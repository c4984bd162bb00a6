"""Keyframe-data-parallel mapper training over a mesh.

Port of ``artdeco_tpu/parallel/dp.py``: each slot of the mesh renders and
differentiates its own keyframe against the replicated scene; the scene
gradients are averaged over the slots, the visibility masks ORed, and one
Adam update of the shared scene follows.  The JAX package runs this as one
``shard_map`` with ``psum``/``pmax`` collectives and a replicated update;
here one controller (``parallel/mesh.py``) runs each step as

1. each slot receives a replica of the scene (``Mesh.replicate``);
2. each slot computes its loss and gradients on its device
   (``scene_model.loss_and_grads``, the single-device step's objective);
3. the gradients come home, to the mesh's first device;
4. they are reduced there in slot order 0..n-1 (deterministic);
5. the update runs once, on the home device: what each replica of the JAX
   update computes.

The rules of the JAX step, each kept:

* **Test frames** train only their pose: their scene gradients are left out
  and the mean is over the non-test slots, not the mesh size.  An all-test
  batch updates no scene, global feature or ``mlp_cov`` parameter and
  leaves the ``mlp_cov`` lr as it is.
* **Visibility** (per Gaussian and per cluster) is ORed over the non-test
  slots; the **loss** reported is the mean over all slots.
* **Per-keyframe rows** (pose, exposure, their Adam moments, the depth-loss
  weight): slots may train the same keyframe (sampling with replacement),
  so each row's delta is summed over its slots and divided by its
  multiplicity: k slots on one keyframe apply the average of their k steps
  once.  Every slot reads the rows as they were before the step: the pool
  is rebuilt after all slots ran, so no slot sees another slot's write.
"""

from __future__ import annotations

import collections
import dataclasses

import torch

from artdeco_tpu_torch.mapper import gaussians as G
from artdeco_tpu_torch.mapper import keyframe as KF
from artdeco_tpu_torch.mapper.config import MapperConfig
from artdeco_tpu_torch.mapper.scene_model import (GRAD_NAMES, MLP_KEYS, MlpCov,
                                                 keyframe_row_steps, loss_and_grads,
                                                 scene_update)
from artdeco_tpu_torch.ops import adam
from artdeco_tpu_torch.parallel.mesh import Mesh

# per-keyframe pool rows a step writes: (pool field, Adam state field, grad)
_ROWS = (("r_w2c", "opt_r", "r"), ("t_w2c", "opt_t", "t"), ("exposure", "opt_e", "e"))
_SCENE_GRADS = tuple(k for k in GRAD_NAMES if k not in ("r", "t", "e"))


def replicate_scene(mesh: Mesh, slot: int, slab: G.GaussianSlab, gfeat_val: torch.Tensor,
                    mlp: MlpCov) -> tuple:
    """Slot ``slot``'s replica of what a view's loss reads: the slab, the
    global features and ``mlp_cov``."""
    rep = lambda x: mesh.replicate(x, slot)  # noqa: E731
    return (G.GaussianSlab(**{f.name: rep(getattr(slab, f.name))
                              for f in dataclasses.fields(slab)}),
            rep(gfeat_val), MlpCov(**{k: rep(getattr(mlp, k)) for k in MLP_KEYS}))


def make_dp_train_step(mesh: Mesh, cfg: MapperConfig, width: int, height: int,
                       is_important: bool = True):
    """The data-parallel train step.

    Step signature:
      (slab, opt, gfeat, mlp, mlp_opt, mlp_lr, pool,
       kf_idx (B ints), gt (B, 3, H, W), mono (B, 1, H, W), K (3, 3), bg (B, 3),
       is_test=None)
      -> (slab, opt, gfeat, mlp, mlp_opt, mlp_lr, pool, metrics)
    with B the mesh's size, every input on the mesh's home
    device, ``gt``/``mono``/``bg`` indexed by slot.  ``is_test`` (B bools)
    is each keyframe's test flag; None reads it from the pool (one sync).
    The inputs are left unchanged."""
    B = mesh.size

    def step(slab, opt, gfeat, mlp, mlp_opt, mlp_lr, pool, kf_idx, gt, mono, K, bg,
             is_test=None):
        kf_idx = [int(k) for k in kf_idx]
        if len(kf_idx) != B:
            raise ValueError(f"{len(kf_idx)} keyframes for a mesh of {B} slots")
        if is_test is None:
            is_test = pool.is_test[kf_idx].tolist()
        is_test = [bool(x) for x in is_test]

        # 1-2: each slot's loss and gradients, on its device
        slots = []
        for d in range(B):
            kf = kf_idx[d]
            rep = lambda x: mesh.replicate(x, d)  # noqa: E731
            r_slab, r_gval, r_mlp = replicate_scene(mesh, d, slab, gfeat.val, mlp)
            slots.append(loss_and_grads(
                r_slab, r_gval, r_mlp, rep(pool.r_w2c[kf]), rep(pool.t_w2c[kf]),
                rep(pool.exposure[kf]), rep(pool.depth_loss_weight[kf]), rep(gt[d]),
                rep(mono[d]), rep(K), rep(bg[d]), width, height, is_important, cfg))

        with torch.no_grad():
            # 3-4: home, reduced in slot order
            home = mesh.home
            grads = [{k: g.to(home) for k, g in s[1].items()} for s in slots]
            loss = mesh.pmean([s[0] for s in slots])
            scene = [d for d in range(B) if not is_test[d]]
            if scene:
                # w_scene is 0 for a test slot: its term is left out of the sum
                n_scene = float(len(scene))
                g_scene = {k: mesh.psum([grads[d][k] for d in scene]) / n_scene
                           for k in _SCENE_GRADS}
                vis = mesh.pmax([slots[d][2] for d in scene])
                gvis = mesh.pmax([slots[d][3] for d in scene])
                # 5: the replicated update, once
                slab, opt, gfeat, mlp, mlp_opt, mlp_lr = scene_update(
                    slab, opt, gfeat, mlp, mlp_opt, mlp_lr, g_scene, vis, gvis, cfg)
            pool = _pool_step(pool, kf_idx, grads, is_test, cfg)
        return slab, opt, gfeat, mlp, mlp_opt, mlp_lr, pool, dict(loss=loss)

    return step


def _pool_step(pool: KF.KeyframePool, kf_idx: list, grads: list, is_test: list,
               cfg: MapperConfig) -> KF.KeyframePool:
    """The per-keyframe rows after the step: each trained row plus the sum
    of its slots' deltas over its multiplicity, computed from the rows as
    they were before the step.  Returns a new pool."""
    mult = collections.Counter(kf_idx)
    deltas: dict = collections.defaultdict(dict)     # field -> {kf: summed delta}

    def add(field, kf, new, old):
        d = new - old
        deltas[field][kf] = deltas[field][kf] + d if kf in deltas[field] else d

    for d, kf in enumerate(kf_idx):
        steps = keyframe_row_steps(pool, kf, grads[d], is_test[d])
        for field, st_field, name in _ROWS:
            p_new, st_new = steps[name]
            st = getattr(pool, st_field)
            add(field, kf, p_new, getattr(pool, field)[kf])
            add(st_field + ".exp_avg", kf, st_new.exp_avg, st.exp_avg[kf])
            add(st_field + ".exp_avg_sq", kf, st_new.exp_avg_sq, st.exp_avg_sq[kf])
        dlw = pool.depth_loss_weight[kf]
        add("depth_loss_weight", kf, dlw * cfg.depth_loss_weight_decay, dlw)

    def stepped(field, old):
        new = old.clone()
        for kf, s in deltas[field].items():
            new[kf] = old[kf] + s * (1.0 / mult[kf])
        return new

    fields = {f: stepped(f, getattr(pool, f)) for f in ("r_w2c", "t_w2c", "exposure",
                                                        "depth_loss_weight")}
    for _, st_field, _ in _ROWS:
        st = getattr(pool, st_field)
        fields[st_field] = adam.AdamState(
            stepped(st_field + ".exp_avg", st.exp_avg),
            stepped(st_field + ".exp_avg_sq", st.exp_avg_sq))
    return dataclasses.replace(pool, **fields)
