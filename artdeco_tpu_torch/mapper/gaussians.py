"""Gaussian parameter slabs with an ``active`` mask.

Port of ``artdeco_tpu/mapper/gaussians.py``: a capacity-allocated slab
where prune clears bits, insert scatters a fixed candidate budget into the
lowest free slots in order, and every consumer runs over the whole slab
with masking.  Capacity still grows by doubling (``grow``): the slab
length enters the loss through the mean scaling regulariser, so the port
keeps the JAX package's sizes to keep its numbers.

Per-Gaussian Adam moments and the per-Gaussian xyz learning rate ride
beside the slab.  Functions return new dataclasses and leave their inputs
unchanged.
"""

from __future__ import annotations

import dataclasses

import torch

from artdeco_tpu_torch.geometry import lie
from artdeco_tpu_torch.ops import adam


@dataclasses.dataclass
class GaussianSlab:
    """All tensors have leading dim = capacity."""

    active: torch.Tensor      # (C,) bool
    kf_id: torch.Tensor       # (C,) int32 creating keyframe
    cls_id: torch.Tensor      # (C,) int32 voxel cluster id
    d_max: torch.Tensor       # (C, 1) LOD distance bound
    xyz: torch.Tensor         # (C, 3)
    f_dc: torch.Tensor        # (C, 1, 3)
    f_rest: torch.Tensor      # (C, K-1, 3)
    scaling: torch.Tensor     # (C, 3) log-scales
    rotation: torch.Tensor    # (C, 4) wxyz
    opacity: torch.Tensor     # (C, 1) logits
    local_feat: torch.Tensor  # (C, Dl)
    xyz_lr: torch.Tensor      # (C,) per-Gaussian position lr

    @property
    def capacity(self) -> int:
        return self.active.shape[0]

    def num_active(self) -> torch.Tensor:
        return torch.sum(self.active)

    def prefix(self, n: int) -> "GaussianSlab":
        """View of the first n rows."""
        return GaussianSlab(**{f.name: getattr(self, f.name)[:n]
                               for f in dataclasses.fields(self)})


TRAINED_KEYS = (
    "xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity", "local_feat",
)

# SlabOptState: one AdamState per trained key
SlabOptState = dict


def create_slab(capacity: int, sh_degree: int, local_feat_dim: int,
                position_lr_init: float, device) -> GaussianSlab:
    k = (sh_degree + 1) ** 2
    f32 = dict(dtype=torch.float32, device=device)
    return GaussianSlab(
        active=torch.zeros(capacity, dtype=torch.bool, device=device),
        kf_id=torch.zeros(capacity, dtype=torch.int32, device=device),
        cls_id=torch.zeros(capacity, dtype=torch.int32, device=device),
        d_max=torch.full((capacity, 1), 1e10, **f32),
        xyz=torch.zeros(capacity, 3, **f32),
        f_dc=torch.zeros(capacity, 1, 3, **f32),
        f_rest=torch.zeros(capacity, k - 1, 3, **f32),
        scaling=torch.full((capacity, 3), -10.0, **f32),
        rotation=torch.tensor([1.0, 0, 0, 0], **f32).repeat(capacity, 1),
        opacity=torch.full((capacity, 1), -10.0, **f32),
        local_feat=torch.zeros(capacity, local_feat_dim, **f32),
        xyz_lr=torch.full((capacity,), position_lr_init, **f32),
    )


def create_opt_state(slab: GaussianSlab) -> SlabOptState:
    return {k: adam.init_state(getattr(slab, k)) for k in TRAINED_KEYS}


def prune(slab: GaussianSlab, keep_mask: torch.Tensor) -> GaussianSlab:
    """Deactivate Gaussians outside ``keep_mask`` (no data movement)."""
    return dataclasses.replace(slab, active=slab.active & keep_mask)


def insert(slab: GaussianSlab, opt: SlabOptState, new: dict,
           new_valid: torch.Tensor):
    """Scatter a fixed-budget batch of candidates into free slots.

    new: dict of (B, ...) tensors keyed like slab fields (subset ok);
    new_valid: (B,) bool.  The i-th valid candidate goes to the i-th lowest
    free slot (the order fixes depth-sort ties downstream); candidates
    beyond the free capacity are dropped.  Returns (slab, opt, n_inserted).
    """
    cap = slab.capacity
    # stable argsort puts free (False) slots first, in index order
    free_slots = torch.argsort(slab.active.to(torch.uint8), stable=True)
    n_free = cap - torch.sum(slab.active)
    rank = torch.cumsum(new_valid.to(torch.int64), 0) - 1
    ok = new_valid & (rank < n_free)
    target = free_slots[torch.clamp(rank, 0, cap - 1)][ok]

    updates = {}
    for key, val in new.items():
        dest = getattr(slab, key).clone()
        dest[target] = val[ok].to(dest.dtype)
        updates[key] = dest
    active = slab.active.clone()
    active[target] = True
    updates["active"] = active
    new_opt = {}
    for k in TRAINED_KEYS:
        m, v = opt[k].exp_avg.clone(), opt[k].exp_avg_sq.clone()
        m[target] = 0.0
        v[target] = 0.0
        new_opt[k] = adam.AdamState(m, v)
    return dataclasses.replace(slab, **updates), new_opt, torch.sum(ok)


def apply_adam(slab: GaussianSlab, opt: SlabOptState, grads: dict,
               visibility: torch.Tensor, lrs: dict, b1: float = 0.5,
               b2: float = 0.99, eps: float = 1e-15):
    """Visibility-masked Adam over all trained slab fields; xyz uses the
    per-Gaussian ``slab.xyz_lr``.  Only active & visible rows update."""
    vis = visibility & slab.active
    updates, new_states = {}, {}
    for key in TRAINED_KEYS:
        lr = slab.xyz_lr if key == "xyz" else lrs[key]
        updates[key], new_states[key] = adam.adam_update_masked(
            getattr(slab, key), grads[key], opt[key], lr, vis,
            b1=b1, b2=b2, eps=eps,
        )
    return dataclasses.replace(slab, **updates), new_states


def decay_xyz_lr(slab: GaussianSlab, visibility: torch.Tensor, decay: float,
                 lr_min: float) -> GaussianSlab:
    new_lr = adam.decay_lr_masked(slab.xyz_lr, visibility & slab.active,
                                  decay, lr_min)
    return dataclasses.replace(slab, xyz_lr=new_lr)


@torch.no_grad()
def rigid_transform(slab: GaussianSlab, old_c2w: torch.Tensor,
                    new_c2w: torch.Tensor) -> GaussianSlab:
    """Per-keyframe pose corrections applied to the Gaussians (loop
    closure): each Gaussian moves by new[kf] @ inv(old[kf]) of its
    keyframe; old_c2w/new_c2w (Kf, 4, 4) camera-to-world."""
    old = old_c2w[slab.kf_id.long()]
    new = new_c2w[slab.kf_id.long()]
    R_o, t_o = old[:, :3, :3], old[:, :3, 3]
    R_n, t_n = new[:, :3, :3], new[:, :3, 3]
    R_d = R_n @ R_o.transpose(-1, -2)
    t_d = t_n - torch.einsum("nij,nj->ni", R_d, t_o)
    new_xyz = torch.einsum("nij,nj->ni", R_d, slab.xyz) + t_d
    # rotate the quaternion (wxyz): q_new = q(R_d) * q
    q_xyzw = torch.cat([slab.rotation[:, 1:4], slab.rotation[:, 0:1]], dim=-1)
    q_new = lie.quat_mul(lie.matrix_to_quat(R_d), q_xyzw)
    new_rot = torch.cat([q_new[:, 3:4], q_new[:, 0:3]], dim=-1)
    return dataclasses.replace(slab, xyz=new_xyz, rotation=new_rot)


def grow(slab: GaussianSlab, opt: SlabOptState, new_capacity: int):
    """Reallocate the slab at a larger capacity; the new rows take
    ``create_slab``'s fill values (xyz_lr takes row 0's lr, as in JAX)."""
    old = slab.capacity
    if new_capacity <= old:
        raise ValueError(f"grow: {new_capacity} <= capacity {old}")
    pad = new_capacity - old

    def pad_rows(x, fill=0.0):
        extra = torch.full((pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                           device=x.device)
        return torch.cat([x, extra], 0)

    rot = torch.tensor([1.0, 0, 0, 0], device=slab.rotation.device)
    slab2 = GaussianSlab(
        active=pad_rows(slab.active, False),
        kf_id=pad_rows(slab.kf_id, 0),
        cls_id=pad_rows(slab.cls_id, 0),
        d_max=pad_rows(slab.d_max, 1e10),
        xyz=pad_rows(slab.xyz),
        f_dc=pad_rows(slab.f_dc),
        f_rest=pad_rows(slab.f_rest),
        scaling=pad_rows(slab.scaling, -10.0),
        rotation=torch.cat([slab.rotation, rot.repeat(pad, 1)], 0),
        opacity=pad_rows(slab.opacity, -10.0),
        local_feat=pad_rows(slab.local_feat),
        xyz_lr=torch.cat([slab.xyz_lr, slab.xyz_lr[:1].expand(pad)]),
    )
    opt2 = {k: adam.AdamState(pad_rows(s.exp_avg), pad_rows(s.exp_avg_sq))
            for k, s in opt.items()}
    return slab2, opt2
