"""MASt3R inference glue: mono, asymmetric and symmetric decodes with matching.

Port of ``artdeco_tpu/models/mast3r_infer.py`` (the reference's
``utils_mast3r.py``).  ``Mast3rRunner`` has the runner surface the tracker,
the backend and the system call (``encode_image``, ``inference_mono``,
``match_asymmetric``, ``match_symmetric``), the surface ``OracleRunner``
stands in for.  Its matches run through ``ops.matching.match``, so every
pair refines through K3.  A symmetric match decodes all of a batch's
edges, both directions, in one batched decode.
"""

from __future__ import annotations

import torch

from artdeco_tpu_torch.device import resolve
from artdeco_tpu_torch.models.mast3r import (MASt3R, MASt3RConfig, empty_mast3r,
                                             load_mast3r_state_dict, random_mast3r)
from artdeco_tpu_torch.ops import matching

DEFAULT_MATCH_CFG = dict(max_iter=10, lambda_init=1e-8, convergence_thresh=1e-6,
                         dist_thresh=0.1, radius=4, dilation_max=5)


class Mast3rRunner:
    """A ``MASt3R`` on ``device`` and the matcher's settings."""

    def __init__(self, cfg: MASt3RConfig, model: MASt3R, match_cfg: dict, *, device=None):
        self.cfg = cfg
        self.device = resolve(device)
        self.model = model.to(self.device).eval()
        self.match_cfg = dict(match_cfg)

    @classmethod
    def create(cls, cfg: MASt3RConfig = MASt3RConfig(), match_cfg: dict = None,
               state_dict: dict = None, seed: int = 0, *, device=None,
               generator: torch.Generator = None):
        """The model from a torch-layout ``state_dict`` (a released
        checkpoint, ``load_mast3r_state_dict``), else with random weights
        drawn on ``device`` from ``generator`` (default: seeded by
        ``seed``)."""
        device = resolve(device)
        if state_dict is not None:
            model = load_mast3r_state_dict(empty_mast3r(cfg, device), state_dict)
        else:
            if generator is None:
                generator = torch.Generator(device=device).manual_seed(seed)
            model = random_mast3r(cfg, generator, device)
        return cls(cfg, model, match_cfg or DEFAULT_MATCH_CFG, device=device)

    # -- primitives -------------------------------------------------------
    @torch.no_grad()
    def encode_image(self, img):
        """img (B, 3, H, W) in [-1, 1] -> (feat (B, N, C) float32, pos (B, N, 2))."""
        return self.model.encode(img.to(self.device))

    @torch.no_grad()
    def decode(self, feat1, pos1, feat2, pos2, hw):
        """Both decoders and heads: (res1, res2) dicts of (B, H, W, ...)."""
        nh, nw = hw[0] // self.cfg.patch_size, hw[1] // self.cfg.patch_size
        d1, d2 = self.model.decode(feat1, pos1, feat2, pos2)
        return self.model.head(1, d1, nh, nw), self.model.head(2, d2, nh, nw)

    # -- the runner surface -------------------------------------------------
    def inference_mono(self, img):
        """(3, H, W) -> (X (2, HW, 3), C (2, HW, 1), feat, pos): the
        self-pair decode."""
        h, w = img.shape[-2:]
        feat, pos = self.encode_image(img[None])
        r1, r2 = self.decode(feat, pos, feat, pos, (h, w))
        X = torch.stack([r1["pts3d"][0], r2["pts3d"][0]]).reshape(2, h * w, 3)
        C = torch.stack([r1["conf"][0], r2["conf"][0]]).reshape(2, h * w, 1)
        return X, C, feat, pos

    def match_asymmetric(self, img_i, img_j, idx_i2j_init=None, embeddings_i=None,
                         embeddings_j=None):
        """Frame j's pixels matched into frame i.  Returns (idx_i2j,
        valid_match_j, Xii, Cii, Qii, Xji, Cji, Qji, feat_i, pos_i) with
        per-pixel (HW, ...) arrays."""
        h, w = img_i.shape[-2:]
        feat1, pos1 = embeddings_i if embeddings_i is not None else self.encode_image(img_i[None])
        feat2, pos2 = embeddings_j if embeddings_j is not None else self.encode_image(img_j[None])
        r11, r21 = self.decode(feat1, pos1, feat2, pos2, (h, w))
        idx, valid = matching.match(self.match_cfg, r11["pts3d"], r21["pts3d"], r11["desc"],
                                    r21["desc"], idx_1_to_2_init=idx_i2j_init)
        hw = h * w
        return (idx, valid, r11["pts3d"].reshape(hw, 3), r11["conf"].reshape(hw, 1),
                r11["desc_conf"].reshape(hw, 1), r21["pts3d"].reshape(hw, 3),
                r21["conf"].reshape(hw, 1), r21["desc_conf"].reshape(hw, 1), feat1, pos1)

    def match_symmetric(self, feat_i, pos_i, feat_j, pos_j, hw):
        """Both directions of every edge (feat_* (B, N, C) stacked per edge)
        in one batched decode [i->j | j->i] and one batched match.  Returns
        (idx_i2j, idx_j2i, valid_match_j, valid_match_i, Qii, Qjj, Qji,
        Qij) with Q* (B, HW, 1)."""
        h, w = hw
        b = feat_i.shape[0]
        rA, rB = self.decode(torch.cat([feat_i, feat_j]), torch.cat([pos_i, pos_j]),
                             torch.cat([feat_j, feat_i]), torch.cat([pos_j, pos_i]), hw)
        # rA: [res11 | res22]; rB: [res21 | res12]: X11 = rA, X21 = rB row for row
        idx, valid = matching.match(self.match_cfg, rA["pts3d"], rB["pts3d"], rA["desc"],
                                    rB["desc"])
        qa, qb = rA["desc_conf"].reshape(2 * b, h * w, 1), rB["desc_conf"].reshape(2 * b, h * w, 1)
        return idx[:b], idx[b:], valid[:b], valid[b:], qa[:b], qa[b:], qb[:b], qb[b:]
