"""Voxel-hash clustering with per-voxel majority voting.

Port of ``artdeco_tpu/mapper/clustering.py``: a persistent spatial hash
table of ``table_size`` buckets maps voxels to cluster ids; existing
Gaussians re-vote their bucket's cluster by a sort-based run-length
argmax, and candidates take their bucket's cluster or a fresh id.
``jax.ops.segment_*`` become ``bincount`` / ``scatter_reduce``.  All
integer math, so both packages give the same ids.

Bit budget of the sort keys: bucket ids use 17 bits (table_size + parking
<= 2^17) and cluster ids 14 bits.
"""

from __future__ import annotations

import dataclasses

import torch

_P1, _P2, _P3 = 73856093, 19349663, 83492791
_LBITS = 14
_I32 = 1 << 32


@dataclasses.dataclass
class ClusterState:
    voxel_cls: torch.Tensor     # (T,) int32 cluster id per bucket, -1 empty
    num_clusters: torch.Tensor  # () int32


def create_cluster_state(table_size: int, device) -> ClusterState:
    if table_size > 1 << 16:
        raise ValueError(f"table_size {table_size} > 2^16")
    return ClusterState(
        voxel_cls=torch.full((table_size,), -1, dtype=torch.int32, device=device),
        num_clusters=torch.zeros((), dtype=torch.int32, device=device),
    )


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value two's-complement arithmetic would give."""
    return (x + (1 << 31)) % _I32 - (1 << 31)


def bucket_of(xyz: torch.Tensor, voxel_size: float, table_size: int) -> torch.Tensor:
    """Spatial hash of the voxel of each point, with int32 wrap-around
    semantics (computed in int64 so no overflow is left to the compiler)."""
    ijk = torch.floor(xyz / voxel_size).to(torch.int32).long()
    h = (_wrap_i32(ijk[..., 0] * _P1) ^ _wrap_i32(ijk[..., 1] * _P2)
         ^ _wrap_i32(ijk[..., 2] * _P3))
    # |INT32_MIN| wraps to itself in int32 arithmetic
    a = torch.where(h == -(1 << 31), h, torch.abs(h))
    return torch.remainder(a, table_size)


def _seg(values, index, num_segments, reduce, init):
    out = torch.full((num_segments,), init, dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce(0, index, values, reduce=reduce, include_self=True)


@torch.no_grad()
def update_clusters(
    state: ClusterState,
    xyz: torch.Tensor,        # (N, 3) existing Gaussians
    cls_id: torch.Tensor,     # (N,) int32
    active: torch.Tensor,     # (N,) bool
    new_xyz: torch.Tensor,    # (B, 3) candidates
    new_valid: torch.Tensor,  # (B,) bool
    voxel_size: float,
    table_size: int,
    max_clusters: int,
):
    """Re-vote existing Gaussians' cluster ids and assign ids to candidates.

    Returns (new_state, updated_cls_id (N,), new_cls_id (B,), n_fresh).
    """
    if max_clusters > 1 << _LBITS:
        raise ValueError(f"max_clusters {max_clusters} > 2^{_LBITS}")
    n = xyz.shape[0]
    b = new_xyz.shape[0]
    dev = xyz.device
    park = table_size  # virtual bucket for inactive rows
    ts1 = table_size + 1

    bk = bucket_of(xyz, voxel_size, table_size)
    bk_eff = torch.where(active, bk, torch.full_like(bk, park))

    # ---- exact majority vote per bucket: sort (bucket, label) pairs -------
    label = torch.clamp(cls_id.long(), 0, max_clusters - 1)
    key = (bk_eff << _LBITS) | label
    keys_sorted, _ = torch.sort(key)
    is_start = torch.ones(n, dtype=torch.bool, device=dev)
    is_start[1:] = keys_sorted[1:] != keys_sorted[:-1]
    run_id = torch.cumsum(is_start.long(), 0) - 1
    run_count = torch.bincount(run_id, minlength=n)
    run_key = _seg(keys_sorted, run_id, n, "amax", 0)
    run_bucket = run_key >> _LBITS
    run_label = run_key & ((1 << _LBITS) - 1)
    # empty run slots have count 0: park them so they can't win bucket 0
    run_bucket = torch.where(run_count > 0, run_bucket,
                             torch.full_like(run_bucket, park))

    max_count = _seg(run_count, run_bucket, ts1, "amax", 0)
    is_winner = run_count == max_count[run_bucket]
    winner = _seg(
        torch.where(is_winner, run_label, torch.full_like(run_label, max_clusters)),
        run_bucket, ts1, "amin", max_clusters,
    )
    has_points = max_count[:table_size] > 0
    winner = torch.where(has_points, winner[:table_size],
                         torch.full_like(winner[:table_size], -1))

    updated_cls = torch.where(active, winner[bk], cls_id.long()).to(torch.int32)

    # refresh the persistent table where there is live evidence
    voxel_cls = torch.where(has_points, winner, state.voxel_cls.long())

    # ---- assign candidates -------------------------------------------------
    nb = bucket_of(new_xyz, voxel_size, table_size)
    nb_eff = torch.where(new_valid, nb, torch.full_like(nb, park))
    existing = voxel_cls[torch.clamp_max(nb_eff, table_size - 1)]
    hit = new_valid & (existing >= 0)

    # fresh ids for the first occurrence per unoccupied bucket
    cand_idx = torch.arange(b, device=dev)
    miss = new_valid & ~hit
    first_idx = _seg(torch.where(miss, cand_idx, torch.full_like(cand_idx, b)),
                     nb_eff, ts1, "amin", b)
    is_first = miss & (cand_idx == first_idx[nb_eff])
    fresh_rank = torch.cumsum(is_first.long(), 0) - 1
    fresh_id = torch.clamp(state.num_clusters.long() + fresh_rank, 0,
                           max_clusters - 1)
    bucket_fresh = _seg(torch.where(is_first, fresh_id, torch.full_like(fresh_id, -1)),
                        nb_eff, ts1, "amax", -1)[:table_size]
    new_cls = torch.where(
        hit, existing,
        torch.where(miss, bucket_fresh[torch.clamp_max(nb, table_size - 1)],
                    torch.zeros_like(existing)),
    ).to(torch.int32)

    n_fresh = torch.sum(is_first)
    num_clusters = torch.clamp_max(state.num_clusters.long() + n_fresh,
                                   max_clusters).to(torch.int32)

    # register fresh buckets
    voxel_cls = torch.where((voxel_cls < 0) & (bucket_fresh >= 0),
                            bucket_fresh, voxel_cls)
    return (
        ClusterState(voxel_cls=voxel_cls.to(torch.int32), num_clusters=num_clusters),
        updated_cls,
        new_cls,
        n_fresh,
    )
