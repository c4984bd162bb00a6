"""Stage-level breakdown of the splat rasterizer at production scale.

Port of ``scripts/profile_render.py``: one training iteration of the mapper
is a render forward and backward; this times the forward's stages alone at
two scene sizes, and the whole forward and forward + backward of
``rasterization``, on the card (``device`` "cpu" runs it on the CPU):

  project -> SH eval -> depth argsort -> gather-reorder -> tile binning
  -> pack + slot gather + compositor (K1)

The scene is the JAX script's frustum wedge (depths 0.5-6 m, log-uniform
scales, SH degree 3) at 512x288, drawn from a seeded ``torch.Generator``.
Each stage is timed by CUDA events over back-to-back calls
(``bench.time_ms``); every row names the card and its power limit.

Usage:
  python -m artdeco_tpu_torch.scripts.profile_render [--sizes 65536 262144]
"""

import argparse

import torch

from artdeco_tpu_torch.bench import card_label, log, time_ms
from artdeco_tpu_torch.device import float32_policy, resolve


def wedge_scene(n: int, sh_degree: int, device, seed: int = 0) -> tuple:
    """(means, quats, scales, opacities, SH colors) of n Gaussians in a
    0.5-6 m frustum wedge in front of an identity camera."""
    g = torch.Generator().manual_seed(seed)

    def u(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=g)

    z = u((n,), 0.5, 6.0)
    means = torch.stack([u((n,), -1.0, 1.0) * z, u((n,), -0.6, 0.6) * z, z], -1)
    quats = torch.randn(n, 4, generator=g)
    quats = quats / torch.linalg.vector_norm(quats, dim=-1, keepdim=True)
    scales = torch.exp(u((n, 3), -5.5, -3.5))
    opac = u((n,), 0.1, 0.9)
    colors = 0.1 * torch.randn(n, (sh_degree + 1) ** 2, 3, generator=g)
    return tuple(x.to(device) for x in (means, quats, scales, opac, colors))


def profile_size(n: int, width: int, height: int, sh_degree: int, device,
                 repeats: int = 6) -> dict:
    """Every stage's ms at one scene size, and the visible Gaussians and
    (tile, Gaussian) pairs."""
    from artdeco_tpu_torch.ops.splat import api, binning, composite, project, sh

    tiles_x, tiles_y = -(-width // binning.TILE), -(-height // binning.TILE)
    K = torch.tensor([[300.0, 0, width / 2], [0, 300.0, height / 2], [0, 0, 1]], device=device)
    viewmat = torch.eye(4, device=device)
    means, quats, scales, opac, colors = wedge_scene(n, sh_degree, device)
    rows = {}

    def row(name, fn):
        rows[name] = time_ms(fn, repeats, device)
        log(f"  {name}: {rows[name]:.3f} ms")

    with torch.no_grad():
        def proj_fn():
            return project.project_gaussians(means, quats, scales, viewmat, K, width, height,
                                             eps2d=0.3, near_plane=0.01, far_plane=1e10)
        row("project", proj_fn)
        proj = proj_fn()
        row("sh_to_color", lambda: sh.sh_to_color(sh_degree, means, colors))
        rgb = sh.sh_to_color(sh_degree, means, colors)
        row("depth argsort", lambda: torch.argsort(proj.depths, stable=True))
        order = torch.argsort(proj.depths, stable=True)
        channels = torch.cat([rgb, proj.depths[:, None]], -1)

        def reorder():
            return (proj.means2d[order], proj.conics[order], proj.radii[order], opac[order],
                    channels[order])
        row("gather-reorder x5", reorder)
        m2d_s, con_s, rad_s, op_s, ch_s = reorder()
        row("build_tile_bins (16N-pair sort)",
            lambda: binning.build_tile_bins(m2d_s, rad_s, tiles_x, tiles_y, kx=4, ky=4))
        bins = binning.build_tile_bins(m2d_s, rad_s, tiles_x, tiles_y, kx=4, ky=4)
        n_ch = ch_s.shape[-1]

        def pack_and_composite():
            packed = torch.cat([m2d_s, con_s, op_s[:, None], m2d_s.new_zeros(n, 2), ch_s,
                                m2d_s.new_zeros(n, composite.C_MAX - n_ch)], -1)
            slot_data = api.SlotGather.apply(packed, bins.slot_gauss, bins.slot_valid,
                                             bins.gauss_slots)
            return composite.tile_composite(slot_data, bins.pad_starts, bins.pad_counts,
                                            tiles_x, tiles_y)
        row("pack+slot gather+composite", pack_and_composite)

        def full():
            return api.rasterization(means, quats, scales, opac, colors, viewmat, K, width,
                                     height, sh_degree=sh_degree, render_mode="RGB+D",
                                     eps2d=0.3)[0]
        row("FULL rasterization fwd", full)

    params = [x.clone().requires_grad_(True) for x in (means, quats, scales, opac, colors)]

    def fwd_bwd():
        r, a, _ = api.rasterization(*params, viewmat, K, width, height, sh_degree=sh_degree,
                                    render_mode="RGB+D", eps2d=0.3)
        loss = torch.mean(torch.abs(r)) + torch.mean(a)
        return torch.autograd.grad(loss, params)
    row("FULL rasterization fwd+bwd", fwd_bwd)
    rows["visible"] = int((torch.amax(proj.radii, -1) > 0).sum())
    rows["pairs"] = int(bins.num_pairs)
    log(f"  [visible gaussians: {rows['visible']}/{n}, pairs={rows['pairs']}]")
    return rows


def main(device=None, sizes=(1 << 16, 1 << 18), width: int = 512, height: int = 288,
         sh_degree: int = 3, repeats: int = 6) -> dict:
    """Profile each of ``sizes`` on ``device`` (default: the card);
    returns {N: {row: ms, "visible": count, "pairs": count}}."""
    dev = resolve(device)
    float32_policy()
    out = {}
    for n in sizes:
        log(f"N = {n} ({width}x{height}, sh{sh_degree}) [{card_label(str(dev))}]")
        out[n] = profile_size(n, width, height, sh_degree, dev, repeats)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--sizes", type=int, nargs="+", default=[1 << 16, 1 << 18])
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=288)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA device)")
    a = ap.parse_args()
    main(a.device, tuple(a.sizes), a.width, a.height)
