"""Numerical sanity of the port's Sim(3): its action against its 4x4
matrix on seeded random poses and points (port of ``scripts/test_sim3.py``,
whose draws are JAX's; here a seeded ``torch.Generator``'s), on the card
unless ``--device`` names another device."""

import argparse


def main(argv=None):
    import torch

    from artdeco_tpu_torch.device import resolve
    from artdeco_tpu_torch.geometry import lie

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    g = torch.Generator().manual_seed(0)
    xi = (0.3 * torch.randn(7, generator=g)).to(dev)
    T = lie.sim3_exp(xi)
    X = torch.randn(100, 3, generator=g).to(dev)
    Y1 = lie.sim3_act(T, X)
    M = lie.sim3_matrix(T)
    Xh = torch.cat([X, torch.ones(100, 1, device=dev)], -1)
    Y2 = (M @ Xh.T).T[:, :3]
    err = float(torch.abs(Y1 - Y2).max())
    print("act vs matrix:", err)
    if not err < 1e-4:
        raise SystemExit(f"Sim(3) action and matrix disagree by {err}")
    print("OK")


if __name__ == "__main__":
    main()
