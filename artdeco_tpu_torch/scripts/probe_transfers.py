"""Probe: do host-to-device uploads overlap compute on the card, and does a
read-back of a ready tensor wait for unrelated queued compute?

Port of ``scripts/probe_transfers.py`` (``device`` "cpu" runs it on the CPU,
where every answer is trivially serial).  Times (a) a compute chain alone
(64 steps of ``a @ a * 0.999`` on a 2048x2048 float32 matrix, TF32 off),
(b) uploads of a 288x512 frame alone, float32 and uint8, from pageable and
from pinned host memory, (c) compute and a float32 upload together: if (c)
is about max(a, b), the upload rides a copy engine beside the compute; if
about a + b, it waits behind it.  A pageable copy on the default stream is
ordered after the compute queued there, so (c) runs twice: pageable on the
default stream, and pinned on a second stream as ``_UploadAhead`` uploads.
Also the device uint8 -> [-1, 1] cast, and (d) the read-back of an already
ready tensor while the compute chain is queued, from the default stream
and from a second stream: ``_MapperWorker`` shares the default stream with
the tracking thread, so a read-back there waits for whatever the other
thread queued.  Every row names the card and its power limit.

Usage:
  python -m artdeco_tpu_torch.scripts.probe_transfers
"""

import argparse
import statistics
import time

import numpy as np
import torch

from artdeco_tpu_torch.bench import card_label, log, sync, time_ms
from artdeco_tpu_torch.device import float32_policy, resolve


def burn(x, n: int):
    """n steps of a @ a * 0.999 (the JAX script's fori_loop, unrolled)."""
    for _ in range(n):
        x = x @ x * 0.999
    return x


def _median_ms(fn, reps: int = 6) -> float:
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(ts)


def main(device=None, size: int = 2048, steps: int = 64, h: int = 288, w: int = 512) -> dict:
    """Probe on ``device`` (default: the card); returns {row: ms}."""
    dev = resolve(device)
    float32_policy()
    cuda = dev.type == "cuda"
    rng = np.random.RandomState(0)
    # scaled so the chain's largest eigenvalue stays near 1: no overflow, no denormals
    x = torch.as_tensor(rng.rand(size, size).astype(np.float32) * (2.0 / size), device=dev)
    rows = {}
    log(f"transfers [{card_label(str(dev))}]")

    def put(name, ms, note=""):
        rows[name] = ms
        log(f"{name}: {ms:.3f} ms{note}")

    burn(x, steps)
    sync(dev)
    t0 = time.perf_counter()
    burn(x, steps)
    sync(dev)
    t_compute = 1e3 * (time.perf_counter() - t0)
    put("compute alone", t_compute, f" ({steps} x {size}^2 f32 matmul)")

    img32 = rng.rand(3, h, w).astype(np.float32)
    img8 = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    side = torch.cuda.Stream(dev) if cuda else None

    def upload(buf, pinned):
        # a fresh host copy each time, so nothing is cached
        t = torch.from_numpy(buf.copy())
        if pinned and cuda:
            t = t.pin_memory()
            with torch.cuda.stream(side):
                d = t.to(dev, non_blocking=True)
            side.synchronize()
            return d
        d = t.to(dev)
        sync(dev)
        return d

    for label, buf in ((f"f32 {img32.nbytes / 1e6:.2f}MB", img32),
                       (f"u8 {img8.nbytes / 1e6:.2f}MB", img8)):
        put(f"h2d {label.split()[0]} pageable alone", _median_ms(lambda: upload(buf, False)),
            f" ({label})")
        put(f"h2d {label.split()[0]} pinned alone", _median_ms(lambda: upload(buf, True)),
            f" ({label}, pinned, second stream)")

    for pinned, where in ((False, "default stream, pageable"),
                          (True, "second stream, pinned")):
        def together():
            r = burn(x, steps)
            upload(img32, pinned)
            sync(dev)
            return r
        put(f"compute + f32 h2d together ({where})", _median_ms(together),
            f" (serialized would be ~{t_compute + rows['h2d f32 pageable alone']:.0f} ms)")

    d8 = torch.as_tensor(img8, device=dev)

    def u8_to_slam():
        return (d8.to(torch.float32) * (2.0 / 255.0) - 1.0).permute(2, 0, 1).contiguous()
    put("device u8->slam cast", time_ms(u8_to_slam, 8, dev))

    small = torch.ones(8, device=dev)
    for where in ("default stream", "second stream"):
        sync(dev)
        r = burn(x, steps)          # enqueue ~t_compute of work
        t0 = time.perf_counter()
        if where == "second stream" and cuda:
            with torch.cuda.stream(side):
                small.cpu()         # pull an ALREADY-READY tensor
        else:
            small.cpu()
        dt = 1e3 * (time.perf_counter() - t0)
        sync(dev)
        del r
        put(f"d2h of ready array while compute queued ({where})", dt,
            f" (>{0.8 * t_compute:.0f} ms means queue-order blocking)")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA device)")
    main(ap.parse_args().device)
