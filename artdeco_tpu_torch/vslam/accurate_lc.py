"""Accurate loop closure: Pi3 joint multi-view verification.

Port of ``artdeco_tpu/vslam/accurate_lc.py`` (the reference's
``accurate_loop_closure`` and ``process_pairs_in_chunks``): stack <= 23
candidate keyframes and the query, run Pi3 jointly at 392x518, then match
each candidate's points to the query's (``match_pi3``, both in Pi3's
common frame) and rank the candidates by their valid-match fraction.

The JAX package resizes each keyframe image on the host with
``cv2.resize(..., INTER_AREA)``.  Here the images stay on the device and
``area_resize`` applies OpenCV's rule as two per-axis weight matrices
(``dataio/resample.area_matrix``): when the image grows along an axis,
INTER_AREA is OpenCV's linear rule; when it shrinks along both, OpenCV's
area tables.
"""

from __future__ import annotations

from typing import Callable

import torch

from artdeco_tpu_torch import trace
from artdeco_tpu_torch.dataio.resample import area_matrix
from artdeco_tpu_torch.ops.matching import match_pi3


def area_resize(img: torch.Tensor, hw) -> torch.Tensor:
    """(C, H, W) float32 -> (C, h, w) as ``cv2.resize(..., (w, h),
    interpolation=cv2.INTER_AREA)`` of the HWC image."""
    _, H, W = img.shape
    h, w = hw
    shrink = h <= H and w <= W
    wy = torch.as_tensor(area_matrix(H, h, shrink), device=img.device)
    wx = torch.as_tensor(area_matrix(W, w, shrink), device=img.device)
    return torch.einsum("yh,chw,xw->cyx", wy, img, wx)


def make_pi3_accurate_matcher(
    pi3_apply: Callable,       # (imgs (1, N, 3, H, W)) -> dict with "points"
    keyframes,                 # KeyframeStore (img in [-1, 1] CHW)
    match_cfg: dict,
    resize_hw=(392, 518),
    chunk_size: int = 32,
    pad_to: int = 24,          # the retrieval database's window bound
):
    """Returns ``matcher(candidate_ids, query_id) -> match fractions``, the
    retrieval database's accurate matcher.  Its ``calls`` attribute counts
    its Pi3 runs, ``pi3`` is ``pi3_apply``.

    A call numbers a request of ``matcher.stream`` where none is open, and
    counts its frames, padding included, in the tracer's ``pi3.frames``;
    the candidates' ``match_pi3`` is its span ``lc.match``, through the
    timers of ``pi3_apply`` where it is a ``trace.Timed`` (a ``Pi3Runner``),
    so that their ``sync_timing`` covers it too."""
    timers = pi3_apply.timers if isinstance(pi3_apply, trace.Timed) else trace.Timers()

    def matcher(candidate_ids, query_id):
        if len(candidate_ids) + 1 > pad_to:
            raise ValueError(f"{len(candidate_ids)} candidates exceed pad_to={pad_to}")
        with trace.request(matcher.stream):
            idxs = list(candidate_ids) + [query_id]
            imgs = torch.stack([
                area_resize(torch.clamp((keyframes.img_dev(i).float() + 1.0) / 2.0, 0, 1),
                            resize_hw) for i in idxs])
            # padded slots repeat the query image; their outputs are ignored
            n_real = imgs.shape[0]
            if n_real < pad_to:
                imgs = torch.cat([imgs, imgs[-1:].expand(pad_to - n_real, -1, -1, -1)])
            trace.count("pi3.frames", imgs.shape[0])
            points = pi3_apply(imgs[None])["points"][0]       # (pad_to, H, W, 3)
            matcher.calls += 1
            q = points[n_real - 1]
            fracs = []
            with timers.device_span("lc.match", q.device):
                for s in range(0, pad_to - 1, chunk_size):
                    cand = points[s:min(s + chunk_size, pad_to - 1)]
                    _, valid = match_pi3(match_cfg, cand, q.expand_as(cand))
                    fracs.append(valid.float().mean(dim=1))
                fracs = torch.cat(fracs)
            return fracs.cpu().tolist()[:len(candidate_ids)]

    matcher.calls = 0
    matcher.pi3 = pi3_apply
    matcher.stream = trace.Stream()
    return matcher
