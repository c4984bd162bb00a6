"""The port's tracer (``artdeco_tpu_torch/trace.py``) and the benchmark's
readers of it (``benchmark/metrics/``), on the CPU.

Two loops of a few tiny frames feed the request and reader tests: the
oracle ``System`` stream of ``benchmark/drivers/system_stream.py`` (tracking,
the backend's synchronous half, the mapper's worker thread) and the MASt3R
step of ``benchmark/drivers/mast3r_step.py`` (a runner with no request
open), each at ``benchmark/tests/tiny.py``'s sizes.
"""

from __future__ import annotations

import collections
import math
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import artdeco_tpu_torch  # noqa: E402
from artdeco_tpu_torch import kernels, trace  # noqa: E402
from benchmark import harness  # noqa: E402
from benchmark.tests import tiny  # noqa: E402

SEED = 2 ** 31 + 15
SYSTEM_FRAMES = 4
MODEL_FRAMES = 8
SYSTEM_READERS = ["bkd_match_ms", "lm_iters_per_frame", "track_offcpu_ms", "worker_busy_share",
                  "map_queue_wait_ms"]
MODEL_READERS = ["encode_host_ms", "decode_host_ms", "heads_host_ms", "cascade_host_ms"]


def _driver(cell: str, frames: int):
    """A cell's driver whose set-up ran ``frames`` frames as its warm-up."""
    spec = harness.load_spec()
    c = harness.find_cell(spec, cell)
    config, mix = harness.load_config(c["config"]), harness.load_traffic(c["traffic"])
    tiny.shrink(config, mix, {})
    mix["warmup_frames"], mix["window_frames_max"] = frames, 1
    if config["entry"] == "system_stream":
        config["args"].update(num_key_iterations=1, num_common_iterations=1)
    else:
        mix["width"], mix["height"] = 64, 48
    return harness.load_driver(config["entry"])(config, mix, SEED, torch.device("cpu"),
                                                harness.Tracer(False))


@pytest.fixture(scope="module")
def system_loop():
    d = _driver("oracle-base.fwd", SYSTEM_FRAMES)
    yield d
    d.upload.close()
    d.worker.close()


@pytest.fixture(scope="module")
def model_loop():
    return _driver("mast3r-vitl-512.track", MODEL_FRAMES)


def _stream_events(stream_id: int) -> list:
    return [e for e in trace.events() if e.stream == stream_id]


def test_parent_links_and_self_time():
    before = trace.totals().get("t.inner", (0.0, 0))
    with trace.span("t.outer"):
        time.sleep(0.002)
        with trace.span("t.inner"):
            time.sleep(0.003)
        trace.count("t.hits", 2)
    ev = {e.name: e for e in trace.events()[-3:]}
    outer, inner, hits = ev["t.outer"], ev["t.inner"], ev["t.hits"]
    assert outer.parent == 0 and inner.parent == outer.seq and hits.parent == outer.seq
    assert outer.t0 <= inner.t0 <= inner.t1 <= outer.t1
    assert inner.self_ns == inner.t1 - inner.t0 >= 3_000_000
    assert outer.self_ns == (outer.t1 - outer.t0) - (inner.t1 - inner.t0)
    assert outer.self_ns >= 2_000_000
    assert (hits.kind, hits.n, outer.n) == ("count", 2, 1)
    assert outer.cpu_ns is None and outer.request is None
    seconds, n = trace.totals()["t.inner"]
    assert n == before[1] + 1 and seconds - before[0] == pytest.approx(1e-9 * inner.self_ns)


def test_worker_items_carry_their_frames_request(system_loop):
    """Each frame is one request across the tracking thread and the mapper's
    worker: the worker's spans carry the message's frame id, the spans
    inside a root inherit it, and the roots record thread CPU time."""
    fe = system_loop.system.frontend
    ev = _stream_events(fe.stream.id)
    assert ev
    by_req = collections.defaultdict(list)
    for e in ev:
        by_req[e.request].append(e)
    assert sorted(by_req) == list(range(SYSTEM_FRAMES)) == list(range(fe.frame_id))
    main = threading.get_ident()
    items = [e for e in ev if e.name == "map.item"]
    assert items and len(items) == len([e for e in ev if e.name == "map.queue_wait"])
    for item in items:
        names = {e.name for e in by_req[item.request]}
        assert {"frontend.frame", "backend.sync", "map.queue_wait"} <= names
        assert item.thread != main and item.cpu_ns is not None
    for e in ev:
        if e.name in ("frontend.frame", "backend.sync"):
            assert e.thread == main and e.parent == 0 and 0 <= e.cpu_ns
    seqs = {e.seq: e for e in ev}
    for e in ev:
        if e.name == "trk.lm":
            assert seqs[e.parent].name == "trk.step"
            assert seqs[seqs[e.parent].parent].name == "frontend.frame"
        if e.name == "gn.solve":
            assert seqs[e.parent].name == "bkd.solve_GN"
    lm = [e for e in ev if e.name == "trk.lm_iters"]
    assert lm and all(e.kind == "count" and 1 <= e.n for e in lm)


def test_a_runner_alone_numbers_its_calls(model_loop):
    ev = _stream_events(model_loop.runner.stream.id)
    reqs = sorted({e.request for e in ev})
    assert reqs == list(range(MODEL_FRAMES))
    for r in reqs:
        names = collections.Counter(e.name for e in ev if e.request == r)
        assert names["mast3r.encode"] == 1
        # frame 0 is only encoded; later frames are matched into the keyframe
        assert names["mast3r.decode"] == names["mast3r.heads"] == names["match.cascade"] == \
            (0 if r == 0 else 1)


def test_timers_are_per_instance_views_with_their_keys(system_loop, monkeypatch):
    sy = system_loop.system
    fe, bk = sy.frontend, sy.backend
    assert set(fe.tracker.timers) == {"trk.match", "trk.step"}
    assert {"bkd.match_asym", "bkd.pointmap_update", "bkd.retrieval", "bkd.add_factors",
            "bkd.solve_GN", "bkd.writeback", "backend.sync"} == set(bk.timers)
    assert set(bk.factor_graph.timers) == {"fg.match_sym", "fg.fracs_pull", "fg.edge_store",
                                          "gn.prep", "gn.solve", "gn.pose_pull"}
    assert set(fe.timers) == {"frontend.frame"} and set(sy.timers) == {"map.item"}
    ev = _stream_events(fe.stream.id)
    for view in (fe.tracker.timers, bk.timers, bk.factor_graph.timers, fe.timers, sy.timers):
        for name, (seconds, n) in view.items():
            assert isinstance(seconds, float) and n == sum(e.name == name for e in ev)
    assert set(sy.runtimes_ms()) == {"track", "backend", "map"}
    assert fe.timers["frontend.frame"][1] == SYSTEM_FRAMES

    # sync_timing: a span names its device; only the flag lets it synchronise
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    card = torch.device("cuda", 0)
    bk.sync_timing = True
    assert bk.sync_timing and bk.factor_graph.sync_timing and bk.timers.sync_timing
    fe.tracker.sync_timing = False
    with bk.timers.span("t.synced", card), bk.factor_graph.timers.span("t.synced", card):
        pass
    with fe.tracker.timers.span("t.free", card), bk.timers.span("t.host"):
        pass
    bk.sync_timing = False
    with bk.timers.span("t.free", card):
        pass
    assert synced == [card, card]


def test_counters_from_three_threads_lose_nothing(monkeypatch):
    """The tracer's counters and the kernels' launch counts, which
    ``kernels.count_launch`` adds under the tracer's lock."""
    monkeypatch.setattr(trace, "_ring", collections.deque(maxlen=trace.RING))
    n = 3000

    def window_argmax():
        pass

    window_argmax.launches = 0
    before = trace.counters().get("t.threads", 0)

    start = threading.Barrier(3)

    def work():
        start.wait(timeout=60)       # all three alive at once: three thread ids
        for _ in range(n):
            trace.count("t.threads")
            kernels.count_launch(window_argmax)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert window_argmax.launches == 3 * n
    assert trace.counters()["t.threads"] - before == 3 * n
    assert len({e.thread for e in trace.events() if e.name == "t.threads"}) == 3


def test_ring_keeps_the_last_events(monkeypatch):
    monkeypatch.setattr(trace, "_ring", collections.deque(maxlen=trace.RING))
    for i in range(trace.RING + 5):
        trace.count("t.ring", i)
    ev = trace.events()
    assert len(ev) == trace.RING == 1 << 16
    assert ev[0].n == 5 and ev[-1].n == trace.RING + 4


def test_spans_are_profiler_ranges_on_its_clock(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    entered = []
    real = torch.profiler.record_function

    def record_function(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    with trace.span("t.unprofiled"):
        torch.ones(4).sum()
    assert entered == []
    names = ["t.a", "t.b", "t.c", "t.d"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("t.a"):
            with trace.span("t.b"):
                time.sleep(0.002)
            for name in names[2:]:
                with trace.span(name):
                    time.sleep(0.002)
    assert entered == names
    rec = {e.name: e for e in trace.events() if e.name in names}
    ranges = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events() if e.name() in rec}
    assert set(ranges) == set(names)
    # one offset between the ring's clock and the profile's places every
    # range inside its span's record
    lo = max(b - rec[n].t1 for n, (a, b) in ranges.items())
    hi = min(a - rec[n].t0 for n, (a, b) in ranges.items())
    assert lo <= hi, (lo, hi)
    for n, (a, b) in ranges.items():
        assert 0 < b - a <= rec[n].t1 - rec[n].t0


def _plant(name, stream, request, t0_ms, t1_ms, cpu_ms=None, n=1):
    """Put one event in the ring as the program would record it: a span
    (``n`` 1) or, with ``n`` > 1, a count; times in ms."""
    t0, t1 = int(t0_ms * 1e6), int(t1_ms * 1e6)
    trace._append(tuple(trace.Event(
        "count" if n > 1 else "span", name, t0, t1 if n == 1 else t0, 1, next(trace._seq), 0,
        stream, request, None if cpu_ms is None else int(cpu_ms * 1e6),
        t1 - t0 if n == 1 else 0, n)))


@pytest.fixture
def fresh_ring(monkeypatch):
    monkeypatch.setattr(trace, "_ring", collections.deque(maxlen=trace.RING))
    monkeypatch.setattr(trace, "_dropped", {})


def _plant_system(s: int) -> None:
    """Stream ``s``'s frames: requests 2-4 are the head; 1 and 5 lie
    outside it, and stream ``s - 1`` is an older stream."""
    for r in (1, 2, 3, 4, 5):
        a = 1000 * r
        _plant("frontend.frame", s, r, a, a + 100, cpu_ms=50 + 10 * r)
    for r, iters in ((1, 90), (3, 2), (4, 5), (5, 90)):
        _plant("trk.match", s, r, 1000 * r + 10, 1000 * r + 40)
        _plant("trk.lm_iters", s, r, 1000 * r + 50, 0, n=iters)
    # keyframes 2 and 4: their matching is read; request 3's fg.match_sym is not
    _plant("bkd.match_asym", s, 2, 2110, 2140)
    _plant("fg.match_sym", s, 2, 2150, 2160)
    _plant("fg.match_sym", s, 3, 3100, 3150)
    _plant("bkd.match_asym", s, 4, 4110, 4130)
    _plant("fg.match_sym", s, 4, 4140, 4160)
    _plant("fg.match_sym", s, 4, 4170, 4174)
    _plant("bkd.match_asym", s, 5, 5110, 5900)
    for r in (2, 4):
        _plant("backend.sync", s, r, 1000 * r + 100, 1000 * r + 250, cpu_ms=1)
    _plant("map.queue_wait", s, 2, 2250, 2300)
    _plant("map.queue_wait", s, 4, 4250, 4260)
    _plant("map.queue_wait", s, 1, 1250, 2300)
    _plant("map.item", s, 1, 1900, 2100, cpu_ms=1)   # another request: not counted
    _plant("map.item", s, 2, 2300, 2900, cpu_ms=1)   # inside the head's frames
    _plant("map.item", s, 4, 4240, 5240, cpu_ms=1)   # 10 ms of it before the last frame ends
    _plant("frontend.frame", s - 1, 3, 0, 500, cpu_ms=0)
    _plant("map.item", s - 1, 3, 0, 500, cpu_ms=0)


def _plant_model(s: int) -> None:
    """Runner stream ``s``: requests 1-3 are the window; 0 and 4 lie outside
    it, and stream ``s - 1`` is an older runner."""
    for r, enc in ((0, 1000), (1, 10), (2, 20), (3, 30), (4, 1000)):
        _plant("mast3r.encode", s, r, 1000 * r, 1000 * r + enc)
    for r, dec, heads, casc in ((0, 900, 900, 900), (2, 5, 1, 4), (3, 7, 3, 8), (4, 900, 900, 900)):
        _plant("mast3r.decode", s, r, 1000 * r + 100, 1000 * r + 100 + dec)
        _plant("mast3r.heads", s, r, 1000 * r + 200, 1000 * r + 200 + heads)
        _plant("match.cascade", s, r, 1000 * r + 300, 1000 * r + 300 + casc)
    _plant("mast3r.heads", s, 1, 1200, 1202)
    for r in (1, 2, 3):
        _plant("mast3r.encode", s - 1, r, 0, 555)


# readers on planted events: the cell's kind, and the value they have to read
PLANTED = {
    "bkd_match_ms": ("system", (30 + 10 + 20 + 20 + 4) / 2),
    "lm_iters_per_frame": ("system", (2 + 5) / 2),
    "track_offcpu_ms": ("system", (30 + 20 + 10) / 3),
    # head's frames 2000..4250 ms; items: 600 ms inside, 10 ms of request 4's
    "worker_busy_share": ("system", 100.0 * (600 + 10) / 2250),
    "map_queue_wait_ms": ("system", (50 + 10) / 2),
    "encode_host_ms": ("model", (10 + 20 + 30) / 3),
    "decode_host_ms": ("model", (5 + 7) / 2),
    "heads_host_ms": ("model", (2 + 1 + 3) / 3),
    "cascade_host_ms": ("model", (4 + 8) / 2),
}


@pytest.mark.parametrize("name", SYSTEM_READERS + MODEL_READERS)
def test_reader_on_planted_spans(name, fresh_ring):
    """Each reader takes the right spans of the right requests of the newest
    stream: the exact value of planted events, in the slice's head and, for
    the system, over a whole window with no slice."""
    kind, want = PLANTED[name]
    s = 10 ** 9
    reader = harness.load_metric(name)
    if kind == "system":
        _plant_system(s)
        assert reader.read(_run(2, 5, head_s=3.0)) == pytest.approx(want, rel=1e-9)
        assert reader.read(_run(2, 5)) == pytest.approx(want, rel=1e-9)
    else:
        _plant_model(s)
        assert reader.read(_run(1, 4)) == pytest.approx(want, rel=1e-9)


def test_window_is_empty_once_the_ring_drops_a_request(fresh_ring, monkeypatch):
    """Requests that lost an event to the ring are not read: the window and
    its readers give nothing rather than a part."""
    monkeypatch.setattr(trace, "_ring", collections.deque(maxlen=16))
    s = 10 ** 9
    for r in range(10):
        _plant("frontend.frame", s, r, 1000 * r, 1000 * r + 100, cpu_ms=40)
    assert len(trace.window("frontend.frame", 2, 10)) == 8
    for r in range(10, 20):
        _plant("frontend.frame", s, r, 1000 * r, 1000 * r + 100, cpu_ms=40)
    # requests 0-3 were pushed out
    assert trace._dropped == {s: 3}
    assert trace.window("frontend.frame", 2, 10) == []
    assert trace.window("frontend.frame", 3, 20) == []
    assert len(trace.window("frontend.frame", 4, 20)) == 16
    reader = harness.load_metric("track_offcpu_ms")
    assert reader.read(_run(2, 10)) is None
    assert reader.read(_run(4, 20)) == pytest.approx(60.0)


def _run(first: int, stop: int, head_s=None) -> harness.Run:
    counters = {"open": {"frames": first}, "close": {"frames": stop}}
    if head_s:
        counters["slice_open"] = {"frames": stop}
    window = harness.Window(seconds=1.0, latencies=[], attempted=0, failed=0)
    return harness.Run(None, {}, {}, window, {}, counters, None, {"head_s": head_s})


@pytest.mark.parametrize("name", SYSTEM_READERS + MODEL_READERS)
def test_reader(name, request, monkeypatch):
    """Each new reader reads a finite value over a head of tiny frames (the
    system's with a profiled slice after it, the model's over its whole
    window), None over an empty head, and None from a program without the
    tracer."""
    if name in SYSTEM_READERS:
        d = request.getfixturevalue("system_loop")
        run = _run(1, SYSTEM_FRAMES, head_s=d.setup_split["warmup"])
    else:
        request.getfixturevalue("model_loop")
        run = _run(1, MODEL_FRAMES)
    reader = harness.load_metric(name)
    value = reader.read(run)
    assert value is not None and math.isfinite(value) and value >= 0, value
    if name == "worker_busy_share":
        assert value <= 100.0
    if name == "lm_iters_per_frame":
        assert value >= 1.0
    assert reader.read(_run(3, 3)) is None
    monkeypatch.delattr(artdeco_tpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "artdeco_tpu_torch.trace", None)
    assert reader.read(run) is None
