"""The port's tracer: named spans and counters, process-wide.

``span(name)`` times one stage of the program.  It records its name, its
start and end on ``time.perf_counter_ns``, the thread, its parent (the span
open around it on that thread) and the request it serves, into a ring of
the last ``RING`` events, and adds its seconds to the running totals
``{name: [seconds, count]}`` (``totals()``).  A span opened through a
component's ``Timers`` also adds to that view, which keeps the totals of
one tracker, backend, factor graph, viewer or system apart from another's.
``count(name, n)`` adds to a counter (``counters()``) and puts the count in
the ring the same way.  All adds take one lock, ``LOCK``, which
``kernels.count_launch`` takes for the kernels' launch counts too.

While a ``torch.profiler`` session records, a span is also a
``record_function`` range of the same name, so the profile's timeline shows
which stage was open over each stretch of device work; with no session, no
range is entered; each range lies inside its span's record, on the
profile's own clock (which ``torch.profiler`` calibrates against the wall
clock when it starts).  The profile is the one exporter: the ring stays in
memory.

A span synchronises the device at its end only where the ``Timers`` it was
opened through has ``sync_timing`` set and the span names a CUDA device:
then its time holds the device work launched inside it, not only the
launches.  Otherwise the tracer neither synchronises nor reads the device.

**Requests.**  The spans one input causes share a request id ``(stream,
n)``: a ``Stream`` numbers the requests of one source (a ``Frontend`` by its
frame ids, a model runner by its top-level calls).  A span or ``request``
given an id sets it on the thread for its extent, and the spans and counts
inside inherit it; given a ``Stream``, it numbers a new request only where
none is open.  The span that sets a request is its root: it also records
the thread's CPU time (``time.thread_time_ns``), so wall minus CPU is the
time the thread did not run (waiting for the interpreter lock, sleeping,
blocked in a call).  ``window(name, first, stop)`` picks requests
``first..stop-1`` of the newest stream that has a span named ``name``, and
picks none where the ring has dropped an event of one of them.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import NamedTuple, Optional

import torch

RING = 1 << 16
LOCK = threading.Lock()          # every add of the tracer, and kernels.count_launch
_acquire, _release = LOCK.acquire, LOCK.release
_ring: collections.deque = collections.deque(maxlen=RING)
_dropped: dict = {}              # {stream: the newest request that lost an event to the ring}
_totals: dict = {}
_counters: dict = {}
_seq = itertools.count(1)
_stream_ids = itertools.count(1)
_local = threading.local()
_profiling = torch._C._autograd._profiler_enabled


class Event(NamedTuple):
    """One record of the ring."""
    kind: str                 # "span" or "count"
    name: str
    t0: int                   # perf_counter_ns; a count's t0 == t1
    t1: int
    thread: int
    seq: int                  # unique in the process, in opening order
    parent: int               # seq of the span open around it on its thread, 0 for none
    stream: Optional[int]     # request id (stream, request), None outside any request
    request: Optional[int]
    cpu_ns: Optional[int]     # thread CPU time of a request's root span, else None
    self_ns: int              # a span's duration less its child spans'; 0 for a count
    n: int                    # a count's amount; 1 for a span


class _Thread:
    __slots__ = ("stack", "req", "tid")

    def __init__(self):
        self.stack: list = []
        self.req = None
        self.tid = threading.get_ident()


def _state() -> _Thread:
    try:
        return _local.st
    except AttributeError:
        st = _local.st = _Thread()
        return st


class Stream:
    """A source of request ids ``(self.id, n)``: ids unique in the process,
    each stream's requests numbered from 0."""

    def __init__(self):
        self.id = next(_stream_ids)
        self._next = itertools.count()

    def take(self) -> int:
        return next(self._next)


def _open_request(st: _Thread, request):
    """The id to set for a span or ``request`` given ``request``: an id
    ``(stream, n)`` always, a ``Stream``'s next number only where none is
    open, else None (inherit)."""
    if isinstance(request, Stream):
        return None if st.req is not None else (request.id, request.take())
    return request


class span:
    """``with span(name): ...`` times a stage (see the module docstring).
    ``timers``: the component's ``Timers`` it adds to; ``sync``: the device
    to synchronise at the end; ``request``: an id ``(stream, n)`` or a
    ``Stream``, making this span its request's root."""

    __slots__ = ("name", "timers", "sync", "request", "_st", "_prev", "_rf", "t0", "cpu0",
                 "seq", "child_ns")

    def __init__(self, name: str, timers: "Timers" = None, sync=None, request=None):
        self.name = name
        self.timers = timers
        self.sync = sync
        self.request = request

    def __enter__(self):
        st = self._st = _state()
        req = None if self.request is None else _open_request(st, self.request)
        self._prev = st.req
        if req is not None:
            st.req = req
            self.cpu0 = time.thread_time_ns()
        else:
            self.cpu0 = None
        st.stack.append(self)
        self.child_ns = 0
        self.seq = next(_seq)
        self.t0 = time.perf_counter_ns()
        self._rf = None
        if _profiling():         # the range opens and closes inside the record
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.sync is not None:
            torch.cuda.synchronize(self.sync)
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        t1 = time.perf_counter_ns()
        st = self._st
        st.stack.pop()
        dur = t1 - self.t0
        parent = st.stack[-1] if st.stack else None
        if parent is not None:
            parent.child_ns += dur
        req = st.req
        cpu = None
        if self.cpu0 is not None:
            cpu = time.thread_time_ns() - self.cpu0
            st.req = self._prev
        ev = ("span", self.name, self.t0, t1, st.tid, self.seq,
              parent.seq if parent is not None else 0,
              req[0] if req else None, req[1] if req else None, cpu, dur - self.child_ns, 1)
        _close(ev, self.name, dur * 1e-9, self.timers)
        return False


def _append(ev: tuple) -> None:
    """Put ``ev`` in the ring (under the lock), noting the request of the
    event it pushes out."""
    if len(_ring) == _ring.maxlen:
        old = _ring[0]
        if old[7] is not None and _dropped.get(old[7], -1) < old[8]:
            _dropped[old[7]] = old[8]
    _ring.append(ev)


def _close(ev: tuple, name: str, seconds: float, timers) -> None:
    _acquire()
    try:
        _append(ev)
        t = _totals.get(name)
        if t is None:
            t = _totals[name] = [0.0, 0]
        t[0] += seconds
        t[1] += 1
        if timers is not None:
            t = timers.get(name)
            if t is None:
                t = timers[name] = [0.0, 0]
            t[0] += seconds
            t[1] += 1
    finally:
        _release()


def interval(name: str, t0: int, t1: int, request=None) -> None:
    """Record a span timed elsewhere (``perf_counter_ns`` ends), such as a
    wait that starts on one thread and ends on another; no parent."""
    st = _state()
    req = request if request is not None else st.req
    ev = ("span", name, t0, t1, st.tid, next(_seq), 0, req[0] if req else None,
          req[1] if req else None, None, t1 - t0, 1)
    _close(ev, name, (t1 - t0) * 1e-9, None)


class request:
    """``with request(id_or_stream): ...`` sets the thread's request for its
    extent, as a span's ``request`` does, without a span of its own."""

    __slots__ = ("request", "_st", "_prev")

    def __init__(self, request):
        self.request = request

    def __enter__(self):
        st = self._st = _state()
        self._prev = st.req
        req = _open_request(st, self.request)
        if req is not None:
            st.req = req
        return self

    def __exit__(self, *exc):
        self._st.req = self._prev
        return False


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``, and record the count in the ring under
    the thread's request and open span."""
    st = _state()
    req = st.req
    t = time.perf_counter_ns()
    ev = ("count", name, t, t, st.tid, next(_seq), st.stack[-1].seq if st.stack else 0,
          req[0] if req else None, req[1] if req else None, None, 0, n)
    with LOCK:
        _append(ev)
        _counters[name] = _counters.get(name, 0) + n


class Timers(dict):
    """One component's totals ``{name: [seconds, count]}`` of the spans
    opened through ``span``.  With ``sync_timing`` set, each such span that
    names a CUDA ``device`` synchronises it at its end."""

    def __init__(self):
        super().__init__()
        self.sync_timing = False

    def span(self, name: str, device: torch.device = None, request=None) -> span:
        sync = (device if self.sync_timing and device is not None and device.type == "cuda"
                else None)
        return span(name, self, sync, request)

    def device_span(self, name: str, device: torch.device) -> span:
        """``span`` for a stage timed by its device work: with ``sync_timing``
        set, the device is synchronised at the start too, so that work
        launched before the stage does not count in it."""
        if self.sync_timing and device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
        return self.span(name, device)


class Timed:
    """A component with per-instance ``timers``: its ``sync_timing`` is
    theirs."""

    timers: Timers

    @property
    def sync_timing(self) -> bool:
        return self.timers.sync_timing

    @sync_timing.setter
    def sync_timing(self, on: bool) -> None:
        self.timers.sync_timing = bool(on)


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------

def events() -> list:
    """The ring's events, oldest first."""
    with LOCK:
        return [Event._make(e) for e in _ring]


def totals() -> dict:
    """``{name: (seconds, count)}`` over every span closed in the process."""
    with LOCK:
        return {k: (v[0], v[1]) for k, v in _totals.items()}


def counters() -> dict:
    with LOCK:
        return dict(_counters)


def window(name: str, first: int, stop: int) -> list:
    """The events of requests ``first..stop-1`` of the newest stream with a
    span named ``name`` in the ring, oldest first; [] when none has one, and
    when the ring has pushed out an event of request ``first`` or later of
    that stream, so that the requests are no longer whole."""
    with LOCK:
        evs = [Event._make(e) for e in _ring]
        dropped = dict(_dropped)
    streams = [e.stream for e in evs if e.name == name and e.stream is not None]
    if not streams:
        return []
    s = max(streams)
    if dropped.get(s, -1) >= first:
        return []
    return [e for e in evs if e.stream == s and first <= e.request < stop]

