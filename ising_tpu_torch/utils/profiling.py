"""Profiling and tracing of the port (torch).

The port of ``ising_tpu/utils/profiling.py``: where the JAX package takes
a jax.profiler trace, the port records a torch.profiler trace (CPU
activity, and CUDA activity when the run is on the card: the kernels'
launches and device time, through CUPTI) and writes it into a directory
as a Chrome trace, which chrome://tracing or Perfetto open.

Spans. Each layer marks its work with ``span(name, device=None,
**counts)``: the step loop (``advance``, and ``launch``, through
``launch(wrapper, tensor)``, around every call of a kernel's wrapper),
the halo rows (``halo``, with the
bytes copied between devices), the measurement (``measure``: a ``count``
a slab, ``gather``, ``wait``), the decode (``decode``), the replicas'
tile sums (``tile_sums``), the run loop's timed window (``window``) and a
Swendsen-Wang update (``sw.bonds``, ``sw.label``, ``sw.flip``). A span
records its parent (the span open when it began), its host start and end
(``time.perf_counter_ns``), and counts: ``launches`` (a launch span's are
its wrapper's ``.launches`` delta, and every span adds its children's)
and ``bytes``. Given a CUDA device it also records a CUDA event on that
device's current stream before its work and one after, read only when
its ``device_s`` is asked for, after the run has synchronised.

Tracing is on while a torch profiler records (torch's own flag,
``torch.autograd.profiler._is_profiler_enabled``, read at each call) or
after ``enable()``; otherwise it is off, and ``span`` returns one shared
null context after that check: no profiler range, no event, no record.
On, each span also enters ``torch.profiler.record_function("ising." +
name)``, so that it lies on the profiler's one timeline beside the device
work it launched (kineto mirrors the range onto the device's rows).

``spans()`` gives the finished spans, ``totals()`` their sums by name,
``clear()`` forgets both. At most ``MAX_SPANS`` spans are kept one by one;
past that the totals still grow (count, host time, self time, launches,
bytes) and the raw spans do not, so a long run under ``enable()`` holds a
bounded record. Set-up spans (``setup(part)``: ``setup.kernels``,
``setup.lattice``, ``setup.stepper``) are recorded whether or not tracing
is on; a run makes a handful. The record is the host thread's that runs
the simulation: spans nest by the order they open and close.

``StepTimer`` is a host-side lap timer.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.autograd import profiler as _torch_profiler

TRACE_FILE = "trace.json"
PREFIX = "ising."
MAX_SPANS = 1 << 16

_enabled = False
_open = []       # the spans open now, innermost last
_done = []       # finished spans, the first MAX_SPANS
_totals = {}     # name -> [n, host_ns, self_ns, launches, bytes]
_NULL = contextlib.nullcontext()
_SUMMED = ("launches", "bytes")


@contextlib.contextmanager
def trace(dir_path: str | None, device=None):
    """Record the region into `dir_path`/trace.json when dir_path is set;
    do nothing with None or "". CUDA activity is recorded too when
    `device` is a CUDA device, or with device None when a card is
    present. The spans of the region appear in it as ``ising.*`` ranges."""
    if not dir_path:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    cuda = (torch.device(device).type == "cuda" if device is not None
            else torch.cuda.is_available())
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(dir_path, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(dir_path, TRACE_FILE))


def enable(on: bool = True):
    """Turn tracing on (or off again) without a profiler: spans are
    recorded on the host's clock and by CUDA events."""
    global _enabled
    _enabled = bool(on)


class Span:
    """A finished (or open) span: times in nanoseconds of
    time.perf_counter_ns; `parent` the span it opened inside, or None."""

    __slots__ = ("name", "parent", "device", "counts", "t0_ns", "t1_ns",
                 "child_ns", "events", "_range")

    def __init__(self, name, device, counts):
        self.name, self.device, self.counts = name, device, counts
        self.parent = None
        self.t0_ns = self.t1_ns = self.child_ns = 0
        self.events = self._range = None

    @property
    def host_s(self) -> float:
        return (self.t1_ns - self.t0_ns) * 1e-9

    @property
    def self_s(self) -> float:
        """Host time less that of the spans opened inside it."""
        return (self.t1_ns - self.t0_ns - self.child_ns) * 1e-9

    @property
    def device_s(self) -> float | None:
        """Device time between the span's two CUDA events (waiting for the
        second), None where it recorded none."""
        if self.events is None:
            return None
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end) * 1e-3


class _Recording:
    """The context of one recorded span."""

    __slots__ = ("span", "timed")

    def __init__(self, name, device, timed, counts):
        self.span = Span(name, device, counts)
        self.timed = timed and getattr(device, "type", None) == "cuda"

    def __enter__(self):
        s = self.span
        s.parent = _open[-1] if _open else None
        s.t0_ns = time.perf_counter_ns()
        if _torch_profiler._is_profiler_enabled:
            s._range = torch.profiler.record_function(PREFIX + s.name)
            s._range.__enter__()
        if self.timed:
            stream = torch.cuda.current_stream(s.device)
            s.events = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            s.events[0].record(stream)
        _open.append(s)
        return s

    def __exit__(self, *exc):
        s = self.span
        if _open and _open[-1] is s:
            _open.pop()
        if s.events is not None:
            s.events[1].record(torch.cuda.current_stream(s.device))
        if s._range is not None:
            s._range.__exit__(*exc)
            s._range = None
        s.t1_ns = time.perf_counter_ns()
        _finish(s)
        return False


def _finish(s: Span):
    host = s.t1_ns - s.t0_ns
    p = s.parent
    if p is not None:
        p.child_ns += host
        for key in _SUMMED:
            if key in s.counts:
                p.counts[key] = p.counts.get(key, 0) + s.counts[key]
    t = _totals.get(s.name)
    if t is None:
        t = _totals[s.name] = [0, 0, 0, 0, 0]
    t[0] += 1
    t[1] += host
    t[2] += host - s.child_ns
    t[3] += s.counts.get("launches", 0)
    t[4] += s.counts.get("bytes", 0)
    if len(_done) < MAX_SPANS:
        _done.append(s)


def span(name: str, device=None, **counts):
    """A context manager that records the span `name` while tracing is
    on (entering it gives the Span, whose counts may still be added to)
    and is a shared null context (entering it gives None) while it is
    off. With a CUDA `device` the span also records a CUDA event before
    and after its work on that device's current stream."""
    if not (_enabled or _torch_profiler._is_profiler_enabled):
        return _NULL
    return _Recording(name, device, True, counts)


def setup(part: str, device=None, **counts):
    """The set-up span ``setup.<part>``, recorded whether or not tracing
    is on (host time only)."""
    return _Recording("setup." + part, device, False, counts)


def launch(wrapper, tensor):
    """The ``launch`` span around one call of a hand-written kernel's
    wrapper, which bumps `wrapper.launches` after each launch it makes:
    while tracing is on it records the kernel's name, the device of
    `tensor` (the call's first) and the launches the call made (0 where a
    CPU tensor ran the plain version); off, the shared null context."""
    if not (_enabled or _torch_profiler._is_profiler_enabled):
        return _NULL
    return _Launch(wrapper, tensor.device)


class _Launch(_Recording):
    __slots__ = ("wrapper", "n0")

    def __init__(self, wrapper, device):
        super().__init__("launch", device, False,
                         {"kernel": wrapper.__name__})
        self.wrapper = wrapper

    def __enter__(self):
        self.n0 = self.wrapper.launches
        return super().__enter__()

    def __exit__(self, *exc):
        self.span.counts["launches"] = self.wrapper.launches - self.n0
        return super().__exit__(*exc)


def spans() -> list:
    """The finished spans, in the order they ended (the first MAX_SPANS)."""
    return list(_done)


def totals() -> dict:
    """name -> {"n", "host_s", "self_s", "launches", "bytes"} over every
    span that ended, kept or not."""
    return {name: {"n": n, "host_s": h * 1e-9, "self_s": own * 1e-9,
                   "launches": launches, "bytes": nbytes}
            for name, (n, h, own, launches, nbytes) in _totals.items()}


def clear():
    """Forget the finished spans and their totals."""
    _done.clear()
    _totals.clear()


class StepTimer:
    """Host-side rolling step timer (the Wtime() analog,
    optimized/utils.c:132-139)."""

    def __init__(self):
        self.t0 = None
        self.laps: list[float] = []

    def start(self):
        self.t0 = time.perf_counter()

    def lap(self) -> float:
        now = time.perf_counter()
        dt = now - (self.t0 if self.t0 is not None else now)
        self.laps.append(dt)
        self.t0 = now
        return dt

    @property
    def total(self) -> float:
        return sum(self.laps)
