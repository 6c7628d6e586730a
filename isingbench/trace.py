"""The traced slice of a run: device intervals by device, harness spans.

The busy-time arithmetic is a copy of ising_tpu_torch/device_trace.py's
(`union_length`): the device is busy where any kernel, copy or set runs,
and idle elsewhere in the slice. Device events are taken by their time on
the profiler's one timeline, which kineto aligns across the host and the
devices; those the slice launched end inside it, because it ends in a
synchronize of every device.
"""

from __future__ import annotations

import dataclasses
import json

PREFIX = "isingbench."
SLICE = PREFIX + "traced"


@dataclasses.dataclass
class Trace:
    """Microseconds on the profiler's timeline."""
    start_us: float
    end_us: float
    # device index -> [(start, end, name)], sorted
    devices: dict
    # [(name without PREFIX, start, end)] of the harness's spans
    spans: list

    @property
    def window_us(self) -> float:
        return self.end_us - self.start_us


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    return sum(e - s for s, e in merged(intervals))


def merged(intervals):
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def collect(events) -> Trace | None:
    """The slice of torch.profiler `events` (prof.events()) that the
    harness marked, or None where it holds no device activity."""
    from torch.autograd import DeviceType
    host = [e.time_range for e in events
            if e.name == SLICE and e.device_type == DeviceType.CPU]
    if not host:
        return None
    w0, w1 = host[0].start, host[0].end
    devices, spans = {}, []
    for e in events:
        r = e.time_range
        if e.device_type == DeviceType.CPU:
            if e.name.startswith(PREFIX) and e.name != SLICE:
                spans.append((e.name[len(PREFIX):], r.start, r.end))
            continue
        if (e.device_type != DeviceType.CUDA or e.name.startswith(PREFIX)
                or getattr(e, "is_user_annotation", False)):
            continue
        s, t = max(r.start, w0), min(r.end, w1)
        if t > s:
            devices.setdefault(e.device_index, []).append((s, t, e.name))
    if not devices:
        return None
    for v in devices.values():
        v.sort()
    spans.sort(key=lambda x: x[1])
    return Trace(w0, w1, devices, spans)


def busy_us(trace: Trace, device) -> float:
    return union_length((s, e) for s, e, _ in trace.devices[device])


def op_us(trace: Trace, match) -> dict:
    """device index -> (summed microseconds, count) of the events whose
    name satisfies match(name)."""
    out = {}
    for d, evs in trace.devices.items():
        picked = [e - s for s, e, n in evs if match(n)]
        out[d] = (sum(picked), len(picked))
    return out


def span_at(trace: Trace, t: float) -> str:
    """The innermost harness span that holds time t, else "harness"."""
    best = None
    for name, s, e in trace.spans:
        if s <= t <= e and (best is None or s >= best[1]):
            best = (name, s)
    return best[0] if best else "harness"


def idle_gaps(trace: Trace, top: int = 10):
    """[name, seconds] of the longest idle gaps of any device in the
    slice, each named by the harness span the host was in at its middle
    (and the device, where there are several)."""
    gaps = []
    for d, evs in trace.devices.items():
        edges = [trace.start_us] + [x for iv in merged(
            (s, e) for s, e, _ in evs) for x in iv] + [trace.end_us]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                name = span_at(trace, (a + b) / 2)
                if len(trace.devices) > 1:
                    name += f" cuda:{d}"
                gaps.append((b - a, name))
    gaps.sort(reverse=True)
    return [[name, us * 1e-6] for us, name in gaps[:top]]


def device_ops(trace: Trace, top: int = 10, width: int = 120):
    """[name, seconds] of the device operations that took most time,
    summed over the devices (names cut to `width` characters)."""
    by = {}
    for evs in trace.devices.values():
        for s, e, n in evs:
            key = n[:width]
            by[key] = by.get(key, 0.0) + (e - s)
    return [[n, us * 1e-6] for n, us in
            sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def write_chrome(trace: Trace, path, width: int = 60) -> None:
    """The slice as a Chrome trace (chrome://tracing, Perfetto): the
    harness's spans on the host's row, each device's operations on its
    own, names cut to `width` characters to keep the file small."""
    events = [{"name": n, "ph": "X", "pid": "host", "tid": "harness",
               "ts": round(s, 3), "dur": round(e - s, 3)}
              for n, s, e in trace.spans]
    for d, evs in trace.devices.items():
        events += [{"name": n[:width], "ph": "X", "pid": f"cuda:{d}",
                    "tid": "ops", "ts": round(s, 3), "dur": round(e - s, 3)}
                   for s, e, n in evs]
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"traceEvents": events}))
