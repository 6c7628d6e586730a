"""Where the main path's time goes on the card, from a torch.profiler trace.

    python3 -m ising_tpu_torch.device_trace [--size 16384] [--rng threefry13]
        [--backend bit1|packed|dense|mxu] [--rows R] [--devs N]
    python3 -m ising_tpu_torch.device_trace --algo sw [--size 4096]

Runs the run loop the CLI runs (bit1 unless --backend says otherwise, T = 1.5,
-w 8 -n 64 -p 16 by default; with --algo sw the Swendsen-Wang run of
README.md:62, 4096^2 at T = Tc, -n 64 -p 8) with the profiler recording
CPU and CUDA activity, and prints, for the span of the run loop that its
flips/ns times (after the warm-up and the first measurement: the
program's `window` span, the profiler range WINDOW):

- the span's wall time and the device's busy time inside it (the union
  of kernel, copy and set intervals; with --devs N, the mean of the
  devices), hence the device's idle share;
- device time by kernel name;
- the gaps between one sweep kernel (either of the two behind
  bit1_sweep, or packed_sweep's, the fused packed step's, dense_sweep's,
  mxu_sweep's or any of the cluster labeler's three) and the next
  kernel: a gap near zero means the host enqueues launches faster than
  the card runs them;
- the kernel launches in the span, against those the path makes: two a
  step, one under ISING_TPU_FUSED=1|2 on packed where the fused step
  applies (packed_fused_step, or packed_fused_step_manual under =2);
- device time by program span (utils/profiling.py's ``ising.*`` ranges:
  advance, launch, halo, measure, count, gather, wait, decode, tile_sums;
  for --algo sw the parts of an update, sw.bonds, sw.label, sw.flip): the
  device time of the kernels inside each span's mirror on the device rows,
  and the length of those mirrors;
- the longest idle gaps of each device, each named by the innermost
  program span the host was in at the gap's middle: what the host was
  doing while the device waited;
- the program's own record of the traced run (profiling.spans()): host
  time and self time by span with their launches and bytes, the launches
  by kernel, the set-up spans (the kernels' build or load, each slab's
  initial state with the allocator's peak), and the halo rows' bytes
  copied between devices a step.

The last line is one JSON object with those numbers. With --device cpu it
records CPU activity only, and the device numbers are zero.
"""

from __future__ import annotations

import argparse
import bisect
import json
import math
import os
import subprocess
import time

import torch
from torch.autograd import DeviceType

from .cluster import SwendsenWang
from .config import SimConfig
from .constants import TCRIT
from .driver import Simulation
from .ops import get_backend
from .utils import profiling

WINDOW = profiling.PREFIX + "window"
PREFIX = profiling.PREFIX

KERNELS = ("bit1_sweep_kernel", "bit1_planes_kernel", "packed_sweep_kernel",
           "packed_fused_kernel", "dense_sweep_kernel", "mxu_sweep_kernel",
           "label_tile_roots_kernel", "label_hook_kernel",
           "label_flatten_kernel")


def is_kernel(name: str) -> bool:
    return any(k in name for k in KERNELS)


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    return sum(e - s for s, e in _merged(intervals))


def _merged(intervals):
    """The union of (start, end) intervals as sorted disjoint [start, end]
    pairs."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _device(e) -> int:
    return getattr(e, "device_index", 0)


def _annotation(e) -> bool:
    return (e.name.startswith(PREFIX)
            or bool(getattr(e, "is_user_annotation", False)))


def summarize(events, top: int = 10):
    """Busy time, idle share, time by name and launch gaps (microseconds)
    of the device work in the WINDOW range of profiler `events`; the device
    time of each program span; the longest idle gaps, named by the program
    span the host was in.

    The wall time is the host's range. The device work is picked by the
    range's mirror on the device timeline, a user annotation from the
    first to the last device activity launched inside the range, so that
    an offset between the host and device clocks cannot move kernels in or
    out of it. Without a mirror (no device activity), the host's range is
    used. A program span's device time is that of the device operations
    inside its mirrors on the same device. An idle gap is a stretch of
    the window in which a device runs nothing; it is named by the
    innermost program span (on the host's row) that holds its middle."""
    host = [e.time_range for e in events
            if e.name == WINDOW and e.device_type == DeviceType.CPU]
    if not host:
        raise RuntimeError(f"no {WINDOW} range in the trace")
    mirror = [e.time_range for e in events
              if e.name == WINDOW and e.device_type == DeviceType.CUDA]
    w0, w1 = host[0].start, host[0].end
    d0, d1 = (mirror[0].start, mirror[0].end) if mirror else (w0, w1)
    inside = [e for e in events if e.device_type == DeviceType.CUDA
              and e.time_range.start >= d0 and e.time_range.end <= d1]
    dev = sorted((e.time_range.start, e.time_range.end, e.name, _device(e))
                 for e in inside if not _annotation(e))
    devices = sorted({k for _, _, _, k in dev}) or [0]
    busy = sum(union_length((s, e) for s, e, _, k in dev if k == d)
               for d in devices) / len(devices)
    by_name = {}
    for s, e, name, _ in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    gaps = [dev[i + 1][0] - dev[i][1] for i in range(len(dev) - 1)
            if is_kernel(dev[i][2])]
    gaps.sort()
    wall = w1 - w0
    return {
        "wall_us": wall, "device_busy_us": busy,
        "idle_share": 1.0 - busy / wall if wall > 0 else None,
        "device_us_by_name": dict(sorted(by_name.items(),
                                         key=lambda kv: -kv[1])),
        "kernel_launches": sum(is_kernel(n) for _, _, n, _ in dev),
        "gap_after_kernel_us": {
            "n": len(gaps),
            "median": gaps[len(gaps) // 2] if gaps else None,
            "p90": gaps[math.ceil(0.9 * len(gaps)) - 1] if gaps else None,
            "max": gaps[-1] if gaps else None},
        "spans": _span_device_time(inside, dev),
        "idle_gaps": _idle_gaps(events, dev, d0, d1, top),
    }


def _span_device_time(inside, dev):
    """{span: {"span_us", "busy_us"}}: the length of each program span's
    mirrors on the device rows, and the device time (a union) of the
    operations inside them."""
    mirrors = {}
    for e in inside:
        if e.name.startswith(PREFIX) and e.name != WINDOW:
            mirrors.setdefault(e.name[len(PREFIX):], []).append(
                (e.time_range.start, e.time_range.end, _device(e)))
    out = {}
    for name, ranges in sorted(mirrors.items()):
        held = []
        for d in {r[2] for r in ranges}:
            spans = _merged((s, e) for s, e, k in ranges if k == d)
            starts = [s for s, _ in spans]
            for s, e, _, k in dev:
                i = bisect.bisect_right(starts, s) - 1
                if k == d and i >= 0 and e <= spans[i][1]:
                    held.append((s, e))
        out[name] = {"span_us": sum(e - s for s, e, _ in ranges),
                     "busy_us": union_length(held)}
    return out


def _idle_gaps(events, dev, d0, d1, top):
    """The `top` longest stretches of [d0, d1] in which one device runs
    nothing, as {"span", "device", "us"}, each named by the innermost
    program span the host was in at its middle ("-" outside any)."""
    host = sorted((e.time_range.start, e.time_range.end,
                   e.name[len(PREFIX):]) for e in events
                  if e.device_type == DeviceType.CPU
                  and e.name.startswith(PREFIX))
    starts = [s for s, _, _ in host]

    def span_at(t):
        for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
            if host[i][1] >= t:
                return host[i][2]
        return "-"

    gaps = []
    for d in sorted({k for _, _, _, k in dev}) or [0]:
        busy = _merged((s, e) for s, e, _, k in dev if k == d)
        edges = [d0] + [x for iv in busy for x in iv] + [d1]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps.append((b - a, d, (a + b) / 2))
    gaps.sort(reverse=True)
    return [{"span": span_at(t), "device": d, "us": us}
            for us, d, t in gaps[:top]]


def step_launches(cfg: SimConfig):
    """(wrapper, launches a step) of cfg's Metropolis path: the fused
    packed step, once a step, where the backend's fusable says so (the
    stepper's rule), else two of the backend's sweep a slab, six with
    halo_overlap (an interior and two bands a color)."""
    backend = get_backend(cfg)
    if getattr(backend, "fusable", None) and backend.fusable(cfg.nrows):
        manual = os.environ.get("ISING_TPU_FUSED") == "2"
        return ("packed_fused_step_manual" if manual
                else "packed_fused_step"), 1
    per_slab = 6 if cfg.halo_overlap and cfg.ndev > 1 else 2
    return f"{cfg.backend}_sweep", per_slab * cfg.ndev


def trace(cfg: SimConfig, make=Simulation):
    """Run cfg's run loop (of make(cfg): Simulation or SwendsenWang)
    without, then under the profiler; the first run's flips/ns is what the
    profiler's own cost is measured against."""
    untraced = make(cfg).run(log=lambda line: None)
    profiling.clear()
    sim = make(cfg)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if sim.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    lines = []
    with torch.profiler.profile(activities=acts) as prof:
        result = sim.run(log=lines.append)
    out = summarize(prof.events())
    out["flips_ns"] = result["flips_ns"]
    out["flips_ns_untraced"] = untraced["flips_ns"]
    out["program"] = program_record(cfg.nwarmup + result["steps"])
    return out, lines


def program_record(steps: int) -> dict:
    """What the program's own record of spans says of the traced run
    (utils/profiling.py): its set-up spans (host s and counts: a build or a
    load, the allocator's peak after each slab's initial state), the host
    time, self time, launches and bytes by span, the launches by kernel,
    and the halo rows' bytes copied between devices a step."""
    record = profiling.spans()
    by_kernel = {}
    for s in record:
        if s.name == "launch":
            k = s.counts["kernel"]
            by_kernel[k] = by_kernel.get(k, 0) + s.counts["launches"]
    totals = profiling.totals()
    return {
        "setup": [{"span": s.name, "host_s": s.host_s,
                   **{k: v for k, v in s.counts.items()}}
                  for s in record if s.name.startswith("setup.")],
        "host_ms_by_span": {
            name: {"n": t["n"], "host_ms": 1e3 * t["host_s"],
                   "self_ms": 1e3 * t["self_s"], "launches": t["launches"],
                   "bytes": t["bytes"]}
            for name, t in sorted(totals.items())
            if not name.startswith("setup.")},
        "launches_by_kernel": by_kernel,
        "halo_bytes_per_step": (totals["halo"]["bytes"] / steps
                                if "halo" in totals and steps else None),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--size", type=int, default=None,
                   help="lattice side (16384; --algo sw: 4096)")
    p.add_argument("--rng", action="append", default=None,
                   help="rng mode; repeat for several (default threefry13 "
                        "and philox)")
    p.add_argument("-w", "--nwarmup", type=int, default=None,
                   help="warm-up steps (8; --algo sw: 0)")
    p.add_argument("-n", "--nit", type=int, default=64)
    p.add_argument("-p", "--print", dest="print_freq", type=int,
                   default=None, help="measure every PRINT steps (16; "
                                      "--algo sw: 8)")
    p.add_argument("--backend", default="bit1",
                   choices=("bit1", "packed", "dense", "mxu"))
    p.add_argument("--algo", default="metropolis",
                   choices=("metropolis", "sw"))
    p.add_argument("--rows", type=int, default=None,
                   help="lattice rows (default: the side)")
    p.add_argument("--devs", type=int, default=1,
                   help="row slabs, one a device (the first N GPUs)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sw = args.algo == "sw"
    size = args.size or (4096 if sw else 16384)
    rows = args.rows or size
    shape = f"{size}^2" if rows == size else f"{rows}x{size}"
    warmup = args.nwarmup if args.nwarmup is not None else (0 if sw else 8)
    prints = args.print_freq or (8 if sw else 16)
    results = {}
    modes = args.rng or ["threefry13", "philox"]
    for mode in modes[:1] if sw else modes:
        cfg = SimConfig(nrows=rows, ncols=size, temp=TCRIT if sw else 1.5,
                        backend="xla" if sw else args.backend, rng=mode,
                        nwarmup=warmup, niters=args.nit, print_freq=prints,
                        ndev=args.devs, device=args.device)
        t0 = time.perf_counter()
        expected = ""
        if not sw:
            kernel, per_step = step_launches(cfg)
            expected = f" (of {per_step * cfg.niters} {kernel} launches)"
        out, lines = trace(cfg, SwendsenWang if sw else Simulation)
        for line in lines:
            print(line)
        gaps = out["gap_after_kernel_us"]
        what = "Swendsen-Wang" if sw else f"{mode} on {args.backend}"
        print(f"[trace] {shape} {what}: timed span "
              f"{out['wall_us']:.1f} us, device busy "
              f"{out['device_busy_us']:.1f} us, idle share "
              f"{out['idle_share']:.4f}; {out['kernel_launches']} kernel "
              f"launches{expected}, gap "
              "after each: median "
              f"{gaps['median']} us, p90 "
              f"{gaps['p90']} us, max {gaps['max']} us "
              f"; {out['flips_ns']:.2f} flips/ns traced, "
              f"{out['flips_ns_untraced']:.2f} untraced "
              f"({time.perf_counter() - t0:.1f} s)",
              flush=True)
        for name, us in list(out["device_us_by_name"].items())[:8]:
            print(f"[trace]   {us:12.1f} us  {name[:100]}")
        for name, sp in out["spans"].items():
            print(f"[trace]   {name}: device busy {sp['busy_us']:.1f} us in "
                  f"a span of {sp['span_us']:.1f} us")
        for gap in out["idle_gaps"]:
            print(f"[trace]   idle {gap['us']:.1f} us on device "
                  f"{gap['device']} in {gap['span']}")
        rec = out["program"]
        for name, t in rec["host_ms_by_span"].items():
            print(f"[trace]   host {name}: {t['n']} spans, {t['host_ms']:.3f} "
                  f"ms ({t['self_ms']:.3f} self), {t['launches']} launches, "
                  f"{t['bytes']} bytes")
        for part in rec["setup"]:
            print(f"[trace]   set-up {part}")
        if rec["halo_bytes_per_step"] is not None:
            print(f"[trace]   halo: {rec['halo_bytes_per_step']:.0f} bytes "
                  "between devices a step")
        results["sw" if sw else mode] = out
    if args.device != "cpu":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
