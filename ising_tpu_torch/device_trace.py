"""Where the main path's time goes on the card, from a torch.profiler trace.

    python3 -m ising_tpu_torch.device_trace [--size 16384] [--rng threefry13]
        [--backend bit1|packed|dense|mxu]
    python3 -m ising_tpu_torch.device_trace --algo sw [--size 4096]

Runs the run loop the CLI runs (bit1 unless --backend says otherwise, T = 1.5,
-w 8 -n 64 -p 16 by default; with --algo sw the Swendsen-Wang run of
README.md:62, 4096^2 at T = Tc, -n 64 -p 8) with the profiler recording
CPU and CUDA activity, and prints, for the span of the run loop that its
flips/ns times (after the warm-up and the first measurement, which
`driver.run_loop` marks as TIMED_WINDOW):

- the span's wall time and the device's busy time inside it (the union
  of kernel, copy and set intervals), hence the device's idle share;
- device time by kernel name;
- the gaps between one sweep kernel (either of the two behind
  bit1_sweep, or packed_sweep's, the fused packed step's, dense_sweep's,
  mxu_sweep's or any of the cluster labeler's three) and the next
  kernel: a gap near zero means the host enqueues launches faster than
  the card runs them;
- the kernel launches in the span, against those the path makes: two a
  step, one under ISING_TPU_FUSED=1|2 on packed where the fused step
  applies (packed_fused_step, or packed_fused_step_manual under =2);
- for --algo sw, each part of an update (sw_step's ranges: the bonds, the
  labeling, the coins and flip): the device time of its kernels and the
  span from its first kernel to its last.

The last line is one JSON object with those numbers. With --device cpu it
records CPU activity only, and the device numbers are zero.
"""

from __future__ import annotations

import argparse
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
from .driver import TIMED_WINDOW as WINDOW
from .driver import Simulation
from .ops import get_backend

KERNELS = ("bit1_sweep_kernel", "bit1_planes_kernel", "packed_sweep_kernel",
           "packed_fused_kernel", "dense_sweep_kernel", "mxu_sweep_kernel",
           "label_tile_roots_kernel", "label_hook_kernel",
           "label_flatten_kernel")
SW_SPANS = ("sw_step.bonds", "sw_step.label", "sw_step.flip")


def is_kernel(name: str) -> bool:
    return any(k in name for k in KERNELS)


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def summarize(events):
    """Busy time, idle share, time by name and launch gaps (microseconds)
    of the device work in the WINDOW range of profiler `events`.

    The wall time is the host's range. The device work is picked by the
    range's mirror on the device timeline, a user annotation from the
    first to the last device activity launched inside the range, so that
    an offset between the host and device clocks cannot move kernels in or
    out of it. Without a mirror (no device activity), the host's range is
    used."""
    host = [e.time_range for e in events
            if e.name == WINDOW and e.device_type == DeviceType.CPU]
    if not host:
        raise RuntimeError(f"no {WINDOW} range in the trace")
    mirror = [e.time_range for e in events
              if e.name == WINDOW and e.device_type == DeviceType.CUDA]
    w0, w1 = host[0].start, host[0].end
    d0, d1 = (mirror[0].start, mirror[0].end) if mirror else (w0, w1)
    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in events if e.device_type == DeviceType.CUDA
                 and e.name != WINDOW and e.name not in SW_SPANS
                 and e.time_range.start >= d0 and e.time_range.end <= d1)
    busy = union_length((s, e) for s, e, _ in dev)
    by_name = {}
    for s, e, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    gaps = [dev[i + 1][0] - dev[i][1] for i in range(len(dev) - 1)
            if is_kernel(dev[i][2])]
    gaps.sort()
    spans = {}
    for name in SW_SPANS:
        ranges = [e.time_range for e in events if e.name == name
                  and e.device_type == DeviceType.CUDA
                  and e.time_range.start >= d0 and e.time_range.end <= d1]
        if ranges:
            spans[name] = {
                "span_us": sum(r.end - r.start for r in ranges),
                "busy_us": union_length(
                    (s, e) for s, e, _ in dev
                    if any(r.start <= s and e <= r.end for r in ranges))}
    wall = w1 - w0
    return {
        "wall_us": wall, "device_busy_us": busy,
        "idle_share": 1.0 - busy / wall if wall > 0 else None,
        "device_us_by_name": dict(sorted(by_name.items(),
                                         key=lambda kv: -kv[1])),
        "kernel_launches": sum(is_kernel(n) for _, _, n in dev),
        "gap_after_kernel_us": {
            "n": len(gaps),
            "median": gaps[len(gaps) // 2] if gaps else None,
            "p90": gaps[math.ceil(0.9 * len(gaps)) - 1] if gaps else None,
            "max": gaps[-1] if gaps else None},
        "spans": spans,
    }


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
    return out, lines


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
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sw = args.algo == "sw"
    size = args.size or (4096 if sw else 16384)
    warmup = args.nwarmup if args.nwarmup is not None else (0 if sw else 8)
    prints = args.print_freq or (8 if sw else 16)
    results = {}
    modes = args.rng or ["threefry13", "philox"]
    for mode in modes[:1] if sw else modes:
        cfg = SimConfig(nrows=size, ncols=size, temp=TCRIT if sw else 1.5,
                        backend="xla" if sw else args.backend, rng=mode,
                        nwarmup=warmup, niters=args.nit, print_freq=prints,
                        device=args.device)
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
        print(f"[trace] {size}^2 {what}: timed span "
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
