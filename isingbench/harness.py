"""One run of one cell: set-up, warm-up, the measured window, the check.

A cell of BENCHMARK.json names a configuration (configs/<name>.json: the
SimConfig fields of ising_tpu_torch, the wrappers that count the
kernels' launches, and what the deployment is) and a traffic mix
(traffic/<name>.json: which of the program's measurements the user's
job reads, and every how many steps). Its metrics are read by
metrics/<name>.py, each a `read(run)` of the Run record below that
returns a number, or None where it finds nothing to read. A mix that
dispatches its measurements ahead (its `ahead`) splits its call in two
with calls/<call>.py. All of these are found by name, so a new cell or
metric is new files.

A configuration may also name, each key optional:

* "program": the dotted path of the class that the harness builds as
  `cls(cfg, mesh=mesh)` (cfg: a SimConfig of the configuration's fields
  and the run's seed). Where it names none, the program is
  ising_tpu_torch.driver.Simulation, checkerboard Metropolis. The harness
  asks of a program only `advance(n)` (n steps or updates, enqueued),
  `block()` (wait for the devices), `step` (the steps done), `cfg`,
  `mesh` (its devices, or None for one), `device` and the traffic's call.
  ising_tpu_torch.cluster.SwendsenWang meets it too. A path that does not
  import, or names no class, ends the run before set-up with a message
  that names the key.
* "check": the name of checks/<name>.py, the module that decides
  `correct` for it. Where it names none, check.py's band check decides:
  it follows the program with reference/ising.py (checkerboard
  Metropolis), reads the storage with reference/storage_<backend>.py and
  judges the answers with reference/answer_<call>.py. Either module
  has the same surface, which the harness calls the same way:
  - `LIMITS`: {name: limit} of the numbers it compares, each limit
    declared beside its reason in the module;
  - `follow(cell, want, sim, root)`: a follower, made in set-up from the
    program's start (measurement 0), whose `add(m, sim)` takes the
    program's state at measurement m (1 the warm-up's end, then one a
    window's interval) into buffers it made at the start; `want` is the
    reference's SimConfig (the configuration's, with the run's seed,
    never the overrides). It keeps no reference to the program;
  - `final(follower, sim, answers)`: {name: count} of what is judged on
    the program's final state, while the program lives;
  - `verdict(follower, final, answers, device)`: every name of LIMITS
    with its count, and `steps_checked`, worked out after the program and
    its memory are freed, on `device`.
  A run is correct where every count is within its limit and
  steps_checked > 0.
* its cut for the CPU tests: tests/tiny/configs/<name>.json, the keys it
  changes to run at a tiny size (tests/tiny/traffic/<name>.json for a
  traffic mix). A configuration without one is skipped there.

The window drives the program's own entry points: `advance` (the step
loop and the kernels), `block`, and the traffic's measurement call. The
harness keeps its own spans around each call and puts nothing inside the
program.
"""

from __future__ import annotations

import collections
import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import torch

from . import check
from . import trace as tr

ROOT = Path(__file__).resolve().parent.parent
PKG = "isingbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "ising_tpu")
# The folders whose modules the harness finds by name.
FOLDERS = ("metrics", "reference", "calls", "checks")
DEFAULT_PROGRAM = "ising_tpu_torch.driver.Simulation"


@dataclasses.dataclass
class Cell:
    name: str
    bench: dict
    config: dict
    traffic: dict
    root: Path

    def metrics(self, kind: str) -> list:
        """The cell's entries of bench[kind] ("end_to_end" or
        "per_layer"): those that list it, and those that list no cell
        (a per-layer one where the cell reports the metric it moves)."""
        e2e = {m["name"] for m in self.bench["end_to_end"]
               if self.name in m.get("workloads", [self.name])}
        return [m for m in self.bench[kind]
                if self.name in m.get("workloads", [self.name])
                and (kind == "end_to_end" or "workloads" in m
                     or m["moves"] in e2e)]


def find_cell(workload: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; one of "
                         f"{sorted(cells)}")
    w = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / PKG / "traffic" /
                          f"{w['traffic']}.json").read_text())
    return Cell(workload, bench, config, traffic, root)


def load(root: Path, folder: str, name: str):
    """The module <folder>/<name>.py of the benchmark under root."""
    path = root / PKG / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"{PKG}_{folder}_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def program_class(config: dict):
    """The class the configuration's "program" names, Simulation where it
    names none."""
    path = config.get("program", DEFAULT_PROGRAM)
    module, _, name = path.rpartition(".")
    try:
        cls = getattr(importlib.import_module(module), name)
    except (ImportError, AttributeError, ValueError) as e:
        raise SystemExit(f'configuration key "program": {path!r} does not '
                         f"import ({type(e).__name__}: {e})") from e
    if not isinstance(cls, type):
        raise SystemExit(f'configuration key "program": {path!r} names no '
                         "class")
    return cls


def check_of(config: dict, root: Path):
    """The module that decides `correct`: checks/<name>.py where the
    configuration's "check" names one, else check.py's band check."""
    name = config.get("check")
    if name is None:
        return check
    if not (root / PKG / "checks" / f"{name}.py").is_file():
        raise SystemExit(f'configuration key "check": no '
                         f"{PKG}/checks/{name}.py")
    return load(root, "checks", name)


@dataclasses.dataclass
class Span:
    name: str
    t0: float
    t1: float
    interval: int        # the window's interval, -1 in the warm-up
    traced: bool
    launches: int        # kernel launches the call made
    device_s: float | None = None   # its time on the device, where marked

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass
class Run:
    """What a run measured, for the metric readers. Times in seconds on
    the host's clock, from the window's start where they are instants."""
    cell: Cell
    cfg: object              # ising_tpu_torch.config.SimConfig
    every: int               # steps between measurements
    setup_s: float
    window_s: float
    intervals: int           # measurements the window completed
    result_times: list       # when each reached the host
    spans: list
    peak_bytes: int
    trace: tr.Trace | None = None
    traced_intervals: int = 0

    @property
    def steps(self) -> int:
        return self.intervals * self.every

    @property
    def traced_steps(self) -> int:
        return self.traced_intervals * self.every


def launch_counters(config: dict) -> list:
    """The wrappers the configuration names ("module.function"), whose
    `.launches` count their kernels' launches."""
    out = []
    for path in config.get("launch_counters", []):
        mod, name = path.rsplit(".", 1)
        out.append(getattr(importlib.import_module(mod), name))
    return out


class Spans:
    """The harness's spans: host clock always, and a profiler range while
    a trace records."""

    def __init__(self, counters):
        self.counters = counters
        self.done = []
        self.interval = -1
        self.traced = False

    def launches(self) -> int:
        return sum(c.launches for c in self.counters)

    def __call__(self, name: str, fn):
        n0 = self.launches()
        t0 = time.perf_counter()
        if self.traced:
            with torch.profiler.record_function(tr.PREFIX + name):
                out = fn()
        else:
            out = fn()
        self.done.append(Span(name, t0, time.perf_counter(), self.interval,
                              self.traced, self.launches() - n0))
        return out


class Mark:
    """A point in the device's stream of work (a CUDA event) or, on the
    CPU, where every call has finished when it returns, on the host's
    clock."""

    def __init__(self, device):
        self.event = None
        if device.type == "cuda":
            self.event = torch.cuda.Event(enable_timing=True)
            self.event.record(torch.cuda.current_stream(device))
        else:
            self.t = time.perf_counter()

    def wait(self):
        if self.event is not None:
            self.event.synchronize()

    def since(self, other: "Mark") -> float:
        """Seconds from `other` to this point, both reached."""
        if self.event is not None:
            return other.event.elapsed_time(self.event) * 1e-3
        return self.t - other.t


class Ahead:
    """The traffic's measurement dispatched ahead of the host. calls/<call>
    .py splits the call: issue(sim) enqueues the program's work and
    returns the answer as a device tensor; finish(sim, host) makes the
    call's answer from its host copy. Each copy goes into a host buffer of
    its own between two marks; the host waits for the oldest only when
    more than `depth` are in flight, so the device stays fed through a
    stall of the host's. An answer is delivered when its copy has landed:
    its time comes from the marks, and so does the measurement's time on
    the device (the span's device_s)."""

    def __init__(self, split, sim, device, spans, span_name: str,
                 depth: int):
        self.split, self.sim, self.device = split, sim, device
        self.spans, self.span_name, self.depth = spans, span_name, depth
        self.pinned = self.device.type == "cuda"
        self.free, self.flight = [], collections.deque()
        self.start = None

    def issue(self):
        def enqueue():
            before = Mark(self.device)
            out = self.split.issue(self.sim)
            host = (self.free.pop() if self.free else
                    torch.empty(out.shape, dtype=out.dtype,
                                pin_memory=self.pinned))
            host.copy_(out, non_blocking=self.pinned)
            return before, host, Mark(self.device)
        before, host, after = self.spans(self.span_name, enqueue)
        self.flight.append((self.spans.done[-1], before, host, after))

    def settle(self, keep: int, answers: list, result_times: list):
        """Take in the oldest answers until `keep` are in flight."""
        while len(self.flight) > keep:
            span, before, host, after = self.flight.popleft()
            after.wait()
            answers.append(self.split.finish(self.sim, host.clone()))
            span.device_s = after.since(before)
            if self.start is not None:
                result_times.append(after.since(self.start))
            self.free.append(host)

    def fill(self):
        """Host buffers for every answer in flight, made in set-up."""
        like = self.free[0]
        while len(self.free) < self.depth + 1:
            self.free.append(torch.empty(like.shape, dtype=like.dtype,
                                         pin_memory=self.pinned))


def build_config(config: dict, device: str, overrides=None):
    from ising_tpu_torch.config import SimConfig
    fields = {f.name for f in dataclasses.fields(SimConfig)}
    kw = {k: v for k, v in config.items() if k in fields}
    kw.update(overrides or {})
    return SimConfig(**kw, device=device)


def devices_of(sim):
    return list(dict.fromkeys(sim.mesh or [sim.device]))


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             root: Path = ROOT, device: str = "cuda", mesh=None,
             overrides=None, t_start: float | None = None, log=None):
    """One run of the cell: the result line's dict. `overrides` change
    SimConfig fields of the program's run (the control), never the
    reference's; `mesh` puts the slabs on given devices."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell = find_cell(workload, root)
    traffic = cell.traffic
    every, call, span_name = (traffic["every"], traffic["call"],
                              traffic["span"])
    want = build_config(cell.config, device, {"seed": seed})
    cfg = build_config(cell.config, device, dict(overrides or {}, seed=seed))
    program = program_class(cell.config)
    checker = check_of(cell.config, root)

    t_build = time.perf_counter()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        for d in mesh or [torch.device("cuda", i) for i in range(cfg.ndev)]:
            torch.zeros(1, device=d)   # the device's allocator, set up
            torch.cuda.reset_peak_memory_stats(d)
    sim = program(cfg, mesh=mesh)
    devs = devices_of(sim)
    follower = checker.follow(cell, want, sim, root)
    spans = Spans(launch_counters(cell.config))
    observe = getattr(sim, call)
    answers, result_times = [], []
    depth = traffic.get("ahead", 0)
    ahead = (Ahead(load(root, "calls", call), sim, devs[0], spans, span_name,
                   depth) if depth else None)

    def interval(m: int):
        """Enqueue the interval's steps and its measurement; without
        `ahead`, wait for the answer and return when it reached the
        host."""
        spans("advance", lambda: sim.advance(every))
        if ahead:
            ahead.issue()
            follower.add(m, sim)
            return None
        spans("sync", sim.block)
        answers.append(spans(span_name, observe))
        t = time.perf_counter()
        follower.add(m, sim)
        return t

    t_warm = time.perf_counter()
    interval(1)
    if ahead:
        ahead.settle(0, answers, result_times)
        ahead.fill()
    prof = None
    if trace and cuda:
        # The profiler's first start loads CUPTI; let that be set-up.
        with torch.profiler.profile(activities=_activities(cuda)):
            torch.zeros(1, device=devs[0]).add_(1)
    sim.block()
    t0 = time.perf_counter()
    if ahead:
        ahead.start = Mark(ahead.device)
    setup_s = t0 - t_start
    log(f"[isingbench] {workload} seed {seed}: set-up {setup_s:.3f} s "
        f"(imports {t_build - t_start:.3f}, the program "
        f"{t_warm - t_build:.3f}, the warm-up {t0 - t_warm:.3f})")
    if trace:
        prof = torch.profiler.profile(activities=_activities(cuda))
        prof.start()
        marker = torch.profiler.record_function(tr.SLICE)
        marker.__enter__()
        spans.traced = True
    limit = traffic["trace_intervals"]
    m, traced = 1, 0
    while True:
        m += 1
        spans.interval = m - 2
        t = interval(m)
        if ahead:
            # When the time is up, nothing more is sent: what was sent
            # is waited for below, and counts, over all of that time.
            ahead.settle(depth, answers, result_times)
            done = time.perf_counter() - t0 >= seconds
        else:
            result_times.append(t - t0)
            done = result_times[-1] >= seconds
        if spans.traced and (m - 1 >= limit or done):
            if ahead:
                ahead.settle(0, answers, result_times)
            sim.block()
            marker.__exit__(None, None, None)
            prof.stop()
            spans.traced, traced = False, m - 1
        if done:
            break
    if ahead:
        ahead.settle(0, answers, result_times)
    sim.block()
    window_s = time.perf_counter() - t0
    peak = max((torch.cuda.max_memory_allocated(d) for d in devs),
               default=0) if cuda else 0
    run = Run(cell, cfg, every, setup_s, window_s, m - 1,
              result_times, spans.done, peak, traced_intervals=traced)
    if prof is not None:
        run.trace = tr.collect(prof.events())
        if run.trace is not None:
            out_dir = Path(os.environ.get("ISINGBENCH_OUT",
                                          root / ".isingbench"))
            tr.write_chrome(run.trace, out_dir / f"trace.{workload}.{seed}"
                            ".json")
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for entry in cell.metrics(kind):
        value = load(root, "metrics", entry["name"]).read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    out = {"metrics": metrics, "device": _device(devs, peak, run)}
    if run.trace is not None:
        out["breakdown"] = {"device_ops": tr.device_ops(run.trace),
                            "idle_gaps": tr.idle_gaps(run.trace)}
    log(f"[isingbench] window {window_s:.3f} s, {run.steps} steps, "
        f"{run.intervals} measurements; checking")

    t_check = time.perf_counter()
    final = checker.final(follower, sim, answers)
    ref_device = devs[0]
    del sim, observe, ahead
    if cuda:
        torch.cuda.empty_cache()
    found = checker.verdict(follower, final, answers, ref_device)
    checks = {k: {"value": found[k], "limit": v}
              for k, v in checker.LIMITS.items()}
    correct = (all(c["value"] <= c["limit"] for c in checks.values())
               and found["steps_checked"] > 0)
    log(f"[isingbench] check {time.perf_counter() - t_check:.3f} s, "
        f"{found['steps_checked']} steps followed")
    for k, c in checks.items():
        log(f"check {k} {c['value']} limit {c['limit']}")
    # Last, once every module the run needs (the metrics' readers and the
    # reference's) has loaded.
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package are loaded: "
                         f"{found}")
    return {"correct": correct, "attempted": run.intervals, "failed": 0,
            **out, "checks": checks}


def _activities(cuda: bool):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _device(devs, peak: int, run: Run) -> dict:
    cuda = devs[0].type == "cuda"
    out = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(devs[0]) if cuda else "cpu",
           "count": len(devs), "memory_peak_bytes": int(peak)}
    if run.trace is not None:
        t = run.trace
        busy = sum(tr.busy_us(t, d) for d in t.devices)
        out["busy_s"] = busy / len(t.devices) * 1e-6
        out["window_s"] = t.window_us * 1e-6
    return out
