"""Profiling and tracing hooks (torch).

The port of ``ising_tpu/utils/profiling.py``: where the JAX package takes
a jax.profiler trace, the port records a torch.profiler trace (CPU
activity, and CUDA activity when the run is on the card: the kernels'
launches and device time, through CUPTI) and writes it into a directory
as a Chrome trace, which chrome://tracing or Perfetto open; `annotate`
marks a named range in it; `StepTimer` is a host-side lap timer.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(dir_path: str | None, device=None):
    """Record the region into `dir_path`/trace.json when dir_path is set;
    do nothing with None or "". CUDA activity is recorded too when
    `device` is a CUDA device, or with device None when a card is
    present."""
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


@contextlib.contextmanager
def annotate(name: str):
    """Named sub-region (shows up in the trace timeline)."""
    with torch.profiler.record_function(name):
        yield


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
