"""Simulation driver of the port: state, step loop and measurement loop.

The port of ``ising_tpu/driver.py`` for one device without disorder or
replicas: the same print schedules, the same log lines, the same flips/ns
and bandwidth formula, the temperature ramp and the external field. Steps
run as host-issued launches; the host synchronises only at measurement
events.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from . import observables
from .config import SimConfig, resolve_device
from .constants import MIN_TEMP, TGT_MAGN_MAX_DIFF
from .lattice import init_store
from .models import ising
from .ops import get_backend
from .parallel import make_stepper

TIMED_WINDOW = "run_loop.timed_window"


def exponential_print_steps(nsteps: int) -> list[int]:
    """Measurement steps: the distinct values of rint(2^(j/4)) <= nsteps."""
    out = []
    j = 0
    while True:
        t = int(round(2.0 ** (j / 4.0)))
        if t > nsteps:
            break
        if not out or t != out[-1]:
            out.append(t)
        j += 1
    return out


def reference_exp_times(nsteps: int) -> list[int]:
    """The -E schedule: from 152, the first rint(2^(j/4)) at least twice
    the previous entry, up to 200 entries (callers filter to <= nsteps)."""
    times = [152]
    t = 0
    j = 0
    while j < nsteps and t < nsteps:
        t = int(round(2.0 ** (j / 4.0)))
        if t >= 2 * times[-1] and len(times) < 200:
            times.append(t)
        j += 1
    return times


class Simulation:
    """One Ising MC run: state on `cfg.device`, stepper, measurements."""

    def __init__(self, cfg: SimConfig):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.temp = cfg.temperature
        self.step = 0
        self.backend = get_backend(cfg)
        self._step_n = make_stepper(cfg, self.backend)
        self.black, self.white = init_store(cfg.seed, cfg.nrows, cfg.ncols,
                                            self.backend.encode,
                                            device=self.device)
        self._thr = ising.threshold_table(self.temp, cfg.field)

    def bits(self):
        """Current (black, white) uint8 bit planes (decoded)."""
        return self.backend.decode(self.black, self.white)

    def _up_rows(self):
        """Per-row up counts: the backend's own reduction where it has one
        (bit1's popcount on words), else on the decoded planes."""
        if hasattr(self.backend, "row_up_counts"):
            return self.backend.row_up_counts(self.black, self.white)
        return observables.row_up_counts(*self.bits())

    def measure(self):
        n_up = int(self._up_rows().sum())
        n_dn = self.cfg.nspins - n_up
        m = abs(n_up - n_dn) / (n_up + n_dn)
        out = {"step": self.step, "magnetization": m,
               "up": n_up, "down": n_dn}
        if self.cfg.field:
            # An external field breaks the +-m symmetry |m| relies on.
            out["m_signed"] = (n_up - n_dn) / (n_up + n_dn)
        return out

    def advance(self, nsteps: int):
        """Enqueue nsteps steps (returns before the card finishes)."""
        if nsteps <= 0:
            return
        self.black, self.white = self._step_n(
            self.black, self.white, self._thr, self.step, nsteps)
        self.step += nsteps

    def block(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def set_temperature(self, temp: float):
        """New thresholds: the u32 table, and the backend's accept (the
        greedy quench when T crosses 0, the k-bit thresholds of the
        bit-plane accepts)."""
        self.temp = float(temp)
        self._thr = ising.threshold_table(self.temp, self.cfg.field)
        self.backend.retune(self.temp, self.cfg.field)

    def set_field(self, field: float):
        """Change the uniform external field mid-run. SimConfig's
        validation fences the backend / rng pairs; the u32 table and the
        backend's accept (the bit-plane accept's field, the xla backend's
        full-table select) follow the new value."""
        field = float(field)
        if field == self.cfg.field:
            return
        self.cfg = dataclasses.replace(self.cfg, field=field)
        self._thr = ising.threshold_table(self.temp, field)
        self.backend.retune(self.temp, field)

    def energy_total(self) -> int:
        """Exact integer bond sum over the current state (H = -this)."""
        if hasattr(self.backend, "energy_rows"):
            rows = self.backend.energy_rows(self.black, self.white)
        else:
            rows = observables.energy_row_sums(*self.bits())
        return int(rows.sum())

    def energy(self) -> float:
        """Internal energy per spin; a field adds its exact -h sum(s)."""
        e = -float(self.energy_total())
        h = self.cfg.field
        if h:
            e -= h * (2 * int(self._up_rows().sum()) - self.cfg.nspins)
        return e / self.cfg.nspins

    def run(self, log=print):
        return run_loop(self, log=log)


def run_loop(self, log=print):
    """The measurement loop: warmup, events on the -p / -e / -E schedule,
    early exit (-m), temperature ramp (-u), final report with flips/ns."""
    cfg = self.cfg
    t_unit = cfg.temperature

    if cfg.nwarmup:
        self.advance(cfg.nwarmup)
        self.block()

    events = set()
    if cfg.print_exp and cfg.exp_thinned:
        events.update(t for t in reference_exp_times(cfg.niters)
                      if t <= cfg.niters)
    elif cfg.print_exp:
        events.update(exponential_print_steps(cfg.niters))
    elif cfg.print_freq:
        events.update(range(cfg.print_freq, cfg.niters + 1,
                            cfg.print_freq))
    temp_events = set()
    if cfg.temp_freq:
        temp_events.update(range(cfg.temp_freq, cfg.niters + 1,
                                 cfg.temp_freq))
    all_events = sorted(events | temp_events | {cfg.niters})

    m0 = self.measure()
    log(f"Initial magnetization: {m0['magnetization']:9.6f}, "
        f"up_s: {m0['up']:12d}, dw_s: {m0['down']:12d}")
    series = [(0, m0["magnetization"])]

    self.block()
    t0 = time.perf_counter()
    # The span that flips/ns times, for a profiler trace (device_trace.py).
    with torch.profiler.record_function(TIMED_WINDOW):
        base = self.step
        done = 0
        stopped_early = False
        for ev in all_events:
            self.advance(base + ev - self.step)
            done = ev
            if ev in events:
                self.block()
                mm = self.measure()
                series.append((ev, mm["magnetization"]))
                log(f"        magnetization: {mm['magnetization']:9.6f}, "
                    f"up_s: {mm['up']:12d}, dw_s: {mm['down']:12d} "
                    f"(iter: {ev:8d})")
                if cfg.tgt_magn is not None and \
                        abs(mm["magnetization"] - cfg.tgt_magn) \
                        < TGT_MAGN_MAX_DIFF:
                    stopped_early = True
                    break
            if ev in temp_events:
                new_t = max(MIN_TEMP, self.temp + cfg.temp_step)
                log(f"Changing temperature to {new_t:f}")
                self.set_temperature(new_t)
        self.block()
    elapsed = time.perf_counter() - t0

    mf = self.measure()
    log(f"Final   magnetization: {mf['magnetization']:9.6f}, "
        f"up_s: {mf['up']:12d}, dw_s: {mf['down']:12d} "
        f"(iter: {done:8d})")

    flips = cfg.nspins * done
    flips_ns = flips / (elapsed * 1e9) if elapsed > 0 else 0.0
    # Effective lattice traffic: per color phase read src + read dst +
    # write dst.
    bw = flips_ns * 3.0 * self.backend.bytes_per_spin
    log(f"Kernel execution time for {done} update steps: "
        f"{elapsed * 1e3:E} ms, {flips_ns:.2f} flips/ns "
        f"(BW: {bw:.2f} GB/s)")
    return {"steps": done, "elapsed_s": elapsed, "flips_ns": flips_ns,
            "bw_gbs": bw, "magnetization": mf["magnetization"],
            "stopped_early": stopped_early, "series": series,
            "temp_final": self.temp, "alpha_unit": t_unit}
