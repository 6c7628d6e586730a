"""Locate the specific-heat peak by WHAM reweighting (reweight.py demo).

Simulate a handful of temperatures around Tc, collect per-measurement
total energies, stitch the runs with the multiple-histogram method, and
golden-search the CONTINUOUS C(T) curve for the pseudo-critical
temperature T_c(L) — resolution the simulated grid itself cannot give.
The reference prints observables only at simulated temperatures
(optimized/main.cu:1095-1110); reweighting interpolates between them with
controlled statistics (ESS-guarded), which is how production studies
actually locate peaks. The port of the JAX package's
examples/reweight_peak.py: its flags, defaults and lines, on the card
unless --device cpu.

Usage:
    python3 -m ising_tpu_torch.examples.reweight_peak [--size 32]
        [--ntemps 5] [--tmin 2.1] [--tmax 2.5] [--warmup 300]
        [--samples 150] [--every 2] [--backend xla] [--device cuda]
"""

import argparse
import sys

import numpy as np

from ising_tpu_torch import SimConfig, TCRIT
from ising_tpu_torch.driver import Simulation
from ising_tpu_torch.reweight import (peak_location, reweight, wham,
                                      wham_jackknife)


def collect(L, temp, warmup, samples, every, backend, seed, device="cuda"):
    sim = Simulation(SimConfig(nrows=L, ncols=L, temp=float(temp),
                               niters=warmup + samples * every,
                               backend=backend, seed=seed, device=device))
    sim.advance(warmup)
    H = np.empty(samples)
    for i in range(samples):
        sim.advance(every)
        H[i] = -sim.energy_total()  # Hamiltonian sign convention
    return H


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--ntemps", type=int, default=5)
    ap.add_argument("--tmin", type=float, default=2.1)
    ap.add_argument("--tmax", type=float, default=2.5)
    ap.add_argument("--warmup", type=int, default=300)
    ap.add_argument("--samples", type=int, default=150)
    ap.add_argument("--every", type=int, default=2)
    ap.add_argument("--backend", default="xla")
    ap.add_argument("--seed", type=int, default=20260818)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    a = ap.parse_args(argv)
    N = a.size * a.size

    temps = np.linspace(a.tmin, a.tmax, a.ntemps)
    runs = [collect(a.size, t, a.warmup, a.samples, a.every, a.backend,
                    a.seed + i, a.device) for i, t in enumerate(temps)]
    for t, H in zip(temps, runs):
        print(f"T={t:6.4f}  <E>/N = {H.mean() / N:+.5f}  "
              f"({H.size} samples)", flush=True)

    ens = wham(runs, temps)
    print(f"WHAM converged: {ens.iterations} iterations, "
          f"residual {ens.residual:.2e}")

    # single-histogram sanity: the middle run reweighted to its neighbor
    # temperature should agree with the direct run there.
    mid = a.ntemps // 2
    if mid + 1 < a.ntemps:
        est, ess = reweight(runs[mid], float(temps[mid]),
                            float(temps[mid + 1]), min_ess=4.0)
        print(f"single-histogram {temps[mid]:.4f} -> {temps[mid + 1]:.4f}: "
              f"<E>/N = {est / N:+.5f} (direct {runs[mid + 1].mean() / N:+.5f},"
              f" ESS {ess:.0f})")

    t_peak, c_peak = peak_location(
        lambda t: ens.specific_heat(t, N), a.tmin, a.tmax, tol=1e-5)
    _, t_err = wham_jackknife(
        runs, temps,
        lambda e: peak_location(lambda t: e.specific_heat(t, N),
                                a.tmin, a.tmax, tol=1e-4)[0],
        nblocks=min(8, a.samples // 2))
    print(f"C/N peak: T_c(L={a.size}) = {t_peak:.4f} +- {t_err:.4f}  "
          f"(C/N = {c_peak:.4f}; infinite-volume Tc = {TCRIT:.4f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
