"""Locate Tc from the xi_L/L crossing, sampled with cluster updates.

The second-moment correlation length obeys xi_L/L -> universal constant
at Tc, so curves for two sizes cross there (same logic as the Binder
cumulant in tc_sweep.py, different observable). Sampling uses
Swendsen-Wang — at Tc it decorrelates in ~3 updates where Metropolis
needs hundreds of sweeps — and the xi estimator consumes only the exact
integer row/column Fourier partials (no FFT, no materialized planes).
The port of the JAX package's examples/xi_scan.py: its flags, defaults
and lines, on the card unless --device cpu.

Usage:
    python3 -m ising_tpu_torch.examples.xi_scan [--sizes 16,32]
        [--ntemps 7] [--warmup 30] [--samples 150] [--device cuda]
"""

import argparse

import numpy as np

from ising_tpu_torch import SimConfig, TCRIT
from ising_tpu_torch.analysis import (correlation_length, fit_collapse,
                                      kmin_mag2)
from ising_tpu_torch.cluster import SwendsenWang


def xi_over_L(L, T, warmup, samples, seed, device="cuda"):
    sw = SwendsenWang(SimConfig(nrows=L, ncols=L, temp=float(T),
                                seed=seed, backend="xla", device=device))
    sw.advance(warmup)
    m0s, mks = [], []
    for _ in range(samples):
        sw.advance(2)
        rows, cols = sw.fourier_partials()
        n_up = int(cols.sum())
        m0s.append(float(2 * n_up - L * L) ** 2)
        # average the two axes' |m(k1)|^2 (isotropic lattice)
        mks.append(0.5 * (kmin_mag2(cols, L) + kmin_mag2(rows, L)))
    xi, err = correlation_length(m0s, mks, L)
    return xi / L, err / L


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="16,32")
    ap.add_argument("--ntemps", type=int, default=7)
    ap.add_argument("--trange", type=float, default=0.12,
                    help="scan Tc * (1 +- trange)")
    ap.add_argument("--warmup", type=int, default=30)
    ap.add_argument("--samples", type=int, default=150)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    sizes = [int(s) for s in args.sizes.split(",")]
    temps = np.linspace(TCRIT * (1 - args.trange),
                        TCRIT * (1 + args.trange), args.ntemps)

    curves, errs = {}, {}
    for L in sizes:
        row, erow = [], []
        for T in temps:
            x, e = xi_over_L(L, T, args.warmup, args.samples,
                             args.seed + L, args.device)
            row.append(x)
            erow.append(e if np.isfinite(e) and e > 1e-6 else 1e-6)
            print(f"L={L:4d} T={T:.4f}  xi/L = {x:7.4f} +- {e:.4f}",
                  flush=True)
        curves[L] = np.asarray(row)
        errs[L] = np.asarray(erow)

    # crossing of the two largest sizes (linear interpolation on the
    # difference, like analysis.binder_crossing)
    a, b = (curves[s] for s in sorted(sizes)[-2:])
    d = a - b
    tc = float("nan")
    for i in range(len(temps) - 1):
        if d[i] == 0.0 or d[i] * d[i + 1] < 0:
            f = d[i] / (d[i] - d[i + 1]) if d[i] != d[i + 1] else 0.0
            tc = float(temps[i] + f * (temps[i + 1] - temps[i]))
            break
    print(f"xi/L crossing estimate: Tc = {tc:.4f} "
          f"(exact {TCRIT:.4f}, err {abs(tc - TCRIT):.4f})")
    # xi_L/L is dimensionless: the same scaling-collapse fit as tc_sweep
    # (zeta = 0) turns the scan into (Tc, nu) with honest error bars.
    try:
        fit = fit_collapse({L: (temps, curves[L], errs[L]) for L in sizes},
                           tc0=tc if np.isfinite(tc) else TCRIT, nu0=1.0,
                           errors=True)
        print(f"scaling collapse: Tc = {fit['tc']:.4f} +- {fit['tc_err']:.4f}"
              f"  nu = {fit['nu']:.3f} +- {fit['nu_err']:.3f}"
              f"  (quality S = {fit['quality']:.2f}; exact nu = 1)")
    except ValueError as e:
        print(f"scaling collapse skipped: {e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
