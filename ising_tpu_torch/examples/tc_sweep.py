"""Binder-cumulant critical-temperature sweep (the SURVEY.md §7.5 workload).

For each lattice size L, one big lattice holds many independent L x L
replicas (the reference's sub-lattice mode, optimized/README.md:143-199);
per-replica magnetization moments accumulate over the measurement window,
and the Binder cumulant curves of two sizes cross at Tc = 2.269185...
The port of the JAX package's examples/tc_sweep.py: its flags, defaults
and lines, on the card unless --device cpu.

Usage:
    python3 -m ising_tpu_torch.examples.tc_sweep [--sizes 16,32]
        [--replicas 64] [--backend xla] [--warmup 400] [--measure 200]
        [--every 4] [--device cuda]

bit1 takes replicas where xsl/2 divides ncols/64 and ysl % 8 == 0: with
rx = floor(sqrt(replicas)) replicas across, rx a multiple of 32 at sizes
8 and 16 (--replicas 1024), of 128 at sizes 64 and 128 (16384).
"""

import argparse
import math

import numpy as np

from ising_tpu_torch import SimConfig, TCRIT
from ising_tpu_torch.analysis import (MomentAccumulator, binder_crossing,
                                      fit_collapse, jackknife_binder_u4)
from ising_tpu_torch.cluster import SwendsenWang
from ising_tpu_torch.driver import Simulation


def sweep(sizes, temps, replicas, warmup, measure, every, backend, seed,
          algo="metropolis", device="cuda"):
    """(u4, u4e): each size's U4 and jackknife error at each temperature."""
    u4 = {L: [] for L in sizes}
    u4e = {L: [] for L in sizes}
    for L in sizes:
        # Pack `replicas` LxL systems into one lattice (grid as square as
        # the packed-backend divisibility allows).
        rx = max(1, int(math.sqrt(replicas)))
        ry = (replicas + rx - 1) // rx
        cfg_kw = dict(nrows=ry * L, ncols=rx * L, xsl=L, ysl=L,
                      backend="xla" if algo == "sw" else backend,
                      seed=seed, device=device)
        for t in temps:
            if algo == "sw":
                # Replica-mode Swendsen-Wang: every replica decorrelates
                # in ~3 cluster updates even AT Tc, so warmup/measure
                # counts can be ~100x smaller than Metropolis sweeps
                # for the same effective sample size.
                sim = SwendsenWang(SimConfig(temp=float(t), **cfg_kw))
            else:
                sim = Simulation(SimConfig(temp=float(t),
                                           niters=warmup + measure,
                                           **cfg_kw))
            sim.advance(warmup)
            acc = MomentAccumulator()
            per_replica = []  # per-replica mean moments -> jackknife error
            done = 0
            while done < measure:
                sim.advance(every)
                done += every
                ms = sim.replica_magnetizations()
                acc.add(ms)
                per_replica.append(np.asarray(ms, np.float64))
            u4[L].append(acc.binder_cumulant())
            # Jackknife over REPLICAS (independent systems; measurements
            # within one replica are correlated, so resample the replica
            # axis) — the right error bar for the nonlinear U4; in
            # O(replicas), where analysis.jackknife takes O(replicas^2).
            _, u4_err = jackknife_binder_u4(np.stack(per_replica, axis=1))
            # nan-safe floor (max(nan, x) is nan): a degenerate jackknife
            # point must not poison every collapse_quality weight
            u4e[L].append(u4_err if np.isfinite(u4_err) and u4_err > 1e-6
                          else 1e-6)
            print(f"L={L:4d} T={t:6.4f}  <|m|>={acc.mean:8.5f}  "
                  f"U4={u4[L][-1]:8.5f} +- {u4_err:.5f}  "
                  f"({acc.n} samples)", flush=True)
    return u4, u4e


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="16,32")
    ap.add_argument("--replicas", type=int, default=64)
    ap.add_argument("--tmin", type=float, default=0.92 * TCRIT)
    ap.add_argument("--tmax", type=float, default=1.08 * TCRIT)
    ap.add_argument("--ntemps", type=int, default=7)
    ap.add_argument("--warmup", type=int, default=400)
    ap.add_argument("--measure", type=int, default=200)
    ap.add_argument("--every", type=int, default=4)
    ap.add_argument("--backend", default="xla")
    ap.add_argument("--seed", type=int, default=20260816)
    ap.add_argument("--algo", default="metropolis",
                    choices=("metropolis", "sw"),
                    help="sw = replica-mode Swendsen-Wang: warmup/"
                         "measure/every count SW updates (use ~100x "
                         "smaller values than Metropolis sweeps)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    sizes = [int(s) for s in args.sizes.split(",")]
    temps = np.linspace(args.tmin, args.tmax, args.ntemps)
    u4, u4e = sweep(sizes, temps, args.replicas, args.warmup, args.measure,
                    args.every, args.backend, args.seed, algo=args.algo,
                    device=args.device)
    tc = binder_crossing(temps, {L: np.asarray(v) for L, v in u4.items()})
    print(f"\nBinder crossing estimate: Tc ~ {tc:.4f} "
          f"(exact {TCRIT:.6f}, error {abs(tc - TCRIT) / TCRIT * 100:.2f}%)")
    # Full finite-size-scaling fit: collapse U4(T, L) onto one master
    # curve over (Tc, nu) (exact 2D Ising: nu = 1). Needs overlapping
    # scaled windows — a very coarse grid may not provide them.
    try:
        fit = fit_collapse({L: (temps, np.asarray(u4[L]), np.asarray(u4e[L]))
                            for L in sizes},
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
