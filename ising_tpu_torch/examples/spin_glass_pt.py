"""Parallel tempering on a 2D +-J spin glass.

The workload the reference's -J flag stops short of (its quenched
disorder runs at ONE temperature, optimized/main.cu:1374-1378): a
frustrated realization is annealed by replica exchange over a geometric
temperature ladder, and the cold rung's energy is compared against a
plain single-temperature run of the same length on the same links
(j_seed pins the realization). Tempering should match or beat the
quench: cold replicas escape local minima by diffusing up the ladder.
A second independent ladder on the same links supplies the per-rung
Edwards-Anderson overlaps q(T_k) (tempering.replica_overlap) and the
cold-rung overlap Binder ratio (analysis.binder_g) — the observables a
spin-glass study actually publishes.

Rung spacing must shrink as 1/sqrt(nspins) for healthy exchange rates
(dE between rungs grows with N while the Metropolis window does not), so
scale --rungs up with --size; the defaults give ~0.1-0.5 acceptance per
pair at size 32. The port of the JAX package's examples/spin_glass_pt.py:
its flags, defaults and lines, on the card unless --device cpu.

Usage:
    python3 -m ising_tpu_torch.examples.spin_glass_pt [--size 32]
        [--rungs 12] [--tmin 0.8] [--tmax 2.0] [--rounds 60] [--sweeps 4]
        [--jprob 0.5] [--backend xla] [--seed 463463564571] [--device cuda]
"""

import argparse
import dataclasses

import numpy as np

from ising_tpu_torch import SimConfig
from ising_tpu_torch.analysis import binder_g, binder_g_disorder
from ising_tpu_torch.driver import Simulation
from ising_tpu_torch.tempering import (ParallelTempering, equalize_ladder,
                                       replica_overlap)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--rungs", type=int, default=12)
    ap.add_argument("--tmin", type=float, default=0.8)
    ap.add_argument("--tmax", type=float, default=2.0)
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--sweeps", type=int, default=4)
    ap.add_argument("--jprob", type=float, default=0.5)
    ap.add_argument("--realizations", type=int, default=1,
                    help="disorder realizations for [g]_av (cold rung)")
    ap.add_argument("--backend", default="xla")
    ap.add_argument("--seed", type=int, default=463463564571)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    # Geometric ladder T_k = tmin * (tmax/tmin)^(k/(K-1)) — constant
    # neighbor beta-ratio, the standard starting spacing.
    K = args.rungs
    temps = [args.tmin * (args.tmax / args.tmin) ** (k / (K - 1))
             for k in range(K)]
    cfg = SimConfig(nrows=args.size, ncols=args.size, temp=args.tmin,
                    backend=args.backend, seed=args.seed,
                    j_prob=args.jprob, j_seed=args.seed, device=args.device)

    pt = ParallelTempering(cfg, temps, sweeps_per_swap=args.sweeps)

    # Feedback phase: measure acceptance on a fraction of the budget,
    # re-space the rungs where exchange is hard (equalize_ladder), then
    # run the production rounds on the tuned ladder.
    tune = max(4, args.rounds // 4)
    pt.run(tune)
    print("pre-tune  acceptance:",
          " ".join(f"{r:.2f}" for r in pt.stats()["pair_acceptance"]))
    pt.retemper(equalize_ladder(pt.temps, pt.stats()["pair_acceptance"]))

    # Second independent ladder (same links, distinct thermal seeds) on
    # the tuned grid: per-rung Edwards-Anderson overlaps q(T_k) are THE
    # spin-glass observables (P(q), Binder g) — collected each round in
    # one batched fetch per ladder pair.
    pt_b = ParallelTempering(dataclasses.replace(cfg, seed=cfg.seed + 1),
                             pt.temps, sweeps_per_swap=args.sweeps)
    pt_b.run(tune)  # match ladder A's equilibration budget
    q_samples = [[] for _ in range(K)]
    for _ in range(args.rounds - tune):
        pt.advance_round()
        pt_b.advance_round()
        for k, q in enumerate(replica_overlap(pt, pt_b)):
            q_samples[k].append(q)

    print(f"tuned ladder: {' '.join(f'{t:.3f}' for t in pt.temps)}")
    st = pt.stats()
    print("pair acceptance:",
          " ".join(f"{r:.2f}" for r in st["pair_acceptance"]))
    print("replica at rung:", st["replica_at"])
    print("round trips per replica:", st["round_trips"],
          f"(total {sum(st['round_trips'])})")
    for m, qs in zip(pt.measure(), q_samples):
        aq = np.mean(np.abs(qs)) if qs else float("nan")
        print(f"T={m['temp']:.3f}  E/N={m['energy']:+.4f}  "
              f"|m|={m['magnetization']:.4f}  <|q|>={aq:.4f}")
    if q_samples[0]:
        print(f"cold-rung overlap Binder g = {binder_g(q_samples[0]):.3f} "
              f"(1 = frozen, 0 = paramagnet)")

    # Same total sweeps, same realization, single cold temperature.
    quench = Simulation(cfg)
    quench.advance(args.rounds * args.sweeps)
    e_pt = pt.sims[0].energy()
    e_q = quench.energy()
    print(f"cold rung T={temps[0]:.3f}: tempered E/N = {e_pt:+.4f}  "
          f"vs single-T quench E/N = {e_q:+.4f}  "
          f"({'tempering lower' if e_pt < e_q else 'quench lower'})")

    # Disorder averaging: more realizations on the SAME tuned ladder,
    # each with its own quenched links and thermal streams; the
    # disorder-averaged overlap Binder [g]_av with realization-jackknife
    # errors is the published SG quantity (analysis.binder_g_disorder).
    if args.realizations > 1 and q_samples[0]:
        q2s = [float(np.mean(np.square(q_samples[0])))]
        q4s = [float(np.mean(np.power(q_samples[0], 4)))]
        for r in range(1, args.realizations):
            # thermal-seed stride 20000038 is not a multiple of the rung
            # spacing 1000003 (prime), so no stream is reused across
            # realizations or rungs either
            cfg_r = dataclasses.replace(cfg, j_seed=args.seed + 7919 * r,
                                        seed=cfg.seed + r * 20000038)
            pa = ParallelTempering(cfg_r, pt.temps,
                                   sweeps_per_swap=args.sweeps)
            pb = ParallelTempering(
                dataclasses.replace(cfg_r, seed=cfg_r.seed + 1), pt.temps,
                sweeps_per_swap=args.sweeps)
            pa.run(tune)
            pb.run(tune)
            qs = []
            for _ in range(args.rounds - tune):
                pa.advance_round()
                pb.advance_round()
                qs.append(replica_overlap(pa, pb)[0])
            q2s.append(float(np.mean(np.square(qs))))
            q4s.append(float(np.mean(np.power(qs, 4))))
        g_av, g_err = binder_g_disorder(q2s, q4s)
        print(f"disorder-averaged cold-rung Binder [g]_av = {g_av:.3f} "
              f"+- {g_err:.3f}  ({args.realizations} realizations)")
    return e_pt, e_q


if __name__ == "__main__":
    main()
