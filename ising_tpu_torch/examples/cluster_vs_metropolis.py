"""Critical slowing down, measured: Swendsen-Wang vs Metropolis at Tc.

Runs both dynamics on the same L x L lattice at the critical temperature
and reports the integrated autocorrelation time of |m| (Madras-Sokal
window) in UPDATE units — one SW cluster update vs one full Metropolis
sweep. Near Tc, tau_Metropolis ~ L^2.17 while tau_SW ~ L^0.35: the reason
cluster.py exists (the reference has no cluster algorithm at all). The
port of the JAX package's examples/cluster_vs_metropolis.py: its flags,
defaults and lines, on the card unless --device cpu.

Usage:
    python3 -m ising_tpu_torch.examples.cluster_vs_metropolis [--size 64]
        [--warmup 200] [--samples 2000] [--sw-samples 400] [--device cuda]
"""

import argparse

import numpy as np

from ising_tpu_torch import SimConfig, TCRIT
from ising_tpu_torch.analysis import autocorrelation_time, binned_error
from ising_tpu_torch.cluster import SwendsenWang
from ising_tpu_torch.driver import Simulation


def series(sim, n):
    out = []
    for _ in range(n):
        sim.advance(1)
        out.append(sim.measure()["magnetization"])
    return np.asarray(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--warmup", type=int, default=200)
    ap.add_argument("--samples", type=int, default=2000,
                    help="Metropolis sweeps measured")
    ap.add_argument("--sw-samples", type=int, default=400,
                    help="SW updates measured")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    kw = dict(nrows=args.size, ncols=args.size, temp=TCRIT,
              seed=args.seed, backend="xla", device=args.device)

    sw = SwendsenWang(SimConfig(**kw))
    sw.advance(max(20, args.warmup // 10))  # SW equilibrates in O(1) steps
    ms_sw = series(sw, args.sw_samples)
    tau_sw, w_sw = autocorrelation_time(ms_sw)

    met = Simulation(SimConfig(**kw))
    met.advance(args.warmup)
    ms_met = series(met, args.samples)
    tau_met, w_met = autocorrelation_time(ms_met)

    L = args.size
    print(f"# L={L}, T=Tc={TCRIT:.6f}, |m| autocorrelation")
    print(f"Swendsen-Wang: tau_int = {tau_sw:6.2f} updates (window {w_sw}), "
          f"<|m|> = {ms_sw.mean():.4f} +- {binned_error(ms_sw):.4f}")
    print(f"Metropolis:    tau_int = {tau_met:6.2f} sweeps  (window {w_met}), "
          f"<|m|> = {ms_met.mean():.4f} +- {binned_error(ms_met):.4f}")
    print(f"speedup in decorrelation units: {tau_met / tau_sw:.1f}x")
    if tau_met > args.samples / 20:
        print("# note: Metropolis tau is window-limited at this sample "
              "count — the true ratio is LARGER; raise --samples.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
