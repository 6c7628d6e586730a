"""Hysteresis loop under a cycled uniform external field (beyond the
reference, which has no field term).

Below Tc the magnetization lags the field: sweeping h from +h_max to
-h_max and back traces the classic open loop whose area is the dissipated
work per cycle. Uses Simulation.set_field (a new threshold table and
accept, the same kernels) on the xla backend's full-table path, or the
bit1 flagship's 10-class bit-serial accept (--backend bit1, a bit-plane
rng mode or hw: set_field retunes its k-bit thresholds for each h). The
port of the JAX package's examples/hysteresis.py: its flags, defaults
and lines, on the card unless --device cpu; matplotlib is imported only
with --png.

Usage:
    python3 -m ising_tpu_torch.examples.hysteresis [--size 128]
        [--temp 1.8] [--hmax 1.0] [--steps 21] [--sweeps 60]
        [--png hysteresis.png] [--device cuda]
"""

import argparse

import numpy as np

from ising_tpu_torch import SimConfig
from ising_tpu_torch.driver import Simulation


def loop(size, temp, hmax, steps, sweeps, seed, backend="xla",
         rng="threefry13", device="cuda"):
    # Start saturated at +h_max; each leg nudges h and re-equilibrates
    # briefly — short on purpose: hysteresis IS the lag of m behind h.
    hs_down = np.linspace(hmax, -hmax, steps)
    hs_up = np.linspace(-hmax, hmax, steps)
    sim = Simulation(SimConfig(nrows=size, ncols=size, temp=temp,
                               seed=seed, backend=backend, rng=rng,
                               field=float(hmax), device=device))
    sim.advance(10 * sweeps)  # saturate at +h_max
    out = []
    for leg, hs in (("down", hs_down), ("up", hs_up)):
        for h in hs:
            if h == 0.0:
                # keep h infinitesimally off zero: the full-table accept
                # path stays active, and the loop stays well-defined
                h = 1e-12 if leg == "up" else -1e-12
            sim.set_field(float(h))
            sim.advance(sweeps)
            m = sim.measure()
            out.append((float(h), m["m_signed"]))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--temp", type=float, default=1.8)
    ap.add_argument("--hmax", type=float, default=1.0)
    ap.add_argument("--steps", type=int, default=21)
    ap.add_argument("--sweeps", type=int, default=60)
    ap.add_argument("--seed", type=int, default=2026)
    ap.add_argument("--backend", default="xla",
                    help="xla (u32 full table) or bit1 (10-class "
                         "bit-serial accept; pick a ...b/hw rng)")
    ap.add_argument("--rng", default=None,
                    help="rng mode (default: threefry13 for xla, "
                         "chacha8b for bit1)")
    ap.add_argument("--png", default=None,
                    help="write a matplotlib plot of the loop")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.rng is None:
        args.rng = "chacha8b" if args.backend == "bit1" else "threefry13"
    pts = loop(args.size, args.temp, args.hmax, args.steps, args.sweeps,
               args.seed, backend=args.backend, rng=args.rng,
               device=args.device)
    n = len(pts) // 2
    print(f"# hysteresis loop: {args.size}^2, T={args.temp}, "
          f"|h|<={args.hmax}")
    print("# leg  h        m")
    for i, (h, m) in enumerate(pts):
        print(f"{'down' if i < n else 'up  '}  {h:+.4f}  {m:+.6f}")
    # Loop area (trapezoid over each leg; open loop => nonzero area)
    hs = np.array([p[0] for p in pts])
    ms = np.array([p[1] for p in pts])
    area = -float(np.trapezoid(ms[:n], hs[:n])) - float(
        np.trapezoid(ms[n:], hs[n:]))
    print(f"# loop area (dissipated work per cycle): {area:.4f}")

    if args.png:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(5, 4))
        ax.plot(hs[:n], ms[:n], "o-", ms=3, label="h decreasing")
        ax.plot(hs[n:], ms[n:], "s-", ms=3, label="h increasing")
        ax.set_xlabel("external field h")
        ax.set_ylabel("magnetization m")
        ax.set_title(f"2D Ising hysteresis, L={args.size}, T={args.temp}")
        ax.legend()
        ax.grid(alpha=0.3)
        fig.tight_layout()
        fig.savefig(args.png, dpi=150)
        print(f"# wrote {args.png}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
