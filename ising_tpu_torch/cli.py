"""Command-line interface of the port: the JAX package's flags, plus
--device. Runs on the card unless --device cpu is given:

    python -m ising_tpu_torch --backend bit1 -y 2048 -x 2048 -n 128 -a 0.66 -p 16
    python -m ising_tpu_torch --algo sw -x 4096 -y 4096 -n 64 -a 1.0 -p 8
    python -m ising_tpu_torch -x 1024 -y 1024 -J 0.5 --pt 0.8,1.0,1.3,1.7 -n 200 -p 50

Without --backend it runs the xla backend (plain torch), as the JAX
package's CLI does; --algo sw runs Swendsen-Wang cluster updates on it.
--pt runs parallel tempering over a ladder on any backend (-n counts swap
rounds).

-o dumps the lattice and -c appends correlation rows at each measurement,
--checkpoint saves the run at its end and --resume continues one, in the
JAX package's file formats. --devs N splits the rows over N slabs on the
first N GPUs (--device cpu: N slabs on the CPU), with the trajectory and
lines of one device; -o then writes one final dump per slab. --profile DIR
records the run loop with torch.profiler (CUDA activity too on the card)
and writes a Chrome trace into DIR (utils/profiling.py).
"""

from __future__ import annotations

import argparse
import sys

from .config import SimConfig
from .constants import ALPHA_DEF, SEED_DEF, TCRIT
from .rng import RNG_MODES


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ising-tpu-torch",
        description="2D Ising Monte Carlo (checkerboard Metropolis) in "
                    "PyTorch with hand-written CUDA kernels")
    p.add_argument("-x", "--cols", type=int, default=2048,
                   help="lattice columns (X)")
    p.add_argument("-y", "--rows", type=int, default=2048,
                   help="lattice rows (Y)")
    p.add_argument("-n", "--nit", type=int, default=128,
                   help="number of trial iterations")
    p.add_argument("-w", "--nwarmup", type=int, default=0,
                   help="number of warmup iterations")
    p.add_argument("-s", "--seed", type=int, default=SEED_DEF,
                   help="random seed")
    p.add_argument("-a", "--alpha", type=float, default=None,
                   help=f"temperature = alpha * T_crit ({TCRIT:.6f}); "
                        f"default alpha {ALPHA_DEF}")
    p.add_argument("-t", "--temp", type=float, default=None,
                   help="absolute temperature (overrides --alpha)")
    p.add_argument("-p", "--print", dest="print_freq", type=int, default=0,
                   help="print magnetization every PRINT steps")
    p.add_argument("-e", "--exppr", action="store_true",
                   help="print on the exponential 2^(j/4) schedule")
    p.add_argument("-E", "--exppr-ref", action="store_true",
                   help="like -e but with >=2x thinning from step 152")
    p.add_argument("-m", "--magn", dest="tgt_magn", type=float, default=None,
                   help="stop when |magnetization - MAGN| < 1e-3")
    p.add_argument("-u", "--update", metavar="STEP,FREQ", default=None,
                   help="temperature ramp: add STEP every FREQ steps")
    p.add_argument("-J", "--j-prob", type=float, default=None,
                   help="probability of antiferromagnetic links "
                        "(quenched +-J disorder)")
    p.add_argument("--j-seed", type=int, default=None,
                   help="seed for the disorder realization")
    p.add_argument("--field", type=float, default=0.0,
                   help="uniform external field h (bit1: bit-plane rng "
                        "modes and hw; packed, dense: u32 modes; xla: any "
                        "mode; mxu: none)")
    p.add_argument("--xsl", type=int, default=None,
                   help="X size of independent sub-lattice replicas")
    p.add_argument("--ysl", type=int, default=None,
                   help="Y size of independent sub-lattice replicas")
    p.add_argument("-d", "--devs", type=int, default=1,
                   help="number of devices (row-slab sharding)")
    p.add_argument("--halo-overlap", action="store_true",
                   help="split each slab's sweep into an interior and two "
                        "boundary bands (ndev > 1; trajectories unchanged)")
    p.add_argument("-o", "--out", action="store_true",
                   help="dump lattice at each measurement and at the end")
    p.add_argument("-c", "--corr", action="store_true",
                   help="append 2-point correlation rows to a corr_* file")
    p.add_argument("--backend", default="xla",
                   choices=("xla", "dense", "packed", "bit1", "mxu"),
                   help="update backend")
    p.add_argument("--rng", default="threefry13",
                   choices=tuple(sorted(RNG_MODES)),
                   help="rng mode: counter modes (u32 or bit-plane ...b; "
                        "chacha6b is the fast tier) or hw")
    p.add_argument("--algo", default="metropolis",
                   choices=("metropolis", "sw"),
                   help="update algorithm: checkerboard Metropolis, or "
                        "Swendsen-Wang cluster updates (sw; backend xla)")
    p.add_argument("--pt", default=None, metavar="T1,T2,...",
                   help="parallel tempering over the given temperature "
                        "ladder (-n counts swap rounds; with -J for spin "
                        "glasses)")
    p.add_argument("--sweeps-per-swap", type=int, default=8,
                   help="Metropolis sweeps between swap phases (--pt)")
    p.add_argument("--use-common-seed", action="store_true",
                   help="accepted for CLI parity; a no-op")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the run "
                        "into DIR")
    p.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="write a checkpoint at the end of the run")
    p.add_argument("--resume", default=None, metavar="PATH",
                   help="resume from a checkpoint (its config; the other "
                        "flags but --device are ignored)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    return p


def config_from_args(args) -> SimConfig:
    temp_step, temp_freq = 0.0, 0
    if args.update:
        parts = args.update.split(",")
        if len(parts) != 2:
            raise SystemExit("-u expects STEP,FREQ (e.g. -u 0.01,100)")
        temp_step, temp_freq = float(parts[0]), int(parts[1])
    return SimConfig(
        nrows=args.rows, ncols=args.cols, temp=args.temp, alpha=args.alpha,
        seed=args.seed, backend=args.backend, rng=args.rng,
        nwarmup=args.nwarmup, niters=args.nit,
        print_freq=args.print_freq,
        print_exp=args.exppr or args.exppr_ref, exp_thinned=args.exppr_ref,
        tgt_magn=args.tgt_magn, temp_step=temp_step, temp_freq=temp_freq,
        j_prob=args.j_prob, j_seed=args.j_seed, field=args.field,
        xsl=args.xsl, ysl=args.ysl, ndev=args.devs,
        halo_overlap=args.halo_overlap,
        dump_lattice=args.out, corr_out=args.corr, device=args.device)


def build_simulation(args):
    """The run that cli.main drives: the checkpoint's under --resume (on
    --device, at the file's device count, as in the JAX CLI), else
    SwendsenWang for --algo sw or Simulation, from
    config_from_args(args). In a group of several processes a
    --checkpoint is refused before the run, not after it."""
    if args.checkpoint:
        from .parallel.mesh import refuse_over_processes
        refuse_over_processes("the checkpoint")
    if args.resume:
        from .driver import Simulation
        return Simulation.from_checkpoint(args.resume, device=args.device)
    cfg = config_from_args(args)
    if args.algo == "sw":
        from .cluster import SwendsenWang
        return SwendsenWang(cfg)
    from .driver import Simulation
    return Simulation(cfg)


def run_pt(args) -> int:
    """--pt: replica exchange over the given ladder
    (tempering.ParallelTempering; -n counts swap rounds). The per-rung,
    acceptance and round-trip lines are the JAX CLI's."""
    try:
        temps = [float(t) for t in args.pt.split(",") if t]
        cfg = config_from_args(args)
        from .tempering import ParallelTempering
        pt = ParallelTempering(cfg, temps,
                               sweeps_per_swap=args.sweeps_per_swap)
    except (ValueError, NotImplementedError) as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    print("ising-tpu-torch parallel tempering:")
    print(f"\tlattice: {cfg.nrows} x {cfg.ncols} "
          f"({cfg.nspins / 1e6:.1f} M spins)")
    print(f"\tladder: {', '.join(f'{t:g}' for t in temps)}")
    print(f"\tbackend: {cfg.backend} (rng: {cfg.rng}), "
          f"{args.sweeps_per_swap} sweeps/swap")
    print(f"\tdevice: {pt.sims[0].device}")
    if cfg.j_prob is not None:
        print(f"\tdisorder: P(antiferro link) = {cfg.j_prob}")
    print(f"\trounds: {args.nit}")
    events = set(range(args.print_freq, args.nit + 1, args.print_freq)) \
        if args.print_freq else set()
    for r in range(1, args.nit + 1):
        pt.advance_round()
        if r in events or r == args.nit:
            for m in pt.measure():
                print(f"        T = {m['temp']:8.5f}  "
                      f"magnetization: {m['magnetization']:9.6f}  "
                      f"E/N: {m['energy']:9.6f} (round: {r:6d})")
    st = pt.stats()
    rates = ", ".join(f"{a:.3f}" for a in st["pair_acceptance"])
    trips = sum(st["round_trips"])
    print(f"Pair acceptance: [{rates}]")
    print(f"Completed round trips: {trips} "
          f"(replica at rung: {st['replica_at']})")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.pt:
        return run_pt(args)
    if args.algo == "sw" and (args.resume or args.checkpoint):
        print("ERROR: --algo sw does not support --resume/--checkpoint",
              file=sys.stderr)
        return 1
    errors = (ValueError, NotImplementedError)
    if args.resume:
        errors += (OSError,)   # a missing or unreadable file
    try:
        sim = build_simulation(args)
    except errors as e:
        where = f"cannot resume from {args.resume}: " if args.resume else ""
        print(f"ERROR: {where}{e}", file=sys.stderr)
        return 1
    cfg = sim.cfg

    print(f"ising-tpu-torch run"
          f"{' (Swendsen-Wang)' if args.algo == 'sw' else ''}:")
    print(f"\tlattice: {cfg.nrows} x {cfg.ncols} "
          f"({cfg.nspins / 1e6:.1f} M spins)")
    print(f"\ttemperature: {sim.temp:f} ({sim.temp / TCRIT:f} * T_crit)")
    print(f"\tseed: {cfg.seed}")
    print(f"\tbackend: {cfg.backend} (rng: {cfg.rng})")
    print(f"\tdevice: {sim.device}")
    print(f"\tdevices: {cfg.ndev}")
    if cfg.xsl:
        print(f"\tsub-lattices: {cfg.xsl} x {cfg.ysl}")
    if cfg.j_prob is not None:
        print(f"\tdisorder: P(antiferro link) = {cfg.j_prob}")
    if cfg.field:
        print(f"\texternal field: h = {cfg.field}")
    print(f"\titerations: {cfg.niters} (+{cfg.nwarmup} warmup)")
    from .utils.profiling import trace
    with trace(args.profile, device=sim.device):
        result = sim.run()
    if args.profile:
        print(f"Wrote profiler trace to {args.profile}")
    if cfg.dump_lattice:
        name = f"final_{cfg.nrows}x{cfg.ncols}.txt"
        sim.dump(name)
        print(f"Wrote final lattice to {name}")
    if args.checkpoint:
        sim.checkpoint(args.checkpoint)
        print(f"Wrote checkpoint to {args.checkpoint}")
    return 0 if result["steps"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
