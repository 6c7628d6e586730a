"""Readings of the check on many seeds in one process: the sound program,
or the control.

    python3 -m isingbench.control --workload NAME --seeds A,B,C \
        --seconds S [--program-rng philox7] [--one-device]

Each seed is one run of the cell (harness.run_cell) with its window of S
seconds; the last line is a JSON list of each run's checks and metrics.
--program-rng runs the program in another rng mode while the reference
keeps the configuration's: with philox7 (Philox4x32-7, the program's own
path of fewer rounds, the step that would tempt a faster kernel) this is
the control, which the check has to call incorrect. --one-device puts
every row slab on the first CUDA device, to try a many-slab cell on one
card. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--program-rng", default=None)
    p.add_argument("--one-device", action="store_true")
    args = p.parse_args(argv)

    import torch

    from isingbench.harness import find_cell, run_cell

    cell = find_cell(args.workload)
    mesh = None
    if args.one_device:
        mesh = [torch.device("cuda", 0)] * cell.config["ndev"]
    overrides = {"rng": args.program_rng} if args.program_rng else None
    out = []
    for seed in (int(s) for s in args.seeds.split(",")):
        r = run_cell(args.workload, seed, args.seconds, False,
                     mesh=mesh, overrides=overrides)
        line = {"seed": seed, "correct": r["correct"],
                "checks": {k: v["value"] for k, v in r["checks"].items()},
                "metrics": {k: v["value"] for k, v in r["metrics"].items()}}
        print(json.dumps(line), flush=True)
        out.append(line)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
