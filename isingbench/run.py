"""Run one cell of the benchmark once and print its result line.

    python3 -m isingbench.run --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout that holds BENCHMARK.json and ising_tpu_torch.
The last line of standard output is one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics, or with --trace 1 its
per-layer ones), device, with --trace 1 a breakdown, and the numbers the
check compared, each beside its limit, which are also the last lines of
standard error. A machine with fewer CUDA devices than the cell asks for
gets no result and exit code 2.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from isingbench.harness import find_cell, run_cell

    chips = next(w["chips"] for w in find_cell(args.workload).bench[
        "workloads"] if w["name"] == args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"isingbench: {args.workload} needs {chips} CUDA devices, "
              f"this machine has {have}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=T_START)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
