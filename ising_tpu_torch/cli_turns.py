"""Time the CLI from two source trees in turns, on one card.

    python3 -m ising_tpu_torch.cli_turns OLD_TREE NEW_TREE -- \\
        --backend mxu --rng threefry13 -x 16384 -y 16384 -w 8 -n 64 -p 16

Runs ``python3 -m ising_tpu_torch ARGS`` with each tree as the working
directory, one process a run, in the order OLD, NEW, NEW, OLD, so that a
drift of the card over the call falls on both trees alike. Each tree builds
its kernels into its own ``ising_tpu_torch/_build`` at first use, and a first
run in a process pays that use in its run loop: compare the second runs.
Prints each run's tree and the CLI's flips/ns line, and last one JSON object
{"runs": [[tree, flips/ns], ...]}.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys


def run_cli(tree: str, args: list[str]) -> float:
    out = subprocess.run([sys.executable, "-m", "ising_tpu_torch", *args],
                         cwd=tree, capture_output=True, text=True, check=True,
                         timeout=900).stdout
    line = next(ln for ln in out.splitlines() if "flips/ns" in ln)
    print(f"[turns] {tree}: {line.strip()}", flush=True)
    return float(re.search(r"([0-9.]+) flips/ns", line)[1])


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 3 or argv[2] != "--":
        print(__doc__)
        return 2
    old, new, args = argv[0], argv[1], argv[3:]
    runs = [[tree, run_cli(tree, args)] for tree in (old, new, new, old)]
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
