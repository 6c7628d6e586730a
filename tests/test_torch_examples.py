"""The port's seven example studies (ising_tpu_torch/examples/) against
the JAX package's (examples/), at tolerance 0: the JAX example run through
runpy and the port's main() with --device cpu print equal lines, at
tests/test_examples.py's sizes, on xla in threefry13 (giant_lattice: bit1
in hw, its own backend, and its storage and measurement lines less the
timings). tc_sweep also runs the port on bit1 (the kernels' plain version
on the CPU) against the JAX example on xla with the same flags: the
backends are bit-identical in threefry13, replicas included, and the
smallest replica geometry bit1 admits (sizes 8 and 16, 1024 replicas:
256^2 and 512^2) would take Pallas's interpret mode minutes."""

import contextlib
import importlib
import io
import re
import runpy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

TC_BIT1 = ["--sizes", "8,16", "--replicas", "1024", "--ntemps", "2",
           "--warmup", "4", "--measure", "4", "--every", "2"]
# (example, flags of both, the port's own flags, the JAX example's own)
CASES = {
    "tc_sweep": (["--sizes", "8,16", "--replicas", "8", "--warmup", "20",
                  "--measure", "12", "--ntemps", "3"], [], []),
    "tc_sweep_bit1": (TC_BIT1, ["--backend", "bit1"], ["--backend", "xla"]),
    "giant_lattice": (["--rows", "16", "--cols", "64", "--steps", "4"], [],
                      []),
    "spin_glass_pt": (["--size", "16", "--rungs", "3", "--rounds", "8",
                       "--sweeps", "2", "--realizations", "2"], [], []),
    "xi_scan": (["--sizes", "8,16", "--ntemps", "3", "--warmup", "5",
                 "--samples", "12"], [], []),
    "cluster_vs_metropolis": (["--size", "16", "--warmup", "20", "--samples",
                               "64", "--sw-samples", "32"], [], []),
    "reweight_peak": (["--size", "16", "--ntemps", "3", "--warmup", "40",
                       "--samples", "40", "--every", "2"], [], []),
    "hysteresis": (["--size", "16", "--hmax", "1.0", "--steps", "5",
                    "--sweeps", "4"], [], []),
}


def _jax_example(name, argv):
    old = sys.argv
    sys.argv = [name] + argv
    try:
        with contextlib.redirect_stdout(io.StringIO()) as out:
            try:
                runpy.run_path(str(ROOT / "examples" / f"{name}.py"),
                               run_name="__main__")
            except SystemExit as e:
                assert not e.code, f"{name} exited {e.code}"
    finally:
        sys.argv = old
    return out.getvalue().splitlines()


def _port_example(name, argv):
    mod = importlib.import_module(f"ising_tpu_torch.examples.{name}")
    with contextlib.redirect_stdout(io.StringIO()) as out:
        code = mod.main(argv + ["--device", "cpu"])
    assert code == 0 or name == "spin_glass_pt", f"{name} returned {code}"
    return out.getvalue().splitlines()


def _giant_numbers(lines):
    """giant_lattice's storage line and its measurement line without the
    timing in parentheses."""
    keep = [ln for ln in lines if "GiB of storage" in ln]
    keep += [re.sub(r"\s*\(measure.*\)$", "", ln) for ln in lines
             if ln.startswith("|m| = ")]
    return keep


@pytest.mark.parametrize("case", list(CASES))
def test_port_example_prints_jax_lines(case):
    both, port_only, jax_only = CASES[case]
    name = case.removesuffix("_bit1")
    want = _jax_example(name, both + jax_only)
    got = _port_example(name, both + port_only)
    if name == "giant_lattice":
        want, got = _giant_numbers(want), _giant_numbers(got)
    assert len(want) >= 2 and got == want


def test_examples_run_as_modules_and_need_no_jax():
    """Each example is `python3 -m ising_tpu_torch.examples.<name>` and
    imports nothing of JAX or of the JAX package."""
    import ast
    for name in {c.removesuffix("_bit1") for c in CASES}:
        path = ROOT / "ising_tpu_torch" / "examples" / f"{name}.py"
        tree = ast.parse(path.read_text())

        def imported(nodes):
            return ([a.name for n in nodes if isinstance(n, ast.Import)
                     for a in n.names]
                    + [n.module for n in nodes
                       if isinstance(n, ast.ImportFrom) and n.module])
        assert not [m for m in imported(ast.walk(tree))
                    if m.split(".")[0] in ("jax", "ising_tpu")]
        # hysteresis imports matplotlib only under --png
        assert not [m for m in imported(tree.body)
                    if m.startswith("matplotlib")]
        assert 'if __name__ == "__main__":' in path.read_text()
