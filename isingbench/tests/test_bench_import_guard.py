"""Nothing a run imports is JAX or the JAX package (top-level names
compared whole: ising_tpu_torch is not ising_tpu), a run that loads one
after its window prints no result, and the reference imports nothing of
the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from conftest import ROOT, make_root

REFERENCE = ROOT / "isingbench" / "reference"
ALLOWED = {"__future__", "math", "torch", "numpy"}


def test_a_run_loads_no_jax(tmp_path):
    root = make_root(tmp_path)
    code = (
        "import json, sys\n"
        "from pathlib import Path\n"
        "from isingbench.harness import run_cell, forbidden_modules\n"
        f"r = run_cell('lattice65k-x4.sweep', 5, 0.2, False, "
        f"root=Path({str(root)!r}), device='cpu')\n"
        "tops = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps([r['correct'], forbidden_modules(), tops]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    correct, found, tops = json.loads(out.stdout.splitlines()[-1])
    assert correct and found == []
    assert "ising_tpu_torch" in tops
    assert not {"jax", "jaxlib", "flax", "ising_tpu"} & set(tops)


def test_a_module_loaded_after_the_window_is_caught(tmp_path):
    """A metric reader or answer reader is loaded after the window closes:
    the run refuses to print a result if one of them brings in JAX."""
    root = make_root(tmp_path)
    (root / "isingbench" / "metrics" / "loads_jax.py").write_text(
        "import sys, types\n\n\n"
        "def read(run):\n"
        "    sys.modules['jax'] = types.ModuleType('jax')\n"
        "    return 1.0\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({"name": "loads_jax", "unit": "n",
                                "better": "lower", "bound": 0.01,
                                "source": "host_clock"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "from pathlib import Path\n"
        "from isingbench.harness import run_cell\n"
        f"r = run_cell('lattice65k.sweep', 5, 0.2, False, "
        f"root=Path({str(root)!r}), device='cpu')\n"
        "print('printed', r['correct'])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "printed" not in out.stdout
    assert "jax" in out.stderr


def test_reference_imports_only_torch_numpy_math():
    for path in REFERENCE.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert (name.split(".")[0] in ALLOWED
                        or name.startswith("isingbench.reference")), (
                    path.name, name)


def test_reference_loads_nothing_of_the_program():
    names = ", ".join(f"isingbench.reference.{p.stem}"
                      for p in sorted(REFERENCE.glob("*.py"))
                      if p.stem != "__init__")
    code = ("import sys\n"
            f"import {names}\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    tops = set(ast.literal_eval(out.stdout.splitlines()[-1]))
    assert not {"ising_tpu_torch", "ising_tpu", "jax"} & tops
