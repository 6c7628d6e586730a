"""A checkout in miniature for the harness's CPU tests: BENCHMARK.json's
cells with the configurations cut to a few rows and columns, the traffic
to a few steps, and the metric readers, the reference, the calls and the
checks as they are.

Each cut is a file of its own beside the others, found by name:
tiny/configs/<config>.json and tiny/traffic/<traffic>.json hold the keys
that the cut changes. A configuration without a cut is left out of the
miniature, and a test that asks for one of its cells is skipped with the
configuration's name in the reason; a traffic mix without one is copied
as it is."""

import json
import shutil
from pathlib import Path

import pytest

from isingbench.harness import FOLDERS

ROOT = Path(__file__).resolve().parents[2]
TINY = Path(__file__).resolve().parent / "tiny"
SEED = 2**32 + 77


def tiny_cut(kind: str, name: str):
    """The keys that tiny/<kind>/<name>.json changes, None where there is
    no such file (kind: "configs" or "traffic")."""
    path = TINY / kind / f"{name}.json"
    return json.loads(path.read_text()) if path.is_file() else None


def make_root(path: Path, bench: dict | None = None) -> Path:
    """The miniature of the repository's BENCHMARK.json, or of `bench`,
    under path."""
    if bench is None:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pkg = path / "isingbench"
    for folder in FOLDERS:
        if (ROOT / "isingbench" / folder).is_dir():
            shutil.copytree(ROOT / "isingbench" / folder, pkg / folder,
                            ignore=shutil.ignore_patterns("__pycache__"))
    (pkg / "configs").mkdir()
    (pkg / "traffic").mkdir()
    for c in bench["configs"]:
        cut = tiny_cut("configs", c["name"])
        if cut is None:
            continue
        conf = json.loads((ROOT / c["file"]).read_text())
        conf.update(cut)
        (path / c["file"]).write_text(json.dumps(conf))
    for t in sorted((ROOT / "isingbench" / "traffic").glob("*.json")):
        traffic = json.loads(t.read_text())
        traffic.update(tiny_cut("traffic", t.stem) or {})
        (pkg / "traffic" / t.name).write_text(json.dumps(traffic))
    (path / "BENCHMARK.json").write_text(json.dumps(bench))
    return path


def skip_uncut(root: Path, workload: str):
    """Skip the test where the miniature under root left the cell's
    configuration out, for want of a tiny cut."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    name = next(w["config"] for w in bench["workloads"]
                if w["name"] == workload)
    conf = next(c for c in bench["configs"] if c["name"] == name)
    if not (root / conf["file"]).is_file():
        pytest.skip(f"configuration {name!r} has no tiny cut "
                    f"(isingbench/tests/tiny/configs/{name}.json)")


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
