"""A checkout in miniature for the harness's CPU tests: BENCHMARK.json's
cells with the configurations cut to a few rows and columns, the traffic
to a few steps, and the metric readers and the reference as they are."""

import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
TINY = {"lattice65k": dict(nrows=64, ncols=256),
        "replicas2k": dict(nrows=64, ncols=256, xsl=8, ysl=8),
        "lattice65k-x4": dict(nrows=128, ncols=256)}
TINY_TRAFFIC = {"sweep": dict(every=4, trace_intervals=3),
                "sample": dict(every=2, trace_intervals=3)}
SEED = 2**32 + 77


def make_root(path: Path) -> Path:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pkg = path / "isingbench"
    for folder in ("metrics", "reference", "calls"):
        shutil.copytree(ROOT / "isingbench" / folder, pkg / folder,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (pkg / "configs").mkdir()
    (pkg / "traffic").mkdir()
    for c in bench["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        conf.update(TINY[c["name"]])
        (path / c["file"]).write_text(json.dumps(conf))
    for name, cut in TINY_TRAFFIC.items():
        t = json.loads((ROOT / "isingbench" / "traffic" / f"{name}.json")
                       .read_text())
        t.update(cut)
        (pkg / "traffic" / f"{name}.json").write_text(json.dumps(t))
    (path / "BENCHMARK.json").write_text(json.dumps(bench))
    return path


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
