"""A configuration, a traffic mix, an answer reader and a per-layer metric
added as new files only are found by name and run."""

import json

import numpy as np

from ising_tpu_torch.driver import Simulation
from isingbench.harness import find_cell, run_cell

from conftest import SEED

# The reference's reading of Simulation.fourier_partials (each row's and
# each column's up spins), as a later traffic mix would add it.
PARTIALS_READER = '''
import torch


def block_rows(cfg):
    return 8


def partial(s, cfg):
    s = s.to(torch.int64)
    return s.sum(1).cpu(), s.sum(0).cpu()


def diffs(answer, partials, cfg):
    rows = torch.cat([r for r, _ in partials])
    cols = sum(c for _, c in partials)
    got_rows, got_cols = (torch.from_numpy(a) for a in answer)
    return int((got_rows != rows).sum() + (got_cols != cols).sum())
'''


def add_partials_cell(root):
    """A traffic mix that reads a second observable, its answer reader and
    a cell that runs it: new files and new entries only."""
    pkg = root / "isingbench"
    traffic = {"call": "fourier_partials", "span": "partials", "every": 3,
               "check_intervals": 2, "trace_intervals": 2, "why": "x"}
    (pkg / "traffic" / "partials.json").write_text(json.dumps(traffic))
    (pkg / "reference" / "answer_fourier_partials.py").write_text(
        PARTIALS_READER)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "lattice65k-x4.partials",
                               "config": "lattice65k-x4",
                               "traffic": "partials", "chips": 1,
                               "why": "x"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return "lattice65k-x4.partials"


def test_new_files_make_a_new_cell(tiny_root):
    pkg = tiny_root / "isingbench"
    conf = json.loads((pkg / "configs" / "lattice65k.json").read_text())
    conf.update(nrows=32, ncols=128, temp=2.0)
    (pkg / "configs" / "hot.json").write_text(json.dumps(conf))
    traffic = json.loads((pkg / "traffic" / "sweep.json").read_text())
    traffic.update(every=3)
    (pkg / "traffic" / "often.json").write_text(json.dumps(traffic))
    (pkg / "metrics" / "measurements_n.py").write_text(
        "def read(run):\n    return run.intervals\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "hot", "source": "x",
                             "file": "isingbench/configs/hot.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "hot.often", "config": "hot",
                               "traffic": "often", "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "measurements_n", "unit": "n",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["hot.often"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = find_cell("hot.often", tiny_root)
    assert cell.config["temp"] == 2.0 and cell.traffic["every"] == 3
    names = [m["name"] for m in cell.metrics("end_to_end")]
    assert "measurements_n" in names and "sample_ms_p95" not in names
    r = run_cell("hot.often", SEED, 0.3, False, root=tiny_root,
                 device="cpu")
    assert r["correct"]
    assert r["metrics"]["measurements_n"]["value"] == r["attempted"] > 0
    assert list(r)[-1] == "checks"


def test_cells_report_their_metrics():
    cell = find_cell("replicas2k.sample")
    assert {m["name"] for m in cell.metrics("end_to_end")} == {
        "flips_per_ns", "sample_ms_p95", "peak_mem_gib", "setup_s"}
    assert {m["name"] for m in cell.metrics("per_layer")} == {
        "sweep_ms_per_step", "sweep_bound_pct", "measure_ms", "idle_pct"}
    cell = find_cell("lattice65k-x4.sweep")
    assert {m["name"] for m in cell.metrics("per_layer")} == {
        "sweep_ms_per_step", "sweep_bound_pct", "launch_us",
        "halo_ms_per_step", "idle_pct"}


def test_a_new_observable_is_judged_by_its_own_reader(tiny_root):
    cell = add_partials_cell(tiny_root)
    r = run_cell(cell, SEED, 0.3, False, root=tiny_root, device="cpu")
    assert r["correct"], r["checks"]
    assert r["metrics"]["flips_per_ns"]["value"] > 0


def test_a_wrong_answer_of_the_new_observable_fails(tiny_root, monkeypatch):
    cell = add_partials_cell(tiny_root)
    partials = Simulation.fourier_partials

    def altered(self):
        rows, cols = partials(self)
        cols = np.array(cols)
        cols[0] += 1
        return rows, cols

    monkeypatch.setattr(Simulation, "fourier_partials", altered)
    r = run_cell(cell, SEED, 0.3, False, root=tiny_root, device="cpu")
    assert not r["correct"] and r["checks"]["answer_diffs"]["value"] > 0
