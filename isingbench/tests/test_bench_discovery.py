"""A configuration, a traffic mix, an answer reader and a per-layer metric
added as new files only are found by name and run."""

import json

import numpy as np
import pytest

from ising_tpu_torch.driver import Simulation
from isingbench.harness import find_cell, run_cell

from conftest import ROOT, SEED, make_root, skip_uncut

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
        "sweep_ms_per_step", "sweep_bound_pct", "measure_ms", "idle_pct",
        "decode_ms", "tile_sum_ms", "init_s"}
    cell = find_cell("lattice65k-x4.sweep")
    assert {m["name"] for m in cell.metrics("per_layer")} == {
        "sweep_ms_per_step", "sweep_bound_pct", "launch_us",
        "halo_ms_per_step", "idle_pct", "launch_self_us", "step_loop_us",
        "count_ms", "measure_wait_ms", "init_s"}


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


# A check of a Swendsen-Wang run, as a configuration that names one would
# add it: the start against the plain reference's initial lattice (the
# port's SwendsenWang starts from Simulation's), the last count of up spins
# against the final lattice. BIAS is added to the start's differing bits.
SW_CHECK = '''
import torch

from isingbench.reference import ising as ref

LIMITS = {"init_bits": 0, "answer_diffs": 0}
BIAS = %d


class Follower:
    def __init__(self, want, sim):
        self.want, self.start, self.steps = want, sim.full.clone(), 0

    def add(self, m, sim):
        self.steps = sim.step


def follow(cell, want, sim, root):
    return Follower(want, sim)


def final(follower, sim, answers):
    up = int(sim.full.to(torch.int64).sum())
    last = answers[-1]
    n = follower.want.nspins
    return {"answer_diffs": int(last["up"] != up)
            + int(last["down"] != n - up)}


def verdict(follower, final, answers, device):
    w = follower.want
    start = ref.init_rows(w.seed, torch.arange(w.nrows), w.ncols)
    bits = int((follower.start.cpu() ^ start).sum()) + BIAS
    return {"init_bits": bits, "steps_checked": follower.steps, **final}
'''


def add_sw_cell(root, *, bias=0, program="ising_tpu_torch.cluster."
                "SwendsenWang"):
    """A configuration that names its program and its check, and a cell
    that runs it under the sweep mix: new files and new entries only."""
    pkg = root / "isingbench"
    (pkg / "checks").mkdir(exist_ok=True)
    (pkg / "checks" / "sw_start.py").write_text(SW_CHECK % bias)
    conf = {"program": program, "check": "sw_start", "nrows": 32,
            "ncols": 32, "temp": 2.269185314213022, "backend": "xla",
            "rng": "philox", "ndev": 1}
    (pkg / "configs" / "sw32.json").write_text(json.dumps(conf))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "sw32", "source": "x",
                             "file": "isingbench/configs/sw32.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "sw32.sweep", "config": "sw32",
                               "traffic": "sweep", "chips": 1, "why": "x"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return "sw32.sweep"


def test_a_configuration_names_its_program_and_its_check(tiny_root):
    cell = add_sw_cell(tiny_root)
    r = run_cell(cell, SEED, 0.3, False, root=tiny_root, device="cpu")
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"init_bits", "answer_diffs"}
    assert r["attempted"] > 0 and r["metrics"]["flips_per_ns"]["value"] > 0


def test_the_named_check_decides_correct(tiny_root):
    cell = add_sw_cell(tiny_root, bias=1)
    r = run_cell(cell, SEED, 0.3, False, root=tiny_root, device="cpu")
    assert not r["correct"]
    assert r["checks"]["init_bits"] == {"value": 1, "limit": 0}


@pytest.mark.parametrize("program,says", [
    ("ising_tpu_torch.nowhere.Simulation", "does not import"),
    ("ising_tpu_torch.driver.Nowhere", "does not import"),
    ("Simulation", "does not import"),
    ("ising_tpu_torch.cluster.sw_step", "names no class")])
def test_a_program_that_is_not_there_fails_at_once(tiny_root, program,
                                                   says):
    cell = add_sw_cell(tiny_root, program=program)
    with pytest.raises(SystemExit, match=f'"program".*{says}'):
        run_cell(cell, SEED, 0.3, False, root=tiny_root, device="cpu")


def test_a_check_that_is_not_there_fails_at_once(tiny_root):
    cell = add_sw_cell(tiny_root)
    (tiny_root / "isingbench" / "checks" / "sw_start.py").unlink()
    with pytest.raises(SystemExit, match='"check".*sw_start.py'):
        run_cell(cell, SEED, 0.3, False, root=tiny_root, device="cpu")


CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_is_correct_at_its_tiny_size(tiny_root, cell):
    skip_uncut(tiny_root, cell)
    r = run_cell(cell, SEED, 0.3, False, root=tiny_root, device="cpu")
    assert r["correct"], r["checks"]


def test_a_configuration_without_a_tiny_cut_is_left_out(tmp_path):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "uncut", "source": "x",
                             "file": "isingbench/configs/uncut.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "uncut.sweep", "config": "uncut",
                               "traffic": "sweep", "chips": 1, "why": "x"})
    root = make_root(tmp_path, bench)
    assert not (root / "isingbench" / "configs" / "uncut.json").exists()
    with pytest.raises(pytest.skip.Exception, match="'uncut'"):
        skip_uncut(root, "uncut.sweep")
    skip_uncut(root, "lattice65k.sweep")
    r = run_cell("lattice65k.sweep", SEED, 0.3, False, root=root,
                 device="cpu")
    assert r["correct"], r["checks"]
