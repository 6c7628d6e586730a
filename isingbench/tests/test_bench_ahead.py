"""A mix that dispatches its measurements ahead: its split of the call
gives the entry's answer, every answer of the window is delivered and
timed, and the same mix waited for at each measurement is as correct."""

import json

import numpy as np

from ising_tpu_torch.config import SimConfig
from ising_tpu_torch.driver import Simulation
from isingbench.harness import load, run_cell

from conftest import ROOT, SEED

DELIVERED = '''
def read(run):
    spans = [s for s in run.spans if s.name == run.cell.traffic["span"]]
    times = run.result_times
    ok = (len(times) == run.intervals == len(spans) - 1
          and all(b > a for a, b in zip(times, times[1:]))
          and all(s.device_s is not None and s.device_s >= 0
                  for s in spans))
    return float(ok)
'''


def test_the_split_call_gives_the_entrys_answer():
    split = load(ROOT, "calls", "replica_magnetizations")
    cfg = SimConfig(temp=1.5, backend="bit1", rng="philox", seed=SEED,
                    device="cpu", nrows=64, ncols=256, xsl=8, ysl=8)
    sim = Simulation(cfg)
    for k in (0, 3):
        sim.advance(k)
        got = split.finish(sim, split.issue(sim).cpu())
        np.testing.assert_array_equal(got, sim.replica_magnetizations())


def test_every_answer_dispatched_ahead_is_delivered(tiny_root):
    (tiny_root / "isingbench" / "metrics" / "delivered.py").write_text(
        DELIVERED)
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({"name": "delivered", "unit": "n",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["replicas2k.sample"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = run_cell("replicas2k.sample", SEED, 0.3, False, root=tiny_root,
                 device="cpu")
    assert r["correct"], r["checks"]
    assert r["attempted"] > 1
    assert r["metrics"]["delivered"]["value"] == 1.0
    assert r["metrics"]["sample_ms_p95"]["value"] > 0


def test_the_mix_waited_for_at_each_measurement_is_correct(tiny_root):
    path = tiny_root / "isingbench" / "traffic" / "sample.json"
    traffic = json.loads(path.read_text())
    assert traffic["ahead"] > 0
    del traffic["ahead"]
    path.write_text(json.dumps(traffic))
    r = run_cell("replicas2k.sample", SEED, 0.3, False, root=tiny_root,
                 device="cpu")
    assert r["correct"], r["checks"]
    assert r["metrics"]["sample_ms_p95"]["value"] > 0
