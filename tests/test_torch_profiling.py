"""The port's profiling hooks (utils/profiling.py): trace(None) is a
no-op, trace(dir) writes a Chrome trace there in which annotate's range
and the run's torch operations appear, and StepTimer keeps the JAX
package's laps."""

import json
import os

import pytest
import torch

from ising_tpu.utils import profiling as jprof
from ising_tpu_torch import SimConfig
from ising_tpu_torch.driver import Simulation
from ising_tpu_torch.utils import profiling as tprof


def test_trace_none_is_a_no_op(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for off in (None, ""):
        with tprof.trace(off):
            x = torch.ones(4).sum()
        assert float(x) == 4.0
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("backend", ["xla", "bit1"])
def test_trace_writes_chrome_trace_with_annotation(tmp_path, backend):
    out = tmp_path / "tracedir" / "nested"
    sim = Simulation(SimConfig(nrows=16, ncols=64, temp=1.5,
                               backend=backend, device="cpu"))
    with tprof.trace(str(out), device=sim.device):
        with tprof.annotate("ising.sweeps"):
            sim.advance(2)
        sim.measure()
    assert sorted(os.listdir(out)) == [tprof.TRACE_FILE]
    events = json.loads((out / tprof.TRACE_FILE).read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "ising.sweeps" in names
    assert any(str(n).startswith("aten::") for n in names)
    # CPU only: no device activity recorded for a CPU run
    assert not any(e.get("cat") == "kernel" for e in events)


def test_step_timer_matches_jax():
    for timer in (tprof.StepTimer(), jprof.StepTimer()):
        assert timer.lap() == 0.0       # no start: a zero lap
        timer.start()
        a = timer.lap()
        b = timer.lap()
        assert a >= 0.0 and b >= 0.0 and len(timer.laps) == 3
        assert timer.total == sum(timer.laps)
