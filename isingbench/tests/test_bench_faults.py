"""The check calls a run incorrect when the program is: the control (the
program in Philox4x32-7, the reference in the configuration's Philox-10)
and each fault a cell can have, planted under the harness in a whole run
on the CPU (the harness's look for a card skipped)."""

import numpy as np
import pytest

from ising_tpu_torch import observables
from ising_tpu_torch.driver import Simulation
from ising_tpu_torch.ops.bit1 import Bit1Backend
from ising_tpu_torch.parallel import sharded
from isingbench.harness import run_cell

from conftest import SEED

CELLS = ["lattice65k.sweep", "replicas2k.sample", "lattice65k-x4.sweep"]


def run(root, cell, **kw):
    return run_cell(cell, SEED, 0.3, False, root=root, device="cpu", **kw)


def values(r):
    return {k: v["value"] for k, v in r["checks"].items()}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_program_is_correct(tiny_root, cell):
    r = run(tiny_root, cell)
    assert r["correct"], values(r)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(tiny_root, cell):
    r = run(tiny_root, cell, overrides={"rng": "philox7"})
    v = values(r)
    assert not r["correct"]
    assert v["init_bits"] == 0 and v["step_bits"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_a_step_that_leaves_the_state_unchanged_fails(tiny_root, cell,
                                                      monkeypatch):
    monkeypatch.setattr(Bit1Backend, "update_color",
                        lambda self, dst, src, **kw: dst)
    r = run(tiny_root, cell)
    assert not r["correct"] and values(r)["step_bits"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_rows_left_out_fails(tiny_root, cell, monkeypatch):
    update = Bit1Backend.update_color

    def half(self, dst, src, *, src_dn=None, **kw):
        h = dst.shape[0] // 2
        update(self, dst[:h], src[:h], src_dn=src[h:h + 1], **kw)
        return dst

    monkeypatch.setattr(Bit1Backend, "update_color", half)
    r = run(tiny_root, cell)
    assert not r["correct"] and values(r)["step_bits"] > 0


def test_the_exchange_between_devices_left_out_fails(tiny_root,
                                                     monkeypatch):
    monkeypatch.setattr(sharded, "ring_halo_rows",
                        lambda slabs: [(s[-1:], s[:1]) for s in slabs])
    r = run(tiny_root, "lattice65k-x4.sweep")
    assert not r["correct"] and values(r)["step_bits"] > 0


@pytest.mark.parametrize("cell", ["lattice65k.sweep",
                                  "lattice65k-x4.sweep"])
def test_an_altered_magnetization_fails(tiny_root, cell, monkeypatch):
    measure = Simulation.measure

    def off_by_one(self):
        out = measure(self)
        out["up"] += 1
        return out

    monkeypatch.setattr(Simulation, "measure", off_by_one)
    r = run(tiny_root, cell)
    assert not r["correct"] and values(r)["answer_diffs"] > 0


def test_an_altered_replica_answer_fails(tiny_root, monkeypatch):
    """The answer altered where it is produced: the |m| the program makes
    from the up counts, in the entry and in the mix's split of it."""
    abs_m = observables.replica_abs_m

    def altered(ups, xsl, ysl):
        out = np.array(abs_m(ups, xsl, ysl))
        out[-1] = abs(out[-1] - 2.0 / (xsl * ysl))
        return out

    monkeypatch.setattr(observables, "replica_abs_m", altered)
    r = run(tiny_root, "replicas2k.sample")
    assert not r["correct"] and values(r)["answer_diffs"] > 0
