"""The harness on the card's kernels, at the CPU tests' small sizes: every
cell correct, the control not (the card's copy of test_bench_faults'
first two tests). A many-slab cell takes the one card repeated where the
machine has fewer cards."""

import pytest
import torch

from isingbench.harness import run_cell

from conftest import SEED

CELLS = ["lattice65k.sweep", "replicas2k.sample", "lattice65k-x4.sweep"]


def card_run(root, cell, **kw):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "false)")
    mesh = None
    if cell.startswith("lattice65k-x4") and torch.cuda.device_count() < 4:
        mesh = [torch.device("cuda", 0)] * 4
    return run_cell(cell, SEED, 0.5, False, root=root, device="cuda",
                    mesh=mesh, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(tiny_root, cell):
    r = card_run(tiny_root, cell)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card_fails(tiny_root, cell):
    r = card_run(tiny_root, cell, overrides={"rng": "philox7"})
    assert not r["correct"]
    assert r["checks"]["step_bits"]["value"] > 0
