"""The reference trajectories in ising_tpu_torch/golden.py, derived again
from the JAX package (xla backend), and reproduced by the port on the CPU.
chip_smoke.py checks the same constants against the CUDA kernel."""

import numpy as np
import pytest

from ising_tpu import SimConfig as JaxConfig
from ising_tpu.driver import Simulation as JaxSimulation
from ising_tpu_torch import golden


def _words(bits):
    """(Y, C) uint8 bit plane -> (Y, C/32) uint32 bit1 words (bit g of word
    j = compact column g*W1 + j), in numpy."""
    Y, C = bits.shape
    g = bits.reshape(Y, 32, C // 32).astype(np.uint64)
    weights = np.left_shift(np.uint64(1), np.arange(32, dtype=np.uint64))
    return (g * weights[None, :, None]).sum(axis=1).astype(np.uint32)


@pytest.mark.parametrize("case", list(golden.GOLDEN))
def test_golden_constants_come_from_jax(case):
    rng, temp = case
    sim = JaxSimulation(JaxConfig(nrows=golden.NROWS, ncols=golden.NCOLS,
                                  temp=temp, seed=golden.SEED,
                                  backend="xla", rng=rng))
    ups = [sim.measure()["up"]]
    for _ in range(golden.NSTEPS):
        sim.advance(1)
        ups.append(sim.measure()["up"])
    b, w = (_words(np.asarray(x)) for x in sim.bits())
    assert {"up": tuple(ups), "crc32": golden.words_crc32(b, w)} == \
        golden.GOLDEN[case]


@pytest.mark.parametrize("case", list(golden.GOLDEN))
def test_port_reproduces_golden_on_cpu(case):
    assert golden.port_trajectory(*case, device="cpu") == golden.GOLDEN[case]


def test_golden_cases_cover_both_families_and_accepts():
    assert {r for r, _ in golden.GOLDEN} == {"threefry13", "philox"}
    assert {t <= 0 for _, t in golden.GOLDEN} == {True, False}
    assert golden.NCOLS == 16384  # the full bench width
