"""The frozen reference against the port's plain-torch (xla) backend in
philox, which is bit-identical to bit1, at small sizes: the start, steps
on the full lattice and in replicas, bands cut from a larger lattice,
and the bit1 words read back."""

import pytest
import torch

from ising_tpu_torch.config import SimConfig
from ising_tpu_torch.driver import Simulation
from ising_tpu_torch.lattice import compact_to_full
from isingbench.reference import ising as ref
from isingbench.reference.storage_bit1 import decode

SEED = 2**33 + 12345


@pytest.mark.parametrize("geometry", [
    dict(nrows=32, ncols=128),
    dict(nrows=32, ncols=256, xsl=8, ysl=8),
    dict(nrows=48, ncols=64, xsl=16, ysl=16),
])
@pytest.mark.parametrize("rng", ["philox", "philox7"])
def test_reference_follows_the_xla_backend(geometry, rng):
    cfg = SimConfig(temp=1.5, backend="xla", rng=rng, seed=SEED,
                    device="cpu", **geometry)
    sim = Simulation(cfg)
    rows = torch.arange(cfg.nrows)
    s = ref.init_rows(SEED, rows, cfg.ncols)
    assert torch.equal(s, compact_to_full(*sim.bits()))
    for k in (1, 3):
        s = ref.run_steps(s, rows, seed=SEED, step0=sim.step, nsteps=k,
                          temp=1.5, xsl=cfg.xsl, ysl=cfg.ysl,
                          rounds=ref.philox_rounds(rng))
        sim.advance(k)
        assert torch.equal(s, compact_to_full(*sim.bits()))


def test_band_is_exact_inside_its_light_cone():
    """A band of rows cut from the lattice, run alone, matches the whole
    lattice in rows [2k, n - 2k) after k steps, and not beyond."""
    Y, X, k = 64, 128, 3
    rows = torch.arange(Y)
    full = ref.run_steps(ref.init_rows(SEED, rows, X), rows, seed=SEED,
                         step0=0, nsteps=k, temp=1.5)
    band = (torch.arange(40) + 50) % Y
    got = ref.run_steps(ref.init_rows(SEED, band, X), band, seed=SEED,
                        step0=0, nsteps=k, temp=1.5)
    v = slice(2 * k, 40 - 2 * k)
    assert torch.equal(got[v], full[band][v])
    assert not torch.equal(got, full[band])


@pytest.mark.parametrize("geometry", [dict(nrows=16, ncols=128),
                                      dict(nrows=16, ncols=256, xsl=8,
                                           ysl=8)])
def test_bit1_words_read_back(geometry):
    cfg = SimConfig(temp=1.5, backend="bit1", rng="philox", seed=SEED,
                    device="cpu", **geometry)
    sim = Simulation(cfg)
    sim.advance(2)
    rows = torch.arange(cfg.nrows)
    assert torch.equal(decode(sim.black, sim.white, rows),
                       compact_to_full(*sim.bits()))
    odd = rows[1::2]
    assert torch.equal(decode(sim.black[1::2], sim.white[1::2], odd),
                       compact_to_full(*sim.bits())[1::2])


def test_thresholds_are_the_accept_of_exp():
    thr = ref.thresholds(1.5)
    assert thr[2] == thr[7] == 4294967295      # dE = 0 always flips
    assert thr[1] == thr[8] and thr[0] == thr[9]  # mirror symmetry
    assert thr[9] == round(2.718281828459045 ** (-8 / 1.5) * 4294967295)


def test_unknown_rng_refused():
    with pytest.raises(ValueError):
        ref.philox_rounds("threefry13")
