"""The Fourier partials of the port (ising_tpu_torch/observables.py,
Simulation.fourier_partials, Bit1Backend.col_up_counts) against the JAX
package's, exactly.

The same planes, made with numpy from a seed, go into both packages: the
column counts at the JAX tests' shapes (tests/test_fourier.py), with row
chunking, through a row decoder and on bit1's words; the float |m|; and
Simulation.fourier_partials on the xla and bit1 backends (a Simulation
takes the planes as its state, so no JAX sweep runs here but one of the
xla backend), and its refusal of replica mode. Tolerance 0: every value is
an integer or the same float expression of integers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ising_tpu import SimConfig as JaxConfig
from ising_tpu import lattice as jlattice
from ising_tpu import observables as jobs
from ising_tpu.driver import Simulation as JaxSimulation
from ising_tpu.ops import pallas_bit1 as jbit1
from ising_tpu_torch import SimConfig, lattice, observables
from ising_tpu_torch.driver import Simulation
from ising_tpu_torch.ops import bit1


def _full(seed, Y, X):
    return np.random.default_rng(seed).integers(0, 2, (Y, X), dtype=np.uint8)


def _both(full):
    """The compact (black, white) planes of `full`: the JAX package's and
    the port's."""
    jb, jw = jlattice.full_to_compact(jnp.asarray(full))
    pb, pw = lattice.full_to_compact(torch.from_numpy(full))
    return (jb, jw), (pb, pw)


def _eq(got, want):
    np.testing.assert_array_equal(
        got.cpu().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("shape,seed", [((8, 16), 0), ((6, 24), 1),
                                        ((16, 32), 2)])
def test_col_up_counts_match_jax(shape, seed):
    full = _full(seed, *shape)
    (jb, jw), (pb, pw) = _both(full)
    got = observables.col_up_counts(pb, pw)
    assert got.dtype == torch.int64
    _eq(got, jobs.col_up_counts(jb, jw))
    _eq(got, full.sum(axis=0))


@pytest.mark.parametrize("row_chunk", [2, 4, 5, 6, 8192])
def test_col_up_counts_row_chunking(row_chunk):
    """Even-aligned slabs (an odd row_chunk is taken down to even) and the
    row decoder's slabs give the JAX package's counts."""
    full = _full(3, 24, 16)
    (jb, jw), (pb, pw) = _both(full)
    _eq(observables.col_up_counts(pb, pw, row_chunk=row_chunk),
        jobs.col_up_counts(jb, jw, row_chunk=row_chunk))
    if row_chunk % 2 == 0:
        _eq(observables.col_up_counts_via(
                lambda r, n: (pb[r:r + n], pw[r:r + n]), 24,
                row_chunk=row_chunk),
            jobs.col_up_counts_via(lambda r, n: (jb[r:r + n], jw[r:r + n]),
                                   24, row_chunk=row_chunk))


@pytest.mark.parametrize("shape,row_chunk", [((8, 128), 8192), ((8, 128), 4),
                                             ((12, 256), 6), ((6, 64), 2)])
def test_bit1_col_up_counts_match_jax(shape, row_chunk):
    """On the words, bit 31 included (a word whose lane holds column
    31 * W1 + j is negative as int32)."""
    full = _full(4, *shape)
    full[:, -2:] = 1
    (jb, jw), (pb, pw) = _both(full)
    bw, ww = bit1.pack_bits1(pb), bit1.pack_bits1(pw)
    assert (bw < 0).any()
    got = observables.bit1_col_up_counts(bw, ww, row_chunk=row_chunk)
    _eq(got, jobs.bit1_col_up_counts(jbit1.pack_bits1(jb),
                                      jbit1.pack_bits1(jw),
                                      row_chunk=row_chunk))
    _eq(got, full.sum(axis=0))


@pytest.mark.parametrize("seed", [0, 5])
def test_magnetization_matches_jax(seed):
    full = _full(seed, 6, 24)
    full[:2] = 1
    (jb, jw), (pb, pw) = _both(full)
    got = observables.magnetization(pb, pw)
    assert isinstance(got, float) and got == jobs.magnetization(jb, jw)


def _sims(backend, Y, X, seed=99, **kw):
    full = _full(seed, Y, X)
    (jb, jw), (pb, pw) = _both(full)
    jax_sim = JaxSimulation(JaxConfig(nrows=Y, ncols=X, temp=2.0, seed=seed,
                                      backend=backend, **kw),
                            state=(jb, jw))
    sim = Simulation(SimConfig(nrows=Y, ncols=X, temp=2.0, seed=seed,
                               backend=backend, device="cpu", **kw),
                     state=(pb, pw))
    return jax_sim, sim, full


@pytest.mark.parametrize("backend,shape", [("xla", (16, 128)),
                                           ("bit1", (16, 128)),
                                           ("bit1", (8, 64)),
                                           ("xla", (6, 24))])
def test_fourier_partials_match_jax(backend, shape):
    jax_sim, sim, full = _sims(backend, *shape)
    rows, cols = sim.fourier_partials()
    jrows, jcols = jax_sim.fourier_partials()
    for got, want, line in ((rows, jrows, full.sum(axis=1)),
                            (cols, jcols, full.sum(axis=0))):
        assert isinstance(got, np.ndarray) and got.dtype == np.int64
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, line)


def test_fourier_partials_after_steps_match_jax():
    """After three sweeps of each package's xla backend from its own
    initial state."""
    cfg = dict(nrows=16, ncols=128, temp=2.0, seed=99, backend="xla")
    jax_sim = JaxSimulation(JaxConfig(**cfg))
    sim = Simulation(SimConfig(**cfg, device="cpu"))
    jax_sim.advance(3)
    sim.advance(3)
    for got, want in zip(sim.fourier_partials(), jax_sim.fourier_partials()):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend", ["packed", "dense", "mxu"])
def test_fourier_partials_decode_path_matches_bit1(backend):
    """The backends without column counts of their own take the decode
    path (col_up_counts_via over _decode_rows) and give bit1's words'
    counts."""
    Y, X = (128, 256) if backend == "mxu" else (16, 128)
    full = _full(7, Y, X)
    _, (pb, pw) = _both(full)
    sims = [Simulation(SimConfig(nrows=Y, ncols=X, temp=2.0, backend=b,
                                 device="cpu"), state=(pb, pw))
            for b in ("bit1", backend)]
    assert not hasattr(sims[1].backend, "col_up_counts")
    for got, want in zip(sims[1].fourier_partials(),
                         sims[0].fourier_partials()):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [dict(xsl=16, ysl=8), dict(xsl=4, ysl=8,
                                                          backend="bit1",
                                                          ncols=128)])
def test_fourier_partials_refuse_replica_mode(kw):
    kw = {**dict(nrows=16, ncols=64, temp=2.0, seed=7, backend="xla"), **kw}
    errors = []
    for sim in (JaxSimulation(JaxConfig(**kw)),
                Simulation(SimConfig(**kw, device="cpu"))):
        with pytest.raises(ValueError, match="full-lattice") as e:
            sim.fourier_partials()
        errors.append(str(e.value))
    assert errors[0] == errors[1]
