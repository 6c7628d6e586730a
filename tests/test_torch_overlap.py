"""The replica overlap of the port (ising_tpu_torch/observables.py,
Simulation.overlap_with, the bit1 and packed backends' overlap_neq_rows,
tempering.replica_overlap) against the JAX package's, exactly.

Words and planes made with numpy from a seed go into both packages: the
word-domain XOR counts with bit1's mask and packed's, with row chunking;
the decode-path counts; Simulation.overlap_with on all five backends from
the same two states (a Simulation takes them as its state, so no JAX sweep
runs here), self-overlap 1, mixed-backend pairs; and replica_overlap of
two ladders with its errors, whose JAX side runs on the xla backend (the
trajectories of a counter mode are the same on every backend). Tolerance
0: q is the same float expression of the same integers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ising_tpu import SimConfig as JaxConfig
from ising_tpu import lattice as jlattice
from ising_tpu import observables as jobs
from ising_tpu.driver import Simulation as JaxSimulation
from ising_tpu.tempering import ParallelTempering as JaxPT
from ising_tpu.tempering import replica_overlap as jax_replica_overlap
from ising_tpu_torch import SimConfig, lattice, observables
from ising_tpu_torch.driver import Simulation
from ising_tpu_torch.tempering import ParallelTempering, replica_overlap

# The JAX overlap tests' shapes (tests/test_overlap.py)
SHAPES = {"xla": (16, 32), "dense": (16, 32), "packed": (16, 64),
          "bit1": (16, 128), "mxu": (128, 256)}


def _words(seed, shape):
    """Random uint32 words (numpy) and the same bits as the port's int32."""
    u = np.random.default_rng(seed).integers(0, 1 << 32, shape,
                                             dtype=np.uint32)
    return u, torch.from_numpy(u.view(np.int32).copy())


@pytest.mark.parametrize("mask", [0xFFFFFFFF, 0x11111111])
@pytest.mark.parametrize("shape,row_chunk", [((8, 4), 16384), ((12, 3), 5),
                                             ((6, 1), 2)])
def test_word_overlap_neq_rows_matches_jax(mask, shape, row_chunk):
    (jb1, b1), (jw1, w1), (jb2, b2), (jw2, w2) = (
        _words(s, shape) for s in range(4))
    got = observables.word_overlap_neq_rows(b1, w1, b2, w2, field_mask=mask,
                                            row_chunk=row_chunk)
    want = jobs.word_overlap_neq_rows(*map(jnp.asarray, (jb1, jw1, jb2, jw2)),
                                      field_mask=mask, row_chunk=row_chunk)
    assert got.dtype == torch.int64 and (b1 < 0).any()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.int64))


def _planes(seed, Y, X):
    full = np.random.default_rng(seed).integers(0, 2, (Y, X), dtype=np.uint8)
    jb, jw = jlattice.full_to_compact(jnp.asarray(full))
    pb, pw = lattice.full_to_compact(torch.from_numpy(full))
    return (jb, jw), (pb, pw)


@pytest.mark.parametrize("row_chunk", [2, 6, 8192])
def test_overlap_neq_rows_via_matches_jax(row_chunk):
    (ja, pa), (jb, pb) = _planes(1, 24, 16), _planes(2, 24, 16)
    dec = lambda p: lambda r, n: (p[0][r:r + n], p[1][r:r + n])
    got = observables.overlap_neq_rows_via(dec(pa), dec(pb), 24,
                                           row_chunk=row_chunk)
    want = jobs.overlap_neq_rows_via(dec(ja), dec(jb), 24,
                                     row_chunk=row_chunk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.int64))


def _pair(backend, seeds=(21, 22), shape=None, **kw):
    """Two Simulations of each package, from the same two random states."""
    Y, X = shape or SHAPES[backend]
    out = {"jax": [], "port": []}
    for s in seeds:
        (jb, jw), (pb, pw) = _planes(s, Y, X)
        out["jax"].append(JaxSimulation(JaxConfig(
            nrows=Y, ncols=X, temp=2.0, seed=s, backend=backend, **kw),
            state=(jb, jw)))
        out["port"].append(Simulation(SimConfig(
            nrows=Y, ncols=X, temp=2.0, seed=s, backend=backend,
            device="cpu", **kw), state=(pb, pw)))
    return out


@pytest.mark.parametrize("backend", list(SHAPES))
def test_overlap_with_matches_jax(backend):
    sims = _pair(backend)
    a, b = sims["port"]
    q = a.overlap_with(b)
    assert q == sims["jax"][0].overlap_with(sims["jax"][1])
    assert b.overlap_with(a) == q
    assert a.overlap_with(a) == 1.0
    assert -1.0 < q < 1.0


def test_overlap_with_disorder_matches_jax():
    sims = _pair("packed", j_prob=0.4, j_seed=77)
    assert sims["port"][0].overlap_with(sims["port"][1]) == \
        sims["jax"][0].overlap_with(sims["jax"][1])


def test_word_path_only_for_one_backend_type(monkeypatch):
    """Same-type bit1 and packed pairs count on their words; a mixed pair
    goes through both decodes and gives the same q as the JAX package's
    mixed pair (here bit1 against xla from the same states)."""
    Y, X = SHAPES["bit1"]
    calls = []
    for be in ("bit1", "packed"):
        sims = _pair(be, shape=(Y, X))
        a, b = sims["port"]
        orig = type(a.backend).overlap_neq_rows
        monkeypatch.setattr(type(a.backend), "overlap_neq_rows",
                            lambda self, *t, orig=orig: (
                                calls.append(self.name), orig(self, *t))[1])
        a.overlap_with(b)
    assert calls == ["bit1", "packed"]
    mixed = {}
    for pkg in ("jax", "port"):
        one = _pair("bit1", shape=(Y, X))[pkg][0]
        other = _pair("xla", shape=(Y, X))[pkg][1]
        mixed[pkg] = (one.overlap_with(other), other.overlap_with(one))
    assert calls == ["bit1", "packed"]
    assert mixed["port"] == mixed["jax"]
    for be in ("packed", "dense", "xla"):
        twin = _pair(be, shape=(Y, X))["port"][0]
        assert _pair("bit1", shape=(Y, X))["port"][0].overlap_with(twin) \
            == 1.0


def test_overlap_after_steps_equal_across_backends():
    """Port to port: after six sweeps from the same seeds, the overlap is
    the same on xla, packed and bit1 (their trajectories are)."""
    Y, X = SHAPES["bit1"]
    qs = {}
    for backend in ("xla", "packed", "bit1"):
        a, b = (Simulation(SimConfig(nrows=Y, ncols=X, temp=2.0, seed=s,
                                     backend=backend, device="cpu"))
                for s in (5, 6))
        a.advance(6)
        b.advance(6)
        qs[backend] = a.overlap_with(b)
    assert qs["xla"] == qs["packed"] == qs["bit1"]


def test_overlap_geometry_error_matches_jax():
    errors = []
    for Cfg, Sim, kw in ((JaxConfig, JaxSimulation, {}),
                         (SimConfig, Simulation, {"device": "cpu"})):
        a = Sim(Cfg(nrows=16, ncols=32, temp=2.0, **kw))
        b = Sim(Cfg(nrows=16, ncols=64, temp=2.0, **kw))
        with pytest.raises(ValueError, match="geometry") as e:
            a.overlap_with(b)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def _ladders(seed, *, port_backend="xla", temps=(0.8, 1.2, 1.8), **kw):
    """One ladder of each package at 16 x 64 with -J 0.5 (j_seed 31), the
    JAX one on its xla backend."""
    cfg = dict(nrows=16, ncols=64, temp=1.0, seed=seed, j_prob=0.5,
               j_seed=31, **kw)
    return (JaxPT(JaxConfig(**cfg, backend="xla"), list(temps),
                  sweeps_per_swap=1),
            ParallelTempering(SimConfig(**cfg, backend=port_backend,
                                        device="cpu"), list(temps),
                              sweeps_per_swap=1))


def test_replica_overlap_matches_jax():
    (ja, pa), (jb, pb) = _ladders(100), _ladders(200)
    ports = {be: (_ladders(100, port_backend=be)[1],
                  _ladders(200, port_backend=be)[1])
             for be in ("packed", "bit1")}
    for _ in range(3):
        for pt in (ja, jb, pa, pb, *ports["packed"], *ports["bit1"]):
            pt.advance_round()
    want = jax_replica_overlap(ja, jb)
    assert replica_overlap(pa, pb) == want
    assert len(want) == 3 and len(set(want)) > 1
    for be, (a, b) in ports.items():
        assert replica_overlap(a, b) == want, be
    for k in range(3):
        assert want[k] == pa.sims[k].overlap_with(pb.sims[k])


@pytest.mark.parametrize("what,other,match", [
    ("temperature grid", dict(seed=400, temps=(0.8, 1.3, 1.8)),
     "temperature grid"),
    ("disorder seed", dict(seed=300, j_seed_of=99), "SAME disorder"),
    ("disorder probability", dict(seed=500, j_prob_of=0.3), "SAME disorder"),
    ("shared rung seed", dict(seed=100), "share thermal seed"),
    ("seed shared across rungs", dict(seed=100 + 1000003),
     "share thermal seed"),
])
def test_replica_overlap_errors_match_jax(what, other, match):
    errors = []
    for pkg in (0, 1):
        kw = dict(nrows=16, ncols=64, temp=1.0, backend="xla",
                  j_prob=other.get("j_prob_of", 0.5),
                  j_seed=other.get("j_seed_of", 31))
        if pkg:
            Cfg, PT, overlap, kw["device"] = (SimConfig, ParallelTempering,
                                              replica_overlap, "cpu")
        else:
            Cfg, PT, overlap = JaxConfig, JaxPT, jax_replica_overlap
        base = dict(kw, j_prob=0.5, j_seed=31)
        pa = PT(Cfg(**base, seed=100), [0.8, 1.2, 1.8], sweeps_per_swap=1)
        pb = PT(Cfg(**kw, seed=other["seed"]),
                list(other.get("temps", (0.8, 1.2, 1.8))), sweeps_per_swap=1)
        with pytest.raises(ValueError, match=match) as e:
            overlap(pa, pb)
        errors.append(str(e.value))
    assert errors[0] == errors[1], what
