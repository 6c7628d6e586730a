"""Row slabs of the port (ising_tpu_torch/parallel/: make_mesh, the halo
rows, make_sharded_stepper, and Simulation over a mesh) against the JAX
package's shard_map stepper on the conftest's 8 virtual CPU devices, and
against one device.

The port's mesh on the CPU is the one CPU device named once a slab, the
counterpart of the virtual devices. Initial states are made with numpy
from a seed; the Pallas backends of the JAX package run in interpret
mode. Everything compared is an integer plane or count: no tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ising_tpu import SimConfig as JaxConfig
from ising_tpu import get_backend as jget_backend
from ising_tpu.driver import Simulation as JaxSimulation
from ising_tpu.parallel import make_mesh as jmake_mesh
from ising_tpu.parallel import make_sharded_stepper as jstepper
from ising_tpu_torch import SimConfig
from ising_tpu_torch.device_trace import step_launches
from ising_tpu_torch.driver import Simulation, build_disorder
from ising_tpu_torch.models import ising
from ising_tpu_torch.ops import get_backend
from ising_tpu_torch.parallel import make_mesh, make_sharded_stepper
from ising_tpu_torch.parallel.halo import ring_halo_rows, ring_rows, \
    rows_after
from ising_tpu_torch.parallel.mesh import gather_rows, split_rows

CPU = torch.device("cpu")


def _planes(seed, Y, X):
    gen = np.random.default_rng(seed)
    return tuple(gen.integers(0, 2, (Y, X // 2), dtype=np.uint8)
                 for _ in range(2))


def _jax_run(kw, ndev, state, steps):
    """The JAX package's Simulation from `state`, stepped: its planes."""
    sim = JaxSimulation(JaxConfig(ndev=ndev, **kw),
                        state=tuple(jnp.asarray(p) for p in state))
    sim.advance(steps)
    return tuple(np.asarray(p) for p in sim.bits())


def _port(kw, ndev, state, steps, mesh=None):
    sim = Simulation(SimConfig(ndev=ndev, device="cpu", **kw), state=state,
                     mesh=mesh)
    sim.advance(steps)
    return sim


def _bits(sim):
    return tuple(p.numpy() for p in sim.bits())


def _equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


# -- the mesh and the halo rows ---------------------------------------------

def test_make_mesh_on_the_cpu_and_explicit_lists():
    assert make_mesh(4, device="cpu") == [CPU] * 4
    assert make_mesh(device="cpu") == [CPU]
    assert make_mesh(devices=["cpu", "cpu"]) == [CPU, CPU]
    assert make_mesh(2, devices=[CPU] * 3) == [CPU, CPU]
    # More than the list holds: the JAX package's refusal, word for word.
    with pytest.raises(ValueError) as got:
        make_mesh(9, devices=[CPU] * 8)
    with pytest.raises(ValueError) as want:
        jmake_mesh(9)
    assert str(got.value) == str(want.value) == \
        "requested 9 devices, only 8 present"
    assert jmake_mesh(8).devices.shape == (8,)


def test_make_mesh_takes_distinct_gpus_and_refuses_more(monkeypatch):
    """On CUDA the default is the first ndev GPUs, never one twice; more
    than are present raises, and so does a card that is not there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cuda = [torch.device("cuda", i) for i in range(2)]
    assert make_mesh(2) == cuda
    assert make_mesh() == cuda
    assert make_mesh(1) == cuda[:1]
    with pytest.raises(ValueError, match="requested 4 devices, only 2 "
                                         "present"):
        make_mesh(4)
    # An explicit list may name the one card several times.
    assert make_mesh(3, devices=[cuda[0]] * 3) == [cuda[0]] * 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh(2)


def test_cli_devs_beyond_the_gpus_exits_1(monkeypatch, capsys):
    from ising_tpu_torch import cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert cli.main(["--backend", "bit1", "-x", "64", "-y", "16", "-n",
                     "1", "--devs", "2"]) == 1
    assert "ERROR: requested 2 devices, only 1 present" in \
        capsys.readouterr().err


@pytest.mark.parametrize("n", [1, 2, 4])
def test_ring_halo_rows_and_ring_rows(n):
    x = torch.arange(8 * 3, dtype=torch.int32).reshape(8, 3)
    slabs = split_rows(x, [CPU] * n)
    assert torch.equal(gather_rows(slabs), x)
    L = 8 // n
    for k, (up, dn) in enumerate(ring_halo_rows(slabs)):
        assert torch.equal(up, x[(k * L - 1) % 8][None])
        assert torch.equal(dn, x[((k + 1) * L) % 8][None])
        # a view of the neighbour on the same device, not a copy
        assert up.data_ptr() == slabs[k - 1][-1:].data_ptr()
    idx = torch.arange(5, 5 + 19) % 8
    assert torch.equal(ring_rows(slabs, 5, 19, CPU), x[idx])
    for k in range(n):
        want = x[torch.arange((k + 1) * L, (k + 1) * L + 11) % 8]
        assert torch.equal(rows_after(slabs, k, 11), want)


# -- the stepper against JAX's shard_map stepper ----------------------------

@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_sharded_matches_single_and_jax(ndev):
    kw = dict(nrows=32, ncols=32, temp=2.0, seed=12345, backend="xla")
    state = _planes(1, 32, 32)
    one = _bits(_port(kw, 1, state, 4))
    many = _bits(_port(kw, ndev, state, 4))
    _equal(many, one)
    _equal(many, _jax_run(kw, ndev, state, 4))


def test_sharded_matches_naive():
    from naive_reference import naive_init, naive_step
    from ising_tpu_torch.lattice import compact_to_full
    cfg = SimConfig(nrows=8, ncols=16, temp=1.7, seed=42, backend="xla",
                    ndev=4, rng="philox", device="cpu")
    thr = ising.threshold_table(cfg.temperature)
    full = naive_init(cfg.seed, 8, 16)
    for step in range(3):
        full = naive_step(full, thr, cfg.seed, step)
    sim = Simulation(cfg)
    sim.advance(3)
    np.testing.assert_array_equal(compact_to_full(*sim.bits()).numpy(),
                                  full)


def test_sharded_ordered_state_stays_ordered():
    """An ordered state at low T stays ordered over 8 slabs."""
    Y, X = 64, 64
    ones = tuple(np.ones((Y, X // 2), np.uint8) for _ in range(2))
    sim = _port(dict(nrows=Y, ncols=X, temp=1.0, seed=7, backend="xla"), 8,
                ones, 60)
    assert sim.measure()["magnetization"] > 0.99


@pytest.mark.parametrize("backend,ndev", [("xla", 2), ("xla", 4),
                                          ("xla", 8), ("bit1", 2),
                                          ("bit1", 4), ("bit1", 8),
                                          ("packed", 2), ("packed", 4),
                                          ("packed", 8), ("dense", 2),
                                          ("dense", 4), ("dense", 8)])
def test_every_backend_matches_jax_at_n(backend, ndev):
    kw = dict(nrows=32, ncols=128, temp=1.7, seed=8, backend=backend,
              rng="philox")
    state = _planes(2, 32, 128)
    sim = _port(kw, ndev, state, 3)
    _equal(_bits(sim), _bits(_port(kw, 1, state, 3)))
    _equal(_bits(sim), _jax_run(kw, ndev, state, 3))


@pytest.mark.parametrize("ndev", [1, 2])
def test_mxu_matches_jax_at_n(ndev):
    kw = dict(nrows=256, ncols=256, temp=1.9, seed=77, backend="mxu",
              rng="threefry13")
    state = _planes(3, 256, 256)
    _equal(_bits(_port(kw, ndev, state, 2)), _jax_run(kw, ndev, state, 2))
    with pytest.raises(ValueError, match="slab height .* multiple of 128"):
        get_backend(SimConfig(nrows=256, ncols=256, backend="mxu", ndev=4,
                              device="cpu"))


def test_sharded_matches_across_backends():
    """packed, bit1 and dense over 4 slabs equal xla over 4 slabs."""
    state = _planes(4, 32, 128)
    base = dict(nrows=32, ncols=128, temp=1.7, seed=8, rng="threefry13")
    want = _bits(_port(dict(backend="xla", **base), 4, state, 3))
    for backend in ("packed", "bit1", "dense"):
        _equal(_bits(_port(dict(backend=backend, **base), 4, state, 3)),
               want)


@pytest.mark.parametrize("backend,xsl", [("xla", 16), ("packed", 16),
                                         ("bit1", 4)])
def test_sharded_replicas_match_single_and_jax(backend, xsl):
    kw = dict(nrows=32, ncols=128, temp=1.6, seed=29, backend=backend,
              xsl=xsl, ysl=8)
    state = _planes(5, 32, 128)
    sim = _port(kw, 4, state, 3)
    one = _port(kw, 1, state, 3)
    _equal(_bits(sim), _bits(one))
    _equal(_bits(sim), _jax_run(kw, 4, state, 3))
    np.testing.assert_array_equal(sim.replica_magnetizations(),
                                  one.replica_magnetizations())


@pytest.mark.parametrize("backend", ["xla", "packed", "bit1", "dense"])
def test_sharded_disorder_matches_single_and_jax(backend):
    """The J planes are built slab by slab; bit1 takes its J-plane path
    (split links are the one-device path)."""
    kw = dict(nrows=32, ncols=64, temp=1.4, seed=23, backend=backend,
              j_prob=0.35, j_seed=4)
    state = _planes(6, 32, 64)
    sim = _port(kw, 4, state, 3)
    assert not getattr(sim.backend, "split_links", False)
    one = _port(kw, 1, state, 3)
    _equal(_bits(sim), _bits(one))
    _equal(_bits(sim), _jax_run(kw, 4, state, 3))
    for a, b in zip(sim.links(), one.links()):
        assert torch.equal(a, b)
    assert sim.energy_total() == one.energy_total()


def test_build_disorder_per_slab_equals_whole():
    """Each slab's link store and J planes are the rows of the one-device
    ones, on the slab's device."""
    cfg = SimConfig(nrows=32, ncols=64, backend="packed", j_prob=0.3,
                    ndev=4, device="cpu")
    links, packed, (jb, jw) = build_disorder(cfg, get_backend(cfg),
                                             mesh=[CPU] * 4)
    one = SimConfig(nrows=32, ncols=64, backend="packed", j_prob=0.3,
                    device="cpu")
    l1, p1, (jb1, jw1) = build_disorder(one, get_backend(one))
    assert packed and p1 and len(links) == len(jb) == len(jw) == 4
    for got, want in ((links, l1), (jb, jb1), (jw, jw1)):
        for k, slab in enumerate(got):
            for g, w in zip(slab, want):
                assert torch.equal(g, w[8 * k:8 * (k + 1)])


@pytest.mark.parametrize("rng,field", [("threefry13b", 0.0),
                                       ("chacha8b", 0.0),
                                       ("threefry13b", 0.7),
                                       ("philox7b", -0.4)])
def test_sharded_plane_modes_and_field_match_jax(rng, field):
    kw = dict(nrows=32, ncols=128, temp=1.7, seed=9, backend="bit1",
              rng=rng, field=field)
    state = _planes(7, 32, 128)
    sim = _port(kw, 8, state, 3)
    _equal(_bits(sim), _bits(_port(kw, 1, state, 3)))
    _equal(_bits(sim), _jax_run(kw, 8, state, 3))
    xla = _port(dict(kw, backend="xla"), 4, state, 3)
    _equal(_bits(sim), _bits(xla))
    assert sim.measure() == xla.measure()


# -- halo_overlap ------------------------------------------------------------

@pytest.mark.parametrize("backend", ["xla", "packed", "bit1", "dense"])
def test_halo_overlap_matches_plain_and_jax(backend):
    kw = dict(nrows=128, ncols=64, temp=1.9, seed=77, backend=backend)
    state = _planes(8, 128, 64)
    plain = _port(kw, 4, state, 3)
    split = _port(dict(kw, halo_overlap=True), 4, state, 3)
    _equal(_bits(split), _bits(plain))
    if backend in ("xla", "packed"):
        _equal(_bits(split), _jax_run(dict(kw, halo_overlap=True), 4,
                                      state, 3))


@pytest.mark.parametrize("backend", ["xla", "bit1"])
def test_halo_overlap_with_disorder_matches_plain(backend):
    kw = dict(nrows=128, ncols=64, temp=1.4, seed=5, backend=backend,
              j_prob=0.3)
    state = _planes(9, 128, 64)
    _equal(_bits(_port(dict(kw, halo_overlap=True), 4, state, 2)),
           _bits(_port(kw, 4, state, 2)))


def test_halo_overlap_plane_rng_and_field_match_one_device():
    kw = dict(nrows=128, ncols=128, temp=1.7, seed=9, backend="bit1",
              rng="chacha8b", field=0.3)
    state = _planes(10, 128, 128)
    _equal(_bits(_port(dict(kw, halo_overlap=True), 2, state, 2)),
           _bits(_port(kw, 1, state, 2)))


def test_halo_overlap_is_ignored_on_one_device():
    kw = dict(nrows=16, ncols=64, temp=1.9, seed=3, backend="packed")
    state = _planes(11, 16, 64)
    _equal(_bits(_port(dict(kw, halo_overlap=True), 1, state, 2)),
           _bits(_port(kw, 1, state, 2)))


@pytest.mark.parametrize("kw,msg", [
    (dict(nrows=16, ncols=32, ndev=4), "local slab >= 32 rows"),
    (dict(nrows=128, ncols=64, ndev=2, xsl=16, ysl=8), "replica mode"),
    (dict(nrows=256, ncols=256, ndev=2, backend="mxu"), "mxu backend"),
])
def test_halo_overlap_refusals_match_jax(kw, msg):
    """The JAX package's refusals, with its wording."""
    cfg = SimConfig(halo_overlap=True, device="cpu", **kw)
    with pytest.raises(ValueError) as got:
        make_sharded_stepper(cfg, get_backend(cfg), mesh=[CPU] * cfg.ndev)
    jcfg = JaxConfig(halo_overlap=True, **kw)
    with pytest.raises(ValueError) as want:
        jstepper(jcfg, jget_backend(jcfg))
    assert str(got.value) == str(want.value)
    assert msg in str(got.value)
    with pytest.raises(ValueError, match=msg):
        Simulation(cfg)


# -- the stepper's own surface -----------------------------------------------

@pytest.mark.parametrize("backend", ["bit1", "packed", "xla"])
def test_force_collectives_is_bit_identical(backend):
    """One slab through the slab path (halo rows, row0, no fused step)
    equals the one-device loop."""
    cfg = SimConfig(nrows=32, ncols=64, temp=1.5, seed=21, backend=backend,
                    device="cpu")
    be = get_backend(cfg)
    thr = ising.threshold_table(cfg.temperature)
    state = _planes(12, 32, 64)
    runs = []
    for force in (False, True):
        b, w = be.encode(*(torch.from_numpy(p) for p in state))
        sh, step_n = make_sharded_stepper(cfg, be, force_collectives=force)
        assert sh["mesh"] == ([CPU] if force else None)
        b, w = step_n([b] if force else b, [w] if force else w, thr, 5, 3)
        if force:
            assert isinstance(b, list) and len(b) == 1
            b, w = b[0], w[0]
        runs.append(tuple(p.numpy() for p in be.decode(b, w)))
    _equal(runs[1], runs[0])


def test_stepper_takes_a_mesh_of_its_size():
    cfg = SimConfig(nrows=32, ncols=64, backend="bit1", ndev=4, device="cpu")
    with pytest.raises(ValueError, match="a mesh of 2 devices for ndev = 4"):
        make_sharded_stepper(cfg, get_backend(cfg), mesh=[CPU] * 2)
    with pytest.raises(ValueError, match="a mesh of 2 devices for ndev = 4"):
        Simulation(cfg, mesh=[CPU] * 2)
    sim = Simulation(cfg, mesh=[CPU] * 4)
    assert sim.mesh == [CPU] * 4 and len(sim.black) == 4
    assert all(b.shape == (8, 1) for b in sim.black)


@pytest.mark.parametrize("kw,want", [
    (dict(backend="bit1", ndev=1), 2), (dict(backend="bit1", ndev=4), 8),
    (dict(backend="packed", ndev=4, halo_overlap=True), 24),
    (dict(backend="dense", ndev=1, halo_overlap=True), 2)])
def test_step_launches_per_slab(kw, want):
    cfg = SimConfig(nrows=128, ncols=64, device="cpu", **kw)
    assert step_launches(cfg) == (f"{kw['backend']}_sweep", want)


def test_initial_state_per_slab_equals_one_device():
    """init_store slab by slab (row0, local_rows) is the one-device
    init's rows, on every backend's storage."""
    from ising_tpu_torch.lattice import init_store
    for backend in ("bit1", "packed", "xla"):
        one = Simulation(SimConfig(nrows=64, ncols=64, backend=backend,
                                   device="cpu"))
        many = Simulation(SimConfig(nrows=64, ncols=64, backend=backend,
                                    ndev=8, device="cpu"))
        for whole, slabs in ((one.black, many.black),
                             (one.white, many.white)):
            assert torch.equal(gather_rows(slabs), whole)
    be = get_backend(SimConfig(ncols=64, device="cpu"))
    b, w = init_store(5, 64, 64, be.encode, chunk_rows=6, device="cpu",
                      row0=16, local_rows=24)
    B, W = init_store(5, 64, 64, be.encode, device="cpu")
    assert torch.equal(b, B[16:40]) and torch.equal(w, W[16:40])


def test_xla_hw_slabs_draw_distinct_streams():
    """xla with hw folds row0 into its key (as the JAX package does): the
    slabs of a sharded run draw distinct streams, so an all-up lattice
    sheds different spins in every slab; the run stays physical."""
    Y, X = 64, 64
    ones = tuple(np.ones((Y, X // 2), np.uint8) for _ in range(2))
    kw = dict(nrows=Y, ncols=X, temp=3.0, seed=5, backend="xla", rng="hw")
    sim = _port(kw, 4, ones, 1)
    b, _ = sim.bits()
    slabs = b.reshape(4, 16, X // 2)
    assert all(not torch.equal(slabs[0], slabs[k]) for k in range(1, 4))
    cold = _port(dict(kw, temp=1.0), 4, ones, 40)
    assert cold.measure()["magnetization"] > 0.99


def test_set_temperature_and_field_reach_every_slab():
    """The ramp and a field change act on every slab's next launch:
    4 slabs equal one device through both."""
    kw = dict(nrows=32, ncols=128, temp=1.5, seed=13, backend="bit1",
              rng="threefry13b", field=0.2)
    state = _planes(13, 32, 128)
    sims = [Simulation(SimConfig(ndev=n, device="cpu", **kw), state=state)
            for n in (1, 4)]
    for s in sims:
        s.advance(2)
        s.set_temperature(0.0)
        s.advance(1)
        s.set_field(-0.5)
        s.set_temperature(2.5)
        s.advance(2)
    _equal(_bits(sims[1]), _bits(sims[0]))
    assert sims[1].energy() == sims[0].energy()
