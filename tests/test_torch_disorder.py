"""Quenched +-J disorder in the port against the JAX package.

The link draws (one-shot and in row chunks), the per-color projections,
build_disorder, the bit1 plain sweep with J planes and with the split
link store (against the JAX Pallas kernel in interpret mode, with several
row blocks), the xla sweep with J planes, the disordered energies, and
Simulation trajectories, energies and links() on both port backends.
Inputs come from numpy seeds; every compared value is an integer or a bit
pattern, so the tolerance is exact equality. The module also holds the
repairs of the CLI (every SimConfig field passed), the bit1 decode (row
chunks) and the xla backend's hw accept.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ising_tpu.ops.pallas_dense as jdense
from ising_tpu import SimConfig as JaxConfig
from ising_tpu import cli as jcli
from ising_tpu import driver as jdriver
from ising_tpu import lattice as jlattice
from ising_tpu import observables as jobs
from ising_tpu.driver import Simulation as JaxSimulation
from ising_tpu.models import ising as jising
from ising_tpu.ops import get_backend as jget_backend
from ising_tpu.ops import pallas_bit1 as jbit1
from ising_tpu.ops import xla_ref as jxla
from ising_tpu_torch import SimConfig, cli, lattice, observables
from ising_tpu_torch import driver
from ising_tpu_torch.driver import Simulation
from ising_tpu_torch.models import ising
from ising_tpu_torch.ops import bit1, get_backend, xla_ref


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's plain-torch sweeps run single-threaded here: the suite
    runs several test processes at once, and torch's intra-op threads
    on top of them slowed this file many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _words(gen, shape):
    return gen.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def _tw(a):
    """uint32 numpy words -> the port's int32 words."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def sweep_both(shape, mode, color, temp, field, seed, monkeypatch, *,
               links=False, split=False, csl=None, ysl=None, row0=0):
    """(JAX words, port words, input words) after one half-sweep of the
    same random (H, W1) words, with four random link planes when `links`
    (this color's J planes, or the split store with `split`) and the
    replica geometry csl / ysl. The JAX kernel runs 8-row blocks."""
    H, W1 = shape
    gen = np.random.default_rng(seed)
    dst, src = _words(gen, (H, W1)), _words(gen, (H, W1))
    up, dn = _words(gen, (1, W1)), _words(gen, (1, W1))
    jp = [_words(gen, (H, W1)) for _ in range(4)] if links else None
    thr = ising.threshold_table(temp, field)
    step = int(gen.integers(0, 1 << 32))
    acc = bit1.plane_accept_args(mode, temp, field)
    monkeypatch.setattr(jdense, "_pick_block_rows",
                        lambda nrows, target=256: 8 if nrows % 8 == 0 else nrows)
    want = jbit1.bit1_sweep(
        jnp.asarray(dst), jnp.asarray(src), jnp.asarray(up), jnp.asarray(dn),
        jnp.asarray(thr), jnp.uint32(row0), jnp.uint32(step),
        None if jp is None else tuple(jnp.asarray(p) for p in jp),
        color=color, seed=seed, rng_mode=mode, interpret=True,
        greedy=temp <= 0, grows=0, csl=csl, ysl=ysl, split_links=split,
        kbits=bit1.accept_bits(mode) or 24, **acc)
    got = bit1.bit1_sweep_reference(
        _tw(dst), _tw(src), _tw(up), _tw(dn), thr, row0, step,
        None if jp is None else [_tw(p) for p in jp], color=color, seed=seed,
        rng_mode=mode, greedy=temp <= 0, split_links=split, csl=csl, ysl=ysl,
        **acc)
    return np.asarray(want), got.numpy().view(np.uint32), dst


# (mode, temp, field): u32 Philox, Threefry and ChaCha, a bit-plane mode,
# hw, the greedy quench, the field accept.
ACCEPT_CASES = [("philox", 1.7, 0.0), ("threefry13", 0.0, 0.0),
                ("chacha6", 1.7, 0.0), ("chacha6b", 1.7, 0.0),
                ("hw", 0.0, 0.0), ("philox7b", 1.7, 0.3)]


@pytest.mark.parametrize("split", [False, True], ids=["jplanes", "split"])
@pytest.mark.parametrize("mode,temp,field", ACCEPT_CASES)
def test_reference_matches_pallas_disorder(mode, temp, field, split,
                                           monkeypatch):
    """J planes, and the split link store projected in the kernel, over
    two 8-row blocks (the split path's j_up crosses a block edge and wraps
    at row 0); the colors alternate over the cases."""
    color = (ACCEPT_CASES.index((mode, temp, field)) + split) % 2
    seed = zlib.crc32(f"{mode} {temp} {field} {split}".encode())
    want, got, before = sweep_both((16, 2), mode, color, temp, field, seed,
                                   monkeypatch, links=True, split=split,
                                   row0=32)
    np.testing.assert_array_equal(got, want)
    assert (got != before).any()


def test_split_links_equal_projected_planes():
    """The kernel's split projection is links_to_color_planes on words."""
    gen = np.random.default_rng(3)
    v, h = (torch.from_numpy(gen.integers(0, 2, (8, 128), dtype=np.uint8))
            for _ in range(2))
    store = [bit1._u(bit1.pack_bits1(p)) for p in
             (v[:, 0::2], v[:, 1::2], h[:, 0::2], h[:, 1::2])]
    for color in (0, 1):
        want = [bit1._u(bit1.pack_bits1(p)) for p in
                lattice.links_to_color_planes(v, h, color)]
        got = bit1.split_link_planes(store, color)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("shape,p,seed", [((8, 16), 0.3, 1),
                                          ((16, 64), 0.5, 7),
                                          ((6, 128), 0.05, 2 ** 40 + 3)])
def test_generate_disorder_links_matches_jax(shape, p, seed):
    Y, X = shape
    jv, jh = jising.generate_disorder_links(seed, Y, X, p)
    v, h = ising.generate_disorder_links(seed, Y, X, p)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    assert v.dtype == torch.uint8 and 0 < int(v.sum()) < v.numel()
    # a row slab of the same stream
    sv, sh = ising.generate_disorder_links(seed, Y, X, p, row0=2,
                                           local_rows=2)
    np.testing.assert_array_equal(sv.numpy(), v[2:4].numpy())
    np.testing.assert_array_equal(sh.numpy(), h[2:4].numpy())


@pytest.mark.parametrize("color", [0, 1])
def test_links_to_color_planes_matches_jax(color):
    gen = np.random.default_rng(10 + color)
    v, h = (gen.integers(0, 2, (8, 32), dtype=np.uint8) for _ in range(2))
    v_up = gen.integers(0, 2, (1, 32), dtype=np.uint8)
    for kw, tkw in (({}, {}), ({"v_up": jnp.asarray(v_up)},
                               {"v_up": torch.from_numpy(v_up)})):
        want = jlattice.links_to_color_planes(jnp.asarray(v), jnp.asarray(h),
                                              color, **kw)
        got = lattice.links_to_color_planes(torch.from_numpy(v),
                                            torch.from_numpy(h), color, **tkw)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("backend,ncols", [("bit1", 128), ("xla", 128),
                                           ("xla", 96)])
def test_build_disorder_matches_jax(backend, ncols):
    """Chunked (4-row chunks) and one-shot: the packed parity-split store
    at ncols % 64 == 0 (the J planes of both colors on bit1), uint8 links
    otherwise, and per-color J planes on xla."""
    kw = dict(nrows=16, ncols=ncols, temp=1.5, seed=5, j_prob=0.3, j_seed=77,
              backend=backend)
    jcfg = JaxConfig(**kw)
    jl, jpacked, jj = jdriver.build_disorder(jcfg, jget_backend(jcfg))
    for chunk in (4, 8192):
        cfg = SimConfig(device="cpu", **kw)
        be = get_backend(cfg)
        links, packed, jplanes = driver.build_disorder(cfg, be,
                                                       chunk_rows=chunk)
        assert packed == jpacked == (ncols % 64 == 0)
        assert getattr(be, "split_links", False) == (backend == "bit1")
        for a, b in zip(links, jl):
            np.testing.assert_array_equal(a.numpy().view(np.asarray(b).dtype),
                                          np.asarray(b))
        for got, want in zip(jplanes, jj):
            for a, b in zip(got, want):
                np.testing.assert_array_equal(
                    a.numpy().view(np.asarray(b).dtype), np.asarray(b))


@pytest.mark.parametrize("mode", ["philox", "chacha6b"])
def test_xla_update_color_with_jplanes_matches_jax(mode):
    H, C = 8, 64
    gen = np.random.default_rng(zlib.crc32(mode.encode()))
    dst, src = (gen.integers(0, 2, (H, C), dtype=np.uint8) for _ in range(2))
    jp = [gen.integers(0, 2, (H, C), dtype=np.uint8) for _ in range(4)]
    kw = dict(nrows=H, ncols=2 * C, temp=1.4, seed=31, rng=mode)
    jbe = jxla.XlaBackend(JaxConfig(**kw))
    tbe = xla_ref.XlaBackend(SimConfig(device="cpu", **kw))
    thr = ising.threshold_table(1.4)
    for color in (0, 1):
        want = jbe.update_color(jnp.asarray(dst), jnp.asarray(src),
                                color=color, thr10=jnp.asarray(thr), step=3,
                                src_up=jnp.asarray(src[-1:]),
                                src_dn=jnp.asarray(src[:1]),
                                jplanes=tuple(jnp.asarray(p) for p in jp))
        got = tbe.update_color(torch.from_numpy(dst), torch.from_numpy(src),
                               color=color, thr10=thr, step=3,
                               src_up=torch.from_numpy(src[-1:]),
                               src_dn=torch.from_numpy(src[:1]),
                               jplanes=[torch.from_numpy(p) for p in jp])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_disordered_energies_match_jax():
    gen = np.random.default_rng(8)
    Y, C = 12, 64
    b, w = (gen.integers(0, 2, (Y, C), dtype=np.uint8) for _ in range(2))
    v, h = (gen.integers(0, 2, (Y, 2 * C), dtype=np.uint8) for _ in range(2))
    want = np.asarray(jobs.energy_row_sums(b, w, v, h))
    t = [torch.from_numpy(x) for x in (b, w, v, h)]
    for chunk in (4, 8192):
        np.testing.assert_array_equal(
            observables.energy_row_sums(*t, row_chunk=chunk).numpy(), want)
        store = [bit1.pack_bits1(x) for x in
                 (t[2][:, 0::2], t[2][:, 1::2], t[3][:, 0::2], t[3][:, 1::2])]
        got = observables.bit1_energy_row_sums(
            bit1.pack_bits1(t[0]), bit1.pack_bits1(t[1]), links_words=store,
            row_chunk=chunk)
        np.testing.assert_array_equal(got.numpy(), want)
        jgot = jobs.bit1_energy_row_sums(
            jbit1.pack_bits1(jnp.asarray(b)), jbit1.pack_bits1(jnp.asarray(w)),
            links_words=tuple(jnp.asarray(x.numpy().view(np.uint32))
                              for x in store))
        np.testing.assert_array_equal(np.asarray(jgot), want)


# (backend, config): the field in a bit-plane mode runs on bit1 only here
# (the JAX xla backend takes a minute to compile it on the CPU; golden.py's
# philox7b case holds the port's xla to it), on xla in a u32 mode.
SIM_CASES = [
    (be, kw) for be in ("bit1", "xla") for kw in (
        dict(nrows=16, ncols=128, temp=1.5, seed=9, j_prob=0.35),
        dict(nrows=32, ncols=128, temp=1.4, seed=13, j_prob=0.35),
        dict(nrows=16, ncols=256, temp=0.0, seed=4, j_prob=0.5, j_seed=3,
             rng="chacha6b"))] + [
    ("bit1", dict(nrows=16, ncols=128, temp=1.5, seed=9, j_prob=0.3,
                  rng="chacha8b", field=0.1)),
    ("xla", dict(nrows=16, ncols=128, temp=1.5, seed=9, j_prob=0.3,
                 rng="philox", field=0.2)),
]


@pytest.mark.parametrize("backend,kw", SIM_CASES)
def test_simulation_disorder_matches_jax(kw, backend, monkeypatch):
    """Trajectories, energy(), energy_total() and links(); bit1 runs the
    split link store (with 8-row blocks on the JAX side, its multi-block
    case)."""
    monkeypatch.setattr(jdense, "_pick_block_rows",
                        lambda nrows, target=256: 8 if nrows % 8 == 0 else nrows)
    jsim = JaxSimulation(JaxConfig(backend=backend, **kw))
    tsim = Simulation(SimConfig(backend=backend, device="cpu", **kw))
    if backend == "bit1":
        assert tsim.backend.split_links and jsim.backend.split_links
    for _ in range(2):
        jsim.advance(2)
        tsim.advance(2)
        for a, b in zip(tsim.bits(), jsim.bits()):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert tsim.energy_total() == jsim.energy_total()
        assert tsim.energy() == jsim.energy()
        assert tsim.measure() == jsim.measure()
    for a, b in zip(tsim.links(), jsim.links()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_links_slab_crosses_chunks():
    """links() unpacks the packed store in row slabs; a slab height that
    does not divide the lattice gives the same planes."""
    sim = Simulation(SimConfig(backend="bit1", nrows=16, ncols=128, j_prob=0.4,
                               device="cpu"))
    v, h = sim.links()
    v3, h3 = sim._links_slab_of(sim._links_store, 0, 16, chunk=3)
    assert torch.equal(v, v3) and torch.equal(h, h3)
    want = ising.generate_disorder_links(sim.cfg.seed, 16, 128, 0.4)
    assert torch.equal(v, want[0]) and torch.equal(h, want[1])
    tail = sim._links_slab_of(sim._links_store, 5, 7, chunk=2)
    assert torch.equal(tail[0], v[5:12]) and torch.equal(tail[1], h[5:12])


def test_cli_passes_every_field():
    """Every field of the JAX package's config_from_args reaches SimConfig
    (the seven it dropped included), and the lifted flags change the run."""
    argv = ["--backend", "bit1", "-x", "128", "-y", "16", "-J", "0.2",
            "--j-seed", "5", "--xsl", "4", "--ysl", "8", "-d", "1", "-o",
            "-c", "--device", "cpu"]
    args = cli.build_parser().parse_args(argv)
    want = jcli.config_from_args(jcli.build_parser().parse_args(argv[:-2]))
    cfg = cli.config_from_args(args)   # -o / -c reach SimConfig
    for field in ("j_prob", "j_seed", "xsl", "ysl", "ndev", "dump_lattice",
                  "corr_out"):
        assert getattr(cfg, field) == getattr(want, field)
    assert cfg.dump_lattice and cfg.corr_out
    base = ["--backend", "bit1", "-x", "128", "-y", "16", "-n", "3", "-t",
            "1.5", "--device", "cpu"]
    finals = []
    for extra in ([], ["-J", "0.2"], ["-J", "0.2", "--j-seed", "5"],
                  ["--xsl", "4", "--ysl", "8"]):
        sim = Simulation(cli.config_from_args(
            cli.build_parser().parse_args(base + extra)))
        sim.advance(3)
        finals.append(bytes(sim.black.numpy()) + bytes(sim.white.numpy()))
    assert len(set(finals)) == 4


def test_decode_crosses_chunk_boundary():
    """Bit1Backend.decode unpacks in row chunks (here 4 rows over 10) to
    the JAX package's planes, uint8, through int32 shifts."""
    gen = np.random.default_rng(12)
    b, w = (_words(gen, (10, 3)) for _ in range(2))
    be = bit1.Bit1Backend(SimConfig(backend="bit1", ncols=192, device="cpu"))
    want = [np.asarray(jbit1.unpack_bits1(jnp.asarray(x))) for x in (b, w)]
    for chunk in (4, 10, 8192):
        got = be.decode(_tw(b), _tw(w), chunk=chunk)
        for a, x in zip(got, want):
            assert a.dtype == torch.uint8 and a.shape == (10, 96)
            np.testing.assert_array_equal(a.numpy(), x)


def test_unpack_keeps_to_one_int32_plane(monkeypatch):
    """unpack_bits1 shifts the int32 words a bit at a time: no int64 (or
    (Y, 32, W1)) transient is made."""
    seen = []
    real = torch.Tensor.__rshift__

    def spy(self, other):
        out = real(self, other)
        seen.append((out.dtype, tuple(out.shape)))
        return out
    monkeypatch.setattr(torch.Tensor, "__rshift__", spy)
    words = _tw(_words(np.random.default_rng(1), (5, 2)))
    out = bit1.unpack_bits1(words)
    assert out.shape == (5, 64) and out.dtype == torch.uint8
    assert set(seen) == {(torch.int32, (5, 2))} and len(seen) == 32


def test_xla_hw_field_takes_the_u32_table():
    """What config.py's comment states: on xla, hw (like the u32 modes)
    compares u32 draws against the full 2 x 5 table under a field; only
    the "...b" modes take bit1's bit-serial accept."""
    hw = xla_ref.XlaBackend(SimConfig(ncols=64, rng="hw", field=0.2,
                                      device="cpu"))
    assert hw.kplanes == 0 and hw.full_table and hw.accept == {}
    b = xla_ref.XlaBackend(SimConfig(ncols=64, rng="chacha6b", field=0.2,
                                     device="cpu"))
    assert b.kplanes == 16 and "tvals10" in b.accept
