"""Sub-lattice replicas (--xsl/--ysl) in the port against the JAX package.

The replica wrap maps, the bit1 plain sweep with the csl / ysl wraps
(against the JAX Pallas kernel in interpret mode, at the edge geometries
csl == 1, csl == W1, ysl == 8 and ysl == H, alone and with J planes), the
xla sweep with the index maps, Simulation trajectories on both port
backends, the per-replica |m|, the bit1 fences and the CLI. Two
behaviours of the JAX package that the port matches on purpose are pinned
here too: with disorder, a replica's wrap bond is seen with two different
flags from its two ends, and energy() sums the full lattice's bonds.
Every compared value is an integer or a bit pattern: exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ising_tpu.ops.pallas_dense as jdense
from ising_tpu import SimConfig as JaxConfig
from ising_tpu import cli as jcli
from ising_tpu import lattice as jlattice
from ising_tpu import observables as jobs
from ising_tpu.driver import Simulation as JaxSimulation
from ising_tpu.ops import pallas_bit1 as jbit1
from ising_tpu.ops import xla_ref as jxla
from ising_tpu_torch import SimConfig, cli, lattice, observables
from ising_tpu_torch.driver import Simulation
from ising_tpu_torch.models import ising
from ising_tpu_torch.ops import bit1, xla_ref

from test_torch_disorder import sweep_both


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's plain-torch sweeps run single-threaded here: the suite
    runs several test processes at once, and torch's intra-op threads
    on top of them slowed this file many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n,sl", [(16, 8), (16, 16), (32, 2), (12, 4)])
def test_wrap_maps_match_jax(n, sl):
    for got, want in zip(xla_ref.make_row_wrap_maps(n, sl),
                         jxla.make_row_wrap_maps(n, sl)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(xla_ref.make_col_wrap_maps(n, 2 * sl),
                         jxla.make_col_wrap_maps(n, 2 * sl)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ((H, W1), csl, ysl, mode, temp, field, J planes): csl == 1, csl == W1
# and between; ysl == 8 (a wrap inside a 16-row slab) and ysl == H; u32,
# bit-plane, hw and field accepts, the greedy quench; with and without J.
REPLICA_CASES = [
    ((16, 4), 1, 8, "philox", 1.7, 0.0, False),
    ((16, 4), 4, 16, "threefry13", 0.0, 0.0, False),
    ((16, 4), 2, 8, "chacha6b", 1.7, 0.0, False),
    ((16, 2), 2, 16, "hw", 1.7, 0.0, False),
    ((16, 4), 1, 16, "chacha8b", 1.7, 0.3, True),
    ((16, 4), 4, 8, "philox", 0.0, 0.0, True),
    ((16, 2), 1, 8, "chacha6", 1.7, 0.0, True),
    ((8, 256), 64, 8, "threefry13b", 1.7, 0.0, True),
]


@pytest.mark.parametrize("case", REPLICA_CASES,
                         ids=[f"{c[3]}-csl{c[1]}-ysl{c[2]}-J{int(c[6])}"
                              for c in REPLICA_CASES])
def test_reference_matches_pallas_replicas(case, monkeypatch):
    shape, csl, ysl, mode, temp, field, links = case
    color = REPLICA_CASES.index(case) % 2
    want, got, before = sweep_both(shape, mode, color, temp, field,
                                   4000 + REPLICA_CASES.index(case),
                                   monkeypatch, links=links, csl=csl, ysl=ysl)
    np.testing.assert_array_equal(got, want)
    assert (got != before).any()


def test_replica_cases_cover_edges():
    W1s = {c[0][1] for c in REPLICA_CASES}
    assert any(c[1] == 1 for c in REPLICA_CASES)
    assert any(c[1] == c[0][1] for c in REPLICA_CASES) and len(W1s) > 1
    assert {c[2] == c[0][0] for c in REPLICA_CASES} == {True, False}
    assert {c[6] for c in REPLICA_CASES} == {True, False}
    assert any(c[3] == "hw" for c in REPLICA_CASES)
    assert any(c[5] for c in REPLICA_CASES)


def test_replicas_ignore_the_slab_halo_rows():
    """With ysl, src_up / src_dn are not read (they are only the slab's
    periodic wrap)."""
    gen = np.random.default_rng(6)
    w = [torch.from_numpy(gen.integers(0, 1 << 32, (16, 4), dtype=np.uint64)
                          .astype(np.uint32).view(np.int32)) for _ in range(4)]
    kw = dict(color=0, seed=3, rng_mode="philox", greedy=False, csl=2, ysl=8)
    thr = ising.threshold_table(1.5)
    a = bit1.bit1_sweep_reference(w[0], w[1], w[2][:1], w[3][:1], thr, 0, 1,
                                  **kw)
    b = bit1.bit1_sweep_reference(w[0], w[1], w[3][:1], w[2][:1], thr, 0, 1,
                                  **kw)
    assert torch.equal(a, b)


@pytest.mark.parametrize("mode,jp", [("threefry13", False), ("chacha6b", True)])
def test_xla_update_color_with_maps_matches_jax(mode, jp):
    H, C = 16, 64
    gen = np.random.default_rng(21)
    dst, src = (gen.integers(0, 2, (H, C), dtype=np.uint8) for _ in range(2))
    planes = [gen.integers(0, 2, (H, C), dtype=np.uint8) for _ in range(4)]
    kw = dict(nrows=H, ncols=2 * C, temp=1.4, seed=31, rng=mode, xsl=8,
              ysl=8)
    jbe = jxla.XlaBackend(JaxConfig(**kw))
    tbe = xla_ref.XlaBackend(SimConfig(device="cpu", **kw))
    thr = ising.threshold_table(1.4)
    for color in (0, 1):
        want = jbe.update_color(
            jnp.asarray(dst), jnp.asarray(src), color=color,
            thr10=jnp.asarray(thr), step=5,
            jplanes=tuple(jnp.asarray(p) for p in planes) if jp else None)
        got = tbe.update_color(
            torch.from_numpy(dst), torch.from_numpy(src), color=color,
            thr10=thr, step=5,
            jplanes=[torch.from_numpy(p) for p in planes] if jp else None)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


SIM_CASES = [
    ("bit1", dict(nrows=16, ncols=256, temp=1.5, seed=9, xsl=8, ysl=8)),
    ("xla", dict(nrows=16, ncols=256, temp=1.5, seed=9, xsl=8, ysl=8)),
    ("bit1", dict(nrows=16, ncols=128, temp=0.0, seed=2, xsl=4, ysl=16,
                  j_prob=0.3, rng="chacha6b")),
    ("xla", dict(nrows=16, ncols=128, temp=1.2, seed=2, xsl=4, ysl=8,
                 j_prob=0.3, rng="philox")),
]


@pytest.mark.parametrize("backend,kw", SIM_CASES)
def test_simulation_replicas_matches_jax(backend, kw, monkeypatch):
    monkeypatch.setattr(jdense, "_pick_block_rows",
                        lambda nrows, target=256: 8 if nrows % 8 == 0 else nrows)
    jsim = JaxSimulation(JaxConfig(backend=backend, **kw))
    tsim = Simulation(SimConfig(backend=backend, device="cpu", **kw))
    if backend == "bit1":
        assert (tsim.backend.csl, tsim.backend.ysl) == (kw["xsl"] // 2,
                                                         kw["ysl"])
        assert not tsim.backend.split_links
    jsim.advance(3)
    tsim.advance(3)
    for a, b in zip(tsim.bits(), jsim.bits()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tsim.measure() == jsim.measure()
    assert tsim.energy_total() == jsim.energy_total()
    tb, jb = tsim.bits(), [np.asarray(x) for x in jsim.bits()]
    np.testing.assert_array_equal(
        observables.replica_magnetizations(*tb, kw["xsl"], kw["ysl"]),
        jobs.replica_magnetizations(*jb, kw["xsl"], kw["ysl"]))


def test_replica_magnetizations_matches_jax():
    gen = np.random.default_rng(4)
    b, w = (gen.integers(0, 2, (16, 32), dtype=np.uint8) for _ in range(2))
    for xsl, ysl in ((4, 8), (64, 16), (2, 2), (8, 4)):
        got = observables.replica_magnetizations(
            torch.from_numpy(b), torch.from_numpy(w), xsl, ysl)
        want = jobs.replica_magnetizations(b, w, xsl, ysl)
        assert got.shape == (16 // ysl * 64 // xsl,)
        np.testing.assert_array_equal(got, want)
    ones = torch.ones((16, 32), dtype=torch.uint8)
    assert (observables.replica_magnetizations(ones, ones, 8, 8) == 1).all()


@pytest.mark.parametrize("xsl,ysl,msg", [
    (128, 8, r"xsl/2 \(64\) to divide ncols/64 \(4\)"),
    (8, 4, "ysl % 8 == 0"),
])
def test_bit1_replica_fences_match_jax(xsl, ysl, msg):
    kw = dict(backend="bit1", nrows=16, ncols=256, xsl=xsl, ysl=ysl)
    for make in (lambda: bit1.Bit1Backend(SimConfig(device="cpu", **kw)),
                 lambda: jbit1.Bit1Backend(JaxConfig(**kw))):
        with pytest.raises(ValueError, match=msg):
            make()
    # the TPU's ncols % 8192 fence is not copied: W1 = 4 runs here
    assert bit1.Bit1Backend(SimConfig(device="cpu", **dict(kw, xsl=8,
                                                            ysl=8))).csl == 4


def _mag_lines(text):
    return [ln for ln in text.splitlines() if "magnetization" in ln]


@pytest.mark.parametrize("replicas", [True, False],
                         ids=["replicas+J", "split-links"])
def test_cli_lines_match_jax(replicas, capsys, monkeypatch):
    """`-J 0.1 --xsl 8 --ysl 16` on bit1 at 256^2 (csl = 4 = W1), and
    -J 0.1 alone (the split link store): the magnetization lines equal the
    JAX package's CLI's, and the header names both features."""
    monkeypatch.setattr(jdense, "_pick_block_rows",
                        lambda nrows, target=256: 16)
    argv = ["--backend", "bit1", "-J", "0.1", "-x", "256", "-y", "256", "-n",
            "8", "-p", "4", "-t", "1.5"]
    if replicas:
        argv += ["--xsl", "8", "--ysl", "16"]
    assert jcli.main(argv) == 0
    want = _mag_lines(capsys.readouterr().out)
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert len(want) == 4 and _mag_lines(out) == want
    assert "\tdisorder: P(antiferro link) = 0.1" in out
    assert ("\tsub-lattices: 8 x 16" in out) == replicas


def test_jax_wrap_bond_flags_differ_at_its_two_ends():
    """With replicas and disorder the per-color J planes come from the
    full lattice's links (lattice.links_to_color_planes, periodic roll):
    a replica's top row sees its wrapped up-neighbour (row y + ysl - 1)
    through v[y - 1], while that row sees it back as its down-neighbour
    through v[y + ysl - 1]. The JAX package does this, and the port
    matches it."""
    Y, X, ysl = 16, 64, 8
    v, h = ising.generate_disorder_links(17, Y, X, 0.5)
    jv, jh = (np.asarray(x) for x in (v, h))
    for color in (0, 1):
        other = 1 - color
        j_up = lattice.links_to_color_planes(v, h, color)[0]
        j_dn_other = lattice.links_to_color_planes(v, h, other)[1]
        jj_up = np.asarray(jlattice.links_to_color_planes(jv, jh, color)[0])
        np.testing.assert_array_equal(j_up.numpy(), jj_up)
        top, bottom = ysl, 2 * ysl - 1     # the wrap bond of replica 1
        # top row: the flag of the bond to row top - 1 (another replica)
        want_up = v[top - 1, 0::2] if (top % 2 == 0) == (color == 0) \
            else v[top - 1, 1::2]
        assert torch.equal(j_up[top], want_up)
        # the two ends of the one wrap bond disagree somewhere
        assert not torch.equal(j_up[top], j_dn_other[bottom])


def test_jax_energy_sums_full_lattice_bonds_in_replica_mode():
    """In replica mode energy() sums the full lattice's bonds, those
    across replica edges (which the dynamics never uses) included, as the
    JAX package's Simulation does: not the replicas' own periodic bonds."""
    kw = dict(nrows=16, ncols=128, temp=1.5, seed=5, xsl=4, ysl=8,
              j_prob=0.3)
    tsim = Simulation(SimConfig(backend="bit1", device="cpu", **kw))
    jsim = JaxSimulation(JaxConfig(backend="bit1", **kw))
    tsim.advance(2)
    jsim.advance(2)
    assert tsim.energy_total() == jsim.energy_total()
    b, w = tsim.bits()
    v, h = tsim.links()
    full = int(observables.energy_row_sums(b, w, v, h).sum())
    assert tsim.energy_total() == full
    # the replicas' own bonds: each replica periodic in itself
    s = 2 * lattice.compact_to_full(b, w).to(torch.int64) - 1
    J = lambda f: 1 - 2 * f.to(torch.int64)
    own = 0
    for r in range(0, 16, 8):
        for c in range(0, 128, 4):
            t = s[r:r + 8, c:c + 4]
            jv, jh = J(v[r:r + 8, c:c + 4]), J(h[r:r + 8, c:c + 4])
            own += int((t * torch.roll(t, -1, 0) * jv).sum()
                       + (t * torch.roll(t, -1, 1) * jh).sum())
    assert own != full
