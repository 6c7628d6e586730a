"""The packed backend's disorder and replica paths and its Simulation, in
the port against the JAX package.

packed_sweep_reference with the J word, replicas (csl == 1, csl == W,
ysl over several 8-row blocks) and both, against the Pallas kernel in
interpret mode; Simulation trajectories, energies and up counts of the
packed backend against the JAX xla backend (whose u32 trajectories the
packed one equals) and once against JAX packed itself; build_disorder's
J word; and the backend's fences and their wording (the fused step,
ISING_TPU_FUSED, is in tests/test_torch_fused.py). Every compared value
is an integer or a bit pattern: exact equality.
"""

import numpy as np
import pytest
import torch

from ising_tpu import SimConfig as JaxConfig
from ising_tpu import driver as jdriver
from ising_tpu.driver import Simulation as JaxSimulation
from ising_tpu.ops import pallas_packed as jpacked
from ising_tpu.ops.registry import get_backend as jget_backend
from ising_tpu_torch import SimConfig, cli, driver
from ising_tpu_torch.driver import Simulation
from ising_tpu_torch.models import ising
from ising_tpu_torch.ops import get_backend, packed

from test_torch_packed import eight_row_blocks, sweep_both


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (shape, mode, color, temp, field, J word, csl, ysl): the J word alone;
# replicas with csl == 1 and ysl == 8 (a wrap inside a 16-row plane), with
# csl == W and ysl == H, and with ysl == 16 over two 8-row blocks; each
# replica case with and without J, a different mode and accept each.
PATH_CASES = [
    ((16, 8), "philox", 1, 1.5, 0.0, True, None, None),
    ((16, 4), "threefry13", 0, 0.0, 0.0, False, 1, 8),
    ((32, 8), "chacha8", 1, 1.5, 0.3, True, 8, 32),
    ((32, 8), "hw", 0, 1.5, 0.0, True, 4, 16),
]


@pytest.mark.parametrize("case", PATH_CASES,
                         ids=[f"{c[1]}-J{c[5]}-{c[6]}-{c[7]}"
                              for c in PATH_CASES])
def test_reference_matches_pallas_paths(case, monkeypatch):
    shape, mode, color, temp, field, jword, csl, ysl = case
    want, got, before = sweep_both(
        shape, mode, color, temp, field, 7, 8200 + PATH_CASES.index(case),
        monkeypatch, jword=jword, csl=csl, ysl=ysl)
    np.testing.assert_array_equal(got, want)
    assert (got != before).any()


def test_replicas_ignore_the_slab_halo_rows():
    """With ysl the rows above and below the slab are not read."""
    gen = np.random.default_rng(2)
    d, s = (torch.from_numpy(gen.integers(0, 1 << 31, (16, 4), dtype=np.int64)
                             .astype(np.int32)) for _ in range(2))
    thr = ising.threshold_table(1.5)
    kw = dict(color=0, seed=3, rng_mode="philox", csl=2, ysl=8)
    a = packed.packed_sweep_reference(d, s, s[:1], s[:1], thr, 0, 1, **kw)
    b = packed.packed_sweep_reference(d, s, s[:1] ^ 1, s[:1] ^ 7, thr, 0, 1,
                                      **kw)
    assert torch.equal(a, b)


def _mag_lines(text):
    return [ln for ln in text.splitlines() if "magnetization" in ln]


# Simulation configs: ordered, the greedy quench, the field (u32 full
# table), -J, replicas and both, in several u32 modes.
SIM_CASES = [
    dict(nrows=16, ncols=128, temp=1.5, seed=9, rng="philox"),
    dict(nrows=16, ncols=64, temp=0.0, seed=4, rng="threefry13"),
    dict(nrows=16, ncols=128, temp=1.4, seed=5, rng="chacha8", field=0.2),
    dict(nrows=16, ncols=128, temp=1.5, seed=13, rng="philox7", j_prob=0.35),
    dict(nrows=32, ncols=128, temp=1.5, seed=6, rng="chacha6", xsl=16, ysl=8),
    dict(nrows=16, ncols=128, temp=0.0, seed=7, rng="threefry", j_prob=0.5,
         j_seed=3, xsl=8, ysl=16),
]


@pytest.mark.parametrize("kw", SIM_CASES)
def test_simulation_matches_jax_xla(kw):
    """The packed trajectories are the xla backend's in every u32 mode:
    the lattice, measure(), energy(), energy_total() and the up counts
    after each pair of steps."""
    jsim = JaxSimulation(JaxConfig(backend="xla", **kw))
    tsim = Simulation(SimConfig(backend="packed", device="cpu", **kw))
    assert tsim.black.shape == (kw["nrows"], kw["ncols"] // 16)
    for _ in range(2):
        jsim.advance(2)
        tsim.advance(2)
        for a, b in zip(tsim.bits(), jsim.bits()):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert tsim.measure() == jsim.measure()
        assert tsim.energy_total() == jsim.energy_total()
        assert tsim.energy() == jsim.energy()
        np.testing.assert_array_equal(
            tsim.backend.row_up_counts(tsim.black, tsim.white).numpy(),
            np.asarray(jsim._up_rows_for(jsim.black, jsim.white)))


def test_simulation_matches_jax_packed(monkeypatch):
    """Once against the JAX packed backend itself (its Pallas kernel in
    interpret mode, 8-row blocks): the words, with the J word and
    replicas, and the energy streamed through decode."""
    eight_row_blocks(monkeypatch)
    kw = dict(nrows=16, ncols=128, temp=1.5, seed=21, rng="philox",
              j_prob=0.2, xsl=16, ysl=8)
    jsim = JaxSimulation(JaxConfig(backend="packed", **kw))
    tsim = Simulation(SimConfig(backend="packed", device="cpu", **kw))
    jsim.advance(3)
    tsim.advance(3)
    for a, b in ((tsim.black, jsim.black), (tsim.white, jsim.white)):
        np.testing.assert_array_equal(a.numpy().view(np.uint32), np.asarray(b))
    assert tsim.measure() == jsim.measure()
    assert tsim.energy_total() == jsim.energy_total()


def test_build_disorder_gives_one_j_word_per_color():
    """Chunked and one-shot: the parity-split link store (ncols % 64 == 0)
    for the energy, and per color the 1-tuple of the JAX package's J
    word."""
    kw = dict(nrows=16, ncols=128, temp=1.5, seed=5, j_prob=0.3, j_seed=77,
              backend="packed")
    jcfg = JaxConfig(**kw)
    jl, jpk, jj = jdriver.build_disorder(jcfg, jget_backend(jcfg))
    for chunk in (4, 8192):
        cfg = SimConfig(device="cpu", **kw)
        be = get_backend(cfg)
        links, pk, jplanes = driver.build_disorder(cfg, be, chunk_rows=chunk)
        assert pk and jpk and not getattr(be, "split_links", False)
        for a, b in zip(links, jl):
            np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                          np.asarray(b))
        for got, want in zip(jplanes, jj):
            assert len(got) == len(want) == 1
            np.testing.assert_array_equal(got[0].numpy().view(np.uint32),
                                          np.asarray(want[0]))


def test_retune_switches_greedy_and_full_table():
    kw = dict(nrows=16, ncols=64, temp=1.5, seed=22, rng="philox")
    jsim = JaxSimulation(JaxConfig(backend="xla", **kw))
    tsim = Simulation(SimConfig(backend="packed", device="cpu", **kw))
    be = tsim.backend
    assert (be.greedy, be.full_table) == (False, False)
    for temp, field in ((0.0, 0.0), (1.0, 0.4), (-1.0, 0.4), (2.0, 0.0)):
        jsim.set_temperature(temp)
        tsim.set_temperature(temp)
        jsim.set_field(field)
        tsim.set_field(field)
        assert (be.greedy, be.full_table) == (temp <= 0, field != 0)
        jsim.advance(2)
        tsim.advance(2)
        for a, b in zip(tsim.bits(), jsim.bits()):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("kw,msg", [
    (dict(rng="chacha6b"), "bit-plane rng modes"),
    (dict(xsl=16, ysl=8), r"xsl/2 \(8\) to divide ncols/16 \(4\)"),
    (dict(xsl=8, ysl=4), "ysl % 8 == 0"),
])
def test_backend_fences_match_jax(kw, msg):
    cfg = dict(backend="packed", nrows=16, ncols=64, **kw)
    with pytest.raises((ValueError, NotImplementedError), match=msg):
        jpacked.PackedBackend(JaxConfig(**cfg))
    with pytest.raises((ValueError, NotImplementedError), match=msg):
        packed.PackedBackend(SimConfig(device="cpu", **cfg))


def test_config_refuses_packed_hw_with_a_field():
    for cls in (JaxConfig, SimConfig):
        with pytest.raises(ValueError, match="u32-contract rng mode"):
            cls(backend="packed", ncols=64, rng="hw", field=0.1)
        with pytest.raises(ValueError, match="ncols multiple of 16"):
            cls(backend="packed", ncols=40)


@pytest.mark.parametrize("extra", [
    ["-J", "0.1", "--xsl", "16", "--ysl", "8"], ["--rng", "hw"],
    ["-t", "0"]])
def test_cli_lines_match_jax(extra, capsys, monkeypatch):
    """The port's CLI prints the JAX CLI's magnetization lines on packed
    (the JAX side with 8-row blocks in interpret mode)."""
    eight_row_blocks(monkeypatch)
    from ising_tpu import cli as jcli
    argv = ["--backend", "packed", "-x", "128", "-y", "16", "-n", "4", "-p",
            "2", "-t", "1.5"] + extra
    assert jcli.main(argv) == 0
    want = _mag_lines(capsys.readouterr().out)
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "\tbackend: packed (rng: " in out
    assert _mag_lines(out) == want and len(want) == 4
