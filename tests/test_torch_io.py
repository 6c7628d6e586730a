"""The port's lattice dumps, -c correlation files and bit1's word-domain
byte paths (ising_tpu_torch/io.py, observables.py, ops/bit1.py, and
Simulation's and SwendsenWang's -o / -c) against the JAX package's, byte
for byte.

The same compact planes and words, made with numpy from a seed, go into
both packages (a Simulation takes them as its state, so no JAX sweep runs
here but the Swendsen-Wang CLI's), and the files each writes must be equal
byte for byte; the integer sums behind them must be equal too. Both
packages write into tmp_path; no file is committed. The IO goldens in
ising_tpu_torch/golden.py are derived here again from the JAX package.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ising_tpu import SimConfig as JaxConfig
from ising_tpu import cli as jcli
from ising_tpu import io as jio
from ising_tpu import lattice as jlattice
from ising_tpu import observables as jobs
from ising_tpu.checkpoint import _pack_rows as jax_pack_rows
from ising_tpu.cluster import SwendsenWang as JaxSwendsenWang
from ising_tpu.driver import Simulation as JaxSimulation
from ising_tpu.ops import pallas_bit1 as jbit1
from ising_tpu_torch import SimConfig, cli, golden, io, lattice, observables
from ising_tpu_torch.checkpoint import _pack_rows, _unpack_rows_device
from ising_tpu_torch.cluster import SwendsenWang
from ising_tpu_torch.constants import MAX_CORR_LEN, TCRIT
from ising_tpu_torch.driver import Simulation
from ising_tpu_torch.ops import bit1


def _planes(seed, Y, X):
    """Random compact (black, white) uint8 planes of a Y x X lattice."""
    gen = np.random.default_rng(seed)
    return tuple(gen.integers(0, 2, (Y, X // 2), dtype=np.uint8)
                 for _ in range(2))


def _words(seed, Y, W1):
    """Random (Y, W1) uint32 words, bit 31 set in the first."""
    w = np.random.default_rng(seed).integers(
        0, 2 ** 32, (Y, W1), dtype=np.uint64).astype(np.uint32)
    w[0, 0] |= 0x80000000
    return w


def _tw(w):
    return torch.from_numpy(w.view(np.int32).copy())


def _t(planes):
    return tuple(torch.from_numpy(p) for p in planes)


def _j(planes):
    return tuple(jnp.asarray(p) for p in planes)


@pytest.mark.parametrize("fmt", ["hex", "txt"])
@pytest.mark.parametrize("shape", [(8, 16), (64, 512)])
def test_dump_matches_jax(tmp_path, fmt, shape):
    """Hex and txt dumps, byte for byte, and both packages load either."""
    planes = _planes(1, *shape)
    io.dump_lattice(str(tmp_path / "port"), *_t(planes), fmt=fmt)
    jio.dump_lattice(str(tmp_path / "jax"), *_j(planes), fmt=fmt)
    assert (tmp_path / "port").read_bytes() == (tmp_path / "jax").read_bytes()
    for b, want in zip(io.load_lattice(str(tmp_path / "jax"), fmt,
                                       device="cpu"), planes):
        assert b.dtype == torch.uint8 and np.array_equal(b.numpy(), want)
    for b, want in zip(jio.load_lattice(str(tmp_path / "port"), fmt), planes):
        assert np.array_equal(np.asarray(b), want)
    with pytest.raises(ValueError, match="unknown dump format 'png'"):
        io.dump_lattice(str(tmp_path / "x"), *_t(planes), fmt="png")


def test_lattice_image_matches_jax():
    planes = _planes(2, 8, 16)
    img = io.lattice_image(*_t(planes))
    assert img.dtype == np.int8
    assert np.array_equal(img, jio.lattice_image(*_j(planes)))
    full = np.asarray(jlattice.compact_to_full(*_j(planes)))
    assert np.array_equal(
        lattice.bits_to_spins(torch.from_numpy(full.copy())).numpy(),
        np.asarray(jlattice.bits_to_spins(jnp.asarray(full))))


@pytest.mark.parametrize("fmt", ["hex", "txt"])
@pytest.mark.parametrize("backend", ["xla", "bit1", "packed", "dense",
                                     "mxu"])
def test_dump_streamed_matches_one_shot(tmp_path, monkeypatch, backend, fmt):
    """dump_lattice_streamed over the backend's row decode, in chunks of 48
    of 128 rows, writes the one-shot dump's bytes (the JAX package's), and
    Simulation.dump streams at or above STREAM_DUMP_SPINS."""
    planes = _planes(3, 128, 256)
    sim = Simulation(SimConfig(nrows=128, ncols=256, backend=backend,
                               device="cpu"), state=planes)
    be = sim.backend
    io.dump_lattice_streamed(
        str(tmp_path / "s"),
        lambda r0, r1: be.decode(sim.black[r0:r1], sim.white[r0:r1]),
        128, fmt=fmt, row_chunk=48)
    jio.dump_lattice(str(tmp_path / "j"), *_j(planes), fmt=fmt)
    want = (tmp_path / "j").read_bytes()
    assert (tmp_path / "s").read_bytes() == want
    if fmt == "hex":
        monkeypatch.setattr(Simulation, "STREAM_DUMP_SPINS", 128 * 256)
        sim.dump(str(tmp_path / "d"))
        assert (tmp_path / "d").read_bytes() == want


CORR_CASES = [
    # (Y, X, xsl, ysl, row_chunk): slabs that do not divide nrows' run of
    # offsets, replicas of several slabs and replica tiles of 6 rows
    (16, 64, None, None, 6), (16, 64, 8, 4, 8), (12, 128, 16, 6, 4),
    (24, 128, 32, 8, 16), (8, 64, None, None, 8192),
]


@pytest.mark.parametrize("Y, X, xsl, ysl, row_chunk", CORR_CASES)
def test_correlation_row_sums_match_jax(Y, X, xsl, ysl, row_chunk):
    """Every (offset, row) sum equal to the JAX package's, over the full
    lattice and in replicas, in slabs; on bit1's words too; c(d) the same
    floats. 9 offsets (more than the 8-row lattice's height)."""
    planes = _planes(4, Y, X)
    want = np.asarray(jobs.correlation_row_sums(*_j(planes), 9, xsl, ysl,
                                                row_chunk=row_chunk))
    got = observables.correlation_row_sums(*_t(planes), 9, xsl, ysl,
                                           row_chunk=row_chunk)
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)
    assert np.array_equal(observables.correlation(*_t(planes), 9, xsl, ysl),
                          jobs.correlation(*_j(planes), 9, xsl, ysl))
    if xsl is None:
        words = (bit1.pack_bits1(p) for p in _t(planes))
        rows = observables.bit1_correlation_row_sums(*words, 9,
                                                     row_chunk=row_chunk)
        assert np.array_equal(rows.numpy(), want)


def _corr_line(sim, directory, it):
    with contextlib.chdir(directory):
        sim._append_corr(it)
        return (directory / sim._corr_path()).read_bytes()


@pytest.mark.parametrize("backend, xsl, ysl", [
    ("bit1", None, None), ("xla", None, None), ("packed", None, None),
    ("dense", None, None), ("bit1", 16, 8)])
def test_corr_lines_match_jax(tmp_path, backend, xsl, ysl):
    """Simulation._append_corr's -c lines equal the JAX package's, byte for
    byte, from the same state: bit1 on its words, the others through the
    decode path, bit1's replicas through the decoded planes; the 64 rows
    are fewer than MAX_CORR_LEN, so the vertical offsets wrap more than
    once."""
    planes = _planes(5, 64, 512)
    kw = dict(nrows=64, ncols=512, temp=1.25, seed=9, backend=backend,
              xsl=xsl, ysl=ysl)
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    port = Simulation(SimConfig(**kw, device="cpu"), state=planes)
    jax = JaxSimulation(JaxConfig(**kw), state=_j(planes))
    assert port._corr_path() == jax._corr_path() == "corr_64x512_T_1.250000_9"
    for it in (4, 1234567890):
        got = _corr_line(port, tmp_path / "p", it)
        assert got == _corr_line(jax, tmp_path / "j", it)
    lines = got.decode().splitlines()
    assert len(lines) == 2 and len(lines[0].split()) == 1 + MAX_CORR_LEN


@pytest.mark.parametrize("Y, W1", [(3, 8), (2, 24)])
def test_words_to_packed_rows_match_jax(Y, W1):
    """bit1's word shuffle gives the checkpoint's bytes of the decoded
    plane (np.packbits order), as the JAX package's does, bit 31 included;
    its inverse gives the words back."""
    w = _words(6, Y, W1)
    got = bit1.words_to_packed_rows(_tw(w))
    want = np.array(jbit1.words_to_packed_rows(jnp.asarray(w)))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    assert np.array_equal(want, _pack_rows(bit1.unpack_bits1(_tw(w))))
    assert np.array_equal(want, jax_pack_rows(jbit1.unpack_bits1(
        jnp.asarray(w))))
    back = bit1.packed_rows_to_words(torch.from_numpy(want), W1)
    assert torch.equal(back, _tw(w))
    assert np.array_equal(
        np.asarray(jbit1.packed_rows_to_words(want, W1)), w)


@pytest.mark.parametrize("W1", [1, 4, 12])
def test_word_paths_fall_back_unless_w1_divides_by_8(W1):
    """W1 % 8 != 0: the shuffles refuse, as the JAX package's do, and the
    backend's fast paths return None (the decode path takes over)."""
    w = _tw(_words(7, 4, W1))
    with pytest.raises(ValueError, match="W1 % 8 == 0"):
        bit1.words_to_packed_rows(w)
    with pytest.raises(ValueError, match="W1 % 8 == 0"):
        jbit1.words_to_packed_rows(jnp.zeros((4, W1), jnp.uint32))
    with pytest.raises(ValueError, match="W1 % 8 == 0"):
        bit1.packed_rows_to_words(torch.zeros((4, 4 * W1), dtype=torch.uint8),
                                  W1)
    be = bit1.Bit1Backend(SimConfig(nrows=4, ncols=64 * W1, backend="bit1",
                                    device="cpu"))
    assert not be.storage_pack_supported(w)
    assert be.pack_storage_rows(w, w, 0, 4) is None
    pb = np.zeros((4, 4 * W1), np.uint8)
    assert be.encode_packed_rows(pb, pb) is None


def test_word_paths_equal_decode_paths():
    """On the same words (bit 31 set in some): pack_storage_rows equals the
    packed decode, encode_packed_rows the encode of the unpacked bytes, and
    corr_rows correlation_rows_via over decoded rows, every int64 sum."""
    Y, W1 = 40, 8
    b, w = _tw(_words(8, Y, W1)), _tw(_words(9, Y, W1))
    be = bit1.Bit1Backend(SimConfig(nrows=Y, ncols=64 * W1, backend="bit1",
                                    device="cpu"))
    for r0, r1 in ((0, 16), (16, 40), (38, 40)):
        pb, pw = be.pack_storage_rows(b, w, r0, r1)
        db, dw = be.decode(b[r0:r1], w[r0:r1])
        assert np.array_equal(pb.numpy(), _pack_rows(db))
        assert np.array_equal(pw.numpy(), _pack_rows(dw))
        eb, ew = be.encode_packed_rows(pb.numpy(), pw.numpy())
        ub, uw = be.encode(_unpack_rows_device(pb.numpy(), 32 * W1, "cpu"),
                           _unpack_rows_device(pw.numpy(), 32 * W1, "cpu"))
        assert torch.equal(eb, ub) and torch.equal(ew, uw)
        assert torch.equal(eb, b[r0:r1]) and torch.equal(ew, w[r0:r1])
    sim = Simulation(SimConfig(nrows=Y, ncols=64 * W1, backend="bit1",
                               device="cpu"), storage=(b, w))
    via = observables.correlation_rows_via(sim._decode_rows, Y, 20,
                                           row_chunk=16)
    assert torch.equal(be.corr_rows(b, w, 20), via)


@pytest.mark.parametrize("xsl, ysl", [(None, None), (64, 16)])
def test_sw_files_match_jax(tmp_path, xsl, ysl):
    """SwendsenWang's -c line and dump equal the JAX package's from the
    same state, in replica mode too."""
    planes = _planes(10, 64, 512)
    kw = dict(nrows=64, ncols=512, temp=TCRIT, seed=3, xsl=xsl, ysl=ysl)
    port = SwendsenWang(SimConfig(**kw, device="cpu"), state=planes)
    jax = JaxSwendsenWang(JaxConfig(**kw), state=_j(planes))
    for sim, d in ((port, tmp_path / "p"), (jax, tmp_path / "j")):
        d.mkdir()
        with contextlib.chdir(d):
            sim._append_corr(7)
            sim._dump(7)
    for name in ("corr_64x512_T_2.269185_3",
                 "lattice_64x512_T_2.269185_IT_00000007.txt"):
        assert (tmp_path / "p" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()


def test_jax_sw_corr_is_full_lattice_in_replica_mode(tmp_path):
    """The JAX package's SwendsenWang writes the full-lattice correlation in
    replica mode (cluster.py:586-593 passes no xsl/ysl), where its
    Simulation writes the replicas' (driver.py:449-456). The port matches
    the JAX file: its SW line is the full-lattice one, not the replicas'."""
    planes = _planes(11, 64, 512)
    kw = dict(nrows=64, ncols=512, temp=TCRIT, seed=3, xsl=64, ysl=16)
    jax = JaxSwendsenWang(JaxConfig(**kw), state=_j(planes))
    port = SwendsenWang(SimConfig(**kw, device="cpu"), state=planes)
    line = _corr_line(jax, tmp_path, 1).decode().split()[1:]
    full = [f"{v:< 12G}".strip() for v in jobs.correlation(*_j(planes))]
    replicas = [f"{v:< 12G}".strip()
                for v in jobs.correlation(*_j(planes), xsl=64, ysl=16)]
    assert line == full and line != replicas
    (tmp_path / "p").mkdir()
    assert _corr_line(port, tmp_path / "p", 1).decode().split()[1:] == full


def test_cli_sw_outputs_match_jax(tmp_path, capsys):
    """--algo sw with -o -c: the same -c file, measurement dumps and final
    dump as the JAX CLI."""
    argv = ["--algo", "sw", "-x", "512", "-y", "64", "-n", "2", "-p", "1",
            "-a", "1.0", "-o", "-c"]
    for main, d, extra in ((jcli.main, tmp_path / "j", []),
                           (cli.main, tmp_path / "p", ["--device", "cpu"])):
        d.mkdir()
        with contextlib.chdir(d):
            assert main(argv + extra) == 0
    assert "Wrote final lattice to final_64x512.txt" in capsys.readouterr().out
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "p").iterdir())
    assert len(names) == 4
    for name in names:
        assert (tmp_path / "p" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()


@pytest.mark.parametrize("case", list(golden.IO_GOLDEN))
def test_io_golden_comes_from_jax(tmp_path, case):
    """The JAX package's three files for the case's state (its xla backend
    steps the counter-mode trajectory, which every backend shares; the
    files are written by the case's backend)."""
    x = JaxSimulation(JaxConfig(**dict(golden.io_config(case),
                                       backend="xla")))
    x.advance(golden.IO_NSTEPS)
    sim = JaxSimulation(JaxConfig(**golden.io_config(case)), state=x.bits(),
                        step0=golden.IO_NSTEPS)
    assert golden.io_crcs(sim, tmp_path) == golden.IO_GOLDEN[case]


@pytest.mark.parametrize("case", list(golden.IO_GOLDEN))
def test_port_reproduces_io_golden_on_cpu(tmp_path, case):
    assert golden.port_io_files(case, tmp_path, device="cpu") == \
        golden.IO_GOLDEN[case]
