"""The port's native codec (ising_tpu_torch/native/codec.py, g++) against
the JAX package's codec and the port's rng, at tolerance 0: Philox and
ChaCha known answers and streams, hex round trips, and the bytes of
io.dump_lattice through the codec and through numpy against the JAX
package's file. Skips where g++ is missing (the port's codec then does not
build, and the JAX package's does not import)."""

import subprocess

import numpy as np
import pytest
import torch

from ising_tpu_torch import io as tio
from ising_tpu_torch import rng as trng
from ising_tpu_torch.lattice import full_to_compact

SEED = 463463564571


@pytest.fixture(scope="module")
def native():
    from ising_tpu_torch.native import codec
    try:
        codec.load()
    except (OSError, subprocess.SubprocessError):
        pytest.skip("g++ unavailable: the native codec does not build")
    return codec


@pytest.fixture(scope="module")
def jax_native():
    return pytest.importorskip("ising_tpu.native.codec",
                               reason="g++ unavailable")


def test_codec_builds_into_build_dir(native):
    path = native.library_path()
    assert path.parent.name == "_build" and path.is_file()
    assert path.parent.parent.name == "ising_tpu_torch"
    assert native.build() == (path, 0.0)     # built once, then reused


def test_library_name_carries_host_cpu(native, monkeypatch):
    """A -march=native build made on another CPU has another name, so it
    is never loaded here."""
    here = native.library_path()
    monkeypatch.setattr(native, "host_cpu", lambda: b"flags\t: other")
    assert native.library_path() != here


def test_philox_kat(native, jax_native):
    for ctr, key, want in (
            ((0, 0, 0, 0), (0, 0),
             (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
            ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
             (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD))):
        assert native.philox4x32(ctr, key) == want
        assert jax_native.philox4x32(ctr, key) == want
        assert tuple(trng.philox4x32(*ctr, *key)) == want


@pytest.mark.parametrize("rounds", [7, 10])
def test_philox_matches_port_and_jax(native, jax_native, rounds):
    for ctr, key in [((1, 2, 3, 4), (5, 6)), ((7, 0, 9, 0), (0, 1)),
                     ((0xDEADBEEF, 3, 0xFFFFFFFF, 1), (SEED & 0xFFFFFFFF,
                                                      SEED >> 32))]:
        cpp = native.philox4x32(ctr, key, rounds)
        assert cpp == jax_native.philox4x32(ctr, key, rounds)
        assert cpp == tuple(trng.philox4x32(*ctr, *key, rounds))


@pytest.mark.parametrize("row0", [0, 4, 1000])
def test_philox_plane_matches_color_draws(native, jax_native, row0):
    step, tag = 7, 1
    want = trng.color_draws(SEED, 8, 32, step=step, tag=tag,
                            row0=row0).numpy()
    cpp = native.philox_plane(SEED, step, tag, row0, 8, 32)
    np.testing.assert_array_equal(cpp, want)
    np.testing.assert_array_equal(
        cpp, jax_native.philox_plane(SEED, step, tag, row0, 8, 32))
    # a slice of rows is the plane's rows
    np.testing.assert_array_equal(
        native.philox_plane(SEED, step, tag, row0 + 3, 5, 32), cpp[3:])


@pytest.mark.parametrize("rounds", [2, 4, 6, 8])
def test_chacha_block_matches_port_and_jax(native, jax_native, rounds):
    for ctr, key in [((0, 0), (0, 0)), ((1, 2), (5, 6)),
                     ((0xFFFFFFFF, 0xFFFFFFFF), (0xDEADBEEF, 0x12345678))]:
        cpp = native.chacha_block(ctr[0], ctr[1], 7, 3, key, rounds)
        assert cpp == jax_native.chacha_block(ctr[0], ctr[1], 7, 3, key,
                                              rounds)
        assert cpp == tuple(trng.chacha_block(ctr[0], ctr[1], 7, 3, *key,
                                              rounds))


@pytest.mark.parametrize("rounds", [2, 4, 6, 8])
@pytest.mark.parametrize("row0", [0, 5])
def test_chacha_plane_matches_color_draws(native, jax_native, rounds, row0):
    step, tag = 7, 1
    want = trng.chacha_color_draws(SEED, 8, 64, step=step, tag=tag,
                                   row0=row0, rounds=rounds).numpy()
    cpp = native.chacha_plane(SEED, step, tag, row0, 8, 64, rounds)
    np.testing.assert_array_equal(cpp, want)
    np.testing.assert_array_equal(
        cpp, jax_native.chacha_plane(SEED, step, tag, row0, 8, 64, rounds))


@pytest.mark.parametrize("shape", [(16, 64), (1, 8), (7, 130)])
def test_hex_round_trip_and_jax_bytes(native, jax_native, tmp_path, shape):
    bits = np.random.default_rng(shape[1]).integers(
        0, 2, shape).astype(np.uint8)
    p, q = str(tmp_path / "port.txt"), str(tmp_path / "jax.txt")
    native.write_hex(p, bits)
    jax_native.write_hex(q, bits)
    assert open(p, "rb").read() == open(q, "rb").read()
    np.testing.assert_array_equal(native.read_hex(p), bits)
    np.testing.assert_array_equal(native.read_hex(q), jax_native.read_hex(q))


def test_read_rejects_what_jax_rejects(native, jax_native, tmp_path):
    for name, text in (("bad.txt", "01x0\n0101\n"), ("ragged.txt",
                                                    "0101\n010\n")):
        p = tmp_path / name
        p.write_text(text)
        with pytest.raises(OSError) as te:
            native.read_hex(str(p))
        with pytest.raises(OSError) as je:
            jax_native.read_hex(str(p))
        assert str(te.value) == str(je.value)
    missing = str(tmp_path / "missing.txt")
    with pytest.raises(OSError) as te:
        native.read_hex(missing)
    with pytest.raises(OSError) as je:
        jax_native.read_hex(missing)
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="2-D"):
        native.write_hex(str(tmp_path / "x.txt"), np.zeros(8, np.uint8))


@pytest.mark.parametrize("text", [
    "0101\r\n1100\r\n", "\n0101\n\n1100\n\n", "0101\n1100",
    "0101\n110", "0101\n11001", "0101\n", "", "\n\n", "01\r01\n1100\n",
    "0101\n1100\nx", "0101\n110\n0x\n", "0101\n1x\n110\n"])
def test_read_matches_jax_reader(native, jax_native, tmp_path, text):
    """The one-pass reader takes and refuses what the JAX package's two
    passes do: carriage returns, empty lines, a last line without its
    newline (short: -4; long: cut), bad characters and ragged lines in
    file order."""
    p = tmp_path / "edge.txt"
    p.write_bytes(text.encode())
    try:
        want = jax_native.read_hex(str(p))
    except OSError as e:
        with pytest.raises(OSError) as te:
            native.read_hex(str(p))
        assert str(te.value) == str(e)
    else:
        got = native.read_hex(str(p))
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_hex_blocks_cross_lines(native, jax_native, tmp_path):
    """A file of more than one 8 MiB block, whose block ends fall inside
    lines, round-trips and is the JAX codec's file."""
    bits = np.random.default_rng(7).integers(
        0, 2, (1100, 8191)).astype(np.uint8)
    p, q = str(tmp_path / "port.txt"), str(tmp_path / "jax.txt")
    native.write_hex(p, bits)
    jax_native.write_hex(q, bits)
    assert open(p, "rb").read() == open(q, "rb").read()
    np.testing.assert_array_equal(native.read_hex(p), bits)


@pytest.mark.parametrize("shape", [(8, 16), (34, 64)])
def test_dump_lattice_bytes_match_jax(native, tmp_path, monkeypatch, shape):
    """io.dump_lattice through the codec and through numpy writes the JAX
    package's hex file (its own codec), byte for byte, and load_lattice
    reads each back through either path."""
    import jax.numpy as jnp
    from ising_tpu import io as jio
    from ising_tpu.lattice import full_to_compact as jax_full_to_compact
    full = np.random.default_rng(shape[0]).integers(
        0, 2, shape).astype(np.uint8)
    jio.dump_lattice(str(tmp_path / "jax.txt"),
                     *jax_full_to_compact(jnp.asarray(full)), fmt="hex")
    planes = full_to_compact(torch.from_numpy(full))
    assert tio.native_codec() is native
    tio.dump_lattice(str(tmp_path / "codec.txt"), *planes, fmt="hex")
    back_codec = tio.load_lattice(str(tmp_path / "jax.txt"), device="cpu")
    monkeypatch.setattr(tio, "native_codec", lambda: None)
    tio.dump_lattice(str(tmp_path / "numpy.txt"), *planes, fmt="hex")
    back_numpy = tio.load_lattice(str(tmp_path / "jax.txt"), device="cpu")
    want = (tmp_path / "jax.txt").read_bytes()
    assert (tmp_path / "codec.txt").read_bytes() == want
    assert (tmp_path / "numpy.txt").read_bytes() == want
    for back in (back_codec, back_numpy):
        assert all(torch.equal(a, b) for a, b in zip(back, planes))
