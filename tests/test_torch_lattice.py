"""Port lattice init, bit1 packing and state interop against the JAX
package (bit-identical: every value is a bit)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ising_tpu import lattice as jlat
from ising_tpu.ops import pallas_bit1 as jbit1
from ising_tpu_torch import interop, lattice as tlat
from ising_tpu_torch.ops import bit1 as tbit1
from naive_reference import naive_init


@pytest.mark.parametrize("shape,seed", [((8, 64), 1), ((16, 128), 463463564571),
                                        ((12, 256), (1 << 40) + 3)])
def test_init_bits_matches_jax(shape, seed):
    Y, X = shape
    want = jlat.init_bits(seed, Y, X)
    got = tlat.init_bits(seed, Y, X, device="cpu")
    for w, g in zip(want, got):
        assert g.dtype == torch.uint8
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def test_init_bits_matches_naive_reference():
    b, w = tlat.init_bits(99, 6, 16, device="cpu")
    np.testing.assert_array_equal(tlat.compact_to_full(b, w).numpy(),
                                  naive_init(99, 6, 16))


def test_init_bits_row_slab():
    b, w = tlat.init_bits(5, 16, 64, device="cpu")
    bs, ws = tlat.init_bits(5, 16, 64, row0=6, local_rows=4, device="cpu")
    assert torch.equal(bs, b[6:10]) and torch.equal(ws, w[6:10])


@pytest.mark.parametrize("chunk", [2, 6, 8])
def test_init_store_chunked_matches_jax(chunk):
    Y, X, seed = 24, 128, 31
    want = jlat.init_store(seed, Y, X, lambda b, w: (jbit1.pack_bits1(b),
                                                     jbit1.pack_bits1(w)))
    enc = lambda b, w: (tbit1.pack_bits1(b), tbit1.pack_bits1(w))
    got = tlat.init_store(seed, Y, X, enc, chunk_rows=chunk, device="cpu")
    one = tlat.init_store(seed, Y, X, enc, device="cpu")
    for w, g, o in zip(want, got, one):
        assert torch.equal(g, o)
        np.testing.assert_array_equal(np.asarray(w), g.numpy().view(np.uint32))


@pytest.mark.parametrize("shape", [(4, 32), (8, 64), (3, 8192)])
def test_pack_unpack_bits1_match_jax(shape):
    bits = np.random.default_rng(shape[1]).integers(0, 2, shape, np.uint8)
    want = np.asarray(jbit1.pack_bits1(jnp.asarray(bits)))
    got = tbit1.pack_bits1(torch.from_numpy(bits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(want, got.numpy().view(np.uint32))
    np.testing.assert_array_equal(tbit1.unpack_bits1(got).numpy(), bits)
    np.testing.assert_array_equal(
        np.asarray(jbit1.unpack_bits1(jnp.asarray(want))),
        tbit1.unpack_bits1(got).numpy())


def test_compact_full_roundtrip_matches_jax():
    full = np.random.default_rng(4).integers(0, 2, (6, 16), np.uint8)
    jb, jw = jlat.full_to_compact(jnp.asarray(full))
    tb, tw = tlat.full_to_compact(torch.from_numpy(full))
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
    np.testing.assert_array_equal(np.asarray(jw), tw.numpy())
    np.testing.assert_array_equal(tlat.compact_to_full(tb, tw).numpy(), full)


def test_interop_roundtrip_bit_exact():
    gen = np.random.default_rng(8)
    b = gen.integers(0, 1 << 32, (4, 3), dtype=np.uint64).astype(np.uint32)
    w = gen.integers(0, 1 << 32, (4, 3), dtype=np.uint64).astype(np.uint32)
    b[0, 0], w[0, 0] = 0xFFFFFFFF, 0x80000000
    tb, tw = interop.from_numpy_words(b, w, device="cpu")
    assert tb.dtype == torch.int32 and tb.device.type == "cpu"
    rb, rw = interop.to_numpy_words(tb, tw)
    assert rb.dtype == np.uint32
    np.testing.assert_array_equal(rb, b)
    np.testing.assert_array_equal(rw, w)
    # The same bits as the JAX package's words: unpacking agrees.
    np.testing.assert_array_equal(np.asarray(jbit1.unpack_bits1(jnp.asarray(b))),
                                  tbit1.unpack_bits1(tb).numpy())


def test_interop_rejects_other_dtypes():
    with pytest.raises(TypeError):
        interop.from_numpy_words(np.zeros((2, 2), np.int64),
                                 np.zeros((2, 2), np.uint32), device="cpu")
