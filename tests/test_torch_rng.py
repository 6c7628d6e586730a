"""The port's counter generators against the JAX package's, bit for bit.

Inputs are made with numpy and handed to both packages; every compared
value is a uint32 bit pattern, so the tolerance is exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ising_tpu import rng as jrng
from ising_tpu_torch import rng as trng
from naive_reference import (chacha_ref, philox4x32_ref, site_draw,
                             threefry2x32_ref)

SEEDS = (0, 463463564571, (1 << 32) + 7, (1 << 63) + 12345)
# Every mode with a counter contract (hw draws from jax.random in the JAX
# package and from torch's generator here).
COUNTER_MODES = [m for m in trng.PORTED_MODES if m != "hw"]


def _u32(gen, shape):
    return gen.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.int64))


def _np(t):
    return t.numpy().astype(np.uint32)


def test_mulhilo32_exact():
    gen = np.random.default_rng(0)
    a = _u32(gen, 4096).astype(np.int64)
    b = _u32(gen, 4096).astype(np.int64)
    a[:4] = b[:4] = 0xFFFFFFFF
    hi, lo = trng.mulhilo32(_t(a), _t(b))
    full = [int(x) * int(y) for x, y in zip(a, b)]
    assert hi.tolist() == [p >> 32 for p in full]
    assert lo.tolist() == [p & 0xFFFFFFFF for p in full]


@pytest.mark.parametrize("rounds", [7, 10])
def test_philox4x32_matches_jax(rounds):
    gen = np.random.default_rng(rounds)
    c = [_u32(gen, 512) for _ in range(4)]
    k0, k1 = (int(x) for x in _u32(gen, 2))
    want = jrng.philox4x32(*(jnp.asarray(x) for x in c), k0, k1, rounds)
    got = trng.philox4x32(*(_t(x) for x in c), k0, k1, rounds)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), _np(g))


@pytest.mark.parametrize("rounds", [13, 20])
def test_threefry2x32_matches_jax(rounds):
    gen = np.random.default_rng(100 + rounds)
    c0, c1 = _u32(gen, 512), _u32(gen, 512)
    k0, k1 = (int(x) for x in _u32(gen, 2))
    want = jrng.threefry2x32(jnp.asarray(c0), jnp.asarray(c1), k0, k1, rounds)
    got = trng.threefry2x32(_t(c0), _t(c1), k0, k1, rounds)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), _np(g))


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_stream_key_matches_jax(seed):
    for step in (0, 1, 77, 0xFFFFFFFF):
        for tag in (0, 1, 0x100, 0x101):
            want = jrng.threefry_stream_key(seed, jnp.uint32(step), tag)
            got = trng.threefry_stream_key(seed, step, tag)
            assert tuple(int(x) for x in want) == got


@pytest.mark.parametrize("row0", [0, 6, (1 << 29) - 4, (1 << 32) - 2])
def test_quad_counters_carry(row0):
    """Counters whose row * stride crosses 2^32 keep the carry."""
    want = jrng.quad_counters(6, 16, row0=row0, row_stride=16)
    got = trng.quad_counters(6, 16, row0=row0, row_stride=16)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), _np(g))
    if row0 == (1 << 29) - 4:
        assert len(set(_np(got[1]).ravel().tolist())) > 1


@pytest.mark.parametrize("mode", COUNTER_MODES)
@pytest.mark.parametrize("seed", SEEDS[1:])
def test_counter_color_draws_match_jax(mode, seed):
    for step, tag, row0 in ((0, 0, 0), (5, 1, 6), (0xFFFFFFFF, 0x101,
                                                    (1 << 29) - 2)):
        want = jrng.counter_color_draws(mode, seed, 6, 64, step=step,
                                        tag=tag, row0=row0, row_stride=64)
        got = trng.counter_color_draws(mode, seed, 6, 64, step=step,
                                       tag=tag, row0=row0, row_stride=64)
        np.testing.assert_array_equal(np.asarray(want), _np(got))


def test_color_draws_and_threefry_draws_match_jax():
    seed = SEEDS[2]
    np.testing.assert_array_equal(
        np.asarray(jrng.color_draws(seed, 4, 32, step=3, tag=0x100)),
        _np(trng.color_draws(seed, 4, 32, step=3, tag=0x100)))
    np.testing.assert_array_equal(
        np.asarray(jrng.threefry_color_draws(seed, 4, 32, step=3, tag=1,
                                             rounds=13)),
        _np(trng.threefry_color_draws(seed, 4, 32, step=3, tag=1,
                                      rounds=13)))


@pytest.mark.parametrize("mode", ["philox", "philox7", "threefry",
                                  "threefry13", "chacha8"])
def test_draws_match_naive_reference(mode):
    """Known answers from the independent scalar reference."""
    seed, step, tag, ch = SEEDS[3], 9, 1, 32
    got = _np(trng.counter_color_draws(mode, seed, 3, ch, step=step, tag=tag))
    for y in range(3):
        for c in range(ch):
            assert got[y, c] == site_draw(seed, y, c, ch, step, tag, mode=mode)


def test_scalar_generators_match_naive_reference():
    assert trng.philox4x32(1, 2, 3, 4, 5, 6) == philox4x32_ref((1, 2, 3, 4),
                                                               (5, 6))
    assert trng.threefry2x32(1, 2, 3, 4, 13) == threefry2x32_ref(1, 2, 3, 4,
                                                                  13)
    assert trng.chacha_block(1, 2, 3, 4, 5, 6, 8) == chacha_ref(1, 2, 3, 4,
                                                                5, 6, 8)


@pytest.mark.parametrize("mode", ["chacha8", "philox7b", "hw"])
def test_unported_modes_raise(mode):
    """Every mode of the table draws; only names outside it raise."""
    assert trng.counter_color_draws(mode, 1, 2, 64, step=0, tag=0).shape \
        == (2, 64)
    with pytest.raises(ValueError, match="unknown rng mode"):
        trng.counter_color_draws(mode[:-1] + "x", 1, 2, 64, step=0, tag=0)


@pytest.mark.parametrize("rounds", [4, 6, 8])
def test_chacha_block_matches_jax(rounds):
    gen = np.random.default_rng(200 + rounds)
    c0, c1 = _u32(gen, 512), _u32(gen, 512)
    step, tag, k0, k1 = (int(x) for x in _u32(gen, 4))
    want = jrng.chacha_block(jnp.asarray(c0), jnp.asarray(c1), step, tag,
                             k0, k1, rounds)
    got = trng.chacha_block(_t(c0), _t(c1), step, tag, k0, k1, rounds)
    assert len(got) == 16
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), _np(g))


def test_chacha_rounds_must_be_even():
    with pytest.raises(ValueError, match="even"):
        trng.chacha_block(0, 0, 0, 0, 0, 0, 7)


@pytest.mark.parametrize("rounds", [4, 8])
@pytest.mark.parametrize("row0,stride", [(0, None), (6, 128),
                                         ((1 << 29) - 2, 64),
                                         ((1 << 32) - 3, 32)])
def test_chacha_color_draws_match_jax(rounds, row0, stride):
    seed = SEEDS[3]
    want = jrng.chacha_color_draws(seed, 6, 32, step=11, tag=0x101,
                                   row0=row0, row_stride=stride,
                                   rounds=rounds)
    got = trng.chacha_color_draws(seed, 6, 32, step=11, tag=0x101,
                                  row0=row0, row_stride=stride,
                                  rounds=rounds)
    np.testing.assert_array_equal(np.asarray(want), _np(got))
    with pytest.raises(ValueError):
        trng.chacha_color_draws(seed, 2, 24, step=0, tag=0)
    with pytest.raises(ValueError):
        trng.chacha_color_draws(seed, 2, 32, step=0, tag=0, row_stride=40)


def test_hw_draws_are_seeded_streams():
    """hw on the plain-torch backend: reproducible per (seed, tag, step,
    row0), distinct across each, and uniform over 32 bits."""
    def draw(seed=5, step=3, tag=1, row0=0, n=64):
        return trng.hw_draws(seed, n, 256, step=step, tag=tag, row0=row0)

    a = draw()
    assert a.dtype == torch.int64 and a.shape == (64, 256)
    assert torch.equal(a, draw())
    for other in (draw(seed=6), draw(step=4), draw(tag=0), draw(row0=64)):
        assert (other != a).float().mean() > 0.99
    assert int(a.min()) >= 0 and int(a.max()) < (1 << 32)
    mean = float(a.double().mean()) / (1 << 32)
    assert abs(mean - 0.5) < 0.01   # 16384 uniforms: sigma 0.0023
    assert torch.equal(trng.counter_color_draws("hw", 5, 64, 256, step=3,
                                                tag=1), a)


def test_mode_table_matches_jax():
    assert trng.RNG_MODES == jrng.RNG_MODES
    assert (trng.TAG_SWEEP, trng.TAG_INIT) == (jrng.TAG_SWEEP, jrng.TAG_INIT)
