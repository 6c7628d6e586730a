"""The port's bit-plane path of the bit1 sweep against the JAX package.

The plain plane-list, bit-serial compare and 10-class field accept of
ising_tpu_torch/ops/bit1.py are held against the JAX helpers they port
(pallas_packed._draw_plane_list, _philox_draw_block for hw,
pallas_bit1._bitserial_lt_planes, _bitserial_field_flip), and
bit1_sweep_reference against the JAX Pallas bit1 kernel in interpret mode
in the rng modes beyond u32 Philox/Threefry: ChaCha u32, the "...b"
modes and hw, at T > 0, in the greedy quench and with a field, with
counters that carry.
Inputs come from numpy seeds; every compared value is a uint32 bit
pattern, so the tolerance is exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ising_tpu.ops.pallas_dense as jdense
from ising_tpu.ops import pallas_bit1 as jbit1
from ising_tpu.ops import pallas_packed as jpacked
from ising_tpu_torch import interop
from ising_tpu_torch.models import ising as tising
from ising_tpu_torch.ops import bit1 as tbit1
from ising_tpu_torch.rng import MASK, RNG_MODES

NEW_MODES = ["philox7b", "threefry13b", "chacha8", "chacha8b", "chacha6",
             "chacha6b", "chacha4", "chacha4b", "hw"]
PLANE_MODES = [m for m in NEW_MODES if tbit1.accept_bits(m)]
ROW_CARRY = (1 << 29) - 4   # q = row * nq crosses 2^32 within the tile


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


def _np(planes):
    return [p.numpy().astype(np.uint32) for p in planes]


def _params(row0, step):
    return jnp.asarray(np.array([row0, step], np.uint32))


@pytest.mark.parametrize("mode", [m for m in PLANE_MODES if m != "hw"])
@pytest.mark.parametrize("row0", [0, ROW_CARRY])
def test_draw_planes_match_jax_plane_list(mode, row0):
    family, rounds = RNG_MODES[mode][:2]
    H, W1, seed, step, tag = 6, 4, 0xDEADBEEF1234, 77, 1
    k = tbit1.accept_bits(mode)
    want = jpacked._draw_plane_list(family, _params(row0, step), W1, k, H,
                                    seed, tag, blk=jnp.int32(0),
                                    rounds=rounds)
    got = tbit1.draw_planes(mode, seed, H, W1, step=step, tag=tag,
                            row0=row0)
    assert len(got) == len(want) == 16
    for w, g in zip(want, _np(got)):
        np.testing.assert_array_equal(np.asarray(w), g)


@pytest.mark.parametrize("row0", [0, ROW_CARRY])
def test_hw_planes_are_jax_offchip_hw_stream(row0):
    """hw: 24 planes of salted Philox-10, the lanes of the JAX kernel's
    interpret-mode draw block (pallas_bit1.py:387-389)."""
    H, W1, seed, step, tag = 4, 2, 99, 5, 0
    k = tbit1.accept_bits("hw")
    assert k == 24
    block = np.asarray(jpacked._philox_draw_block(
        _params(row0, step), H, k * W1, H, seed, tag | 0x8000,
        blk=jnp.int32(0)))
    got = _np(tbit1.draw_planes("hw", seed, H, W1, step=step, tag=tag,
                                row0=row0))
    for z in range(k):
        np.testing.assert_array_equal(got[z], block[:, z * W1:(z + 1) * W1])


@pytest.mark.parametrize("kbits,temp", [(16, 1.5), (16, 0.0), (24, 2.5),
                                        (16, 40.0)])
def test_bitserial_lt_planes_match_jax(kbits, temp):
    gen = np.random.default_rng(kbits * 100 + int(temp * 10))
    planes = [_words(gen, (3, 5)) for _ in range(kbits)]
    t4k, t8k = tising.bernoulli_kbit_thresholds(temp, kbits)
    want = jbit1._bitserial_lt_planes([jnp.asarray(p) for p in planes], 5,
                                      kbits, t4k, t8k)
    got = tbit1.bitserial_lt_planes(
        [torch.from_numpy(p.astype(np.int64)) for p in planes], t4k, t8k)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy() & MASK)


def test_bitserial_lt_planes_is_the_kbit_compare():
    """Per spin, lt4 / lt8 say v < t4k / t8k for the k-bit v assembled
    LSB-first from the planes; coin is plane 0."""
    gen = np.random.default_rng(3)
    k = 16
    planes = [_words(gen, (1, 1)) for _ in range(k)]
    t4k, t8k = 23456, 40000
    lt4, lt8, coin = tbit1.bitserial_lt_planes(
        [torch.from_numpy(p.astype(np.int64)) for p in planes], t4k, t8k)
    for g in range(32):
        v = sum(((int(p[0, 0]) >> g) & 1) << z for z, p in enumerate(planes))
        assert (int(lt4) >> g) & 1 == (v < t4k)
        assert (int(lt8) >> g) & 1 == (v < t8k)
        assert (int(coin) >> g) & 1 == int(planes[0][0, 0]) >> g & 1


@pytest.mark.parametrize("temp,field,kbits", [
    (1.5, 0.3, 16), (0.0, -0.2, 16), (2.2, -1.0, 24), (0.7, 4.5, 16)])
def test_bitserial_field_flip_matches_jax(temp, field, kbits):
    gen = np.random.default_rng(int(temp * 100) + kbits)
    W1 = 4
    planes = [_words(gen, (2, W1)) for _ in range(kbits)]
    me, up, dn, same, off = (_words(gen, (2, W1)) for _ in range(5))
    tvals10, always10 = tising.field_kbit_thresholds(temp, field, kbits)
    n_j = jbit1._neighbor_adder(*(jnp.asarray(x) for x in (up, dn, same,
                                                           off)))
    want = jbit1._bitserial_field_flip([jnp.asarray(p) for p in planes],
                                       jnp.asarray(me), *n_j, W1, kbits,
                                       tvals10, always10)
    t = [torch.from_numpy(x.astype(np.int64)) for x in (me, up, dn, same,
                                                       off)]
    got = tbit1.bitserial_field_flip(
        [torch.from_numpy(p.astype(np.int64)) for p in planes], t[0],
        *tbit1._neighbor_adder(*t[1:]), tvals10, always10)
    np.testing.assert_array_equal(np.asarray(want), got.numpy() & MASK)


def test_kbit_thresholds_match_jax():
    from ising_tpu.models import ising as jising
    for temp in (0.0, -1.0, 0.5, 1.5, 2.269, 40.0):
        for k in (16, 24):
            assert tising.bernoulli_kbit_thresholds(temp, k) == \
                jising.bernoulli_kbit_thresholds(temp, k)
            for h in (0.0, 0.1, -0.7, 3.0):
                assert tising.field_kbit_thresholds(temp, h, k) == \
                    jising.field_kbit_thresholds(temp, h, k)


def _sweep_both(shape, mode, color, temp, field, row0, seed, monkeypatch):
    """(JAX words, port words, input words) after one half-sweep."""
    Y, X = shape
    W1 = X // 64
    gen = np.random.default_rng(seed)
    dst, src = _words(gen, (Y, W1)), _words(gen, (Y, W1))
    up, dn = _words(gen, (1, W1)), _words(gen, (1, W1))
    thr = tising.threshold_table(temp, field)
    step = int(gen.integers(0, 1 << 32))
    acc = tbit1.plane_accept_args(mode, temp, field)
    jkw = dict(acc, kbits=tbit1.accept_bits(mode) or 24)
    monkeypatch.setattr(jdense, "_pick_block_rows",
                        lambda nrows, target=256: 8 if nrows % 8 == 0 else nrows)
    want = jbit1.bit1_sweep(
        jnp.asarray(dst), jnp.asarray(src), jnp.asarray(up), jnp.asarray(dn),
        jnp.asarray(thr), jnp.uint32(row0), jnp.uint32(step), color=color,
        seed=seed, rng_mode=mode, interpret=True, greedy=temp <= 0, grows=0,
        **jkw)
    d, s = interop.from_numpy_words(dst, src, device="cpu")
    u, n = interop.from_numpy_words(up, dn, device="cpu")
    got = tbit1.bit1_sweep_reference(d, s, u, n, thr, row0, step,
                                     color=color, seed=seed, rng_mode=mode,
                                     greedy=temp <= 0, **acc)
    return np.asarray(want), interop.to_numpy_words(got, got)[0], dst


# Each new mode at T > 0 and in the greedy quench, and each bit-plane mode
# with a field, colors and row offsets alternating.
SWEEP_CASES = (
    [(m, (i + g) % 2, 0.0 if g else 1.7, 0.0, ROW_CARRY if i % 2 else 0)
     for i, m in enumerate(NEW_MODES) for g in (0, 1)]
    + [(m, i % 2, (1.7, 0.0)[i % 2], (0.3, -0.2)[i % 2],
        0 if i % 2 else ROW_CARRY) for i, m in enumerate(PLANE_MODES)])


@pytest.mark.parametrize("mode,color,temp,field,row0", SWEEP_CASES)
def test_reference_matches_pallas_new_modes(mode, color, temp, field, row0,
                                            monkeypatch):
    seed = 93000 + SWEEP_CASES.index((mode, color, temp, field, row0))
    want, got, before = _sweep_both((16, 128), mode, color, temp, field,
                                    row0, seed, monkeypatch)
    np.testing.assert_array_equal(got, want)
    assert (got != before).any()


def test_sweep_cases_cover_modes_accepts_and_colors():
    assert {c[0] for c in SWEEP_CASES} == set(NEW_MODES)
    assert {c[0] for c in SWEEP_CASES if c[3]} == set(PLANE_MODES)
    assert len(PLANE_MODES) == 6
    for mode in NEW_MODES:
        assert {(c[2] <= 0) for c in SWEEP_CASES if c[0] == mode} == {True,
                                                                   False}
    assert {c[1] for c in SWEEP_CASES} == {0, 1}


@pytest.mark.parametrize("mode,row0", [("chacha6b", 0), ("hw", 64),
                                       ("chacha8", ROW_CARRY)])
def test_reference_matches_pallas_full_width(mode, row0, monkeypatch):
    """The bench width, 16384 (W1 = 256), where the draw blocks span many
    lanes per plane."""
    want, got, _ = _sweep_both((8, 16384), mode, 1, 1.5, 0.0, row0, 94000,
                               monkeypatch)
    np.testing.assert_array_equal(got, want)


def test_wrapper_refuses_field_in_u32_mode():
    d, s = interop.from_numpy_words(*(_words(np.random.default_rng(1), (8, 2))
                                      for _ in range(2)), device="cpu")
    tvals10, always10 = tising.field_kbit_thresholds(1.5, 0.2, 16)
    with pytest.raises(ValueError, match="bit-plane rng mode or hw"):
        tbit1.bit1_sweep(d, s, s[-1:], s[:1], tising.threshold_table(1.5),
                         0, 0, color=0, seed=1, rng_mode="chacha8",
                         greedy=False, tvals10=tvals10, always10=always10)


def test_accept_bits_and_args():
    assert {m: tbit1.accept_bits(m) for m in RNG_MODES} == {
        m: (24 if m == "hw" else (16 if m.endswith("b") else 0))
        for m in RNG_MODES}
    assert tbit1.plane_accept_args("philox", 1.5) == {}
    assert tbit1.plane_accept_args("chacha6b", 1.5) == dict(zip(
        ("t4k", "t8k"), tising.bernoulli_kbit_thresholds(1.5, 16)))
    assert set(tbit1.plane_accept_args("hw", 1.5, 0.1)) == {"tvals10",
                                                            "always10"}


@pytest.mark.parametrize("mode", sorted(RNG_MODES))
def test_backend_accept_attributes_match_jax(mode):
    """Bit1Backend keeps the JAX backend's accept interface (kplanes,
    accept_bits, temp_static, temperature, field, greedy), before and
    after a new temperature and field."""
    from ising_tpu import SimConfig as JaxConfig
    from ising_tpu_torch.config import SimConfig
    field = 0.2 if tbit1.accept_bits(mode) else 0.0
    kw = dict(nrows=8, ncols=128, temp=1.5, field=field, rng=mode)
    jbe = jbit1.Bit1Backend(JaxConfig(backend="bit1", **kw))
    tbe = tbit1.Bit1Backend(SimConfig(backend="bit1", device="cpu", **kw))
    names = ("kplanes", "accept_bits", "temp_static", "temperature", "field",
             "greedy")
    assert {n: getattr(tbe, n) for n in names} == \
        {n: getattr(jbe, n) for n in names}
    assert tbe.accept == tbit1.plane_accept_args(mode, 1.5, field)
    tbe.retune(-1.0, field / 2)
    assert (tbe.temperature, tbe.field, tbe.greedy) == (-1.0, field / 2, True)
    assert tbe.accept == tbit1.plane_accept_args(mode, -1.0, field / 2)
