"""The port's packed tier against the JAX package's: storage, up counts,
and the plain half-sweep against the Pallas kernel in interpret mode.

pack_bits / unpack_bits / pack_jplanes, the masked popcount, and
packed_sweep_reference (the plain torch version of csrc/packed_sweep.cu)
held bit for bit against ising_tpu.ops.pallas_packed.packed_sweep, with
8-row blocks forced on the JAX side, in philox, threefry13, chacha8 and
hw, at T > 0, in the greedy quench and with the full field table, on
words with every bit random (bit 31 included). The J word and the
replica wraps are in tests/test_torch_packed_paths.py. Every compared
value is an integer or a bit pattern: exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ising_tpu.ops.pallas_dense as jdense
from ising_tpu import observables as jobs
from ising_tpu.ops import pallas_packed as jpacked
from ising_tpu_torch import SimConfig, interop, observables
from ising_tpu_torch.models import ising
from ising_tpu_torch.ops import packed


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's plain-torch sweeps run single-threaded here: the suite
    runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _words(gen, shape):
    return gen.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return interop.from_numpy_words(a, a, device="cpu")[0]


def _np(t):
    return interop.to_numpy_words(t, t)[0]


def eight_row_blocks(monkeypatch):
    """8-row blocks in the JAX Pallas kernels: several blocks per plane."""
    monkeypatch.setattr(jdense, "_pick_block_rows",
                        lambda nrows, target=256:
                        8 if nrows % 8 == 0 else nrows)


def sweep_both(shape, mode, color, temp, field, row0, seed, monkeypatch,
               jword=False, csl=None, ysl=None):
    """(JAX words, port words, dst before) after one half-sweep of the same
    random words, with 8-row blocks on the JAX side."""
    H, W = shape
    gen = np.random.default_rng(seed)
    dst, src = _words(gen, (H, W)), _words(gen, (H, W))
    up, dn = _words(gen, (1, W)), _words(gen, (1, W))
    jw = _words(gen, (H, W)) if jword else None
    thr = ising.threshold_table(temp, field)
    step = int(gen.integers(0, 1 << 32))
    eight_row_blocks(monkeypatch)
    kw = dict(color=color, seed=seed, rng_mode=mode, greedy=temp <= 0,
              full_table=field != 0, csl=csl, ysl=ysl)
    want = jpacked.packed_sweep(
        jnp.asarray(dst), jnp.asarray(src), jnp.asarray(up), jnp.asarray(dn),
        jnp.asarray(thr), jnp.uint32(row0), jnp.uint32(step),
        None if jw is None else jnp.asarray(jw), interpret=True, **kw)
    d = _t(dst)
    got = packed.packed_sweep_reference(
        d, _t(src), _t(up), _t(dn), thr, row0, step,
        None if jw is None else _t(jw), **kw)
    assert (_np(d) == dst).all()
    return np.asarray(want), _np(got), dst


# (shape (H, W), mode, color, temp, field, row0): T > 0, the greedy quench,
# the full table; a row offset whose counters carry into the high word.
SWEEP_CASES = [
    ((16, 8), "philox", 0, 1.7, 0.0, 0),
    ((16, 8), "threefry13", 1, 0.0, 0.0, (1 << 29) - 4),
    ((32, 16), "chacha8", 0, 1.5, 0.3, 6),
    ((16, 8), "hw", 1, 1.5, 0.0, (1 << 32) - 8),
]


@pytest.mark.parametrize("case", SWEEP_CASES,
                         ids=[f"{c[1]}-T{c[3]}-h{c[4]}" for c in SWEEP_CASES])
def test_reference_matches_pallas(case, monkeypatch):
    shape, mode, color, temp, field, row0 = case
    want, got, before = sweep_both(shape, mode, color, temp, field, row0,
                                   8100 + SWEEP_CASES.index(case),
                                   monkeypatch)
    np.testing.assert_array_equal(got, want)
    assert (got != before).any()


def test_sweep_cases_cover_the_accepts():
    assert {c[1] for c in SWEEP_CASES} == {"philox", "threefry13",
                                           "chacha8", "hw"}
    assert {(c[3] <= 0, c[4] != 0) for c in SWEEP_CASES} == {
        (False, False), (True, False), (False, True)}
    assert {c[2] for c in SWEEP_CASES} == {0, 1}


@pytest.mark.parametrize("Y,C", [(4, 8), (6, 64), (3, 128)])
def test_pack_unpack_match_jax(Y, C):
    gen = np.random.default_rng(Y * C)
    bits = gen.integers(0, 2, (Y, C), dtype=np.uint8)
    want = np.asarray(jpacked.pack_bits(jnp.asarray(bits)))
    got = packed.pack_bits(torch.from_numpy(bits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(packed.unpack_bits(got).numpy(), bits)
    words = _words(gen, (Y, C // 8))
    np.testing.assert_array_equal(
        packed.unpack_bits(_t(words)).numpy(),
        np.asarray(jpacked.unpack_bits(jnp.asarray(words))))


def test_pack_jplanes_matches_jax():
    """The four flags in bits 0..3 of each field: field 7's off flag is
    bit 31."""
    gen = np.random.default_rng(3)
    planes = [gen.integers(0, 2, (6, 64), dtype=np.uint8) for _ in range(4)]
    planes[3][:, 56:] = 1
    want = np.asarray(jpacked.pack_jplanes([jnp.asarray(p) for p in planes]))
    got = packed.pack_jplanes([torch.from_numpy(p) for p in planes])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), want)
    assert (want >> 31).all()


def test_decode_crosses_chunk_boundary():
    gen = np.random.default_rng(12)
    b, w = (_words(gen, (10, 3)) for _ in range(2))
    be = packed.PackedBackend(SimConfig(backend="packed", ncols=48,
                                        device="cpu"))
    want = [np.asarray(jpacked.unpack_bits(jnp.asarray(x))) for x in (b, w)]
    for chunk in (4, 10, 8192):
        for a, x in zip(be.decode(_t(b), _t(w), chunk=chunk), want):
            assert a.dtype == torch.uint8 and a.shape == (10, 24)
            np.testing.assert_array_equal(a.numpy(), x)


def test_unpack_keeps_to_one_int32_plane(monkeypatch):
    """unpack_bits shifts the int32 words a field at a time: no int64 (or
    (Y, 8, W)) transient is made."""
    seen = []
    real = torch.Tensor.__rshift__

    def spy(self, other):
        out = real(self, other)
        seen.append((out.dtype, tuple(out.shape)))
        return out
    monkeypatch.setattr(torch.Tensor, "__rshift__", spy)
    out = packed.unpack_bits(_t(_words(np.random.default_rng(1), (5, 2))))
    assert out.shape == (5, 16) and out.dtype == torch.uint8
    assert set(seen) == {(torch.int32, (5, 2))} and len(seen) == 8


@pytest.mark.parametrize("mask", [0x11111111, 0xFFFFFFFF, 0x0F0F0F0F])
def test_row_up_counts_match_jax(mask):
    gen = np.random.default_rng(mask & 0xFF)
    b, w = (_words(gen, (7, 5)) for _ in range(2))
    want = np.asarray(jobs.word_row_up_counts(jnp.asarray(b), jnp.asarray(w),
                                              field_mask=mask))
    got = observables.word_row_up_counts(_t(b), _t(w), field_mask=mask,
                                         row_chunk=3)
    np.testing.assert_array_equal(got.numpy(), want)
    if mask == 0x11111111:
        np.testing.assert_array_equal(
            observables.packed_row_up_counts(_t(b), _t(w),
                                             row_chunk=3).numpy(),
            np.asarray(jobs.packed_row_up_counts(jnp.asarray(b),
                                                 jnp.asarray(w))))


def test_wrapper_runs_the_plain_version_on_cpu():
    gen = np.random.default_rng(4)
    H, W = 8, 6
    dst, src = _words(gen, (H, W)), _words(gen, (H, W))
    thr = ising.threshold_table(1.5)
    kw = dict(color=1, seed=5, rng_mode="threefry", greedy=False)
    s = _t(src)
    want = packed.packed_sweep_reference(_t(dst), s, s[-1:], s[:1], thr, 0,
                                         3, **kw)
    d = _t(dst)
    packed.packed_sweep.launches = 0
    assert packed.packed_sweep(d, s, s[-1:].clone(), s[:1].clone(), thr, 0,
                               3, **kw) is d
    assert torch.equal(d, want) and packed.packed_sweep.launches == 0


@pytest.mark.parametrize("bad,msg", [
    (dict(color=2), "color must be 0 or 1"),
    (dict(rng_mode="chacha6b"), "bit-plane mode"),
    (dict(csl=4), r"csl \(4\) must divide W \(6\)"),
    (dict(ysl=3), r"ysl \(3\) must divide H \(8\)"),
    (dict(src_dn=torch.zeros((1, 5), dtype=torch.int32)), "src_dn has shape"),
    (dict(dst=torch.zeros((8, 6), dtype=torch.int64)), "torch.int32"),
    (dict(rng_mode="chacha8", shape=(8, 3)), "even W"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, msg):
    H, W = bad.pop("shape", (8, 6))
    src = torch.zeros((H, W), dtype=torch.int32)
    args = dict(dst=torch.zeros((H, W), dtype=torch.int32), src=src,
                src_up=src[-1:].clone(), src_dn=src[:1].clone())
    kw = dict(color=0, seed=1, rng_mode="philox")
    for k in list(bad):
        (args if k in args else kw)[k] = bad.pop(k)
    with pytest.raises((ValueError, TypeError), match=msg):
        packed.packed_sweep(args["dst"], args["src"], args["src_up"],
                            args["src_dn"], ising.threshold_table(1.5), 0, 0,
                            **kw)


class _CudaWords:
    """A word plane that the wrapper takes for a CUDA tensor (no card
    here): enough to reach the checks made before a launch."""

    def __init__(self, buf, offset, shape):
        self.buf, self.offset, self.shape = buf, offset, shape
        self.device = torch.device("cuda", 0)
        self.dtype = torch.int32

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return self.buf.ctypes.data + 4 * self.offset

    def numel(self):
        return self.shape[0] * self.shape[1]

    def element_size(self):
        return 4


def test_wrapper_refuses_overlap_before_a_launch(monkeypatch):
    """dst is updated in place: a dst that overlaps src or the J word is
    refused before the kernel library is even loaded."""
    monkeypatch.setattr(packed.kernel_lib, "load",
                        lambda: pytest.fail("the kernel library was loaded"))
    buf = np.zeros(64, np.uint32)
    dst = _CudaWords(buf, 0, (4, 4))
    up, dn = _CudaWords(buf, 48, (1, 4)), _CudaWords(buf, 52, (1, 4))
    for src, jw in ((_CudaWords(buf, 8, (4, 4)), None),
                    (_CudaWords(buf, 16, (4, 4)),
                     _CudaWords(buf, 12, (4, 4)))):
        with pytest.raises(ValueError, match="must not overlap"):
            packed.packed_sweep(dst, src, up, dn, ising.threshold_table(1.5),
                                0, 0, jw, color=0, seed=1, rng_mode="philox")


class _FakeLib:
    """Records packed_sweep_launch's arguments; returns `code`."""

    def __init__(self, code=0):
        self.code, self.calls = code, []

    def packed_sweep_launch(self, *args):
        self.calls.append(args)
        return self.code

    def ising_cuda_error_string(self, code):
        return b"fake error"


@pytest.mark.parametrize("mode,family,rounds,tag", [
    ("philox", 0, 10, 1), ("philox7", 0, 7, 1), ("threefry13", 1, 13, 1),
    ("chacha4", 2, 4, 1), ("hw", 0, 10, 0x8001)])
@pytest.mark.parametrize("temp,field,accept", [(1.5, 0.0, 0), (0.0, 0.0, 1),
                                               (0.0, 0.3, 2)])
def test_wrapper_launches_kernel_on_cuda_tensor(monkeypatch, mode, family,
                                                rounds, tag, temp, field,
                                                accept):
    """On a CUDA tensor the wrapper launches (never the plain version) with
    the kernel's arguments: hw as salted Philox-10, Threefry's stream key,
    the accept variant (the field's table wins over greedy), the 10
    thresholds, the J word and the replica sizes; then counts the launch."""
    from ising_tpu_torch.rng import threefry_stream_key
    monkeypatch.setattr(packed, "packed_sweep_reference", lambda *a, **k:
                        pytest.fail("plain version called on a CUDA tensor"))
    monkeypatch.setattr(packed, "_cuda_stream", lambda device: 1234)
    lib = _FakeLib()
    monkeypatch.setattr(packed.kernel_lib, "load", lambda: (lib, None))
    buf = np.zeros(256, np.uint32)
    dst, src, jw = (_CudaWords(buf, o, (8, 4)) for o in (0, 32, 64))
    up, dn = _CudaWords(buf, 96, (1, 4)), _CudaWords(buf, 100, (1, 4))
    thr = ising.threshold_table(temp, field)
    before = packed.packed_sweep.launches
    assert packed.packed_sweep(dst, src, up, dn, thr, 6, 9, jw, color=1,
                               seed=5, rng_mode=mode, greedy=temp <= 0,
                               full_table=field != 0, csl=2, ysl=4) is dst
    assert packed.packed_sweep.launches == before + 1
    (args,) = lib.calls
    assert args[:4] == tuple(t.data_ptr() for t in (dst, src, up, dn))
    assert args[4:10] == (8, 4, 6, 9, tag, 1)
    assert list(args[10]) == [int(t) for t in thr]
    assert args[11:13] == (threefry_stream_key(5, 9, tag) if family == 1
                           else (5, 0))
    assert args[13:] == (family, rounds, accept, jw.data_ptr(), 2, 4, 1234)


def test_wrapper_raises_on_failed_launch(monkeypatch):
    lib = _FakeLib(code=700)
    monkeypatch.setattr(packed.kernel_lib, "load", lambda: (lib, None))
    monkeypatch.setattr(packed, "_cuda_stream", lambda device: 0)
    buf = np.zeros(128, np.uint32)
    dst, src = _CudaWords(buf, 0, (4, 4)), _CudaWords(buf, 16, (4, 4))
    up, dn = _CudaWords(buf, 32, (1, 4)), _CudaWords(buf, 36, (1, 4))
    before = packed.packed_sweep.launches
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        packed.packed_sweep(dst, src, up, dn, ising.threshold_table(1.0), 0,
                            0, color=0, seed=1, rng_mode="philox")
    assert packed.packed_sweep.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py, or "
                    "pytest -m gpu on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["philox", "philox7", "threefry",
                                  "threefry13", "chacha8", "chacha6",
                                  "chacha4", "hw"])
def test_kernel_matches_plain_on_card(mode, cuda_device):
    """csrc/packed_sweep.cu against its plain version on the card, in
    every accept and on the J-word and replica paths."""
    gen = np.random.default_rng(18)
    accepts = [(1.5, 0.0), (0.0, 0.0)] + ([] if mode == "hw" else
                                          [(1.5, 0.3)])
    for (temp, field), (jword, csl, ysl) in (
            (a, g) for a in accepts
            for g in ((False, None, None), (True, None, None),
                      (True, 11, 8))):
        d, s, j = (_t(_words(gen, (64, 66))).to(cuda_device)
                   for _ in range(3))
        jw = j if jword else None
        thr = ising.threshold_table(temp, field)
        for color in (0, 1):
            kw = dict(color=color, seed=7, rng_mode=mode, greedy=temp <= 0,
                      full_table=field != 0, csl=csl, ysl=ysl)
            want = packed.packed_sweep_reference(d, s, s[-1:], s[:1], thr, 2,
                                                 1, jw, **kw)
            packed.packed_sweep(d, s, s[-1:], s[:1], thr, 2, 1, jw, **kw)
            torch.cuda.synchronize()
            assert torch.equal(d, want)
