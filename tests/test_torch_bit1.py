"""The port's bit1 half-sweep against the JAX package's Pallas kernel.

bit1_sweep_reference (the plain torch version of the CUDA kernels) is held
bit for bit against ising_tpu.ops.pallas_bit1.bit1_sweep run in interpret
mode, with multi-block row tiling forced on the JAX side, in the u32
Philox and Threefry modes, both colors, T > 0 and the greedy quench (the
other modes: tests/test_torch_planes.py). Inputs come from numpy seeds;
outputs are uint32 bit patterns, compared exactly.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ising_tpu.ops.pallas_dense as jdense
from ising_tpu.models import ising as jising
from ising_tpu.ops import pallas_bit1 as jbit1
from ising_tpu_torch import interop
from ising_tpu_torch.models import ising as tising
from ising_tpu_torch.ops import bit1 as tbit1
from ising_tpu_torch.rng import PORTED_MODES, RNG_MODES

MODES = ["philox", "philox7", "threefry", "threefry13"]


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


def _sweep_both(shape, mode, color, greedy, row0, seed, monkeypatch):
    """(JAX words, port words) after one half-sweep of the same inputs."""
    Y, X = shape
    W1 = X // 64
    gen = np.random.default_rng(seed)
    dst, src = _words(gen, (Y, W1)), _words(gen, (Y, W1))
    up, dn = _words(gen, (1, W1)), _words(gen, (1, W1))
    thr = tising.threshold_table(0.0 if greedy else 1.7)
    step = int(gen.integers(0, 1 << 32))
    monkeypatch.setattr(jdense, "_pick_block_rows",
                        lambda nrows, target=256: 8 if nrows % 8 == 0 else nrows)
    want = jbit1.bit1_sweep(
        jnp.asarray(dst), jnp.asarray(src), jnp.asarray(up), jnp.asarray(dn),
        jnp.asarray(thr), jnp.uint32(row0), jnp.uint32(step), color=color,
        seed=seed, rng_mode=mode, interpret=True, greedy=greedy, grows=0)
    d, s = interop.from_numpy_words(dst, src, device="cpu")
    u, n = interop.from_numpy_words(up, dn, device="cpu")
    got = tbit1.bit1_sweep_reference(d, s, u, n, thr, row0, step, color=color,
                                     seed=seed, rng_mode=mode, greedy=greedy)
    assert torch.equal(d, interop.from_numpy_words(dst, dst, "cpu")[0])
    return np.asarray(want), interop.to_numpy_words(got, got)[0], dst


@pytest.mark.parametrize("mode,color,greedy", list(itertools.product(
    MODES, (0, 1), (False, True))))
def test_reference_matches_pallas_all_modes(mode, color, greedy, monkeypatch):
    seed = 91000 + 4 * MODES.index(mode) + 2 * color + greedy
    want, got, before = _sweep_both((16, 128), mode, color, greedy, 0, seed,
                                    monkeypatch)
    np.testing.assert_array_equal(got, want)
    assert (got != before).any()


# Other shapes: each case a different (mode, color, greedy, row0), so that
# together they cover every mode, both colors, both accepts, and global row
# offsets whose 64-bit counters carry into the high word.
SHAPE_CASES = [
    ((8, 64), "philox", 0, False, (1 << 29) - 4),
    ((8, 64), "threefry13", 1, True, (1 << 29) - 4),
    ((8, 64), "philox7", 1, False, 0),
    ((8, 64), "threefry", 0, True, 2),
    ((64, 256), "threefry13", 0, False, 64),
    ((64, 256), "philox7", 1, True, 0),
    ((64, 256), "philox", 0, True, (1 << 27) - 32),
    ((64, 256), "threefry", 1, False, 0),
    ((32, 16384), "threefry13", 1, False, 0),
    ((32, 16384), "philox", 0, False, 0),
    ((32, 16384), "philox7", 0, True, 32),
    ((32, 16384), "threefry", 1, True, 1 << 20),
]


@pytest.mark.parametrize("shape,mode,color,greedy,row0", SHAPE_CASES)
def test_reference_matches_pallas_shapes(shape, mode, color, greedy, row0,
                                         monkeypatch):
    seed = 92000 + SHAPE_CASES.index((shape, mode, color, greedy, row0))
    want, got, _ = _sweep_both(shape, mode, color, greedy, row0, seed,
                               monkeypatch)
    np.testing.assert_array_equal(got, want)


def _bits_to_word(bits):
    return sum(int(b) << k for k, b in enumerate(bits))


def test_adder_and_class_masks_exhaustive():
    """All 32 combinations of (me, up, dn, same, off), one per bit, against
    the JAX helpers and against the count arithmetic itself."""
    combos = list(itertools.product((0, 1), repeat=5))
    planes = [_bits_to_word(c[i] for c in combos) for i in range(5)]
    t = torch.tensor(planes, dtype=torch.int64)
    j = [jnp.uint32(p) for p in planes]
    n_t = tbit1._neighbor_adder(*t[1:])
    n_j = jbit1._neighbor_adder(*j[1:])
    m_t = tbit1._neighbor_class_masks(*t)
    m_j = jbit1._neighbor_class_masks(*j)
    for a, b in zip(n_t + m_t, n_j + m_j):
        assert int(a) & 0xFFFFFFFF == int(b)
    n0, n1, n2 = (int(x) for x in n_t)
    ge3, ge4, eq2 = (int(x) & 0xFFFFFFFF for x in m_t)
    for k, (me, up, dn, same, off) in enumerate(combos):
        n = up + dn + same + off
        assert ((n2 >> k) & 1) * 4 + ((n1 >> k) & 1) * 2 + ((n0 >> k) & 1) == n
        e = n if me else 4 - n
        assert (ge3 >> k) & 1 == (e >= 3)
        assert (ge4 >> k) & 1 == (e >= 4)
        assert (eq2 >> k) & 1 == (e == 2)


def test_threshold_table_matches_jax():
    for temp in (0.0, -1.0, 0.5, 1.5, 2.269, 10.0):
        np.testing.assert_array_equal(tising.threshold_table(temp),
                                      jising.threshold_table(temp))
        np.testing.assert_array_equal(tising.acceptance_probabilities(temp),
                                      jising.acceptance_probabilities(temp))
    assert tising.onsager_energy(1.5) == jising.onsager_energy(1.5)
    assert tising.onsager_magnetization(2.0) == jising.onsager_magnetization(2.0)


def _state(H=8, W1=2, seed=3):
    gen = np.random.default_rng(seed)
    d, s = interop.from_numpy_words(_words(gen, (H, W1)), _words(gen, (H, W1)),
                                    device="cpu")
    return d, s


def test_wrapper_on_cpu_runs_plain_version_in_place():
    d, s = _state()
    thr = tising.threshold_table(1.5)
    kw = dict(color=1, seed=5, rng_mode="threefry13", greedy=False)
    want = tbit1.bit1_sweep_reference(d, s, s[-1:], s[:1], thr, 0, 3, **kw)
    before = tbit1.bit1_sweep.launches
    out = tbit1.bit1_sweep(d, s, s[-1:], s[:1], thr, 0, 3, **kw)
    assert out is d and torch.equal(d, want)
    assert tbit1.bit1_sweep.launches == before  # CPU runs launch nothing


@pytest.mark.parametrize("bad,exc", [
    (lambda d, s: (d.to(torch.int64), s), TypeError),
    (lambda d, s: (d, s[:4]), ValueError),
    (lambda d, s: (d.t(), s.t()), ValueError),
])
def test_wrapper_checks_inputs(bad, exc):
    d, s = bad(*_state(H=8, W1=8))
    with pytest.raises(exc):
        tbit1.bit1_sweep(d, s, s[-1:], s[:1], tising.threshold_table(1.0), 0,
                         0, color=0, seed=1, rng_mode="philox", greedy=False)


def test_wrapper_refuses_unported_modes():
    """Every mode of the table runs; a name outside it is refused."""
    d, s = _state()
    with pytest.raises(ValueError, match="unknown rng mode"):
        tbit1.bit1_sweep(d, s, s[-1:], s[:1], tising.threshold_table(1.0), 0,
                         0, color=0, seed=1, rng_mode="chacha2", greedy=False)
    assert set(PORTED_MODES) == set(RNG_MODES)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py, or "
                    "pytest -m gpu on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", PORTED_MODES)
def test_kernel_matches_plain_on_card(mode, cuda_device):
    gen = np.random.default_rng(17)
    fields = (0.0, 0.3) if tbit1.accept_bits(mode) else (0.0,)
    for greedy, field in ((g, h) for g in (False, True) for h in fields):
        d, s = interop.from_numpy_words(_words(gen, (64, 256)),
                                        _words(gen, (64, 256)), cuda_device)
        temp = 0.0 if greedy else 1.5
        thr = tising.threshold_table(temp, field)
        for color in (0, 1):
            kw = dict(color=color, seed=7, rng_mode=mode, greedy=greedy,
                      **tbit1.plane_accept_args(mode, temp, field))
            want = tbit1.bit1_sweep_reference(d, s, s[-1:], s[:1], thr, 2, 1,
                                              **kw)
            tbit1.bit1_sweep(d, s, s[-1:], s[:1], thr, 2, 1, **kw)
            torch.cuda.synchronize()
            assert torch.equal(d, want)
