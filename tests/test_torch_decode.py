"""bit1's decode (ops/bit1.py:bit1_decode): what the wrapper refuses, its
plain path on CPU tensors, the launch it makes on a CUDA tensor, and on the
card the kernel csrc/bit1_decode.cu against unpack_bits1, byte for byte.
The kernel source itself runs on the CPU in
tests/test_torch_kernel_emulated.py. This file imports no JAX, so that its
card tests run where JAX is absent (pytest --noconftest -m gpu).
"""

import contextlib

import numpy as np
import pytest
import torch

from ising_tpu_torch import SimConfig
from ising_tpu_torch.driver import Simulation
from ising_tpu_torch.ops import bit1, kernel_lib
from ising_tpu_torch.utils import profiling


def _words(gen, shape, device="cpu"):
    a = gen.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def _planes(shape=(8, 4), seed=5):
    gen = np.random.default_rng(seed)
    return _words(gen, shape), _words(gen, shape)


@pytest.mark.parametrize("bad,exc,match", [
    (lambda b, w: (b.to(torch.int64), w), TypeError, "black must be torch.int32"),
    (lambda b, w: (b, w.to(torch.uint8)), TypeError, "white must be torch.int32"),
    (lambda b, w: (b.t(), w.t()), ValueError, "black must be contiguous"),
    (lambda b, w: (b, torch.cat([w, w], 1)[:, ::2]), ValueError,
     "white must be contiguous"),
    (lambda b, w: (b, w[:4]), ValueError, r"white has shape \(4, 4\)"),
    (lambda b, w: (b.reshape(-1), w.reshape(-1)), ValueError, "an \\(H, W1\\)"),
    (lambda b, w: (b, w.to("meta")), ValueError, "white is on meta"),
    (lambda b, w: (b.to("meta"), w.to("meta")), ValueError, "not meta"),
], ids=["dtype", "dtype-white", "strided", "strided-white", "shapes", "1-D",
        "devices", "device"])
def test_wrapper_refuses(bad, exc, match):
    b, w = bad(*_planes())
    n0 = bit1.bit1_decode.launches
    with pytest.raises(exc, match=match):
        bit1.bit1_decode(b, w)
    assert bit1.bit1_decode.launches == n0


@pytest.mark.parametrize("shape,chunk", [((8, 4), 8192), ((8, 4), 3),
                                         ((1, 1), 8192), ((0, 2), 8192)])
def test_wrapper_on_cpu_returns_unpack_rows(shape, chunk):
    b, w = _planes(shape)
    n0 = bit1.bit1_decode.launches
    got = bit1.bit1_decode(b, w, chunk)
    assert bit1.bit1_decode.launches == n0
    for g, x in zip(got, (b, w)):
        assert g.dtype == torch.uint8 and g.shape == (shape[0], 32 * shape[1])
        assert torch.equal(g, bit1.unpack_rows(x, chunk))
        assert torch.equal(g, bit1.unpack_bits1(x))


def test_backend_decode_goes_through_the_wrapper(monkeypatch):
    """Simulation.bits() and the slab decode take Bit1Backend.decode, which
    is bit1_decode: the path that launches the kernel on the card."""
    calls = []
    wrapped = bit1.bit1_decode

    def spy(black, white, chunk=8192):
        calls.append((black, white, chunk))
        return wrapped(black, white, chunk)

    monkeypatch.setattr(bit1, "bit1_decode", spy)
    sim = Simulation(SimConfig(nrows=16, ncols=128, temp=1.5, backend="bit1",
                               device="cpu"))
    bits = sim.bits()
    assert len(calls) == 1 and calls[0][0] is sim.black
    assert calls[0][1] is sim.white and calls[0][2] == 8192
    for g, x in zip(bits, (sim.black, sim.white)):
        assert torch.equal(g, bit1.unpack_bits1(x))


def test_the_decode_is_a_launch_span():
    b, w = _planes()
    profiling.clear()
    profiling.enable()
    try:
        bit1.bit1_decode(b, w)
    finally:
        profiling.enable(False)
    s, = profiling.spans()
    profiling.clear()
    assert s.name == "launch" and s.device == torch.device("cpu")
    assert s.counts == {"kernel": "bit1_decode", "launches": 0}


class FakeCudaTensor:
    """Stands in for a CUDA tensor: what the wrapper checks and passes."""

    def __init__(self, shape, ptr, dtype=torch.int32, index=0):
        self.shape, self.ptr, self.dtype = shape, ptr, dtype
        self.device = torch.device("cuda", index)

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return self.ptr


class FakeLib:
    def __init__(self, code=0):
        self.code, self.calls, self.current = code, [], []
        self.device = None  # the current device, as torch.cuda.device sets it

    def bit1_decode_launch(self, *args):
        self.calls.append(args)
        self.current.append(self.device)
        return self.code

    def ising_cuda_error_string(self, code):
        return b"fake error"


@pytest.fixture
def fake_card(monkeypatch):
    """A stand-in library, allocator and device context: the wrapper's
    launch without a card (torch.empty on "cuda" hands out
    FakeCudaTensors; the library sees the device torch.cuda.device made
    current)."""
    lib = FakeLib()
    monkeypatch.setattr(kernel_lib, "load", lambda: (lib, None))
    monkeypatch.setattr(bit1, "_cuda_stream", lambda device: 1234)

    @contextlib.contextmanager
    def current(device):
        prev, lib.device = lib.device, torch.device(device)
        try:
            yield
        finally:
            lib.device = prev

    monkeypatch.setattr(torch.cuda, "device", current)
    monkeypatch.setattr(bit1, "unpack_rows",
                        lambda *a: pytest.fail("plain version on a card"))
    real_empty, made = torch.empty, []

    def empty(shape, *, dtype, device):
        if torch.device(device).type != "cuda":
            return real_empty(shape, dtype=dtype, device=device)
        made.append(FakeCudaTensor(shape, (9 + len(made)) << 30, dtype))
        return made[-1]

    monkeypatch.setattr(torch, "empty", empty)
    lib.made = made
    return lib


def test_wrapper_launches_once_for_both_planes(fake_card):
    b, w = FakeCudaTensor((6, 3), 1 << 20), FakeCudaTensor((6, 3), 2 << 20)
    n0 = bit1.bit1_decode.launches
    got = bit1.bit1_decode(b, w)
    assert bit1.bit1_decode.launches == n0 + 1
    assert list(got) == fake_card.made
    assert all(t.shape == (6, 96) and t.dtype == torch.uint8 for t in got)
    assert fake_card.calls == [(1 << 20, 2 << 20, 9 << 30, 10 << 30, 6, 3,
                                1234)]
    assert fake_card.current == [torch.device("cuda", 0)]


def test_wrapper_launches_with_the_planes_device_current(fake_card):
    """A slab's planes on cuda:1 while no device is made current: the
    launch runs with cuda:1 current (CUDA refuses a launch to a stream of
    a device that is not current)."""
    b = FakeCudaTensor((4, 2), 1 << 20, index=1)
    w = FakeCudaTensor((4, 2), 2 << 20, index=1)
    bit1.bit1_decode(b, w)
    assert fake_card.current == [torch.device("cuda", 1)]
    assert fake_card.device is None


def test_wrapper_raises_on_failed_launch(fake_card):
    fake_card.code = 700
    n0 = bit1.bit1_decode.launches
    with pytest.raises(RuntimeError, match="bit1_decode launch: CUDA error 700"):
        bit1.bit1_decode(FakeCudaTensor((2, 1), 1 << 20),
                         FakeCudaTensor((2, 1), 2 << 20))
    assert bit1.bit1_decode.launches == n0


def test_wrapper_makes_no_launch_for_no_rows(fake_card):
    n0 = bit1.bit1_decode.launches
    got = bit1.bit1_decode(FakeCudaTensor((0, 4), 1 << 20),
                           FakeCudaTensor((0, 4), 2 << 20))
    assert [t.shape for t in got] == [(0, 128)] * 2
    assert fake_card.calls == [] and bit1.bit1_decode.launches == n0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (pytest --noconftest -m gpu on the "
                    "card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(64, 256), (8192, 1024), (7, 17), (5, 12),
                                   (1, 1)])
def test_kernel_matches_plain_on_card(shape, cuda_device):
    gen = np.random.default_rng(shape[0] * 7 + shape[1])
    b, w = (_words(gen, shape, cuda_device) for _ in range(2))
    n0 = bit1.bit1_decode.launches
    got = bit1.bit1_decode(b, w)
    torch.cuda.synchronize()
    assert bit1.bit1_decode.launches == n0 + 1
    for g, x in zip(got, (b, w)):
        assert torch.equal(g, bit1.unpack_rows(x))


@pytest.mark.gpu
def test_kernel_on_views_off_the_vector_alignment(cuda_device):
    """Rows of a larger plane, and a plane 4 bytes past a 16-byte boundary
    (one word a thread), decode as their copies do."""
    gen = np.random.default_rng(11)
    big = _words(gen, (64, 1024), cuda_device)
    flat = _words(gen, (1 + 24 * 16,), cuda_device)
    for b, w in ((big[3:40], big[20:57]),
                 (flat[1:].view(24, 16), flat[:-1].view(24, 16))):
        got = bit1.bit1_decode(b, w)
        for g, x in zip(got, (b, w)):
            assert torch.equal(g, bit1.unpack_rows(x.clone()))


@pytest.mark.gpu
def test_one_launch_a_decode_on_the_card(cuda_device):
    sim = Simulation(SimConfig(nrows=64, ncols=256, temp=1.5, backend="bit1",
                               xsl=8, ysl=8, device="cuda"))
    sim.advance(4)
    n0 = bit1.bit1_decode.launches
    m = sim.replica_magnetizations()
    bits = sim.bits()
    assert bit1.bit1_decode.launches == n0 + 2
    for g, x in zip(bits, (sim.black, sim.white)):
        assert torch.equal(g, bit1.unpack_rows(x))
    assert m.shape == (256,)


@pytest.mark.gpu
@pytest.mark.parametrize("xsl", [None, 8])
def test_slabs_on_several_cards_decode_as_one_device(xsl, cuda_device):
    """Row slabs on cuda:0 .. cuda:N-1 (cuda:0 current): bits() and, with
    replicas, replica_magnetizations() decode each slab on its own card,
    equal to one device's."""
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs 2 or more CUDA devices")
    mesh = [torch.device("cuda", k % cards) for k in range(4)]
    cfg = dict(nrows=256, ncols=256, temp=1.5, backend="bit1", xsl=xsl,
               ysl=xsl, device="cuda")
    one = Simulation(SimConfig(**cfg))
    sim = Simulation(SimConfig(ndev=4, **cfg), mesh=mesh)
    one.advance(3)
    sim.advance(3)
    n0 = bit1.bit1_decode.launches
    for a, b in zip(sim.bits(), one.bits()):
        assert torch.equal(a, b)
    assert bit1.bit1_decode.launches == n0 + 4 + 1
    if xsl is not None:
        assert np.array_equal(sim.replica_magnetizations(),
                              one.replica_magnetizations())
        assert bit1.bit1_decode.launches == n0 + 2 * (4 + 1)
