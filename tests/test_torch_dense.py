"""The port's dense tier against the JAX package's: the plain half-sweep
against the Pallas kernel in interpret mode, whole Simulation trajectories,
the wrapper, the backend's fences and the CLI.

dense_sweep_reference (the plain torch version of csrc/dense_sweep.cu) is
held bit for bit against ising_tpu.ops.pallas_dense.dense_sweep with 8-row
blocks forced on the JAX side, in every u32 rng mode and hw, at T > 0, in
the greedy quench and with the field's full table (u32 modes), with and
without the four J planes, both colors, and a row offset whose counters
carry into the high word. Every compared value is a bit or an integer:
exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ising_tpu.ops.pallas_dense as jdense
from ising_tpu import SimConfig as JaxConfig
from ising_tpu import cli as jcli
from ising_tpu.driver import Simulation as JaxSimulation
from ising_tpu_torch import SimConfig, cli
from ising_tpu_torch.driver import Simulation
from ising_tpu_torch.models import ising
from ising_tpu_torch.ops import dense
from ising_tpu_torch.rng import PORTED_MODES, plane_bits, threefry_stream_key

U32_MODES = [m for m in PORTED_MODES if not plane_bits(m)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's plain-torch sweeps run single-threaded here: the suite
    runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def eight_row_blocks(monkeypatch):
    """8-row blocks in the JAX dense kernel: several blocks per plane."""
    monkeypatch.setattr(jdense, "_pick_block_rows",
                        lambda nrows, target=256:
                        8 if nrows % 8 == 0 else nrows)


def _bits(gen, shape):
    return gen.integers(0, 2, shape, dtype=np.uint8)


def _accepts(mode):
    """(temperature, field, J planes): T > 0 with J planes, the greedy
    quench, and the full table of the field (not hw, whose config
    refuses a field on dense)."""
    return [(1.5, 0.0, True), (0.0, 0.0, False)] + (
        [] if mode == "hw" else [(1.5, 0.3, False)])


@pytest.mark.parametrize("mode", U32_MODES)
def test_reference_matches_pallas(mode, monkeypatch):
    eight_row_blocks(monkeypatch)
    H, C = 16, 64
    gen = np.random.default_rng(U32_MODES.index(mode))
    for i, (temp, field, jp) in enumerate(_accepts(mode)):
        thr = ising.threshold_table(temp, field)
        for color in (0, 1):
            dst, src = _bits(gen, (H, C)), _bits(gen, (H, C))
            up, dn = _bits(gen, (1, C)), _bits(gen, (1, C))
            jplanes = [_bits(gen, (H, C)) for _ in range(4)] if jp else None
            row0 = ((1 << 32) - 8) if i == 1 else (1 << 27) + 16 * color
            step = int(gen.integers(0, 1 << 32))
            want = jdense.dense_sweep(
                jnp.asarray(dst), jnp.asarray(src), jnp.asarray(up),
                jnp.asarray(dn), jnp.asarray(thr), jnp.uint32(row0),
                jnp.uint32(step),
                None if jplanes is None else tuple(map(jnp.asarray, jplanes)),
                color=color, seed=1234 + i, rng_mode=mode, interpret=True)
            t = lambda a: torch.from_numpy(a.copy())
            got = dense.dense_sweep_reference(
                t(dst), t(src), t(up), t(dn), thr, row0, step,
                None if jplanes is None else [t(p) for p in jplanes],
                color=color, seed=1234 + i, rng_mode=mode)
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(want),
                err_msg=f"{mode} T={temp} h={field} J={jp} color={color}")


def test_sweep_cases_cover_the_accepts():
    assert set(U32_MODES) == {"philox", "philox7", "threefry", "threefry13",
                              "chacha8", "chacha6", "chacha4", "hw"}
    acc = {a for m in U32_MODES for a in _accepts(m)}
    assert {a[0] <= 0 for a in acc} == {True, False}
    assert any(a[1] for a in acc) and any(a[2] for a in acc)


TRAJECTORIES = [
    dict(rng="threefry13", temp=1.5, j_prob=0.3, j_seed=5),
    dict(rng="chacha8", temp=0.0),
    dict(rng="philox", temp=1.5, field=0.3),
    dict(rng="hw", temp=1.5),
    dict(rng="philox7", temp=0.0, j_prob=0.5),
]


@pytest.mark.parametrize("kw", TRAJECTORIES,
                         ids=[k["rng"] for k in TRAJECTORIES])
def test_simulation_matches_jax_dense(kw, monkeypatch):
    """Whole trajectories: the JAX dense backend (8-row blocks, interpret
    mode) and the port's Simulation on the CPU give the same lattice,
    up counts and energy after 3 steps."""
    eight_row_blocks(monkeypatch)
    cfg = dict(nrows=16, ncols=128, seed=21, **kw)
    jsim = JaxSimulation(JaxConfig(backend="dense", **cfg))
    tsim = Simulation(SimConfig(backend="dense", device="cpu", **cfg))
    jsim.advance(3)
    tsim.advance(3)
    for a, b in zip(tsim.bits(), jsim.bits()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tsim.measure() == jsim.measure()
    assert tsim.energy_total() == jsim.energy_total()


def test_dense_equals_xla_and_packed():
    """In a counter mode dense's trajectory is xla's and packed's (the same
    draws and accept), with the field and with -J."""
    for kw in (dict(rng="chacha8", field=0.2), dict(rng="philox", j_prob=0.2)):
        sims = {be: Simulation(SimConfig(backend=be, nrows=16, ncols=128,
                                         temp=1.5, device="cpu", **kw))
                for be in ("dense", "xla", "packed")}
        for s in sims.values():
            s.advance(3)
        for be in ("xla", "packed"):
            for a, b in zip(sims["dense"].bits(), sims[be].bits()):
                assert torch.equal(a, b), (kw, be)
        assert sims["dense"].energy_total() == sims["xla"].energy_total()


def test_wrapper_runs_the_plain_version_on_cpu():
    gen = np.random.default_rng(4)
    dst, src = (torch.from_numpy(_bits(gen, (8, 32))) for _ in range(2))
    thr = ising.threshold_table(1.5)
    kw = dict(color=1, seed=5, rng_mode="threefry")
    want = dense.dense_sweep_reference(dst, src, src[-1:], src[:1], thr, 0,
                                       3, **kw)
    before = dense.dense_sweep.launches
    assert dense.dense_sweep(dst, src, src[-1:].clone(), src[:1].clone(),
                             thr, 0, 3, **kw) is dst
    assert torch.equal(dst, want) and dense.dense_sweep.launches == before


@pytest.mark.parametrize("bad,msg", [
    (dict(color=2), "color must be 0 or 1"),
    (dict(rng_mode="chacha6b"), "bit-plane mode"),
    (dict(rng_mode="chacha8", shape=(8, 24)), r"chacha needs C % 16"),
    (dict(rng_mode="philox", shape=(8, 18)), r"philox needs C % 4"),
    (dict(src_dn=torch.zeros((1, 5), dtype=torch.uint8)), "src_dn has shape"),
    (dict(dst=torch.zeros((8, 32), dtype=torch.int32)), "torch.uint8"),
    (dict(jplanes=[torch.zeros((8, 32), dtype=torch.uint8)] * 3),
     "4 planes"),
    (dict(jplanes=[torch.zeros((8, 32), dtype=torch.uint8)] * 3
          + [torch.zeros((8, 16), dtype=torch.uint8)]), r"jplanes\[3\]"),
    (dict(thr=[0] * 9), "9 entries"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, msg):
    H, C = bad.pop("shape", (8, 32))
    src = torch.zeros((H, C), dtype=torch.uint8)
    args = dict(dst=torch.zeros((H, C), dtype=torch.uint8), src=src,
                src_up=src[-1:].clone(), src_dn=src[:1].clone(),
                thr=ising.threshold_table(1.5), jplanes=None)
    kw = dict(color=0, seed=1, rng_mode="philox")
    for k in list(bad):
        (args if k in args else kw)[k] = bad.pop(k)
    with pytest.raises((ValueError, TypeError), match=msg):
        dense.dense_sweep(args["dst"], args["src"], args["src_up"],
                          args["src_dn"], args["thr"], 0, 0, args["jplanes"],
                          **kw)


class CudaPlane:
    """A uint8 plane that the wrapper takes for a CUDA tensor (no card
    here): enough to reach the checks made before a launch."""

    def __init__(self, buf, offset, shape):
        self.buf, self.offset, self.shape = buf, offset, shape
        self.device = torch.device("cuda", 0)
        self.dtype = torch.uint8

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return self.buf.ctypes.data + self.offset

    def numel(self):
        return self.shape[0] * self.shape[1]

    def element_size(self):
        return 1


def test_wrapper_refuses_overlap_before_a_launch(monkeypatch):
    """dst is updated in place: a dst that overlaps src, a halo row or a J
    plane is refused before the kernel library is even loaded."""
    monkeypatch.setattr(dense.kernel_lib, "load",
                        lambda: pytest.fail("the kernel library was loaded"))
    buf = np.zeros(1024, np.uint8)
    dst = CudaPlane(buf, 0, (4, 16))
    up, dn = CudaPlane(buf, 512, (1, 16)), CudaPlane(buf, 528, (1, 16))
    cases = [(CudaPlane(buf, 32, (4, 16)), None),
             (CudaPlane(buf, 128, (4, 16)),
              [CudaPlane(buf, o, (4, 16)) for o in (192, 256, 320, 48)])]
    for src, jp in cases:
        with pytest.raises(ValueError, match="must not overlap"):
            dense.dense_sweep(dst, src, up, dn, ising.threshold_table(1.5),
                              0, 0, jp, color=0, seed=1, rng_mode="philox")
    with pytest.raises(ValueError, match="must not overlap"):
        dense.dense_sweep(dst, CudaPlane(buf, 128, (4, 16)),
                          CudaPlane(buf, 60, (1, 16)), dn,
                          ising.threshold_table(1.5), 0, 0, color=0, seed=1,
                          rng_mode="philox")


def test_wrapper_refuses_unaligned_planes(monkeypatch):
    """The kernel moves four sites per 32-bit word: a plane that starts off
    a 4-byte boundary is refused before the library is loaded."""
    monkeypatch.setattr(dense.kernel_lib, "load",
                        lambda: pytest.fail("the kernel library was loaded"))
    buf = np.zeros(1024, np.uint8)
    dst, src = CudaPlane(buf, 0, (4, 16)), CudaPlane(buf, 128, (4, 16))
    for up in (CudaPlane(buf, 513, (1, 16)), CudaPlane(buf, 530, (1, 16))):
        with pytest.raises(ValueError, match="4-byte aligned"):
            dense.dense_sweep(dst, src, up, CudaPlane(buf, 600, (1, 16)),
                              ising.threshold_table(1.5), 0, 0, color=0,
                              seed=1, rng_mode="philox")


class FakeLib:
    """Records the launchers' arguments; returns `code`."""

    def __init__(self, code=0):
        self.code, self.calls = code, []

    def dense_sweep_launch(self, *args):
        self.calls.append(args)
        return self.code

    def mxu_sweep_launch(self, *args):
        self.calls.append(args)
        return self.code

    def ising_cuda_error_string(self, code):
        return b"fake error"


@pytest.mark.parametrize("mode,family,rounds,tag", [
    ("philox", 0, 10, 1), ("philox7", 0, 7, 1), ("threefry13", 1, 13, 1),
    ("threefry", 1, 20, 1), ("chacha4", 2, 4, 1), ("hw", 0, 10, 0x8001)])
@pytest.mark.parametrize("jp", [False, True])
def test_wrapper_launches_kernel_on_cuda_tensor(monkeypatch, mode, family,
                                                rounds, tag, jp):
    """On a CUDA tensor the wrapper launches (never the plain version) with
    the kernel's arguments: hw as salted Philox-10, Threefry's stream key,
    the 10 thresholds and the J planes; then counts the launch."""
    monkeypatch.setattr(dense, "dense_sweep_reference", lambda *a, **k:
                        pytest.fail("plain version called on a CUDA tensor"))
    monkeypatch.setattr(dense, "_cuda_stream", lambda device: 1234)
    lib = FakeLib()
    monkeypatch.setattr(dense.kernel_lib, "load", lambda: (lib, None))
    buf = np.zeros(4096, np.uint8)
    dst, src, *js = (CudaPlane(buf, 512 * k, (8, 32)) for k in range(6))
    up, dn = CudaPlane(buf, 3200, (1, 32)), CudaPlane(buf, 3264, (1, 32))
    thr = ising.threshold_table(0.5, 0.2)
    before = dense.dense_sweep.launches
    assert dense.dense_sweep(dst, src, up, dn, thr, 6, 9, js if jp else None,
                             color=1, seed=5, rng_mode=mode) is dst
    assert dense.dense_sweep.launches == before + 1
    (args,) = lib.calls
    assert args[:4] == tuple(t.data_ptr() for t in (dst, src, up, dn))
    assert args[4:10] == (8, 32, 6, 9, tag, 1)
    assert list(args[10]) == [int(t) for t in thr]
    assert args[11:13] == (threefry_stream_key(5, 9, tag) if family == 1
                           else (5, 0))
    assert args[13:15] == (family, rounds)
    assert args[15:19] == (tuple(j.data_ptr() for j in js) if jp
                           else (None,) * 4)
    assert args[19:] == (1234,)


def test_wrapper_raises_on_failed_launch(monkeypatch):
    lib = FakeLib(code=700)
    monkeypatch.setattr(dense.kernel_lib, "load", lambda: (lib, None))
    monkeypatch.setattr(dense, "_cuda_stream", lambda device: 0)
    buf = np.zeros(512, np.uint8)
    dst, src = CudaPlane(buf, 0, (4, 16)), CudaPlane(buf, 64, (4, 16))
    up, dn = CudaPlane(buf, 128, (1, 16)), CudaPlane(buf, 144, (1, 16))
    before = dense.dense_sweep.launches
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        dense.dense_sweep(dst, src, up, dn, ising.threshold_table(1.0), 0, 0,
                          color=0, seed=1, rng_mode="philox")
    assert dense.dense_sweep.launches == before


@pytest.mark.parametrize("kw,msg", [
    (dict(rng="chacha6b"), "bit-plane rng modes"),
    (dict(xsl=16, ysl=8), "no sub-lattice mode"),
])
def test_backend_fences_match_jax(kw, msg):
    cfg = dict(backend="dense", nrows=16, ncols=64, **kw)
    with pytest.raises(NotImplementedError, match=msg):
        jdense.DenseBackend(JaxConfig(**cfg))
    with pytest.raises(NotImplementedError, match=msg):
        dense.DenseBackend(SimConfig(device="cpu", **cfg))


def test_config_refuses_dense_hw_with_a_field():
    for cls in (JaxConfig, SimConfig):
        with pytest.raises(ValueError, match="u32-contract rng mode"):
            cls(backend="dense", ncols=64, rng="hw", field=0.1)


def _mag_lines(text):
    return [ln for ln in text.splitlines() if "magnetization" in ln]


@pytest.mark.parametrize("extra", [["-J", "0.1"], ["--rng", "hw"],
                                   ["-t", "0", "--rng", "chacha6"]])
def test_cli_lines_match_jax(extra, capsys, monkeypatch):
    """The port's CLI prints the JAX CLI's magnetization lines on dense
    (the JAX side with 8-row blocks in interpret mode)."""
    eight_row_blocks(monkeypatch)
    argv = ["--backend", "dense", "-x", "128", "-y", "16", "-n", "4", "-p",
            "2", "-t", "1.5"] + extra
    assert jcli.main(argv) == 0
    want = _mag_lines(capsys.readouterr().out)
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "\tbackend: dense (rng: " in out
    assert _mag_lines(out) == want and len(want) == 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py, or "
                    "pytest -m gpu on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", U32_MODES)
def test_kernel_matches_plain_on_card(mode, cuda_device):
    """csrc/dense_sweep.cu against its plain version on the card, in every
    accept, with and without J planes."""
    gen = np.random.default_rng(19)
    for temp, field, jp in _accepts(mode):
        d, s = (torch.from_numpy(_bits(gen, (64, 1056))).to(cuda_device)
                for _ in range(2))
        jplanes = [torch.from_numpy(_bits(gen, (64, 1056))).to(cuda_device)
                   for _ in range(4)] if jp else None
        thr = ising.threshold_table(temp, field)
        for color in (0, 1):
            kw = dict(color=color, seed=7, rng_mode=mode)
            want = dense.dense_sweep_reference(d, s, s[-1:], s[:1], thr, 2,
                                               1, jplanes, **kw)
            dense.dense_sweep(d, s, s[-1:], s[:1], thr, 2, 1, jplanes, **kw)
            torch.cuda.synchronize()
            assert torch.equal(d, want)
