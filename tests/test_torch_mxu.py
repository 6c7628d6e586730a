"""The port's mxu tier against the JAX package's: the plain half-sweep
against the Pallas kernel in interpret mode, whole Simulation trajectories,
the tiling of the band products, the wrapper, the backend's fences and the
CLI.

mxu_sweep_reference (the plain torch version of csrc/mxu_sweep.cu, its
band products tiled as the kernel tiles them) is held bit for bit against
ising_tpu.ops.mxu.mxu_sweep at 128 x 256 (one 128-row block) and 256 x 512
(two, forced on the JAX side), in every u32 rng mode and hw, at T > 0 and
in the greedy quench, both colors; and against the port's dense and xla
sweeps. The neighbour sums are small integers, exact in float32: exact
equality everywhere.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ising_tpu.ops.mxu as jmxu
from ising_tpu import SimConfig as JaxConfig
from ising_tpu import cli as jcli
from ising_tpu.driver import Simulation as JaxSimulation
from ising_tpu_torch import SimConfig, cli
from ising_tpu_torch.driver import Simulation
from ising_tpu_torch.models import ising
from ising_tpu_torch.ops import dense, mxu, xla_ref
from ising_tpu_torch.rng import PORTED_MODES, plane_bits, threefry_stream_key

from test_torch_dense import CudaPlane, FakeLib

U32_MODES = [m for m in PORTED_MODES if not plane_bits(m)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def row_blocks_of_128(monkeypatch):
    """128-row blocks in the JAX mxu kernel: two blocks at 256 rows."""
    monkeypatch.setattr(jmxu, "_pick_block_rows_128",
                        lambda nrows, target=256: 128)


def _bits(gen, shape):
    return gen.integers(0, 2, shape, dtype=np.uint8)


def _t(a):
    return torch.from_numpy(a.copy())


# (H, C, temperature, color): the 128 x 256 lattice (C = 128: ChaCha's runs
# are 8 columns, tq = 8) and the 256 x 512 lattice in two row blocks.
SWEEPS = [(128, 128, 1.5, 0), (128, 128, 0.0, 1),
          (256, 256, 1.5, 1), (256, 256, 0.0, 0)]


@pytest.mark.parametrize("mode", U32_MODES)
def test_reference_matches_pallas(mode, monkeypatch):
    row_blocks_of_128(monkeypatch)
    gen = np.random.default_rng(40 + U32_MODES.index(mode))
    for H, C, temp, color in SWEEPS:
        thr = ising.threshold_table(temp)
        dst, src = _bits(gen, (H, C)), _bits(gen, (H, C))
        up, dn = _bits(gen, (1, C)), _bits(gen, (1, C))
        row0 = (1 << 32) - 128 if temp else 0
        step = int(gen.integers(0, 1 << 32))
        kw = dict(color=color, seed=77, rng_mode=mode)
        want = np.asarray(jmxu.mxu_sweep(
            jnp.asarray(dst), jnp.asarray(src), jnp.asarray(up),
            jnp.asarray(dn), jnp.asarray(thr), jnp.uint32(row0),
            jnp.uint32(step), interpret=True, **kw))
        got = mxu.mxu_sweep_reference(_t(dst), _t(src), _t(up), _t(dn), thr,
                                      row0, step, **kw)
        what = f"{mode} {H}x{C} T={temp} color={color}"
        np.testing.assert_array_equal(got.numpy(), want, err_msg=what)
        # the same function as dense's integer stencil and full table
        same = dense.dense_sweep_reference(_t(dst), _t(src), _t(up), _t(dn),
                                           thr, row0, step, **kw)
        assert torch.equal(got, same), what


@pytest.mark.parametrize("mode", ["threefry13", "chacha8"])
def test_reference_matches_xla_sweep(mode):
    """In the counter modes mxu's sweep is the xla backend's."""
    gen = np.random.default_rng(3)
    H, C = 32, 384          # C = 384: ChaCha's G = 24 is not a multiple of 16
    cfg = SimConfig(backend="xla", nrows=H, ncols=2 * C, rng=mode, seed=9,
                    temp=1.5, device="cpu")
    be = xla_ref.XlaBackend(cfg)
    thr = ising.threshold_table(1.5)
    for color in (0, 1):
        d, s = _t(_bits(gen, (H, C))), _t(_bits(gen, (H, C)))
        want = be.update_color(d, s, color=color, thr10=thr, step=4,
                               src_up=s[-1:], src_dn=s[:1])
        got = mxu.mxu_sweep_reference(d, s, s[-1:], s[:1], thr, 0, 4,
                                      color=color, seed=9, rng_mode=mode)
        assert torch.equal(got, want)


@pytest.mark.parametrize("C,mode,tq", [
    (8192, "philox", 64), (8192, "threefry13", 64), (8192, "chacha8", 16),
    (8192, "hw", 64), (128, "philox", 32), (128, "chacha6", 8),
    (384, "chacha4", 8), (384, "philox7", 32), (640, "threefry", 64),
])
def test_calls_per_tile(C, mode, tq):
    """tq divides G = C/S, the CTA stages at most 256 columns, and a
    16-wide fragment starts at every multiple of min(tq, 16)."""
    assert mxu.calls_per_tile(C, mode) == tq
    S = dense.sites_per_call(mode)
    assert (C // S) % tq == 0 and S * max(tq, 16) <= mxu.MAX_COLS


def test_edge_patches_are_what_the_products_miss():
    """The banded, patched counts equal the integer stencil with 16- and
    8-wide windows; on an all-up lattice every count is 4, which a missing
    patch (rows 0 and 15 of a block, lanes 0 and 15 of a window, lane 0 of
    a run of 8) would lower."""
    gen = np.random.default_rng(5)
    H, C = 32, 128
    src = _t(_bits(gen, (H, C)))
    up, dn = _t(_bits(gen, (1, C))), _t(_bits(gen, (1, C)))
    want = xla_ref.neighbor_bit_sum(src, color=0, H=H, src_up=up,
                                    src_dn=dn).to(torch.int32)
    for window in (16, 8):
        assert torch.equal(mxu.neighbour_counts(src, up, dn, color=0,
                                                window=window), want)
    ones = torch.ones_like(src)
    lone = mxu.neighbour_counts(ones, ones[:1], ones[:1], color=0, window=16)
    assert torch.equal(lone, torch.full_like(lone, 4))


TRAJECTORIES = [dict(rng="threefry13", temp=1.5), dict(rng="hw", temp=1.5),
                dict(rng="chacha6", temp=0.0)]


@pytest.mark.parametrize("kw", TRAJECTORIES,
                         ids=[k["rng"] for k in TRAJECTORIES])
def test_simulation_matches_jax_mxu(kw):
    """Whole trajectories at 128 x 256: the JAX mxu backend (interpret
    mode) and the port's Simulation on the CPU give the same lattice and
    up counts after 2 steps; so do the port's dense backend and, in the
    counter modes, xla (hw: packed, the same salted Philox-10 per spin)."""
    cfg = dict(nrows=128, ncols=256, seed=21, **kw)
    jsim = JaxSimulation(JaxConfig(backend="mxu", **cfg))
    jsim.advance(2)
    others = ("dense", "packed") if kw["rng"] == "hw" else ("dense", "xla")
    sims = {be: Simulation(SimConfig(backend=be, device="cpu", **cfg))
            for be in ("mxu",) + others}
    for s in sims.values():
        s.advance(2)
    for a, b in zip(sims["mxu"].bits(), jsim.bits()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert sims["mxu"].measure() == jsim.measure()
    assert sims["mxu"].energy_total() == jsim.energy_total()
    for be in others:
        for a, b in zip(sims["mxu"].bits(), sims[be].bits()):
            assert torch.equal(a, b), be


def _cfg(**kw):
    base = dict(xsl=None, j_prob=None, rng="philox", nrows=256, ncols=256,
                local_rows=256)
    base.update(kw)
    return types.SimpleNamespace(**base)


@pytest.mark.parametrize("kw,exc,msg", [
    (dict(xsl=16), NotImplementedError, "no sub-lattice mode"),
    (dict(j_prob=0.1), NotImplementedError, "no disorder mode"),
    (dict(rng="chacha6b"), NotImplementedError, "bit-plane rng modes"),
    (dict(nrows=192), ValueError, "multiples of 128"),
    (dict(ncols=384), ValueError, "multiples of 128"),
    (dict(local_rows=64), ValueError, "slab height"),
])
def test_backend_fences_match_jax(kw, exc, msg):
    """Each of the JAX backend's fences, with its exception type (on a
    bare config object: SimConfig refuses some of them earlier, and the
    port's slab is the whole lattice)."""
    with pytest.raises(exc, match=msg):
        jmxu.MxuBackend(_cfg(**kw))
    with pytest.raises(exc, match=msg):
        mxu.MxuBackend(_cfg(**kw))
    mxu.MxuBackend(_cfg())


def test_config_fences_match_jax():
    for cls in (JaxConfig, SimConfig):
        with pytest.raises(ValueError, match="not supported on the mxu"):
            cls(backend="mxu", ncols=256, field=0.1)
        with pytest.raises(ValueError, match="ncols multiple of 256"):
            cls(backend="mxu", ncols=384)
    for kw in (dict(j_prob=0.1), dict(xsl=16, ysl=16)):
        with pytest.raises(NotImplementedError):
            Simulation(SimConfig(backend="mxu", nrows=128, ncols=256,
                                 device="cpu", **kw))


def test_wrapper_runs_the_plain_version_on_cpu():
    gen = np.random.default_rng(4)
    dst, src = (_t(_bits(gen, (16, 128))) for _ in range(2))
    thr = ising.threshold_table(1.5)
    kw = dict(color=1, seed=5, rng_mode="chacha8")
    want = mxu.mxu_sweep_reference(dst, src, src[-1:], src[:1], thr, 0, 3,
                                   **kw)
    before = mxu.mxu_sweep.launches
    assert mxu.mxu_sweep(dst, src, src[-1:].clone(), src[:1].clone(), thr, 0,
                         3, **kw) is dst
    assert torch.equal(dst, want) and mxu.mxu_sweep.launches == before


@pytest.mark.parametrize("bad,msg", [
    (dict(color=2), "color must be 0 or 1"),
    (dict(rng_mode="philox7b"), "bit-plane mode"),
    (dict(shape=(24, 128)), r"H % 16 == 0 and C % 128"),
    (dict(shape=(16, 192)), r"H % 16 == 0 and C % 128"),
    (dict(src_up=torch.zeros((2, 128), dtype=torch.uint8)), "src_up has"),
    (dict(src=torch.zeros((16, 128), dtype=torch.bool)), "torch.uint8"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, msg):
    H, C = bad.pop("shape", (16, 128))
    src = torch.zeros((H, C), dtype=torch.uint8)
    args = dict(dst=torch.zeros((H, C), dtype=torch.uint8), src=src,
                src_up=src[-1:].clone(), src_dn=src[:1].clone())
    kw = dict(color=0, seed=1, rng_mode="philox")
    for k in list(bad):
        (args if k in args else kw)[k] = bad.pop(k)
    with pytest.raises((ValueError, TypeError), match=msg):
        mxu.mxu_sweep(args["dst"], args["src"], args["src_up"],
                      args["src_dn"], ising.threshold_table(1.5), 0, 0, **kw)


def test_wrapper_refuses_overlap_before_a_launch(monkeypatch):
    monkeypatch.setattr(mxu.kernel_lib, "load",
                        lambda: pytest.fail("the kernel library was loaded"))
    buf = np.zeros(8192, np.uint8)
    dst = CudaPlane(buf, 0, (16, 128))
    up, dn = CudaPlane(buf, 6144, (1, 128)), CudaPlane(buf, 6272, (1, 128))
    for src, u in ((CudaPlane(buf, 1024, (16, 128)), up),
                   (CudaPlane(buf, 2048, (16, 128)),
                    CudaPlane(buf, 1920, (1, 128)))):
        with pytest.raises(ValueError, match="must not overlap"):
            mxu.mxu_sweep(dst, src, u, dn, ising.threshold_table(1.5), 0, 0,
                          color=0, seed=1, rng_mode="philox")


def test_wrapper_refuses_unaligned_planes(monkeypatch):
    monkeypatch.setattr(mxu.kernel_lib, "load",
                        lambda: pytest.fail("the kernel library was loaded"))
    buf = np.zeros(8192, np.uint8)
    dst, src = CudaPlane(buf, 0, (16, 128)), CudaPlane(buf, 2050, (16, 128))
    with pytest.raises(ValueError, match="4-byte aligned"):
        mxu.mxu_sweep(dst, src, CudaPlane(buf, 6144, (1, 128)),
                      CudaPlane(buf, 6272, (1, 128)),
                      ising.threshold_table(1.5), 0, 0, color=0, seed=1,
                      rng_mode="philox")


@pytest.mark.parametrize("mode,family,rounds,tag,tq", [
    ("philox", 0, 10, 1, 32), ("philox7", 0, 7, 1, 32),
    ("threefry13", 1, 13, 1, 64), ("chacha8", 2, 8, 1, 8),
    ("hw", 0, 10, 0x8001, 32)])
def test_wrapper_launches_kernel_on_cuda_tensor(monkeypatch, mode, family,
                                                rounds, tag, tq):
    """On a CUDA tensor the wrapper launches (never the plain version) with
    the kernel's arguments, tq among them; then counts the launch."""
    monkeypatch.setattr(mxu, "mxu_sweep_reference", lambda *a, **k:
                        pytest.fail("plain version called on a CUDA tensor"))
    monkeypatch.setattr(mxu, "_cuda_stream", lambda device: 1234)
    lib = FakeLib()
    monkeypatch.setattr(mxu.kernel_lib, "load", lambda: (lib, None))
    buf = np.zeros(8192, np.uint8)
    dst, src = CudaPlane(buf, 0, (16, 128)), CudaPlane(buf, 2048, (16, 128))
    up, dn = CudaPlane(buf, 4096, (1, 128)), CudaPlane(buf, 4224, (1, 128))
    thr = ising.threshold_table(0.0)
    before = mxu.mxu_sweep.launches
    assert mxu.mxu_sweep(dst, src, up, dn, thr, 6, 9, color=1, seed=5,
                         rng_mode=mode) is dst
    assert mxu.mxu_sweep.launches == before + 1
    (args,) = lib.calls
    assert args[:4] == tuple(t.data_ptr() for t in (dst, src, up, dn))
    assert args[4:11] == (16, 128, tq, 6, 9, tag, 1)
    assert list(args[11]) == [int(t) for t in thr]
    assert args[12:14] == (threefry_stream_key(5, 9, tag) if family == 1
                           else (5, 0))
    assert args[14:] == (family, rounds, 1234)


def test_wrapper_raises_on_failed_launch(monkeypatch):
    lib = FakeLib(code=700)
    monkeypatch.setattr(mxu.kernel_lib, "load", lambda: (lib, None))
    monkeypatch.setattr(mxu, "_cuda_stream", lambda device: 0)
    buf = np.zeros(8192, np.uint8)
    dst, src = CudaPlane(buf, 0, (16, 128)), CudaPlane(buf, 2048, (16, 128))
    up, dn = CudaPlane(buf, 4096, (1, 128)), CudaPlane(buf, 4224, (1, 128))
    before = mxu.mxu_sweep.launches
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        mxu.mxu_sweep(dst, src, up, dn, ising.threshold_table(1.0), 0, 0,
                      color=0, seed=1, rng_mode="philox")
    assert mxu.mxu_sweep.launches == before


def _mag_lines(text):
    return [ln for ln in text.splitlines() if "magnetization" in ln]


def test_cli_lines_match_jax(capsys):
    argv = ["--backend", "mxu", "-x", "256", "-y", "128", "-n", "2", "-p",
            "1", "-t", "1.5", "--rng", "philox"]
    assert jcli.main(argv) == 0
    want = _mag_lines(capsys.readouterr().out)
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "\tbackend: mxu (rng: philox)" in out
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
    """csrc/mxu_sweep.cu against its plain version on the card, at T > 0
    and in the quench, at C = 128 (ChaCha's runs of 8) and C = 384."""
    gen = np.random.default_rng(20)
    for (H, C), temp in (((32, 128), 1.5), ((48, 384), 0.0)):
        d, s = (_t(_bits(gen, (H, C))).to(cuda_device) for _ in range(2))
        thr = ising.threshold_table(temp)
        for color in (0, 1):
            kw = dict(color=color, seed=7, rng_mode=mode)
            want = mxu.mxu_sweep_reference(d, s, s[-1:], s[:1], thr, 2, 1,
                                           **kw)
            mxu.mxu_sweep(d, s, s[-1:], s[:1], thr, 2, 1, **kw)
            torch.cuda.synchronize()
            assert torch.equal(d, want)
