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
# are 8 columns, one n8 tile) and the 256 x 512 lattice in two row blocks.
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


@pytest.mark.parametrize("C,mode,cols", [
    (8192, "philox", 16), (8192, "threefry13", 16), (8192, "chacha8", 16),
    (8192, "hw", 16), (128, "philox", 16), (128, "chacha6", 8),
    (384, "chacha4", 8), (384, "philox7", 16), (640, "threefry", 16),
    (128, "threefry13", 16), (384, "hw", 16), (256, "chacha8", 16),
])
def test_calls_per_tile(C, mode, cols):
    """A warp's tile a run: cols output columns (two n8 tiles where G =
    C/S allows, else one) dividing G, so a run holds whole tiles; a lane
    holds cols/4 calls of each of its two rows and keeps a byte a site, S
    runs of cols/8 words, at most 32 registers."""
    assert mxu.tile_columns(C, mode) == cols
    S = dense.sites_per_call(mode)
    assert (C // S) % cols == 0 and S * cols // 8 <= 32
    offsets = sorted(mxu.tile_column(cols, j, n)
                     for j in range(cols // mxu.N8) for n in range(mxu.N8))
    assert offsets == list(range(cols))


def test_tile_columns_refuses_a_run_of_partial_tiles():
    with pytest.raises(ValueError, match="not a multiple of 8"):
        mxu.tile_columns(96, "chacha8")


@pytest.mark.parametrize("cols,color", [(16, 0), (16, 1), (8, 0), (8, 1)])
def test_edge_patches_are_what_the_products_miss(cols, color):
    """The banded counts equal the integer stencil with 16- and 8-column
    groups and no patch: 32 rows of k hold the rows above and below, a
    32-column window from 4 left of the group both horizontal neighbours.
    On an all-up lattice every count is 4; a term the products missed
    (rows 0 and 15 of a block, a group's first and last column, the wrap)
    would lower it."""
    gen = np.random.default_rng(5 + cols + color)
    H, C = 48, 128
    src = _t(_bits(gen, (H, C)))
    up, dn = _t(_bits(gen, (1, C))), _t(_bits(gen, (1, C)))
    want = xla_ref.neighbor_bit_sum(src, color=color, H=H, src_up=up,
                                    src_dn=dn).to(torch.int32)
    assert torch.equal(mxu.neighbour_counts(src, up, dn, color=color,
                                            cols=cols), want)
    ones = torch.ones_like(src)
    lone = mxu.neighbour_counts(ones, ones[:1], ones[:1], color=color,
                                cols=cols)
    assert torch.equal(lone, torch.full_like(lone, 4))


# mma.sync.m16n8k32 with .u8 operands, as the PTX ISA lays out its
# fragments (g = lane / 4, t = lane % 4): element i of A (four registers of
# four bytes) is row g (i < 4 or 8 <= i < 12) else g + 8, column 4t +
# (i & 3) (+ 16 for i >= 8); element i of B (two registers) is row 4t +
# (i & 3) (+ 16 for i >= 4), column g; accumulator i is row g (i < 2) else
# g + 8, column 2t + (i & 1).
def a_element(lane, i):
    g, t = lane >> 2, lane & 3
    return (g if i < 4 or 8 <= i < 12 else g + 8,
            4 * t + (i & 3) + (16 if i >= 8 else 0))


def b_element(lane, i):
    g, t = lane >> 2, lane & 3
    return 4 * t + (i & 3) + (16 if i >= 4 else 0), g


def c_element(lane, i):
    g, t = lane >> 2, lane & 3
    return g + (8 if i >= 2 else 0), 2 * t + (i & 1)


def lane_sites(C, mode, q0):
    """{lane: sorted (row, column) of its accumulator elements} over a
    warp's tile (S runs of cols/8 n8 tiles at in-run offset q0)."""
    S = dense.sites_per_call(mode)
    G, cols = C // S, mxu.tile_columns(C, mode)
    out = {}
    for lane in range(32):
        got = []
        for s in range(S):
            for j in range(cols // mxu.N8):
                for i in range(4):
                    m, n = c_element(lane, i)
                    got.append((m, s * G + q0 + mxu.tile_column(cols, j, n)))
        out[lane] = sorted(got)
    return out


@pytest.mark.parametrize("C,mode", [
    (128, "chacha8"), (384, "chacha6"), (8192, "chacha4"), (128, "philox"),
    (256, "chacha8"),
    (8192, "philox7"), (128, "threefry13"), (640, "threefry"),
    (8192, "hw")])
def test_lane_map_holds_whole_calls(C, mode):
    """The fragment model: the A and B elements of each register are
    distinct, every site of a warp's tile is one accumulator element of one
    lane, and lane (g, t)'s elements are exactly the S sites (q + s*G) of
    its 2 * cols/4 generator calls: rows g and g + 8, calls q0 + (cols/4) t
    .. + cols/4 - 1, which the kernel draws in that lane."""
    assert len({a_element(ln, i) for ln in range(32) for i in range(16)}) \
        == 16 * 32
    assert len({b_element(ln, i) for ln in range(32) for i in range(8)}) \
        == 32 * 8
    S = dense.sites_per_call(mode)
    G, cols = C // S, mxu.tile_columns(C, mode)
    P = cols // 4
    for q0 in sorted({0, G - cols}):
        sites = lane_sites(C, mode, q0)
        every = [x for v in sites.values() for x in v]
        assert sorted(every) == sorted(
            (r, s * G + q0 + c) for r in range(16) for s in range(S)
            for c in range(cols))
        for lane, got in sites.items():
            g, t = lane >> 2, lane & 3
            calls = [(r, q0 + P * t + p) for r in (g, g + 8)
                     for p in range(P)]
            assert got == sorted((r, q + s * G) for r, q in calls
                                 for s in range(S)), lane


def byte_perm(x, y, sel):
    """__byte_perm: byte i of the result is byte (sel >> 4i) & 7 of y:x."""
    b = [(x >> (8 * k)) & 0xFF for k in range(4)] + \
        [(y >> (8 * k)) & 0xFF for k in range(4)]
    return sum(b[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))


def band_bytes(k0, a, b, v):
    return sum((v << (8 * i)) for i in range(4) if k0 + i in (a, b))


def word(row, c, nbytes):
    return int.from_bytes(bytes(row[c:c + nbytes]), "little")


def warp_tile_sums(dst, src, up, dn, *, color, mode, ty, q0):
    """The accumulators of one warp's tile as csrc/mxu_sweep.cu builds
    them: every lane's registers made from the planes' bytes as the kernel
    makes them (words, byte permutes, window wraps, halo rows), placed by
    the fragment model, multiplied, and each lane's left or right product
    selected. Returns {(row, column): accumulator}."""
    H, C = dst.shape
    S = dense.sites_per_call(mode)
    G, cols = C // S, mxu.tile_columns(C, mode)
    T, P = cols // mxu.N8, cols // 4
    y0 = 16 * ty
    upr = up[0] if y0 == 0 else src[y0 - 1]
    dnr = dn[0] if y0 + 16 == H else src[y0 + 16]
    out = {}
    for s in range(S):
        c0 = s * G + q0
        regs = []
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            x = c0 - 4 + 4 * t
            if s == 0 and x < 0:
                x += C
            if T == 1 and s == S - 1 and x >= C:
                x -= C
            a = [word(src[y0 + g], x, 4), word(src[y0 + g + 8], x, 4), 0, 0]
            if T == 2 and t < 2:
                x2 = c0 + 12 + 4 * t
                if s == S - 1 and x2 >= C:
                    x2 -= C
                a[2:] = word(src[y0 + g], x2, 4), word(src[y0 + g + 8], x2, 4)
            me = [word(dst[y0 + g], c0 + P * t, 2 * T),
                  word(dst[y0 + g + 8], c0 + P * t, 2 * T), 0, 0]
            if T == 2:
                xv = c0 + 2 * g
                r = [word(src[y0 + 4 * t + b], xv, 2) for b in range(4)]
                hu = word(upr, xv, 2) if t == 0 else 0
                hd = word(dnr, xv, 2) if t == 0 else 0
                lo = byte_perm(r[0], r[1], 0x5140)
                hi = byte_perm(r[2], r[3], 0x5140)
                v0 = [byte_perm(lo, hi, 0x5410), byte_perm(lo, hi, 0x7632)]
                v1 = [byte_perm(hu, hd, 0x3240), byte_perm(hu, hd, 0x3251)]
            else:
                xv = c0 + g
                r = [int(src[y0 + 4 * t + b, xv]) for b in range(4)]
                hu = int(upr[xv]) if t == 0 else 0
                hd = int(dnr[xv]) if t == 0 else 0
                v0 = [byte_perm(byte_perm(r[0], r[1], 0x3340),
                                byte_perm(r[2], r[3], 0x3340), 0x5410)]
                v1 = [byte_perm(hu, hd, 0x3340)]
            kv = []
            for i in range(4):
                m = g + 8 * (i & 1)
                kv.append(band_bytes(4 * t + 16 * (i >> 1),
                                     16 if m == 0 else m - 1,
                                     17 if m == 15 else m + 1, 4))
            bl, br, bd = [], [], []
            for j in range(T):
                f = 2 * g + j if T == 2 else g
                kd = f if T == 2 else 4 * (g >> 1) + (g & 1)
                bl.append([band_bytes(4 * t + 16 * i, f + 3, f + 4, 4)
                           for i in range(2)])
                br.append([band_bytes(4 * t + 16 * i, f + 4, f + 5, 4)
                           for i in range(2)])
                bd.append([band_bytes(4 * t, kd, kd, 20), 0])
            regs.append(dict(a=a, me=me, kv=kv, v=list(zip(v0, v1)), bl=bl,
                             br=br, bd=bd))

        def a_matrix(key):
            m = np.zeros((16, 32), np.int64)
            for lane, rg in enumerate(regs):
                for i in range(16):
                    m[a_element(lane, i)] = \
                        (rg[key][i // 4] >> (8 * (i % 4))) & 0xFF
            return m

        def b_matrix(get):
            m = np.zeros((32, 8), np.int64)
            for lane, rg in enumerate(regs):
                for i in range(8):
                    m[b_element(lane, i)] = \
                        (get(rg)[i // 4] >> (8 * (i % 4))) & 0xFF
            return m

        A, M, K = a_matrix("a"), a_matrix("me"), a_matrix("kv")
        for j in range(T):
            acc = M @ b_matrix(lambda rg: rg["bd"][j]) \
                + K @ b_matrix(lambda rg: rg["v"][j])
            left = acc + A @ b_matrix(lambda rg: rg["bl"][j])
            right = acc + A @ b_matrix(lambda rg: rg["br"][j])
            for lane in range(32):
                g = lane >> 2
                use = right if (color == 0) == bool(g & 1) else left
                for i in range(4):
                    m, n = c_element(lane, i)
                    out[(y0 + m, c0 + mxu.tile_column(cols, j, n))] = \
                        int(use[m, n])
    return out


@pytest.mark.parametrize("mode,C,color", [
    ("threefry13", 128, 0), ("philox", 256, 1), ("hw", 128, 1),
    ("chacha8", 128, 1), ("chacha6", 384, 0), ("chacha4", 256, 1)])
def test_warp_operands_give_the_threshold_offset(mode, C, color):
    """Every lane's operands built from the bytes as the kernel builds them
    (window words and their wraps, the 16-bit or byte loads of the vertical
    operand and their byte permutes, the halo rows, the dst bytes, the
    constant bands), placed by the fragment model and multiplied, leave
    4 (5 dst + n) in each site's accumulator: the byte offset of its
    threshold in the kernel's table. Checked at the first and last row
    block (src_up, src_dn) and in-run offset (both window wraps)."""
    gen = np.random.default_rng(8 + C + color)
    H = 48
    dst, src = _bits(gen, (H, C)), _bits(gen, (H, C))
    up, dn = _bits(gen, (1, C)), _bits(gen, (1, C))
    n = xla_ref.neighbor_bit_sum(_t(src), color=color, H=H, src_up=_t(up),
                                 src_dn=_t(dn)).numpy().astype(np.int64)
    S = dense.sites_per_call(mode)
    G, cols = C // S, mxu.tile_columns(C, mode)
    for ty, q0 in ((0, 0), (H // 16 - 1, G - cols), (1, 0)):
        got = warp_tile_sums(dst, src, up, dn, color=color, mode=mode,
                             ty=ty, q0=q0)
        assert len(got) == 16 * cols * S
        for (y, c), acc in got.items():
            assert acc == 4 * (5 * int(dst[y, c]) + n[y, c]), (ty, q0, y, c)


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


@pytest.mark.parametrize("mode,family,rounds,tag,cols", [
    ("philox", 0, 10, 1, 16), ("philox7", 0, 7, 1, 16),
    ("threefry13", 1, 13, 1, 16), ("chacha8", 2, 8, 1, 8),
    ("hw", 0, 10, 0x8001, 16)])
def test_wrapper_launches_kernel_on_cuda_tensor(monkeypatch, mode, family,
                                                rounds, tag, cols):
    """On a CUDA tensor the wrapper launches (never the plain version) with
    the kernel's arguments, the tile's columns among them; then counts the
    launch."""
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
    assert args[4:11] == (16, 128, cols, 6, 9, tag, 1)
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
