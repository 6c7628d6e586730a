"""1-bit tier (backend "bit1"): storage, plain sweep, CUDA sweep, backend.

The port of ``ising_tpu/ops/pallas_bit1.py`` and its TPU kernel
``_bit1_kernel`` in every rng mode: the u32-draw path (Philox, Threefry
and ChaCha counter modes), the bit-plane path (the "...b" modes and hw)
with its bit-serial accept, the greedy T <= 0 quench, and the 10-class
external-field accept, quenched +-J disorder (per-color J planes, or the
parity-split link store projected in the kernel) and sub-lattice replicas.

Storage: a compact color plane (Y, C = X/2) is held as (Y, W1 = C/32)
torch.int32 words carrying the same 32 bits as the JAX package's uint32
words; bit g of word j is the spin at compact column g*W1 + j.

``bit1_sweep`` launches the hand-written kernels in ``csrc/`` on CUDA
tensors and runs ``bit1_sweep_reference``, the same function in plain
torch, on CPU tensors. The plain version works on int64 copies of the
words (values in [0, 2^32)), because torch's int32 right shift is
arithmetic and its uint32 lacks shifts and compares on the CPU.
``bit1_decode`` unpacks both word planes into bit planes in one launch of
csrc/bit1_decode.cu on CUDA tensors, through ``unpack_rows`` on CPU
tensors.

Bit-plane path: instead of one u32 draw per spin, a color phase draws k
random bit-plane words per word (plane z holds random bit z of the 32
spins) and accepts where the assembled k-bit uniform v < t, evaluated
bit-serially over the planes with no per-spin compare. The "...b" modes
take k = 16 planes of their counter generator; hw takes k = 24 planes of
Philox-10 with counter word 3 salted by HW_SALT, which is the stream the
JAX package's Pallas kernels substitute for the TPU's hardware generator
when they run off the TPU (so the two agree bit for bit there; a real
TPU's hw stream is a different one).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..constants import BLACK, WHITE
from ..models import ising
from ..rng import (MASK, TAG_SWEEP, counter_color_draws, key_from_seed,
                   parse_rng_mode, plane_bits, threefry_stream_key)
from ..utils import profiling
from . import kernel_lib

SPW = 32  # spins per word
HW_KBITS = 24      # hw's accept granularity: the reference's 2^-24 uniforms
HW_SALT = 0x8000   # hw's counter word 3 is the sweep tag | HW_SALT


def accept_bits(rng_mode: str) -> int:
    """k of the bit-serial accept: the mode's plane count, HW_KBITS for
    hw, 0 for the u32-draw modes."""
    if parse_rng_mode(rng_mode)[0] == "hw":
        return HW_KBITS
    return plane_bits(rng_mode)


def _u(words):
    """int32 words -> int64 holding the unsigned 32-bit value."""
    return words.to(torch.int64) & MASK


def _s(values):
    """int64 holding unsigned 32-bit values -> int32 words (same bits)."""
    return (((values & MASK) ^ 0x80000000) - 0x80000000).to(torch.int32)


def _bit_weights(device):
    return (torch.ones(SPW, dtype=torch.int64, device=device)
            << torch.arange(SPW, device=device))[:, None]


def pack_bits1(bits):
    """(Y, C) uint8 bit plane -> (Y, W1 = C/32) int32, bit g = col g*W1+j."""
    Y, C = bits.shape
    g = bits.reshape(Y, SPW, C // SPW).to(torch.int64)
    return _s((g * _bit_weights(bits.device)).sum(dim=1))


def unpack_bits1(packed, out=None):
    """(Y, W1) int32 words -> (Y, 32*W1) uint8 bit plane, written into
    `out` when given. One bit at a time, shifted in int32 (the sign bits
    an arithmetic shift brings in are masked off): the only transient is
    one (Y, W1) int32 plane."""
    Y, W1 = packed.shape
    if out is None:
        out = torch.empty((Y, SPW * W1), dtype=torch.uint8,
                          device=packed.device)
    view = out.view(Y, SPW, W1)
    for g in range(SPW):
        view[:, g, :] = (packed >> g) & 1
    return out


def unpack_rows(store, chunk: int = 8192, unpack=unpack_bits1,
                per_word: int = SPW):
    """unpack (unpack_bits1, or packed's unpack_bits with its per_word 8)
    of a (Y, W) word plane in row chunks: the transient stays one chunk's
    int32 plane, however tall the lattice."""
    Y, W = store.shape
    out = torch.empty((Y, per_word * W), dtype=torch.uint8,
                      device=store.device)
    for r in range(0, Y, chunk):
        unpack(store[r:r + chunk], out=out[r:r + chunk])
    return out


def words_to_packed_rows(words):
    """(Y, W1) int32 bit1 words -> (Y, 4*W1) uint8 in np.packbits byte
    order: the bytes the checkpoint's packing of unpack_bits1(words) gives,
    without the 8x larger byte plane. With W1 % 8 == 0 byte k of bit group
    g holds bit g of words 8k..8k+7, the first word in its top bit."""
    Y, W1 = words.shape
    if W1 % 8:
        raise ValueError("word-domain packing needs W1 % 8 == 0 "
                         "(ncols % 512)")
    gw = words.reshape(Y, 1, W1 // 8, 8)
    shifts = torch.arange(SPW, dtype=torch.int32,
                          device=words.device)[None, :, None]
    acc = torch.zeros((Y, SPW, W1 // 8), dtype=torch.int32,
                      device=words.device)
    for i in range(8):
        acc |= ((gw[..., i] >> shifts) & 1) << (7 - i)
    return acc.to(torch.uint8).reshape(Y, 4 * W1)


def packed_rows_to_words(packed, W1: int):
    """(Y, 4*W1) uint8 bytes in np.packbits order -> (Y, W1) int32 bit1
    words on packed's device: the inverse of words_to_packed_rows."""
    Y = packed.shape[0]
    if W1 % 8:
        raise ValueError("word-domain unpacking needs W1 % 8 == 0")
    pg = packed.reshape(Y, SPW, W1 // 8).to(torch.int64)
    weights = _bit_weights(packed.device)[None]        # (1, 32, 1)
    words = torch.empty((Y, W1 // 8, 8), dtype=torch.int64,
                        device=packed.device)
    for i in range(8):
        words[..., i] = (((pg >> (7 - i)) & 1) * weights).sum(dim=1)
    return _s(words.reshape(Y, W1))


def _neighbor_adder(up, dn, same, off):
    """4-input bit-sliced carry-save adder: the neighbor-up count
    n = n2 n1 n0 as three bit planes (11 bitwise ops per 32 spins)."""
    t0 = up ^ dn
    c0 = up & dn
    t1 = same ^ off
    c1 = same & off
    n0 = t0 ^ t1
    c2 = t0 & t1
    n1 = c0 ^ c1 ^ c2
    n2 = (c0 & c1) | (c2 & (c0 ^ c1))
    return n0, n1, n2


def _neighbor_class_masks(me, up, dn, same, off):
    """Bit-plane predicates (ge3, ge4, eq2) of the mirrored count
    e = b ? n : 4 - n. Works on any integer type; with signed types the
    bits above 31 are garbage that the caller masks off."""
    n0, n1, n2 = _neighbor_adder(up, dn, same, off)
    n_ge3 = n2 | (n1 & n0)
    n_le1 = ~(n2 | n1)
    n_eq0 = n_le1 & ~n0
    ge3 = (me & n_ge3) | (~me & n_le1)
    ge4 = (me & n2) | (~me & n_eq0)
    eq2 = ~n2 & n1 & ~n0
    return ge3, ge4, eq2


def _accept_plane(draws, threshold: int):
    """(H, 32*W1) draws -> (H, W1) plane, bit g set where the draw of
    compact column g*W1 + j is <= threshold (unsigned)."""
    H, C = draws.shape
    hit = (draws <= int(threshold)).to(torch.int64).reshape(H, SPW, C // SPW)
    return (hit * _bit_weights(draws.device)).sum(dim=1)


def plane_accept_args(rng_mode: str, temp: float, field: float = 0.0) -> dict:
    """bit1_sweep's k-bit thresholds for a bit-plane mode at (temp,
    field): t4k/t8k, or the 10-class tvals10/always10 when field != 0
    (pallas_bit1.py:733-740). Empty for the u32 modes."""
    k = accept_bits(rng_mode)
    if not k:
        return {}
    if field:
        tvals10, always10 = ising.field_kbit_thresholds(temp, field, k)
        return dict(tvals10=tvals10, always10=always10)
    t4k, t8k = ising.bernoulli_kbit_thresholds(temp, k)
    return dict(t4k=t4k, t8k=t8k)


@functools.lru_cache(maxsize=16)
def accept_table(kbits: int, t4k: int, t8k: int, tvals10, always10: int):
    """bit1_planes_launch's threshold table (AcceptTable in
    csrc/bit1_planes.cu) as kernel_lib.TABLE_WORDS ctypes words, each
    threshold bit laid out as a whole word (all ones where it is set), so
    that the kernel's step of the bit-serial compare over a plane is one
    logic op: the bit-words of t4k and of t8k; with a field (tvals10 a
    tuple) the mask of the classes that flip on a draw, then all-ones
    words where a class always flips and the bit-words of each drawing
    class's threshold. Built once per set of thresholds, not on every
    launch."""
    K = kernel_lib.TABLE_KBITS
    words = [0] * kernel_lib.TABLE_WORDS
    for i, t in enumerate((t4k, t8k)):
        for z in range(kbits):
            if (t >> z) & 1:
                words[i * K + z] = MASK
    if tvals10 is not None:
        draws, always, bits = 2 * K, 2 * K + 1, 2 * K + 11
        for c, t in enumerate(tvals10):
            if (always10 >> c) & 1:
                words[always + c] = MASK
            elif t:
                words[draws] |= 1 << c
                for z in range(kbits):
                    if (t >> z) & 1:
                        words[bits + c * K + z] = MASK
    return (ctypes.c_uint32 * kernel_lib.TABLE_WORDS)(*words)


def draw_mode(rng_mode: str, tag: int):
    """(mode, tag) of the counter stream drawn under `tag`: hw is Philox-10
    under the salted tag (the JAX package's off-TPU hw stream)."""
    if parse_rng_mode(rng_mode)[0] == "hw":
        return "philox", tag | HW_SALT
    return rng_mode, tag


def draw_planes(rng_mode: str, seed: int, H: int, W1: int, *, step,
                tag: int, row0=0, device="cpu"):
    """The k = accept_bits(rng_mode) random bit-plane words of one (H, W1)
    color tile, as a list of (H, W1) int64 tensors. Plane z is lanes
    [z*W1, (z+1)*W1) of the mode's (H, k*W1) draw block under the
    ordinary counter layout (the port of pallas_packed._draw_plane_list;
    hw: salted Philox-10, pallas_bit1.py's off-TPU hw stream)."""
    k = accept_bits(rng_mode)
    rng_mode, tag = draw_mode(rng_mode, tag)
    draws = counter_color_draws(rng_mode, seed, H, k * W1, step=step,
                                tag=tag, row0=row0, row_stride=k * W1,
                                device=device)
    return [draws[:, z * W1:(z + 1) * W1] for z in range(k)]


def bitserial_lt_planes(planes, t4k: int, t8k: int):
    """(lt4, lt8, coin) words: bit set where the k-bit uniform assembled
    LSB-first from `planes` is below t4k / t8k; coin is plane 0 (the greedy
    e == 2 coin). The strict compare runs over the planes as
    a' = t_z ? (~u | a) : (~u & a) from a = 0, which is what the JAX
    helper's folded chains compute."""
    a4 = a8 = torch.zeros_like(planes[0])
    for z, u in enumerate(planes):
        nu = u ^ MASK
        a4 = (nu | a4) if (t4k >> z) & 1 else (nu & a4)
        a8 = (nu | a8) if (t8k >> z) & 1 else (nu & a8)
    return a4, a8, planes[0]


def bitserial_field_flip(planes, me, n0, n1, n2, tvals10, always10: int):
    """Flip words of the 10-class external-field accept
    (ising.field_kbit_thresholds): classes in `always10` flip; class
    b*5 + n flips where v < tvals10[b*5 + n]. One strict less-than chain
    with a per-spin threshold: lt' = (T_z & ~u) | (~(T_z ^ u) & lt), T_z
    the OR of the classes whose threshold has bit z set."""
    notme = me ^ MASK
    n_eq = ((n2 | n1 | n0) ^ MASK,        # n == 0
            ((n2 | n1) ^ MASK) & n0,      # n == 1
            ((n2 | n0) ^ MASK) & n1,      # n == 2
            n1 & n0,                      # n == 3
            n2)                           # n == 4
    classes = [(me if c >= 5 else notme) & n_eq[c % 5] for c in range(10)]
    always = torch.zeros_like(me)
    stoch = []
    for c, m in enumerate(classes):
        if (always10 >> c) & 1:
            always = always | m
        elif tvals10[c]:
            stoch.append((m, tvals10[c]))
    lt = torch.zeros_like(me)
    for z, u in enumerate(planes):
        T = torch.zeros_like(me)
        for m, t in stoch:
            if (t >> z) & 1:
                T = T | m
        lt = (T & (u ^ MASK)) | ((T ^ u ^ MASK) & lt)
    return always | lt


def _rotl(x, r: int):
    """Rotate int64-held uint32 words left by r bits."""
    return ((x << r) & MASK) | (x >> (32 - r))


def _lane_left(x, group: int = 1):
    """Word plane of compact column c - 1, periodic: lane j - 1, and at
    lane 0 the last word one column group over: `group` bits, 1 for bit1's
    words, 4 for packed's fields (x: int64 holding uint32)."""
    return torch.cat([_rotl(x[:, -1:], group), x[:, :-1]], 1)


def _lane_right(x, group: int = 1):
    """Word plane of compact column c + 1, periodic."""
    return torch.cat([x[:, 1:], _rotl(x[:, :1], 32 - group)], 1)


def _odd_column(H: int, color: int, device):
    """(H, 1) mask of the rows where this color's sites sit on odd
    full-lattice columns (black on odd rows, white on even rows): there
    the off-column neighbour is to the right, elsewhere to the left."""
    odd = (torch.arange(H, device=device) % 2 == 1)[:, None]
    return odd if color == BLACK else ~odd


def _off_column(src, color: int, csl: int | None = None, group: int = 1):
    """Word plane of each site's off-column in-row neighbor. Periodic: at
    the row's first / last lane the neighbor is the word one column group
    (`group` bits) over. With replicas of csl compact columns (csl divides
    W1, so column c % csl == lane % csl in every group), the neighbour
    wraps inside the replica at its edge lanes, with no rotation."""
    H, W1 = src.shape
    if csl is None:
        left, right = _lane_left(src, group), _lane_right(src, group)
    else:
        lane = torch.arange(W1, device=src.device)[None, :]
        left = torch.where(lane % csl == 0, torch.roll(src, 1 - csl, 1),
                           torch.roll(src, 1, 1))
        right = torch.where(lane % csl == csl - 1,
                            torch.roll(src, csl - 1, 1),
                            torch.roll(src, -1, 1))
    return torch.where(_odd_column(H, color, src.device), right, left)


def split_link_planes(links, color: int):
    """This color's (j_up, j_dn, j_same, j_off) flag words, projected from
    the parity-split link store (vE, vO, hE, hO) of one periodic lattice
    (int64 holding uint32): vE / hE hold the v / h link flags of the sites
    on even full-lattice columns, vO / hO of those on odd ones. A site on
    an odd column takes vO and its right link hO; on an even column vE and
    its left link, which is hO of compact column c - 1; its same-column
    link is hE either way."""
    vE, vO, hE, hO = links
    p = _odd_column(vE.shape[0], color, vE.device)
    j_dn = torch.where(p, vO, vE)
    j_up = torch.where(p, torch.roll(vO, 1, 0), torch.roll(vE, 1, 0))
    j_off = torch.where(p, hO, _lane_left(hO))
    return j_up, j_dn, hE, j_off


def bit1_sweep_reference(dst, src, src_up, src_dn, thr, row0, step,
                         jplanes=None, *, color: int, seed: int,
                         rng_mode: str, greedy: bool, t4k: int = 0,
                         t8k: int = 0, tvals10=None, always10: int = 0,
                         split_links: bool = False, csl: int | None = None,
                         ysl: int | None = None):
    """One color half-sweep in plain torch: the new (H, W1) int32 dst.

    dst/src are this color's and the other color's (H, W1) words; src_up /
    src_dn the (1, W1) rows above and below the slab; thr the (10,) uint32
    threshold table (the u32 modes read entries 7, 8, 9); row0 the slab's
    global first row. The bit-plane modes (accept_bits(rng_mode) > 0) read
    the k-bit thresholds (t4k, t8k) instead, or with an external field the
    10-class table (tvals10, always10), which also covers T <= 0.

    jplanes: quenched disorder as four (H, W1) word planes, either this
    color's (j_up, j_dn, j_same, j_off) flags, or with split_links the
    parity-split link store (vE, vO, hE, hO) of one periodic lattice; the
    flags are XORed into the four neighbour words before the count. csl /
    ysl: sub-lattice replicas of csl compact columns (dividing W1) and ysl
    rows (dividing H): the neighbours wrap inside each replica, and src_up
    / src_dn are not read. Inputs are not modified.
    """
    me, s = _u(dst), _u(src)
    if ysl is None:
        up = torch.cat([_u(src_up), s[:-1]])
        dn = torch.cat([s[1:], _u(src_dn)])
    else:
        from .xla_ref import make_row_wrap_maps
        up_idx, dn_idx = make_row_wrap_maps(s.shape[0], ysl, device=s.device)
        up, dn = s[up_idx], s[dn_idx]
    off = _off_column(s, color, csl)
    same = s
    if jplanes is not None:
        links = [_u(p) for p in jplanes]
        if split_links:
            links = split_link_planes(links, color)
        up, dn = up ^ links[0], dn ^ links[1]
        same, off = same ^ links[2], off ^ links[3]
    H, W1 = dst.shape
    tag = TAG_SWEEP | color
    if accept_bits(rng_mode):
        planes = draw_planes(rng_mode, seed, H, W1, step=step, tag=tag,
                             row0=row0, device=dst.device)
        if tvals10 is not None:
            flip = bitserial_field_flip(
                planes, me, *_neighbor_adder(up, dn, same, off), tvals10,
                always10)
            return _s(me ^ flip)
        p4, p8, p0 = bitserial_lt_planes(planes, t4k, t8k)
    else:
        draws = counter_color_draws(rng_mode, seed, H, SPW * W1, step=step,
                                    tag=tag, row0=row0, device=dst.device)
        p4 = _accept_plane(draws, thr[8])
        p8 = _accept_plane(draws, thr[9])
        p0 = _accept_plane(draws, thr[7]) if greedy else None
    ge3, ge4, eq2 = _neighbor_class_masks(me, up, dn, same, off)
    if greedy:
        flip = ((~ge3 & ~eq2) | (eq2 & p0) | (ge3 & ~ge4 & p4)
                | (ge4 & p8))
    else:
        flip = ~ge3 | (ge3 & ~ge4 & p4) | (ge4 & p8)
    return _s(me ^ flip)


def _check_words(name, t, shape, device, fn: str = "bit1_sweep"):
    if t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{fn}: {name} must be torch.int32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def overlaps(a, b) -> bool:
    """Whether the storage of contiguous tensors a and b shares a byte."""
    a0, b0 = a.data_ptr(), b.data_ptr()
    return (a0 < b0 + b.numel() * b.element_size()
            and b0 < a0 + a.numel() * a.element_size())


def _cuda_stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


_FAMILY_CODE = {"philox": 0, "threefry": 1, "chacha": 2}


def launch_args(rng_mode: str, seed: int, step, color: int):
    """(tag, k0, k1, family code, rounds) of a sweep kernel's launch."""
    mode, tag = draw_mode(rng_mode, TAG_SWEEP | color)
    family, rounds = parse_rng_mode(mode)
    if family == "threefry":
        k0, k1 = threefry_stream_key(seed, step, tag)
    else:
        k0, k1 = key_from_seed(seed)
    return tag, k0, k1, _FAMILY_CODE[family], rounds
ACCEPT_METROPOLIS, ACCEPT_GREEDY, ACCEPT_FIELD = 0, 1, 2


LINKS_NONE, LINKS_JPLANES, LINKS_SPLIT = 0, 1, 2


def _check_geometry(H: int, W1: int, jplanes, split_links, csl, ysl):
    if jplanes is not None and len(jplanes) != 4:
        raise ValueError(f"bit1_sweep: jplanes must be 4 word planes, got "
                         f"{len(jplanes)}")
    if split_links and jplanes is None:
        raise ValueError("bit1_sweep: split_links needs the link store as "
                         "jplanes")
    if split_links and (csl is not None or ysl is not None):
        raise ValueError("bit1_sweep: split links are the periodic "
                         "single-lattice path; replicas take per-color "
                         "J planes")
    _check_replicas("bit1_sweep", H, W1, "W1", csl, ysl)


def _check_replicas(fn: str, H: int, W: int, wname: str, csl, ysl):
    """csl / ysl, where given, are positive ints dividing W / H."""
    if csl is not None and not (isinstance(csl, int) and 0 < csl
                                and W % csl == 0):
        raise ValueError(f"{fn}: csl ({csl!r}) must divide {wname} ({W})")
    if ysl is not None and not (isinstance(ysl, int) and 0 < ysl
                                and H % ysl == 0):
        raise ValueError(f"{fn}: ysl ({ysl!r}) must divide H ({H})")


def bit1_sweep(dst, src, src_up, src_dn, thr, row0, step, jplanes=None, *,
               color: int, seed: int, rng_mode: str, greedy: bool,
               t4k: int = 0, t8k: int = 0, tvals10=None, always10: int = 0,
               split_links: bool = False, csl: int | None = None,
               ysl: int | None = None):
    """One color half-sweep of dst, in place; returns dst.

    On CUDA tensors this launches a kernel of csrc/ (a thread walks a
    band of rows down its word column):
    bit1_sweep.cu in the u32 modes, bit1_planes.cu in the bit-plane modes;
    a launch that fails raises. On CPU tensors it runs
    bit1_sweep_reference. Arguments as for bit1_sweep_reference. Counts
    launches in bit1_sweep.launches.
    """
    with profiling.launch(bit1_sweep, dst):
        H, W1 = tuple(dst.shape)
        device = dst.device
        _check_words("dst", dst, (H, W1), device)
        _check_words("src", src, (H, W1), device)
        _check_words("src_up", src_up, (1, W1), device)
        _check_words("src_dn", src_dn, (1, W1), device)
        _check_geometry(H, W1, jplanes, split_links, csl, ysl)
        for z, p in enumerate(jplanes or ()):
            _check_words(f"jplanes[{z}]", p, (H, W1), device)
        if color not in (BLACK, WHITE):
            raise ValueError("bit1_sweep: color must be 0 or 1, got "
                             f"{color!r}")
        kbits = accept_bits(rng_mode)
        if tvals10 is not None and not kbits:
            raise ValueError("bit1_sweep: the external-field accept needs a "
                             f"bit-plane rng mode or hw, not {rng_mode!r}")
        if device.type == "cpu":
            dst.copy_(bit1_sweep_reference(
                dst, src, src_up, src_dn, thr, row0, step, jplanes,
                color=color,
                seed=seed, rng_mode=rng_mode, greedy=greedy, t4k=t4k, t8k=t8k,
                tvals10=tvals10, always10=always10, split_links=split_links,
                csl=csl, ysl=ysl))
            return dst
        if device.type != "cuda":
            raise ValueError(f"bit1_sweep runs on cuda or cpu, not {device}")
        if any(overlaps(dst, t)
               for t in (src, src_up, src_dn, *(jplanes or ()))):
            raise ValueError("bit1_sweep updates dst in place: dst must not "
                             "overlap src, src_up, src_dn or a J plane")
        tag, k0, k1, family, rounds = launch_args(rng_mode, seed, step, color)
        ptrs = (dst.data_ptr(), src.data_ptr(), src_up.data_ptr(),
                src_dn.data_ptr(), H, W1, int(row0) & MASK, int(step) & MASK,
                tag, color)
        links = tuple(p.data_ptr() for p in jplanes) if jplanes else (0,) * 4
        mode = (LINKS_NONE if jplanes is None
                else LINKS_SPLIT if split_links else LINKS_JPLANES)
        geometry = (*links, mode, csl or 0, ysl or 0)
        lib, _ = kernel_lib.load()
        if kbits:
            if tvals10 is not None:
                accept, tvals10 = ACCEPT_FIELD, tuple(tvals10)
            else:
                accept = ACCEPT_GREEDY if greedy else ACCEPT_METROPOLIS
            code = lib.bit1_planes_launch(
                *ptrs, k0, k1, family, rounds, kbits, accept,
                accept_table(kbits, t4k, t8k, tvals10, always10), *geometry,
                _cuda_stream(device))
            kernel_lib.check(lib, code, "bit1_planes launch")
        else:
            code = lib.bit1_sweep_launch(
                *ptrs, int(thr[7]), int(thr[8]), int(thr[9]), k0, k1,
                family, rounds, int(bool(greedy)), *geometry,
                _cuda_stream(device))
            kernel_lib.check(lib, code, "bit1_sweep launch")
        bit1_sweep.launches += 1
        return dst


bit1_sweep.launches = 0


def bit1_decode(black, white, chunk: int = 8192):
    """(black, white) (H, W1) int32 word planes -> their (H, 32*W1) uint8
    bit planes, in unpack_bits1's layout.

    On CUDA tensors one launch of csrc/bit1_decode.cu decodes both planes
    on their device's current stream, with that device made current (a
    slab's planes may lie on another GPU than the current one); a launch
    that fails raises. On CPU tensors it returns unpack_rows of each,
    `chunk` rows at a time. Counts launches in bit1_decode.launches.
    """
    with profiling.launch(bit1_decode, black):
        if len(black.shape) != 2:
            raise ValueError("bit1_decode: black must be an (H, W1) word "
                             f"plane, got shape {tuple(black.shape)}")
        H, W1 = tuple(black.shape)
        device = black.device
        _check_words("black", black, (H, W1), device, "bit1_decode")
        _check_words("white", white, (H, W1), device, "bit1_decode")
        if device.type == "cpu":
            return unpack_rows(black, chunk), unpack_rows(white, chunk)
        if device.type != "cuda":
            raise ValueError(f"bit1_decode runs on cuda or cpu, not {device}")
        out = tuple(torch.empty((H, SPW * W1), dtype=torch.uint8,
                                device=device) for _ in range(2))
        if H and W1:
            lib, _ = kernel_lib.load()
            with torch.cuda.device(device):
                code = lib.bit1_decode_launch(
                    black.data_ptr(), white.data_ptr(), out[0].data_ptr(),
                    out[1].data_ptr(), H, W1, _cuda_stream(device))
            kernel_lib.check(lib, code, "bit1_decode launch")
            bit1_decode.launches += 1
        return out


bit1_decode.launches = 0


class Bit1Backend:
    """Backend adapter: 1 bit per spin, bit-sliced sweep."""

    name = "bit1"
    bytes_per_spin = 0.125

    def __init__(self, cfg):
        self.csl = self.ysl = None
        if cfg.xsl is not None:
            # The JAX backend's replica fences (pallas_bit1.py:584-601):
            # csl = xsl/2 must divide W1 = ncols/64, so the wrap never
            # crosses a bit group. (Its ysl % 8 keeps a TPU block height;
            # the port keeps it so that both packages take the same runs.)
            csl = cfg.xsl // 2
            W1 = cfg.ncols // (2 * SPW)
            if W1 % csl:
                raise ValueError(
                    f"bit1 replica mode needs xsl/2 ({csl}) to divide "
                    f"ncols/64 ({W1}); use xsl <= ncols/32 or the packed "
                    "backend (which admits xsl up to ncols/8)")
            if cfg.ysl % 8:
                raise ValueError("bit1 replica mode needs ysl % 8 == 0")
            self.csl, self.ysl = csl, cfg.ysl
        self.cfg = cfg
        # One device without replicas: the kernel projects each color's
        # flags from the parity-split link store itself (2 bits per site
        # resident instead of 4 + 2). The driver turns split_links on when
        # it passes that store as jplanes (build_disorder).
        self.split_links_capable = (cfg.ndev == 1 and cfg.xsl is None
                                    and cfg.ncols % 64 == 0)
        self.split_links = False
        # The JAX backend's interface (pallas_bit1.py:608-625): the mode's
        # plane count, the bit-serial accept's k (HW_KBITS unless a "...b"
        # mode fixes it; unused in the u32 modes), and whether the accept
        # takes k-bit thresholds of the temperature (hw, "...b").
        self.kplanes = plane_bits(cfg.rng)
        self.accept_bits = self.kplanes or HW_KBITS
        self.temp_static = accept_bits(cfg.rng) > 0
        self.retune(cfg.temperature, cfg.field)

    def retune(self, temperature: float, field: float):
        """Take a new temperature or field (Simulation.set_temperature /
        set_field): the greedy quench at T <= 0 and, in the bit-plane
        modes and hw, the k-bit thresholds, computed here once on the
        host rather than on every launch (12-21 us each on the host)."""
        self.temperature, self.field = temperature, field
        self.greedy = temperature <= 0
        self.accept = plane_accept_args(self.cfg.rng, temperature, field)

    def encode(self, black_bits, white_bits):
        return pack_bits1(black_bits), pack_bits1(white_bits)

    def decode(self, black_store, white_store, chunk: int = 8192):
        """uint8 bit planes (pallas_bit1.py:648): bit1_decode, one kernel
        launch on the card, unpacked in row chunks on the CPU."""
        return bit1_decode(black_store, white_store, chunk)

    def storage_pack_supported(self, black_store) -> bool:
        """Whether the checkpoint can take its bytes straight from the
        words (W1 % 8 == 0); the decode path writes the same bytes
        otherwise."""
        return black_store.shape[1] % 8 == 0

    def pack_storage_rows(self, black_store, white_store, r0: int, r1: int):
        """Rows [r0, r1) of both planes as checkpoint bytes, straight from
        the words; None where W1 % 8 != 0."""
        if not self.storage_pack_supported(black_store):
            return None
        return (words_to_packed_rows(black_store[r0:r1]),
                words_to_packed_rows(white_store[r0:r1]))

    def encode_packed_rows(self, pb, pw):
        """Checkpoint bytes (numpy or a tensor) -> storage words on the
        config's device, without a byte plane; None where W1 % 8 != 0."""
        W1 = self.cfg.ncols // (2 * SPW)
        if W1 % 8:
            return None
        dev = torch.device(self.cfg.device)
        return tuple(packed_rows_to_words(torch.as_tensor(p).to(dev), W1)
                     for p in (pb, pw))

    def corr_rows(self, black_store, white_store, corr_len: int,
                  tail=None):
        """Per-(offset, row) correlation sums on the words (no decode);
        tail: a row slab's following rows."""
        from ..observables import bit1_correlation_row_sums
        return bit1_correlation_row_sums(black_store, white_store, corr_len,
                                         tail=tail)

    def row_up_counts(self, black_store, white_store):
        """Per-row up-spin counts by popcount on the words."""
        from ..observables import word_row_up_counts
        return word_row_up_counts(black_store, white_store)

    def energy_rows(self, black_store, white_store, tail=None):
        """Per-row exact bond sums on the words (no decode); tail: a row
        slab's following row."""
        from ..observables import bit1_energy_row_sums
        return bit1_energy_row_sums(black_store, white_store, tail=tail)

    def energy_rows_disordered(self, black_store, white_store, links_words,
                               tail=None):
        """Disordered bond sums on the words: links_words is the driver's
        parity-split (vE, vO, hE, hO) link store."""
        from ..observables import bit1_energy_row_sums
        return bit1_energy_row_sums(black_store, white_store,
                                    links_words=links_words, tail=tail)

    def col_up_counts(self, black_store, white_store):
        """Per-column up counts on the words (no decode): the column twin
        of row_up_counts."""
        from ..observables import bit1_col_up_counts
        return bit1_col_up_counts(black_store, white_store)

    def overlap_neq_rows(self, b1, w1, b2, w2):
        """Per-row differing-spin counts between two states' words (XOR
        and popcount): the replica overlap's integer core."""
        from ..observables import word_overlap_neq_rows
        return word_overlap_neq_rows(b1, w1, b2, w2)

    def encode_jplanes(self, planes):
        """(j_up, j_dn, j_same, j_off) uint8 planes -> bit1 word planes."""
        return tuple(pack_bits1(p) for p in planes)

    def update_color(self, dst, src, *, color, thr10, step, row0=0,
                     src_up=None, src_dn=None, jplanes=None):
        return bit1_sweep(dst, src, src_up, src_dn, thr10, row0, step,
                          jplanes, color=color, seed=self.cfg.seed,
                          rng_mode=self.cfg.rng, greedy=self.greedy,
                          split_links=self.split_links
                          and jplanes is not None,
                          csl=self.csl, ysl=self.ysl, **self.accept)
