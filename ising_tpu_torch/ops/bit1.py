"""1-bit tier (backend "bit1"): storage, plain sweep, CUDA sweep, backend.

The port of ``ising_tpu/ops/pallas_bit1.py`` for the u32-draw path of its
TPU kernel ``_bit1_kernel`` (Philox and Threefry counter modes, T > 0 and
the greedy T <= 0 quench).

Storage: a compact color plane (Y, C = X/2) is held as (Y, W1 = C/32)
torch.int32 words carrying the same 32 bits as the JAX package's uint32
words; bit g of word j is the spin at compact column g*W1 + j.

``bit1_sweep`` launches the hand-written kernel ``csrc/bit1_sweep.cu`` on
CUDA tensors and runs ``bit1_sweep_reference``, the same function in plain
torch, on CPU tensors. The plain version works on int64 copies of the
words (values in [0, 2^32)), because torch's int32 right shift is
arithmetic and its uint32 lacks shifts and compares on the CPU.
"""

from __future__ import annotations

import torch

from ..config import not_ported
from ..constants import BLACK, WHITE
from ..rng import (MASK, PORTED_MODES, TAG_SWEEP, counter_color_draws,
                   key_from_seed, parse_rng_mode, threefry_stream_key,
                   unported_mode_item)
from . import kernel_lib

SPW = 32  # spins per word


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


def unpack_bits1(packed):
    """(Y, W1) int32 words -> (Y, 32*W1) uint8 bit plane."""
    Y, W1 = packed.shape
    shifts = torch.arange(SPW, device=packed.device)[:, None]
    planes = (_u(packed)[:, None, :] >> shifts) & 1
    return planes.to(torch.uint8).reshape(Y, SPW * W1)


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


def _off_column(src, color: int):
    """Word plane of each site's off-column in-row neighbor (left on even
    rows for black, right on odd rows; mirrored for white). At the row's
    first / last lane the neighbor is the word one bit over."""
    H, W1 = src.shape
    last, first = src[:, W1 - 1:], src[:, :1]
    left = torch.cat([((last << 1) & MASK) | (last >> 31), src[:, :-1]], 1)
    right = torch.cat([src[:, 1:], (first >> 1) | ((first << 31) & MASK)], 1)
    odd = (torch.arange(H, device=src.device) % 2 == 1)[:, None]
    if color == BLACK:
        return torch.where(odd, right, left)
    return torch.where(odd, left, right)


def bit1_sweep_reference(dst, src, src_up, src_dn, thr, row0, step, *,
                         color: int, seed: int, rng_mode: str,
                         greedy: bool):
    """One color half-sweep in plain torch: the new (H, W1) int32 dst.

    dst/src are this color's and the other color's (H, W1) words; src_up /
    src_dn the (1, W1) rows above and below the slab; thr the (10,) uint32
    threshold table (entries 7, 8, 9 are read); row0 the slab's global
    first row. Inputs are not modified.
    """
    me, s = _u(dst), _u(src)
    up = torch.cat([_u(src_up), s[:-1]])
    dn = torch.cat([s[1:], _u(src_dn)])
    ge3, ge4, eq2 = _neighbor_class_masks(me, up, dn, s,
                                          _off_column(s, color))
    H, W1 = dst.shape
    draws = counter_color_draws(rng_mode, seed, H, SPW * W1, step=step,
                                tag=TAG_SWEEP | color, row0=row0,
                                device=dst.device)
    p4 = _accept_plane(draws, thr[8])
    p8 = _accept_plane(draws, thr[9])
    if greedy:
        p0 = _accept_plane(draws, thr[7])
        flip = ((~ge3 & ~eq2) | (eq2 & p0) | (ge3 & ~ge4 & p4)
                | (ge4 & p8))
    else:
        flip = ~ge3 | (ge3 & ~ge4 & p4) | (ge4 & p8)
    return _s(me ^ flip)


def _check_words(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"bit1_sweep: {name} is on {t.device}, dst on {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"bit1_sweep: {name} must be torch.int32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"bit1_sweep: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"bit1_sweep: {name} must be contiguous")


def _overlaps(a, b) -> bool:
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + 4 * b.numel() and b0 < a0 + 4 * a.numel()


def _cuda_stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


_FAMILY_CODE = {"philox": 0, "threefry": 1}


def bit1_sweep(dst, src, src_up, src_dn, thr, row0, step, *, color: int,
               seed: int, rng_mode: str, greedy: bool):
    """One color half-sweep of dst, in place; returns dst.

    On CUDA tensors this launches csrc/bit1_sweep.cu (one thread per word)
    or raises; on CPU tensors it runs bit1_sweep_reference. Arguments as
    for bit1_sweep_reference. Counts launches in bit1_sweep.launches.
    """
    H, W1 = tuple(dst.shape)
    device = dst.device
    _check_words("dst", dst, (H, W1), device)
    _check_words("src", src, (H, W1), device)
    _check_words("src_up", src_up, (1, W1), device)
    _check_words("src_dn", src_dn, (1, W1), device)
    if rng_mode not in PORTED_MODES:
        raise not_ported(f"rng mode {rng_mode!r} on bit1",
                         unported_mode_item(rng_mode))
    if color not in (BLACK, WHITE):
        raise ValueError(f"bit1_sweep: color must be 0 or 1, got {color!r}")
    if device.type == "cpu":
        dst.copy_(bit1_sweep_reference(
            dst, src, src_up, src_dn, thr, row0, step, color=color,
            seed=seed, rng_mode=rng_mode, greedy=greedy))
        return dst
    if device.type != "cuda":
        raise ValueError(f"bit1_sweep runs on cuda or cpu, not {device}")
    if any(_overlaps(dst, t) for t in (src, src_up, src_dn)):
        raise ValueError("bit1_sweep updates dst in place: dst must not "
                         "overlap src, src_up or src_dn")
    family, rounds = parse_rng_mode(rng_mode)
    tag = TAG_SWEEP | color
    if family == "philox":
        k0, k1 = key_from_seed(seed)
    else:
        k0, k1 = threefry_stream_key(seed, step, tag)
    lib, _ = kernel_lib.load()
    code = lib.bit1_sweep_launch(
        dst.data_ptr(), src.data_ptr(), src_up.data_ptr(), src_dn.data_ptr(),
        H, W1, int(row0) & MASK, int(step) & MASK, tag, color,
        int(thr[7]), int(thr[8]), int(thr[9]), k0, k1,
        _FAMILY_CODE[family], rounds, int(bool(greedy)), _cuda_stream(device))
    kernel_lib.check(lib, code, "bit1_sweep launch")
    bit1_sweep.launches += 1
    return dst


bit1_sweep.launches = 0


class Bit1Backend:
    """Backend adapter: 1 bit per spin, bit-sliced sweep."""

    name = "bit1"
    bytes_per_spin = 0.125

    def __init__(self, cfg):
        self.cfg = cfg
        self.greedy = cfg.temperature <= 0

    def encode(self, black_bits, white_bits):
        return pack_bits1(black_bits), pack_bits1(white_bits)

    def decode(self, black_store, white_store):
        return unpack_bits1(black_store), unpack_bits1(white_store)

    def row_up_counts(self, black_store, white_store):
        """Per-row up-spin counts by popcount on the words."""
        from ..observables import word_row_up_counts
        return word_row_up_counts(black_store, white_store)

    def energy_rows(self, black_store, white_store):
        """Per-row exact bond sums on the words (no decode)."""
        from ..observables import bit1_energy_row_sums
        return bit1_energy_row_sums(black_store, white_store)

    def update_color(self, dst, src, *, color, thr10, step, row0=0,
                     src_up=None, src_dn=None, jplanes=None):
        if jplanes is not None:
            raise not_ported("quenched disorder on bit1", 4)
        return bit1_sweep(dst, src, src_up, src_dn, thr10, row0, step,
                          color=color, seed=self.cfg.seed,
                          rng_mode=self.cfg.rng, greedy=self.greedy)
