"""Packed tier (backend "packed"): storage, plain sweep, CUDA sweep, backend.

The port of ``ising_tpu/ops/pallas_packed.py`` and its TPU kernel
``_packed_kernel`` (with ``_metropolis_block`` and ``_accept_and_flip``):
4 bits per spin, so that the neighbour counts of eight spins come from
whole-word adds, in the u32-draw rng modes (hw as salted Philox-10, the
stream the JAX package substitutes off the TPU), at T > 0, in the greedy
T <= 0 quench and with the 10-entry external-field table, with the J word
of quenched +-J disorder and the sub-lattice replica wraps.

Storage: a compact color plane (Y, C = X/2) is held as (Y, W = C/8)
torch.int32 words carrying the same 32 bits as the JAX package's uint32
words; field z (bits 4z..4z+3) of word j holds the spin at compact column
z*W + j in its low bit. The J word carries the four direction flags of a
site in bits 0..3 of its field: up, dn, same, off.

``packed_sweep`` launches the hand-written kernel ``csrc/packed_sweep.cu``
on CUDA tensors and runs ``packed_sweep_reference``, the same function in
plain torch, on CPU tensors. The plain version works on int64 copies of
the words (values in [0, 2^32)), because torch's int32 right shift is
arithmetic and its uint32 lacks shifts and compares on the CPU.

The JAX package's fused both-colors step (``ISING_TPU_FUSED=1|2``, TPU
kernel rows 3 and 4) is not ported: the backend refuses the variable.
"""

from __future__ import annotations

import os

import torch

from ..config import not_ported
from ..constants import BLACK, WHITE
from ..rng import (MASK, TAG_SWEEP, counter_color_draws, parse_rng_mode,
                   plane_bits)
from . import kernel_lib
from .bit1 import (ACCEPT_FIELD, ACCEPT_GREEDY, ACCEPT_METROPOLIS,
                   _check_replicas, _check_words, _cuda_stream, _off_column,
                   _s, _u, draw_mode, launch_args, overlaps, unpack_rows)

FIELDS = 8           # spins per word
M1 = 0x11111111      # the spin bit of every field
M8 = 0x88888888      # bit 3 of every field
FUSED_ITEM = 16      # ROADMAP item of the fused packed step (rows 3, 4)


def pack_bits(bits):
    """(Y, C) uint8 bit plane -> (Y, W = C/8) int32 packed words."""
    Y, C = bits.shape
    g = bits.reshape(Y, FIELDS, C // FIELDS)
    out = torch.zeros((Y, C // FIELDS), dtype=torch.int32, device=bits.device)
    for z in range(FIELDS):
        out |= g[:, z, :].to(torch.int32) << (4 * z)
    return out


def unpack_bits(packed, out=None):
    """(Y, W) int32 packed words -> (Y, 8W) uint8 bit plane, written into
    `out` when given. One field at a time, shifted in int32 (the low bit of
    a field is below the sign bits an arithmetic shift brings in): the only
    transient is one (Y, W) int32 plane."""
    Y, W = packed.shape
    if out is None:
        out = torch.empty((Y, FIELDS * W), dtype=torch.uint8,
                          device=packed.device)
    view = out.view(Y, FIELDS, W)
    for z in range(FIELDS):
        view[:, z, :] = (packed >> (4 * z)) & 1
    return out


def pack_jplanes(jplanes):
    """4 x (Y, C) uint8 direction-flag planes (up, dn, same, off) -> one
    (Y, W) int32 word with the flags in bits 0..3 of each field. Assembled
    in int64: field 7's off flag is bit 31."""
    out = sum(_u(pack_bits(p)) << k for k, p in enumerate(jplanes))
    return _s(out)


def packed_sweep_reference(dst, src, src_up, src_dn, thr10, row0, step,
                           jword=None, *, color: int, seed: int,
                           rng_mode: str, greedy: bool = False,
                           full_table: bool = False, csl: int | None = None,
                           ysl: int | None = None):
    """One color half-sweep in plain torch: the new (H, W) int32 dst.

    dst/src are this color's and the other color's (H, W) words; src_up /
    src_dn the (1, W) rows above and below the slab; thr10 the (10,) uint32
    table thr10[b*5 + n]; row0 the slab's global first row. greedy: the
    T <= 0 quench (e == 2 flips on thr10[7]); full_table: the external
    field's 10-entry accept (which covers T <= 0 itself). jword: the (H, W)
    J words of this color. csl / ysl: replicas of csl words (dividing W)
    and ysl rows (dividing H); src_up / src_dn are then not read. The word
    arithmetic is pallas_packed._accept_and_flip's, on any 32-bit words,
    not only on valid packed ones. Inputs are not modified.
    """
    me, s = _u(dst), _u(src)
    H, W = dst.shape
    if ysl is None:
        up = torch.cat([_u(src_up), s[:-1]])
        dn = torch.cat([s[1:], _u(src_dn)])
    else:
        from .xla_ref import make_row_wrap_maps
        up_idx, dn_idx = make_row_wrap_maps(H, ysl, device=s.device)
        up, dn = s[up_idx], s[dn_idx]
    # the row's ends wrap one field group (4 bits) over
    off = _off_column(s, color, csl, group=4)
    same = s
    if jword is not None:
        jw = _u(jword)
        up, dn = up ^ (jw & M1), dn ^ ((jw >> 1) & M1)
        same, off = same ^ ((jw >> 2) & M1), off ^ ((jw >> 3) & M1)
    nsum = (up + dn + same + off) & MASK
    m1 = me & M1
    mask = (m1 << 4) - m1
    e = (nsum & mask) | ((0x44444444 - nsum) & (mask ^ MASK))
    ge = {k: (e + (8 - k) * M1) & M8 for k in (1, 2, 3, 4)}
    mode, tag = draw_mode(rng_mode, TAG_SWEEP | color)
    draws = counter_color_draws(mode, seed, H, FIELDS * W, step=step,
                                tag=tag, row0=row0, device=dst.device)
    t = [int(x) for x in thr10]
    flip = torch.zeros_like(me)
    if full_table:
        for z in range(FIELDS):
            d = draws[:, z * W:(z + 1) * W]
            # own bit 1 takes t[5 + e], own bit 0 t[4 - e]; e >= k raises
            # both chains one class, k = 1..4 in turn
            t_up = torch.full_like(d, t[5])
            t_dn = torch.full_like(d, t[4])
            for k in (1, 2, 3, 4):
                is_ge = ((ge[k] >> (4 * z + 3)) & 1) == 1
                t_up = torch.where(is_ge, t[5 + k], t_up)
                t_dn = torch.where(is_ge, t[4 - k], t_dn)
            tsel = torch.where(((me >> (4 * z)) & 1) == 1, t_up, t_dn)
            flip |= (d <= tsel).to(torch.int64) << (4 * z)
        return _s(me ^ flip)
    p0 = torch.zeros_like(me)
    p4 = torch.zeros_like(me)
    p8 = torch.zeros_like(me)
    for z in range(FIELDS):
        d = draws[:, z * W:(z + 1) * W]
        p4 |= (d <= t[8]).to(torch.int64) << (4 * z)
        p8 |= (d <= t[9]).to(torch.int64) << (4 * z)
        if greedy:
            p0 |= (d <= t[7]).to(torch.int64) << (4 * z)
    g3, g4 = ge[3] >> 3, ge[4] >> 3
    n3, n4 = g3 ^ M1, g4 ^ M1          # ~g3, ~g4 on the spin bits
    if greedy:
        g2 = ge[2] >> 3
        flip = (g2 ^ M1) | (g2 & ((g4 & p8) | (n4 & g3 & p4) | (n4 & n3 & p0)))
    else:
        flip = n3 | (g3 & n4 & p4) | (g4 & p8)
    return _s(me ^ flip)


def packed_sweep(dst, src, src_up, src_dn, thr10, row0, step, jword=None, *,
                 color: int, seed: int, rng_mode: str, greedy: bool = False,
                 full_table: bool = False, csl: int | None = None,
                 ysl: int | None = None):
    """One color half-sweep of dst, in place; returns dst.

    On CUDA tensors this launches csrc/packed_sweep.cu (one thread per
    word, per pair of words in ChaCha); a launch that fails raises. On CPU
    tensors it runs packed_sweep_reference. Arguments as for
    packed_sweep_reference. Counts launches in packed_sweep.launches.
    """
    H, W = tuple(dst.shape)
    device = dst.device
    for name, t, shape in (("dst", dst, (H, W)), ("src", src, (H, W)),
                           ("src_up", src_up, (1, W)),
                           ("src_dn", src_dn, (1, W)),
                           ("jword", jword, (H, W))):
        if t is not None:
            _check_words(name, t, shape, device, "packed_sweep")
    _check_replicas("packed_sweep", H, W, "W", csl, ysl)
    if color not in (BLACK, WHITE):
        raise ValueError(f"packed_sweep: color must be 0 or 1, got {color!r}")
    family = parse_rng_mode(rng_mode)[0]
    if plane_bits(rng_mode):
        raise ValueError(f"packed_sweep draws u32 per spin; {rng_mode!r} is "
                         "a bit-plane mode")
    if family == "chacha" and W % 2:
        raise ValueError(f"packed_sweep: chacha needs an even W, got {W}")
    if len(thr10) != 10:
        raise ValueError(f"packed_sweep: thr10 has {len(thr10)} entries, "
                         "expected 10")
    if device.type == "cpu":
        dst.copy_(packed_sweep_reference(
            dst, src, src_up, src_dn, thr10, row0, step, jword, color=color,
            seed=seed, rng_mode=rng_mode, greedy=greedy,
            full_table=full_table, csl=csl, ysl=ysl))
        return dst
    if device.type != "cuda":
        raise ValueError(f"packed_sweep runs on cuda or cpu, not {device}")
    if any(overlaps(dst, t) for t in (src, src_up, src_dn)
           + (() if jword is None else (jword,))):
        raise ValueError("packed_sweep updates dst in place: dst must not "
                         "overlap src, src_up, src_dn or the J word")
    tag, k0, k1, family, rounds = launch_args(rng_mode, seed, step, color)
    accept = (ACCEPT_FIELD if full_table else
              ACCEPT_GREEDY if greedy else ACCEPT_METROPOLIS)
    lib, _ = kernel_lib.load()
    code = lib.packed_sweep_launch(
        dst.data_ptr(), src.data_ptr(), src_up.data_ptr(), src_dn.data_ptr(),
        H, W, int(row0) & MASK, int(step) & MASK, tag, color,
        kernel_lib.table10(thr10), k0, k1, family, rounds, accept,
        None if jword is None else jword.data_ptr(), csl or 0, ysl or 0,
        _cuda_stream(device))
    kernel_lib.check(lib, code, "packed_sweep launch")
    packed_sweep.launches += 1
    return dst


packed_sweep.launches = 0


class PackedBackend:
    """Backend adapter: 4-bit packed int32 storage, word-parallel sweep."""

    name = "packed"
    bytes_per_spin = 0.5

    def __init__(self, cfg):
        self.csl = self.ysl = None
        if plane_bits(cfg.rng):
            raise NotImplementedError(
                "bit-plane rng modes (...b) are implemented by the bit1 and "
                "xla backends (their storage matches the plane layout); use "
                "philox7/threefry13 here")
        if cfg.xsl is not None:
            # The JAX backend's replica fences (pallas_packed.py:904-919):
            # csl = xsl/2 must divide the word-group width W = ncols/16, and
            # ysl must be a multiple of 8 rows (a TPU block height there; the
            # port keeps it so that both packages take the same runs).
            csl = cfg.xsl // 2
            W = cfg.ncols // 16
            if W % csl:
                raise ValueError(
                    f"packed replica mode needs xsl/2 ({csl}) to divide "
                    f"ncols/16 ({W}); use xsl <= ncols/8 or the xla backend")
            if cfg.ysl % 8:
                raise ValueError("packed replica mode needs ysl % 8 == 0")
            self.csl, self.ysl = csl, cfg.ysl
        fused = os.environ.get("ISING_TPU_FUSED")
        if fused in ("1", "2"):
            # pallas_packed.py:961-1005 runs both colors in one kernel under
            # this variable; running the two-call path in its place would
            # pass off one kernel for another.
            raise not_ported(f"the fused packed step (ISING_TPU_FUSED={fused},"
                             " TPU kernel rows 3 and 4)", FUSED_ITEM)
        self.cfg = cfg
        self.retune(cfg.temperature, cfg.field)

    def retune(self, temperature: float, field: float):
        """Take a new temperature or field (Simulation.set_temperature /
        set_field): the greedy quench at T <= 0, and the full 10-entry table
        whenever a field is on (JAX driver.py:258-266, :291-300)."""
        self.temperature, self.field = temperature, field
        self.greedy = temperature <= 0
        self.full_table = field != 0.0

    def encode(self, black_bits, white_bits):
        return pack_bits(black_bits), pack_bits(white_bits)

    def decode(self, black_store, white_store, chunk: int = 8192):
        """uint8 bit planes, unpacked in row chunks (pallas_packed.py:945)."""
        return (unpack_rows(black_store, chunk, unpack_bits, FIELDS),
                unpack_rows(white_store, chunk, unpack_bits, FIELDS))

    def row_up_counts(self, black_store, white_store):
        """Per-row up-spin counts on the words, no decode."""
        from ..observables import packed_row_up_counts
        return packed_row_up_counts(black_store, white_store)

    def encode_jplanes(self, jplanes):
        """(j_up, j_dn, j_same, j_off) uint8 planes -> a 1-tuple of the J
        word, threaded by the driver like bit1's four planes."""
        return (pack_jplanes(jplanes),)

    def update_color(self, dst, src, *, color, thr10, step, row0=0,
                     src_up=None, src_dn=None, jplanes=None):
        return packed_sweep(dst, src, src_up, src_dn, thr10, row0, step,
                            None if jplanes is None else jplanes[0],
                            color=color, seed=self.cfg.seed,
                            rng_mode=self.cfg.rng, greedy=self.greedy,
                            full_table=self.full_table, csl=self.csl,
                            ysl=self.ysl)
