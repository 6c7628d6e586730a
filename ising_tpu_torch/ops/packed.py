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

The fused both-colors step (``ISING_TPU_FUSED=1|2``, the TPU kernels
``_fused_kernel`` and ``_fused_manual_kernel``): ``packed_fused_step`` and
``packed_fused_step_manual`` launch the two entry points of
``csrc/packed_fused.cu`` on CUDA tensors, one launch a step, out of place,
and run ``packed_fused_step_reference`` (two plain half-sweeps) on CPU
tensors. ``PackedBackend.fusable`` takes the JAX package's decision
(pallas_packed.py:974-989), with its block-row helpers copied here.
"""

from __future__ import annotations

import ctypes
import os

import torch

from ..constants import BLACK, WHITE
from ..rng import (MASK, TAG_SWEEP, counter_color_draws, parse_rng_mode,
                   plane_bits)
from ..utils import profiling
from . import kernel_lib
from .bit1 import (ACCEPT_FIELD, ACCEPT_GREEDY, ACCEPT_METROPOLIS,
                   _check_replicas, _check_words, _cuda_stream, _off_column,
                   _s, _u, draw_mode, launch_args, overlaps, unpack_rows)

FIELDS = 8           # spins per word
M1 = 0x11111111      # the spin bit of every field
M8 = 0x88888888      # bit 3 of every field


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


def _accept(greedy: bool, full_table: bool) -> int:
    """The kernels' accept variant: the field's table covers T <= 0."""
    return (ACCEPT_FIELD if full_table else
            ACCEPT_GREEDY if greedy else ACCEPT_METROPOLIS)


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
    with profiling.launch(packed_sweep, dst):
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
            raise ValueError("packed_sweep: color must be 0 or 1, got "
                             f"{color!r}")
        family = parse_rng_mode(rng_mode)[0]
        if plane_bits(rng_mode):
            raise ValueError(f"packed_sweep draws u32 per spin; {rng_mode!r} "
                             "is a bit-plane mode")
        if family == "chacha" and W % 2:
            raise ValueError(f"packed_sweep: chacha needs an even W, got {W}")
        if len(thr10) != 10:
            raise ValueError(f"packed_sweep: thr10 has {len(thr10)} entries, "
                             "expected 10")
        if device.type == "cpu":
            dst.copy_(packed_sweep_reference(
                dst, src, src_up, src_dn, thr10, row0, step, jword,
                color=color, seed=seed, rng_mode=rng_mode, greedy=greedy,
                full_table=full_table, csl=csl, ysl=ysl))
            return dst
        if device.type != "cuda":
            raise ValueError(f"packed_sweep runs on cuda or cpu, not {device}")
        if any(overlaps(dst, t) for t in (src, src_up, src_dn)
               + (() if jword is None else (jword,))):
            raise ValueError("packed_sweep updates dst in place: dst must not "
                             "overlap src, src_up, src_dn or the J word")
        tag, k0, k1, family, rounds = launch_args(rng_mode, seed, step, color)
        accept = _accept(greedy, full_table)
        lib, _ = kernel_lib.load()
        code = lib.packed_sweep_launch(
            dst.data_ptr(), src.data_ptr(), src_up.data_ptr(),
            src_dn.data_ptr(),
            H, W, int(row0) & MASK, int(step) & MASK, tag, color,
            kernel_lib.table10(thr10), k0, k1, family, rounds, accept,
            None if jword is None else jword.data_ptr(), csl or 0, ysl or 0,
            _cuda_stream(device))
        kernel_lib.check(lib, code, "packed_sweep launch")
        packed_sweep.launches += 1
        return dst


packed_sweep.launches = 0


def packed_fused_step_reference(black, white, thr10, row0, step, *,
                                seed: int, rng_mode: str,
                                greedy: bool = False,
                                full_table: bool = False):
    """One whole step in plain torch: (black', white') as two half-sweeps,
    black against white with the periodic wrap rows, then white against
    black'. New tensors; the inputs are not modified."""
    kw = dict(seed=seed, rng_mode=rng_mode, greedy=greedy,
              full_table=full_table)
    nb = packed_sweep_reference(black, white, white[-1:], white[:1], thr10,
                                row0, step, color=BLACK, **kw)
    nw = packed_sweep_reference(white, nb, nb[-1:], nb[:1], thr10, row0,
                                step, color=WHITE, **kw)
    return nb, nw


def _fused_step(fn, black, white, thr10, row0, step, *, seed, rng_mode,
                greedy, full_table, band_rows):
    """packed_fused_step and packed_fused_step_manual: fn is the wrapper,
    whose name is its C entry point's and whose counter is bumped."""
    with profiling.launch(fn, black):
        name = fn.__name__
        H, W = tuple(black.shape)
        device = black.device
        for arg, t in (("black", black), ("white", white)):
            _check_words(arg, t, (H, W), device, name)
        if plane_bits(rng_mode):
            raise ValueError(f"{name} draws u32 per spin; {rng_mode!r} is a "
                             "bit-plane mode")
        if parse_rng_mode(rng_mode)[0] == "chacha" and W % 2:
            raise ValueError(f"{name}: chacha needs an even W, got {W}")
        if len(thr10) != 10:
            raise ValueError(f"{name}: thr10 has {len(thr10)} entries, "
                             "expected 10")
        if band_rows is not None and band_rows < 1:
            raise ValueError(f"{name}: band_rows must be positive, got "
                             f"{band_rows}")
        if device.type == "cpu":
            return packed_fused_step_reference(
                black, white, thr10, row0, step, seed=seed, rng_mode=rng_mode,
                greedy=greedy, full_table=full_table)
        if device.type != "cuda":
            raise ValueError(f"{name} runs on cuda or cpu, not {device}")
        if overlaps(black, white):
            # the two-call path it equals updates black in place before white
            # reads it
            raise ValueError(f"{name}: black and white must not overlap")
        new_black, new_white = torch.empty_like(black), torch.empty_like(white)
        tag_b, kb0, kb1, family, rounds = launch_args(rng_mode, seed, step,
                                                      BLACK)
        tag_w, kw0, kw1, _, _ = launch_args(rng_mode, seed, step, WHITE)
        accept = _accept(greedy, full_table)
        lib, _ = kernel_lib.load()
        code = getattr(lib, name + "_launch")(
            black.data_ptr(), white.data_ptr(), new_black.data_ptr(),
            new_white.data_ptr(), H, W, int(row0) & MASK, int(step) & MASK,
            kernel_lib.table10(thr10), tag_b, kb0, kb1, tag_w, kw0, kw1,
            family, rounds, accept, band_rows or 0, _cuda_stream(device))
        kernel_lib.check(lib, code, f"{name} launch")
        fn.launches += 1
        return new_black, new_white


def packed_fused_step(black, white, thr10, row0, step, *, seed: int,
                      rng_mode: str, greedy: bool = False,
                      full_table: bool = False, band_rows: int | None = None):
    """One whole step, both colors: returns new (black', white') planes.

    On CUDA tensors this launches csrc/packed_fused.cu's
    packed_fused_step_launch (rows reach shared memory by plain loads);
    a launch that fails raises. On CPU tensors it runs
    packed_fused_step_reference. band_rows: the rows a CTA owns (None: one
    wave of CTAs); the result does not depend on it. Counts launches in
    packed_fused_step.launches.
    """
    return _fused_step(packed_fused_step, black, white, thr10, row0, step,
                       seed=seed, rng_mode=rng_mode, greedy=greedy,
                       full_table=full_table, band_rows=band_rows)


def packed_fused_step_manual(black, white, thr10, row0, step, *, seed: int,
                             rng_mode: str, greedy: bool = False,
                             full_table: bool = False,
                             band_rows: int | None = None):
    """As packed_fused_step, through packed_fused_step_manual_launch: rows
    reach shared memory by cp.async, a few rows ahead of the compute.
    Counts launches in packed_fused_step_manual.launches."""
    return _fused_step(packed_fused_step_manual, black, white, thr10, row0,
                       step, seed=seed, rng_mode=rng_mode, greedy=greedy,
                       full_table=full_table, band_rows=band_rows)


packed_fused_step.launches = 0
packed_fused_step_manual.launches = 0


def fused_band_rows(H: int, W: int, rng_mode: str, *, manual: bool,
                    greedy: bool = False, full_table: bool = False) -> int:
    """The band height (rows a CTA owns) that a fused launch with
    band_rows=None takes for an (H, W) plane on the current CUDA device:
    one wave of CTAs, from the kernel's occupancy."""
    _, _, _, family, rounds = launch_args(rng_mode, 0, 0, BLACK)
    accept = _accept(greedy, full_table)
    lib, _ = kernel_lib.load()
    band = ctypes.c_int(0)
    code = lib.packed_fused_step_band(H, W, family, rounds, accept,
                                      int(manual), ctypes.byref(band))
    kernel_lib.check(lib, code, "packed_fused_step_band")
    return band.value


def _pick_block_rows(nrows: int, target: int = 256) -> int:
    """The JAX package's row-block height (pallas_dense.py:48-55): the
    largest multiple-of-8 divisor of nrows up to target, else nrows."""
    best = nrows
    for by in range(8, min(nrows, target) + 1, 8):
        if nrows % by == 0:
            best = by
    return best


def _block_rows_for(nrows: int, width_words: int, rng_mode: str) -> int:
    """The JAX package's block height for a per-row width of width_words
    32-bit words (pallas_dense.py:58-72): tighter in Philox and ChaCha."""
    if parse_rng_mode(rng_mode)[0] in ("philox", "chacha"):
        target = max(8, min(256, (1 << 16) // max(1, width_words)))
    else:
        target = max(8, min(512, (1 << 21) // max(1, width_words)))
    return _pick_block_rows(nrows, target)


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

    def overlap_neq_rows(self, b1, w1, b2, w2):
        """Per-row differing-spin counts between two states' packed words:
        the XOR masked to each 4-bit field's spin bit."""
        from ..observables import PACKED_SPIN_MASK, word_overlap_neq_rows
        return word_overlap_neq_rows(b1, w1, b2, w2,
                                     field_mask=PACKED_SPIN_MASK)

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

    def fusable(self, nrows: int) -> bool:
        """Whether a step runs as one fused launch: the JAX package's rule
        (pallas_packed.py:974-983), ISING_TPU_FUSED in ("1", "2"), one
        device, no replicas, no disorder, and at least 3 row blocks of
        fused_block_rows."""
        if os.environ.get("ISING_TPU_FUSED") not in ("1", "2"):
            return False
        if (self.cfg.ndev != 1 or self.cfg.xsl is not None
                or self.cfg.j_prob is not None):
            return False
        return nrows // self.fused_block_rows(nrows) >= 3

    def fused_block_rows(self, nrows: int) -> int:
        """ISING_TPU_FUSED_BY, else the JAX package's block height
        (pallas_packed.py:985-989). The CUDA kernel runs bands of its own
        height; this height decides fusable, and under ISING_TPU_FUSED=2
        it is the JAX manual kernel's block. There a height that is odd or
        does not divide nrows gives a wrong lattice in the JAX package
        (ROADMAP.md §3): refused."""
        by = os.environ.get("ISING_TPU_FUSED_BY")
        if not by:
            return _block_rows_for(nrows, 4 * (self.cfg.ncols // 16),
                                   self.cfg.rng)
        rows = int(by)
        if os.environ.get("ISING_TPU_FUSED") == "2" and (
                rows < 1 or rows % 2 or nrows % rows):
            raise ValueError(
                f"ISING_TPU_FUSED_BY={by}: the fused step takes an even block "
                f"height that divides nrows ({nrows}); the JAX package's "
                "manual kernel computes a wrong lattice at this one")
        return rows

    def update_step(self, black, white, *, thr10, step):
        """Both colors of one step in one launch (pallas_packed.py:
        991-1005): the manual kernel under ISING_TPU_FUSED=2, else
        packed_fused_step; row 0 first. Fewer than 3 row blocks of the
        step's block height raise, as in the JAX package."""
        H, W = black.shape
        manual = os.environ.get("ISING_TPU_FUSED") == "2"
        rows = (self.fused_block_rows(H) if manual
                else _block_rows_for(H, 4 * W, self.cfg.rng))
        if H // rows < 3:
            raise ValueError("fused step needs at least 3 row blocks")
        fn = packed_fused_step_manual if manual else packed_fused_step
        return fn(black, white, thr10, 0, step, seed=self.cfg.seed,
                  rng_mode=self.cfg.rng, greedy=self.greedy,
                  full_table=self.full_table)
