"""Exact integer observables (plain torch).

The port of ``ising_tpu/observables.py``: per-row up-spin counts, bond
sums, the 2-point correlation's per-(offset, row) sums, the replica
overlap's per-row differing-spin counts and the per-column up counts of
the Fourier magnetizations, on uint8 bit planes (the xla backend's
storage) and straight on the bit1 backend's (Y, W1) words, without a
decode to byte planes; bond sums with or without quenched disorder links,
the correlation over the full lattice or inside sub-lattice replicas; up
counts and overlaps on the packed backend's words too; and the
per-replica |m| of replica mode. torch has no popcount, so words are
counted with the SWAR bit-count on int64 copies; every sum is exact in
int64.
"""

from __future__ import annotations

import numpy as np
import torch

from .constants import MAX_CORR_LEN
from .rng import MASK
from .utils import profiling


def row_up_counts(black, white):
    """Per-row up-spin counts (int64) of two (Y, C) uint8 bit planes."""
    return (black.sum(dim=1, dtype=torch.int64)
            + white.sum(dim=1, dtype=torch.int64))


def count_spins(black, white):
    """(n_up, n_down) of two uint8 bit planes, as exact Python ints."""
    ups = int(row_up_counts(black, white).sum())
    return ups, black.numel() + white.numel() - ups


def magnetization(black, white) -> float:
    """|m| in [0, 1]: |n_up - n_down| / N of two uint8 bit planes."""
    n_up, n_dn = count_spins(black, white)
    return abs(n_up - n_dn) / (black.numel() + white.numel())


def _row_block(Y: int, row_chunk: int) -> int:
    """The slab height: row_chunk or less, even, dividing Y."""
    R = min(Y, row_chunk)
    while Y % R:
        R -= 2
    return R


def _energy_block(e_ext, o_ext, vh=None, hh=None):
    """Per-row bond sums of R rows from R + 1 rows of column-parity planes,
    with optional (R, X) antiferro link flags vh / hh: each row has 2C
    horizontal and 2C vertical bonds, and the sum is the bond count less
    twice the antialigned ones."""
    R = e_ext.shape[0] - 1
    e0, o0 = e_ext[:R], o_ext[:R]
    hx1 = e0 ^ o0                              # (y, 2j) - (y, 2j+1)
    hx2 = o0 ^ torch.roll(e0, -1, dims=1)      # (y, 2j+1) - (y, 2j+2)
    vx1 = e0 ^ e_ext[1:]                       # vertical, even columns
    vx2 = o0 ^ o_ext[1:]                       # vertical, odd columns
    if hh is not None:
        hx1, hx2 = hx1 ^ hh[:, 0::2], hx2 ^ hh[:, 1::2]
    if vh is not None:
        vx1, vx2 = vx1 ^ vh[:, 0::2], vx2 ^ vh[:, 1::2]
    anti = (hx1 + hx2 + vx1 + vx2).sum(dim=1, dtype=torch.int64)
    return 4 * e0.shape[1] - 2 * anti


def energy_rows_via(decode_rows, nrows: int, links_rows=None,
                    row_chunk: int = 8192):
    """Per-row exact bond sums from storage via row callbacks:
    decode_rows(r, n) -> compact (black, white) uint8 planes of the
    wrapped rows [r, r+n); links_rows(r, n) -> (v, h) uint8 link rows
    [r, r+n), or None without disorder. Row-chunked, with one wrap row
    appended per slab, so no full-lattice decode is made."""
    R = _row_block(nrows, row_chunk)
    parts = []
    for r in range(0, nrows, R):
        e_ext, o_ext = _col_parity_planes(*decode_rows(r, R + 1))
        vh, hh = (None, None) if links_rows is None else links_rows(r, R)
        parts.append(_energy_block(e_ext, o_ext, vh, hh))
    return torch.cat(parts)


def energy_row_sums(black, white, v=None, h=None, row_chunk: int = 8192):
    """Per-row exact bond sums sum_x (J_r s s_right + J_d s s_down), int64,
    of two (Y, C) uint8 bit planes, with optional full-lattice antiferro
    link flags v / h (J = 1 - 2 flag); the Hamiltonian is minus their
    total."""
    links = None
    if v is not None or h is not None:
        links = lambda r, n: (None if v is None else v[r:r + n],
                              None if h is None else h[r:r + n])
    return energy_rows_via(
        lambda r, n: (_rows_wrap(black, r, n), _rows_wrap(white, r, n)),
        black.shape[0], links, row_chunk=row_chunk)


def energy_per_spin(black, white) -> float:
    """Internal energy per spin, E/N = -(1/N) sum_<ij> s_i s_j, of two
    uint8 bit planes."""
    rows = int(energy_row_sums(black, white).sum())
    return -float(rows) / (black.numel() + white.numel())


def popcount32(words, mask: int = MASK):
    """Per-element count of the bits under `mask` of int32 (or int64
    holding uint32) words."""
    x = words.to(torch.int64) & mask
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK) >> 24


PACKED_SPIN_MASK = 0x11111111  # the spin bit of each packed 4-bit field


def _popcount_rows(x, field_mask: int = MASK):
    return popcount32(x, field_mask).sum(dim=1)


def word_row_up_counts(black_w, white_w, field_mask: int = MASK,
                       row_chunk: int = 16384):
    """Per-row up-spin counts (int64) of the two color planes: the set bits
    of each word under field_mask (every bit for bit1's words)."""
    parts = [_popcount_rows(black_w[r:r + row_chunk], field_mask)
             + _popcount_rows(white_w[r:r + row_chunk], field_mask)
             for r in range(0, black_w.shape[0], row_chunk)]
    return torch.cat(parts)


def _field_sum_rows(x):
    """Per-row count of the packed spin bits: with at most one bit per
    4-bit field, the multiply sums the eight fields into the top field
    without a carry (each partial sum is at most 8)."""
    x = x.to(torch.int64) & PACKED_SPIN_MASK
    return (((x * PACKED_SPIN_MASK) & MASK) >> 28).sum(dim=1)


def packed_row_up_counts(black_w, white_w, row_chunk: int = 16384):
    """Per-row up-spin counts on the packed backend's words: the low bit of
    each 4-bit field, without unpacking."""
    parts = [_field_sum_rows(black_w[r:r + row_chunk])
             + _field_sum_rows(white_w[r:r + row_chunk])
             for r in range(0, black_w.shape[0], row_chunk)]
    return torch.cat(parts)


def _rows_wrap(x, r: int, n: int):
    """Rows [r, r+n) with periodic wrap (n may exceed the height)."""
    Y = x.shape[0]
    idx = torch.arange(r, r + n, device=x.device) % Y
    return x[idx]


def _rows_after(x, r: int, n: int, tail=None):
    """Rows [r, r+n) of x continued by `tail`, the rows that follow its
    last one (a row slab's neighbours below); without a tail, x's own
    periodic wrap."""
    if tail is None:
        return _rows_wrap(x, r, n)
    Y = x.shape[0]
    if r + n <= Y:
        return x[r:r + n]
    return torch.cat([x[r:], tail[:r + n - Y]])


def _col_parity_planes(black, white):
    """Compact color planes -> column-parity planes (E, O): E[y] holds the
    sites at even full-lattice columns, O[y] the odd ones."""
    odd = (torch.arange(black.shape[0], device=black.device) % 2 == 1)[:, None]
    return torch.where(odd, white, black), torch.where(odd, black, white)


def _rotr32(x, k: int):
    k %= 32
    if k == 0:
        return x
    return (x >> k) | ((x << (32 - k)) & MASK)


def _col_shift_words(x, d: int):
    """Word plane (int64 holding uint32) of the compact column + d
    neighbor, periodic: a bit rotation, a lane roll, one boundary select."""
    W1 = x.shape[1]
    db, dl = divmod(d, W1)
    lo = _rotr32(x, db)
    if dl == 0:
        return lo
    hi = _rotr32(x, db + 1)
    lane = torch.arange(W1, device=x.device)[None, :]
    return torch.where(lane < W1 - dl, torch.roll(lo, -dl, dims=1),
                       torch.roll(hi, -dl, dims=1))


def _bit1_energy_block(e_ext, o_ext, links=None):
    """Per-row bond sums of R rows, from R + 1 rows of E/O words; links:
    the (vE, vO, hE, hO) flag words of the R rows (parity-split, as the
    driver stores them), XORed into each bond class before the popcount."""
    R = e_ext.shape[0] - 1
    e0, o0 = e_ext[:R], o_ext[:R]
    ncols = 2 * 32 * e0.shape[1]
    bonds = [e0 ^ e_ext[1:R + 1], o0 ^ o_ext[1:R + 1],        # v: E, O
             e0 ^ o0, o0 ^ _col_shift_words(e0, 1)]           # h: E, O
    if links is not None:
        bonds = [b ^ (p.to(torch.int64) & MASK)
                 for b, p in zip(bonds, links)]
    anti = sum(_popcount_rows(b) for b in bonds)
    return 2 * ncols - 2 * anti


def bit1_energy_row_sums(black_w, white_w, links_words=None,
                         row_chunk: int = 8192, tail=None):
    """Per-row exact bond sums sum_bonds J s_i s_j (int64) on word storage;
    the Hamiltonian is minus their total. links_words: the parity-split
    (vE, vO, hE, hO) link flag words (driver.build_disorder's store), so
    the disordered energy runs without a decode too. tail: the (black,
    white) row after the last (a row slab's), else the periodic wrap."""
    Y = black_w.shape[0]
    R = _row_block(Y, row_chunk)
    tb, tw = (None, None) if tail is None else tail
    parts = []
    for r in range(0, Y, R):
        e_ext, o_ext = _col_parity_planes(
            _rows_after(black_w, r, R + 1, tb).to(torch.int64) & MASK,
            _rows_after(white_w, r, R + 1, tw).to(torch.int64) & MASK)
        links = (None if links_words is None
                 else [p[r:r + R] for p in links_words])
        parts.append(_bit1_energy_block(e_ext, o_ext, links))
    return torch.cat(parts)


def _tile_roll(x, shift: int, tile: int, axis: int):
    """Roll by `shift` within consecutive `tile`-sized groups along axis
    (the periodic wrap inside each sub-lattice replica)."""
    if tile == x.shape[axis]:
        return torch.roll(x, -shift, dims=axis)
    shp = x.shape
    new = shp[:axis] + (shp[axis] // tile, tile) + shp[axis + 1:]
    return torch.roll(x.reshape(new), -shift, dims=axis + 1).reshape(shp)


def _corr_block(e_ext, o_ext, corr_len: int, csl: int, ytile: int | None):
    """Per-(offset, row) correlation sums, (corr_len, R) int64, of one row
    slab of column-parity planes. Over the full lattice (ytile None) the
    slab carries corr_len wrap rows below its R rows and the vertical
    shift is a slice; in replica mode the slab is whole ysl-row replicas
    and both shifts wrap inside the tiles."""
    R = e_ext.shape[0] - (0 if ytile is not None else corr_len)
    e0, o0 = e_ext[:R], o_ext[:R]
    out = torch.empty((corr_len, R), dtype=torch.int64, device=e0.device)
    for d in range(1, corr_len + 1):
        # Horizontal offset d: even d pairs the same column parity, odd d
        # crosses parity with a half-offset split.
        dh = d // 2
        if d % 2 == 0:
            hx1 = e0 ^ _tile_roll(e0, dh, csl, 1)
            hx2 = o0 ^ _tile_roll(o0, dh, csl, 1)
        else:
            hx1 = e0 ^ _tile_roll(o0, dh, csl, 1)
            hx2 = o0 ^ _tile_roll(e0, dh + 1, csl, 1)
        if ytile is not None:
            vx1 = e0 ^ _tile_roll(e0, d, ytile, 0)
            vx2 = o0 ^ _tile_roll(o0, d, ytile, 0)
        else:
            vx1 = e0 ^ e_ext[d:R + d]
            vx2 = o0 ^ o_ext[d:R + d]
        anti = (hx1 + hx2 + vx1 + vx2).sum(dim=1, dtype=torch.int64)
        out[d - 1] = 4 * e0.shape[1] - 2 * anti
    return out


def correlation_rows_via(decode_rows, nrows: int,
                         corr_len: int = MAX_CORR_LEN,
                         row_chunk: int = 8192):
    """Per-(offset, row) correlation sums over the full lattice from
    storage via a row decoder: decode_rows(r, n) -> compact (black, white)
    uint8 planes of the wrapped rows [r, r+n). Row slabs with corr_len wrap
    rows each, so no full-lattice decode is made."""
    R = _row_block(nrows, row_chunk)
    parts = []
    for r in range(0, nrows, R):
        e_ext, o_ext = _col_parity_planes(*decode_rows(r, R + corr_len))
        parts.append(_corr_block(e_ext, o_ext, corr_len, e_ext.shape[1],
                                 None))
    return torch.cat(parts, dim=1)


def correlation_row_sums(black, white, corr_len: int = MAX_CORR_LEN,
                         xsl: int | None = None, ysl: int | None = None,
                         row_chunk: int = 8192):
    """Exact per-(offset, row) correlation sums, int64 of shape
    (corr_len, Y): entry [d-1, y] = sum_x [s(y,x) s(y,x+d) + s(y,x)
    s(y+d,x)], with periodic shifts over the full lattice, or wrapping
    inside xsl x ysl replicas when given."""
    Y, ch = black.shape
    if xsl is None and ysl is None:
        return correlation_rows_via(
            lambda r, n: (_rows_wrap(black, r, n), _rows_wrap(white, r, n)),
            Y, corr_len, row_chunk=row_chunk)
    # Replica mode: slabs of whole replicas (their vertical wrap stays in
    # the slab), of even height (the slab's row parity is the lattice's).
    csl = (xsl // 2) if xsl is not None else ch
    ytile = ysl if ysl is not None else Y
    R = (row_chunk // ytile) * ytile if ytile <= row_chunk else Y
    R = R or Y
    while Y % R:
        R -= ytile
    if R % 2:
        R = Y
    parts = []
    for r in range(0, Y, R):
        e_ext, o_ext = _col_parity_planes(black[r:r + R], white[r:r + R])
        parts.append(_corr_block(e_ext, o_ext, corr_len, csl, ytile))
    return torch.cat(parts, dim=1)


def correlation(black, white, corr_len: int = MAX_CORR_LEN,
                xsl: int | None = None, ysl: int | None = None) -> np.ndarray:
    """c(d) for d = 1..corr_len, normalised by 2N, as float64 numpy: the
    int64 row sums are added on the host, as the JAX package does, so the
    values are the same floats."""
    rows = correlation_row_sums(black, white, corr_len, xsl,
                                ysl).cpu().numpy()
    return rows.sum(axis=1) / (2.0 * (black.numel() + white.numel()))


def _bit1_corr_block(e_ext, o_ext, corr_len: int):
    """_corr_block on E/O words (int64 holding uint32) over the full
    lattice: each bond class an XOR of words, counted by popcount."""
    R = e_ext.shape[0] - corr_len
    ncols = 2 * 32 * e_ext.shape[1]
    e0, o0 = e_ext[:R], o_ext[:R]
    out = torch.empty((corr_len, R), dtype=torch.int64, device=e0.device)
    for d in range(1, corr_len + 1):
        dh = d // 2
        if d % 2 == 0:
            hx1 = e0 ^ _col_shift_words(e0, dh)
            hx2 = o0 ^ _col_shift_words(o0, dh)
        else:
            hx1 = e0 ^ _col_shift_words(o0, dh)
            hx2 = o0 ^ _col_shift_words(e0, dh + 1)
        bonds = (hx1, hx2, e0 ^ e_ext[d:R + d], o0 ^ o_ext[d:R + d])
        out[d - 1] = 2 * ncols - 2 * sum(_popcount_rows(b) for b in bonds)
    return out


def bit1_correlation_row_sums(black_w, white_w,
                              corr_len: int = MAX_CORR_LEN,
                              row_chunk: int = 8192, tail=None):
    """correlation_row_sums over the full lattice, straight on bit1's
    (Y, W1) int32 words (no decode). tail: the (black, white) corr_len
    rows after the last (a row slab's), else the periodic wrap."""
    Y = black_w.shape[0]
    R = _row_block(Y, row_chunk)
    tb, tw = (None, None) if tail is None else tail
    parts = []
    for r in range(0, Y, R):
        e_ext, o_ext = _col_parity_planes(
            _rows_after(black_w, r, R + corr_len, tb).to(torch.int64) & MASK,
            _rows_after(white_w, r, R + corr_len, tw).to(torch.int64) & MASK)
        parts.append(_bit1_corr_block(e_ext, o_ext, corr_len))
    return torch.cat(parts, dim=1)


def replica_up_counts(black, white, xsl: int, ysl: int):
    """int64 up counts of the sub-lattice replicas, a (Y/ysl, X/xsl) grid,
    from the compact uint8 planes (each replica holds xsl/2 compact
    columns of each color)."""
    Y, ch = black.shape
    csl = xsl // 2

    def tile_ups(p):
        t = p.reshape(Y // ysl, ysl, ch // csl, csl)
        return t.sum(dim=(1, 3), dtype=torch.int64)

    with profiling.span("tile_sums", black.device):
        return tile_ups(black) + tile_ups(white)


def replica_abs_m(ups, xsl: int, ysl: int) -> np.ndarray:
    """|m| of each replica from its up count, row-major over the grid."""
    n = xsl * ysl
    ups = ups.cpu().numpy()
    return (np.abs(2 * ups - n) / float(n)).reshape(-1)


def replica_magnetizations(black, white, xsl: int, ysl: int) -> np.ndarray:
    """|m| of each sub-lattice replica, row-major over the (Y/ysl, X/xsl)
    grid of replicas, from the compact uint8 planes; up counts exact in
    int64."""
    return replica_abs_m(replica_up_counts(black, white, xsl, ysl), xsl, ysl)


# Replica overlap: q = (1/N) sum_i s1_i s2_i = 1 - 2 neq / N, where neq
# counts the sites at which two states differ; the partials are per-row
# XOR counts.

def _neq_block(b1, w1, b2, w2):
    return ((b1 ^ b2).sum(dim=1, dtype=torch.int64)
            + (w1 ^ w2).sum(dim=1, dtype=torch.int64))


def overlap_neq_rows_via(decode_a, decode_b, nrows: int,
                         row_chunk: int = 8192):
    """Per-row differing-spin counts (int64) between two states, from each
    state's row decoder (decode(r, n) -> compact (black, white) uint8
    planes of rows [r, r+n)), slab by slab: no full-lattice decode."""
    R = _row_block(nrows, row_chunk)
    return torch.cat([_neq_block(*decode_a(r, R), *decode_b(r, R))
                      for r in range(0, nrows, R)])


def word_overlap_neq_rows(b1, w1, b2, w2, field_mask: int = MASK,
                          row_chunk: int = 16384):
    """Per-row differing-spin counts (int64) straight on word storage: the
    set bits under field_mask of the XOR of the two states' words (every
    bit for bit1's, PACKED_SPIN_MASK for packed's)."""
    parts = [_popcount_rows(b1[r:r + row_chunk] ^ b2[r:r + row_chunk],
                            field_mask)
             + _popcount_rows(w1[r:r + row_chunk] ^ w2[r:r + row_chunk],
                              field_mask)
             for r in range(0, b1.shape[0], row_chunk)]
    return torch.cat(parts)


# Column partials: per-column up counts, the column twin of
# row_up_counts. With the row counts they hold the exact integer content
# of m(0) and of the smallest-wavevector magnetization along either axis.

def _col_up_block(black, white):
    """Per-full-lattice-column up counts (int64, (X,)) of one row slab
    whose first row is even: column 2j is the E plane's column j, 2j+1
    the O plane's."""
    e, o = _col_parity_planes(black, white)
    return torch.stack([e.sum(dim=0, dtype=torch.int64),
                        o.sum(dim=0, dtype=torch.int64)], dim=1).reshape(-1)


def _col_chunked(block, a, b, nrows: int, row_chunk: int):
    """Sum a per-column block reduction over row slabs that start at even
    rows, so that each slab's own row parity is the lattice's."""
    R = min(nrows, row_chunk - (row_chunk % 2))
    if nrows <= R:
        return block(a, b)
    acc = block(a[:R], b[:R])
    for r in range(R, nrows, R):
        acc = acc + block(a[r:r + R], b[r:r + R])
    return acc


def col_up_counts(black, white, row_chunk: int = 8192):
    """Per-column up-spin counts (int64, (X,)) of two uint8 bit planes."""
    return _col_chunked(_col_up_block, black, white, black.shape[0],
                        row_chunk)


def col_up_counts_via(decode_rows, nrows: int, row_chunk: int = 8192):
    """col_up_counts from storage via a row decoder (decode_rows(r, n) ->
    compact (black, white) uint8 planes of rows [r, r+n)), slab by slab."""
    R = _row_block(nrows, row_chunk)
    acc = _col_up_block(*decode_rows(0, R))
    for r in range(R, nrows, R):
        acc = acc + _col_up_block(*decode_rows(r, R))
    return acc


def _bit1_col_up_block(black_w, white_w):
    """Per-column up counts of one row slab of bit1 words: bit g of word
    lane j is compact column g * W1 + j, so bit plane g summed over the
    rows gives W1 consecutive compact columns. On int32 words the
    arithmetic shift and & 1 take bit 31 too."""
    e, o = _col_parity_planes(black_w, white_w)

    def percol(x):
        return torch.cat([((x >> g) & 1).sum(dim=0, dtype=torch.int64)
                          for g in range(32)])

    return torch.stack([percol(e), percol(o)], dim=1).reshape(-1)


def bit1_col_up_counts(black_w, white_w, row_chunk: int = 8192):
    """col_up_counts straight on bit1's (Y, W1) int32 words (no decode)."""
    return _col_chunked(_bit1_col_up_block, black_w, white_w,
                        black_w.shape[0], row_chunk)
