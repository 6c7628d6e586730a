"""Exact integer observables (plain torch).

The port of ``ising_tpu/observables.py``: per-row up-spin counts and bond
sums, on uint8 bit planes (the xla backend's storage) and straight on the
bit1 backend's (Y, W1) words, without a decode to byte planes. torch has
no popcount, so words are counted with the SWAR bit-count on int64
copies; every sum is exact in int64.
"""

from __future__ import annotations

import torch

from .rng import MASK


def row_up_counts(black, white):
    """Per-row up-spin counts (int64) of two (Y, C) uint8 bit planes."""
    return (black.sum(dim=1, dtype=torch.int64)
            + white.sum(dim=1, dtype=torch.int64))


def energy_row_sums(black, white, row_chunk: int = 8192):
    """Per-row exact bond sums sum_x (s s_right + s s_down), int64, of two
    (Y, C) uint8 bit planes; the Hamiltonian is minus their total. Each
    row has 2C horizontal and 2C vertical bonds, and the sum is the bond
    count less twice the antialigned ones. Row-chunked, with one wrap row
    appended per slab."""
    Y = black.shape[0]
    R = min(Y, row_chunk)
    while Y % R:
        R -= 2
    parts = []
    for r in range(0, Y, R):
        e_ext, o_ext = _col_parity_planes(_rows_wrap(black, r, R + 1),
                                          _rows_wrap(white, r, R + 1))
        e0, o0 = e_ext[:R], o_ext[:R]
        anti = ((e0 ^ o0) + (o0 ^ torch.roll(e0, -1, dims=1))
                + (e0 ^ e_ext[1:]) + (o0 ^ o_ext[1:]))
        parts.append(4 * e0.shape[1] - 2 * anti.sum(dim=1, dtype=torch.int64))
    return torch.cat(parts)


def popcount32(words):
    """Per-element bit count of int32 (or int64 holding uint32) words."""
    x = words.to(torch.int64) & MASK
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK) >> 24


def _popcount_rows(x):
    return popcount32(x).sum(dim=1)


def word_row_up_counts(black_w, white_w, row_chunk: int = 16384):
    """Per-row up-spin counts (int64) of the two color planes."""
    parts = [_popcount_rows(black_w[r:r + row_chunk])
             + _popcount_rows(white_w[r:r + row_chunk])
             for r in range(0, black_w.shape[0], row_chunk)]
    return torch.cat(parts)


def _rows_wrap(x, r: int, n: int):
    """Rows [r, r+n) with periodic wrap (n may exceed the height)."""
    Y = x.shape[0]
    idx = torch.arange(r, r + n, device=x.device) % Y
    return x[idx]


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


def _bit1_energy_block(e_ext, o_ext):
    """Per-row bond sums of R rows, from R + 1 rows of E/O words."""
    R = e_ext.shape[0] - 1
    e0, o0 = e_ext[:R], o_ext[:R]
    ncols = 2 * 32 * e0.shape[1]
    anti = (_popcount_rows(e0 ^ o0)
            + _popcount_rows(o0 ^ _col_shift_words(e0, 1))
            + _popcount_rows(e0 ^ e_ext[1:R + 1])
            + _popcount_rows(o0 ^ o_ext[1:R + 1]))
    return 2 * ncols - 2 * anti


def bit1_energy_row_sums(black_w, white_w, row_chunk: int = 8192):
    """Per-row exact bond sums sum_bonds s_i s_j (int64) on word storage;
    the Hamiltonian is minus their total."""
    Y = black_w.shape[0]
    R = min(Y, row_chunk)
    while Y % R:
        R -= 2
    parts = []
    for r in range(0, Y, R):
        e_ext, o_ext = _col_parity_planes(
            _rows_wrap(black_w, r, R + 1).to(torch.int64) & MASK,
            _rows_wrap(white_w, r, R + 1).to(torch.int64) & MASK)
        parts.append(_bit1_energy_block(e_ext, o_ext))
    return torch.cat(parts)
