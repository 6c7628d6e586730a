"""Checkerboard lattice state: compact black/white bit planes (torch).

The port of ``ising_tpu/lattice.py``. The full (Y, X) periodic lattice is
split by color c = (x + y) mod 2 into two compact (Y, X/2) planes:

  even row y:  black[y, j] = s[y, 2j]      white[y, j] = s[y, 2j + 1]
  odd  row y:  black[y, j] = s[y, 2j + 1]  white[y, j] = s[y, 2j]

Spins are bits {0, 1} in uint8 (physical spin 2b - 1).
"""

from __future__ import annotations

import torch

from .constants import BLACK, WHITE
from .rng import TAG_INIT, color_draws


def init_bits(seed: int, nrows: int, ncols: int, *, row0: int = 0,
              local_rows: int | None = None, device="cuda"):
    """Random 50/50 initial spins: the top bit of each compact site's
    Philox-10 draw on the INIT stream (row0/local_rows carve out rows)."""
    ch = ncols // 2
    rows = local_rows if local_rows is not None else nrows
    planes = []
    for color in (BLACK, WHITE):
        d = color_draws(seed, rows, ch, step=0, tag=TAG_INIT | color,
                        row0=row0, row_stride=ch, device=device)
        planes.append((d >> 31).to(torch.uint8))
    return planes[0], planes[1]


def init_store(seed: int, nrows: int, ncols: int, encode,
               chunk_rows: int = 8192, device="cuda", *, row0: int = 0,
               local_rows: int | None = None):
    """Random initial state straight in backend storage, in row chunks:
    the init stream is row-indexed and encode is row-local, so this equals
    the one-shot path with transients bounded by O(chunk_rows * ncols).
    row0 / local_rows carve out one slab's rows (an even row0)."""
    rows = nrows if local_rows is None else local_rows
    if rows <= chunk_rows:
        return encode(*init_bits(seed, nrows, ncols, row0=row0,
                                 local_rows=rows, device=device))
    if rows % chunk_rows:
        start = chunk_rows - (chunk_rows % 2)
        chunk_rows = next(c for c in range(start, 1, -2) if rows % c == 0)
    chunks = [encode(*init_bits(seed, nrows, ncols, row0=row0 + r,
                                local_rows=chunk_rows, device=device))
              for r in range(0, rows, chunk_rows)]
    return (torch.cat([c[0] for c in chunks]),
            torch.cat([c[1] for c in chunks]))


def _row_odd(nrows: int, device):
    return (torch.arange(nrows, device=device) % 2 == 1)[:, None]


def compact_to_full(black, white):
    """Merge compact planes into the full (Y, X) lattice of {0,1} bits."""
    nrows, ch = black.shape
    odd = _row_odd(nrows, black.device)
    full = torch.empty((nrows, 2 * ch), dtype=black.dtype,
                       device=black.device)
    full[:, 0::2] = torch.where(odd, white, black)
    full[:, 1::2] = torch.where(odd, black, white)
    return full


def full_to_compact(full):
    """Split a full (Y, X) bit lattice into compact (black, white) planes."""
    odd = _row_odd(full.shape[0], full.device)
    even_cols, odd_cols = full[:, 0::2], full[:, 1::2]
    return (torch.where(odd, odd_cols, even_cols),
            torch.where(odd, even_cols, odd_cols))


def bits_to_spins(bits):
    """{0,1} bits -> {-1,+1} int8 spins."""
    return 2 * bits.to(torch.int8) - 1


def links_to_color_planes(v, h, color: int, v_up=None):
    """Project full-lattice disorder links onto one color's neighbour planes.

    v[y, x] flags the vertical link (y,x)-(y+1,x), h[y, x] the horizontal
    link (y,x)-(y,x+1). Returns four compact (Y, X/2) uint8 planes
    (j_up, j_dn, j_same, j_off): the antiferro flag of the link from each
    `color` site to its up / down / same-column / off-column neighbour.
    Both colors project from the same links, so the two views agree.

    v_up: optional (1, X) halo row holding the v links above the first row
    (row-slab chunked generation, starting on an even global row); without
    it the full-lattice periodic roll.
    """
    odd = _row_odd(v.shape[0], v.device)

    def pick(full_plane):
        even_cols, odd_cols = full_plane[:, 0::2], full_plane[:, 1::2]
        if color == BLACK:
            return torch.where(odd, odd_cols, even_cols)
        return torch.where(odd, even_cols, odd_cols)

    j_dn = pick(v)
    v_above = torch.roll(v, 1, dims=0) if v_up is None \
        else torch.cat([v_up, v[:-1]])
    j_up = pick(v_above)
    # black on even rows sits at x = 2j: its same-column neighbour (white
    # j) is to the right; mirrored for white
    same_is_right = ~odd if color == BLACK else odd
    j_right = pick(h)
    j_left = pick(torch.roll(h, 1, dims=1))
    j_same = torch.where(same_is_right, j_right, j_left)
    j_off = torch.where(same_is_right, j_left, j_right)
    return j_up, j_dn, j_same, j_off
