"""Checkerboard Metropolis on the 2-D Ising lattice, written plainly.

This module is the yardstick that decides whether a run is correct. It
imports torch alone: nothing of the measured program, and no table, weight
or state that the program made. It holds a frozen copy of the counter
generator and of the update that the program promises to follow bit for
bit:

* Spins are bits b in {0, 1} on a periodic (Y, X) lattice; the site (y, x)
  has color (x + y) mod 2, black 0 and white 1.
* A draw is Philox4x32-R (Salmon et al., SC'11) under the key (seed mod
  2^32, seed >> 32), at the counter (q mod 2^32, q >> 32, step, tag). A
  color's sites form a compact (Y, X/2) plane, site (y, x) at compact
  column j = x // 2; with Q = X/8 the draw of (y, j) is output word
  j // Q of the call at q = y * Q + (j mod Q).
* The initial spin of a site is the top bit of its draw at step 0 under
  tag 0x100 | color.
* Step t updates black, then white, each site of the color against its
  four neighbours as they stand, with its draw under tag color at step t:
  it flips when draw <= thr[b * 5 + n], n its up neighbours, thr[i] =
  rint(min(exp(-dE / T), 1) * (2^32 - 1)), dE = 2 (2b - 1)(2n - 4).
* Replicas: the lattice is cut into ysl x xsl tiles, each periodic on its
  own.

Everything works on full-lattice rows: a tensor of `rows` (global row
indices, which may wrap) by X columns. Rows are periodic in the tensor;
for a band of rows cut from a larger lattice, the caller discards the rows
that the wrap has reached (two a step from each edge).
"""

from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
TAG_SWEEP = 0x000
TAG_INIT = 0x100
BLACK, WHITE = 0, 1


def mulhilo32(a, b: int):
    """(hi, lo) of the 64-bit product of int64-held u32 values a and b,
    from 16-bit halves of b so that nothing leaves int64."""
    p0 = a * (b & 0xFFFF)
    p1 = a * (b >> 16)
    lo = (p0 + ((p1 & 0xFFFF) << 16)) & MASK
    hi = (((p0 >> 16) + p1) >> 16) & MASK
    return hi, lo


def philox4x32(c0, c1, c2: int, c3: int, k0: int, k1: int, rounds: int):
    """Philox4x32-R: four words a counter."""
    c2 = torch.full_like(c0, c2)
    c3 = torch.full_like(c0, c3)
    for r in range(rounds):
        hi0, lo0 = mulhilo32(c0, PHILOX_M0)
        hi1, lo1 = mulhilo32(c2, PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + PHILOX_W0) & MASK
        k1 = (k1 + PHILOX_W1) & MASK
    return c0, c1, c2, c3


def philox_rounds(rng: str) -> int:
    """Rounds of the Philox modes the reference runs."""
    rounds = {"philox": 10, "philox7": 7}
    if rng not in rounds:
        raise ValueError(f"the reference runs no rng mode {rng!r}")
    return rounds[rng]


def thresholds(temp: float) -> list[int]:
    """thr[b * 5 + n] of the accept, from float64 exp."""
    out = []
    for b in range(2):
        for n in range(5):
            de = 2.0 * (2 * b - 1) * (2 * n - 4)
            p = min(math.exp(-de / temp), 1.0)
            out.append(int(round(p * 4294967295.0)))
    return out


def compact_draws(seed: int, rows, ncols: int, *, step: int, tag: int,
                  rounds: int = 10):
    """(len(rows), ncols / 2) int64 draws of one color's compact plane."""
    Q = ncols // 8
    q = rows[:, None] * Q + torch.arange(Q, device=rows.device)[None, :]
    words = philox4x32(q & MASK, q >> 32, step & MASK, tag, seed & MASK,
                       (seed >> 32) & MASK, rounds)
    return torch.cat(words, dim=1)


def site_color(rows, ncols: int):
    """(len(rows), X) uint8 color of each site."""
    x = torch.arange(ncols, device=rows.device)
    return ((rows[:, None] + x[None, :]) % 2).to(torch.uint8)


def full_draws(seed: int, rows, ncols: int, *, step: int, tag: int,
               rounds: int = 10):
    """Each site's draw from one color's compact plane: column x reads
    compact column x // 2."""
    d = compact_draws(seed, rows, ncols, step=step, tag=tag, rounds=rounds)
    return d.repeat_interleave(2, dim=1)


def init_rows(seed: int, rows, ncols: int):
    """(len(rows), X) uint8 initial spins of the given global rows."""
    color = site_color(rows, ncols)
    bits = [(full_draws(seed, rows, ncols, step=0, tag=TAG_INIT | c) >> 31)
            for c in (BLACK, WHITE)]
    return torch.where(color == BLACK, bits[0], bits[1]).to(torch.uint8)


def neighbour_ups(s, xsl: int | None = None, ysl: int | None = None):
    """Up neighbours of each site, periodic over the tensor's rows and
    columns, or inside each ysl x xsl tile."""
    n, X = s.shape
    c = s.view(n, X // xsl, xsl) if xsl else s.view(n, 1, X)
    r = s.view(n // ysl, ysl, X) if ysl else s.view(1, n, X)
    horiz = (torch.roll(c, 1, 2) + torch.roll(c, -1, 2)).view(n, X)
    vert = (torch.roll(r, 1, 1) + torch.roll(r, -1, 1)).view(n, X)
    return horiz + vert


def sweep_color(s, rows, *, seed: int, step: int, color: int, thr,
                xsl=None, ysl=None, rounds: int = 10):
    """One color's update of s (returns a new tensor)."""
    X = s.shape[1]
    n = neighbour_ups(s, xsl, ysl)
    t = torch.as_tensor(thr, dtype=torch.int64, device=s.device)
    limit = t[s.to(torch.int64) * 5 + n.to(torch.int64)]
    draw = full_draws(seed, rows, X, step=step, tag=TAG_SWEEP | color,
                      rounds=rounds)
    flip = (site_color(rows, X) == color) & (draw <= limit)
    return s ^ flip.to(torch.uint8)


def run_steps(s, rows, *, seed: int, step0: int, nsteps: int, temp: float,
              xsl=None, ysl=None, rounds: int = 10):
    """nsteps steps from step index step0 (black, then white, each)."""
    thr = thresholds(temp)
    for t in range(step0, step0 + nsteps):
        for color in (BLACK, WHITE):
            s = sweep_color(s, rows, seed=seed, step=t, color=color, thr=thr,
                            xsl=xsl, ysl=ysl, rounds=rounds)
    return s


def tile_ups(s, xsl: int, ysl: int):
    """int64 up counts of each ysl x xsl tile of s, row-major."""
    n, X = s.shape
    return s.view(n // ysl, ysl, X // xsl, xsl).to(torch.int64).sum((1, 3))
