"""Counter-based Philox4x32 and Threefry2x32 streams in plain torch.

The port of ``ising_tpu/rng.py`` for the u32-draw contract of the philox
and threefry families. Every draw is a pure function of (seed, site, step,
tag), so the port's trajectories are bit-identical to the JAX package's.

torch has no usable uint32 arithmetic on the CPU (``+``, ``<<``, ``>>`` and
``<`` raise for torch.uint32), so the generators here work on int64
tensors that hold values in [0, 2^32) and mask with ``& MASK`` after every
operation that can leave that range. The same functions take plain Python
ints, which is how the host derives per-launch scalars (the Threefry stream
key) for the CUDA kernel.

Counter layout (shared with the JAX package): for a compact color tile of
``ncols`` draws per row, Philox covers four sites per call, one in each
quarter of the row, at the 64-bit quad counter q = row * (ncols/4) +
(col mod ncols/4) and the stream words (step, tag); Threefry covers a pair
(col, col + ncols/2) per call at q = row * (ncols/2) + (col mod ncols/2)
under the per-(step, tag) stream key.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF

# Philox4x32 multipliers and Weyl key increments (Salmon et al., SC'11).
PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
PHILOX_ROUNDS = 10

THREEFRY_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
THREEFRY_ROUNDS = 20

# Stream tags (counter word 3). Bit 0 is the checkerboard color.
TAG_SWEEP = 0x000
TAG_INIT = 0x100

# rng-mode string -> (family, rounds, plane_bits), the JAX package's table.
RNG_MODES = {
    "philox": ("philox", 10, 0),
    "philox7": ("philox", 7, 0),
    "philox7b": ("philox", 7, 16),
    "threefry": ("threefry", 20, 0),
    "threefry13": ("threefry", 13, 0),
    "threefry13b": ("threefry", 13, 16),
    "chacha8": ("chacha", 8, 0),
    "chacha8b": ("chacha", 8, 16),
    "chacha6": ("chacha", 6, 0),
    "chacha6b": ("chacha", 6, 16),
    "chacha4": ("chacha", 4, 0),
    "chacha4b": ("chacha", 4, 16),
    "hw": ("hw", 0, 0),
}

# The modes this port runs: the u32 draw contract of Philox and Threefry.
PORTED_MODES = ("philox", "philox7", "threefry", "threefry13")


def parse_rng_mode(mode: str):
    """-> (family, rounds); raises on unknown modes."""
    try:
        return RNG_MODES[mode][:2]
    except KeyError:
        raise ValueError(f"unknown rng mode {mode!r}; "
                         f"one of {sorted(RNG_MODES)}") from None


def plane_bits(mode: str) -> int:
    """k for bit-plane-contract modes ("...b"), 0 for u32-draw modes."""
    try:
        return RNG_MODES[mode][2]
    except KeyError:
        raise ValueError(f"unknown rng mode {mode!r}; "
                         f"one of {sorted(RNG_MODES)}") from None


def unported_mode_item(mode: str):
    """ROADMAP.md queue-1 item that ports `mode`, or None if it runs here."""
    if mode in PORTED_MODES:
        return None
    family = parse_rng_mode(mode)[0]
    return 3 if family == "chacha" and not plane_bits(mode) else 2


def mulhilo32(a, b):
    """Full 32x32 -> 64 bit product as (hi, lo), from 16-bit halves of b so
    that no intermediate leaves int64 (a * b itself can exceed 2^63)."""
    p0 = a * (b & 0xFFFF)           # < 2^48
    p1 = a * (b >> 16)              # < 2^48
    lo = (p0 + ((p1 & 0xFFFF) << 16)) & MASK
    hi = (((p0 >> 16) + p1) >> 16) & MASK
    return hi, lo


def philox4x32(c0, c1, c2, c3, k0, k1, rounds: int = PHILOX_ROUNDS):
    """Philox4x32-R block; four draws per 128-bit counter."""
    for r in range(rounds):
        hi0, lo0 = mulhilo32(c0, PHILOX_M0)
        hi1, lo1 = mulhilo32(c2, PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        if r != rounds - 1:
            k0 = (k0 + PHILOX_W0) & MASK
            k1 = (k1 + PHILOX_W1) & MASK
    return c0, c1, c2, c3


def rotl32(x, r: int):
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(c0, c1, k0, k1, rounds: int = THREEFRY_ROUNDS):
    """Threefry2x32-R with Random123's round structure: key injection
    first, then after every completed group of four rounds."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (c0 + ks[0]) & MASK
    x1 = (c1 + ks[1]) & MASK
    for r in range(rounds):
        x0 = (x0 + x1) & MASK
        x1 = rotl32(x1, THREEFRY_ROT[r % 8]) ^ x0
        if (r + 1) % 4 == 0:
            j = (r + 1) // 4
            x0 = (x0 + ks[j % 3]) & MASK
            x1 = (x1 + ks[(j + 1) % 3] + j) & MASK
    return x0, x1


def key_from_seed(seed: int):
    """Split a 64-bit seed into the (lo, hi) key pair."""
    seed = int(seed)
    return seed & MASK, (seed >> 32) & MASK


def threefry_stream_key(seed: int, step: int, tag: int):
    """Per-(step, tag) 64-bit key, one full-strength scalar Threefry call
    (host Python ints)."""
    k0, k1 = key_from_seed(seed)
    return threefry2x32(int(step) & MASK, int(tag) & MASK, k0, k1)


def quad_counters(nrows: int, nquads: int, *, row0=0,
                  row_stride: int | None = None, device="cpu"):
    """64-bit counters (c0 = lo, c1 = hi) of a (nrows, nquads) tile:
    q64 = (row0 + y) * row_stride + q, the carry into the high word
    included. Global rows wrap mod 2^32 as the JAX package's uint32 do."""
    if row_stride is None:
        row_stride = nquads
    y = (torch.arange(nrows, dtype=torch.int64, device=device)[:, None]
         + int(row0)) & MASK
    q = torch.arange(nquads, dtype=torch.int64, device=device)[None, :]
    hi, lo = mulhilo32(y, int(row_stride) & MASK)
    s = lo + q
    return s & MASK, (hi + (s >> 32)) & MASK


def color_draws(seed: int, nrows: int, ncols: int, *, step, tag: int,
                row0=0, row_stride: int | None = None,
                rounds: int = PHILOX_ROUNDS, device="cpu"):
    """(nrows, ncols) Philox draws (int64 holding uint32) for one compact
    color tile; `row_stride` is the global compact row width."""
    if ncols % 4 != 0:
        raise ValueError(f"compact width must be a multiple of 4, got {ncols}")
    stride = (row_stride if row_stride is not None else ncols) // 4
    c0, c1 = quad_counters(nrows, ncols // 4, row0=row0, row_stride=stride,
                           device=device)
    k0, k1 = key_from_seed(seed)
    o = philox4x32(c0, c1, int(step) & MASK, int(tag) & MASK, k0, k1, rounds)
    return torch.cat(o, dim=1)


def threefry_color_draws(seed: int, nrows: int, ncols: int, *, step,
                         tag: int, row0=0, row_stride: int | None = None,
                         rounds: int = THREEFRY_ROUNDS, device="cpu"):
    """(nrows, ncols) Threefry draws under the (step, tag) stream key."""
    if ncols % 2 != 0:
        raise ValueError("compact width must be even")
    stride = (row_stride if row_stride is not None else ncols) // 2
    c0, c1 = quad_counters(nrows, ncols // 2, row0=row0, row_stride=stride,
                           device=device)
    k0, k1 = threefry_stream_key(seed, step, tag)
    o0, o1 = threefry2x32(c0, c1, k0, k1, rounds)
    return torch.cat([o0, o1], dim=1)


def counter_color_draws(mode: str, seed: int, nrows: int, ncols: int, *,
                        step, tag: int, row0=0,
                        row_stride: int | None = None, device="cpu"):
    """Mode-dispatched per-site draws (philox and threefry families)."""
    family, rounds = parse_rng_mode(mode)
    kw = dict(step=step, tag=tag, row0=row0, row_stride=row_stride,
              rounds=rounds, device=device)
    if mode in PORTED_MODES and family == "philox":
        return color_draws(seed, nrows, ncols, **kw)
    if mode in PORTED_MODES and family == "threefry":
        return threefry_color_draws(seed, nrows, ncols, **kw)
    raise NotImplementedError(
        f"rng mode {mode!r} is not yet ported "
        f"(ROADMAP item {unported_mode_item(mode)})")
