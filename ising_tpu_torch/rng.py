"""Counter-based Philox4x32, Threefry2x32 and ChaCha streams in plain torch.

The port of ``ising_tpu/rng.py``: every counter mode of its RNG_MODES
table. Every draw is a pure function of (seed, site, step, tag), so the
port's trajectories are bit-identical to the JAX package's. The one mode
without that contract, ``hw``, draws from a torch.Generator here
(``hw_draws``), as the JAX package draws it from ``jax.random``.

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
under the per-(step, tag) stream key; ChaCha covers 16 sites per block,
one in each sixteenth of the row, at q = row * (ncols/16) + (col mod
ncols/16) with (step, tag) in the block's nonce words.
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
TAG_HAMILT = 0x200  # quenched disorder links (models/ising.py)
TAG_CLUSTER = 0x300  # Swendsen-Wang bonds, coins and ghost (cluster.py)

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

# ChaCha state constants ("expand 32-byte k") and the pi-digit pad words
# filling the key lanes a 64-bit seed leaves free. State layout:
#   [ C0 C1 C2 C3 | k0 k1 P0 P1 | P2 P3 P4 P5 | c0 c1 step tag ]
CHACHA_C = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
CHACHA_PAD = (0x243F6A88, 0x85A308D3, 0x13198A2E,
              0x03707344, 0xA4093822, 0x299F31D0)
CHACHA_ROUNDS = 8

# The modes this port runs: all of them.
PORTED_MODES = tuple(RNG_MODES)


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


def _chacha_qr(a, b, c, d):
    """ChaCha quarter round (add-rotate-xor, rotations 16/12/8/7)."""
    a = (a + b) & MASK
    d = rotl32(d ^ a, 16)
    c = (c + d) & MASK
    b = rotl32(b ^ c, 12)
    a = (a + b) & MASK
    d = rotl32(d ^ a, 8)
    c = (c + d) & MASK
    b = rotl32(b ^ c, 7)
    return a, b, c, d


def chacha_block(c0, c1, step, tag, k0, k1, rounds: int = CHACHA_ROUNDS):
    """ChaCha-R block: 16 outputs per counter. `rounds` counts single
    rounds, applied as column/diagonal pairs, so it must be even; the
    initial state is added back at the end."""
    if rounds % 2:
        raise ValueError(f"chacha rounds must be even, got {rounds}")
    init = [*CHACHA_C, k0, k1, *CHACHA_PAD, c0, c1, step, tag]
    x = list(init)
    for _ in range(rounds // 2):
        x[0], x[4], x[8], x[12] = _chacha_qr(x[0], x[4], x[8], x[12])
        x[1], x[5], x[9], x[13] = _chacha_qr(x[1], x[5], x[9], x[13])
        x[2], x[6], x[10], x[14] = _chacha_qr(x[2], x[6], x[10], x[14])
        x[3], x[7], x[11], x[15] = _chacha_qr(x[3], x[7], x[11], x[15])
        x[0], x[5], x[10], x[15] = _chacha_qr(x[0], x[5], x[10], x[15])
        x[1], x[6], x[11], x[12] = _chacha_qr(x[1], x[6], x[11], x[12])
        x[2], x[7], x[8], x[13] = _chacha_qr(x[2], x[7], x[8], x[13])
        x[3], x[4], x[9], x[14] = _chacha_qr(x[3], x[4], x[9], x[14])
    return [(a + b) & MASK for a, b in zip(x, init)]


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


def chacha_color_draws(seed: int, nrows: int, ncols: int, *, step,
                       tag: int, row0=0, row_stride: int | None = None,
                       rounds: int = CHACHA_ROUNDS, device="cpu"):
    """(nrows, ncols) ChaCha draws: draw (y, col) is output word col // g of
    the block at q = y * stride/16 + (col mod g), g = ncols/16."""
    if ncols % 16 != 0:
        raise ValueError("chacha draw width must be a multiple of 16")
    if row_stride is not None and row_stride % 16 != 0:
        raise ValueError("chacha row_stride must be a multiple of 16")
    stride = (row_stride if row_stride is not None else ncols) // 16
    c0, c1 = quad_counters(nrows, ncols // 16, row0=row0, row_stride=stride,
                           device=device)
    k0, k1 = key_from_seed(seed)
    o = chacha_block(c0, c1, int(step) & MASK, int(tag) & MASK, k0, k1,
                     rounds)
    return torch.cat(o, dim=1)


def hw_draws(seed: int, nrows: int, ncols: int, *, step, tag: int, row0=0,
             device="cpu"):
    """(nrows, ncols) draws of rng mode "hw" on the plain-torch backend:
    torch's own generator on `device`, seeded from (seed, tag, step, row0).
    Like the JAX package's jax.random path, it is reproducible on one
    device type but carries no cross-backend contract."""
    k0, k1 = threefry_stream_key(seed, step, tag)
    lo, hi = threefry2x32(int(row0) & MASK, 0, k0, k1)
    gen = torch.Generator(device=device)
    gen.manual_seed((hi << 32) | lo)
    return torch.randint(0, 1 << 32, (nrows, ncols), generator=gen,
                         dtype=torch.int64, device=device)


def counter_color_draws(mode: str, seed: int, nrows: int, ncols: int, *,
                        step, tag: int, row0=0,
                        row_stride: int | None = None, device="cpu"):
    """Mode-dispatched per-site draws (int64 holding uint32)."""
    family, rounds = parse_rng_mode(mode)
    kw = dict(step=step, tag=tag, row0=row0, row_stride=row_stride,
              rounds=rounds, device=device)
    if family == "philox":
        return color_draws(seed, nrows, ncols, **kw)
    if family == "threefry":
        return threefry_color_draws(seed, nrows, ncols, **kw)
    if family == "chacha":
        return chacha_color_draws(seed, nrows, ncols, **kw)
    return hw_draws(seed, nrows, ncols, step=step, tag=tag, row0=row0,
                    device=device)
