"""2-D block decomposition: a (rows, cols) grid of blocks, column halos.

The port of ``ising_tpu/parallel/block2d.py``, the JAX package's design
probe for sharding columns as well as rows. Its verdict stands here:
NO-GO for production, and 1-D row slabs (sharded.py) stay the shipped
path, for two reasons this module makes concrete.

1. **The counter-to-column draw contract prices a column block at LANES
   times the draws it keeps.** Every counter rng call yields LANES words
   per counter (4 Philox, 2 Threefry, 16 ChaCha), laid out lane by lane
   across the whole compact row: column j of a CH-wide row is output
   word j // g of counter j % g, g = CH / LANES (rng.counter_color_draws).
   A block of Cl columns inside one lane group needs Cl counters whose
   other LANES - 1 outputs land in other blocks: it generates LANES * Cl
   words to keep Cl (``draws_block``; a block of k whole lane groups
   generates the full row's CH words to keep k * g). Row slabs generate
   each word once, since counters are indexed by global row, and the
   generator is most of a sweep's work in the reproducible modes.
2. **A column split adds a second halo phase.** A row slab takes one
   boundary row from each side a color phase; a block also takes a
   boundary column from each side, a second exchange that depends on the
   same phase's state and that no row count amortises.

What the module establishes, and tests hold: the column halo mechanics
are sound, and the trajectory of every counter rng family stays the one
of one device, bit for bit, under the existing contract. The grid is an
R x C list of lists of torch devices (``make_mesh2d``), which may name a
device more than once, as the row slabs' mesh may; each block is a
tensor of its own, and the halos are views where the neighbour shares the
device, copies where it does not. The xla backend (plain torch) is the
one that runs it, as in the JAX package. The reference has row slabs
only (optimized/main.cu:1602-1658, one slab per GPU).
"""

from __future__ import annotations

import torch

from ..config import resolve_device
from ..constants import BLACK, WHITE
from ..rng import (MASK, TAG_SWEEP, chacha_block, key_from_seed, mulhilo32,
                   parse_rng_mode, philox4x32, plane_bits, threefry2x32,
                   threefry_stream_key)
from .halo import _on, ring_halo_rows
from .sharded import _guard

_LANES = {"philox": 4, "threefry": 2, "chacha": 16}


def make_mesh2d(nrow_shards: int, ncol_shards: int, devices=None,
                device="cuda"):
    """An nrow_shards x ncol_shards grid (a list of rows) of torch
    devices, row-major over `devices` (default: on CUDA the card's GPUs,
    each once; on the CPU the CPU device once a block). Asking for more
    devices than the list holds raises, as the JAX package's make_mesh2d
    does."""
    n = nrow_shards * ncol_shards
    if devices is None:
        dev = resolve_device(device)
        devices = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   if dev.type == "cuda" else [dev] * n)
    devices = [torch.device(d) for d in devices]
    if n > len(devices):
        raise ValueError(f"mesh {nrow_shards}x{ncol_shards} needs {n} "
                         f"devices, only {len(devices)} present")
    for d in devices[:n]:
        resolve_device(d)
    return [devices[r * ncol_shards:(r + 1) * ncol_shards]
            for r in range(nrow_shards)]


def _lane_plan(mode: str, ncl: int, ch_global: int):
    """(family, rounds, lanes, g) of `mode`'s draws for a block of ncl
    compact columns of a ch_global-wide row, g the lane-group width; the
    JAX package's refusals and wording."""
    family, rounds = parse_rng_mode(mode)
    if family not in _LANES or plane_bits(mode):
        raise NotImplementedError(
            "2-D block draws cover the u32 counter contracts only "
            "(philox/threefry/chacha); hw and bit-plane ...b modes are "
            "out of the prototype's scope")
    lanes = _LANES[family]
    if ch_global % lanes:
        raise ValueError(f"{family} needs compact width % {lanes} == 0")
    g = ch_global // lanes
    if ncl <= g and g % ncl:
        raise ValueError(
            f"column block width {ncl} must divide the lane-group "
            f"width {g} (= compact width / {lanes} for {family})")
    if ncl > g and ncl % g:
        raise ValueError(
            f"column block width {ncl} must be a multiple of the "
            f"lane-group width {g} for {family}")
    return family, rounds, lanes, g


def block_draw_words(mode: str, nrows: int, ncl: int, ch_global: int) -> int:
    """The u32 words ``draws_block`` generates for a block of nrows x ncl
    compact columns (it keeps nrows * ncl of them)."""
    _, _, lanes, g = _lane_plan(mode, ncl, ch_global)
    return lanes * nrows * min(ncl, g)


def _block_counters(nrows: int, m: int, row0: int, q0: int, stride: int,
                    device):
    """64-bit counters c = y * stride + q (c0 = lo, c1 = hi) for counters
    [q0, q0 + m) of global rows [row0, row0 + nrows): rng.quad_counters
    with a counter offset, the same carry; rows wrap mod 2^32."""
    y = (torch.arange(nrows, dtype=torch.int64, device=device)[:, None]
         + int(row0)) & MASK
    q = torch.arange(m, dtype=torch.int64, device=device)[None, :] + int(q0)
    hi, lo = mulhilo32(y, int(stride) & MASK)
    s = lo + q
    return s & MASK, (hi + (s >> 32)) & MASK


def draws_block(mode: str, seed: int, nrows: int, ncl: int, *, step,
                tag: int, row0, col0, ch_global: int, device="cpu"):
    """Draws (int64 holding uint32) for the compact-column block [col0,
    col0 + ncl) of global rows [row0, row0 + nrows), equal bit for bit to
    columns [col0, col0 + ncl) of the full-row rng.counter_color_draws.

    col0 is a multiple of ncl (a uniform column partition); with ncl
    dividing the lane-group width g the block never straddles a lane
    group. LANES words are generated a kept word (the module's first
    no-go reason): inside one lane group the block's counters [col0 mod
    g, + ncl) and the lane col0 // g of their outputs; over k whole lane
    groups the full row's g counters and lanes col0 // g .. + k - 1."""
    family, rounds, lanes, g = _lane_plan(mode, ncl, ch_global)
    col0 = int(col0)
    if col0 % ncl:
        raise ValueError(f"column block offset {col0} must be a multiple "
                         f"of its width {ncl}")
    step, tag = int(step) & MASK, int(tag) & MASK
    if family == "philox":
        k0, k1 = key_from_seed(seed)
        gen = lambda c0, c1: philox4x32(c0, c1, step, tag, k0, k1, rounds)
    elif family == "threefry":
        k0, k1 = threefry_stream_key(seed, step, tag)
        gen = lambda c0, c1: threefry2x32(c0, c1, k0, k1, rounds)
    else:
        k0, k1 = key_from_seed(seed)
        gen = lambda c0, c1: chacha_block(c0, c1, step, tag, k0, k1, rounds)
    lane0 = col0 // g
    if ncl <= g:
        outs = gen(*_block_counters(nrows, ncl, row0, col0 % g, g, device))
        return outs[lane0]
    outs = gen(*_block_counters(nrows, g, row0, 0, g, device))
    return torch.cat(outs[lane0:lane0 + ncl // g], dim=1)


def ring_halo_cols(blocks):
    """[(left, right)] per block of one row of the grid, each an (H, 1)
    column on the block's device: left the previous block's last column,
    right the next block's first column, around the column ring (the
    column twin of halo.ring_halo_rows)."""
    n = len(blocks)
    return [(_on(blocks[c - 1][:, -1:], b.device),
             _on(blocks[(c + 1) % n][:, :1], b.device))
            for c, b in enumerate(blocks)]


def split_blocks(plane, mesh):
    """A (Y, CH) compact plane (torch or numpy) as the grid of its blocks,
    block (r, c) a tensor of its own on mesh[r][c]."""
    plane = torch.as_tensor(plane)
    R, C = len(mesh), len(mesh[0])
    hl, cl = plane.shape[0] // R, plane.shape[1] // C
    return [[plane[r * hl:(r + 1) * hl, c * cl:(c + 1) * cl]
             .to(d, copy=True).contiguous() for c, d in enumerate(row)]
            for r, row in enumerate(mesh)]


def gather_blocks(grid):
    """The grid's blocks as one plane on the first block's device."""
    dev = grid[0][0].device
    return torch.cat([torch.cat([b.to(dev) for b in row], dim=1)
                      for row in grid])


def make_block2d_stepper(cfg, backend, mesh):
    """(shardings, step_n) over an R x C grid of devices (make_mesh2d):
    the xla backend, the u32 counter rng modes, no replicas, disorder or
    field (the JAX package's scope and refusals).

    step_n(black, white, thr10, step0, n) takes and returns the R x C
    grids of compact block planes (split_blocks). A color phase gives
    block (r, c) the halo rows of its column's ring, the halo columns of
    its row's ring, and the draws of its rows and columns (row0 = r * hl,
    col0 = c * cl), then sweeps it with xla_ref.sweep_color; the blocks
    of the phase are new tensors, so every block reads the other color's
    state as it stood. shardings: {"mesh": the grid, "block": (hl, cl)}.
    """
    from ..ops.xla_ref import sweep_color

    if backend.name != "xla":
        raise NotImplementedError("block2d prototype drives the xla "
                                  "backend only")
    if cfg.xsl is not None or cfg.j_prob is not None:
        raise NotImplementedError("block2d prototype: no replica/disorder")
    if cfg.field != 0.0:
        # sweep_color's mirror-symmetric select holds at h = 0 only.
        raise NotImplementedError("block2d prototype: no external field")
    R, C = len(mesh), len(mesh[0])
    ch = cfg.ncols // 2
    if cfg.nrows % R or (cfg.nrows // R) % 2:
        raise ValueError("nrows must split into even-height row blocks")
    if ch % C:
        raise ValueError("compact width must split evenly across columns")
    hl, cl = cfg.nrows // R, ch // C
    _lane_plan(cfg.rng, cl, ch)

    def half(dst, src, color, thr10, step):
        rows = [ring_halo_rows([src[r][c] for r in range(R)])
                for c in range(C)]
        cols = [ring_halo_cols(src[r]) for r in range(R)]
        out = []
        for r in range(R):
            row = []
            for c in range(C):
                d = dst[r][c]
                (up, dn), (left, right) = rows[c][r], cols[r][c]
                with _guard(d.device):
                    draws = draws_block(
                        cfg.rng, cfg.seed, hl, cl, step=step,
                        tag=TAG_SWEEP | color, row0=r * hl, col0=c * cl,
                        ch_global=ch, device=d.device)
                    row.append(sweep_color(
                        d, src[r][c], color=color, thr10=thr10,
                        draws=draws, src_up=up, src_dn=dn, src_left=left,
                        src_right=right))
                    del draws
            out.append(row)
        return out

    def step_n(black, white, thr10, step0, n):
        for i in range(n):
            step = (int(step0) + i) & MASK
            black = half(black, white, BLACK, thr10, step)
            white = half(white, black, WHITE, thr10, step)
        return black, white

    return {"mesh": mesh, "block": (hl, cl)}, step_n
