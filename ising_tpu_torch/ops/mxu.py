"""MXU tier (backend "mxu"): neighbour sums as band-matrix products.

The port of ``ising_tpu/ops/mxu.py`` and its TPU kernel ``_mxu_kernel``:
the vertical sum s[r-1] + s[r+1] and the left / right neighbour (with the
site's own column) come from products with band matrices, and the accept is
the integer one through the mirrored count e = b ? n : 4 - n (h = 0 only).
Every term is a small integer, exact in any of the products' types, so
trajectories equal the dense and xla backends' in the counter modes, and the
dense and packed backends' in hw (salted Philox-10).

``mxu_sweep`` launches the hand-written kernel ``csrc/mxu_sweep.cu``, whose
products run on the tensor cores (mma.sync m16n8k32 on the 0/1 spin bytes),
on CUDA tensors, and runs ``mxu_sweep_reference`` on CPU tensors. The plain
version tiles the products as the kernel does (``neighbour_counts``): a
16 x 32 band over 32 rows of k per 16-row block (the block's rows, then the
rows above and below: no edge patch), and per group of ``tile_columns``
output columns a window of 32 columns from 4 left of the group times a
32 x 8 band per n8 tile, output column n of tile j at ``tile_column``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import BLACK
from ..rng import MASK, plane_bits
from ..utils import profiling
from . import kernel_lib
from .bit1 import _cuda_stream, launch_args
from .dense import (check_cuda_planes, check_plane_sweep, site_draws,
                    sites_per_call)
from .xla_ref import select_threshold

TILE = 128          # the JAX backend's fences: nrows, ncols/2, slab % 128
TILE_ROWS = 16      # rows of one product (mma m16)
N8 = 8              # output columns of one product (mma n8)
DEPTH = 32          # k of one product (mma k32): rows, or window columns
HALO_K = (16, 17)   # k of the rows above and below in the vertical band
WINDOW_LEFT = 4     # a window's first column: 4 left of its group's


def tile_columns(C: int, rng_mode: str) -> int:
    """Output columns a run of one warp's tile in csrc/mxu_sweep.cu: two
    n8 tiles (16) where G = C/S is a multiple of 16 (every Philox and
    Threefry width, ChaCha where C % 256 == 0), else one (8; C % 128 == 0
    gives G % 8 == 0)."""
    G = C // sites_per_call(rng_mode)
    if G % N8:
        raise ValueError(f"mxu_sweep: C = {C} leaves {G} calls per run, not "
                         f"a multiple of {N8}")
    return 2 * N8 if G % (2 * N8) == 0 else N8


def tile_column(cols: int, j, n):
    """Offset in its group of output column n of n8 tile j: 2n + j with two
    tiles (lane g's vertical operand is then columns 2g, 2g + 1 of one
    row), n with one."""
    return 2 * n + j if cols == 2 * N8 else n


def vertical_band() -> np.ndarray:
    """(16, 32) A operand of the vertical product: row m has ones at k =
    m - 1 and m + 1, k 0..15 being the block's rows, 16 the row above and
    17 the row below it."""
    m = np.zeros((TILE_ROWS, DEPTH), np.float32)
    for r in range(TILE_ROWS):
        m[r, HALO_K[0] if r == 0 else r - 1] = 1.0
        m[r, HALO_K[1] if r == TILE_ROWS - 1 else r + 1] = 1.0
    return m


def horizontal_band(cols: int, j: int, right: bool) -> np.ndarray:
    """(32, 8) B operand of n8 tile j's horizontal product, k being window
    column c0 - 4 + k: ones at the site's own column and at its left
    (right) neighbour's."""
    m = np.zeros((DEPTH, N8), np.float32)
    for n in range(N8):
        k = WINDOW_LEFT + tile_column(cols, j, n)
        m[k, n] = 1.0
        m[k + 1 if right else k - 1, n] = 1.0
    return m


def neighbour_counts(src, src_up, src_dn, *, color: int, cols: int):
    """(H, C) int32 neighbour counts n, the sums taken as the kernel takes
    them: the vertical band times 32 rows of k per 16-row block (its rows,
    the rows above and below, zeros); per group of `cols` output columns a
    window of 32 columns (periodic) times the left or right band of each n8
    tile. Products in float32 on 0/1 spins: exact."""
    H, C = src.shape
    s = src.to(torch.float32)
    dev = src.device
    nb = H // TILE_ROWS
    above = torch.cat([src_up.to(torch.float32),
                       s[TILE_ROWS - 1::TILE_ROWS][:-1]])
    below = torch.cat([s[TILE_ROWS::TILE_ROWS], src_dn.to(torch.float32)])
    rows = torch.cat([s.reshape(nb, TILE_ROWS, C), above[:, None],
                      below[:, None],
                      torch.zeros((nb, DEPTH - TILE_ROWS - 2, C), device=dev)],
                     dim=1)
    v = torch.matmul(torch.from_numpy(vertical_band()).to(dev), rows)
    c0 = torch.arange(0, C, cols, device=dev)
    win = s[:, (c0[:, None] - WINDOW_LEFT
                + torch.arange(DEPTH, device=dev)) % C]   # (H, C/cols, 32)
    right_row = (torch.arange(H, device=dev) % 2 == 1)[:, None]
    if color != BLACK:
        right_row = ~right_row
    h = torch.empty((H, C), dtype=torch.float32, device=dev)
    for j in range(cols // N8):
        at = (c0[:, None] + tile_column(cols, j, torch.arange(N8, device=dev))
              ).reshape(-1)
        left, right = (torch.matmul(
            win, torch.from_numpy(horizontal_band(cols, j, r)).to(dev)
        ).reshape(H, -1) for r in (False, True))
        h[:, at] = torch.where(right_row, right, left)
    return (v.reshape(H, C) + h).to(torch.int32)


def mxu_sweep_reference(dst, src, src_up, src_dn, thr10, row0, step, *,
                        color: int, seed: int, rng_mode: str):
    """One color half-sweep in plain torch: the new (H, C) uint8 dst.
    Arguments as for dense.dense_sweep_reference, without J planes; thr10
    must be an h = 0 table (its mirror symmetry is what the accept uses).
    Inputs are not modified."""
    H, C = dst.shape
    n = neighbour_counts(src, src_up, src_dn, color=color,
                         cols=tile_columns(C, rng_mode))
    draws = site_draws(rng_mode, seed, H, C, step=step, color=color,
                       row0=row0, device=dst.device)
    return dst ^ (draws <= select_threshold(dst, n, thr10)).to(torch.uint8)


def mxu_sweep(dst, src, src_up, src_dn, thr10, row0, step, *, color: int,
              seed: int, rng_mode: str):
    """One color half-sweep of dst, in place; returns dst.

    On CUDA tensors this launches csrc/mxu_sweep.cu (a warp a 16-row tile
    of whole generator calls, neighbour sums on the tensor cores, the
    draws and accept in the lane that holds them); a launch that
    fails raises. On CPU tensors it runs mxu_sweep_reference. Arguments as
    for mxu_sweep_reference; H must be a multiple of 16 and C of 128.
    Counts launches in mxu_sweep.launches.
    """
    with profiling.launch(mxu_sweep, dst):
        H, C = check_plane_sweep("mxu_sweep", dst, src, src_up, src_dn, thr10,
                                 color, rng_mode)
        if H % TILE_ROWS or C % TILE:
            raise ValueError(f"mxu_sweep: needs H % {TILE_ROWS} == 0 and C % "
                             f"{TILE} == 0, got ({H}, {C})")
        device = dst.device
        if device.type == "cpu":
            dst.copy_(mxu_sweep_reference(
                dst, src, src_up, src_dn, thr10, row0, step, color=color,
                seed=seed, rng_mode=rng_mode))
            return dst
        if device.type != "cuda":
            raise ValueError(f"mxu_sweep runs on cuda or cpu, not {device}")
        check_cuda_planes("mxu_sweep", dst, (src, src_up, src_dn))
        tag, k0, k1, family, rounds = launch_args(rng_mode, seed, step, color)
        lib, _ = kernel_lib.load()
        code = lib.mxu_sweep_launch(
            dst.data_ptr(), src.data_ptr(), src_up.data_ptr(),
            src_dn.data_ptr(), H, C, tile_columns(C, rng_mode),
            int(row0) & MASK, int(step) & MASK,
            tag, color, kernel_lib.table10(thr10), k0, k1, family, rounds,
            _cuda_stream(device))
        kernel_lib.check(lib, code, "mxu_sweep launch")
        mxu_sweep.launches += 1
        return dst


mxu_sweep.launches = 0


class MxuBackend:
    """Backend adapter: uint8 bit-plane storage, tensor-core neighbour
    sums and integer accept."""

    name = "mxu"
    bytes_per_spin = 1.0

    def __init__(self, cfg):
        # The JAX backend's fences (mxu.py:210-228); SimConfig refuses a
        # field on mxu and ncols % 256.
        if cfg.xsl is not None:
            raise NotImplementedError(
                "mxu backend has no sub-lattice mode (nor does the "
                "reference tensorcore tier)")
        if cfg.j_prob is not None:
            raise NotImplementedError(
                "mxu backend has no disorder mode (nor does the reference "
                "tensorcore tier)")
        if plane_bits(cfg.rng):
            raise NotImplementedError(
                "bit-plane rng modes (...b) are implemented by the bit1 and "
                "xla backends; use philox7/threefry13 here")
        if cfg.nrows % TILE or (cfg.ncols // 2) % TILE:
            raise ValueError(
                "mxu backend needs nrows and ncols/2 multiples of 128")
        if cfg.local_rows % TILE:
            raise ValueError(
                f"mxu backend needs the per-device slab height "
                f"({cfg.local_rows} = nrows/ndev) to be a multiple of 128")
        self.cfg = cfg

    def retune(self, temperature: float, field: float):
        """The mirrored accept serves T > 0 and the quench alike, and the
        config refuses a field: nothing to choose."""

    def encode(self, black_bits, white_bits):
        return black_bits, white_bits

    def decode(self, black_store, white_store):
        return black_store, white_store

    def update_color(self, dst, src, *, color, thr10, step, row0=0,
                     src_up=None, src_dn=None, jplanes=None):
        if jplanes is not None:
            raise ValueError("mxu backend has no disorder mode")
        return mxu_sweep(dst, src, src_up, src_dn, thr10, row0, step,
                         color=color, seed=self.cfg.seed,
                         rng_mode=self.cfg.rng)
