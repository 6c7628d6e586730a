"""MXU tier (backend "mxu"): neighbour sums as band-matrix products.

The port of ``ising_tpu/ops/mxu.py`` and its TPU kernel ``_mxu_kernel``:
the spins of a uint8 bit plane become +-1, the vertical sum s[r-1] + s[r+1]
and the left / right neighbours come from products with band matrices
(``band``), the edges of each product patched from the neighbouring rows
and columns, and the accept is the integer one through the mirrored count
e = b ? n : 4 - n (h = 0 only). Every term is a small integer, exact in
bf16 and float32, so trajectories equal the dense and xla backends' in the
counter modes, and the dense and packed backends' in hw (salted Philox-10).

``mxu_sweep`` launches the hand-written kernel ``csrc/mxu_sweep.cu``, whose
products run on the tensor cores, on CUDA tensors, and runs
``mxu_sweep_reference`` on CPU tensors. The plain version tiles the
products as the kernel does: 16-row blocks for the vertical product, and
16-column windows at the kernel's run offsets for the horizontal ones
(``calls_per_tile``), so the CPU tests check the kernel's edge patching.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import BLACK
from ..rng import MASK, plane_bits
from . import kernel_lib
from .bit1 import _cuda_stream, launch_args
from .dense import (check_cuda_planes, check_plane_sweep, site_draws,
                    sites_per_call)
from .xla_ref import select_threshold

TILE = 128          # the JAX backend's fences: nrows, ncols/2, slab % 128
FRAG = 16           # the kernel's fragment: 16 rows, 16 columns
MAX_COLS = 256      # columns a CTA of the kernel stages


def band(n: int, offset: int) -> np.ndarray:
    """(n, n) matrix with ones on the given diagonal (mxu.py:_band)."""
    m = np.zeros((n, n), np.float32)
    idx = np.arange(n - abs(offset))
    if offset >= 0:
        m[idx, idx + offset] = 1.0
    else:
        m[idx - offset, idx] = 1.0
    return m


def calls_per_tile(C: int, rng_mode: str) -> int:
    """tq, the generator calls per run of one CTA of csrc/mxu_sweep.cu: the
    largest of 64, 32, 16 dividing G = C/S with S * tq <= 256 columns, else
    8. The kernel's 16-wide fragments start at multiples of min(tq, 16)."""
    S = sites_per_call(rng_mode)
    G = C // S
    for tq in (64, 32, 16):
        if G % tq == 0 and S * tq <= MAX_COLS:
            return tq
    if G % 8 == 0:
        return 8
    raise ValueError(f"mxu_sweep: C = {C} leaves {G} calls per run, not a "
                     "multiple of 8")


def neighbour_counts(src, src_up, src_dn, *, color: int, window: int):
    """(H, C) int32 neighbour counts n = (total + 4) >> 1, the sums taken as
    the kernel takes them: +-1 spins, float32 band products on 16-row blocks
    (vertical) and on 16-column windows starting every `window` columns
    (horizontal, the first `window` outputs of each kept), edges patched
    from the rows above / below and the columns left / right (periodic)."""
    H, C = src.shape
    pm = lambda b: 2.0 * b.to(torch.float32) - 1.0
    s = pm(src)
    dev = src.device
    kv = torch.from_numpy(band(FRAG, 1) + band(FRAG, -1)).to(dev)
    kl = torch.from_numpy(band(FRAG, 1)).to(dev)     # out[j] = in[j - 1]
    kr = torch.from_numpy(band(FRAG, -1)).to(dev)    # out[j] = in[j + 1]
    v = torch.matmul(kv, s.reshape(H // FRAG, FRAG, C)).reshape(H, C)
    row = (torch.arange(H, device=dev) % FRAG)[:, None]
    v = torch.where(row == 0, v + torch.cat([pm(src_up), s[:-1]]), v)
    v = torch.where(row == FRAG - 1, v + torch.cat([s[1:], pm(src_dn)]), v)
    cols = (torch.arange(0, C, window, device=dev)[:, None]
            + torch.arange(FRAG, device=dev)) % C
    win = s[:, cols]                                  # (H, C/window, 16)
    left = torch.matmul(win, kl)[..., :window].reshape(H, C)
    right = torch.matmul(win, kr)[..., :window].reshape(H, C)
    lane = (torch.arange(C, device=dev) % window)[None, :]
    left = torch.where(lane == 0, torch.roll(s, 1, dims=1), left)
    right = torch.where(lane == FRAG - 1, torch.roll(s, -1, dims=1), right)
    odd = (torch.arange(H, device=dev) % 2 == 1)[:, None]
    off = torch.where(odd, right, left) if color == BLACK \
        else torch.where(odd, left, right)
    total = v + s + off
    return (total.to(torch.int32) + 4) >> 1


def mxu_sweep_reference(dst, src, src_up, src_dn, thr10, row0, step, *,
                        color: int, seed: int, rng_mode: str):
    """One color half-sweep in plain torch: the new (H, C) uint8 dst.
    Arguments as for dense.dense_sweep_reference, without J planes; thr10
    must be an h = 0 table (its mirror symmetry is what the accept uses).
    Inputs are not modified."""
    H, C = dst.shape
    n = neighbour_counts(src, src_up, src_dn, color=color,
                         window=min(calls_per_tile(C, rng_mode), FRAG))
    draws = site_draws(rng_mode, seed, H, C, step=step, color=color,
                       row0=row0, device=dst.device)
    return dst ^ (draws <= select_threshold(dst, n, thr10)).to(torch.uint8)


def mxu_sweep(dst, src, src_up, src_dn, thr10, row0, step, *, color: int,
              seed: int, rng_mode: str):
    """One color half-sweep of dst, in place; returns dst.

    On CUDA tensors this launches csrc/mxu_sweep.cu (16-row tiles of whole
    generator calls, neighbour sums on the tensor cores); a launch that
    fails raises. On CPU tensors it runs mxu_sweep_reference. Arguments as
    for mxu_sweep_reference; H must be a multiple of 16 and C of 128.
    Counts launches in mxu_sweep.launches.
    """
    H, C = check_plane_sweep("mxu_sweep", dst, src, src_up, src_dn, thr10,
                             color, rng_mode)
    if H % FRAG or C % TILE:
        raise ValueError(f"mxu_sweep: needs H % {FRAG} == 0 and C % {TILE} "
                         f"== 0, got ({H}, {C})")
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
        dst.data_ptr(), src.data_ptr(), src_up.data_ptr(), src_dn.data_ptr(),
        H, C, calls_per_tile(C, rng_mode), int(row0) & MASK, int(step) & MASK,
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
