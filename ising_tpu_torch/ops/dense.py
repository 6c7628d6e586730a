"""Dense tier (backend "dense"): plain sweep, CUDA sweep, backend.

The port of ``ising_tpu/ops/pallas_dense.py`` and its TPU kernel
``_sweep_kernel``: one uint8 per spin (the compact bit planes themselves,
as the xla backend keeps them), the 4-neighbour sum of the other color, one
u32 draw per site in the u32 rng modes (hw as salted Philox-10, the stream
the JAX package substitutes off the TPU), and the full 10-entry threshold
select thr10[dst*5 + nsum], which covers T > 0, the greedy T <= 0 quench
and the external field alike; quenched +-J disorder as this color's four
uint8 J planes, XORed into the neighbours.

``dense_sweep`` launches the hand-written kernel ``csrc/dense_sweep.cu`` on
CUDA tensors and runs ``dense_sweep_reference`` on CPU tensors. The plain
version is the xla backend's sweep with the full table and counter draws
(``xla_ref.sweep_color``): the JAX dense kernel computes the same function.
"""

from __future__ import annotations

import torch

from ..constants import BLACK, WHITE
from ..rng import (MASK, TAG_SWEEP, counter_color_draws, parse_rng_mode,
                   plane_bits)
from ..utils import profiling
from . import kernel_lib
from .bit1 import _cuda_stream, draw_mode, launch_args, overlaps
from .xla_ref import sweep_color

SITES_PER_CALL = {"philox": 4, "threefry": 2, "chacha": 16}


def sites_per_call(rng_mode: str) -> int:
    """S, the sites one generator call of the mode serves (hw: Philox)."""
    return SITES_PER_CALL[parse_rng_mode(draw_mode(rng_mode, 0)[0])[0]]


def site_draws(rng_mode: str, seed: int, H: int, C: int, *, step, color: int,
               row0=0, device="cpu"):
    """(H, C) draws (int64 holding uint32) of one color phase: one u32 per
    site in the per-call layout of pallas_dense._philox_draws & co; hw is
    Philox-10 under the salted tag (pallas_dense.py:192-194)."""
    mode, tag = draw_mode(rng_mode, TAG_SWEEP | color)
    return counter_color_draws(mode, seed, H, C, step=step, tag=tag,
                               row0=row0, row_stride=C, device=device)


def check_plane_sweep(fn: str, dst, src, src_up, src_dn, thr10, color: int,
                      rng_mode: str, jplanes=()):
    """The checks both uint8-plane wrappers make: device, dtype, shape and
    contiguity of every plane, the color, the table, a u32 rng mode and a
    width the mode's calls tile. Returns (H, C)."""
    H, C = tuple(dst.shape)
    for name, t, shape in (("dst", dst, (H, C)), ("src", src, (H, C)),
                           ("src_up", src_up, (1, C)),
                           ("src_dn", src_dn, (1, C)),
                           *((f"jplanes[{i}]", p, (H, C))
                             for i, p in enumerate(jplanes))):
        if t.device != dst.device:
            raise ValueError(f"{fn}: {name} is on {t.device}, dst on "
                             f"{dst.device}")
        if t.dtype != torch.uint8:
            raise TypeError(f"{fn}: {name} must be torch.uint8, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    if color not in (BLACK, WHITE):
        raise ValueError(f"{fn}: color must be 0 or 1, got {color!r}")
    if plane_bits(rng_mode):
        raise ValueError(f"{fn} draws u32 per spin; {rng_mode!r} is a "
                         "bit-plane mode")
    S = sites_per_call(rng_mode)
    if C % S:
        family = parse_rng_mode(draw_mode(rng_mode, 0)[0])[0]
        raise ValueError(f"{fn}: {family} needs C % {S} == 0, got C = {C}")
    if len(thr10) != 10:
        raise ValueError(f"{fn}: thr10 has {len(thr10)} entries, expected 10")
    return H, C


def check_cuda_planes(fn: str, dst, inputs):
    """Before a launch: dst is updated in place, so it may overlap no
    input; every plane starts at a 4-byte boundary, as the kernels move
    four sites per 32-bit word (rows of C % 4 == 0 keep them there)."""
    if any(overlaps(dst, t) for t in inputs):
        raise ValueError(f"{fn} updates dst in place: dst must not overlap "
                         "src, src_up, src_dn or a J plane")
    if any(t.data_ptr() % 4 for t in (dst, *inputs)):
        raise ValueError(f"{fn}: every plane must start at a 4-byte aligned "
                         "address")


def dense_sweep_reference(dst, src, src_up, src_dn, thr10, row0, step,
                          jplanes=None, *, color: int, seed: int,
                          rng_mode: str):
    """One color half-sweep in plain torch: the new (H, C) uint8 dst.

    dst/src are this color's and the other color's (H, C) uint8 planes;
    src_up / src_dn the (1, C) rows above and below the slab; thr10 the
    (10,) uint32 table thr10[b*5 + n]; row0 the slab's global first row;
    jplanes this color's (j_up, j_dn, j_same, j_off) flag planes. Inputs
    are not modified."""
    H, C = dst.shape
    draws = site_draws(rng_mode, seed, H, C, step=step, color=color,
                       row0=row0, device=dst.device)
    return sweep_color(dst, src, color=color, thr10=thr10, draws=draws,
                       src_up=src_up, src_dn=src_dn, jplanes=jplanes,
                       full_table=True)


def dense_sweep(dst, src, src_up, src_dn, thr10, row0, step, jplanes=None,
                *, color: int, seed: int, rng_mode: str):
    """One color half-sweep of dst, in place; returns dst.

    On CUDA tensors this launches csrc/dense_sweep.cu (a thread takes one
    or four generator calls of each row of a band of rows); a launch that
    fails raises. On CPU tensors it runs
    dense_sweep_reference. Arguments as for dense_sweep_reference. Counts
    launches in dense_sweep.launches.
    """
    with profiling.launch(dense_sweep, dst):
        jp = () if jplanes is None else tuple(jplanes)
        if jplanes is not None and len(jp) != 4:
            raise ValueError(f"dense_sweep: jplanes must be 4 planes, got "
                             f"{len(jp)}")
        H, C = check_plane_sweep("dense_sweep", dst, src, src_up, src_dn,
                                 thr10, color, rng_mode, jp)
        device = dst.device
        if device.type == "cpu":
            dst.copy_(dense_sweep_reference(
                dst, src, src_up, src_dn, thr10, row0, step, jplanes,
                color=color, seed=seed, rng_mode=rng_mode))
            return dst
        if device.type != "cuda":
            raise ValueError(f"dense_sweep runs on cuda or cpu, not {device}")
        check_cuda_planes("dense_sweep", dst, (src, src_up, src_dn, *jp))
        tag, k0, k1, family, rounds = launch_args(rng_mode, seed, step, color)
        lib, _ = kernel_lib.load()
        code = lib.dense_sweep_launch(
            dst.data_ptr(), src.data_ptr(), src_up.data_ptr(),
            src_dn.data_ptr(),
            H, C, int(row0) & MASK, int(step) & MASK, tag, color,
            kernel_lib.table10(thr10), k0, k1, family, rounds,
            *((p.data_ptr() for p in jp) if jp else (None,) * 4),
            _cuda_stream(device))
        kernel_lib.check(lib, code, "dense_sweep launch")
        dense_sweep.launches += 1
        return dst


dense_sweep.launches = 0


class DenseBackend:
    """Backend adapter: uint8 bit-plane storage, per-site CUDA sweep."""

    name = "dense"
    bytes_per_spin = 1.0

    def __init__(self, cfg):
        # The JAX backend's fences (pallas_dense.py:276-284).
        if cfg.xsl is not None:
            raise NotImplementedError(
                "dense backend has no sub-lattice mode; use xla or packed")
        if plane_bits(cfg.rng):
            raise NotImplementedError(
                "bit-plane rng modes (...b) are implemented by the bit1 and "
                "xla backends (their storage matches the plane layout); use "
                "philox7/threefry13 here")
        self.cfg = cfg

    def retune(self, temperature: float, field: float):
        """The full 10-entry table covers every temperature and field:
        nothing to choose."""

    def encode(self, black_bits, white_bits):
        return black_bits, white_bits

    def decode(self, black_store, white_store):
        return black_store, white_store

    def update_color(self, dst, src, *, color, thr10, step, row0=0,
                     src_up=None, src_dn=None, jplanes=None):
        return dense_sweep(dst, src, src_up, src_dn, thr10, row0, step,
                           jplanes, color=color, seed=self.cfg.seed,
                           rng_mode=self.cfg.rng)
