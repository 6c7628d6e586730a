"""Reference checkerboard sweep in plain torch (backend "xla").

The port of ``ising_tpu/ops/xla_ref.py``, the JAX package's semantic ground
truth, which has no Pallas kernel: the 4-neighbour bit sum of the opposite
color, a threshold per site, accept where the draw is at or below it, flip
by XOR. It is plain torch on every device and is the CLI's default
backend. Storage is the compact uint8 bit planes themselves (lattice.py).

Draws: every counter mode gives the same per-site draws as the JAX
package's xla backend, so trajectories match it bit for bit; the bit-plane
modes ("...b") consume the same plane words and bit-serial compare as the
bit1 kernel (ops/bit1.py). In hw mode the draws come from torch's own
generator (rng.hw_draws), as the JAX package draws them from jax.random:
no counter contract, so hw trajectories agree with the JAX package's only
in distribution.

Quenched disorder rides as this color's four uint8 flag planes, XORed
into the neighbour bits; sub-lattice replicas as index maps that wrap
the neighbours inside each replica (torch.index_select gathers).
"""

from __future__ import annotations

import torch

from ..config import resolve_device
from ..constants import BLACK
from ..rng import MASK, TAG_SWEEP, counter_color_draws, plane_bits
from .bit1 import (bitserial_lt_planes, draw_planes, plane_accept_args,
                   unpack_bits1)


def make_row_wrap_maps(nrows: int, ysl: int, device="cpu"):
    """Row index maps (up, dn) that wrap vertically inside ysl-row
    sub-lattices."""
    i = torch.arange(nrows, device=device)
    up = torch.where(i % ysl != 0, i - 1, i + ysl - 1)
    dn = torch.where((i + 1) % ysl != 0, i + 1, i - ysl + 1)
    return up, dn


def make_col_wrap_maps(ncols_half: int, xsl: int, device="cpu"):
    """Compact-column index maps (left, right) that wrap horizontally
    inside sub-lattices of xsl columns (xsl/2 compact columns)."""
    csl = xsl // 2
    j = torch.arange(ncols_half, device=device)
    left = torch.where(j % csl != 0, j - 1, j + csl - 1)
    right = torch.where((j + 1) % csl != 0, j + 1, j - csl + 1)
    return left, right


def select_threshold(dst_bits, nsum, thr10):
    """Per-site acceptance threshold (int64 holding uint32) through the
    mirrored count e = b ? n : 4 - n: e < 2 always accepts, e = 2, 3, 4
    take thr10[7], [8], [9]. Equals thr10[b*5 + n] because the h = 0
    table is mirror-symmetric."""
    e = torch.where(dst_bits == 1, nsum, 4 - nsum).to(torch.int64)
    table = torch.tensor([MASK, MASK] + [int(t) for t in thr10[7:10]],
                         dtype=torch.int64, device=nsum.device)
    return table[e]


def select_threshold_full(dst_bits, nsum, thr10):
    """Per-site threshold from the full 2 x 5 table, thr10[b*5 + n]
    (external-field runs, where the mirror symmetry does not hold)."""
    table = torch.tensor([int(t) for t in thr10], dtype=torch.int64,
                         device=nsum.device)
    return table[dst_bits.to(torch.int64) * 5 + nsum.to(torch.int64)]


def neighbor_bit_sum(src, *, color: int, H: int, src_up=None, src_dn=None,
                     src_left=None, src_right=None, row_idx_up=None,
                     row_idx_dn=None, col_idx_left=None, col_idx_right=None,
                     jplanes=None):
    """4-neighbour bit sum (0..4, uint8) of the opposite-color plane per
    dst site, with src_up / src_dn the (1, C) rows above and below the slab
    (src[-1:] and src[:1] for one periodic lattice). The off-column
    neighbour: black looks left on even rows, right on odd rows; white the
    mirror. Even slab heights keep local row parity global.

    src_left / src_right: the (H, 1) columns beside a block of the 2-D
    decomposition (parallel/block2d.py) in place of the horizontal wrap;
    without them the wrap is the block's own periodic roll.

    row / col index maps (make_row_wrap_maps, make_col_wrap_maps) replace
    the periodic wrap in replica mode; with row maps src_up / src_dn are
    not read. jplanes: this color's (j_up, j_dn, j_same, j_off) uint8
    antiferro flags, XORed into the neighbour bits before the sum."""
    if row_idx_up is not None:
        up = torch.index_select(src, 0, row_idx_up)
        dn = torch.index_select(src, 0, row_idx_dn)
    else:
        up = torch.cat([src_up, src[:-1]])
        dn = torch.cat([src[1:], src_dn])
    if col_idx_left is not None:
        left = torch.index_select(src, 1, col_idx_left)
        right = torch.index_select(src, 1, col_idx_right)
    elif src_left is not None:
        left = torch.cat([src_left, src[:, :-1]], dim=1)
        right = torch.cat([src[:, 1:], src_right], dim=1)
    else:
        left = torch.roll(src, 1, dims=1)
        right = torch.roll(src, -1, dims=1)
    row_odd = (torch.arange(H, device=src.device) % 2 == 1)[:, None]
    if color == BLACK:
        off = torch.where(row_odd, right, left)
    else:
        off = torch.where(row_odd, left, right)
    same = src
    if jplanes is not None:
        j_up, j_dn, j_same, j_off = jplanes
        up, dn, same, off = up ^ j_up, dn ^ j_dn, same ^ j_same, off ^ j_off
    return up + dn + same + off


def sweep_color(dst, src, *, color: int, thr10, draws, src_up=None,
                src_dn=None, jplanes=None, full_table: bool = False,
                **maps):
    """One Metropolis half-sweep of the (H, C) uint8 plane dst against
    src: accept where the (H, C) draw (int64 holding uint32) is at or below
    the site's threshold from the (10,) uint32 table thr10; full_table
    selects from all ten entries (external field). jplanes, the column
    halos src_left / src_right and the replica index maps as for
    neighbor_bit_sum."""
    H = dst.shape[0]
    nsum = neighbor_bit_sum(src, color=color, H=H, src_up=src_up,
                            src_dn=src_dn, jplanes=jplanes, **maps)
    pick = select_threshold_full if full_table else select_threshold
    return dst ^ (draws <= pick(dst, nsum, thr10)).to(torch.uint8)


def sweep_color_planes_field(dst, src, *, color: int, v, t10, src_up=None,
                             src_dn=None, jplanes=None, **maps):
    """Half-sweep, bit-plane contract with external field: flip where the
    assembled k-bit uniform v (int64) is below t10[b*5 + n]; always-flip
    classes hold 2^k. Bit-identical to bit1.bitserial_field_flip."""
    H = dst.shape[0]
    nsum = neighbor_bit_sum(src, color=color, H=H, src_up=src_up,
                            src_dn=src_dn, jplanes=jplanes, **maps)
    return dst ^ (v < select_threshold_full(dst, nsum, t10)).to(torch.uint8)


def sweep_color_planes(dst, src, *, color: int, lt4, lt8, coin,
                       greedy: bool, src_up=None, src_dn=None, jplanes=None,
                       **maps):
    """Half-sweep under the bit-plane contract ("...b" modes): lt4 / lt8 /
    coin are (H, C) uint8 Bernoulli bits (v < t4k, v < t8k, plane 0) from
    bit1.bitserial_lt_planes, consumed as the bit1 kernel consumes them."""
    H = dst.shape[0]
    nsum = neighbor_bit_sum(src, color=color, H=H, src_up=src_up,
                            src_dn=src_dn, jplanes=jplanes, **maps)
    e = torch.where(dst == 1, nsum, 4 - nsum)
    if greedy:
        flip = ((e < 2) | ((e == 2) & (coin == 1))
                | ((e == 3) & (lt4 == 1)) | ((e == 4) & (lt8 == 1)))
    else:
        flip = (e < 3) | ((e == 3) & (lt4 == 1)) | ((e == 4) & (lt8 == 1))
    return dst ^ flip.to(torch.uint8)


class XlaBackend:
    """Backend adapter: plain uint8 bit-plane storage, plain-torch sweep."""

    name = "xla"
    bytes_per_spin = 1.0  # uint8 bit planes

    def __init__(self, cfg):
        self.cfg = cfg
        self._maps = {}
        if cfg.xsl is not None:   # SimConfig sets both xsl and ysl or neither
            device = resolve_device(cfg.device)
            m = self._maps
            m["row_idx_up"], m["row_idx_dn"] = make_row_wrap_maps(
                cfg.local_rows, cfg.ysl, device)
            m["col_idx_left"], m["col_idx_right"] = make_col_wrap_maps(
                cfg.ncols // 2, cfg.xsl, device)
        self.kplanes = plane_bits(cfg.rng)
        if self.kplanes and (cfg.ncols // 2) % 32:
            raise ValueError(
                "bit-plane rng modes (...b) need ncols % 64 == 0 "
                "(one random bit-plane word covers 32 compact columns)")
        self.retune(cfg.temperature, cfg.field)

    def retune(self, temperature: float, field: float):
        """Take a new temperature or field (Simulation.set_temperature /
        set_field). With a field the u32 modes select from the full 2 x 5
        table; the plane modes take the k-bit thresholds of
        bit1.plane_accept_args, computed here once."""
        self.temperature, self.field = temperature, field
        self.greedy = temperature <= 0
        self.full_table = field != 0.0
        self.accept = (plane_accept_args(self.cfg.rng, temperature, field)
                       if self.kplanes else {})

    def encode(self, black_bits, white_bits):
        return black_bits, white_bits

    def decode(self, black_store, white_store):
        return black_store, white_store

    def update_color(self, dst, src, *, color, thr10, step, row0=0,
                     src_up=None, src_dn=None, jplanes=None):
        H, C = dst.shape
        # The replica wrap maps, on the slab's device.
        maps = {k: v.to(dst.device) for k, v in self._maps.items()}
        kw = dict(src_up=src_up, src_dn=src_dn, jplanes=jplanes, **maps)
        tag = TAG_SWEEP | color
        if self.kplanes:
            k, acc = self.kplanes, self.accept
            planes = draw_planes(self.cfg.rng, self.cfg.seed, H, C // 32,
                                 step=step, tag=tag, row0=row0,
                                 device=dst.device)
            if "tvals10" in acc:
                t10 = [(1 << k) if (acc["always10"] >> c) & 1
                       else acc["tvals10"][c] for c in range(10)]
                v = sum(unpack_bits1(p).to(torch.int64) << z
                        for z, p in enumerate(planes))
                return sweep_color_planes_field(dst, src, color=color, v=v,
                                                t10=t10, **kw)
            lt4, lt8, coin = (unpack_bits1(p) for p in bitserial_lt_planes(
                planes, acc["t4k"], acc["t8k"]))
            return sweep_color_planes(
                dst, src, color=color, lt4=lt4, lt8=lt8, coin=coin,
                greedy=self.greedy, **kw)
        draws = counter_color_draws(self.cfg.rng, self.cfg.seed, H, C,
                                    step=step, tag=tag, row0=row0,
                                    row_stride=C, device=dst.device)
        return sweep_color(dst, src, color=color, thr10=thr10, draws=draws,
                           full_table=self.full_table, **kw)
