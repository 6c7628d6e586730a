"""Swendsen-Wang cluster updates (--algo sw), with the cluster labeler as
three hand-written CUDA kernels.

The port of ``ising_tpu/cluster.py``. Each update
  * opens the bond between two aligned neighbours with p = 1 - exp(-2/T):
    a raw Philox-10 draw on the TAG_CLUSTER streams, compared unsigned
    against bond_threshold's u32 (the port keeps u32 draws in int64);
  * labels the Fortuin-Kasteleyn clusters: each site gets the minimum
    site id of its connected component under the open bonds, periodic in
    both axes, or within its replica in replica mode;
  * flips every cluster by the coin of its label (one Threefry-13 call of
    the id), except, under a uniform field, the clusters bonded to the
    ghost spin.
So trajectories are bit-identical to the JAX package's for a seed.

Site ids. In replica mode (xsl, ysl) the id of site (y, x) is
rep * ysl * xsl + (y % ysl) * xsl + (x % xsl), rep = (y // ysl) * (X // xsl)
+ x // xsl: the JAX package labels each replica in its batch layout and
adds rep * ysl * xsl. With one replica of (Y, X) this is y * X + x, so one
convention serves both paths. Within a replica, ids grow with the flat
position, so the component's minimum position carries its minimum id; but
an id is not a position, and nothing here gathers by id.

The labeler (the port of ``label_clusters_tiled`` and its Pallas kernel
``_local_pass_kernel``, kernel row 7) is a global union-find on flat
positions y * X + x, in three launches of csrc/cluster_label.cu with no
host read between them:
  1. ``tile_roots``: a union-find over the open bonds inside each tile
     gives every site the least position of its tile component (the
     parent plane); where every tile holds whole replicas (or the whole
     lattice) every bond lies inside a tile, it writes the least site id
     instead, and the labeling is this one launch;
  2. ``hook_roots``: over the open bonds that leave a tile (the tile edges
     and the periodic or replica wraps), the larger root goes under the
     smaller in the parent plane;
  3. ``flatten_roots``: every site takes the site id of its root.
Each component's last root is its least position whatever order the
hooks take, so the labels are unique. The wrappers launch the kernels on
CUDA tensors and run the plain phases beside them on CPU tensors
(``tile_roots_reference``, ``hook_reference``, ``flatten_reference``).
``label_clusters`` is the plain global labeler; ``local_pass_reference``
and ``label_clusters_tiled_reference`` record the JAX package's passes.
Bonds, coins, the ghost and the flip stay plain torch on every device,
as the JAX package computes them outside any Pallas kernel.

Row slabs (cfg.ndev > 1, ``sw_step_slabs``). The lattice is never
gathered to be labelled: each slab is labelled alone by the three
kernels, its bonds down to the next slab held back and its labels offset
by the slab's first site id, so each slab component carries the least
global id it holds. ``merge_slab_edges`` then joins the components across
the slab edges with a small union-find over the labels met there, and
relabels every slab. The labels, and so the coins, are those of the
whole lattice, as the JAX package's sharded labeling gives.
"""

from __future__ import annotations

import collections
import dataclasses
import math

import numpy as np
import torch

from . import io as lio
from . import observables
from .config import SimConfig, resolve_device
from .lattice import compact_to_full, full_to_compact, init_bits
from .ops import kernel_lib
from .ops.bit1 import _cuda_stream, overlaps
from .parallel.halo import rows_after
from .parallel.mesh import (gather_rows, refuse_over_processes,
                            slab_devices)
from .parallel.sharded import _guard
from .rng import (MASK, TAG_CLUSTER, color_draws, threefry2x32,
                  threefry_stream_key)
from .utils import profiling

# tile_roots' tile: the least key and union-find parent of each site in
# shared memory, 8 B a site. MAX_TILE_SITES (128 KB) takes one 128 x 128
# replica; tiles of the full lattice, and of grouped small replicas, hold
# at most TILE_SITES (64 KB: three blocks on an SM).
MAX_TILE_SITES = 16384
TILE_SITES = 8192
TILE_COLS = 128
# Row slabs of the int64 draw and coin planes (8 B a site each).
SLAB_SITES = 1 << 24
NO_LABEL = 0x7FFFFFFF


def bond_threshold(temp: float, coupling: float = 1.0) -> int:
    """uint32 open-bond threshold: open <=> draw <= thr,
    p = 1 - exp(-2*coupling/T) (coupling = J for spin-spin bonds, |h| for
    the ghost bonds of a uniform field). T <= 0 gives p = 1. Host float64,
    as the JAX package computes it."""
    p = 1.0 if temp <= 0 else 1.0 - math.exp(-2.0 * coupling / temp)
    return int(np.rint(min(p, 1.0) * 4294967295.0))


def _sizes(shape, ysl, xsl):
    """(Y, X, ysl, xsl) with the full lattice as one replica."""
    Y, X = shape
    return Y, X, ysl or Y, xsl or X


def next_site(a, axis: int, sl: int):
    """a at each site's periodic next neighbour along `axis` within
    replicas of `sl` sites along it (the axis length: the full lattice)."""
    Y, X = a.shape
    if axis == 1:
        return a.reshape(Y, X // sl, sl).roll(-1, dims=2).reshape(Y, X)
    return a.reshape(Y // sl, sl, X).roll(-1, dims=1).reshape(Y, X)


def aligned_pairs(full, *, ysl=None, xsl=None):
    """(right, down) bool planes: the site and its next neighbour along
    the row / the column are aligned, the only pairs a bond may join."""
    _, _, ysl, xsl = _sizes(full.shape, ysl, xsl)
    return full == next_site(full, 1, xsl), full == next_site(full, 0, ysl)


def open_bonds(full, draws_r, draws_d, thr: int, *, ysl=None, xsl=None):
    """(open_r, open_d) bool planes: bond (y,x)-(y,x+1) / (y,x)-(y+1,x),
    the neighbours wrapped within the replica, is open. Draws are int64
    holding u32; the compare is unsigned."""
    right, down = aligned_pairs(full, ysl=ysl, xsl=xsl)
    return right & (draws_r <= thr), down & (draws_d <= thr)


def site_ids(Y: int, X: int, *, ysl=None, xsl=None, device="cpu"):
    """int64 (Y, X) plane of the site ids (see the module docstring)."""
    _, _, ysl, xsl = _sizes((Y, X), ysl, xsl)
    y = torch.arange(Y, device=device)[:, None]
    x = torch.arange(X, device=device)[None, :]
    rep = (y // ysl) * (X // xsl) + x // xsl
    return rep * (ysl * xsl) + (y % ysl) * xsl + x % xsl


def _bond_edges(open_r, open_d, ysl, xsl):
    """(u, v): the int64 flat positions of the two ends of every open
    bond."""
    Y, X = open_r.shape
    pos = torch.arange(Y * X, device=open_r.device).reshape(Y, X)
    u = torch.cat([pos[open_r], pos[open_d]])
    v = torch.cat([next_site(pos, 1, xsl)[open_r],
                   next_site(pos, 0, ysl)[open_d]])
    return u, v


def _min_positions(n: int, u, v):
    """The minimum flat position in each of n sites' component under the
    undirected edges u-v: hook each edge's larger representative under the
    smaller, then jump pointers to their roots, until no edge joins two
    representatives. Every representative is a site of the component no
    larger than the site, so the fixpoint is the minimum."""
    comp = torch.arange(n, device=u.device)
    while u.numel():
        cu, cv = comp[u], comp[v]
        differ = cu != cv
        if not bool(differ.any()):
            break
        cu, cv = cu[differ], cv[differ]
        comp.scatter_reduce_(0, torch.maximum(cu, cv), torch.minimum(cu, cv),
                             "amin")
        while True:
            jumped = comp[comp]
            if torch.equal(jumped, comp):
                break
            comp = jumped
    return comp


def label_clusters(open_r, open_d, *, ysl=None, xsl=None):
    """int32 (Y, X) cluster labels: the minimum site id of each component
    under the open bonds (plain torch, any device)."""
    Y, X, ysl, xsl = _sizes(open_r.shape, ysl, xsl)
    u, v = _bond_edges(open_r, open_d, ysl, xsl)
    comp = _min_positions(Y * X, u, v)
    ids = site_ids(Y, X, ysl=ysl, xsl=xsl, device=open_r.device).reshape(-1)
    return ids[comp].reshape(Y, X).to(torch.int32)


def _tile_of(Y: int, X: int, tile, device):
    ty, tx = tile
    y = torch.arange(Y, device=device)[:, None] // ty
    x = torch.arange(X, device=device)[None, :] // tx
    return (y * ((X + tx - 1) // tx) + x).reshape(-1)


def local_pass_reference(lab, open_r, open_d, *, tile, ysl=None, xsl=None):
    """One pass of the tiled labeler in plain torch: the new int32 (Y, X)
    labels. lab: int32 (Y, X) labels, or None for the site ids. tile:
    (ty, tx); tiles start at multiples of it, and the last row and column
    of tiles may be cut short. Each site takes the minimum of its label and
    of the labels across its open bonds that leave its tile; then every
    component of the bonds inside a tile takes the minimum of those."""
    Y, X, ysl, xsl = _sizes(open_r.shape, ysl, xsl)
    dev = open_r.device
    if lab is None:
        lab = site_ids(Y, X, ysl=ysl, xsl=xsl, device=dev)
    flat = lab.reshape(-1).to(torch.int64)
    u, v = _bond_edges(open_r, open_d, ysl, xsl)
    tiles = _tile_of(Y, X, tile, dev)
    cross = tiles[u] != tiles[v]
    stepped = flat.clone()
    uc, vc = u[cross], v[cross]
    stepped.scatter_reduce_(0, uc, flat[vc], "amin")
    stepped.scatter_reduce_(0, vc, flat[uc], "amin")
    comp = _min_positions(Y * X, u[~cross], v[~cross])
    least = torch.full_like(stepped, NO_LABEL).scatter_reduce_(
        0, comp, stepped, "amin")
    return least[comp].reshape(Y, X).to(torch.int32)


def whole_replica_tiles(shape, tile, *, ysl=None, xsl=None) -> bool:
    """Whether every tile holds whole replicas (or the whole lattice), so
    that every bond lies inside one tile: one pass of the JAX labeler, one
    launch (tile_roots) of the port's."""
    _, _, ysl, xsl = _sizes(shape, ysl, xsl)
    return tile[0] % ysl == 0 and tile[1] % xsl == 0


def label_clusters_tiled_reference(open_r, open_d, *, tile, ysl=None,
                                   xsl=None):
    """(labels, passes): local_pass_reference from the ids until a pass
    changes nothing (that pass counted), or one pass where the tiles hold
    whole replicas."""
    lab = local_pass_reference(None, open_r, open_d, tile=tile, ysl=ysl,
                               xsl=xsl)
    passes = 1
    if whole_replica_tiles(open_r.shape, tile, ysl=ysl, xsl=xsl):
        return lab, passes
    while True:
        new = local_pass_reference(lab, open_r, open_d, tile=tile, ysl=ysl,
                                   xsl=xsl)
        passes += 1
        if torch.equal(new, lab):
            return new, passes
        lab = new


def _divisors(n: int):
    return [d for d in range(1, n + 1) if n % d == 0]


def pick_tile(Y: int, X: int, *, ysl=None, xsl=None):
    """(ty, tx) of the labeler's tiles. The full lattice, where it exceeds
    MAX_TILE_SITES, is cut into TILE_COLS-wide tiles of TILE_SITES sites,
    short at its edges. A replica of at most MAX_TILE_SITES sites is never
    cut: small ones are grouped up to TILE_SITES a tile (at most TILE_COLS
    wide), a larger one is a tile. Larger replicas are cut into tiles that
    divide them."""
    Y, X, ysl, xsl = _sizes((Y, X), ysl, xsl)
    size = ysl * xsl
    if (ysl, xsl) == (Y, X) and size > MAX_TILE_SITES:
        tx = min(X, TILE_COLS)
        return min(Y, TILE_SITES // tx), tx
    if size <= MAX_TILE_SITES:
        cap = max(TILE_SITES, size)
        m = max(d for d in _divisors(X // xsl)
                if d * size <= cap and d * xsl <= max(TILE_COLS, xsl))
        n = max(d for d in _divisors(Y // ysl) if d * m * size <= cap)
        return n * ysl, m * xsl
    tx = max(d for d in _divisors(xsl) if d <= TILE_COLS)
    return max(d for d in _divisors(ysl) if d * tx <= TILE_SITES), tx


def tile_roots_reference(open_r, open_d, *, tile, ysl=None, xsl=None,
                         ids=False):
    """Phase 1 of the labeler in plain torch: the int32 (Y, X) least flat
    position of each site's component under the open bonds inside its
    tile (tiles as in local_pass_reference); with ids, the site id of that
    position."""
    Y, X, ysl, xsl = _sizes(open_r.shape, ysl, xsl)
    u, v = _bond_edges(open_r, open_d, ysl, xsl)
    tiles = _tile_of(Y, X, tile, open_r.device)
    inside = tiles[u] == tiles[v]
    least = _min_positions(Y * X, u[inside], v[inside])
    if ids:
        least = site_ids(Y, X, ysl=ysl, xsl=xsl,
                         device=open_r.device).reshape(-1)[least]
    return least.reshape(Y, X).to(torch.int32)


def hook_reference(parent, open_r, open_d, *, tile, ysl=None, xsl=None):
    """Phase 2 in plain torch: from phase 1's parent plane, the int32
    (Y, X) least position of each site's component, over the bonds that
    leave a tile between the tile roots. It is the flattest forest the
    kernel's hooks may leave; the kernel's own depends on the order of its
    atomics, and only the flattened labels are unique."""
    Y, X, ysl, xsl = _sizes(open_r.shape, ysl, xsl)
    u, v = _bond_edges(open_r, open_d, ysl, xsl)
    tiles = _tile_of(Y, X, tile, open_r.device)
    cross = tiles[u] != tiles[v]
    flat = parent.reshape(-1).to(torch.int64)
    least = _min_positions(Y * X, flat[u[cross]], flat[v[cross]])
    return least[flat].reshape(Y, X).to(torch.int32)


def flatten_reference(parent, *, ysl=None, xsl=None):
    """Phase 3 in plain torch: the int32 (Y, X) site id of each site's
    root in the parent plane (pointers jumped to their roots)."""
    Y, X, ysl, xsl = _sizes(parent.shape, ysl, xsl)
    flat = parent.reshape(-1).to(torch.int64)
    while True:
        jumped = flat[flat]
        if torch.equal(jumped, flat):
            break
        flat = jumped
    ids = site_ids(Y, X, ysl=ysl, xsl=xsl, device=parent.device).reshape(-1)
    return ids[flat].reshape(Y, X).to(torch.int32)


def _check_planes(what, device, planes):
    """Device, dtype, shape and contiguity of (name, tensor, dtype, shape)
    planes."""
    for name, t, dtype, shape in planes:
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, expected "
                             f"{device}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def _check_geometry(what, shape, ysl, xsl, tile=None):
    """The lattice, replica and tile checks of the wrappers; returns
    (Y, X, ysl, xsl)."""
    Y, X, ysl, xsl = _sizes(tuple(shape), ysl, xsl)
    if Y * X >= 2 ** 31:
        raise ValueError("labels are int32 site ids: needs nrows * ncols "
                         "< 2^31")
    if Y % ysl or X % xsl:
        raise ValueError(f"{what}: replicas of {ysl} x {xsl} do not tile "
                         f"{Y} x {X}")
    if tile is not None:
        ty, tx = tile
        if not (0 < ty <= Y and 0 < tx <= X and ty * tx <= MAX_TILE_SITES):
            raise ValueError(f"{what}: tile {tile} must fit the lattice and "
                             f"hold at most {MAX_TILE_SITES} sites")
    return Y, X, ysl, xsl


def _check_bond_phase(what, open_r, open_d, plane, tile, ysl, xsl):
    """The checks of tile_roots and hook_roots: bool bonds, the int32
    plane they write, which must not overlap the bonds."""
    Y, X, ysl, xsl = _check_geometry(what, open_r.shape, ysl, xsl, tile)
    _check_planes(what, open_r.device,
                  (("open_r", open_r, torch.bool, (Y, X)),
                   ("open_d", open_d, torch.bool, (Y, X)),
                   ("the int32 plane", plane, torch.int32, (Y, X))))
    if overlaps(plane, open_r) or overlaps(plane, open_d):
        raise ValueError(f"{what} writes its int32 plane: it must not "
                         "overlap the bonds")
    return Y, X, ysl, xsl


def _launch(what, device, name, *args):
    """Launch the C entry point `name` on device's current stream; a launch
    that fails raises."""
    if device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {device}")
    lib, _ = kernel_lib.load()
    code = getattr(lib, name)(*args, _cuda_stream(device))
    kernel_lib.check(lib, code, f"{what} launch")


def tile_roots(open_r, open_d, out, *, tile, ysl=None, xsl=None, ids=False):
    """Phase 1 into out (int32 (Y, X)); returns out. Each site gets the
    least flat position of its component under the open bonds inside its
    tile (ids: that position's site id, the labels where every tile holds
    whole replicas). On CUDA tensors this launches csrc/cluster_label.cu
    (counted in tile_roots.launches); a launch that fails raises. On CPU
    tensors it runs tile_roots_reference."""
    with profiling.launch(tile_roots, open_r):
        Y, X, ysl, xsl = _check_bond_phase("tile_roots", open_r, open_d, out,
                                           tile, ysl, xsl)
        if open_r.device.type == "cpu":
            return out.copy_(tile_roots_reference(open_r, open_d, tile=tile,
                                                  ysl=ysl, xsl=xsl, ids=ids))
        _launch("tile_roots", open_r.device, "label_tile_roots_launch",
                open_r.data_ptr(), open_d.data_ptr(), out.data_ptr(), Y, X,
                ysl, xsl, tile[0], tile[1], int(bool(ids)))
        tile_roots.launches += 1
        return out


def hook_roots(open_r, open_d, parent, *, tile, ysl=None, xsl=None):
    """Phase 2 on tile_roots' parent plane, in place; returns parent.
    Every open bond that leaves a tile joins the roots of its two ends,
    the larger under the smaller. On CUDA tensors this launches
    csrc/cluster_label.cu (counted in hook_roots.launches); on CPU tensors
    it runs hook_reference."""
    with profiling.launch(hook_roots, open_r):
        Y, X, ysl, xsl = _check_bond_phase("hook_roots", open_r, open_d,
                                           parent, tile, ysl, xsl)
        if open_r.device.type == "cpu":
            return parent.copy_(hook_reference(parent, open_r, open_d,
                                               tile=tile, ysl=ysl,
                                               xsl=xsl))
        _launch("hook_roots", open_r.device, "label_hook_launch",
                open_r.data_ptr(), open_d.data_ptr(), parent.data_ptr(), Y, X,
                ysl, xsl, tile[0], tile[1])
        hook_roots.launches += 1
        return parent


def flatten_roots(parent, labels, *, tile, ysl=None, xsl=None):
    """Phase 3 into labels (int32 (Y, X)); returns labels: the site id of
    each site's root in parent, by phase 1's tiles. On the full lattice
    labels may be parent itself (the id is the position); in replica mode
    it must not overlap it. On CUDA tensors this launches
    csrc/cluster_label.cu (counted in flatten_roots.launches); on CPU
    tensors it runs flatten_reference."""
    with profiling.launch(flatten_roots, parent):
        Y, X, ysl, xsl = _check_geometry("flatten_roots", parent.shape, ysl,
                                         xsl, tile)
        _check_planes("flatten_roots", parent.device,
                      (("parent", parent, torch.int32, (Y, X)),
                       ("labels", labels, torch.int32, (Y, X))))
        same = labels.data_ptr() == parent.data_ptr()
        if overlaps(labels, parent) and not (same and (ysl, xsl) == (Y, X)):
            raise ValueError("flatten_roots: labels must be parent itself (on "
                             "the full lattice only) or not overlap it")
        if parent.device.type == "cpu":
            return labels.copy_(flatten_reference(parent, ysl=ysl, xsl=xsl))
        _launch("flatten_roots", parent.device, "label_flatten_launch",
                parent.data_ptr(), labels.data_ptr(), Y, X, ysl, xsl, tile[0],
                tile[1])
        flatten_roots.launches += 1
        return labels


tile_roots.launches = hook_roots.launches = flatten_roots.launches = 0
# The labeler's wrappers, in launch order.
LABEL_PHASES = (tile_roots, hook_roots, flatten_roots)


def label_clusters_tiled(open_r, open_d, *, ysl=None, xsl=None, tile=None,
                         return_stats: bool = False):
    """The labels of label_clusters by the three phases, enqueued with no
    host read: tile_roots, then hook_roots and flatten_roots, or
    tile_roots alone (writing ids) where every tile holds whole replicas.
    On the full lattice the labels overwrite the parent plane. return_stats
    adds {"launches": 3 or 1}."""
    Y, X, ysl, xsl = _sizes(open_r.shape, ysl, xsl)
    if tile is None:
        tile = pick_tile(Y, X, ysl=ysl, xsl=xsl)
    kw = dict(tile=tile, ysl=ysl, xsl=xsl)
    whole = whole_replica_tiles((Y, X), tile, ysl=ysl, xsl=xsl)
    parent = torch.empty((Y, X), dtype=torch.int32, device=open_r.device)
    tile_roots(open_r, open_d, parent, ids=whole, **kw)
    labels, launches = parent, 1
    if not whole:
        hook_roots(open_r, open_d, parent, **kw)
        if (ysl, xsl) != (Y, X):
            labels = torch.empty((Y, X), dtype=torch.int32,
                                 device=open_r.device)
        flatten_roots(parent, labels, **kw)
        launches = 3
    return (labels, {"launches": launches}) if return_stats else labels


def cluster_coins(labels, seed: int, step):
    """uint8 flip mask: bit 31 of Threefry-13 of the label under the
    per-(step, TAG_CLUSTER|2) stream key; a cluster's sites share it."""
    k0, k1 = threefry_stream_key(seed, step, TAG_CLUSTER | 2)
    x0, _ = threefry2x32(labels.to(torch.int64) & MASK, 0, k0, k1, 13)
    return (x0 >> 31).to(torch.uint8)


def ghost_bonded_clusters(labels, ghost):
    """uint8 plane: 1 where the site's cluster holds any ghost-bonded
    site. One scatter onto the labels' slots, one gather back."""
    held = torch.zeros(labels.numel(), dtype=torch.bool, device=labels.device)
    held[labels[ghost].to(torch.int64)] = True
    return held[labels].to(torch.uint8)


def _slabs(Y: int, X: int):
    R = max(1, SLAB_SITES // X)
    return [(r, min(Y, r + R)) for r in range(0, Y, R)]


def draw_bonds(full, thr: int, seed: int, step, *, field: float = 0.0,
               thr_ghost: int | None = None, ysl=None, xsl=None,
               row0: int = 0, below=None):
    """(open_r, open_d, ghost) bool planes of one update: the open bonds,
    and under a field the sites bonded to the ghost spin (aligned with
    sign(field) and their TAG_CLUSTER|3 draw at most thr_ghost; None
    without a field). The draws are made in row slabs of SLAB_SITES.
    row0: the global row of full's first row (a row slab's); below: the
    (1, X) row after its last, which its last row's down bonds reach
    (default: the periodic wrap)."""
    Y, X, ysl, xsl = _sizes(full.shape, ysl, xsl)
    open_r, open_d = aligned_pairs(full, ysl=ysl, xsl=xsl)
    if below is not None:
        open_d[-1:] = full[-1:] == below
    ghost = (full == (1 if field > 0 else 0)) if field else None
    for r0, r1 in _slabs(Y, X):
        kw = dict(step=step, row0=row0 + r0, row_stride=X,
                  device=full.device)
        open_r[r0:r1] &= color_draws(seed, r1 - r0, X, tag=TAG_CLUSTER | 0,
                                     **kw) <= thr
        open_d[r0:r1] &= color_draws(seed, r1 - r0, X, tag=TAG_CLUSTER | 1,
                                     **kw) <= thr
        if ghost is not None:
            ghost[r0:r1] &= color_draws(seed, r1 - r0, X,
                                        tag=TAG_CLUSTER | 3, **kw) <= thr_ghost
    return open_r, open_d, ghost


def flip_clusters(full, labels, seed: int, step, ghost=None, held=None):
    """The new lattice: every cluster flipped by its coin, but for those
    holding a ghost-bonded site (held: their uint8 mark, else found from
    ghost). Coins in row slabs of SLAB_SITES."""
    if held is None and ghost is not None:
        held = ghost_bonded_clusters(labels, ghost)
    new = full.clone()
    for r0, r1 in _slabs(*full.shape):
        flip = cluster_coins(labels[r0:r1], seed, step)
        if held is not None:
            flip &= 1 - held[r0:r1]
        new[r0:r1] ^= flip
    return new


def sw_step(full, thr: int, seed: int, step, *, field: float = 0.0,
            thr_ghost: int | None = None, ysl=None, xsl=None,
            return_stats: bool = False):
    """One Swendsen-Wang update of the (Y, X) uint8 lattice; returns the
    new lattice (and the labeling's stats with return_stats).

    ysl, xsl: sub-lattice replicas (the JAX package's sw_step_replica):
    bonds wrap within each replica and labels are replica ids. A uniform
    field enters by the ghost spin (draw_bonds); only its sign is read.
    """
    with profiling.span("sw.bonds"):
        open_r, open_d, ghost = draw_bonds(full, thr, seed, step, field=field,
                                           thr_ghost=thr_ghost, ysl=ysl,
                                           xsl=xsl)
    with profiling.span("sw.label"):
        labels, stats = label_clusters_tiled(open_r, open_d, ysl=ysl,
                                             xsl=xsl, return_stats=True)
    with profiling.span("sw.flip"):
        new = flip_clusters(full, labels, seed, step, ghost)
    return (new, stats) if return_stats else new


def merge_slab_edges(labels, edges):
    """The slabs' labels joined across the slab edges. labels: each slab's
    int32 labels, the least global site id of its component within the
    slab; edges[k]: the open down bonds of slab k's last row, to the next
    slab's first row around the ring. A union-find on the first slab's
    device over the labels those bonds join (at most 2 X a slab edge) maps
    each to the least label of its merged component, and every slab is
    relabelled through that map: the least global id of each component of
    the whole lattice."""
    n = len(labels)
    dev = labels[0].device
    bonds = torch.stack([e.to(dev) for e in edges])
    u = torch.stack([lab[-1].to(dev) for lab in labels])[bonds]
    v = torch.stack([labels[(k + 1) % n][0].to(dev)
                     for k in range(n)])[bonds]
    keys = torch.unique(torch.cat([u, v]))       # sorted
    comp = _min_positions(keys.numel(), torch.searchsorted(keys, u),
                          torch.searchsorted(keys, v))
    least = keys[comp]
    moved = least != keys
    keys, least = keys[moved], least[moved]
    if not keys.numel():
        return labels
    out = []
    for lab in labels:
        k, m = keys.to(lab.device), least.to(lab.device)
        i = torch.searchsorted(k, lab).clamp_(max=k.numel() - 1)
        out.append(torch.where(k[i] == lab, m[i], lab))
    return out


def ghost_bonded_slabs(labels, ghosts):
    """ghost_bonded_clusters over row slabs: the union of every slab's
    ghost-bonded labels, marked back into each slab (uint8 planes)."""
    dev = labels[0].device
    roots = torch.unique(torch.cat([lab[g].to(dev)
                                    for lab, g in zip(labels, ghosts)]))
    return [torch.isin(lab, roots.to(lab.device)).to(torch.uint8)
            for lab in labels]


def label_slabs(open_r, open_d, *, return_stats: bool = False):
    """label_clusters of a lattice whose bond planes are given as equal row
    slabs (lists; slab k: rows [k L, (k+1) L) on its device), never
    gathered: each slab is labelled alone by label_clusters_tiled (the
    three kernels on CUDA), its last row's down bonds, which reach the
    next slab, held back and its labels offset by its first site id
    k L X; merge_slab_edges then joins the slabs over those bonds. The
    int32 labels of each slab (and {"launches": the labeler's launches
    over all slabs} with return_stats). The bond planes are left as
    given."""
    L, X = open_r[0].shape
    labels, edges, launches = [], [], 0
    for k, (o_r, o_d) in enumerate(zip(open_r, open_d)):
        with _guard(o_r.device):
            edges.append(o_d[-1].clone())
            o_d[-1] = False
            lab, stats = label_clusters_tiled(o_r, o_d, return_stats=True)
            o_d[-1] = edges[-1]
            labels.append(lab.add_(k * L * X))
        launches += stats["launches"]
    labels = merge_slab_edges(labels, edges)
    return (labels, {"launches": launches}) if return_stats else labels


def sw_step_slabs(slabs, thr: int, seed: int, step, *, field: float = 0.0,
                  thr_ghost: int | None = None, return_stats: bool = False):
    """sw_step of the lattice held in equal row slabs (slab k: full-lattice
    rows [k L, (k+1) L) as an (L, X) uint8 plane on its device), without
    gathering it; returns the new slabs (and label_slabs' stats with
    return_stats). Each slab draws its bonds with its global rows, its
    last row's down bonds reaching the next slab's first row; label_slabs
    labels them. The labels, coins and lattice are sw_step's on the whole
    lattice."""
    L = slabs[0].shape[0]
    bonds = []
    for k, full in enumerate(slabs):
        with _guard(full.device):
            bonds.append(draw_bonds(
                full, thr, seed, step, field=field, thr_ghost=thr_ghost,
                row0=k * L, below=rows_after(slabs, k, 1)))
    open_r, open_d, ghosts = zip(*bonds)
    labels, stats = label_slabs(open_r, open_d, return_stats=True)
    held = [None] * len(slabs) if not field else \
        ghost_bonded_slabs(labels, ghosts)
    new = []
    for full, lab, h in zip(slabs, labels, held):
        with _guard(full.device):
            new.append(flip_clusters(full, lab, seed, step, held=h))
    return (new, stats) if return_stats else new


class SwendsenWang:
    """Cluster-update driver with Simulation's SimConfig surface and
    seed/init contract (the same initial lattice for the same seed). Step
    counts mean SW updates. state: compact (black, white) uint8 planes,
    numpy or torch (a JAX SwendsenWang's bits()), with step0 the update
    it has reached. With cfg.ndev > 1 `full` is a list of row slabs over
    `mesh` (mesh.slab_devices), updated by sw_step_slabs."""

    def __init__(self, cfg: SimConfig, *, state=None, step0: int = 0,
                 mesh=None):
        # The JAX package's fences and wording (cluster.py:483-496).
        if cfg.backend != "xla":
            raise ValueError("cluster updates operate on decoded planes; "
                             "use backend='xla'")
        if cfg.j_prob is not None:
            raise ValueError("Swendsen-Wang needs a ferromagnetic "
                             "Hamiltonian (frustrated +-J has no FK "
                             "cluster representation)")
        if cfg.xsl is not None and cfg.ndev > 1:
            raise ValueError("replica cluster updates are single-device "
                             "(the replica batch transpose has no "
                             "sharded path yet); drop --devs or xsl/ysl")
        if cfg.nrows * cfg.ncols >= 2 ** 31:
            raise ValueError("labels are int32 site ids: needs "
                             "nrows * ncols < 2^31")
        refuse_over_processes("Swendsen-Wang")
        self.cfg = cfg
        self.mesh = slab_devices(cfg, mesh)
        self.device = (self.mesh[0] if self.mesh
                       else resolve_device(cfg.device))
        self.temp = cfg.temperature
        self.step = int(step0)
        # The state slab by slab (one slab on one device): each slab's rows
        # of the initial draw or of `state`, as the full (L, X) lattice.
        L = cfg.local_rows
        self.full = []
        for k, d in enumerate(self.mesh or [self.device]):
            if state is None:
                part = init_bits(cfg.seed, cfg.nrows, cfg.ncols, row0=k * L,
                                 local_rows=L, device=d)
            else:
                part = ((p if torch.is_tensor(p)
                         else torch.from_numpy(np.array(p)))
                        [k * L:(k + 1) * L].to(d, torch.uint8) for p in state)
            self.full.append(compact_to_full(*part))
        if self.mesh is None:
            self.full = self.full[0]
        # The labeler's launches per update (count of updates by launches).
        self.launch_counts = collections.Counter()
        self._set_thresholds()

    def _set_thresholds(self):
        self._thr = bond_threshold(self.temp)
        self._thr_ghost = bond_threshold(self.temp, abs(self.cfg.field))

    def set_temperature(self, temp: float):
        self.temp = float(temp)
        self._set_thresholds()

    def set_field(self, field: float):
        """Change h mid-run; SimConfig's validation runs through
        dataclasses.replace. Each update reads the sign anew."""
        if float(field) == self.cfg.field:
            return
        self.cfg = dataclasses.replace(self.cfg, field=float(field))
        self._set_thresholds()

    def advance(self, nsteps: int):
        # Replicas never run over slabs (the JAX fence above).
        step, kw = ((sw_step, dict(ysl=self.cfg.ysl, xsl=self.cfg.xsl))
                    if self.mesh is None else (sw_step_slabs, {}))
        for _ in range(nsteps):
            self.full, stats = step(
                self.full, self._thr, self.cfg.seed, self.step,
                field=self.cfg.field, thr_ghost=self._thr_ghost,
                return_stats=True, **kw)
            self.launch_counts[stats["launches"]] += 1
            self.step += 1

    def block(self):
        for d in dict.fromkeys(self.mesh or [self.device]):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def run(self, log=print):
        """The measurement loop (schedules, early exit, ramp, flips/ns
        report) over SW updates: the CLI's --algo sw."""
        from .driver import run_loop
        return run_loop(self, log=log)

    def _corr_path(self):
        return (f"corr_{self.cfg.nrows}x{self.cfg.ncols}"
                f"_T_{self.temp:f}_{self.cfg.seed}")

    def _append_corr(self, it: int):
        """One -c line of the full-lattice correlation. In replica mode
        too: the JAX package's SwendsenWang passes no xsl/ysl here
        (cluster.py:586-593), unlike its Simulation, and the port writes
        the same file."""
        lio.append_corr_line(self._corr_path(), it,
                             observables.correlation(*self.bits()))

    def dump(self, name: str):
        lio.dump_lattice(name, *self.bits(), fmt="hex")

    def _dump(self, it: int):
        self.dump(f"lattice_{self.cfg.nrows}x{self.cfg.ncols}"
                  f"_T_{self.temp:f}_IT_{it:08d}.txt")

    def bits(self):
        """Compact (black, white) uint8 planes of the current state (over
        a mesh, on the first slab's device: the measurements read the whole
        lattice, as the JAX package's do)."""
        if self.mesh is None:
            return full_to_compact(self.full)
        pairs = [full_to_compact(f) for f in self.full]
        return tuple(gather_rows([p[i] for p in pairs]) for i in (0, 1))

    def replica_magnetizations(self):
        """|m| per sub-lattice replica (flattened); replica mode only."""
        if self.cfg.xsl is None:
            raise ValueError("replica_magnetizations needs replica mode "
                             "(cfg.xsl/ysl)")
        return observables.replica_magnetizations(
            *self.bits(), xsl=self.cfg.xsl, ysl=self.cfg.ysl)

    def fourier_partials(self):
        """Exact (per-row, per-column) up counts as int64 numpy, the surface
        of Simulation.fourier_partials. Over the full lattice in replica
        mode too: the JAX package's SwendsenWang does not refuse it
        (cluster.py:619-630), unlike its Simulation, and the port gives the
        same line sums."""
        b, w = self.bits()
        rows = observables.row_up_counts(b, w)
        both = torch.cat([rows, observables.col_up_counts(b, w)])
        both = both.cpu().numpy()
        return both[:rows.numel()], both[rows.numel():]

    def measure(self):
        n_up, n_dn = observables.count_spins(*self.bits())
        out = {"step": self.step, "magnetization":
               abs(n_up - n_dn) / (n_up + n_dn), "up": n_up, "down": n_dn}
        if self.cfg.field:
            out["m_signed"] = (n_up - n_dn) / (n_up + n_dn)
        return out

    def energy(self) -> float:
        b, w = self.bits()
        e = observables.energy_per_spin(b, w)
        h = self.cfg.field
        if h:
            n_up, n_dn = observables.count_spins(b, w)
            e -= h * (n_up - n_dn) / self.cfg.nspins
        return e
