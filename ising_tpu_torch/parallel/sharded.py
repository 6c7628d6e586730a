"""The step loop of the port, on one device or over row slabs.

The port of ``ising_tpu/parallel/sharded.py``: the reference's multi-GPU
structure (row slabs, boundary-row halo, bulk-synchronous color phases,
optimized/main.cu:1762-1805) over a mesh of parallel/mesh.py. Each slab
holds `local_rows` rows of both color planes. A step launches the black
phase on every slab, each slab's kernel taking the white halo rows of
its neighbours and row0 = k * local_rows, then the white phase likewise.
The draws are functions of global rows, so the trajectory is the one of
one device, bit for bit, at any slab count.

On one device without `force_collectives` a step updates black against
white, then white against black, with the periodic wrap rows taken from
the other plane; where the backend's ``fusable`` says so (packed under
ISING_TPU_FUSED=1|2, one device, no J), a step is one ``update_step``
launch instead. The loop runs on the host; each color phase is one
launch of the backend's kernel a slab (bit1_sweep, packed_sweep,
dense_sweep or mxu_sweep; plain torch on xla), three with halo_overlap.

In a group of processes (mesh.py) each process steps its own slabs, global
slab first_slab(mesh) + k taking row0 = (first_slab + k) * local_rows, and
the halo rows at the process's edges come from its neighbouring ranks
(halo.process_halo_rows) before each color phase.
"""

from __future__ import annotations

import contextlib

import torch

from ..constants import BLACK, WHITE
from ..rng import MASK
from .halo import process_halo_rows, ring_halo_rows
from .mesh import first_slab, make_mesh, process_group

# The boundary bands of halo_overlap: 8 rows, as in the JAX package.
BAND = 8


def _guard(device):
    """The CUDA device context a slab's launches need (a kernel goes to
    the current device's stream)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _slice_j(jp, a: int, b: int):
    return None if jp is None else tuple(p[a:b] for p in jp)


def make_sharded_stepper(cfg, backend, mesh=None, jplanes=None,
                         force_collectives=False):
    """(shardings, step_n) for cfg and its backend.

    step_n(black, white, thr10, step0, n) runs n steps and returns the
    planes: over a mesh, lists of per-slab tensors (one tensor pair is
    taken as one slab); on one device, tensors. The kernels update their
    slabs in place; xla returns new tensors. shardings: {"mesh": the list
    of devices, or None on one device}.

    jplanes: the disorder of driver.build_disorder as (black's, white's) J
    planes, over a mesh one tuple a slab each. force_collectives: run one
    device through the slab path (halo rows, row offsets, no fused step),
    bit-identical; the datum of its fixed cost on one card.
    """
    ndev = cfg.ndev
    collect = ndev > 1 or force_collectives
    fused = (not collect and jplanes is None
             and hasattr(backend, "fusable") and backend.fusable(cfg.nrows))
    overlap = bool(getattr(cfg, "halo_overlap", False)) and ndev > 1
    if overlap:
        # The JAX package's refusals (sharded.py:72-79).
        if cfg.local_rows < 4 * BAND:
            raise ValueError("halo_overlap needs local slab >= 32 rows")
        if cfg.xsl is not None:
            raise ValueError("halo_overlap is not supported in replica "
                             "mode (vertical wrap is sub-lattice-local)")
        if backend.name == "mxu":
            raise ValueError("halo_overlap unsupported for the mxu backend "
                             "(interior slab breaks its 128-row tiling)")
    size = process_group()[1]
    if collect:
        if mesh is None:
            mesh = make_mesh(ndev, device=cfg.device)
        if len(mesh) * size != ndev:
            raise ValueError(f"a mesh of {len(mesh)} devices for ndev = "
                             f"{ndev}")
        guards = [_guard(d) for d in mesh]
        first = first_slab(mesh)
    L = cfg.local_rows
    jb, jw = (None, None) if jplanes is None else jplanes

    def sweep(dst, src, up, dn, *, color, thr10, step, row0, jp):
        """One slab's color phase: one launch, or with halo_overlap the
        interior and two BAND-row bands (sharded.py:81-103). The kernels
        update dst's row views in place; xla's new parts are joined."""
        update = backend.update_color
        if not overlap:
            return update(dst, src, color=color, thr10=thr10, step=step,
                          row0=row0, src_up=up, src_dn=dn, jplanes=jp)
        H = dst.shape[0]
        views = (dst[:BAND], dst[BAND:H - BAND], dst[H - BAND:])
        parts = (
            update(views[0], src[:BAND], color=color, thr10=thr10,
                   step=step, row0=row0, src_up=up,
                   src_dn=src[BAND:BAND + 1], jplanes=_slice_j(jp, 0, BAND)),
            update(views[1], src[BAND:H - BAND], color=color, thr10=thr10,
                   step=step, row0=row0 + BAND, src_up=src[BAND - 1:BAND],
                   src_dn=src[H - BAND:H - BAND + 1],
                   jplanes=_slice_j(jp, BAND, H - BAND)),
            update(views[2], src[H - BAND:], color=color, thr10=thr10,
                   step=step, row0=row0 + H - BAND,
                   src_up=src[H - BAND - 1:H - BAND], src_dn=dn,
                   jplanes=_slice_j(jp, H - BAND, H)))
        if all(p.data_ptr() == v.data_ptr() for p, v in zip(parts, views)):
            return dst
        return torch.cat(parts)

    def phase(dsts, srcs, color, thr10, step, jps):
        """One color phase on every slab, the halos of the other color's
        slabs as they stand."""
        halos = ring_halo_rows(srcs)
        if size > 1:
            up, dn = process_halo_rows(srcs[0], srcs[-1])
            halos[0] = (up, halos[0][1])
            halos[-1] = (halos[-1][0], dn)
        for k, (up, dn) in enumerate(halos):
            with guards[k]:
                dsts[k] = sweep(dsts[k], srcs[k], up, dn, color=color,
                                thr10=thr10, step=step,
                                row0=(first + k) * L, jp=jps[k])

    def step_slabs(black, white, thr10, step0, n):
        sharded = isinstance(black, (list, tuple))
        bs = list(black) if sharded else [black]
        ws = list(white) if sharded else [white]
        jbs = [None] * len(bs) if jb is None else (jb if ndev > 1 else [jb])
        jws = [None] * len(ws) if jw is None else (jw if ndev > 1 else [jw])
        for i in range(n):
            step = (int(step0) + i) & MASK
            phase(bs, ws, BLACK, thr10, step, jbs)
            phase(ws, bs, WHITE, thr10, step, jws)
        return (bs, ws) if sharded else (bs[0], ws[0])

    def step_one(b, w, thr10, step0, n):
        for i in range(n):
            step = (int(step0) + i) & MASK
            if fused:
                b, w = backend.update_step(b, w, thr10=thr10, step=step)
                continue
            b = backend.update_color(b, w, color=BLACK, thr10=thr10,
                                     step=step, row0=0, src_up=w[-1:],
                                     src_dn=w[:1], jplanes=jb)
            w = backend.update_color(w, b, color=WHITE, thr10=thr10,
                                     step=step, row0=0, src_up=b[-1:],
                                     src_dn=b[:1], jplanes=jw)
        return b, w

    shardings = {"mesh": mesh if collect else None}
    return shardings, (step_slabs if collect else step_one)
