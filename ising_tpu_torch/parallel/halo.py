"""Rows of the neighbouring slabs: the halo exchange of the row slabs.

The port of ``ising_tpu/parallel/halo.py``. The JAX package pushes each
shard's edge rows around the device ring with ``lax.ppermute`` before a
color sweep; the reference's kernels read the neighbouring GPU's edge row
in place (optimized/main.cu:1637-1642). Here the one controller hands
each slab's kernel the two rows it needs: a view of the neighbouring
slab where it shares the device, else a copy onto the slab's device
(``non_blocking``; torch orders it with both devices' current streams).

In a group of processes (mesh.initialize_multihost) the ring runs through
the ranks: a process's first slab takes its up row from the last slab of
rank r - 1, its last slab its dn row from the first slab of rank r + 1
(``process_halo_rows``), and the rows below a process's last slab come
from the next rank (``process_rows_after``). The rows move point to
point, device to device under NCCL and through host memory under gloo,
whose point-to-point takes CPU tensors.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..utils import profiling


def _on(row, device):
    return row if row.device == device else row.to(device,
                                                   non_blocking=True)


def ring_halo_rows(slabs):
    """[(up, dn)] per slab, each a (1, C) row on the slab's device: up the
    previous slab's last row (global row row0 - 1), dn the next slab's
    first row (global row row0 + H), around the ring. With one slab these
    are its own wrap rows. A `halo` span counts the bytes copied between
    devices (0 where every neighbour shares the slab's device)."""
    n = len(slabs)
    with profiling.span("halo") as span:
        out = [(_on(slabs[k - 1][-1:], s.device),
                _on(slabs[(k + 1) % n][:1], s.device))
               for k, s in enumerate(slabs)]
        if span is not None:
            span.counts["bytes"] = slabs[0][:1].nbytes * sum(
                (slabs[k - 1].device != s.device)
                + (slabs[(k + 1) % n].device != s.device)
                for k, s in enumerate(slabs))
    return out


def ring_rows(slabs, r: int, n: int, device):
    """Global rows [r, r+n) of the lattice split into equal row `slabs`,
    periodic (n may exceed the lattice height), on `device`."""
    L = slabs[0].shape[0]
    Y = L * len(slabs)
    parts, r = [], r % Y
    while n > 0:
        k, off = divmod(r, L)
        take = min(L - off, n)
        parts.append(slabs[k][off:off + take].to(device))
        r, n = (r + take) % Y, n - take
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def rows_after(slabs, k: int, n: int):
    """The n rows that follow slab k's last row around the ring, on slab
    k's device: the wrap rows of an observable that reads rows below."""
    L = slabs[0].shape[0]
    return ring_rows(slabs, (k + 1) * L, n, slabs[k].device)


def _sendrecv(t, to: int, frm: int, tag: int, device):
    """Send t to rank `to` and receive a tensor of t's shape and dtype from
    rank `frm`, on `device`: one send and one receive a batch, so that
    NCCL (which matches a pair of ranks' messages by order) and gloo (by
    tag) pair them alike. Under gloo both go through host memory."""
    where = torch.device("cpu") if dist.get_backend() == "gloo" else device
    buf = torch.empty(t.shape, dtype=t.dtype, device=where)
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, t.to(where).contiguous(), to, tag=tag),
            dist.P2POp(dist.irecv, buf, frm, tag=tag)]):
        req.wait()
    return buf.to(device, non_blocking=True)


def _ring_peers():
    rank, size = dist.get_rank(), dist.get_world_size()
    return (rank - 1) % size, (rank + 1) % size


def process_halo_rows(first, last):
    """(up, dn) of this process's edge slabs, `first` and `last` (the same
    slab where it holds one): up the previous rank's last row, on first's
    device, dn the next rank's first row, on last's device. Every rank of
    the group calls it at the same point. A `halo` span counts the bytes
    received."""
    prev, nxt = _ring_peers()
    with profiling.span("halo") as span:
        up = _sendrecv(last[-1:], nxt, prev, 0, first.device)
        dn = _sendrecv(first[:1], prev, nxt, 1, last.device)
        if span is not None:
            span.counts["bytes"] = up.nbytes + dn.nbytes
    return up, dn


def process_rows_after(slabs, n: int):
    """The n rows that follow this process's last slab: the next rank's
    first n rows (n at most one slab's height), on the last slab's
    device. Every rank of the group calls it at the same point."""
    if n > slabs[0].shape[0]:
        raise ValueError(f"{n} rows after a slab of {slabs[0].shape[0]}")
    prev, nxt = _ring_peers()
    return _sendrecv(slabs[0][:n], prev, nxt, 2, slabs[-1].device)
