"""Rows of the neighbouring slabs: the halo exchange of the row slabs.

The port of ``ising_tpu/parallel/halo.py``. The JAX package pushes each
shard's edge rows around the device ring with ``lax.ppermute`` before a
color sweep; the reference's kernels read the neighbouring GPU's edge row
in place (optimized/main.cu:1637-1642). Here the one controller hands
each slab's kernel the two rows it needs: a view of the neighbouring
slab where it shares the device, else a copy onto the slab's device
(``non_blocking``; torch orders it with both devices' current streams).
"""

from __future__ import annotations

import torch


def _on(row, device):
    return row if row.device == device else row.to(device,
                                                   non_blocking=True)


def ring_halo_rows(slabs):
    """[(up, dn)] per slab, each a (1, C) row on the slab's device: up the
    previous slab's last row (global row row0 - 1), dn the next slab's
    first row (global row row0 + H), around the ring. With one slab these
    are its own wrap rows."""
    n = len(slabs)
    return [(_on(slabs[k - 1][-1:], s.device),
             _on(slabs[(k + 1) % n][:1], s.device))
            for k, s in enumerate(slabs)]


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
