"""Devices of the row slabs: a single-controller mesh.

The port of ``ising_tpu/parallel/mesh.py``. The JAX package drives a 1-D
mesh of devices from one process (``shard_map``), as the reference drives
its GPUs from one host process, each with a contiguous row slab
(optimized/main.cu:1602-1658). Here the mesh is an ordered list of torch
devices, one per slab: slab k holds rows [k * local_rows, (k+1) *
local_rows) of both color planes on mesh[k]. A list may name one device
more than once; then its slabs share that device, which is how N slabs
run on one card or on the CPU.
"""

from __future__ import annotations

import torch

from ..config import resolve_device


def make_mesh(ndev: int | None = None, devices=None, device="cuda"):
    """The first `ndev` of `devices` (default: all of them) as a list of
    torch devices. Without `devices`: on CUDA the card's GPUs, cuda:0 ..
    cuda:ndev-1 (never one of them twice); on the CPU the one CPU device
    `ndev` times. Asking for more devices than the list holds raises, as
    the JAX package's make_mesh does."""
    if devices is None:
        dev = resolve_device(device)
        if dev.type == "cuda":
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        else:
            devices = [dev] * (1 if ndev is None else ndev)
    devices = [torch.device(d) for d in devices]
    if ndev is None:
        ndev = len(devices)
    if ndev > len(devices):
        raise ValueError(f"requested {ndev} devices, only {len(devices)} "
                         "present")
    for d in devices[:ndev]:
        resolve_device(d)
    return devices[:ndev]


def slab_devices(cfg, mesh=None):
    """The devices of cfg.ndev row slabs, or None for one device: `mesh`,
    which must name cfg.ndev devices of cfg.device's type, else
    make_mesh(cfg.ndev, device=cfg.device)."""
    if mesh is not None and len(mesh) != cfg.ndev:
        raise ValueError(f"a mesh of {len(mesh)} devices for ndev = "
                         f"{cfg.ndev}")
    if cfg.ndev == 1:
        return None
    mesh = (make_mesh(cfg.ndev, device=cfg.device) if mesh is None
            else make_mesh(devices=mesh))
    if any(d.type != resolve_device(cfg.device).type for d in mesh):
        raise ValueError(f"a mesh of {mesh} for device {cfg.device!r}")
    return mesh


def split_rows(x, mesh):
    """A (Y, ...) tensor as len(mesh) row slabs, slab k a tensor of its own
    on mesh[k]."""
    L = x.shape[0] // len(mesh)
    return [x[k * L:(k + 1) * L].to(d, copy=True)
            for k, d in enumerate(mesh)]


def gather_rows(slabs):
    """The row slabs as one tensor on the first slab's device."""
    dev = slabs[0].device
    return torch.cat([s.to(dev) for s in slabs])
