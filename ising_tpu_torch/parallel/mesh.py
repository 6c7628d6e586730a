"""Devices of the row slabs: a single-controller mesh.

The port of ``ising_tpu/parallel/mesh.py``. The JAX package drives a 1-D
mesh of devices from one process (``shard_map``), as the reference drives
its GPUs from one host process, each with a contiguous row slab
(optimized/main.cu:1602-1658). Here the mesh is an ordered list of torch
devices, one per slab: slab k holds rows [k * local_rows, (k+1) *
local_rows) of both color planes on mesh[k]. A list may name one device
more than once; then its slabs share that device, which is how N slabs
run on one card or on the CPU.

Across processes (``initialize_multihost``, a torch.distributed group, as
the JAX package spans hosts with ``jax.distributed``), the slabs are
global: rank r of a group of P holds slabs [r * n, (r+1) * n), n = ndev /
P, and its mesh lists the devices of those n. The halo rows at a
process's edge and the observables' integer sums cross processes
(halo.py, ``all_sum``); everything else stays in the process.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..config import resolve_device


def initialize_multihost(*, device="cuda", **kwargs) -> None:
    """Join a torch.distributed group: kwargs go to
    ``torch.distributed.init_process_group`` (init_method, world_size,
    rank, timeout, ...), as the JAX package's hook forwards its own to
    ``jax.distributed.initialize``. Without a `backend`, NCCL where
    `device` is CUDA and gloo on the CPU. A CUDA device with an index
    becomes the process's current device first (a rank a GPU). Call it
    before make_mesh in every process of the group."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    kwargs.setdefault("backend", "nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(**kwargs)


def process_group():
    """(rank, size) of this process's torch.distributed group; (0, 1) where
    none is up."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def first_slab(mesh) -> int:
    """The global index of the first slab of this process's `mesh`."""
    return process_group()[0] * len(mesh)


def refuse_over_processes(what: str):
    """Raise NotImplementedError for `what` in a group of several
    processes."""
    size = process_group()[1]
    if size > 1:
        raise NotImplementedError(
            f"{what} does not run over {size} processes yet "
            "(ROADMAP.md §1, item 18)")


def all_sum(x):
    """The int64 tensor x summed over the group's processes (exact), on
    x's device; x itself where no group is up. Under gloo the partials go
    through host memory."""
    if not (dist.is_available() and dist.is_initialized()):
        return x
    y = x.to("cpu" if dist.get_backend() == "gloo" else x.device,
             copy=True)
    dist.all_reduce(y)
    return y.to(x.device)


def make_mesh(ndev: int | None = None, devices=None, device="cuda"):
    """The first `ndev` of `devices` (default: all of them) as a list of
    torch devices. Without `devices`: on CUDA the card's GPUs, cuda:0 ..
    cuda:ndev-1 (never one of them twice); on the CPU the one CPU device
    `ndev` times. Asking for more devices than the list holds raises, as
    the JAX package's make_mesh does.

    In a group of P processes ndev counts the group's slabs: the result is
    this process's ndev / P devices, on CUDA from its current device on,
    and the refusal counts the devices of all P."""
    rank, size = process_group()
    local = None if ndev is None else ndev // size
    if ndev is not None and ndev % size:
        raise ValueError(f"{ndev} slabs do not split over {size} processes")
    if devices is None:
        dev = resolve_device(device)
        if dev.type == "cuda":
            first = torch.cuda.current_device() if size > 1 else 0
            devices = [torch.device("cuda", i)
                       for i in range(first, torch.cuda.device_count())]
        else:
            devices = [dev] * (1 if local is None else local)
    devices = [torch.device(d) for d in devices]
    if local is None:
        local = len(devices)
    if local > len(devices):
        raise ValueError(f"requested {ndev} devices, only "
                         f"{len(devices) * size} present")
    for d in devices[:local]:
        resolve_device(d)
    return devices[:local]


def slab_devices(cfg, mesh=None):
    """The devices of this process's row slabs, or None for one device:
    `mesh`, which must name cfg.ndev devices of cfg.device's type (in a
    group of P processes, cfg.ndev / P), else make_mesh(cfg.ndev,
    device=cfg.device)."""
    size = process_group()[1]
    if cfg.ndev % size:
        raise ValueError(f"ndev = {cfg.ndev} does not split over {size} "
                         "processes")
    if mesh is not None and len(mesh) != cfg.ndev // size:
        raise ValueError(f"a mesh of {len(mesh)} devices for ndev = "
                         f"{cfg.ndev}" + (f" over {size} processes"
                                          if size > 1 else ""))
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
