"""Backend registry of the port. The xla, bit1 and packed backends run
here; the others raise NotImplementedError naming the ROADMAP.md queue-1
item that ports them (see ising_tpu/ops/registry.py for the interface)."""

from __future__ import annotations

from ..config import not_ported

_UNPORTED = {"dense": 9, "mxu": 9}


def available_backends():
    return ("xla", "bit1", "packed")


def get_backend(cfg):
    if cfg.backend == "xla":
        from .xla_ref import XlaBackend
        return XlaBackend(cfg)
    if cfg.backend == "bit1":
        from .bit1 import Bit1Backend
        return Bit1Backend(cfg)
    if cfg.backend == "packed":
        from .packed import PackedBackend
        return PackedBackend(cfg)
    if cfg.backend in _UNPORTED:
        raise not_ported(f"the {cfg.backend!r} backend",
                         _UNPORTED[cfg.backend])
    raise ValueError(f"unknown backend {cfg.backend!r}")
