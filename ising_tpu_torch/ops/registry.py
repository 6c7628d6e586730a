"""Backend registry of the port: all five backends of the JAX package
(see ising_tpu/ops/registry.py for the interface)."""

from __future__ import annotations


def available_backends():
    return ("xla", "bit1", "packed", "dense", "mxu")


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
    if cfg.backend == "dense":
        from .dense import DenseBackend
        return DenseBackend(cfg)
    if cfg.backend == "mxu":
        from .mxu import MxuBackend
        return MxuBackend(cfg)
    raise ValueError(f"unknown backend {cfg.backend!r}")
