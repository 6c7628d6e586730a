"""State exchange with the JAX package: its (Y, W1) uint32 bit1 word
planes, as numpy arrays, to and from the port's int32 storage. Both ways
are bit-exact (the same 32 bits, reinterpreted)."""

from __future__ import annotations

import numpy as np
import torch

from .config import resolve_device


def _to_words(a, device):
    a = np.asarray(a)
    if a.dtype != np.uint32 or a.ndim != 2:
        raise TypeError(f"expected a 2-D uint32 word plane, got {a.dtype} "
                        f"with {a.ndim} dimensions")
    return torch.from_numpy(
        np.ascontiguousarray(a).view(np.int32).copy()).to(device)


def from_numpy_words(black_u32, white_u32, device="cuda"):
    """(black, white) uint32 numpy word planes -> int32 tensors on device."""
    dev = resolve_device(device)
    return _to_words(black_u32, dev), _to_words(white_u32, dev)


def to_numpy_words(black, white):
    """(black, white) int32 word tensors -> uint32 numpy word planes."""
    return tuple(t.detach().cpu().contiguous().numpy().view(np.uint32).copy()
                 for t in (black, white))
