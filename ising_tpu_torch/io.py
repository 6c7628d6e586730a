"""Lattice dumps and loads in the reference's text formats (torch).

The port of ``ising_tpu/io.py``, writing the same bytes:

  * "hex": one line per row, one character '0' or '1' per spin in
    full-lattice column order, each line ended by a newline;
  * "txt": space-separated -1/1 integers, one row per line (numpy's
    savetxt with "%d", as the JAX package writes them).

``dump_lattice`` writes hex through the native g++ codec
(native/codec.py, built at first use) and ``load_lattice`` reads it back
through it, as the JAX package's io does where its codec builds; where
g++ is missing, numpy writes and reads the same bytes. The streamed dump
writes with numpy, as the JAX package's does.
A lattice held in row slabs is written one file per slab
(``dump_lattice_sharded``, as the reference writes one per GPU) and
stitched back by ``load_lattice_sharded``. The correlation files of -c
take one line per measurement (``append_corr_line``).
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from .config import resolve_device
from .lattice import bits_to_spins, compact_to_full, full_to_compact

FORMATS = ("hex", "txt")


def _check_format(fmt: str):
    if fmt not in FORMATS:
        raise ValueError(f"unknown dump format {fmt!r}")


def native_codec():
    """The native hex codec (native/codec.py), built on first use; None
    where it cannot be built (no g++), and numpy does its work."""
    from .native import codec
    try:
        codec.load()
    except (OSError, subprocess.SubprocessError):
        return None
    return codec


def full_bits_host(black, white) -> np.ndarray:
    """Compact planes (on any device) -> full {0,1} uint8 lattice on the
    host."""
    return compact_to_full(black, white).cpu().numpy()


def _write_rows(f, full: np.ndarray, fmt: str):
    if fmt == "hex":
        lines = np.empty((full.shape[0], full.shape[1] + 1), np.uint8)
        lines[:, :-1] = full + ord("0")
        lines[:, -1] = ord("\n")
        f.write(lines.tobytes())
    else:
        np.savetxt(f, 2 * full.astype(np.int8) - 1, fmt="%d")


def _read_hex_rows(f) -> np.ndarray:
    """The (rows, cols) {0,1} uint8 lattice of an open hex dump."""
    rows = [np.frombuffer(line, np.uint8) - ord("0")
            for line in (ln.strip() for ln in f) if line]
    return np.stack(rows)


def dump_lattice(path: str, black, white, fmt: str = "hex") -> None:
    """Write compact (black, white) planes to `path` in `fmt`."""
    _check_format(fmt)
    full = full_bits_host(black, white)
    codec = native_codec() if fmt == "hex" else None
    if codec is not None:
        codec.write_hex(path, full)
        return
    with open(path, "wb") as f:
        _write_rows(f, full, fmt)


def dump_lattice_streamed(path: str, decode_rows, nrows: int,
                          fmt: str = "hex", row_chunk: int = 8192) -> None:
    """dump_lattice's bytes, one row chunk at a time: decode_rows(r0, r1)
    -> compact (black, white) planes of rows [r0, r1), so the host holds
    one chunk however tall the lattice."""
    _check_format(fmt)
    with open(path, "wb") as f:
        for r in range(0, nrows, row_chunk):
            _write_rows(f, full_bits_host(
                *decode_rows(r, min(nrows, r + row_chunk))), fmt)


def load_lattice(path: str, fmt: str = "hex", device="cuda"):
    """Read a dump back into compact (black, white) uint8 planes on
    `device`."""
    _check_format(fmt)
    codec = native_codec() if fmt == "hex" else None
    if codec is not None:
        full = codec.read_hex(path)
    elif fmt == "hex":
        with open(path, "rb") as f:
            full = _read_hex_rows(f)
    else:
        full = ((np.loadtxt(path, dtype=np.int8) + 1) // 2).astype(np.uint8)
    return full_to_compact(torch.from_numpy(full).to(resolve_device(device)))


def _shard_path(path: str, k: int) -> str:
    """`<path>_shard000k.<ext>`: the file of row slab k."""
    root, dot, ext = path.rpartition(".")
    return f"{root}_shard{k:04d}.{ext}" if dot else f"{path}_shard{k:04d}"


def dump_lattice_sharded(path: str, black, white, fmt: str = "hex"):
    """One file per row slab, in row order; returns the paths. black and
    white: lists of the slabs' compact planes, or one plane each (one
    slab). Each file is a dump of its slab in dump_lattice's format, so
    load_lattice reads any one of them."""
    if not isinstance(black, (list, tuple)):
        black, white = [black], [white]
    paths = [_shard_path(path, k) for k in range(len(black))]
    for p, b, w in zip(paths, black, white):
        dump_lattice(p, b, w, fmt)
    return paths


def load_lattice_sharded(path: str, fmt: str = "hex", device="cuda"):
    """Stitch the `<path>_shard*.<ext>` files back into compact (black,
    white) planes on `device`."""
    import glob
    import re

    root, dot, ext = path.rpartition(".")
    pattern = f"{root}_shard*.{ext}" if dot else f"{path}_shard*"
    paths = glob.glob(pattern)
    if not paths:
        raise FileNotFoundError(f"no shard files match {pattern!r}")
    paths.sort(key=lambda p: int(re.search(r"_shard(\d+)", p).group(1)))
    planes = [load_lattice(p, fmt, device=device) for p in paths]
    return (torch.cat([b for b, _ in planes]),
            torch.cat([w for _, w in planes]))


def lattice_image(black, white) -> np.ndarray:
    """The full lattice as int8 -1/+1 spins on the host, for plotting."""
    return bits_to_spins(compact_to_full(black, white)).cpu().numpy()


def append_corr_line(path: str, it: int, c) -> None:
    """Append one -c line: the iteration, then each c(d) as `{:< 12G}`."""
    with open(path, "a") as f:
        f.write(f"{it:10d}")
        for val in c:
            f.write(f" {val:< 12G}")
        f.write("\n")
