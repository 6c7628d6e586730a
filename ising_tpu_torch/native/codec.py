"""The native host codec of the port: g++, loaded with ctypes.

The port of ``ising_tpu/native/codec.py``, with its own copy of the C++
(``codec.cpp``, ``chacha.h``): the hex lattice codec, the host hot path
when a multi-gigabyte lattice is dumped or loaded (io.py uses it where it
builds), and independent C++ twins of Philox4x32-10 and ChaCha-R, which
the tests hold the port's rng against. The hex codec writes the JAX
package's bytes and reads what its reader reads, but moves the file in
blocks of a few MiB through one buffer, where the JAX copy writes a row
and reads a byte at a time. Host code, not a kernel: it is built with g++
(-O3 -march=native -shared -fPIC) at first use, not on import, into the
git-ignored ``ising_tpu_torch/_build/`` under a name that carries a hash
of the sources, the flags and the host CPU's features, through a
temporary file and a rename, so that concurrent processes never load a
half-written library. ``load()`` raises where g++ is missing or fails;
io.py then writes and reads the same bytes with numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np

SRC_DIR = Path(__file__).resolve().parent
SOURCES = (SRC_DIR / "codec.cpp", SRC_DIR / "chacha.h")
BUILD_DIR = SRC_DIR.parent / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
BUILD_TIMEOUT_S = 300

_c = ctypes
_u32p = _c.POINTER(_c.c_uint32)
SIGNATURES = {
    "ising_write_hex": ([_c.c_char_p, _c.c_void_p, _c.c_int64, _c.c_int64],
                        _c.c_int),
    "ising_read_hex": ([_c.c_char_p, _c.c_void_p, _c.c_int64,
                        _c.POINTER(_c.c_int64), _c.POINTER(_c.c_int64)],
                       _c.c_int),
    "ising_philox4x32": ([_u32p, _u32p, _c.c_int, _u32p], None),
    "ising_philox_plane": ([_c.c_uint64, _c.c_uint32, _c.c_uint32,
                            _c.c_int64, _c.c_int64, _c.c_int64, _c.c_void_p],
                           None),
    "ising_chacha_block": ([_c.c_uint32] * 6 + [_c.c_int, _u32p], None),
    "ising_chacha_plane": ([_c.c_uint64, _c.c_uint32, _c.c_uint32,
                            _c.c_int64, _c.c_int64, _c.c_int64, _c.c_int,
                            _c.c_void_p], None),
}

_loaded = None  # (ctypes library, build seconds) once loaded in this process


def host_cpu() -> bytes:
    """What -march=native builds for: the CPU's feature flags (Linux), else
    the machine's name, so that a build for another CPU is never loaded."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith((b"flags", b"Features")):
                    return line
    except OSError:
        pass
    return platform.machine().encode()


def library_path() -> Path:
    """The library's path: a hash of the compiler, flags, host CPU and
    sources."""
    h = hashlib.sha256(" ".join(("g++",) + CXX_FLAGS).encode())
    h.update(host_cpu())
    for p in SOURCES:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libising_codec_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """(path, g++ seconds; 0.0 when a build of the same sources exists)."""
    lib = library_path()
    if lib.is_file():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(SOURCES[0]), "-o", tmp],
                       check=True, capture_output=True,
                       timeout=BUILD_TIMEOUT_S)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, time.perf_counter() - t0


def load():
    """(ctypes library, build seconds), building on first use in the
    process; raises OSError or subprocess.SubprocessError where g++ is
    missing or fails."""
    global _loaded
    if _loaded is None:
        path, seconds = build()
        lib = ctypes.CDLL(str(path))
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _loaded = (lib, seconds)
    return _loaded


def _lib():
    return load()[0]


def write_hex(path: str, bits: np.ndarray) -> None:
    """One '0'/'1' character per spin of the (rows, cols) {0,1} array, one
    line a row."""
    bits = np.ascontiguousarray(bits, dtype=np.uint8)
    if bits.ndim != 2:
        raise ValueError(f"write_hex takes a 2-D array, not {bits.shape}")
    rc = _lib().ising_write_hex(path.encode(), bits.ctypes.data,
                                bits.shape[0], bits.shape[1])
    if rc != 0:
        raise OSError(f"native hex write failed ({rc}) for {path}")


def read_hex(path: str) -> np.ndarray:
    """A hex dump back into a (rows, cols) {0,1} uint8 array, in one pass
    over the file. Raises OSError with the JAX package's words: "probe"
    where the file is no lattice (rc -1 to -3), "read" where its last line
    is short (-4)."""
    try:
        size = os.path.getsize(path)
    except OSError:
        size = 0                          # fopen fails: rc -1, as in JAX
    out = np.empty(size, np.uint8)
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    rc = _lib().ising_read_hex(path.encode(), out.ctypes.data, size,
                               ctypes.byref(rows), ctypes.byref(cols))
    if rc != 0:
        what = "read" if rc == -4 else "probe"
        raise OSError(f"native hex {what} failed ({rc}) for {path}")
    return out[:rows.value * cols.value].reshape(rows.value, cols.value)


def philox4x32(ctr, key, rounds: int = 10):
    """One Philox4x32-R block of the 4-word counter under the 2-word key."""
    c = (ctypes.c_uint32 * 4)(*[v & 0xFFFFFFFF for v in ctr])
    k = (ctypes.c_uint32 * 2)(*[v & 0xFFFFFFFF for v in key])
    o = (ctypes.c_uint32 * 4)()
    _lib().ising_philox4x32(c, k, rounds, o)
    return tuple(o)


def philox_plane(seed: int, step: int, tag: int, row0: int, nrows: int,
                 cols: int) -> np.ndarray:
    """Bulk draws with the library's quad contract (for cross-validation)."""
    out = np.empty((nrows, cols), np.uint32)
    _lib().ising_philox_plane(seed & 0xFFFFFFFFFFFFFFFF, step, tag, row0,
                              nrows, cols, out.ctypes.data)
    return out


def chacha_block(c0: int, c1: int, step: int, tag: int, key: tuple,
                 rounds: int = 8):
    """One scalar ChaCha-R block (independent C++ twin, for KATs)."""
    o = (ctypes.c_uint32 * 16)()
    _lib().ising_chacha_block(c0 & 0xFFFFFFFF, c1 & 0xFFFFFFFF,
                              step & 0xFFFFFFFF, tag & 0xFFFFFFFF,
                              key[0] & 0xFFFFFFFF, key[1] & 0xFFFFFFFF,
                              rounds, o)
    return tuple(o)


def chacha_plane(seed: int, step: int, tag: int, row0: int, nrows: int,
                 cols: int, rounds: int = 8) -> np.ndarray:
    """Bulk draws with the library's chacha 16-slot lane-group contract
    (the stream the JAX package's native/rngtest.cpp qualifies)."""
    out = np.empty((nrows, cols), np.uint32)
    _lib().ising_chacha_plane(seed & 0xFFFFFFFFFFFFFFFF, step, tag, row0,
                              nrows, cols, rounds, out.ctypes.data)
    return out
