"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library with
a plain C interface (no PyTorch headers, so a build takes seconds), which
is loaded with ctypes. The build runs at first use, into
``ising_tpu_torch/_build/``, and is reused while a hash of the sources and
flags matches. Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from ..utils import profiling

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_NAME = "libising_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 600

_c = ctypes
# bit1_planes_launch's threshold table (AcceptTable in bit1_planes.cu): the
# TABLE_KBITS bit-words of t4k and of t8k, the draw-class bits, 10
# always-words, 10 x TABLE_KBITS bit-words
TABLE_KBITS = 24
TABLE_WORDS = 2 * TABLE_KBITS + 1 + 10 + 10 * TABLE_KBITS
# Geometry (bit1_common.cuh): the four link planes, link mode, csl, ysl.
GEOMETRY = [_c.c_void_p] * 4 + [_c.c_int] * 3
# Argument types of the C entry points (pointers and the stream as
# c_void_p, so that ctypes does not cut them to 32 bits).
SIGNATURES = {
    "bit1_sweep_launch": (
        [_c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,  # dst src up dn
         _c.c_int, _c.c_int,                                  # H, W1
         _c.c_uint32, _c.c_uint32, _c.c_uint32, _c.c_int,     # row0 step tag color
         _c.c_uint32, _c.c_uint32, _c.c_uint32,               # thr7 thr8 thr9
         _c.c_uint32, _c.c_uint32,                            # k0 k1
         _c.c_int, _c.c_int, _c.c_int,                        # family rounds greedy
         *GEOMETRY,
         _c.c_void_p],                                        # stream
        _c.c_int),
    "bit1_planes_launch": (
        [_c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,  # dst src up dn
         _c.c_int, _c.c_int,                                  # H, W1
         _c.c_uint32, _c.c_uint32, _c.c_uint32, _c.c_int,     # row0 step tag color
         _c.c_uint32, _c.c_uint32,                            # k0 k1
         _c.c_int, _c.c_int, _c.c_int, _c.c_int,              # family rounds kbits accept
         _c.POINTER(_c.c_uint32),                             # table
         *GEOMETRY,
         _c.c_void_p],                                        # stream
        _c.c_int),
    "packed_sweep_launch": (
        [_c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,  # dst src up dn
         _c.c_int, _c.c_int,                                  # H, W
         _c.c_uint32, _c.c_uint32, _c.c_uint32, _c.c_int,     # row0 step tag color
         _c.POINTER(_c.c_uint32),                             # thr10
         _c.c_uint32, _c.c_uint32,                            # k0 k1
         _c.c_int, _c.c_int, _c.c_int,                        # family rounds accept
         _c.c_void_p, _c.c_int, _c.c_int,                     # jword csl ysl
         _c.c_void_p],                                        # stream
        _c.c_int),
    # packed_fused_step_launch and packed_fused_step_manual_launch
    **{name: (
        [_c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,  # b w b' w'
         _c.c_int, _c.c_int,                                  # H, W
         _c.c_uint32, _c.c_uint32,                            # row0 step
         _c.POINTER(_c.c_uint32),                             # thr10
         _c.c_uint32, _c.c_uint32, _c.c_uint32,               # black: tag k0 k1
         _c.c_uint32, _c.c_uint32, _c.c_uint32,               # white: tag k0 k1
         _c.c_int, _c.c_int, _c.c_int, _c.c_int,              # family rounds accept band
         _c.c_void_p],                                        # stream
        _c.c_int)
       for name in ("packed_fused_step_launch",
                    "packed_fused_step_manual_launch")},
    "packed_fused_step_band": (
        [_c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_int,   # H W family rounds accept
         _c.c_int, _c.POINTER(_c.c_int)],                     # manual, band out
        _c.c_int),
    "dense_sweep_launch": (
        [_c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,  # dst src up dn
         _c.c_int, _c.c_int,                                  # H, C
         _c.c_uint32, _c.c_uint32, _c.c_uint32, _c.c_int,     # row0 step tag color
         _c.POINTER(_c.c_uint32),                             # thr10
         _c.c_uint32, _c.c_uint32,                            # k0 k1
         _c.c_int, _c.c_int,                                  # family rounds
         _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,  # J planes
         _c.c_void_p],                                        # stream
        _c.c_int),
    "mxu_sweep_launch": (
        [_c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,  # dst src up dn
         _c.c_int, _c.c_int, _c.c_int,                        # H, C, cols
         _c.c_uint32, _c.c_uint32, _c.c_uint32, _c.c_int,     # row0 step tag color
         _c.POINTER(_c.c_uint32),                             # thr10
         _c.c_uint32, _c.c_uint32,                            # k0 k1
         _c.c_int, _c.c_int,                                  # family rounds
         _c.c_void_p],                                        # stream
        _c.c_int),
    # the SW labeler's three phases (csrc/cluster_label.cu)
    "label_tile_roots_launch": (
        [_c.c_void_p, _c.c_void_p, _c.c_void_p,               # r d out
         _c.c_int, _c.c_int, _c.c_int, _c.c_int,              # Y X ysl xsl
         _c.c_int, _c.c_int, _c.c_int,                        # ty tx ids
         _c.c_void_p],                                        # stream
        _c.c_int),
    "label_hook_launch": (
        [_c.c_void_p, _c.c_void_p, _c.c_void_p,               # r d parent
         _c.c_int, _c.c_int, _c.c_int, _c.c_int,              # Y X ysl xsl
         _c.c_int, _c.c_int,                                  # ty tx
         _c.c_void_p],                                        # stream
        _c.c_int),
    "label_flatten_launch": (
        [_c.c_void_p, _c.c_void_p,                            # parent labels
         _c.c_int, _c.c_int, _c.c_int, _c.c_int,              # Y X ysl xsl
         _c.c_int, _c.c_int,                                  # ty tx
         _c.c_void_p],                                        # stream
        _c.c_int),
    "bit1_decode_launch": (
        [_c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,  # black white, outs
         _c.c_int, _c.c_int,                                  # H, W1
         _c.c_void_p],                                        # stream
        _c.c_int),
    "ising_cuda_error_string": ([_c.c_int], _c.c_char_p),
}


@dataclasses.dataclass
class BuildInfo:
    path: str
    seconds: float       # nvcc wall time; 0.0 when the cached build was used
    cached: bool
    ptxas: list          # the -Xptxas -v lines: registers, smem, spills


_loaded = None  # (ctypes.CDLL, BuildInfo) once loaded in this process


def find_nvcc() -> str:
    """nvcc from PyTorch's CUDA_HOME, else from PATH; raises if neither."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found (neither under "
                       "torch.utils.cpp_extension.CUDA_HOME nor on PATH): "
                       "the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _source_hash(nvcc: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join((nvcc,) + NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def build() -> BuildInfo:
    """Compile the library unless a build of the same sources exists."""
    nvcc = find_nvcc()
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    ptxas_log = BUILD_DIR / "ptxas.txt"
    digest = _source_hash(nvcc)
    if lib.is_file() and stamp.is_file() and stamp.read_text() == digest:
        lines = ptxas_log.read_text().splitlines() if ptxas_log.is_file() else []
        return BuildInfo(str(lib), 0.0, True, lines)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}.{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    outputs = []
    try:
        for cmd, proc in procs:
            out, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
            outputs.append((cmd, proc.returncode, out))
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    lines = []
    for cmd, code, out in outputs:
        if code != 0:
            raise RuntimeError(f"nvcc failed ({code}):\n{' '.join(cmd)}\n{out}")
        lines += [ln for ln in out.splitlines()
                  if "ptxas" in ln or "stack frame" in ln]
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(link, capture_output=True, text=True,
                          timeout=NVCC_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{' '.join(link)}\n{proc.stdout}{proc.stderr}")
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink()
    os.replace(tmp, lib)
    ptxas_log.write_text("\n".join(lines) + "\n")
    stamp.write_text(digest)
    return BuildInfo(str(lib), seconds, False, lines)


def load():
    """(ctypes library, BuildInfo), building on first use in the process."""
    global _loaded
    if _loaded is None:
        with profiling.setup("kernels") as span:
            info = build()
            lib = ctypes.CDLL(info.path)
            for name, (argtypes, restype) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            span.counts["built"] = not info.cached
        _loaded = (lib, info)
    return _loaded


@functools.lru_cache(maxsize=16)
def _table10(thr: tuple):
    return (_c.c_uint32 * 10)(*thr)


def table10(thr10):
    """The (10,) u32 threshold table thr10[b*5 + n] as the C array the
    launchers take (cached by value)."""
    return _table10(tuple(int(x) for x in thr10))


def check(lib, code: int, what: str):
    """Raise on a non-zero CUDA error code returned by a launcher."""
    if code != 0:
        msg = lib.ising_cuda_error_string(code)
        raise RuntimeError(f"{what}: CUDA error {code} "
                           f"({msg.decode() if msg else 'unknown'})")
