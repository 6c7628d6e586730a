"""The CUDA sources of the bit1, packed and dense sweeps, compiled for the
CPU and run through the real wrappers.

There is no nvcc here, so csrc/*.cu are compiled with the host C++
compiler over a small header that stands in for the CUDA runtime: one
thread at a time runs the kernel body, in grid order (so shared memory
that thread 0 fills before a barrier is filled before the block's other
threads read it). That checks the
kernels' arithmetic (draw layouts of every rng mode, counters with carry,
neighbours, the u32, bit-serial and 10-class field accepts, the
quenched-disorder links as J planes and as the split link store, the
replica wraps; in the packed kernel ChaCha's pair of words, the 4-bit
rotation at the row's ends, the J word and the replica edges, the row walk
down a band (heights that cross and do not divide it, lone first and last
rows, the slab's edge rows, replica heights the band does not divide), and
the accept through one byte offset a field into a 32-word table, which the
fused step shares; in the dense kernel the per-call sites, the row walk
down a band with its three-row window (heights that cross and do not
divide the band, the lone first and last rows, the slab's edge rows), the
accept through one byte offset into the 64-word shared table, and the J
planes; in bit1's decode the vector widths of 16 and 1 words a thread
and planes that are not 16-byte aligned) against their plain torch version
before any card sees it. The
fused packed step (packed_fused.cu), whose threads meet at barriers, runs
with one fiber a thread (FIBER_SHIM). mxu_sweep.cu (warp-wide mma.sync: a
lane's sums come from all 32 lanes' operands, so one thread at a time
cannot run it) and cluster_label.cu are left out (NOT_EMULATED).
The card itself checks the compiled kernels in chip_smoke.py.
"""

import contextlib
import ctypes
import itertools
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from ising_tpu_torch.models import ising
from ising_tpu_torch.ops import bit1, dense, kernel_lib, packed
from ising_tpu_torch.rng import PORTED_MODES, parse_rng_mode, plane_bits

import torch

CUDA_SHIM = r"""
#pragma once
#include <cstdint>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
inline void __syncthreads() {}
struct uint4 { uint32_t x, y, z, w; };
struct uint2 { uint32_t x, y; };
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) { return {a, b, c, d}; }
inline uint2 make_uint2(uint32_t a, uint32_t b) { return {a, b}; }
// Vector loads and stores off their size's alignment, a fault on the card.
inline int emu_misaligned = 0;
template <class T> inline bool emu_off(const T* p) { return reinterpret_cast<uintptr_t>(p) % sizeof(T); }
template <class T> inline T __ldg(const T* p) { emu_misaligned += emu_off(p); return *p; }
template <class T> inline void __stcs(T* p, T v) { emu_misaligned += emu_off(p); *p = v; }
inline uint32_t __umulhi(uint32_t a, uint32_t b) { return (uint32_t)(((uint64_t)a * b) >> 32); }
inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, uint32_t s) {
  s &= 31; uint64_t v = ((uint64_t)hi << 32) | lo; return (uint32_t)((v << s) >> 32); }
inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, uint32_t s) {
  s &= 31; uint64_t v = ((uint64_t)hi << 32) | lo; return (uint32_t)(v >> s); }
inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  uint64_t v = ((uint64_t)y << 32) | x; uint32_t r = 0;
  for (int i = 0; i < 4; ++i) r |= (uint32_t)(v >> (8 * ((s >> (4 * i)) & 7)) & 0xFF) << (8 * i);
  return r; }
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
inline dim3 blockIdx, threadIdx, blockDim, gridDim;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
template <class F, class... A>
void emulate_launch(dim3 grid, dim3 block, F f, A... a) {
  blockDim = block;
  gridDim = grid;
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned b = 0; b < grid.x; ++b) {
      blockIdx = dim3(b, by);
      for (unsigned ty = 0; ty < block.y; ++ty)
        for (unsigned t = 0; t < block.x; ++t) { threadIdx = dim3(t, ty); f(a...); }
    }
}
"""

# The same for a kernel whose threads pass barriers (packed_fused.cu): one
# ucontext fiber a thread of the block, __syncthreads switching to the next
# thread, a block going on once all its threads wait there (or have
# returned), in forward or reverse thread order (emu_set). Dynamic shared
# memory is one buffer filled with a pattern before each block; cp.async
# copies land at once or, with emu_set, only at the issuing thread's
# wait_group: a read of a row before its barrier or its wait, or a copy into
# a slot that another thread still reads, changes the result.
FIBER_SHIM = CUDA_SHIM.replace("inline void __syncthreads() {}", r"""
#include <algorithm>
#include <cstring>
#include <tuple>
#include <vector>
#include <ucontext.h>
using std::min;
#define __align__(n) alignas(n)
inline ucontext_t emu_main;
inline std::vector<ucontext_t> emu_ctx;
inline std::vector<char> emu_done;
inline int emu_cur = 0, emu_reverse = 0, emu_late = 0;
alignas(16) inline uint32_t emu_smem[1 << 16];
inline void __syncthreads() { swapcontext(&emu_ctx[emu_cur], &emu_main); }
struct EmuCopy { uint32_t* d; const uint32_t* s; int n; };
inline std::vector<std::vector<std::vector<EmuCopy>>> emu_groups;
inline std::vector<std::vector<EmuCopy>> emu_open;
inline void emu_land(const EmuCopy& c) { std::memcpy(c.d, c.s, 4 * c.n); }
inline void emu_cp(uint32_t* d, const uint32_t* s, int n) {
  if (emu_late) emu_open[emu_cur].push_back({d, s, n}); else emu_land({d, s, n}); }
inline void emu_commit() {
  emu_groups[emu_cur].push_back(emu_open[emu_cur]); emu_open[emu_cur].clear(); }
inline void emu_wait(int n) {
  auto& g = emu_groups[emu_cur];
  while (static_cast<int>(g.size()) > n) {
    for (const auto& c : g.front()) emu_land(c);
    g.erase(g.begin());
  } }
extern "C" void emu_set(int reverse, int late) { emu_reverse = reverse; emu_late = late; }""").replace(
    "enum { cudaErrorInvalidValue = 1 };", """enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
template <class F> cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = 3; return 0; }
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = 2; return 0; }""").replace(
    CUDA_SHIM[CUDA_SHIM.index("template <class F, class... A>\nvoid emulate_launch"):],
    r"""template <class F, class... A>
void emu_thread(unsigned lo, unsigned hi) {
  auto* call = reinterpret_cast<std::tuple<F, A...>*>(
      (static_cast<uintptr_t>(hi) << 32) | lo);
  std::apply([](F f, A... a) { (*f)(a...); }, *call);
  emu_done[emu_cur] = 1;
}
template <class F, class... A>
void emulate_launch(dim3 grid, dim3 block, F f, A... a) {
  blockDim = block;
  gridDim = grid;
  const int n = block.x * block.y;
  std::vector<std::vector<char>> stacks(n, std::vector<char>(1 << 16));
  std::tuple<F, A...> call(f, a...);
  const uintptr_t p = reinterpret_cast<uintptr_t>(&call);
  for (unsigned b = 0; b < grid.x; ++b) {
    std::memset(emu_smem, 0xA5, sizeof(emu_smem));
    emu_ctx.assign(n, ucontext_t{});
    emu_done.assign(n, 0);
    emu_groups.assign(n, {});
    emu_open.assign(n, {});
    for (int t = 0; t < n; ++t) {
      getcontext(&emu_ctx[t]);
      emu_ctx[t].uc_stack.ss_sp = stacks[t].data();
      emu_ctx[t].uc_stack.ss_size = stacks[t].size();
      emu_ctx[t].uc_link = &emu_main;
      makecontext(&emu_ctx[t], reinterpret_cast<void (*)()>(emu_thread<F, A...>), 2,
                  static_cast<unsigned>(p), static_cast<unsigned>(p >> 32));
    }
    blockIdx = dim3(b, 0);
    for (bool alive = true; alive;) {
      alive = false;
      for (int i = 0; i < n; ++i) {
        const int t = emu_reverse ? n - 1 - i : i;
        if (emu_done[t]) continue;
        emu_cur = t;
        threadIdx = dim3(t % block.x, t / block.x);
        swapcontext(&emu_main, &emu_ctx[t]);
        alive = alive || !emu_done[t];
      }
    }
  }
}
""")
# packed_fused.cu's text for FIBER_SHIM: its dynamic shared memory and its
# cp.async copies (a plain copy off the card) through the shim's
FIBER_EDITS = (
    ("extern __shared__ __align__(16) uint32_t smem[];",
     "uint32_t* smem = emu_smem;"),
    ("  *dst = *src;\n#endif", "  emu_cp(dst, src, 1);\n#endif"),
    ("  for (int i = 0; i < 4; ++i) dst[i] = src[i];\n#endif",
     "  emu_cp(dst, src, 4);\n#endif"),
    ('  asm volatile("cp.async.commit_group;\\n" ::);\n#endif',
     '  asm volatile("cp.async.commit_group;\\n" ::);\n#else\n  emu_commit();\n#endif'),
    ('  asm volatile("cp.async.wait_group %0;\\n" ::"n"(N));\n#endif',
     '  asm volatile("cp.async.wait_group %0;\\n" ::"n"(N));\n#else\n  emu_wait(N);\n#endif'),
)

# kernel<T...><<<grid, block, smem, stream>>>(args)  ->  emulate_launch(grid, block, &kernel<T...>, args)
LAUNCH = re.compile(r"(\w+(?:<[^<>]*>)?)<<<([^,>]+),\s*([^,>]+),[^>]*>>>\(")
EMULATED_LAUNCH_SITES = {"bit1_sweep.cu": 1, "bit1_planes.cu": 1,
                         "bit1_decode.cu": 1, "packed_sweep.cu": 1,
                         "dense_sweep.cu": 1, "packed_fused.cu": 1}
# Sources whose threads meet at barriers, run by FIBER_SHIM: packed_fused.cu's
# rings of rows refilled behind a barrier on every row (a thread computes
# from rows the others copied or wrote) and its cp.async.
FIBER_EMULATED = {"packed_fused.cu": ("packed_fused_step_launch",
                                      "packed_fused_step_manual_launch",
                                      "packed_fused_step_band")}
# Sources that one thread at a time cannot run: mxu_sweep.cu's warp-wide
# mma.sync products (each lane's accumulators take operands from all 32
# lanes; tests/test_torch_mxu.py models its fragments instead);
# cluster_label.cu's block-wide barriers between its phases (a
# thread's union-find reads what the others wrote before the barrier), its
# warp votes, its shared-memory atomics and its device-memory
# compare-and-swap between threads. chip_smoke.py holds those kernels
# against their plain versions on the card.
NOT_EMULATED = {"mxu_sweep.cu": ("mxu_sweep_launch",),
                "cluster_label.cu": ("label_tile_roots_launch",
                                     "label_hook_launch",
                                     "label_flatten_launch"),
                **FIBER_EMULATED}


@pytest.fixture(scope="module")
def emulated_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++) to emulate the kernel")
    d = tmp_path_factory.mktemp("emu")
    (d / "cuda_runtime.h").write_text(CUDA_SHIM)
    sources = []
    for cu in kernel_lib._sources():
        if cu.name in NOT_EMULATED:
            continue
        src, n = LAUNCH.subn(r"emulate_launch(\2, \3, &\1, ", cu.read_text())
        # the bit1, decode and packed kernels' one templated launch each;
        # the dense kernel's words of four sites and of one
        assert n == EMULATED_LAUNCH_SITES[cu.name]
        sources.append(d / (cu.stem + ".cpp"))
        sources[-1].write_text(src)
    out = d / "libemu.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{d}",
                    f"-I{kernel_lib.CSRC_DIR}", "-o", str(out),
                    *map(str, sources)], check=True, capture_output=True,
                   timeout=300)
    lib = ctypes.CDLL(str(out))
    for name, (argtypes, restype) in kernel_lib.SIGNATURES.items():
        if any(name in names for names in NOT_EMULATED.values()):
            continue
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = restype
    return lib


@pytest.fixture(scope="module")
def fiber_lib(tmp_path_factory):
    """FIBER_EMULATED's sources, compiled over FIBER_SHIM."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++) to emulate the kernel")
    d = tmp_path_factory.mktemp("fiber")
    (d / "cuda_runtime.h").write_text(FIBER_SHIM)
    sources = []
    for name in FIBER_EMULATED:
        src, n = LAUNCH.subn(r"emulate_launch(\2, \3, &\1, ",
                             (kernel_lib.CSRC_DIR / name).read_text())
        assert n == EMULATED_LAUNCH_SITES[name]
        for old, new in FIBER_EDITS:
            assert src.count(old) == 1, old
            src = src.replace(old, new)
        sources.append(d / (Path(name).stem + ".cpp"))
        sources[-1].write_text(src)
    out = d / "libfiber.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{d}",
                    f"-I{kernel_lib.CSRC_DIR}", "-o", str(out),
                    *map(str, sources)], check=True, capture_output=True,
                   timeout=300)
    lib = ctypes.CDLL(str(out))
    for names in FIBER_EMULATED.values():
        for name in names:
            getattr(lib, name).argtypes, getattr(lib, name).restype = (
                kernel_lib.SIGNATURES[name])
    lib.emu_set.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib


class HostWords:
    """A numpy word plane that the wrapper takes for a CUDA tensor."""

    def __init__(self, a):
        self.a = np.ascontiguousarray(a, np.uint32)
        self.shape = self.a.shape
        self.device = torch.device("cuda", 0)
        self.dtype = torch.int32

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return self.a.ctypes.data

    def numel(self):
        return self.a.size

    def element_size(self):
        return self.a.itemsize


def _torch(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32).copy())


# (temperature, field): T > 0, the greedy quench, and in the bit-plane
# modes the 10-class field accept (which covers T <= 0 itself).
ACCEPTS = ((1.5, 0.0), (0.0, 0.0), (1.5, 0.3), (0.0, -0.2))
CASES = [c for c in itertools.product(
    [(2, 1), (6, 3), (16, 2), (8, 256)], PORTED_MODES, ACCEPTS,
    (0, 1), (0, (1 << 29) - 4, (1 << 32) - 2))
    if not c[2][1] or bit1.accept_bits(c[1])]


@pytest.mark.parametrize("shape", sorted({c[0] for c in CASES}))
def test_kernel_source_matches_plain_version(shape, emulated_lib, monkeypatch):
    monkeypatch.setattr(kernel_lib, "load", lambda: (emulated_lib, None))
    monkeypatch.setattr(bit1, "_cuda_stream", lambda device: None)
    gen = np.random.default_rng(shape[0] * 1000 + shape[1])
    H, W1 = shape
    for _, mode, (temp, field), color, row0 in (c for c in CASES
                                                if c[0] == shape):
        dst, src = (gen.integers(0, 1 << 32, (H, W1), dtype=np.uint64)
                    .astype(np.uint32) for _ in range(2))
        up, dn = (gen.integers(0, 1 << 32, (1, W1), dtype=np.uint64)
                  .astype(np.uint32) for _ in range(2))
        thr = ising.threshold_table(temp, field)
        kw = dict(color=color, seed=int(gen.integers(0, 1 << 63)),
                  rng_mode=mode, greedy=temp <= 0,
                  **bit1.plane_accept_args(mode, temp, field))
        step = int(gen.integers(0, 1 << 32))
        want = bit1.bit1_sweep_reference(_torch(dst), _torch(src), _torch(up),
                                         _torch(dn), thr, row0, step, **kw)
        d = HostWords(dst)
        bit1.bit1_sweep(d, HostWords(src), HostWords(up), HostWords(dn), thr,
                        row0, step, **kw)
        np.testing.assert_array_equal(
            d.a, want.numpy().view(np.uint32),
            err_msg=f"{shape} {mode} T={temp} h={field} color={color} "
                    f"row0={row0}")


def _random(gen, shape):
    return gen.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


# (path, (H, W1), csl, ysl): J planes, the split link store, and replicas
# (csl == 1, csl == W1 and between; ysl == 8, ysl == H and ysl == 2), alone
# and with J planes.
GEOMETRIES = [
    ("jplanes", (6, 3), None, None), ("jplanes", (8, 256), None, None),
    ("split", (2, 1), None, None), ("split", (6, 3), None, None),
    ("split", (16, 8), None, None),
    ("replicas", (16, 4), 1, 8), ("replicas", (16, 4), 4, 16),
    ("replicas", (8, 256), 64, 8), ("replicas", (4, 6), 3, 2),
    ("replicas+J", (16, 4), 2, 16), ("replicas+J", (16, 4), 4, 8),
    ("replicas+J", (8, 3), 1, 8),
]


@pytest.mark.parametrize("geometry", GEOMETRIES,
                         ids=[f"{g[0]}-{g[1][0]}x{g[1][1]}-{g[2]}-{g[3]}"
                              for g in GEOMETRIES])
def test_kernel_source_matches_plain_version_geometry(geometry, emulated_lib,
                                                      monkeypatch):
    """Every mode, both colors and every accept (in turn) on the
    disordered and replica paths of load_site."""
    monkeypatch.setattr(kernel_lib, "load", lambda: (emulated_lib, None))
    monkeypatch.setattr(bit1, "_cuda_stream", lambda device: None)
    path, (H, W1), csl, ysl = geometry
    gen = np.random.default_rng(GEOMETRIES.index(geometry))
    for i, mode in enumerate(PORTED_MODES):
        accepts = [a for a in ACCEPTS if not a[1] or bit1.accept_bits(mode)]
        temp, field = accepts[i % len(accepts)]
        color = i % 2
        dst, src = _random(gen, (H, W1)), _random(gen, (H, W1))
        up, dn = _random(gen, (1, W1)), _random(gen, (1, W1))
        links = [_random(gen, (H, W1)) for _ in range(4)]
        if path in ("jplanes", "split"):
            csl = ysl = None
        kw = dict(color=color, seed=int(gen.integers(0, 1 << 63)),
                  rng_mode=mode, greedy=temp <= 0, csl=csl, ysl=ysl,
                  split_links=path == "split",
                  **bit1.plane_accept_args(mode, temp, field))
        thr = ising.threshold_table(temp, field)
        step, row0 = int(gen.integers(0, 1 << 32)), 2 * i
        jt = None if path == "replicas" else [_torch(p) for p in links]
        want = bit1.bit1_sweep_reference(_torch(dst), _torch(src), _torch(up),
                                         _torch(dn), thr, row0, step, jt, **kw)
        d = HostWords(dst)
        jh = None if path == "replicas" else [HostWords(p) for p in links]
        bit1.bit1_sweep(d, HostWords(src), HostWords(up), HostWords(dn), thr,
                        row0, step, jh, **kw)
        np.testing.assert_array_equal(
            d.a, want.numpy().view(np.uint32),
            err_msg=f"{geometry} {mode} T={temp} h={field} color={color}")


# bit1's row walk (csrc/bit1_common.cuh): a thread walks a band of rows down
# its word column. (path, (H, W1), csl, ysl): heights 1 and 2 (lone rows,
# both edge rows from src_up and src_dn), 13 and 21 (odd: cross the band and
# do not divide it) and 48, at widths 1 (the 1-bit rotation at a lane that
# is both the first and the last), 3 and 33; the split link store across a
# band edge and at rows 0 and H - 1; J planes; replicas of 6, 12 and 16 rows
# in 48 (one of them neither divides the band nor is a multiple of it) and
# ysl == H, alone and with J planes. Every mode runs on each, in an accept,
# a color and a row0 (0 or 2^32 - 2: a global row that wraps and counters
# that carry) that turn with the mode and the geometry.
def bit1_band() -> int:
    """The rows a bit1 thread walks (csrc/bit1_common.cuh: BAND_ROWS)."""
    src = (kernel_lib.CSRC_DIR / "bit1_common.cuh").read_text()
    return int(re.search(r"constexpr int BAND_ROWS = (\d+);", src)[1])


BIT1_BAND = bit1_band()
BIT1_WALK_GEOMETRIES = [
    *(("ordered", (H, W1), None, None) for H in (1, 2, 13, 21, 48)
      for W1 in (1, 3, 33)),
    ("ordered", (2 * BIT1_BAND + 3, 2), None, None),
    ("split", (1, 3), None, None), ("split", (2, 33), None, None),
    ("split", (13, 1), None, None), ("split", (21, 33), None, None),
    ("split", (2 * BIT1_BAND + 1, 3), None, None),
    ("jplanes", (1, 33), None, None), ("jplanes", (13, 3), None, None),
    ("jplanes", (48, 33), None, None), ("jplanes", (21, 3), None, None),
    ("jplanes", (2 * BIT1_BAND + 1, 33), None, None),
    ("replicas", (48, 33), 11, 6), ("replicas", (48, 3), 1, 12),
    ("replicas", (48, 33), 33, 48), ("replicas", (21, 3), 3, 21),
    ("replicas", (13, 1), 1, 13), ("replicas", (2, 3), 3, 2),
    ("replicas", (48, 3), 3, 16),
    ("replicas+J", (48, 3), 3, 6), ("replicas+J", (48, 33), 1, 12),
    ("replicas+J", (48, 33), 33, 16),
    ("replicas+J", (21, 33), 11, 21), ("replicas+J", (1, 3), 1, 1),
]


@pytest.mark.parametrize("geometry", BIT1_WALK_GEOMETRIES,
                         ids=[f"{g[0]}-{g[1][0]}x{g[1][1]}-{g[2]}-{g[3]}"
                              for g in BIT1_WALK_GEOMETRIES])
def test_bit1_walk_matches_plain_version(geometry, emulated_lib, monkeypatch):
    monkeypatch.setattr(kernel_lib, "load", lambda: (emulated_lib, None))
    monkeypatch.setattr(bit1, "_cuda_stream", lambda device: None)
    path, (H, W1), csl, ysl = geometry
    g = BIT1_WALK_GEOMETRIES.index(geometry)
    gen = np.random.default_rng(400 + g)
    for i, mode in enumerate(PORTED_MODES):
        # the accept, then the color, then row0 turn with the mode and the
        # geometry both, so that each mode meets each of them on the walk
        accepts = [a for a in ACCEPTS if not a[1] or bit1.accept_bits(mode)]
        k = i + g
        temp, field = accepts[k % len(accepts)]
        color = k // len(accepts) % 2
        row0 = (0, (1 << 32) - 2)[k // (2 * len(accepts)) % 2]
        dst, src = _random(gen, (H, W1)), _random(gen, (H, W1))
        up, dn = _random(gen, (1, W1)), _random(gen, (1, W1))
        links = None if path in ("ordered", "replicas") else [
            _random(gen, (H, W1)) for _ in range(4)]
        kw = dict(color=color, seed=int(gen.integers(0, 1 << 63)),
                  rng_mode=mode, greedy=temp <= 0, csl=csl, ysl=ysl,
                  split_links=path == "split",
                  **bit1.plane_accept_args(mode, temp, field))
        thr = ising.threshold_table(temp, field)
        step = int(gen.integers(0, 1 << 32))
        want = bit1.bit1_sweep_reference(
            _torch(dst), _torch(src), _torch(up), _torch(dn), thr, row0, step,
            None if links is None else [_torch(p) for p in links], **kw)
        d = HostWords(dst)
        bit1.bit1_sweep(d, HostWords(src), HostWords(up), HostWords(dn), thr,
                        row0, step,
                        None if links is None else [HostWords(p) for p in links],
                        **kw)
        np.testing.assert_array_equal(
            d.a, want.numpy().view(np.uint32),
            err_msg=f"{geometry} {mode} T={temp} h={field} color={color} "
                    f"row0={row0}")


def test_bit1_walk_geometries_cover_the_edges():
    assert len(set(BIT1_WALK_GEOMETRIES)) == len(BIT1_WALK_GEOMETRIES)
    band = BIT1_BAND
    assert band % 2 == 0
    ordered = {g[1] for g in BIT1_WALK_GEOMETRIES if g[0] == "ordered"}
    assert {(h, w) for h in (1, 2, 13, 21, 48) for w in (1, 3, 33)} <= ordered
    # heights that cross the band and do not divide it, odd (a lone last
    # row), on every path
    for path in ("ordered", "split", "jplanes", "replicas", "replicas+J"):
        heights = {g[1][0] for g in BIT1_WALK_GEOMETRIES if g[0] == path}
        assert any(h > band and h % band and h % 2 for h in heights), path
    assert {1, 2} <= {g[1][0] for g in BIT1_WALK_GEOMETRIES if g[0] == "split"}
    rep = [g for g in BIT1_WALK_GEOMETRIES if g[0].startswith("replicas")]
    for path in ("replicas", "replicas+J"):
        ysls = [(g[1][0], g[3]) for g in rep if g[0] == path]
        assert any(y % band and band % y and h > y for h, y in ysls), path
        assert any(h == y for h, y in ysls)
    assert {6, 12} <= {g[3] for g in rep}
    assert {g[2] == g[1][1] for g in rep} == {True, False}
    # each geometry runs every mode: both colors and both row0 among them
    assert len(PORTED_MODES) >= 4


def _jax_bit1():
    """The JAX package's bit1 helpers and jnp (plain jnp functions on the
    CPU: no Pallas kernel runs)."""
    import jax.numpy as jnp
    from ising_tpu.ops import pallas_bit1
    return pallas_bit1, jnp


def _kernel_lt_chain(planes, words, kbits):
    """The planes kernel's strict less-than recurrence (bit1_planes.cu:
    lt_step): a' = majority(T_z, ~u, a) over the planes LSB-first, T_z the
    table's whole word for bit z of the threshold."""
    a = np.zeros_like(planes[0])
    for z in range(kbits):
        nu = ~planes[z]
        a = (words[z] & (nu | a)) | (nu & a)
    return a


def _bitsliced_counts(gen, shape):
    """(me, n0, n1, n2) of random words: n the bit-sliced count of four
    random neighbour words (bit1.py:_neighbor_adder)."""
    me, up, dn, same, off = (_random(gen, shape) for _ in range(5))
    n0, n1, n2 = bit1._neighbor_adder(up, dn, same, off)
    return me, n0, n1, n2


@pytest.mark.parametrize("kbits", [16, 24])
def test_plane_step_is_the_jax_lt_chain(kbits):
    """One LOP3 a plane and threshold, reading the T_z words that
    accept_table lays out, equals the JAX helper _bitserial_lt_planes
    (pallas_bit1.py:146) on random planes, at real and edge thresholds."""
    jbit1, jnp = _jax_bit1()
    gen = np.random.default_rng(500 + kbits)
    K = kernel_lib.TABLE_KBITS
    pairs = [ising.bernoulli_kbit_thresholds(t, kbits)
             for t in (0.5, 1.0, 1.5, 2.269, 3.0, 10.0)]
    pairs += [(0, 0), ((1 << kbits) - 1, 0), (1, (1 << kbits) - 1)]
    pairs += [tuple(int(x) for x in gen.integers(0, 1 << kbits, 2))
              for _ in range(6)]
    planes = [_random(gen, (3, 40)) for _ in range(kbits)]
    for t4k, t8k in pairs:
        table = np.array(list(bit1.accept_table(kbits, t4k, t8k, None, 0)),
                         np.uint32)
        a4 = _kernel_lt_chain(planes, table[:K], kbits)
        a8 = _kernel_lt_chain(planes, table[K:2 * K], kbits)
        want = jbit1._bitserial_lt_planes([jnp.asarray(p) for p in planes],
                                          40, kbits, t4k, t8k)
        np.testing.assert_array_equal(a4, np.asarray(want[0]),
                                      err_msg=f"t4k={t4k}")
        np.testing.assert_array_equal(a8, np.asarray(want[1]),
                                      err_msg=f"t8k={t8k}")
        np.testing.assert_array_equal(planes[0], np.asarray(want[2]))


@pytest.mark.parametrize("kbits", [16, 24])
def test_field_chains_are_the_jax_field_flip(kbits):
    """The planes kernel's field accept (bit1_planes.cu: always-classes
    flip, each class that draws its own chain of one LOP3 a plane on the
    table's bit-words) equals the JAX helper _bitserial_field_flip on
    random planes and counts, at real thresholds and at random tables in
    which every class in turn always flips, draws, or never flips."""
    jbit1, jnp = _jax_bit1()
    gen = np.random.default_rng(600 + kbits)
    K = kernel_lib.TABLE_KBITS
    tables = [ising.field_kbit_thresholds(t, h, kbits)
              for t, h in ((1.5, 0.3), (1.5, -0.2), (0.0, 0.2), (0.0, -0.2),
                           (2.269, 1.5), (0.7, 0.05))]
    for _ in range(12):
        kind = gen.integers(0, 3, 10)   # 0 never, 1 draws, 2 always
        tvals = tuple(int(gen.integers(1, 1 << kbits)) if k == 1 else 0
                      for k in kind)
        tables.append((tvals, sum(1 << c for c in range(10) if kind[c] == 2)))
    kinds = set()
    me, n0, n1, n2 = _bitsliced_counts(gen, (3, 40))
    planes = [_random(gen, (3, 40)) for _ in range(kbits)]
    n_eq = (~(n2 | n1 | n0), ~(n2 | n1) & n0, ~(n2 | n0) & n1, n1 & n0, n2)
    for tvals10, always10 in tables:
        table = np.array(list(bit1.accept_table(kbits, 0, 0, tuple(tvals10),
                                                always10)), np.uint32)
        draws, always = int(table[2 * K]), table[2 * K + 1:2 * K + 11]
        bits = table[2 * K + 11:].reshape(10, K)
        flip = np.zeros_like(me)
        for c in range(10):
            cls = (me if c >= 5 else ~me) & n_eq[c % 5]
            flip |= cls & always[c]
            if draws >> c & 1:
                flip |= cls & _kernel_lt_chain(planes, bits[c], kbits)
            kinds.add((c, 2 if always10 >> c & 1 else 1 if draws >> c & 1
                       else 0))
        want = jbit1._bitserial_field_flip(
            [jnp.asarray(p) for p in planes], jnp.asarray(me),
            jnp.asarray(n0), jnp.asarray(n1), jnp.asarray(n2), 40, kbits,
            tuple(tvals10), always10)
        np.testing.assert_array_equal(flip, np.asarray(want),
                                      err_msg=f"{tvals10} {always10:#x}")
    assert kinds == {(c, k) for c in range(10) for k in range(3)}


def test_cases_cover_every_mode_and_accept():
    assert {c[1] for c in CASES} == set(PORTED_MODES)
    plane = {c[1] for c in CASES if c[2][1]}
    assert plane == {m for m in PORTED_MODES if plane_bits(m) or m == "hw"}


def _past_boundary(a, misaligned: bool):
    """A copy of `a` whose data lies 4 bytes past a 16-byte boundary where
    `misaligned` (where a view's pointer can sit), else on one."""
    n = a.size * a.itemsize
    buf = np.empty(n + 32, np.uint8)
    start = (4 * misaligned - buf.ctypes.data) % 16
    view = buf[start:start + n].view(a.dtype).reshape(a.shape)
    view[...] = a
    return view


class HostBytes:
    """A numpy byte plane, filled with a pattern that no decoded byte (0 or
    1) has, that the wrapper allocates in place of a CUDA tensor."""

    def __init__(self, shape, misaligned: bool):
        self.a = _past_boundary(np.full(shape, 0xA5, np.uint8), misaligned)

    def data_ptr(self):
        return self.a.ctypes.data


# bit1's decode (csrc/bit1_decode.cu): W1 of 16 and 64 take 16 words a
# thread, 1, 3, 4, 17 and 20 one; heights 1, 2, 5 and 8; the planes and
# their outputs 16-byte aligned (the wide path) or not (one word a
# thread).
DECODE_WIDTHS = (1, 3, 4, 16, 17, 20, 64)


@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("W1", DECODE_WIDTHS)
def test_decode_kernel_source_matches_unpack_bits1(W1, misaligned,
                                                   emulated_lib, monkeypatch):
    """Both planes through the real wrapper, byte for byte against
    unpack_bits1, words with the sign bit set among them; no vector load
    or store off its alignment."""
    monkeypatch.setattr(kernel_lib, "load", lambda: (emulated_lib, None))
    monkeypatch.setattr(bit1, "_cuda_stream", lambda device: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    real_empty = torch.empty

    def empty(shape, *, dtype, device):
        if torch.device(device).type == "cuda":
            assert dtype == torch.uint8
            return HostBytes(shape, misaligned)
        return real_empty(shape, dtype=dtype, device=device)

    gen = np.random.default_rng(W1 * 2 + misaligned)
    for H in (1, 2, 5, 8):
        planes = [_random(gen, (H, W1)) for _ in range(2)]
        planes[0][0, 0], planes[1][-1, -1] = 0x80000000, 0xFFFFFFFF
        want = [bit1.unpack_bits1(_torch(p)).numpy() for p in planes]
        black, white = (HostWords(_past_boundary(p, misaligned))
                        for p in planes)
        misaligned_ops = ctypes.c_int.in_dll(emulated_lib, "emu_misaligned")
        misaligned_ops.value = 0
        n0 = bit1.bit1_decode.launches
        with monkeypatch.context() as m:
            m.setattr(torch, "empty", empty)
            got = bit1.bit1_decode(black, white)
        assert bit1.bit1_decode.launches == n0 + 1
        ptrs = [t.data_ptr() for t in (black, white, *got)]
        assert all((q % 16 != 0) == misaligned for q in ptrs)
        assert misaligned_ops.value == 0
        for g, w, color in zip(got, want, ("black", "white")):
            np.testing.assert_array_equal(
                g.a, w, err_msg=f"{color} H={H} W1={W1} "
                                f"misaligned={misaligned}")


def test_decode_launcher_refuses_empty_planes(emulated_lib):
    buf = np.full((2, 4), 0xFFFFFFFF, np.uint32)
    out = np.zeros((2, 128), np.uint8)
    p, o = buf.ctypes.data, out.ctypes.data
    for H, W1 in ((0, 4), (2, 0), (-1, 4)):
        assert emulated_lib.bit1_decode_launch(p, p, o, o, H, W1, None) != 0
    assert not out.any()
    assert emulated_lib.bit1_decode_launch(p, p, o, o, 2, 4, None) == 0
    assert (out == 1).all()


NO_LINKS = (None, None, None, None, 0, 0, 0)


def test_launcher_refuses_unknown_rounds(emulated_lib):
    buf = np.zeros((2, 1), np.uint32)
    p = buf.ctypes.data
    code = emulated_lib.bit1_sweep_launch(p, p, p, p, 2, 1, 0, 0, 0, 0, 0, 0,
                                          0, 0, 0, 0, 9, 0, *NO_LINKS, None)
    assert code != 0
    assert Path(kernel_lib.CSRC_DIR / "bit1_sweep.cu").is_file()
    table = (ctypes.c_uint32 * kernel_lib.TABLE_WORDS)()
    for family, rounds, kbits, accept in ((0, 10, 16, 0), (2, 8, 24, 0),
                                          (1, 20, 16, 1), (2, 8, 16, 3)):
        assert emulated_lib.bit1_planes_launch(
            p, p, p, p, 2, 1, 0, 0, 0, 0, 0, 0, family, rounds, kbits,
            accept, table, *NO_LINKS, None) != 0
    assert emulated_lib.bit1_planes_launch(
        p, p, p, p, 2, 1, 0, 0, 0, 0, 0, 0, 2, 8, 16, 0, table, *NO_LINKS,
        None) == 0


@pytest.mark.parametrize("geometry,ok", [
    ((None,) * 4 + (0, 0, 0), True),
    ((1,) * 4 + (1, 2, 4), True),        # J planes, csl | W1, ysl | H
    ((1,) * 4 + (2, 0, 0), True),        # split links
    ((1,) * 4 + (3, 0, 0), False),       # unknown link mode
    ((1,) * 4 + (2, 2, 0), False),       # split links with replicas
    ((1, 1, None, 1, 1, 0, 0), False),   # a missing J plane
    ((None,) * 4 + (0, 3, 0), False),    # csl does not divide W1 = 4
    ((None,) * 4 + (0, 0, 3), False),    # ysl does not divide H = 4
    ((None,) * 4 + (0, -1, 0), False),
])
def test_launchers_check_geometry(emulated_lib, geometry, ok):
    buf = np.zeros((4, 4), np.uint32)
    p = buf.ctypes.data
    links = [p if x == 1 else x for x in geometry[:4]]
    g = (*links, *geometry[4:])
    table = (ctypes.c_uint32 * kernel_lib.TABLE_WORDS)()
    codes = (emulated_lib.bit1_sweep_launch(p, p, p, p, 4, 4, 0, 0, 0, 0, 0,
                                            0, 0, 0, 0, 0, 10, 0, *g, None),
             emulated_lib.bit1_planes_launch(p, p, p, p, 4, 4, 0, 0, 0, 0, 0,
                                             0, 2, 8, 16, 0, table, *g, None))
    assert codes == ((0, 0) if ok else (1, 1))


# The packed kernel: the u32 modes and hw, T > 0, the greedy quench and the
# full table (h != 0, also at T <= 0), on words with every bit random (bit
# 31 included, which the 4-bit rotation at lane 0 fills from field 7).
PACKED_MODES = [m for m in PORTED_MODES if not plane_bits(m)]
PACKED_ACCEPTS = ((1.5, 0.0), (0.0, 0.0), (1.5, 0.3), (0.0, -0.2))
# (path, (H, W), csl, ysl): W odd and W = 1 for the one-word families (not
# ChaCha, whose thread owns words q and q + W/2), W = 66 (ncols 1056, not a
# multiple of 32); the J word; replicas with csl == 1, csl == W and between,
# ysl == 2, 8 and H; replicas with the J word. A thread walks a band of rows
# (packed_band): heights 1 (both edge rows from src_up and src_dn) and 2, a
# band and one row, two bands and three rows, odd heights that cross the
# band and do not divide it (lone first and last rows: color 1 starts the
# bands a row up), on the ordered and J-word paths; replicas ysl rows tall
# that the band does not divide (3, 6, 12), alone and with the J word.
def packed_band() -> int:
    """The rows a packed thread walks (csrc/packed_sweep.cu: band_rows)."""
    src = (kernel_lib.CSRC_DIR / "packed_sweep.cu").read_text()
    chacha, other = re.search(
        r"band_rows\(int family\) \{\s*return family == FAMILY_CHACHA \? "
        r"(\d+) : (\d+);", src).groups()
    assert chacha == other
    return int(other)


PACKED_BAND = packed_band()
PACKED_GEOMETRIES = [
    ("ordered", (2, 2), None, None), ("ordered", (6, 6), None, None),
    ("ordered", (8, 66), None, None), ("ordered", (4, 3), None, None),
    ("ordered", (2, 1), None, None),
    ("jword", (6, 4), None, None), ("jword", (8, 66), None, None),
    ("replicas", (16, 4), 1, 8), ("replicas", (16, 4), 4, 16),
    ("replicas", (8, 66), 33, 8), ("replicas", (4, 6), 3, 2),
    ("replicas+J", (16, 4), 2, 16), ("replicas+J", (8, 6), 1, 8),
    ("replicas+J", (8, 66), 66, 2),
    ("ordered", (1, 6), None, None), ("ordered", (PACKED_BAND + 1, 2), None, None),
    ("ordered", (2 * PACKED_BAND + 3, 6), None, None),
    ("ordered", (PACKED_BAND + 3, 1), None, None),
    ("jword", (1, 2), None, None), ("jword", (2, 66), None, None),
    ("jword", (2 * PACKED_BAND + 3, 2), None, None),
    ("replicas", (2 * PACKED_BAND + 2, 4), 2, PACKED_BAND + 1),
    ("replicas", (24, 2), 1, 6), ("replicas", (21, 6), 3, 3),
    ("replicas+J", (3 * (PACKED_BAND // 2 + 1), 6), 6, PACKED_BAND // 2 + 1),
    ("replicas+J", (2 * PACKED_BAND + 2, 2), 2, PACKED_BAND + 1),
]


@pytest.mark.parametrize("geometry", PACKED_GEOMETRIES,
                         ids=[f"{g[0]}-{g[1][0]}x{g[1][1]}-{g[2]}-{g[3]}"
                              for g in PACKED_GEOMETRIES])
def test_packed_kernel_source_matches_plain_version(geometry, emulated_lib,
                                                    monkeypatch):
    """Every u32 mode and hw in every accept, both colors, row offsets
    whose counters carry into the high word and rows that wrap mod 2^32."""
    monkeypatch.setattr(kernel_lib, "load", lambda: (emulated_lib, None))
    monkeypatch.setattr(packed, "_cuda_stream", lambda device: None)
    path, (H, W), csl, ysl = geometry
    gen = np.random.default_rng(100 + PACKED_GEOMETRIES.index(geometry))
    for i, (mode, (temp, field)) in enumerate(itertools.product(
            PACKED_MODES, PACKED_ACCEPTS)):
        if mode.startswith("chacha") and W % 2:
            continue
        color = i % 2
        row0 = (0, (1 << 29) - 4, (1 << 32) - 2)[i % 3]
        dst, src = _random(gen, (H, W)), _random(gen, (H, W))
        up, dn = _random(gen, (1, W)), _random(gen, (1, W))
        jword = _random(gen, (H, W)) if path.endswith("J") or \
            path == "jword" else None
        kw = dict(color=color, seed=int(gen.integers(0, 1 << 63)),
                  rng_mode=mode, greedy=temp <= 0, full_table=field != 0,
                  csl=csl, ysl=ysl)
        thr = ising.threshold_table(temp, field)
        step = int(gen.integers(0, 1 << 32))
        want = packed.packed_sweep_reference(
            _torch(dst), _torch(src), _torch(up), _torch(dn), thr, row0, step,
            None if jword is None else _torch(jword), **kw)
        d = HostWords(dst)
        packed.packed_sweep(d, HostWords(src), HostWords(up), HostWords(dn),
                            thr, row0, step,
                            None if jword is None else HostWords(jword), **kw)
        np.testing.assert_array_equal(
            d.a, want.numpy().view(np.uint32),
            err_msg=f"{geometry} {mode} T={temp} h={field} color={color} "
                    f"row0={row0}")


def test_packed_geometries_cover_the_edges():
    assert len(set(PACKED_GEOMETRIES)) == len(PACKED_GEOMETRIES)
    widths = {g[1][1] for g in PACKED_GEOMETRIES}
    assert 1 in widths and any(w % 2 for w in widths) and 66 in widths
    rep = [g for g in PACKED_GEOMETRIES if g[2] is not None]
    assert {g[2] == 1 for g in rep} == {True, False}
    assert any(g[2] == g[1][1] for g in rep)
    assert {8, 2} <= {g[3] for g in rep}
    assert any(g[3] == g[1][0] for g in rep)
    # the row walk: heights 1 and 2, heights that cross the band and do not
    # divide it (odd: a lone last row), on the ordered and J-word paths, at
    # a width ChaCha takes; replica heights that neither divide the band
    # nor are a multiple of it, alone and with the J word
    band = PACKED_BAND
    assert band % 2 == 0
    for path in ("ordered", "jword"):
        heights = {g[1][0] for g in PACKED_GEOMETRIES
                   if g[0] == path and g[1][1] % 2 == 0}
        assert {1, 2} <= heights
        assert any(h > band and h % band and h % 2 for h in heights)
    assert {1, band + 1, 2 * band + 3} <= {
        g[1][0] for g in PACKED_GEOMETRIES if g[0] == "ordered"}
    for path in ("replicas", "replicas+J"):
        assert any(g[3] % band and band % g[3] and g[1][0] > band
                   for g in PACKED_GEOMETRIES if g[0] == path)
    assert set(PACKED_MODES) == {"philox", "philox7", "threefry",
                                 "threefry13", "chacha8", "chacha6", "chacha4",
                                 "hw"}


def _packed_constant(name: str) -> int:
    src = (kernel_lib.CSRC_DIR / "packed_word.cuh").read_text()
    return int(re.search(rf"constexpr \w+ {name} = (\d+);", src)[1])


def _packed_offsets(me, nsum, accept):
    """A plain model of csrc/packed_word.cuh's field_offsets: the byte
    offset 4*(b + 2*g1 + 4*g2 + 8*g3 + 16*g4) of each field (the class bits
    an accept does not read, and b but for the field table, left at 0),
    even fields in the bytes of one word and odd fields in another. Returns
    (H, W, 8) offsets by field."""
    m = np.uint32
    m1 = me & m(0x11111111)
    mask = (m1 << m(4)) - m1
    e = (nsum & mask) | ((m(0x44444444) - nsum) & ~mask)
    ge = {k: (e + m((8 - k) * 0x11111111)) & m(0x88888888) for k in (1, 2, 3, 4)}
    g = ge[4] | (ge[3] >> m(1))
    if accept != packed.ACCEPT_METROPOLIS:
        g |= ge[2] >> m(2)
    if accept == packed.ACCEPT_FIELD:
        g |= ge[1] >> m(3)
    lo = (g & m(0x0F0F0F0F)) << m(3)
    hi = (g >> m(1)) & m(0x78787878)
    if accept == packed.ACCEPT_FIELD:
        lo |= (me & m(0x01010101)) << m(2)
        hi |= (me >> m(2)) & m(0x04040404)
    return np.stack([(w >> m(8 * (z >> 1))) & m(0xFF)
                     for z in range(8) for w in ((hi if z & 1 else lo),)], -1)


def _packed_table(thr, accept):
    """The kernel's accept table (packed_word.cuh:table_entry): word i =
    b + 2*g1 + 4*g2 + 8*g3 + 16*g4 holds the threshold of that class."""
    t, out = [int(x) for x in thr], []
    for i in range(_packed_constant("TABLE_WORDS")):
        b, g1, g2, g3, g4 = ((i >> k) & 1 for k in range(5))
        if accept == packed.ACCEPT_FIELD:
            k = 4 if g4 else 3 if g3 else 2 if g2 else 1 if g1 else 0
            out.append(t[5 + k] if b else t[4 - k])
        elif accept == packed.ACCEPT_GREEDY:
            out.append((t[9] if g4 else t[8] if g3 else t[7]) if g2
                       else 0xFFFFFFFF)
        else:
            out.append((t[9] if g4 else t[8]) if g3 else 0xFFFFFFFF)
    return np.array(out, np.uint32)


@pytest.mark.parametrize("temp,field,accept", [
    (1.5, 0.0, packed.ACCEPT_METROPOLIS), (0.0, 0.0, packed.ACCEPT_GREEDY),
    (1.5, 0.3, packed.ACCEPT_FIELD), (0.0, -0.2, packed.ACCEPT_FIELD)])
def test_packed_byte_offsets_read_the_jax_select(temp, field, accept,
                                                 monkeypatch):
    """A plain model of the packed kernels' accept (csrc/packed_word.cuh:
    each field's byte offset into a 32-word table, and a flip where its
    draw is at or below the word there) against packed_sweep_reference's
    accept (pallas_packed.py:_accept_and_flip), on random words (carries
    between fields included) that take every class index the accept reads,
    with each field's draw one below, at and one above its threshold and
    at and around every entry of thr10."""
    assert _packed_constant("TABLE_WORDS") == 32
    thr = ising.threshold_table(temp, field)
    table = _packed_table(thr, accept)
    gen = np.random.default_rng(31 + accept)
    H, W = 3, 512
    me, up, dn, src = (_random(gen, (H, W)) for _ in range(4))
    # replicas one word wide: the off-column word is the word itself
    nsum = up + dn + src + src
    off = _packed_offsets(me, nsum, accept)
    assert off.max() <= 124 and not (off % 4).any()
    # every class index a field can take: its mirrored count's nibble v
    # and the carries c_k into it from the lower fields' sums e + (8-k)*M1
    # (c_1 >= c_2 >= c_3 >= c_4), the bits the accept reads
    used = {packed.ACCEPT_METROPOLIS: 0b11000, packed.ACCEPT_GREEDY: 0b11100,
            packed.ACCEPT_FIELD: 0b11111}[accept]
    reachable = {(b + sum((((v + 8 - k + (k <= c)) >> 3) & 1) << k
                          for k in (1, 2, 3, 4))) & used
                 for v in range(16) for c in range(5) for b in (0, 1)}
    assert set(np.unique(off // 4).tolist()) == reachable
    th = table[off // 4].astype(np.int64)                      # (H, W, 8)
    t10 = np.array([int(x) for x in thr], np.int64)
    near = np.concatenate([th[..., None] + np.array([-1, 0, 1]),
                           np.broadcast_to(t10[:, None] + np.array([-1, 0, 1]),
                                           th.shape + (10, 3)).reshape(
                                               th.shape + (30,))], -1)
    pick = gen.integers(0, near.shape[-1], th.shape)
    draws = np.take_along_axis(near, pick[..., None], -1)[..., 0] % (1 << 32)
    flips = sum(((draws[..., z] <= th[..., z]).astype(np.uint32)
                 << np.uint32(4 * z)) for z in range(8))
    for row in range(H):
        # the reference's draws: column z*W + j is field z of word j
        monkeypatch.setattr(packed, "counter_color_draws",
                            lambda *a, row=row, **k: torch.from_numpy(
                                draws[row].T.reshape(1, 8 * W).copy()))
        got = packed.packed_sweep_reference(
            _torch(me[row:row + 1]), _torch(src[row:row + 1]),
            _torch(up[row:row + 1]), _torch(dn[row:row + 1]), thr, 0, 0,
            color=0, seed=0, rng_mode="philox", greedy=temp <= 0,
            full_table=accept == packed.ACCEPT_FIELD, csl=1)
        want = me[row] ^ flips[row]
        np.testing.assert_array_equal(got.numpy().view(np.uint32)[0], want)


@pytest.mark.parametrize("args,ok", [
    ((0, 10, 0, 0, 0), True),
    ((2, 8, 2, 0, 0), True),
    ((1, 13, 1, 2, 4), True),       # csl | W = 4, ysl | H = 4
    ((0, 9, 0, 0, 0), False),       # no Philox-9
    ((1, 13, 3, 0, 0), False),      # unknown accept
    ((0, 10, 0, 3, 0), False),      # csl does not divide W = 4
    ((0, 10, 0, 0, 3), False),      # ysl does not divide H = 4
    ((0, 10, 0, -1, 0), False),
])
def test_packed_launcher_checks_its_arguments(emulated_lib, args, ok):
    family, rounds, accept, csl, ysl = args
    buf = np.zeros((4, 4), np.uint32)
    p = buf.ctypes.data
    thr = (ctypes.c_uint32 * 10)()
    code = emulated_lib.packed_sweep_launch(
        p, p, p, p, 4, 4, 0, 0, 0, 0, thr, 0, 0, family, rounds, accept,
        None, csl, ysl, None)
    assert (code == 0) == ok
    # ChaCha's thread owns a pair of words: an odd W is refused
    assert emulated_lib.packed_sweep_launch(
        p, p, p, p, 4, 3, 0, 0, 0, 0, thr, 0, 0, 2, 8, 0, None, 0, 0,
        None) != 0


# The fused step (packed_fused.cu, both entry points): (H, W, row0, band
# rows; 0 for one wave of the emulated 3 SMs x 2 CTAs): W = 66 (W/2 odd:
# ChaCha's pairs) with H = 14, 6 and 2 (bands of 1 and 3 rows, bands that
# wrap onto themselves, fewer rows than CTAs), odd heights and bands (a
# band's first row of either parity), narrow rows (W = 2: both row ends in
# one thread), W = 130 (a row that needs a second pass of the CTA's
# threads), row0 near 2^32 (counters that carry and wrap).
FUSED_SHAPES = [(14, 66, (1 << 32) - 8, 0), (14, 66, 3, 3), (6, 66, 0, 1),
                (2, 66, (1 << 32) - 1, 0), (2, 66, 5, 1), (7, 4, 1, 2),
                (9, 2, (1 << 32) - 3, 4), (5, 260, 0, 0), (11, 6, 2, 3)]


@pytest.mark.parametrize("shape", FUSED_SHAPES,
                         ids=[f"{s[0]}x{s[1]}-{s[2]}-{s[3]}"
                              for s in FUSED_SHAPES])
def test_fused_kernel_source_matches_plain_version(shape, fiber_lib):
    """Both fused entry points against the plain fused step, both planes,
    in every u32 mode and hw and every accept, the threads of a block in
    forward and reverse order, cp.async copies landing at once and at the
    wait."""
    H, W, row0, band = shape
    gen = np.random.default_rng(300 + FUSED_SHAPES.index(shape))
    for i, (mode, (temp, field)) in enumerate(itertools.product(
            PACKED_MODES, PACKED_ACCEPTS)):
        if mode.startswith("chacha") and W % 2:
            continue
        black, white = _random(gen, (H, W)), _random(gen, (H, W))
        thr = ising.threshold_table(temp, field)
        seed, step = int(gen.integers(0, 1 << 62)), int(gen.integers(0, 1 << 32))
        kw = dict(seed=seed, rng_mode=mode, greedy=temp <= 0,
                  full_table=field != 0)
        want = packed.packed_fused_step_reference(_torch(black), _torch(white),
                                                  thr, row0, step, **kw)
        tag_b, kb0, kb1, family, rounds = bit1.launch_args(mode, seed, step, 0)
        tag_w, kw0, kw1, _, _ = bit1.launch_args(mode, seed, step, 1)
        for manual, fn in enumerate((fiber_lib.packed_fused_step_launch,
                                     fiber_lib.packed_fused_step_manual_launch)):
            fiber_lib.emu_set(i % 2, (i // 2 + manual) % 2)
            got = [np.zeros_like(black), np.zeros_like(white)]
            code = fn(black.ctypes.data, white.ctypes.data, got[0].ctypes.data,
                      got[1].ctypes.data, H, W, row0, step,
                      kernel_lib.table10(thr), tag_b, kb0, kb1, tag_w, kw0,
                      kw1, family, rounds,
                      packed._accept(temp <= 0, field != 0), band, None)
            assert code == 0
            for g, w, color in zip(got, want, ("black", "white")):
                np.testing.assert_array_equal(
                    g, w.numpy().view(np.uint32),
                    err_msg=f"{shape} manual={manual} {mode} T={temp} "
                            f"h={field} {color}")


class HostPlane(HostWords):
    """A numpy uint8 plane that the wrapper takes for a CUDA tensor."""

    def __init__(self, a):
        self.a = np.ascontiguousarray(a, np.uint8)
        self.shape = self.a.shape
        self.device = torch.device("cuda", 0)
        self.dtype = torch.uint8


def _bits(gen, shape):
    return gen.integers(0, 2, shape, dtype=np.uint8)


# The dense kernel: the u32 modes and hw, T > 0, the greedy quench and the
# full table (h != 0, also at T <= 0; not hw, whose field config refuses), on
# random bit planes, both colors, row offsets whose counters carry into the
# high word and rows that wrap mod 2^32. (path, (H, C)): H = 1 (both edge rows
# from src_up / src_dn), C = 16 (one ChaCha call per row), C = 20 and 36
# (not multiples of 16: Philox and Threefry only), C = 48 (three ChaCha
# calls), a wide row; J planes. The kernel takes four sites per word where
# G = C/S is a multiple of 4 (Philox at C = 16, 48, 64, 1056; Threefry at 48,
# 64, 1056; ChaCha at 64 and 128) and one elsewhere (C = 36: Philox and
# Threefry, C = 1056: ChaCha). A thread walks a band of rows (dense_band):
# heights 1, 7 (odd), a band and one row and two bands and three rows of
# each band height, on both paths at C = 36 (one site a word) and C = 64
# (four in every family); color 1 shifts the bands by a row.
def dense_band(family: str) -> int:
    """The rows a dense thread walks (csrc/dense_sweep.cu: band_rows)."""
    src = (kernel_lib.CSRC_DIR / "dense_sweep.cu").read_text()
    chacha, other = re.search(
        r"band_rows\(int family\) \{\s*return family == FAMILY_CHACHA \? "
        r"(\d+) : (\d+);", src).groups()
    return int(chacha) if family == "chacha" else int(other)


DENSE_BANDS = sorted({dense_band(f) for f in ("philox", "chacha")})
DENSE_GEOMETRIES = [
    ("ordered", (1, 16)), ("ordered", (2, 20)), ("ordered", (6, 48)),
    ("ordered", (4, 36)), ("ordered", (3, 1056)), ("ordered", (3, 64)),
    ("jplanes", (5, 32)), ("jplanes", (2, 1056)), ("jplanes", (2, 128)),
    ("jplanes", (3, 36)),
    *((path, (H, C)) for path in ("ordered", "jplanes") for C in (36, 64)
      for H in sorted({1, 7} | {h for b in DENSE_BANDS
                                for h in (b + 1, 2 * b + 3)})),
]


@pytest.mark.parametrize("geometry", DENSE_GEOMETRIES,
                         ids=[f"{g[0]}-{g[1][0]}x{g[1][1]}"
                              for g in DENSE_GEOMETRIES])
def test_dense_kernel_source_matches_plain_version(geometry, emulated_lib,
                                                   monkeypatch):
    monkeypatch.setattr(kernel_lib, "load", lambda: (emulated_lib, None))
    monkeypatch.setattr(dense, "_cuda_stream", lambda device: None)
    path, (H, C) = geometry
    gen = np.random.default_rng(200 + DENSE_GEOMETRIES.index(geometry))
    for i, (mode, (temp, field)) in enumerate(itertools.product(
            PACKED_MODES, PACKED_ACCEPTS)):
        family = parse_rng_mode(mode)[0]
        if C % dense.SITES_PER_CALL.get(family, 4) or (field and mode == "hw"):
            continue
        color = i % 2
        row0 = (0, (1 << 29) - 4, (1 << 32) - 2)[i % 3]
        dst, src = _bits(gen, (H, C)), _bits(gen, (H, C))
        up, dn = _bits(gen, (1, C)), _bits(gen, (1, C))
        jp = [_bits(gen, (H, C)) for _ in range(4)] if path == "jplanes" \
            else None
        kw = dict(color=color, seed=int(gen.integers(0, 1 << 63)),
                  rng_mode=mode)
        thr = ising.threshold_table(temp, field)
        step = int(gen.integers(0, 1 << 32))
        t = lambda a: torch.from_numpy(a.copy())
        want = dense.dense_sweep_reference(
            t(dst), t(src), t(up), t(dn), thr, row0, step,
            None if jp is None else [t(p) for p in jp], **kw)
        d = HostPlane(dst)
        dense.dense_sweep(d, HostPlane(src), HostPlane(up), HostPlane(dn),
                          thr, row0, step,
                          None if jp is None else [HostPlane(p) for p in jp],
                          **kw)
        np.testing.assert_array_equal(
            d.a, want.numpy(),
            err_msg=f"{geometry} {mode} T={temp} h={field} color={color} "
                    f"row0={row0}")


def test_dense_geometries_cover_the_edges():
    shapes = [g[1] for g in DENSE_GEOMETRIES]
    assert len(set(DENSE_GEOMETRIES)) == len(DENSE_GEOMETRIES)
    assert any(h == 1 for h, _ in shapes)
    assert {c % 16 == 0 for _, c in shapes} == {True, False}
    assert any(c == 16 for _, c in shapes)
    assert {g[0] for g in DENSE_GEOMETRIES} == {"ordered", "jplanes"}
    # every family on both the four-site and the one-site word, with and
    # without J planes
    for path in ("ordered", "jplanes"):
        for S in dense.SITES_PER_CALL.values():
            gs = {(c // S) % 4 == 0 for p, (_, c) in DENSE_GEOMETRIES
                  if p == path and c % S == 0}
            assert gs == {True, False}
    # heights that cross each family's band and do not divide it, on both
    # paths, at a one-site and a four-site width
    for family, S in dense.SITES_PER_CALL.items():
        band = dense_band(family)
        assert band % 2 == 0
        for path in ("ordered", "jplanes"):
            for C, four in ((36, False), (64, True)):
                if C % S:
                    continue
                assert (C // S % 4 == 0) == four
                heights = {h for p, (h, c) in DENSE_GEOMETRIES
                           if p == path and c == C}
                assert {1, band + 1, 2 * band + 3} <= heights
                assert any(h % 2 and h % band and h > band for h in heights)


def _kernel_constant(name: str) -> int:
    src = (kernel_lib.CSRC_DIR / "dense_sweep.cu").read_text()
    return int(re.search(rf"constexpr \w+ {name} = (\d+);", src)[1])


@pytest.mark.parametrize("temp,field", [(1.5, 0.0), (0.0, 0.0), (1.5, 0.3)])
def test_dense_byte_offsets_read_the_jax_select(temp, field):
    """A plain model of csrc/dense_sweep.cu's accept: the shared table's
    TABLE_WORDS words hold thr10 from word BIAS/4 on and 0 elsewhere; a
    site's byte offset is BIAS + 20*dst + 4*nsum (summed bytewise over a
    word's four sites). At every word offset 4k a byte can address, the
    table gives pallas_dense.py's select of thr10 at index k - BIAS/4
    (:198-200: an index outside 0..9 selects 0), and every bit-plane site
    reads thr10[dst*5 + nsum] at an offset whose bit 7 is dst."""
    bias, words = _kernel_constant("BIAS"), _kernel_constant("TABLE_WORDS")
    assert bias % 4 == 0 and words == 64
    thr = [int(t) for t in ising.threshold_table(temp, field)]
    table = [thr[k - bias // 4] if 0 <= k - bias // 4 < 10 else 0
             for k in range(words)]

    def jax_select(idx):
        return thr[idx] if 0 <= idx < 10 else 0

    for k in range(words):        # every word offset 4k: no range check
        assert table[k] == jax_select(k - bias // 4)
    assert 4 * words == 256       # a byte offset always lands in the table
    for dst in (0, 1):
        for nsum in range(5):
            off = bias + 20 * dst + 4 * nsum
            assert off % 4 == 0 and off < 256
            assert off >> 7 == dst
            assert table[off // 4] == jax_select(dst * 5 + nsum)
    # four sites summed bytewise carry into no neighbouring byte
    gen = np.random.default_rng(5)
    for _ in range(200):
        dst, n = gen.integers(0, 2, 4), gen.integers(0, 5, 4)
        word = sum((bias + 20 * int(d) + 4 * int(m)) << (8 * v)
                   for v, (d, m) in enumerate(zip(dst, n)))
        for v in range(4):
            b = word >> (8 * v) & 0xFF
            assert table[b // 4] == jax_select(int(dst[v]) * 5 + int(n[v]))
            assert b >> 7 == dst[v]


@pytest.mark.parametrize("args,ok", [
    ((0, 10, 16, 0), True),
    ((2, 4, 16, 4), True),         # ChaCha-4 with four J planes
    ((1, 13, 18, 0), True),        # Threefry: C % 2
    ((0, 9, 16, 0), False),        # no Philox-9
    ((2, 8, 24, 0), False),        # ChaCha: C % 16
    ((0, 10, 18, 0), False),       # Philox: C % 4
    ((1, 20, 16, 2), False),       # two of the four J planes
])
def test_dense_launcher_checks_its_arguments(emulated_lib, args, ok):
    family, rounds, C, links = args
    buf = np.zeros((2, C), np.uint8)
    p = buf.ctypes.data
    thr = (ctypes.c_uint32 * 10)()
    jp = [p] * links + [None] * (4 - links)
    code = emulated_lib.dense_sweep_launch(
        p, p, p, p, 2, C, 0, 0, 0, 0, thr, 0, 0, family, rounds, *jp, None)
    assert (code == 0) == ok
