// One checkerboard color half-sweep of the dense Ising lattice (one uint8 per
// spin) with the neighbour sums on the tensor cores, for Hopper (sm_90a).
// Replaces the TPU kernel ising_tpu/ops/mxu.py:_mxu_kernel (:71-145): the
// spins become +-1 bf16 and the neighbour sums come from band-matrix products
// with fp32 accumulation, the edges of each product patched from the
// neighbouring rows and columns; then the integer accept through the mirrored
// count (h = 0; T > 0 and the greedy quench share its three thresholds) in the
// u32-draw rng modes and hw (salted Philox-10). No disorder, no replicas, no
// field: the JAX backend has none either.
//
// The sums, per 16 x 16 fragment S of +-1 spins (nvcuda::wmma, bf16
// m16n16k16, fp32 accumulators, three products):
//   vertical  V = Kv S, Kv with ones on the sub- and super-diagonal: row r gets
//             s[r - 1] + s[r + 1]; rows 0 and 15 miss one term, added from the
//             rows above and below (src_up / src_dn at the slab's edges);
//   left      S Kl, Kl[k][k + 1] = 1: lane j gets s[j - 1]; lane 0 patched
//             from the column to its left (periodic);
//   right     S Kr, Kr[k + 1][k] = 1: lane j gets s[j + 1]; lane 15 patched.
// Every term is a small integer, exact in bf16 and fp32, so the count
// n = (v + same + off + 4) / 2 equals the integer stencil's and trajectories
// equal the dense and xla backends' bit for bit (mxu.py:19-21).
//
// Tiling against the draws: one generator call serves the S sites q + s*G of
// a row (site_draws.cuh; S = 4, 2, 16 for Philox, Threefry, ChaCha, G = C/S),
// so a CTA owns whole calls: 16 rows by the calls q0 .. q0 + tq - 1, i.e. S
// runs of tq columns at stride G. The launcher picks tq, the largest of 64,
// 32, 16 dividing G with S * tq <= 256 columns, else 8 (ChaCha with C % 256
// != 0). Each run is cut into 16-wide fragments; a run of 8 takes the
// fragment of its 8 columns and the next 8 (read, not updated), so lane 7's
// right neighbour comes out of the product too. A CTA first makes every load
// from device memory, in 32-bit words: the tile's +-1 spins, the halo rows
// above and below, the columns left and right of each fragment, and dst's
// sites, all into shared memory. Then each warp multiplies its fragments,
// stores the three accumulators to shared memory (store_matrix_sync: the
// fragment layout is opaque), patches the edges from the halo and writes n
// per site; then one thread per call draws once and accepts its S sites.
//
// What bounds it (least times on an H100 SXM from its data-sheet rates, not
// measured): per color phase 3 bytes per site (read src and dst, write dst):
// 0.120 ms at 16384^2, as dense. The tensor-core work is 3 x 16^3
// multiply-adds per 256 sites, 96 flops per site, 12.9 GFLOP at 16384^2:
// 0.013 ms at 989 TFLOP/s (bf16, dense). The function's integer work is
// dense's (chip_smoke.py:dense_ops_per_site, 0.05 to 0.16 ms at 16384^2);
// it and the bytes bind before the MMA does, so the products stay simple
// (wmma, operands from shared memory); the design reads
// src and dst from device memory once, all at the start of a tile, so the
// loads are in flight together and the later phases wait on none.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a (ops/kernel_lib.py). The
// C entry point returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <mma.h>

#include "site_draws.cuh"

namespace {

using namespace ising;
using namespace nvcuda;

constexpr int TILE_ROWS = 16;   // rows per CTA: one fragment row
constexpr int MAX_COLS = 256;   // columns per CTA: S runs of max(tq, 16)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int FRAG = 16 * 16;

__device__ __forceinline__ float pm(uint32_t b) { return 2.f * static_cast<float>(b) - 1.f; }

__device__ __forceinline__ int log2i(int x) { return 31 - __clz(x); }

template <int FAMILY, int R>
__global__ void __launch_bounds__(THREADS)
mxu_sweep_kernel(uint8_t* __restrict__ dst, const uint8_t* __restrict__ src,
                 const uint8_t* __restrict__ src_up,
                 const uint8_t* __restrict__ src_dn, int H, int C, int tq,
                 uint32_t row0, uint32_t step, uint32_t tag, int color,
                 Table10 thr, uint32_t k0, uint32_t k1) {
  constexpr int S = sites_per_call(FAMILY);
  constexpr int MAX_FRAGS = MAX_COLS / 16;
  __shared__ __align__(128) __nv_bfloat16 spins[TILE_ROWS * MAX_COLS];
  __shared__ __align__(128) __nv_bfloat16 band[3][FRAG];   // Kv, Kl, Kr
  __shared__ __align__(128) float sums[WARPS][3][FRAG];    // V, S Kl, S Kr
  __shared__ __align__(16) uint8_t halo_rows[2][MAX_COLS];  // rows y0 - 1, y0 + 16
  __shared__ uint8_t halo_cols[TILE_ROWS][MAX_FRAGS][2];   // left of lane 0, right of 15
  __shared__ __align__(16) uint8_t cur[TILE_ROWS * MAX_COLS];  // dst, [row][s*tq + k]
  __shared__ uint8_t counts[TILE_ROWS * MAX_COLS];         // n, [row][s*tq + k]

  const int G = C / S;
  const int w16 = tq < 16 ? 16 : tq;   // staged columns per run
  const int ncol = S * w16;            // all four of tq, w16, ncol: powers of 2
  const int frags = ncol >> 4, per_run = w16 >> 4;
  const int lg_tq = log2i(tq), lg_w16 = log2i(w16), lg_ncol = log2i(ncol);
  const int tid = static_cast<int>(threadIdx.x), warp = tid >> 5, lane = tid & 31;
  const int q0 = static_cast<int>(blockIdx.x) * tq;

  for (int i = tid; i < FRAG; i += THREADS) {
    const int r = i >> 4, k = i & 15;
    band[0][i] = __float2bfloat16(r - k == 1 || k - r == 1 ? 1.f : 0.f);
    band[1][i] = __float2bfloat16(k == r + 1 ? 1.f : 0.f);
    band[2][i] = __float2bfloat16(r == k + 1 ? 1.f : 0.f);
  }
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> kv, sa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> kl, kr, sb;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> v, l, r;
  wmma::load_matrix_sync(kv, band[0], 16);
  wmma::load_matrix_sync(kl, band[1], 16);
  wmma::load_matrix_sync(kr, band[2], 16);
  float* const vs = sums[warp][0];
  float* const ls = sums[warp][1];
  float* const rs = sums[warp][2];

  for (int ty = static_cast<int>(blockIdx.y); ty < H / TILE_ROWS;
       ty += static_cast<int>(gridDim.y)) {
    const int y0 = ty * TILE_ROWS;
    // 1. Every load from device memory, in 32-bit words (a run's columns are
    //    contiguous and 8-aligned; the only wrap, at C, falls between words):
    //    staged column s*w16 + k of run s is global column (s*G + q0 + k) mod C
    //    of rows y0 - 1 .. y0 + 16 (the tile as +-1 bf16, the two halo rows as
    //    bytes), the columns left and right of each fragment, and dst's sites.
    for (int i = tid; i < (TILE_ROWS + 2) * (ncol >> 2); i += THREADS) {
      const int row = i >> (lg_ncol - 2), col = (i & ((ncol >> 2) - 1)) << 2;
      const int s = col >> lg_w16, k = col & (w16 - 1);
      int c = s * G + q0 + k;
      if (c >= C) c -= C;
      const int y = y0 + row - 1;   // staged row 0 is the halo row above
      const uint8_t* p = y < 0 ? src_up : y == H ? src_dn : src + static_cast<int64_t>(y) * C;
      const uint32_t w = *reinterpret_cast<const uint32_t*>(p + c);
      if (row == 0 || row == TILE_ROWS + 1) {
        *reinterpret_cast<uint32_t*>(&halo_rows[row ? 1 : 0][col]) = w;
      } else {
        __nv_bfloat16* out = spins + (row - 1) * MAX_COLS + col;
#pragma unroll
        for (int b = 0; b < 4; ++b) out[b] = __float2bfloat16(pm((w >> (8 * b)) & 0xFFu));
      }
    }
    for (int i = tid; i < TILE_ROWS * frags * 2; i += THREADS) {
      const int row = i / (frags * 2), f = (i >> 1) % frags, right = i & 1;
      const int s = f / per_run;
      const int c0 = s * G + q0 + (f - s * per_run) * 16;   // the fragment's lane 0
      int c = right ? c0 + 16 : c0 - 1;
      c = c < 0 ? c + C : c >= C ? c - C : c;
      halo_cols[row][f][right] = src[static_cast<int64_t>(y0 + row) * C + c];
    }
    for (int i = tid; i < TILE_ROWS * (S * tq >> 2); i += THREADS) {
      const int row = i / (S * tq >> 2), col = (i - row * (S * tq >> 2)) << 2;
      const int s = col >> lg_tq, k = col & (tq - 1);
      *reinterpret_cast<uint32_t*>(&cur[row * MAX_COLS + col]) =
          *reinterpret_cast<const uint32_t*>(
              dst + static_cast<int64_t>(y0 + row) * C + s * G + q0 + k);
    }
    __syncthreads();
    // 2. Neighbour sums on the tensor cores, then n per site; the edges of
    //    each product patched from the halo.
    for (int f = warp; f < frags; f += WARPS) {
      const int s = f / per_run, sub = f - s * per_run;
      const int cb = s * w16 + sub * 16;
      wmma::load_matrix_sync(sa, spins + cb, MAX_COLS);
      wmma::load_matrix_sync(sb, spins + cb, MAX_COLS);
      wmma::fill_fragment(v, 0.f);
      wmma::fill_fragment(l, 0.f);
      wmma::fill_fragment(r, 0.f);
      wmma::mma_sync(v, kv, sb, v);
      wmma::mma_sync(l, sa, kl, l);
      wmma::mma_sync(r, sa, kr, r);
      wmma::store_matrix_sync(vs, v, 16, wmma::mem_row_major);
      wmma::store_matrix_sync(ls, l, 16, wmma::mem_row_major);
      wmma::store_matrix_sync(rs, r, 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < FRAG; e += 32) {
        const int i = e >> 4, jj = e & 15, k = sub * 16 + jj;
        if (k >= tq) continue;   // the second half of a run of 8: not ours
        float vert = vs[e];
        if (i == 0) vert += pm(halo_rows[0][cb + jj]);
        if (i == 15) vert += pm(halo_rows[1][cb + jj]);
        const bool look_right = (color == 0) == static_cast<bool>((y0 + i) & 1);
        const float off = look_right ? (jj == 15 ? pm(halo_cols[i][f][1]) : rs[e])
                                     : (jj == 0 ? pm(halo_cols[i][f][0]) : ls[e]);
        const float total = vert + __bfloat162float(spins[i * MAX_COLS + cb + jj]) + off;
        counts[i * MAX_COLS + s * tq + k] =
            static_cast<uint8_t>((static_cast<int>(total) + 4) >> 1);
      }
      __syncwarp();
    }
    __syncthreads();
    // 3. One thread per generator call: draw once, accept its S sites.
    for (int t = tid; t < TILE_ROWS * tq; t += THREADS) {
      const int i = t >> lg_tq, k = t & (tq - 1), y = y0 + i;
      uint32_t d[S];
      call_draws<FAMILY, R>(row0 + static_cast<uint32_t>(y), static_cast<uint32_t>(G),
                            static_cast<uint32_t>(q0 + k), step, tag, k0, k1, d);
      uint8_t* out = dst + static_cast<int64_t>(y) * C;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int me = cur[i * MAX_COLS + s * tq + k];
        const int n = counts[i * MAX_COLS + s * tq + k];
        const uint32_t accept = d[s] <= mirrored_threshold(me == 1 ? n : 4 - n, thr);
        out[s * G + q0 + k] = static_cast<uint8_t>(me ^ accept);
      }
    }
    __syncthreads();
  }
}

template <int FAMILY, int R>
struct MxuLaunch {
  static void launch(dim3 grid, cudaStream_t stream, uint8_t* dst,
                     const uint8_t* src, const uint8_t* up, const uint8_t* dn,
                     int H, int C, int tq, uint32_t row0, uint32_t step,
                     uint32_t tag, int color, const Table10& thr, uint32_t k0,
                     uint32_t k1) {
    mxu_sweep_kernel<FAMILY, R><<<grid, THREADS, 0, stream>>>(
        dst, src, up, dn, H, C, tq, row0, step, tag, color, thr, k0, k1);
  }
};

}  // namespace

// Launch one half-sweep on `stream`. dst, src: (H, C) bytes; src_up, src_dn:
// (1, C); tq: calls per run of a CTA (ops/mxu.py:calls_per_tile); family,
// rounds, k0, k1 and thr10 as for dense_sweep_launch. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// (family, rounds) pair that is not instantiated here, H not a multiple of
// 16, C not a multiple of 128, or a tq that is not 8, 16, 32 or 64, does not
// divide G = C/S or stages more than 256 columns.
extern "C" int mxu_sweep_launch(void* dst, const void* src, const void* src_up,
                                const void* src_dn, int H, int C, int tq,
                                uint32_t row0, uint32_t step, uint32_t tag,
                                int color, const uint32_t* thr10, uint32_t k0,
                                uint32_t k1, int family, int rounds, void* stream) {
  const auto fn = find_u32_mode<MxuLaunch>(family, rounds);
  const int S = sites_per_call(family);
  if (fn == nullptr || thr10 == nullptr || H <= 0 || H % TILE_ROWS || C <= 0 ||
      C % 128 || (tq != 8 && tq != 16 && tq != 32 && tq != 64) || (C / S) % tq ||
      S * (tq < 16 ? 16 : tq) > MAX_COLS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Table10 thr;
  for (int i = 0; i < 10; ++i) thr.t[i] = thr10[i];
  const int tiles = H / TILE_ROWS;
  const dim3 grid((C / S) / tq, tiles < 65535 ? tiles : 65535);
  fn(grid, static_cast<cudaStream_t>(stream), static_cast<uint8_t*>(dst),
     static_cast<const uint8_t*>(src), static_cast<const uint8_t*>(src_up),
     static_cast<const uint8_t*>(src_dn), H, C, tq, row0, step, tag, color, thr, k0, k1);
  return static_cast<int>(cudaGetLastError());
}
