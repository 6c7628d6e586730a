// One checkerboard color half-sweep of the dense Ising lattice (one uint8 per
// spin) with the neighbour sums on the tensor cores, for Hopper (sm_90a).
// Replaces the TPU kernel ising_tpu/ops/mxu.py:_mxu_kernel (:71): the
// neighbour sums come from band-matrix products, the vertical one a band
// times the spins and the horizontal one the spins times a band, and the
// integer accept through the mirrored count (h = 0; T > 0 and the greedy
// quench share its three thresholds), in the u32-draw rng modes and hw
// (salted Philox-10). No disorder, no replicas, no field: the JAX backend has
// none either.
//
// The products: mma.sync m16n8k32, u8 operands, s32 accumulators. Its A
// operand (16 x 32, row-major) is four lattice bytes of one row to a
// register, as they lie in memory, and 32 rows of k cover the tile's 16 rows
// and both halo rows with no edge patch. The spins stay 0/1 bytes and every
// band entry is a small integer, so the accumulator is exact: it holds
// 4 (5 dst + n), the byte offset of the site's threshold, with n its
// neighbour count. The alternative, m16n8k16 bf16 -> f32 (the JAX kernel's
// type), needs every spin converted to a bf16 and the count converted back,
// and k16 covers neither halo row. Per 16 rows and 8 output columns of one
// run, a tile, four products accumulate into one 16 x 8 result:
//   dst       A = the lane's own dst bytes, B = 20 at (k of column n, n);
//   vertical  A = band (row m: 4 at k = m - 1 and m + 1; row 0's up and row
//             15's down at k = 16 and 17), B = spins, k = 0..15 the tile's
//             rows, 16 and 17 the rows above and below (src_up / src_dn at
//             the slab's edges);
//   left      A = spins, a window of 32 columns from 4 left of the tile's
//             first, B = 4 at k = f(n) + 3 and f(n) + 4 (left and same);
//   right     the same A, B = 4 at k = f(n) + 4 and f(n) + 5; each lane
//             takes left or right with one select, since its rows g and
//             g + 8 share their parity.
// f(n) is output column n's offset in the run: 2n + j in tile j of two, n
// with one, so that with two lane g's vertical operand is one 16-bit load a
// row (columns 2g, 2g + 1) for both tiles, and lane (g, t)'s four outputs in
// a row are the four bytes at 4t (one 32-bit load and store).
//
// Lane map (PTX ISA, mma.m16n8k32 .u8 fragments; g = lane / 4, t = lane %
// 4): A registers (row g, k 4t..4t+3), (g + 8, same), (g, 16 + 4t..),
// (g + 8, 16 + 4t..); B registers (k 4t..4t+3, column g), (16 + 4t.., g);
// accumulators (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1). A warp
// takes the tile at in-run offset q0 in each of the S runs of a 16-row
// block (columns s*G + q0 .. + 8T - 1, T tiles a run: 2 where G % 16 == 0,
// every Philox and Threefry width and ChaCha where C % 256 == 0, else 1):
// generator call q of a row serves the S sites q + s*G (site_draws.cuh; S =
// 4, 2, 16 for Philox, Threefry, ChaCha), so lane (g, t) holds, in every
// run, rows g and g + 8 at the 2T columns q0 + 2T t .. + 2T - 1: every site
// of its 4T calls. It runs the S tiles first, all of the task's loads in
// flight together, and keeps each site's threshold offset and dst in a
// byte; then each call draws once and accepts its S sites in the lane that
// holds the sums. (Drawing first holds 4T x S draws, 64 registers for
// ChaCha with one tile, and each tile's loads then wait behind the last
// tile's accept.) No shared memory but the 10-entry table, no barrier after
// it.
//
// What bounds it (least times on an H100 SXM from its data-sheet rates, not
// measured): per color phase 3 bytes per site (read src and dst, write dst),
// 0.120 ms at 16384^2, as dense. The function's integer work is dense's
// (chip_smoke.py:dense_ops_per_site, 0.05 to 0.16 ms at 16384^2); the
// products, 4 x 16 x 8 x 32 multiply-adds a tile (256 ops a site), take
// 0.017 ms at 1979 TOP/s (int8, dense). Device memory is read once a byte;
// the windows and the rows that lanes share come again from L1. On an H100
// 80GB HBM3 at 700 W (PERF.md) it takes 1.27-1.37x dense's time, 27-36% of
// the bytes bound: the ALU pipe needs 46-80% of that time, the tensor pipe
// little, and each load of a lane's fragments touches 4 or 8 rows. ptxas -v (CUDA 12.8,
// sm_90a), registers a thread and CTAs an SM, no stack frame: Philox 104
// (2 of 256 threads), Threefry 73-80 (3 of 256), ChaCha with two tiles
// 112-160 (3-4 of 128 threads; its lanes hold the most), with one 84 (5).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a (ops/kernel_lib.py). The
// C entry point returns cudaGetLastError() after the launch.

#include "site_draws.cuh"

namespace {

using namespace ising;

// Threads a CTA: 128 for ChaCha, whose lanes hold the most (S = 16 runs of
// sites and a 16-word block), 256 for the others.
__host__ __device__ constexpr int threads_for(int family) {
  return family == FAMILY_CHACHA ? 128 : 256;
}
constexpr int TILE_ROWS = 16;
constexpr int MAX_BLOCKS = 2048;   // the warps loop over the tiles

// d += A * B on the tensor cores: m16n8k32, A 16 x 32 u8 row-major, B 32 x 8
// u8 column-major, s32 accumulators.
__device__ __forceinline__ void mma_u8(uint32_t (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment register of the four k from k0: v in the bytes of k == a or b.
__device__ __forceinline__ uint32_t band_bytes(int k0, int a, int b, uint32_t v) {
  uint32_t r = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) r |= k0 + i == a || k0 + i == b ? v << (8 * i) : 0u;
  return r;
}

__device__ __forceinline__ uint32_t load32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t load16(const uint8_t* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

// The lane's 2T sites of a row: a 32-bit word (T = 2) or a 16-bit half (1).
template <int T>
__device__ __forceinline__ uint32_t load_sites(const uint8_t* p) {
  if constexpr (T == 2) {
    return load32(p);
  } else {
    return load16(p);
  }
}

template <int T>
__device__ __forceinline__ void store_sites(uint8_t* p, uint32_t v) {
  if constexpr (T == 2) {
    *reinterpret_cast<uint32_t*>(p) = v;
  } else {
    *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(v);
  }
}

template <int FAMILY, int R, int T>
__global__ void __launch_bounds__(threads_for(FAMILY))
mxu_sweep_kernel(uint8_t* __restrict__ dst, const uint8_t* __restrict__ src,
                 const uint8_t* __restrict__ src_up,
                 const uint8_t* __restrict__ src_dn, int H, int C,
                 uint32_t row0, uint32_t step, uint32_t tag, int color,
                 Table10 thr, uint32_t k0, uint32_t k1) {
  constexpr int S = sites_per_call(FAMILY);
  constexpr int WARPS = threads_for(FAMILY) / 32;
  constexpr int P = 2 * T;              // the lane's calls (columns) a row
  constexpr int W = T == 2 ? 2 : 1;     // words of the lane's sites a run
  // dst words to a register: ChaCha's lanes hold 16 runs of them; the
  // others keep one a register (words sharing one chain their accepts).
  constexpr int PACK = FAMILY == FAMILY_CHACHA ? 8 : 1;
  // thr10[5 dst + n] of the mirrored accept, read at the byte offset the
  // products leave in the accumulator.
  __shared__ uint32_t table[10];
  if (threadIdx.x < 10) {
    const int b = static_cast<int>(threadIdx.x) / 5, n = static_cast<int>(threadIdx.x) % 5;
    table[threadIdx.x] = mirrored_threshold(b ? n : 4 - n, thr);
  }
  __syncthreads();

  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int g = lane >> 2, t = lane & 3;
  // The constant operands of this lane, scaled by 4 (the table's stride).
  uint32_t kv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = g + 8 * (i & 1);
    kv[i] = band_bytes(4 * t + 16 * (i >> 1), m == 0 ? 16 : m - 1, m == 15 ? 17 : m + 1, 4);
  }
  uint32_t bl[T][2], br[T][2], bd[T];
#pragma unroll
  for (int j = 0; j < T; ++j) {
    const int f = T == 2 ? 2 * g + j : g;                       // column g's offset
    const int kd = T == 2 ? f : 4 * (g >> 1) + (g & 1);         // its dst byte's k
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      bl[j][i] = band_bytes(4 * t + 16 * i, f + 3, f + 4, 4);
      br[j][i] = band_bytes(4 * t + 16 * i, f + 4, f + 5, 4);
    }
    bd[j] = band_bytes(4 * t, kd, kd, 20);
  }
  const bool right = (color == 0) == static_cast<bool>(g & 1);

  const int G = C / S, groups = G / (8 * T), tasks = (H / TILE_ROWS) * groups;
  for (int task = static_cast<int>(blockIdx.x) * WARPS + warp; task < tasks;
       task += static_cast<int>(gridDim.x) * WARPS) {
    const int ty = task / groups;
    const int q0 = (task - ty * groups) * 8 * T;
    const int y0 = ty * TILE_ROWS;
    const uint8_t* const tile = src + static_cast<int64_t>(y0) * C;
    const uint8_t* const row_lo = tile + g * C;              // row y0 + g
    const uint8_t* const row_hi = row_lo + 8 * C;            // row y0 + g + 8
    const uint8_t* const rows_v = tile + 4 * t * C;          // rows y0 + 4t + b
    const uint8_t* const up = y0 == 0 ? src_up : tile - C;
    const uint8_t* const dn = y0 + TILE_ROWS == H ? src_dn : tile + TILE_ROWS * C;
    uint8_t* const out_lo = dst + static_cast<int64_t>(y0 + g) * C;
    uint8_t* const out_hi = out_lo + 8 * C;

    // 1. Every run's tile: operands, products. The lane keeps, a byte a
    //    site, its threshold offset 4 (5 dst + n) in off[s][w]: site (h, p),
    //    row g + 8h and call q0 + Pt + p, in byte p of word h (T = 2), or in
    //    byte 2h + p of word 0 (T = 1: both rows' 16 bits). Its dst bytes,
    //    0 or 1, in me: word i = sW + w shifted by i % PACK, PACK words to a
    //    register.
    uint32_t off[S][W], me[(S * W + PACK - 1) / PACK] = {};
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int c0 = s * G + q0;
      // Spins of rows g and g + 8, the window from c0 - 4 (periodic; only the
      // first run can wrap left and only the last right).
      uint32_t a[4];
      int x = c0 - 4 + 4 * t;
      if (s == 0 && x < 0) x += C;
      if (T == 1 && s == S - 1 && x >= C) x -= C;
      a[0] = load32(row_lo + x);
      a[1] = load32(row_hi + x);
      if constexpr (T == 2) {
        int x2 = c0 + 12 + 4 * t;   // k 16..23 (t < 2) hold columns c0 + 12..19
        if (s == S - 1 && x2 >= C) x2 -= C;
        a[2] = t < 2 ? load32(row_lo + x2) : 0u;
        a[3] = t < 2 ? load32(row_hi + x2) : 0u;
      } else {
        a[2] = a[3] = 0u;
      }
      // The lane's own dst sites, rows g and g + 8: the dst product's A.
      const uint32_t mine[4] = {load_sites<T>(out_lo + c0 + P * t),
                                load_sites<T>(out_hi + c0 + P * t), 0u, 0u};
      // The vertical operand: the tile's rows 4t..4t+3 and (t == 0) the rows
      // above and below, at column f(g) of each tile.
      uint32_t v0[T], v1[T];
      if constexpr (T == 2) {
        const int xv = c0 + 2 * g;
        const uint32_t r0 = load16(rows_v + xv), r1 = load16(rows_v + C + xv);
        const uint32_t r2 = load16(rows_v + 2 * C + xv), r3 = load16(rows_v + 3 * C + xv);
        const uint32_t hu = t == 0 ? load16(up + xv) : 0u;
        const uint32_t hd = t == 0 ? load16(dn + xv) : 0u;
        const uint32_t lo = __byte_perm(r0, r1, 0x5140), hi = __byte_perm(r2, r3, 0x5140);
        v0[0] = __byte_perm(lo, hi, 0x5410);
        v0[T - 1] = __byte_perm(lo, hi, 0x7632);
        v1[0] = __byte_perm(hu, hd, 0x3240);
        v1[T - 1] = __byte_perm(hu, hd, 0x3251);
      } else {
        const int xv = c0 + g;
        const uint32_t r0 = rows_v[xv], r1 = rows_v[C + xv];
        const uint32_t r2 = rows_v[2 * C + xv], r3 = rows_v[3 * C + xv];
        const uint32_t hu = t == 0 ? up[xv] : 0u, hd = t == 0 ? dn[xv] : 0u;
        v0[0] = __byte_perm(__byte_perm(r0, r1, 0x3340), __byte_perm(r2, r3, 0x3340), 0x5410);
        v1[0] = __byte_perm(hu, hd, 0x3340);
      }
      uint32_t sum[T][4];
#pragma unroll
      for (int j = 0; j < T; ++j) {
        uint32_t acc[4] = {0u, 0u, 0u, 0u};
        mma_u8(acc, mine, bd[j], 0u);
        mma_u8(acc, kv, v0[j], v1[j]);
        uint32_t l[4] = {acc[0], acc[1], acc[2], acc[3]};
        mma_u8(l, a, bl[j][0], bl[j][1]);
        mma_u8(acc, a, br[j][0], br[j][1]);
#pragma unroll
        for (int i = 0; i < 4; ++i) sum[j][i] = right ? acc[i] : l[i];
      }
      // Site (h, p) is tile p % T's output column 2t + p / T of row g + 8h.
#pragma unroll
      for (int w = 0; w < W; ++w) off[s][w] = 0u;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int p = 0; p < P; ++p) {
          off[s][T == 2 ? h : 0] |= sum[p % T][2 * h + p / T] << (8 * (T == 2 ? p : 2 * h + p));
        }
      }
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const int i = s * W + w;
        const uint32_t word = T == 2 ? mine[w] : mine[0] | mine[1] << 16;
        me[i / PACK] |= word << (i % PACK);
      }
    }
    // 2. Each of the lane's 2P calls draws once and accepts its S sites.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        uint32_t d[S];
        call_draws<FAMILY, R>(row0 + static_cast<uint32_t>(y0 + g + 8 * h),
                              static_cast<uint32_t>(G), static_cast<uint32_t>(q0 + P * t + p),
                              step, tag, k0, k1, d);
        const int w = T == 2 ? h : 0, b = T == 2 ? p : 2 * h + p;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const uint32_t th = *reinterpret_cast<const uint32_t*>(
              reinterpret_cast<const char*>(table) + __byte_perm(off[s][w], 0u, 0x4440 | b));
          const int i = s * W + w;
          me[i / PACK] ^= static_cast<uint32_t>(d[s] <= th) << (8 * b + i % PACK);
        }
      }
    }
    // 3. The new dst sites.
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int c = s * G + q0 + P * t;
      const int i = s * W, j = i + W - 1;
      const uint32_t lo = me[i / PACK] >> (i % PACK) & 0x01010101u;
      store_sites<T>(out_lo + c, lo);
      store_sites<T>(out_hi + c, T == 2 ? me[j / PACK] >> (j % PACK) & 0x01010101u : lo >> 16);
    }
  }
}

// Two n8 tiles a run where G % 16 == 0 (every Philox and Threefry width),
// else one (ChaCha where C % 256 != 0).
template <int FAMILY, int R>
struct MxuLaunch {
  static void launch(int blocks, int cols, cudaStream_t stream, uint8_t* dst,
                     const uint8_t* src, const uint8_t* up, const uint8_t* dn,
                     int H, int C, uint32_t row0, uint32_t step, uint32_t tag,
                     int color, const Table10& thr, uint32_t k0, uint32_t k1) {
    if constexpr (FAMILY == FAMILY_CHACHA) {
      if (cols == 8) {
        mxu_sweep_kernel<FAMILY, R, 1><<<blocks, threads_for(FAMILY), 0, stream>>>(
            dst, src, up, dn, H, C, row0, step, tag, color, thr, k0, k1);
        return;
      }
    }
    mxu_sweep_kernel<FAMILY, R, 2><<<blocks, threads_for(FAMILY), 0, stream>>>(
        dst, src, up, dn, H, C, row0, step, tag, color, thr, k0, k1);
  }
};

}  // namespace

// Launch one half-sweep on `stream`. dst, src: (H, C) bytes; src_up, src_dn:
// (1, C); cols: output columns a run of one warp's tile (ops/mxu.py:
// tile_columns: 16 where G = C/S is a multiple of 16, else 8); family,
// rounds, k0, k1 and thr10 as for dense_sweep_launch (thr10 an h = 0 table:
// the kernel reads entries 7 to 9). Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a (family, rounds) pair that is not
// instantiated here, H not a multiple of 16, C not a multiple of 128, or
// another cols.
extern "C" int mxu_sweep_launch(void* dst, const void* src, const void* src_up,
                                const void* src_dn, int H, int C, int cols,
                                uint32_t row0, uint32_t step, uint32_t tag,
                                int color, const uint32_t* thr10, uint32_t k0,
                                uint32_t k1, int family, int rounds, void* stream) {
  const auto fn = find_u32_mode<MxuLaunch>(family, rounds);
  const int S = sites_per_call(family);
  if (fn == nullptr || thr10 == nullptr || H <= 0 || H % TILE_ROWS || C <= 0 ||
      C % 128 || cols != ((C / S) % 16 ? 8 : 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Table10 thr;
  for (int i = 0; i < 10; ++i) thr.t[i] = thr10[i];
  const int64_t tasks = static_cast<int64_t>(H / TILE_ROWS) * ((C / S) / cols);
  const int64_t warps = threads_for(family) / 32;
  const int64_t want = (tasks + warps - 1) / warps;
  const int blocks = static_cast<int>(want < MAX_BLOCKS ? want : MAX_BLOCKS);
  fn(blocks, cols, static_cast<cudaStream_t>(stream), static_cast<uint8_t*>(dst),
     static_cast<const uint8_t*>(src), static_cast<const uint8_t*>(src_up),
     static_cast<const uint8_t*>(src_dn), H, C, row0, step, tag, color, thr, k0, k1);
  return static_cast<int>(cudaGetLastError());
}
