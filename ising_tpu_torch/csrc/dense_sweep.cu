// One checkerboard color half-sweep of the dense Ising lattice (one uint8 per
// spin), for Hopper (sm_90a). Replaces the TPU kernel
// ising_tpu/ops/pallas_dense.py:_sweep_kernel (:145-202): the u32-draw rng
// modes (Philox, Threefry, ChaCha, and hw as salted Philox-10), the full
// 10-entry threshold select (T > 0, the greedy T <= 0 quench and the external
// field alike), and the four uint8 J planes of quenched +-J disorder.
//
// Layout: a color plane is (H, C) bytes, one spin (0 or 1) per byte. The site
// (y, c) sums its four neighbours of the other color: rows y - 1 and y + 1
// (src_up / src_dn at the slab's edges), the same column, and the left or
// right neighbour (periodic): a site looks right where it sits on an odd
// full-lattice column, black on odd rows and white on even rows. With J
// planes each neighbour is XORed with its flag. It flips where its u32 draw
// is at or below thr10[dst*5 + nsum] (unsigned).
//
// Draws: generator call q of row y serves the S sites q + s*G (site_draws.cuh;
// S = 4, 2, 16 for Philox, Threefry, ChaCha; G = C/S). A thread takes V
// neighbouring calls q0 .. q0 + V - 1 of one row, so it owns V neighbouring
// sites in each of the S runs: V = 4 where G % 4 == 0 (each run's four sites
// are one aligned 32-bit word, loaded and stored whole, and their indices
// dst*5 + nsum are summed bytewise in one register, no byte carrying on bit
// planes), else V = 1. Each call is computed once. Neighbouring threads take
// neighbouring words, so a warp's loads and stores cover 128 (V = 4) or 32
// neighbouring bytes. A thread reads only its own dst sites and writes them in
// place: the update is race-free (the wrapper refuses dst overlapping an
// input).
//
// What bounds it (least times on an H100 SXM from its data-sheet rates, not
// measured): per color phase the lattice moves 3 bytes per site (read dst and
// src, write dst; 7 with the J planes): 0.120 ms at 16384^2 (0.280 ms with J
// planes), against 30 (Philox-7) to 375 (ChaCha-8) integer operations per
// generator call and about 6 per site for the index, lookup and flip
// (chip_smoke.py:dense_ops_per_site): 0.05 to 0.16 ms by mode. Both terms
// are close, so the design makes one pass over each byte, moves four sites
// per load and store, keeps every operand in registers and unrolls the
// generator for its round count (a template parameter). The 10-entry table sits in shared
// memory: a by-value table indexed at run time would need a stack frame, and
// a chain of ten selects costs 20 ALU instructions per site.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a (ops/kernel_lib.py). The
// C entry point returns cudaGetLastError() after the launch.

#include "site_draws.cuh"

namespace {

using namespace ising;

// This color's quenched-disorder flags (up, dn, same, off), (H, C) bytes each,
// or all nullptr for none.
struct JPlanes {
  const uint8_t* up;
  const uint8_t* dn;
  const uint8_t* same;
  const uint8_t* off;
};

// V sites of a row as one word: a byte (V = 1) or four neighbouring bytes
// read and written as one aligned 32-bit word (V = 4).
template <int V>
__device__ __forceinline__ uint32_t load_sites(const uint8_t* p) {
  if constexpr (V == 4) {
    return *reinterpret_cast<const uint32_t*>(p);
  } else {
    return *p;
  }
}

template <int V>
__device__ __forceinline__ void store_sites(uint8_t* p, uint32_t v) {
  if constexpr (V == 4) {
    *reinterpret_cast<uint32_t*>(p) = v;
  } else {
    *p = static_cast<uint8_t>(v);
  }
}

template <int FAMILY, int R, int V>
__global__ void __launch_bounds__(256)
dense_sweep_kernel(uint8_t* __restrict__ dst, const uint8_t* __restrict__ src,
                   const uint8_t* __restrict__ src_up,
                   const uint8_t* __restrict__ src_dn, int H, int C,
                   uint32_t row0, uint32_t step, uint32_t tag, int color,
                   Table10 thr, uint32_t k0, uint32_t k1, JPlanes j) {
  constexpr int S = sites_per_call(FAMILY);
  // thr10[dst*5 + nsum] from shared memory, entry 10 the 0 that
  // pallas_dense.py:198-200 selects for an index outside 0..9: one lookup
  // per site instead of a ten-deep chain of compares and selects.
  __shared__ uint32_t table[11];
  if (threadIdx.x == 0 && threadIdx.y == 0) {
#pragma unroll
    for (int k = 0; k < 10; ++k) table[k] = thr.t[k];
    table[10] = 0;
  }
  __syncthreads();
  const int G = C / S;
  const int q0 = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (q0 >= G) return;   // after the block's one barrier
  for (int y = static_cast<int>(blockIdx.y * blockDim.y + threadIdx.y); y < H;
       y += static_cast<int>(gridDim.y * blockDim.y)) {
    const int64_t base = static_cast<int64_t>(y) * C;
    const uint8_t* row = src + base;
    const uint8_t* above = y == 0 ? src_up : row - C;
    const uint8_t* below = y == H - 1 ? src_dn : row + C;
    const bool look_right = (color == 0) == static_cast<bool>(y & 1);
    // 1. per word of V sites (columns c0 .. c0 + V - 1 of run s): the table
    //    index dst*5 + nsum of each site, in its byte (bytes never carry:
    //    dst*5 <= 5 and nsum <= 4 on bit planes).
    uint32_t me[S], idx[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int c0 = s * G + q0;
      const uint32_t same = load_sites<V>(row + c0);
      uint32_t off;
      if (look_right) {   // column c + 1; the row's last site wraps to 0
        const uint32_t next = load_sites<V>(row + (c0 + V == C ? 0 : c0 + V));
        off = V == 4 ? (same >> 8) | (next << 24) : next;
      } else {            // column c - 1; site 0 wraps to C - 1
        const uint32_t prev = load_sites<V>(row + (c0 == 0 ? C - V : c0 - V));
        off = V == 4 ? (same << 8) | (prev >> 24) : prev;
      }
      uint32_t up = load_sites<V>(above + c0), dn = load_sites<V>(below + c0);
      uint32_t sm = same;
      if (j.up != nullptr) {
        up ^= load_sites<V>(j.up + base + c0);
        dn ^= load_sites<V>(j.dn + base + c0);
        sm ^= load_sites<V>(j.same + base + c0);
        off ^= load_sites<V>(j.off + base + c0);
      }
      me[s] = load_sites<V>(dst + base + c0);
      idx[s] = me[s] * 5 + up + dn + sm + off;
    }
    // 2. each of the V generator calls draws once and decides its S sites.
    uint32_t flip[S] = {};
#pragma unroll
    for (int v = 0; v < V; ++v) {
      uint32_t d[S];
      call_draws<FAMILY, R>(row0 + static_cast<uint32_t>(y), static_cast<uint32_t>(G),
                            static_cast<uint32_t>(q0 + v), step, tag, k0, k1, d);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const uint32_t i = (idx[s] >> (8 * v)) & 0xFFu;
        flip[s] |= static_cast<uint32_t>(d[s] <= table[i < 10 ? i : 10]) << (8 * v);
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) store_sites<V>(dst + base + s * G + q0, me[s] ^ flip[s]);
  }
}

// Blocks of 256 threads: bx threads along a row (the smallest power of two
// from 32 to 256 that covers its `threads` threads) by 256 / bx rows, so a
// row of few calls does not leave most of a block idle.
inline void blocks_for(int threads, int H, dim3& grid, dim3& block) {
  int bx = 32;
  while (bx < threads && bx < 256) bx *= 2;
  block = dim3(bx, 256 / bx);
  const int tiles = (H + static_cast<int>(block.y) - 1) / static_cast<int>(block.y);
  grid = dim3((threads + bx - 1) / bx, tiles < 65535 ? tiles : 65535);
}

template <int FAMILY, int R>
struct DenseLaunch {
  // Four sites per word where the calls of a row come in fours (G % 4 == 0,
  // so every word is aligned), else one.
  static void launch(cudaStream_t stream, uint8_t* dst, const uint8_t* src,
                     const uint8_t* up, const uint8_t* dn, int H, int C,
                     uint32_t row0, uint32_t step, uint32_t tag, int color,
                     const Table10& thr, uint32_t k0, uint32_t k1,
                     const JPlanes& j) {
    const int G = C / sites_per_call(FAMILY);
    dim3 grid, block;
    if (G % 4 == 0) {
      blocks_for(G / 4, H, grid, block);
      dense_sweep_kernel<FAMILY, R, 4><<<grid, block, 0, stream>>>(
          dst, src, up, dn, H, C, row0, step, tag, color, thr, k0, k1, j);
    } else {
      blocks_for(G, H, grid, block);
      dense_sweep_kernel<FAMILY, R, 1><<<grid, block, 0, stream>>>(
          dst, src, up, dn, H, C, row0, step, tag, color, thr, k0, k1, j);
    }
  }
};

}  // namespace

// Launch one half-sweep on `stream`. dst, src: (H, C) bytes; src_up, src_dn:
// (1, C); family: 0 = Philox and 2 = ChaCha (k0, k1 = seed lo, hi), 1 =
// Threefry (k0, k1 = threefry_stream_key(seed, step, tag)); thr10: the host's
// (10,) u32 table; j_up .. j_off: the four (H, C) J planes, all nullptr for
// none. Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a (family, rounds) pair that is not instantiated here, a C that the
// family's calls do not tile (C % S), or some but not all four J planes.
extern "C" int dense_sweep_launch(void* dst, const void* src, const void* src_up,
                                  const void* src_dn, int H, int C, uint32_t row0,
                                  uint32_t step, uint32_t tag, int color,
                                  const uint32_t* thr10, uint32_t k0, uint32_t k1,
                                  int family, int rounds, const void* j_up,
                                  const void* j_dn, const void* j_same,
                                  const void* j_off, void* stream) {
  const auto fn = find_u32_mode<DenseLaunch>(family, rounds);
  const int S = sites_per_call(family);
  const int links = (j_up != nullptr) + (j_dn != nullptr) + (j_same != nullptr) +
                    (j_off != nullptr);
  if (fn == nullptr || thr10 == nullptr || H <= 0 || C <= 0 || C % S ||
      (links != 0 && links != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Table10 thr;
  for (int i = 0; i < 10; ++i) thr.t[i] = thr10[i];
  const JPlanes j{static_cast<const uint8_t*>(j_up), static_cast<const uint8_t*>(j_dn),
                  static_cast<const uint8_t*>(j_same), static_cast<const uint8_t*>(j_off)};
  fn(static_cast<cudaStream_t>(stream), static_cast<uint8_t*>(dst),
     static_cast<const uint8_t*>(src), static_cast<const uint8_t*>(src_up),
     static_cast<const uint8_t*>(src_dn), H, C, row0, step, tag, color, thr, k0, k1, j);
  return static_cast<int>(cudaGetLastError());
}
