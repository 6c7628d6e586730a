// One checkerboard color half-sweep of the dense Ising lattice (one uint8 per
// spin), for Hopper (sm_90a). Replaces the TPU kernel
// ising_tpu/ops/pallas_dense.py:_sweep_kernel (:145): the u32-draw rng modes
// (Philox, Threefry, ChaCha, and hw as salted Philox-10), the full 10-entry
// threshold select (T > 0, the greedy T <= 0 quench and the external field
// alike), and the four uint8 J planes of quenched +-J disorder.
//
// Layout: a color plane is (H, C) bytes, one spin (0 or 1) per byte. The site
// (y, c) sums its four neighbours of the other color: rows y - 1 and y + 1
// (src_up / src_dn at the slab's edges), the same column, and the left or
// right neighbour (periodic): a site looks right where it sits on an odd
// full-lattice column, black on odd rows and white on even rows. With J
// planes each neighbour is XORed with its flag. It flips where its u32 draw
// is at or below thr10[dst*5 + nsum] (unsigned). The kernel's domain is bit
// planes (bytes 0 and 1), as the wrapper's callers keep them.
//
// Draws: generator call q of row y serves the S sites q + s*G (site_draws.cuh;
// S = 4, 2, 16 for Philox, Threefry, ChaCha; G = C/S). A thread owns the V
// neighbouring calls q0 .. q0 + V - 1, so V neighbouring sites in each of the
// S runs: V = 4 where G % 4 == 0 (each run's four sites are one aligned
// 32-bit word, loaded and stored whole), else V = 1. Neighbouring threads take
// neighbouring words, so a warp's loads and stores cover 128 (V = 4) or 32
// neighbouring bytes.
//
// The row walk: a thread walks a band of B rows down its columns (B = 8, 4
// for ChaCha; band_rows), with its window of rows in registers: row y + 1's
// word of a run is row y's "below" and row y - 1's is row y + 1's "above",
// so each src word is loaded once a thread, not three times. The side word
// (left or right neighbour) is loaded once, for the row that needs it: the
// same address minus or plus V, but at the two runs whose word can wrap.
// Rows alternate the side they look to, so rows go in pairs whose first row
// has the parity of the color: it always looks left and the second right,
// a compile-time fact inside the pair. Band k starts at row k*B - color, on
// such a row; a lone first or last row takes the same code with the side
// chosen at run time. Any H >= 1 works. Bands are short (band_rows); a CTA
// fills the table and passes its one barrier once for its bands.
//
// The accept through one byte offset: a site's offset into the shared table
// is BIAS + 20*dst + 4*nsum (108..144 on bit planes), summed bytewise for a
// word's four sites (no byte carries), one IMAD a word on the FMA pipe. Each
// site reads its threshold with one __byte_perm and one shared-memory load
// at that offset. The table has 64 words, thr10 at words 27..36 and 0 in the
// rest: every word offset a byte can hold reads a defined entry, the 0 that
// pallas_dense.py:198-200 selects for an index outside 0..9, so there is no
// range check. Bit 7 of the offset byte is dst; a flip toggles it after the
// site's lookup (the compare's predicate guards one xor), and bit 7 of each
// byte is the new word. Threefry's round adds run on the FMA pipe (IMAD by a
// kernel argument that is 1), beside its rotations and xors on the ALU pipe.
//
// What bounds it (least times on an H100 SXM from its data-sheet rates, not
// measured): per color phase the lattice moves 3 bytes per site (read dst and
// src, write dst; 7 with the J planes): 0.120 ms at 16384^2 (0.280 ms with J
// planes), against 30 (Philox-7) to 375 (ChaCha-8) integer operations per
// generator call and about 6 per site for the index, lookup and flip
// (chip_smoke.py:dense_ops_per_site): 0.05 to 0.16 ms by mode. So bytes bound
// it, then the ALU pipe (64 lanes an SM a clock, half the integer issue
// rate). In the main loop a site takes about 10.7 (Philox-10), 21.6
// (Threefry-13) and 20.2 (ChaCha-8) ALU-pipe instructions, of them 3 for the
// accept and 2-3 for addresses and sums; the rest are the generator's
// (python3 -m ising_tpu_torch.sass; the kernel that walked no rows: 23, 34
// and 33).
// ptxas -v (CUDA 12.8, sm_90a), registers a thread and CTAs an SM, no stack
// frame: Philox-10 62 (4 of 256 threads; 64 with J planes), Threefry-13 40
// (6; 48: 5), ChaCha-8 168 (3 of 128), 128-148 where a word is one site.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a (ops/kernel_lib.py). The
// C entry point returns cudaGetLastError() after the launch.

#include "site_draws.cuh"

namespace {

using namespace ising;

// Threads a CTA: 128 for ChaCha, whose threads hold the most (S = 16 runs of
// a three-row window and a 16-word block), 256 for the others.
__host__ __device__ constexpr int threads_for(int family) {
  return family == FAMILY_CHACHA ? 128 : 256;
}

// Rows a thread walks, its band: short, so that the CTAs that run at once
// work on neighbouring rows (on the card, bands of 4 to 12 rows ran faster
// than one wave of long bands or bands of 32 or 64 rows; PERF.md §6);
// 4 for ChaCha, 8 for the others.
__host__ __device__ constexpr int band_rows(int family) {
  return family == FAMILY_CHACHA ? 4 : 8;
}

// A site's byte offset into the shared table: BIAS + 20*dst + 4*nsum, in
// 108..144 on bit planes. Its bit 7 is dst (108 + 16 < 128 <= 108 + 20), and
// the table's 64 words hold thr10 at words 27..36 (BIAS / 4 + 5*dst + nsum)
// and 0 in the rest, so every offset a byte can hold reads a defined entry.
constexpr uint32_t BIAS = 108;
constexpr uint32_t BIAS4 = BIAS * 0x01010101u;
constexpr int TABLE_WORDS = 64;

// This color's quenched-disorder flags (up, dn, same, off), (H, C) bytes each,
// or all nullptr for none.
struct JPlanes {
  const uint8_t* up;
  const uint8_t* dn;
  const uint8_t* same;
  const uint8_t* off;
};

// What every row of a launch shares.
struct Sweep {
  uint8_t* dst;
  const uint8_t* src;
  const uint8_t* src_up;
  const uint8_t* src_dn;
  int H, C;
  uint32_t G;     // generator calls a row, C / S
  int q0;         // the thread's first call (column in each run)
  int left0;      // run 0's left neighbour word, wrapped at column 0
  int rightS;     // run S - 1's right neighbour word, wrapped at column C
  uint32_t row0, step, tag, k0, k1;
  uint32_t one;    // 1, a kernel argument: adds on the FMA pipe
  const uint32_t* table;
  JPlanes j;
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

// Run s of a row: s*G bytes on (one IMAD.WIDE for a constant s).
template <class T>
__device__ __forceinline__ T* run_at(T* row, uint32_t G, int s) {
  return row + static_cast<uint64_t>(G) * static_cast<uint32_t>(s);
}

// site_draws.cuh's call_draws: the draws of call q of global row gy.
template <int FAMILY, int R>
__device__ __forceinline__ void thread_draws(const Sweep& a, uint32_t gy, uint32_t q,
                                             uint32_t (&d)[sites_per_call(FAMILY)]) {
  if constexpr (FAMILY == FAMILY_THREEFRY) {
    const uint64_t c = counter(gy, a.G, q);
    const uint2 o = threefry_fma<R>(static_cast<uint32_t>(c), static_cast<uint32_t>(c >> 32),
                                    a.k0, a.k1, a.one);
    d[0] = o.x;
    d[1] = o.y;
  } else {
    call_draws<FAMILY, R>(gy, a.G, q, a.step, a.tag, a.k0, a.k1, d);
  }
}

// What a row of the thread's words reads from device memory besides its
// window: the row below (the next row's window), the side neighbour words,
// dst, and the J flags.
template <int S, bool J>
struct RowIn {
  uint32_t below[S], nb[S], me[S];
  uint32_t ju[J ? S : 1], jd[J ? S : 1], js[J ? S : 1], jo[J ? S : 1];
};

// Loads row y's inputs: the row below is row y + 1, or src_dn at the slab's
// last row; the side word is the left or right neighbour word (SIDE -1 or
// +1; 0: the side `right` says, a lone row).
template <int FAMILY, int V, bool J, int SIDE>
__device__ __forceinline__ void fetch_row(const Sweep& a, int y, bool right,
                                          RowIn<sites_per_call(FAMILY), J>& in) {
  constexpr int S = sites_per_call(FAMILY);
  if constexpr (SIDE != 0) right = SIDE > 0;
  const int64_t base = static_cast<int64_t>(y) * a.C;
  const uint8_t* row = a.src + base;
  const uint8_t* next = (y + 1 < a.H ? row + a.C : a.src_dn) + a.q0;
  const uint8_t* drow = a.dst + base + a.q0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const uint8_t* at = run_at(row + a.q0, a.G, s);
    in.below[s] = load_sites<V>(run_at(next, a.G, s));
    // column c + 1, the row's last word wrapping to column 0; or column
    // c - 1, column 0 wrapping to C - 1
    in.nb[s] = load_sites<V>(right ? (s == S - 1 ? row + a.rightS : at + V)
                                   : (s == 0 ? row + a.left0 : at - V));
    in.me[s] = load_sites<V>(run_at(drow, a.G, s));
    if constexpr (J) {
      const int64_t c = base + a.q0;
      in.ju[s] = load_sites<V>(run_at(a.j.up + c, a.G, s));
      in.jd[s] = load_sites<V>(run_at(a.j.dn + c, a.G, s));
      in.js[s] = load_sites<V>(run_at(a.j.same + c, a.G, s));
      in.jo[s] = load_sites<V>(run_at(a.j.off + c, a.G, s));
    }
  }
}

// Updates the thread's words of row y from its window (up and same: rows
// y - 1 and y) and its inputs; SIDE as for fetch_row.
template <int FAMILY, int R, int V, bool J, int SIDE>
__device__ __forceinline__ void update_row(const Sweep& a, int y, bool right,
                                           const uint32_t (&up)[sites_per_call(FAMILY)],
                                           const uint32_t (&same)[sites_per_call(FAMILY)],
                                           const RowIn<sites_per_call(FAMILY), J>& in) {
  constexpr int S = sites_per_call(FAMILY);
  if constexpr (SIDE != 0) right = SIDE > 0;
  uint8_t* drow = a.dst + static_cast<int64_t>(y) * a.C + a.q0;
  // 1. per word of V sites: the byte offsets BIAS + 20*dst + 4*nsum of its
  //    sites, each in its byte (no byte carries)
  uint32_t off[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    uint32_t side = V == 4 ? (right ? __funnelshift_r(same[s], in.nb[s], 8)
                                    : __funnelshift_l(in.nb[s], same[s], 8))
                           : in.nb[s];
    uint32_t u = up[s], d = in.below[s], m = same[s];
    if constexpr (J) {
      u ^= in.ju[s];
      d ^= in.jd[s];
      m ^= in.js[s];
      side ^= in.jo[s];
    }
    off[s] = (u + d + m + side) * 4u + (in.me[s] * 20u + (V == 4 ? BIAS4 : BIAS));
  }
  // 2. each of the V generator calls draws once and decides its S sites: a
  //    flip toggles bit 7 of the site's byte, its dst, after its lookup
#pragma unroll
  for (int v = 0; v < V; ++v) {
    uint32_t d[S];
    thread_draws<FAMILY, R>(a, a.row0 + static_cast<uint32_t>(y), static_cast<uint32_t>(a.q0 + v), d);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const uint32_t th = *reinterpret_cast<const uint32_t*>(
          reinterpret_cast<const char*>(a.table) + __byte_perm(off[s], 0u, 0x4440 | v));
      flip_if_le(off[s], d[s], th, 0x80u << (8 * v));
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    store_sites<V>(run_at(drow, a.G, s), off[s] >> 7 & 0x01010101u);
  }
}

// The thread's words of row y in src (row - 1 reads src_up at y = 0).
template <int FAMILY, int V>
__device__ __forceinline__ void load_row(const Sweep& a, int y,
                                         uint32_t (&w)[sites_per_call(FAMILY)]) {
  const uint8_t* row = (y < 0 ? a.src_up : a.src + static_cast<int64_t>(y) * a.C) + a.q0;
#pragma unroll
  for (int s = 0; s < sites_per_call(FAMILY); ++s) w[s] = load_sites<V>(run_at(row, a.G, s));
}

// The window moves a row down: the row below becomes the row itself.
template <int S, bool J>
__device__ __forceinline__ void slide(uint32_t (&up)[S], uint32_t (&same)[S],
                                      const RowIn<S, J>& in) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    up[s] = same[s];
    same[s] = in.below[s];
  }
}

template <int FAMILY, int R, int V, bool J>
__global__ void __launch_bounds__(threads_for(FAMILY))
dense_sweep_kernel(uint8_t* __restrict__ dst, const uint8_t* __restrict__ src,
                   const uint8_t* __restrict__ src_up,
                   const uint8_t* __restrict__ src_dn, int H, int C, int bands,
                   uint32_t row0, uint32_t step, uint32_t tag, int color,
                   Table10 thr, uint32_t k0, uint32_t k1, uint32_t one, JPlanes j) {
  constexpr int S = sites_per_call(FAMILY);
  constexpr int B = band_rows(FAMILY);
  __shared__ uint32_t table[TABLE_WORDS];
  if (threadIdx.x == 0 && threadIdx.y == 0) {
#pragma unroll
    for (int k = 0; k < TABLE_WORDS; ++k) {
      const int i = k - static_cast<int>(BIAS / 4);
      table[k] = i >= 0 && i < 10 ? thr.t[i >= 0 && i < 10 ? i : 0] : 0u;
    }
  }
  __syncthreads();
  const int G = C / S;
  const int q0 = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (q0 >= G) return;   // after the block's one barrier
  const Sweep a{dst, src, src_up, src_dn, H, C, static_cast<uint32_t>(G), q0,
                q0 == 0 ? C - V : q0 - V, q0 + V == G ? 0 : (S - 1) * G + q0 + V,
                row0, step, tag, k0, k1, one, table, j};
  for (int k = static_cast<int>(blockIdx.y * blockDim.y + threadIdx.y); k < bands;
       k += static_cast<int>(gridDim.y * blockDim.y)) {
    // band k: rows k*B - color .. (k+1)*B - color - 1, cut to 0 .. H - 1
    const int y0 = k == 0 ? 0 : k * B - color;
    const int y1 = (k + 1) * B - color < H ? (k + 1) * B - color : H;
    const int lead = (y0 & 1) != color;   // a lone first row, of the other parity
    int y = y0 + lead;
    uint32_t up[S], same[S];
    RowIn<S, J> in;
    if (y + 1 < y1) {
      load_row<FAMILY, V>(a, y - 1, up);
      load_row<FAMILY, V>(a, y, same);
    }
#pragma unroll 1
    for (; y + 1 < y1; y += 2) {
      fetch_row<FAMILY, V, J, -1>(a, y, false, in);
      update_row<FAMILY, R, V, J, -1>(a, y, false, up, same, in);
      slide(up, same, in);
      fetch_row<FAMILY, V, J, +1>(a, y + 1, true, in);
      update_row<FAMILY, R, V, J, +1>(a, y + 1, true, up, same, in);
      slide(up, same, in);
    }
    // the lone rows: the first (if it has the other parity) and the last
#pragma unroll 1
    for (int i = 0; i < 2; ++i) {
      const int ly = i == 0 ? (lead ? y0 : -1) : (y < y1 ? y : -1);
      if (ly < 0) continue;
      const bool right = (color == 0) == static_cast<bool>(ly & 1);
      load_row<FAMILY, V>(a, ly - 1, up);
      load_row<FAMILY, V>(a, ly, same);
      fetch_row<FAMILY, V, J, 0>(a, ly, right, in);
      update_row<FAMILY, R, V, J, 0>(a, ly, right, up, same, in);
    }
  }
}

// CTAs of `cta` threads for `threads` threads a row: bx along a row (the
// smallest power of two from 32 to cta that covers the row) by cta / bx
// bands.
inline void geometry(int cta, int threads, int bands, dim3& grid, dim3& block) {
  int bx = 32;
  while (bx < threads && bx < cta) bx *= 2;
  block = dim3(bx, cta / bx);
  const int gy = (bands + static_cast<int>(block.y) - 1) / static_cast<int>(block.y);
  grid = dim3((threads + bx - 1) / bx, gy < 65535 ? gy : 65535);
}

template <int FAMILY, int R>
struct DenseLaunch {
  // Four sites per word where the calls of a row come in fours (G % 4 == 0,
  // so every word is aligned), else one; J planes or none. Band k holds rows
  // k*B - color .. (k+1)*B - color - 1: (H + B) / B bands cover the H + 1
  // rows that color 1 shifts them over.
  template <int V, bool J>
  static void launch_v(cudaStream_t stream, uint8_t* dst, const uint8_t* src,
                       const uint8_t* up, const uint8_t* dn, int H, int C,
                       uint32_t row0, uint32_t step, uint32_t tag, int color,
                       const Table10& thr, uint32_t k0, uint32_t k1, const JPlanes& j) {
    constexpr int B = band_rows(FAMILY);
    const int bands = (H + B) / B;
    dim3 grid, block;
    geometry(threads_for(FAMILY), C / sites_per_call(FAMILY) / V, bands, grid, block);
    dense_sweep_kernel<FAMILY, R, V, J><<<grid, block, 0, stream>>>(
        dst, src, up, dn, H, C, bands, row0, step, tag, color, thr, k0, k1, 1u, j);
  }

  static void launch(cudaStream_t stream, uint8_t* dst, const uint8_t* src,
                     const uint8_t* up, const uint8_t* dn, int H, int C,
                     uint32_t row0, uint32_t step, uint32_t tag, int color,
                     const Table10& thr, uint32_t k0, uint32_t k1,
                     const JPlanes& j) {
    const bool four = C / sites_per_call(FAMILY) % 4 == 0;
    const auto fn = four ? (j.up ? &launch_v<4, true> : &launch_v<4, false>)
                         : (j.up ? &launch_v<1, true> : &launch_v<1, false>);
    fn(stream, dst, src, up, dn, H, C, row0, step, tag, color, thr, k0, k1, j);
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
      (links != 0 && links != 4) || (color != 0 && color != 1)) {
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
