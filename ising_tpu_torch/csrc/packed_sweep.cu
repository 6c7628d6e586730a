// One checkerboard color half-sweep of the packed Ising lattice (4 bits per
// spin), for Hopper (sm_90a). Replaces the TPU kernel
// ising_tpu/ops/pallas_packed.py:_packed_kernel (:396-450) with
// _metropolis_block (:192-240) and _accept_and_flip (:243-393): the u32-draw
// rng modes (Philox, Threefry, ChaCha, and hw as salted Philox-10), T > 0,
// the greedy T <= 0 quench and the 10-entry external-field table, the J word
// of quenched +-J disorder and the sub-lattice replica wraps.
//
// Layout, accept and draws: packed_word.cuh, shared with the fused
// both-colors step (packed_fused.cu).
//
// The row walk: a thread owns one word column (ChaCha: the pair q, q + W/2)
// and walks a band of B rows down it (band_rows), with its window of src
// words in registers: row y + 1's word becomes row y's "below" and row
// y - 1's becomes row y + 1's "above", so each src word is loaded once a
// thread, not three times. The off-column word is loaded once, for the row
// that needs it (it hits L1: the neighbouring thread loaded it as its
// below), at a column offset and with a rotation that are fixed for the
// thread (Side): only the words at a row's or a replica's
// ends take another column, and only the row's end words rotate. Rows
// alternate the side they look to, so rows go in pairs whose first row has
// the parity of the color: it always looks left and the second right, a
// compile-time fact inside the pair. Band k starts at row k*B - color, on
// such a row; a lone first or last row takes the same code with the side
// chosen at run time. A thread's counters keep their addends across its rows
// (packed_word.cuh:Calls). The grid is two-dimensional (word columns by
// bands), so no thread divides an index. The J word and the replica rows
// are template parameters, so that the ordered path carries neither: rows
// of replicas ysl tall reload the window at a replica's first row and take
// its first row as the last row's below.
//
// No thread reads another thread's dst word, so the in-place update is
// race-free (the wrapper refuses dst/src overlap). Neighbouring threads take
// neighbouring words, so every load and the store coalesce.
//
// What bounds it: per color phase the lattice moves 3 words per 8 spins
// (read dst, read src, write dst; 4 with the J word), 0.060 ms at 16384^2
// (0.080 ms with the J word), against 2 Philox, 4 Threefry or half a ChaCha
// call per word plus about 60 operations of neighbours, classes and accept:
// 142 (Philox-10) to 236 (Threefry-13) integer operations per word, 0.071 to
// 0.118 ms (chip_smoke.py:packed_ops_per_word). Both terms are close, and the
// ALU pipe (64 lanes an SM, half the integer issue rate) runs most of them:
// so the design keeps every operand in registers, the generators fully
// unrolled for their round count (a template parameter), Threefry's round
// adds on the FMA pipe, and the per-word index, address and edge work off
// the rows the walk repeats.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a (ops/kernel_lib.py). The
// C entry point returns cudaGetLastError() after the launch.

#include "packed_word.cuh"

namespace {

using namespace ising;

constexpr int THREADS = 256;

// Rows a thread walks, its band (even: rows go in pairs).
__host__ __device__ constexpr int band_rows(int family) {
  return family == FAMILY_CHACHA ? 12 : 12;
}

// What every row of a launch shares: jword, the J word of quenched disorder
// (nullptr for none; the flags of field z in its bits 4z..4z+3: up, dn,
// same, off); csl > 0 replicas csl words wide (csl divides W), ysl > 0
// replicas ysl rows tall (ysl divides H); 0 is the periodic wrap.
struct Sweep {
  uint32_t* dst;
  const uint32_t* src;
  const uint32_t* src_up;
  const uint32_t* src_dn;
  const uint32_t* jword;
  int H, W, csl, ysl, bands, color;
  uint32_t row0;
  Stream s;
  uint32_t one;   // 1, a kernel argument: adds on the FMA pipe
};

// Where a word's off-column neighbour lies in the same row: a byte offset
// from the word and a left rotation, fixed for a thread's word across its
// rows.
struct Side {
  int64_t bytes;
  int rot;
};

// A thread's words (columns j) and their side neighbours in rows that look
// left and right (pallas_packed.py:202-235): word j - 1 or j + 1 of the same
// field; at the row's first / last word the last / first word with every
// field moved one group (a 4-bit rotation). Replicas: at lane j % csl == 0
// the left neighbour is lane j + csl - 1, at j % csl == csl - 1 the right
// one lane j - csl + 1, with no rotation (csl divides W, so the wrap stays
// inside the field group).
template <int P>
struct Cols {
  int j[P];
  Side left[P], right[P];

  __device__ __forceinline__ Cols(int q, int W, int csl) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      j[p] = q + p * (W / 2);
      const bool first = csl ? j[p] % csl == 0 : j[p] == 0;
      const bool last = csl ? j[p] % csl == csl - 1 : j[p] == W - 1;
      const int span = (csl ? csl : W) - 1;   // to the other end of the row
      left[p] = first ? Side{4 * static_cast<int64_t>(span), csl ? 0 : 4} : Side{-4, 0};
      right[p] = last ? Side{-4 * static_cast<int64_t>(span), csl ? 0 : 28} : Side{4, 0};
    }
  }
};

template <class T>
__device__ __forceinline__ T* add_bytes(T* p, int64_t bytes) {
  return reinterpret_cast<T*>(reinterpret_cast<uintptr_t>(p) + bytes);
}

// A thread's words in one row: of dst and of src (columns j) and, with the
// J word, of jword. A row down is a 64-bit add to each (no multiply).
template <int P, bool J>
struct Row {
  uint32_t* d[P];
  const uint32_t* s[P];
  const uint32_t* jw[J ? P : 1];

  __device__ __forceinline__ Row(const Sweep& a, const Cols<P>& c, int y) {
    const int64_t base = static_cast<int64_t>(y) * a.W;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      d[p] = a.dst + base + c.j[p];
      s[p] = a.src + base + c.j[p];
      if constexpr (J) jw[p] = a.jword + base + c.j[p];
    }
  }

  __device__ __forceinline__ Row down(int64_t row_bytes) const {
    Row r = *this;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      r.d[p] = add_bytes(d[p], row_bytes);
      r.s[p] = add_bytes(s[p], row_bytes);
      if constexpr (J) r.jw[p] = add_bytes(jw[p], row_bytes);
    }
    return r;
  }
};

// Plane row y (y = -1: the slab's src_up row; y = H: src_dn).
__device__ __forceinline__ const uint32_t* src_row(const Sweep& a, int y) {
  return y < 0 ? a.src_up : y >= a.H ? a.src_dn : a.src + static_cast<int64_t>(y) * a.W;
}

// The rows above and below row y: y - 1 and y + 1 (src_up and src_dn past
// the slab's edges), or with replicas ysl tall (YSL) the replica's last row
// above its first and its first below its last. r is y % ysl.
template <bool YSL>
__device__ __forceinline__ const uint32_t* above(const Sweep& a, int y, int r) {
  return src_row(a, YSL && r == 0 ? y + a.ysl - 1 : y - 1);
}

template <bool YSL>
__device__ __forceinline__ const uint32_t* below(const Sweep& a, int y, int r) {
  return src_row(a, YSL && r == a.ysl - 1 ? y - a.ysl + 1 : y + 1);
}

// The thread's words in a row whose word 0 is at `row`.
template <int P>
__device__ __forceinline__ void words_at(const uint32_t* row, const Cols<P>& c,
                                         const uint32_t* (&w)[P]) {
#pragma unroll
  for (int p = 0; p < P; ++p) w[p] = row + c.j[p];
}

// The window of row y: the thread's words in the row above it (up) and in
// row y itself (same).
template <int P, bool YSL>
__device__ __forceinline__ void load_window(const Sweep& a, const Cols<P>& c, int y, int r,
                                            uint32_t (&up)[P], uint32_t (&same)[P]) {
  const uint32_t* u = above<YSL>(a, y, r);
  const uint32_t* m = src_row(a, y);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    up[p] = u[c.j[p]];
    same[p] = m[c.j[p]];
  }
}

// Updates the thread's words of global row gy at `at` from its window and
// the words below them (`dn`), then moves the window a row down. SIDE -1 or
// +1: the row looks left or right; 0: the side `right` says (a lone row).
template <int FAMILY, int R, int ACCEPT, bool J, int SIDE>
__device__ __forceinline__ void update_row(
    const Sweep& a, const Cols<words_per_thread(FAMILY)>& c,
    const Calls<FAMILY>& calls, const uint32_t* table, uint32_t gy, bool right,
    const Row<words_per_thread(FAMILY), J>& at,
    const uint32_t* const (&dn)[words_per_thread(FAMILY)],
    uint32_t (&up)[words_per_thread(FAMILY)], uint32_t (&same)[words_per_thread(FAMILY)]) {
  constexpr int P = words_per_thread(FAMILY);
  if constexpr (SIDE != 0) right = SIDE > 0;
  // the row's loads, issued together
  uint32_t me[P], below[P], side[P], jw[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const Side sd = right ? c.right[p] : c.left[p];
    me[p] = *at.d[p];
    below[p] = *dn[p];
    side[p] = rotl(*add_bytes(at.s[p], sd.bytes), sd.rot);
    if constexpr (J) jw[p] = *at.jw[p];
  }
  // each word's eight byte offsets from its whole-word neighbour sum, the J
  // word's flags XORed into the four neighbours
  uint2 off[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    uint32_t u = up[p], d = below[p], m = same[p], o = side[p];
    if constexpr (J) {
      u ^= jw[p] & M1;
      d ^= (jw[p] >> 1) & M1;
      m ^= (jw[p] >> 2) & M1;
      o ^= (jw[p] >> 3) & M1;
    }
    off[p] = field_offsets<ACCEPT>(me[p], u + d + m + o);
  }
  accept_words<FAMILY, R>(me, off, gy, calls, a.s, a.one, table);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    *at.d[p] = me[p];
    up[p] = same[p];
    same[p] = below[p];
  }
}

// A row of the pair loop, at `at`, whose row below lies in the plane
// (without replica rows, the loop stops short of the slab's last row); `at`
// moves a row down. With replicas ysl tall the window reloads at a
// replica's first row and the last row's below is the first; r (y % ysl)
// moves on a row.
template <int FAMILY, int R, int ACCEPT, bool J, bool YSL, int SIDE>
__device__ __forceinline__ void walk_row(const Sweep& a, const Cols<words_per_thread(FAMILY)>& c,
                                         const Calls<FAMILY>& calls, const uint32_t* table,
                                         uint32_t gy, int& r,
                                         Row<words_per_thread(FAMILY), J>& at,
                                         uint32_t (&up)[words_per_thread(FAMILY)],
                                         uint32_t (&same)[words_per_thread(FAMILY)]) {
  constexpr int P = words_per_thread(FAMILY);
  const int64_t row_bytes = 4 * static_cast<int64_t>(a.W);
  const Row<P, J> next = at.down(row_bytes);
  const uint32_t* dn[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if constexpr (YSL) {
      if (r == 0) {   // a replica's first row: its last row above it
        up[p] = *add_bytes(at.s[p], (a.ysl - 1) * row_bytes);
        same[p] = *at.s[p];
      }
      dn[p] = r == a.ysl - 1 ? add_bytes(at.s[p], (1 - a.ysl) * row_bytes) : next.s[p];
    } else {
      dn[p] = next.s[p];
    }
  }
  update_row<FAMILY, R, ACCEPT, J, SIDE>(a, c, calls, table, gy, SIDE > 0, at, dn, up,
                                         same);
  at = next;
  if constexpr (YSL) r = r + 1 == a.ysl ? 0 : r + 1;
}

template <int FAMILY, int R, int ACCEPT, bool J, bool YSL>
__global__ void __launch_bounds__(THREADS)
packed_sweep_kernel(const Sweep a, const Thresholds thr) {
  constexpr int P = words_per_thread(FAMILY);
  constexpr int B = band_rows(FAMILY);
  __shared__ uint32_t table[TABLE_WORDS];
  if (threadIdx.x == 0 && threadIdx.y == 0) fill_table<ACCEPT>(table, thr);
  __syncthreads();
  const int q = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x);
  if (q >= a.W / P) return;   // after the block's one barrier
  const Cols<P> c(q, a.W, a.csl);
  const Calls<FAMILY> calls(q, a.W);
  for (int k = static_cast<int>(blockIdx.y * blockDim.y + threadIdx.y); k < a.bands;
       k += static_cast<int>(gridDim.y * blockDim.y)) {
    // band k: rows k*B - color .. (k+1)*B - color - 1, cut to 0 .. H - 1
    const int y0 = k == 0 ? 0 : k * B - a.color;
    const int y1 = (k + 1) * B - a.color < a.H ? (k + 1) * B - a.color : a.H;
    const int lead = (y0 & 1) != a.color;   // a lone first row, of the other parity
    int y = y0 + lead;
    int r = YSL ? y % a.ysl : 0;
    uint32_t up[P], same[P];
    // pairs of rows y (looks left) and y + 1 (right); without replica rows
    // the last row's below (src_dn) is left to the lone rows
    if (y + 1 < y1 && (YSL || y + 2 < a.H)) {
      Row<P, J> at(a, c, y);
      if (!(YSL && r == 0)) load_window<P, YSL>(a, c, y, r, up, same);
#pragma unroll 1
      for (; y + 1 < y1 && (YSL || y + 2 < a.H); y += 2) {
        const uint32_t gy = a.row0 + static_cast<uint32_t>(y);
        walk_row<FAMILY, R, ACCEPT, J, YSL, -1>(a, c, calls, table, gy, r, at, up, same);
        walk_row<FAMILY, R, ACCEPT, J, YSL, +1>(a, c, calls, table, gy + 1, r, at, up,
                                                same);
      }
    }
    // the lone rows: the first (if it has the other parity) and the last
    // one or two
#pragma unroll 1
    for (int i = 0; i < 3; ++i) {
      const int ly = i == 0 ? (lead ? y0 : -1) : (y + i - 1 < y1 ? y + i - 1 : -1);
      if (ly < 0) continue;
      const int lr = YSL ? ly % a.ysl : 0;
      const uint32_t* dn[P];
      words_at(below<YSL>(a, ly, lr), c, dn);
      load_window<P, YSL>(a, c, ly, lr, up, same);
      update_row<FAMILY, R, ACCEPT, J, 0>(a, c, calls, table,
                                          a.row0 + static_cast<uint32_t>(ly),
                                          looks_right(a.color, ly), Row<P, J>(a, c, ly),
                                          dn, up, same);
    }
  }
}

// CTAs of THREADS threads for `units` threads a row: bx along a row (the
// smallest power of two from 32 to THREADS that covers the row) by
// THREADS / bx bands.
inline void geometry(int units, int bands, dim3& grid, dim3& block) {
  int bx = 32;
  while (bx < units && bx < THREADS) bx *= 2;
  block = dim3(bx, THREADS / bx);
  const int gy = (bands + static_cast<int>(block.y) - 1) / static_cast<int>(block.y);
  grid = dim3((units + bx - 1) / bx, gy < 65535 ? gy : 65535);
}

// Band k holds rows k*B - color .. (k+1)*B - color - 1: (H + B) / B bands
// cover the H + 1 rows that color 1 shifts them over.
template <int FAMILY, int R, int ACCEPT, bool J, bool YSL>
void launch_geometry(cudaStream_t stream, Sweep a, const Thresholds& thr) {
  constexpr int B = band_rows(FAMILY);
  a.bands = (a.H + B) / B;
  dim3 grid, block;
  geometry(a.W / words_per_thread(FAMILY), a.bands, grid, block);
  packed_sweep_kernel<FAMILY, R, ACCEPT, J, YSL><<<grid, block, 0, stream>>>(a, thr);
}

// The kernel of the J word (or none) and of replica rows (or none).
template <int FAMILY, int R, int ACCEPT>
void launch(cudaStream_t stream, Sweep a, const Thresholds& thr) {
  const auto fn = a.jword ? (a.ysl ? launch_geometry<FAMILY, R, ACCEPT, true, true>
                                   : launch_geometry<FAMILY, R, ACCEPT, true, false>)
                          : (a.ysl ? launch_geometry<FAMILY, R, ACCEPT, false, true>
                                   : launch_geometry<FAMILY, R, ACCEPT, false, false>);
  fn(stream, a, thr);
}

using Launch = void (*)(cudaStream_t, Sweep, const Thresholds&);

template <int FAMILY, int R>
Launch with_accept(int accept) {
  if (accept == ACCEPT_METROPOLIS) return launch<FAMILY, R, ACCEPT_METROPOLIS>;
  if (accept == ACCEPT_GREEDY) return launch<FAMILY, R, ACCEPT_GREEDY>;
  if (accept == ACCEPT_FIELD) return launch<FAMILY, R, ACCEPT_FIELD>;
  return nullptr;
}

// The (family, rounds) pairs of the u32 rng modes (ising_tpu/rng.py:99-113).
Launch find_launch(int family, int rounds, int accept) {
  if (family == FAMILY_PHILOX && rounds == 10) return with_accept<FAMILY_PHILOX, 10>(accept);
  if (family == FAMILY_PHILOX && rounds == 7) return with_accept<FAMILY_PHILOX, 7>(accept);
  if (family == FAMILY_THREEFRY && rounds == 20) return with_accept<FAMILY_THREEFRY, 20>(accept);
  if (family == FAMILY_THREEFRY && rounds == 13) return with_accept<FAMILY_THREEFRY, 13>(accept);
  if (family == FAMILY_CHACHA && rounds == 8) return with_accept<FAMILY_CHACHA, 8>(accept);
  if (family == FAMILY_CHACHA && rounds == 6) return with_accept<FAMILY_CHACHA, 6>(accept);
  if (family == FAMILY_CHACHA && rounds == 4) return with_accept<FAMILY_CHACHA, 4>(accept);
  return nullptr;
}

}  // namespace

// Launch one half-sweep on `stream`. family: 0 = Philox and 2 = ChaCha
// (k0, k1 = seed lo, hi), 1 = Threefry (k0, k1 = threefry_stream_key(seed,
// step, tag)); accept: 0 = T > 0, 1 = the greedy quench, 2 = the full table;
// thr10: the host's (10,) u32 threshold table. jword, csl, ysl: the
// geometry of Sweep above (nullptr and 0 for none). Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// (family, rounds, accept) that is not instantiated here, a shape the grid
// cannot cover (ChaCha needs an even W) or a replica size that does not
// divide the plane.
extern "C" int packed_sweep_launch(void* dst, const void* src, const void* src_up,
                                   const void* src_dn, int H, int W,
                                   uint32_t row0, uint32_t step, uint32_t tag,
                                   int color, const uint32_t* thr10, uint32_t k0,
                                   uint32_t k1, int family, int rounds, int accept,
                                   const void* jword, int csl, int ysl,
                                   void* stream) {
  const Launch fn = find_launch(family, rounds, accept);
  const int pair = family == FAMILY_CHACHA ? 2 : 1;
  if (fn == nullptr || thr10 == nullptr || H <= 0 || W <= 0 || W % pair ||
      H > 0x7FFFFFFF - 16 || csl < 0 || ysl < 0 || (csl && W % csl) ||
      (ysl && H % ysl) || (color != 0 && color != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Thresholds thr;
  for (int i = 0; i < 10; ++i) thr.t[i] = thr10[i];
  const Sweep a{static_cast<uint32_t*>(dst), static_cast<const uint32_t*>(src),
                static_cast<const uint32_t*>(src_up), static_cast<const uint32_t*>(src_dn),
                static_cast<const uint32_t*>(jword), H, W, csl, ysl, 0, color, row0,
                Stream{step, tag, k0, k1}, 1u};
  fn(static_cast<cudaStream_t>(stream), a, thr);
  return static_cast<int>(cudaGetLastError());
}
