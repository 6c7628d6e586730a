// One whole Metropolis step of the packed Ising lattice (4 bits per spin):
// both checkerboard colors in one launch, for Hopper (sm_90a). Replaces the
// TPU kernels ising_tpu/ops/pallas_packed.py:_fused_kernel (:453-528, via
// packed_fused_step :753) and :_fused_manual_kernel (:531-682, via
// packed_fused_step_manual :688): black against the old white plane, then
// white against the new black plane, out of place, in the u32-draw rng modes
// (Philox, Threefry, ChaCha, and hw as salted Philox-10), at T > 0, in the
// greedy T <= 0 quench and with the 10-entry field table. The result equals
// two packed_sweep launches (packed_sweep.cu) bit for bit: the accept and
// the draws are packed_word.cuh's.
//
// Design: bands of whole rows, the halo recomputed. CTA b owns rows [a, a + n)
// of both output planes and walks down them with a one-row lag, the
// counterpart of the TPU kernels' one-block lag: step s computes new black
// row a - 1 + s from old black row a - 1 + s and old white rows a - 2 + s ..
// a + s, then new white row a - 2 + s from its old word and new black rows
// a - 3 + s .. a - 1 + s. The new black rows a - 1 and a + n lie outside the
// band: the CTA computes them again rather than wait for their owner. Their
// inputs are old planes that nobody writes, and the draws are counter-based
// by the plane's row (row0 + y), so the copy equals the owner's row bit for
// bit. No CTA waits for another (no grid sync, no flags in device memory),
// whatever order the CTAs run in. Rows wrap mod H, so white row 0 reads new
// black row H - 1 directly, and a band may wrap onto itself (H = 1, 2).
// Shared memory holds full-width rows: a ring of 4 old-white rows and one of
// 3 new-black rows (7 rows, 29 KiB at W = 1024). Each row sits between two
// pad words that hold its end words rotated, so a word's off-column
// neighbour is the word beside it, the row's side one pointer for all of a
// thread's words. A thread takes word columns threadIdx.x + i * THREADS,
// each with the shared word update of packed_word.cuh (the accept through
// one byte offset a field into a 32-word shared table).
//
// Two ways rows reach shared memory, two entry points (rows 3 and 4 of the
// kernel table): packed_fused_step_launch loads each old-white row with
// plain coalesced loads just before it is needed (a barrier a row), reading
// old black straight from device memory; packed_fused_step_manual_launch
// copies the old-white and old-black rows of step s + STAGES with cp.async
// into rings of STAGES + 3 and STAGES + 1 rows while step s computes
// (commit_group / wait_group: a slot is written only after the barrier that
// ends its last read, and read only after its group has landed), 16-byte
// copies where W % 4 == 0 and the planes are 16-byte aligned, 4-byte ones
// elsewhere (W = 66 at 1056 columns).
//
// What bounds it: a step reads each plane once and writes each once, 4
// words per 8 spins (6 for two half-sweeps), 0.080 ms at 16384^2 at
// 3.35 TB/s, against twice a half-sweep's integer operations, 142
// (Philox-10) to 244 (ChaCha8) per word and color, 0.142 to 0.244 ms
// (chip_smoke.py:packed_ops_per_word). The operations bind, so the design
// keeps packed_sweep's arithmetic (operands in registers, generators fully
// unrolled) and adds only what the band needs: two recomputed black rows a
// band, which the default band height (one wave of CTAs, from the occupancy
// of the kernel) keeps to 6-8% of the work at 16384^2. That share is what
// the step pays over two packed_sweep launches, whose row walk has no
// per-word address work left either: both run at the same ALU (Threefry,
// ChaCha) or FMA (Philox's wide multiplies) time a word.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a (ops/kernel_lib.py). The
// C entry points return cudaGetLastError() after the launch.

#include "packed_word.cuh"

namespace {

using namespace ising;

constexpr int THREADS = 256;
constexpr int STAGES = 2;           // rows copied ahead by cp.async
constexpr int NEW_BLACK_ROWS = 3;   // new black rows a - 1 + s - 2 .. s

// Rows of shared memory: the old-white ring, the new-black ring and, with
// cp.async, the old-black ring.
constexpr int OLD_BLACK_ROWS = STAGES + 1;
template <bool ASYNC>
constexpr int WHITE_ROWS = ASYNC ? STAGES + 3 : 4;
template <bool ASYNC>
constexpr int SMEM_ROWS = WHITE_ROWS<ASYNC> + NEW_BLACK_ROWS + (ASYNC ? OLD_BLACK_ROWS : 0);

struct FusedArgs {
  const uint32_t* black;  // old planes, (H, W) words
  const uint32_t* white;
  uint32_t* black_out;    // new planes
  uint32_t* white_out;
  int H, W, band;         // band: rows a CTA owns
  uint32_t row0;          // the plane's first global row, for the draws
  Stream sb, sw;          // black's and white's counter streams
  Thresholds thr;
  uint32_t one;           // 1: adds on the FMA pipe
  bool vec16;             // rows copy as 16-byte vectors
};

__device__ __forceinline__ int wrap_row(int y, int H) {
  y %= H;
  return y < 0 ? y + H : y;
}

// cp.async of 4 or 16 bytes, its commit and its wait (a plain copy and
// nothing off the card).
__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
#ifdef __CUDA_ARCH__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void cp_async16(uint32_t* dst, const uint32_t* src) {
#ifdef __CUDA_ARCH__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
#else
  for (int i = 0; i < 4; ++i) dst[i] = src[i];
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
#endif
}

// One row of W words into shared memory, by every thread of the CTA.
template <bool ASYNC>
__device__ __forceinline__ void copy_row(uint32_t* dst, const uint32_t* src,
                                         int W, bool vec16) {
  if (vec16) {
    for (int i = threadIdx.x; i < W / 4; i += THREADS) {
      if constexpr (ASYNC) {
        cp_async16(dst + 4 * i, src + 4 * i);
      } else {
        reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
      }
    }
  } else {
    for (int i = threadIdx.x; i < W; i += THREADS) {
      if constexpr (ASYNC) {
        cp_async4(dst + i, src + i);
      } else {
        dst[i] = src[i];
      }
    }
  }
}

// A row of W words in shared memory sits between two pad words: word -1
// holds its word W - 1 rotated 4 bits left and word W its word 0 rotated 28,
// so that every word's off-column neighbour is word j - 1 or j + 1 of its
// row (pallas_packed.py:202-235), with no select at the row's ends. Rows
// start PAD words into their slot of W + 2 * PAD words (16-byte aligned).
constexpr int PAD = 4;
constexpr int PAD_THREAD = THREADS - 1;   // the thread that writes the pads

__device__ __forceinline__ void write_pads(uint32_t* row, int W) {
  row[-1] = rotl(row[W - 1], 4);
  row[W] = rotl(row[0], 28);
}

// One row of a plane's new words from shared-memory rows: `me` (the row's
// old words), up, same and dn (the other color's rows around it) and
// off_row (same, one word to the side the row looks to); into out and, where
// gout is not null, device memory. A thread takes word columns threadIdx.x,
// threadIdx.x + THREADS, ...; each keeps its counter addends (Calls).
template <int FAMILY, int R, int ACCEPT>
__device__ __forceinline__ void update_row(const uint32_t* me, const uint32_t* up,
                                           const uint32_t* same, const uint32_t* dn,
                                           const uint32_t* off_row, uint32_t* out,
                                           uint32_t* gout, uint32_t gy, int W,
                                           const Stream& s, uint32_t one,
                                           const uint32_t* table) {
  constexpr int P = words_per_thread(FAMILY);
  for (int q = threadIdx.x; q < W / P; q += THREADS) {
    const Calls<FAMILY> calls(q, W);
    uint32_t x[P];
    uint2 off[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int j = q + p * (W / 2);
      x[p] = me[j];
      off[p] = field_offsets<ACCEPT>(x[p], up[j] + dn[j] + same[j] + off_row[j]);
    }
    accept_words<FAMILY, R>(x, off, gy, calls, s, one, table);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int j = q + p * (W / 2);
      if (out != nullptr) out[j] = x[p];
      if (gout != nullptr) gout[j] = x[p];
    }
  }
}

// Old-white row k of a band starting at row a is plane row a - 2 + k; old
// (and new) black row i is plane row a - 1 + i. Step s (0 <= s <= n + 1)
// reads white rows s, s + 1, s + 2 and black row s, and computes new black
// row s and, from s = 2, new white row s - 2 (plane row a + s - 2). A row
// of either color looks to the side its plane row's parity gives. White row
// k is black row k - 1's `same`, so its pads are written at step k - 2,
// once it has landed; new black row i is white row i - 1's `same`, so its
// pads are written at step i, after the barrier that ends its update.
template <int FAMILY, int R, int ACCEPT, bool ASYNC>
__global__ void __launch_bounds__(THREADS) packed_fused_kernel(const FusedArgs p) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ uint32_t table[TABLE_WORDS];
  constexpr int NW = WHITE_ROWS<ASYNC>;
  const int H = p.H, W = p.W, stride = W + 2 * PAD;
  const int a = blockIdx.x * p.band;
  const int n = min(p.band, H - a);
  if (threadIdx.x == 0) fill_table<ACCEPT>(table, p.thr);
  uint32_t* const wring = smem + PAD;
  uint32_t* const nb = wring + NW * stride;
  uint32_t* const ob = nb + NEW_BLACK_ROWS * stride;
  const auto wslot = [&](int k) { return wring + (k % NW) * stride; };
  const auto nbslot = [&](int i) { return nb + (i % NEW_BLACK_ROWS) * stride; };
  const auto white_row = [&](int k) {
    return p.white + static_cast<int64_t>(wrap_row(a - 2 + k, H)) * W;
  };
  const auto black_row = [&](int i) {
    return p.black + static_cast<int64_t>(wrap_row(a - 1 + i, H)) * W;
  };
  // cp.async group g carries old-white row g + 2 and old-black row g
  const auto prefetch = [&](int g) {
    if (g <= n + 1) {
      copy_row<true>(wslot(g + 2), white_row(g + 2), W, p.vec16);
      copy_row<true>(ob + (g % OLD_BLACK_ROWS) * stride, black_row(g), W, p.vec16);
    }
    cp_async_commit();
  };

  // white rows 0 and 1 by plain loads; row 1 (black row 0's `same`) with
  // its pads, from device memory
  copy_row<false>(wslot(0), white_row(0), W, p.vec16);
  copy_row<false>(wslot(1), white_row(1), W, p.vec16);
  if (threadIdx.x == PAD_THREAD) {
    const uint32_t* row = white_row(1);
    wslot(1)[-1] = rotl(row[W - 1], 4);
    wslot(1)[W] = rotl(row[0], 28);
  }
  if constexpr (ASYNC) {
#pragma unroll
    for (int g = 0; g < STAGES; ++g) prefetch(g);
  }
  for (int s = 0; s <= n + 1; ++s) {
    if constexpr (ASYNC) {
      cp_async_wait<STAGES - 1>();  // group s has landed
      __syncthreads();              // ... for every thread; step s - 1 is done
      prefetch(s + STAGES);         // into the slots step s - 1 freed
    } else {
      copy_row<false>(wslot(s + 2), white_row(s + 2), W, p.vec16);
      __syncthreads();
    }
    if (threadIdx.x == PAD_THREAD) write_pads(wslot(s + 2), W);
    {  // new black row s: a band row (1 <= s <= n) or a recomputed halo row
      const int y = wrap_row(a - 1 + s, H);
      const uint32_t* same = wslot(s + 1);
      update_row<FAMILY, R, ACCEPT>(
          ASYNC ? ob + (s % OLD_BLACK_ROWS) * stride : black_row(s), wslot(s), same,
          wslot(s + 2), same + (looks_right(0, y) ? 1 : -1), nbslot(s),
          s >= 1 && s <= n ? p.black_out + static_cast<int64_t>(y) * W : nullptr,
          p.row0 + static_cast<uint32_t>(y), W, p.sb, p.one, table);
    }
    __syncthreads();
    if (threadIdx.x == PAD_THREAD) write_pads(nbslot(s), W);
    if (s >= 2) {  // new white row t = s - 2, against new black t .. t + 2
      const int t = s - 2;
      const uint32_t* same = nbslot(t + 1);
      update_row<FAMILY, R, ACCEPT>(
          wslot(s), nbslot(t), same, nbslot(t + 2),
          same + (looks_right(1, a + t) ? 1 : -1), nullptr,
          p.white_out + static_cast<int64_t>(a + t) * W,
          p.row0 + static_cast<uint32_t>(a + t), W, p.sw, p.one, table);
    }
  }
}

// Resolve p's band height (0: one wave of CTAs over the SMs, from the
// kernel's occupancy) and, where `run`, launch one step with the dynamic
// shared memory it needs (above 48 KiB after raising the kernel's limit).
// Returns a CUDA error code.
template <int FAMILY, int R, int ACCEPT, bool ASYNC>
int launch(FusedArgs* p, cudaStream_t stream, bool run) {
  const auto kernel = packed_fused_kernel<FAMILY, R, ACCEPT, ASYNC>;
  const size_t smem =
      static_cast<size_t>(SMEM_ROWS<ASYNC>) * (p->W + 2 * PAD) * sizeof(uint32_t);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (p->band == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                             smem)) != cudaSuccess) {
      return static_cast<int>(err);
    }
    const int ctas = sms * per_sm > 0 ? sms * per_sm : 1;
    p->band = (p->H + ctas - 1) / ctas;
  }
  if (!run) return 0;
  const dim3 grid((p->H + p->band - 1) / p->band);
  kernel<<<grid, THREADS, smem, stream>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

using Launch = int (*)(FusedArgs*, cudaStream_t, bool);

template <int FAMILY, int R, bool ASYNC>
Launch with_accept(int accept) {
  if (accept == ACCEPT_METROPOLIS) return launch<FAMILY, R, ACCEPT_METROPOLIS, ASYNC>;
  if (accept == ACCEPT_GREEDY) return launch<FAMILY, R, ACCEPT_GREEDY, ASYNC>;
  if (accept == ACCEPT_FIELD) return launch<FAMILY, R, ACCEPT_FIELD, ASYNC>;
  return nullptr;
}

// The (family, rounds) pairs of the u32 rng modes (ising_tpu/rng.py:99-113).
template <bool ASYNC>
Launch find_launch(int family, int rounds, int accept) {
  if (family == FAMILY_PHILOX && rounds == 10) return with_accept<FAMILY_PHILOX, 10, ASYNC>(accept);
  if (family == FAMILY_PHILOX && rounds == 7) return with_accept<FAMILY_PHILOX, 7, ASYNC>(accept);
  if (family == FAMILY_THREEFRY && rounds == 20) return with_accept<FAMILY_THREEFRY, 20, ASYNC>(accept);
  if (family == FAMILY_THREEFRY && rounds == 13) return with_accept<FAMILY_THREEFRY, 13, ASYNC>(accept);
  if (family == FAMILY_CHACHA && rounds == 8) return with_accept<FAMILY_CHACHA, 8, ASYNC>(accept);
  if (family == FAMILY_CHACHA && rounds == 6) return with_accept<FAMILY_CHACHA, 6, ASYNC>(accept);
  if (family == FAMILY_CHACHA && rounds == 4) return with_accept<FAMILY_CHACHA, 4, ASYNC>(accept);
  return nullptr;
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

template <bool ASYNC>
int fused_step(const void* black, const void* white, void* black_out,
               void* white_out, int H, int W, uint32_t row0, uint32_t step,
               const uint32_t* thr10, uint32_t tag_b, uint32_t kb0, uint32_t kb1,
               uint32_t tag_w, uint32_t kw0, uint32_t kw1, int family, int rounds,
               int accept, int band, void* stream) {
  const Launch fn = find_launch<ASYNC>(family, rounds, accept);
  const int pair = family == FAMILY_CHACHA ? 2 : 1;
  if (fn == nullptr || thr10 == nullptr || black == nullptr || white == nullptr ||
      black_out == nullptr || white_out == nullptr || H <= 0 || W <= 0 ||
      W % pair || band < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FusedArgs p;
  p.black = static_cast<const uint32_t*>(black);
  p.white = static_cast<const uint32_t*>(white);
  p.black_out = static_cast<uint32_t*>(black_out);
  p.white_out = static_cast<uint32_t*>(white_out);
  p.H = H;
  p.W = W;
  p.band = band;
  p.row0 = row0;
  p.sb = Stream{step, tag_b, kb0, kb1};
  p.sw = Stream{step, tag_w, kw0, kw1};
  for (int i = 0; i < 10; ++i) p.thr.t[i] = thr10[i];
  p.one = 1u;
  p.vec16 = W % 4 == 0 && aligned16(black) && aligned16(white);
  return fn(&p, static_cast<cudaStream_t>(stream), true);
}

}  // namespace

// One step of both colors on `stream`, out of place: black_out and
// white_out (H, W) must not overlap black or white. tag_b / tag_w and
// (kb0, kb1) / (kw0, kw1): each color's tag and key (ops/bit1.py:launch_args;
// family 0 = Philox and 2 = ChaCha take seed lo, hi, 1 = Threefry its stream
// key); accept: 0 = T > 0, 1 = the greedy quench, 2 = the full table; thr10:
// the host's (10,) u32 threshold table; band: rows a CTA owns, 0 for one wave
// of CTAs. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a (family, rounds, accept) that is not
// instantiated here or a shape the kernel does not take (ChaCha needs an
// even W). packed_fused_step_launch loads rows into shared memory with plain
// loads, packed_fused_step_manual_launch with cp.async, STAGES rows ahead.
extern "C" int packed_fused_step_launch(
    const void* black, const void* white, void* black_out, void* white_out, int H,
    int W, uint32_t row0, uint32_t step, const uint32_t* thr10, uint32_t tag_b,
    uint32_t kb0, uint32_t kb1, uint32_t tag_w, uint32_t kw0, uint32_t kw1,
    int family, int rounds, int accept, int band, void* stream) {
  return fused_step<false>(black, white, black_out, white_out, H, W, row0, step,
                           thr10, tag_b, kb0, kb1, tag_w, kw0, kw1, family,
                           rounds, accept, band, stream);
}

extern "C" int packed_fused_step_manual_launch(
    const void* black, const void* white, void* black_out, void* white_out, int H,
    int W, uint32_t row0, uint32_t step, const uint32_t* thr10, uint32_t tag_b,
    uint32_t kb0, uint32_t kb1, uint32_t tag_w, uint32_t kw0, uint32_t kw1,
    int family, int rounds, int accept, int band, void* stream) {
  return fused_step<true>(black, white, black_out, white_out, H, W, row0, step,
                          thr10, tag_b, kb0, kb1, tag_w, kw0, kw1, family,
                          rounds, accept, band, stream);
}

// The band height a launch with band = 0 takes for an (H, W) plane in this
// (family, rounds, accept) on the current device (manual: the cp.async
// kernel), into *band. Returns a CUDA error code.
extern "C" int packed_fused_step_band(int H, int W, int family, int rounds,
                                      int accept, int manual, int* band) {
  const Launch fn = manual ? find_launch<true>(family, rounds, accept)
                           : find_launch<false>(family, rounds, accept);
  if (fn == nullptr || band == nullptr || H <= 0 || W <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FusedArgs p{};
  p.H = H;
  p.W = W;
  const int err = fn(&p, nullptr, false);
  *band = p.band;
  return err;
}
