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
// One thread per word (per pair in ChaCha), no shared memory: a thread reads
// its own dst word(s) and the src words around them and writes dst in place.
// No thread reads another thread's dst word, so the in-place update is
// race-free (the wrapper refuses dst/src overlap). Neighbouring threads take
// neighbouring words, so every load and the store coalesce.
//
// What bounds it: per color phase the lattice moves 3 words per 8 spins
// (read dst, read src, write dst; 4 with the J word), 0.060 ms at 16384^2
// (0.080 ms with the J word), against 2 Philox, 4 Threefry or half a ChaCha
// call per word plus about 60 operations of neighbours, classes and accept:
// 142 (Philox-10) to 236 (Threefry-13) integer operations per word, 0.071 to
// 0.118 ms (chip_smoke.py:packed_ops_per_word). Both terms are close, and in
// philox7 and with the J word in philox the bytes bind. So the design keeps
// one pass over each word, every operand in registers and the generators
// fully unrolled for their round count (a template parameter).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a (ops/kernel_lib.py). The
// C entry point returns cudaGetLastError() after the launch.

#include "packed_word.cuh"

namespace {

using namespace ising;

// Where a word's neighbours come from, the same for every thread of a
// launch: jword, the J word of quenched disorder (nullptr for none; the flags
// of field z in its bits 4z..4z+3: up, dn, same, off); csl > 0 replicas csl
// words wide (csl divides W), ysl > 0 replicas ysl rows tall (ysl divides H);
// 0 is the periodic wrap.
struct PackedGeometry {
  const uint32_t* jword;
  int csl, ysl;
};

// The word (y, j) and the src words around it (pallas_packed.py:202-235,
// :413-441): the periodic off-column word is packed_word.cuh's off_word.
// Replicas: at lane j % csl == 0 the left neighbour is lane j + csl - 1, at
// j % csl == csl - 1 the right one lane j - csl + 1 (no rotation: csl
// divides W, so the wrap stays inside the field group); row y % ysl == 0
// takes row y + ysl - 1 as up, row y % ysl == ysl - 1 row y - ysl + 1 as
// down, and src_up / src_dn are not read. The J word's flags are XORed into
// the four neighbours.
__device__ __forceinline__ Word load_word(const uint32_t* __restrict__ dst,
                                          const uint32_t* __restrict__ src,
                                          const uint32_t* __restrict__ src_up,
                                          const uint32_t* __restrict__ src_dn,
                                          int H, int W, int color,
                                          const PackedGeometry& g, int y, int j) {
  Word w;
  const int64_t w64 = W;
  const uint32_t* row = src + y * w64;
  const int64_t idx = y * w64 + j;
  w.me = dst[idx];
  w.same = row[j];
  const bool right = looks_right(color, y);
  if (g.ysl) {
    const int r = y % g.ysl;
    w.up = row[r == 0 ? (g.ysl - 1) * w64 + j : j - w64];
    w.dn = row[r == g.ysl - 1 ? j - (g.ysl - 1) * w64 : j + w64];
  } else {
    w.up = y == 0 ? src_up[j] : row[j - w64];
    w.dn = y == H - 1 ? src_dn[j] : row[j + w64];
  }
  if (g.csl) {
    const int l = j % g.csl;
    w.off = right ? row[l == g.csl - 1 ? j - g.csl + 1 : j + 1]
                  : row[l == 0 ? j + g.csl - 1 : j - 1];
  } else {
    w.off = off_word(row, j, W, right);
  }
  if (g.jword != nullptr) {
    const uint32_t jw = g.jword[idx];
    w.up ^= jw & M1;
    w.dn ^= (jw >> 1) & M1;
    w.same ^= (jw >> 2) & M1;
    w.off ^= (jw >> 3) & M1;
  }
  return w;
}

template <int FAMILY, int R, int ACCEPT>
__global__ void __launch_bounds__(256)
packed_sweep_kernel(uint32_t* __restrict__ dst, const uint32_t* __restrict__ src,
                    const uint32_t* __restrict__ src_up,
                    const uint32_t* __restrict__ src_dn, int H, int W,
                    uint32_t row0, uint32_t step, uint32_t tag, int color,
                    Thresholds thr, uint32_t k0, uint32_t k1, PackedGeometry geo) {
  // ChaCha: one thread per pair of words (q, q + W/2); else one per word.
  constexpr int PAIR = FAMILY == FAMILY_CHACHA ? 2 : 1;
  const int wt = W / PAIR;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<int64_t>(H) * wt) return;
  const int y = static_cast<int>(t / wt);
  const int q = static_cast<int>(t - static_cast<int64_t>(y) * wt);
  const int64_t base = static_cast<int64_t>(y) * W;
  update_words<FAMILY, R, ACCEPT>(
      [&](int j) {
        return load_word(dst, src, src_up, src_dn, H, W, color, geo, y, j);
      },
      [&](int j, uint32_t word) { dst[base + j] = word; },
      row0 + static_cast<uint32_t>(y), W, q, Stream{step, tag, k0, k1}, thr);
}

template <int FAMILY, int R, int ACCEPT>
void launch(dim3 grid, cudaStream_t stream, uint32_t* dst, const uint32_t* src,
            const uint32_t* up, const uint32_t* dn, int H, int W, uint32_t row0,
            uint32_t step, uint32_t tag, int color, const Thresholds& thr,
            uint32_t k0, uint32_t k1, const PackedGeometry& geo) {
  packed_sweep_kernel<FAMILY, R, ACCEPT><<<grid, 256, 0, stream>>>(
      dst, src, up, dn, H, W, row0, step, tag, color, thr, k0, k1, geo);
}

using Launch = void (*)(dim3, cudaStream_t, uint32_t*, const uint32_t*,
                        const uint32_t*, const uint32_t*, int, int, uint32_t,
                        uint32_t, uint32_t, int, const Thresholds&, uint32_t,
                        uint32_t, const PackedGeometry&);

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
// PackedGeometry above (nullptr and 0 for none). Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a (family, rounds, accept)
// that is not instantiated here, a shape the grid cannot cover (ChaCha needs
// an even W) or a replica size that does not divide the plane.
extern "C" int packed_sweep_launch(void* dst, const void* src, const void* src_up,
                                   const void* src_dn, int H, int W,
                                   uint32_t row0, uint32_t step, uint32_t tag,
                                   int color, const uint32_t* thr10, uint32_t k0,
                                   uint32_t k1, int family, int rounds, int accept,
                                   const void* jword, int csl, int ysl,
                                   void* stream) {
  const Launch fn = find_launch(family, rounds, accept);
  const int pair = family == FAMILY_CHACHA ? 2 : 1;
  dim3 grid;
  if (fn == nullptr || thr10 == nullptr || H <= 0 || W <= 0 || W % pair ||
      csl < 0 || ysl < 0 || (csl && W % csl) || (ysl && H % ysl) ||
      !grid_for_threads(static_cast<int64_t>(H) * (W / pair), grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Thresholds thr;
  for (int i = 0; i < 10; ++i) thr.t[i] = thr10[i];
  const PackedGeometry geo{static_cast<const uint32_t*>(jword), csl, ysl};
  fn(grid, static_cast<cudaStream_t>(stream), static_cast<uint32_t*>(dst),
     static_cast<const uint32_t*>(src), static_cast<const uint32_t*>(src_up),
     static_cast<const uint32_t*>(src_dn), H, W, row0, step, tag, color, thr,
     k0, k1, geo);
  return static_cast<int>(cudaGetLastError());
}
