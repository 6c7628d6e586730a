// One checkerboard color half-sweep of the packed Ising lattice (4 bits per
// spin), for Hopper (sm_90a). Replaces the TPU kernel
// ising_tpu/ops/pallas_packed.py:_packed_kernel (:396-450) with
// _metropolis_block (:192-240) and _accept_and_flip (:243-393): the u32-draw
// rng modes (Philox, Threefry, ChaCha, and hw as salted Philox-10), T > 0,
// the greedy T <= 0 quench and the 10-entry external-field table, the J word
// of quenched +-J disorder and the sub-lattice replica wraps.
//
// Layout: a color plane is (H, W) 32-bit words, W = C/8 for C compact
// columns; field z (bits 4z..4z+3) of word (y, j) holds the spin at compact
// column c = z*W + j in its low bit. The four neighbour words are added as
// whole words, so each field sums its count n = 0..4 without a carry; the
// mirrored count e = b ? n : 4 - n classifies all eight fields at once
// (ge_k = e + (8 - k)*0x11111111, bit 3 of each field), and a field flips
// where its u32 draw is at or below its class's threshold (unsigned).
//
// Draws follow rng.color_draws' contract for a C-wide row: the draw of
// column c is output slot c / nq of counter q = c mod nq, counter
// q64 = gy*nq + q. For field z of word j (c = z*W + j):
//   Philox   (nq = 2W): counter j gives fields 0, 2, 4, 6, counter W + j
//            fields 1, 3, 5, 7: two calls per word;
//   Threefry (nq = 4W): counter r*W + j gives fields r and r + 4: four calls;
//   ChaCha   (nq = W/2): the block at q = j mod W/2 gives field z of word j
//            in slot 2z + (j >= W/2), so one block serves words q and
//            q + W/2, and one thread owns that pair of words.
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

#include "counter_rng.cuh"

namespace {

using namespace ising;

constexpr uint32_t M1 = 0x11111111u;  // the spin bit of every field
constexpr uint32_t M8 = 0x88888888u;  // bit 3 of every field

constexpr int ACCEPT_METROPOLIS = 0;
constexpr int ACCEPT_GREEDY = 1;
constexpr int ACCEPT_FIELD = 2;

// The (10,) u32 threshold table thr10[b*5 + n] of models/ising.py, by value.
// Read at constant indices only: a runtime index would move the struct into
// local memory.
struct Thresholds {
  uint32_t t[10];
};

// Where a word's neighbours come from, the same for every thread of a
// launch: jword, the J word of quenched disorder (nullptr for none; the flags
// of field z in its bits 4z..4z+3: up, dn, same, off); csl > 0 replicas csl
// words wide (csl divides W), ysl > 0 replicas ysl rows tall (ysl divides H);
// 0 is the periodic wrap.
struct PackedGeometry {
  const uint32_t* jword;
  int csl, ysl;
};

struct Word {
  int64_t idx;
  uint32_t me, up, dn, same, off;
};

// The word (y, j) and the src words around it (pallas_packed.py:202-235,
// :413-441). The off-column neighbour of column z*W + j is lane j - 1 or
// j + 1 of the same field; at the row's first / last lane it is the last /
// first word with every field moved one group (a 4-bit rotation). A site
// looks right where it sits on an odd full-lattice column: black on odd
// rows, white on even rows. Replicas: at lane j % csl == 0 the left
// neighbour is lane j + csl - 1, at j % csl == csl - 1 the right one lane
// j - csl + 1 (no rotation: csl divides W, so the wrap stays inside the
// field group); row y % ysl == 0 takes row y + ysl - 1 as up, row
// y % ysl == ysl - 1 row y - ysl + 1 as down, and src_up / src_dn are not
// read. The J word's flags are XORed into the four neighbours.
__device__ __forceinline__ Word load_word(const uint32_t* __restrict__ dst,
                                          const uint32_t* __restrict__ src,
                                          const uint32_t* __restrict__ src_up,
                                          const uint32_t* __restrict__ src_dn,
                                          int H, int W, int color,
                                          const PackedGeometry& g, int y, int j) {
  Word w;
  const int64_t w64 = W;
  const uint32_t* row = src + y * w64;
  w.idx = y * w64 + j;
  w.me = dst[w.idx];
  w.same = row[j];
  const bool look_right = (color == 0) == static_cast<bool>(y & 1);
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
    w.off = look_right ? row[l == g.csl - 1 ? j - g.csl + 1 : j + 1]
                       : row[l == 0 ? j + g.csl - 1 : j - 1];
  } else {
    w.off = look_right ? (j == W - 1 ? rotl(row[0], 28) : row[j + 1])
                       : (j == 0 ? rotl(row[W - 1], 4) : row[j - 1]);
  }
  if (g.jword != nullptr) {
    const uint32_t jw = g.jword[w.idx];
    w.up ^= jw & M1;
    w.dn ^= (jw >> 1) & M1;
    w.same ^= (jw >> 2) & M1;
    w.off ^= (jw >> 3) & M1;
  }
  return w;
}

// The accept of one word (pallas_packed.py:_accept_and_flip), fed one draw
// per field, then asked for the flip word. The class words ge_k hold, in
// bit 4z+3, whether field z's mirrored count e is at least k.
//   ACCEPT_METROPOLIS (T > 0): e <= 2 flips; e == 3 on d <= thr[8], e == 4 on
//     d <= thr[9];
//   ACCEPT_GREEDY (T <= 0): e < 2 flips; e == 2 on thr[7], and as above;
//   ACCEPT_FIELD: own bit 1 takes thr[5 + e], own bit 0 thr[4 - e].
template <int ACCEPT>
struct Acceptor {
  uint32_t me, ge1, ge2, ge3, ge4;
  uint32_t p0 = 0, p4 = 0, p8 = 0, flips = 0;

  __device__ __forceinline__ explicit Acceptor(const Word& w) : me(w.me) {
    const uint32_t nsum = w.up + w.dn + w.same + w.off;
    const uint32_t m1 = me & M1;
    const uint32_t mask = (m1 << 4) - m1;
    const uint32_t e = (nsum & mask) | ((0x44444444u - nsum) & ~mask);
    ge1 = (e + 0x77777777u) & M8;
    ge2 = (e + 0x66666666u) & M8;
    ge3 = (e + 0x55555555u) & M8;
    ge4 = (e + 0x44444444u) & M8;
  }

  __device__ __forceinline__ void take(uint32_t d, int z, const Thresholds& thr) {
    const int b = 4 * z;
    if constexpr (ACCEPT == ACCEPT_FIELD) {
      const bool i4 = (ge4 >> (b + 3)) & 1, i3 = (ge3 >> (b + 3)) & 1;
      const bool i2 = (ge2 >> (b + 3)) & 1, i1 = (ge1 >> (b + 3)) & 1;
      const uint32_t t_up = i4 ? thr.t[9] : i3 ? thr.t[8] : i2 ? thr.t[7]
                          : i1 ? thr.t[6] : thr.t[5];
      const uint32_t t_dn = i4 ? thr.t[0] : i3 ? thr.t[1] : i2 ? thr.t[2]
                          : i1 ? thr.t[3] : thr.t[4];
      const uint32_t t = ((me >> b) & 1) ? t_up : t_dn;
      flips |= static_cast<uint32_t>(d <= t) << b;
    } else {
      p4 |= static_cast<uint32_t>(d <= thr.t[8]) << b;
      p8 |= static_cast<uint32_t>(d <= thr.t[9]) << b;
      if constexpr (ACCEPT == ACCEPT_GREEDY) {
        p0 |= static_cast<uint32_t>(d <= thr.t[7]) << b;
      }
    }
  }

  __device__ __forceinline__ uint32_t flip() const {
    if constexpr (ACCEPT == ACCEPT_FIELD) return flips;
    const uint32_t g3 = ge3 >> 3, g4 = ge4 >> 3;
    if constexpr (ACCEPT == ACCEPT_GREEDY) {
      const uint32_t g2 = ge2 >> 3;
      return (M1 & ~g2) |
             (g2 & ((g4 & p8) | (~g4 & g3 & p4) | (~g4 & ~g3 & p0)));
    } else {
      return (M1 & ~g3) | (g3 & ~g4 & p4) | (g4 & p8);
    }
  }
};

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
  const uint32_t gy = row0 + static_cast<uint32_t>(y);
  const uint32_t w = static_cast<uint32_t>(W);
  const Word a = load_word(dst, src, src_up, src_dn, H, W, color, geo, y, q);
  Acceptor<ACCEPT> acc_a(a);
  if constexpr (FAMILY == FAMILY_CHACHA) {
    const Word b = load_word(dst, src, src_up, src_dn, H, W, color, geo, y, q + wt);
    Acceptor<ACCEPT> acc_b(b);
    const uint64_t c = counter(gy, w / 2, static_cast<uint32_t>(q));
    uint32_t o[16];
    chacha<R>(static_cast<uint32_t>(c), static_cast<uint32_t>(c >> 32), step,
              tag, k0, k1, o);
#pragma unroll
    for (int z = 0; z < 8; ++z) {
      acc_a.take(o[2 * z], z, thr);
      acc_b.take(o[2 * z + 1], z, thr);
    }
    dst[b.idx] = b.me ^ acc_b.flip();
  } else if constexpr (FAMILY == FAMILY_PHILOX) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint64_t c = counter(gy, 2u * w, h * w + static_cast<uint32_t>(q));
      const uint4 o = philox<R>(static_cast<uint32_t>(c),
                                static_cast<uint32_t>(c >> 32), step, tag, k0, k1);
      acc_a.take(o.x, h, thr);
      acc_a.take(o.y, 2 + h, thr);
      acc_a.take(o.z, 4 + h, thr);
      acc_a.take(o.w, 6 + h, thr);
    }
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint64_t c = counter(gy, 4u * w, r * w + static_cast<uint32_t>(q));
      const uint2 o = threefry<R>(static_cast<uint32_t>(c),
                                  static_cast<uint32_t>(c >> 32), k0, k1);
      acc_a.take(o.x, r, thr);
      acc_a.take(o.y, r + 4, thr);
    }
  }
  dst[a.idx] = a.me ^ acc_a.flip();
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
