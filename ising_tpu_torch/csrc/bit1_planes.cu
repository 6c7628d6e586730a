// One checkerboard color half-sweep of the 1-bit (bit1) Ising lattice, for
// Hopper (sm_90a), in the bit-plane rng modes ("...b" and hw). Replaces the
// bit-plane path of the TPU kernel ising_tpu/ops/pallas_bit1.py:_bit1_kernel
// (:369-424) with its helpers ising_tpu/ops/pallas_packed.py:_draw_plane_list
// (the k random bit-plane words of a draw block), :_hw_draw_block (here the
// salted Philox-10 stream the JAX package substitutes off the TPU) and
// pallas_bit1.py:_bitserial_lt_planes / _bitserial_field_flip (the
// bit-serial accept).
//
// Each thread owns one word (32 spins), as in bit1_sweep.cu. Instead of 32
// u32 draws it draws KBITS plane words: plane z holds random bit z of its 32
// spins, and a spin flips where its assembled KBITS-bit uniform v is below
// its class's threshold t. The compare runs over the planes LSB-first as
// one bitwise recurrence per threshold, a' = t_z ? (~u | a) : (~u & a), with
// no per-spin compare. Plane z is lanes [z*W1, (z+1)*W1) of the mode's
// (H, KBITS*W1) draw block under the ordinary counter layout, so with P
// generator calls per word (P = KBITS/4 for Philox, KBITS/2 for Threefry,
// KBITS/16 for ChaCha) call k sits at counter q = gy*(P*W1) + k*W1 + j, and
// its output word o is plane o*P + k. All KBITS planes stay in registers.
//
// The thresholds are launch arguments (an AcceptTable by value), so one
// build serves every temperature and field: (t4k, t8k) for the Metropolis
// and greedy accepts, or the 10-class table of the external field, laid out
// on the host (ops/bit1.py:accept_table) as whole words so that each use is
// one logic op with a constant operand.
//
// What bounds it: 3 words of lattice traffic per word, as in bit1_sweep.cu,
// against one ChaCha block, 4 Philox-7 or 8 Threefry-13 calls per word (16
// planes), or 6 Philox-10 calls (hw, 24 planes), plus 2 bitwise operations
// per plane, or with a field one per plane for each class that draws:
// 180-470 integer operations per word, so the integer pipes bound it
// (chip_smoke.py:ops_per_word).

#include <cstring>

#include "bit1_common.cuh"

namespace {

using namespace ising;

constexpr int ACCEPT_METROPOLIS = 0;
constexpr int ACCEPT_GREEDY = 1;
constexpr int ACCEPT_FIELD = 2;
constexpr int NCLASS = 10;
constexpr int MAX_KBITS = 24;

// Metropolis / greedy: t4k, t8k. Field (models/ising.py:field_kbit_thresholds):
// bit c of `draws` is set when class c flips on a draw (not always, threshold
// > 0); always[c] is all ones when class c always flips; bits[c][z] is all
// ones when bit z of class c's threshold is set.
struct AcceptTable {
  uint32_t t4k, t8k;
  uint32_t draws;
  uint32_t always[NCLASS];
  uint32_t bits[NCLASS][MAX_KBITS];
};
constexpr int TABLE_WORDS = sizeof(AcceptTable) / sizeof(uint32_t);
static_assert(TABLE_WORDS == 3 + NCLASS + NCLASS * MAX_KBITS, "packed table");

template <int FAMILY, int R, int KBITS>
__device__ __forceinline__ void draw_planes(uint32_t gy, uint32_t w1, uint32_t j,
                                            uint32_t step, uint32_t tag,
                                            uint32_t k0, uint32_t k1,
                                            uint32_t (&pl)[KBITS]) {
  if constexpr (FAMILY == FAMILY_PHILOX) {
    static_assert(KBITS % 4 == 0, "philox planes come in fours");
    constexpr int P = KBITS / 4;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const uint64_t q = counter(gy, P * w1, k * w1 + j);
      const uint4 o = philox<R>(static_cast<uint32_t>(q),
                                static_cast<uint32_t>(q >> 32), step, tag, k0, k1);
      pl[k] = o.x;
      pl[k + P] = o.y;
      pl[k + 2 * P] = o.z;
      pl[k + 3 * P] = o.w;
    }
  } else if constexpr (FAMILY == FAMILY_THREEFRY) {
    static_assert(KBITS % 2 == 0, "threefry planes come in pairs");
    constexpr int P = KBITS / 2;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const uint64_t q = counter(gy, P * w1, k * w1 + j);
      const uint2 o = threefry<R>(static_cast<uint32_t>(q),
                                  static_cast<uint32_t>(q >> 32), k0, k1);
      pl[k] = o.x;
      pl[k + P] = o.y;
    }
  } else {
    static_assert(KBITS % 16 == 0, "chacha planes come in sixteens");
    constexpr int P = KBITS / 16;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const uint64_t q = counter(gy, P * w1, k * w1 + j);
      uint32_t o[16];
      chacha<R>(static_cast<uint32_t>(q), static_cast<uint32_t>(q >> 32),
                step, tag, k0, k1, o);
#pragma unroll
      for (int w = 0; w < 16; ++w) pl[w * P + k] = o[w];
    }
  }
}

template <int FAMILY, int R, int KBITS, int ACCEPT>
__global__ void __launch_bounds__(256)
bit1_planes_kernel(uint32_t* __restrict__ dst, const uint32_t* __restrict__ src,
                   const uint32_t* __restrict__ src_up,
                   const uint32_t* __restrict__ src_dn, int H, int W1,
                   uint32_t row0, uint32_t step, uint32_t tag, int color,
                   uint32_t k0, uint32_t k1, AcceptTable tab, Geometry geo) {
  Site s;
  if (!load_site(dst, src, src_up, src_dn, H, W1, color, geo, s)) return;
  uint32_t pl[KBITS];
  draw_planes<FAMILY, R, KBITS>(row0 + static_cast<uint32_t>(s.y),
                                static_cast<uint32_t>(W1),
                                static_cast<uint32_t>(s.j), step, tag, k0, k1, pl);
  uint32_t flip;
  if constexpr (ACCEPT == ACCEPT_FIELD) {
    // 10-class accept (pallas_bit1.py:_bitserial_field_flip): class b*5 + n
    // by own bit b and neighbour count n. Always-classes flip outright; each
    // class that draws runs its own strict less-than chain over the planes,
    // a' = t_z ? (~u | a) : (~u & a), which is the per-spin-threshold chain
    // of the JAX helper restricted to one class. Whether a class draws is
    // the same for every thread of the launch, so its chain is skipped by a
    // uniform branch. At most five classes draw: for each count n, only one
    // of the two own bits raises the energy.
    static_assert(KBITS <= MAX_KBITS, "table holds MAX_KBITS planes");
    const Count n = neighbour_count(s);
    const uint32_t n_eq[5] = {~(n.n2 | n.n1 | n.n0), ~(n.n2 | n.n1) & n.n0,
                              ~(n.n2 | n.n0) & n.n1, n.n1 & n.n0, n.n2};
    flip = 0;
#pragma unroll
    for (int c = 0; c < NCLASS; ++c) {
      const uint32_t cls = (c >= 5 ? s.me : ~s.me) & n_eq[c % 5];
      flip |= cls & tab.always[c];
      if ((tab.draws >> c) & 1u) {
        uint32_t a = 0;
#pragma unroll
        for (int z = 0; z < KBITS; ++z) {
          const uint32_t nu = ~pl[z], t = tab.bits[c][z];
          a = (t & (nu | a)) | (nu & a);
        }
        flip |= cls & a;
      }
    }
  } else {
    // Two-threshold accept (pallas_bit1.py:_bitserial_lt_planes): v < t4k
    // and v < t8k, LSB-first; plane 0 is the greedy e == 2 coin.
    const uint32_t t4k = tab.t4k, t8k = tab.t8k;
    uint32_t a4 = 0, a8 = 0;
#pragma unroll
    for (int z = 0; z < KBITS; ++z) {
      const uint32_t nu = ~pl[z];
      a4 = ((t4k >> z) & 1u) ? (nu | a4) : (nu & a4);
      a8 = ((t8k >> z) & 1u) ? (nu | a8) : (nu & a8);
    }
    flip = flip_mask<ACCEPT == ACCEPT_GREEDY>(neighbour_classes(s), pl[0], a4, a8);
  }
  dst[s.idx] = s.me ^ flip;
}

template <int FAMILY, int R, int KBITS>
void launch(int accept, dim3 grid, cudaStream_t stream, uint32_t* dst,
            const uint32_t* src, const uint32_t* up, const uint32_t* dn, int H,
            int W1, uint32_t row0, uint32_t step, uint32_t tag, int color,
            uint32_t k0, uint32_t k1, const AcceptTable& tab,
            const Geometry& geo) {
  if (accept == ACCEPT_FIELD) {
    bit1_planes_kernel<FAMILY, R, KBITS, ACCEPT_FIELD><<<grid, 256, 0, stream>>>(
        dst, src, up, dn, H, W1, row0, step, tag, color, k0, k1, tab, geo);
  } else if (accept == ACCEPT_GREEDY) {
    bit1_planes_kernel<FAMILY, R, KBITS, ACCEPT_GREEDY><<<grid, 256, 0, stream>>>(
        dst, src, up, dn, H, W1, row0, step, tag, color, k0, k1, tab, geo);
  } else {
    bit1_planes_kernel<FAMILY, R, KBITS, ACCEPT_METROPOLIS><<<grid, 256, 0, stream>>>(
        dst, src, up, dn, H, W1, row0, step, tag, color, k0, k1, tab, geo);
  }
}

using Launch = void (*)(int, dim3, cudaStream_t, uint32_t*, const uint32_t*,
                        const uint32_t*, const uint32_t*, int, int, uint32_t,
                        uint32_t, uint32_t, int, uint32_t, uint32_t,
                        const AcceptTable&, const Geometry&);

// The (family, rounds, kbits) triples of the bit-plane modes: philox7b,
// threefry13b, chacha8b/6b/4b (k = 16) and hw (Philox-10, k = 24).
Launch find_launch(int family, int rounds, int kbits) {
  if (kbits == 16) {
    if (family == FAMILY_PHILOX && rounds == 7) return launch<FAMILY_PHILOX, 7, 16>;
    if (family == FAMILY_THREEFRY && rounds == 13) return launch<FAMILY_THREEFRY, 13, 16>;
    if (family == FAMILY_CHACHA && rounds == 8) return launch<FAMILY_CHACHA, 8, 16>;
    if (family == FAMILY_CHACHA && rounds == 6) return launch<FAMILY_CHACHA, 6, 16>;
    if (family == FAMILY_CHACHA && rounds == 4) return launch<FAMILY_CHACHA, 4, 16>;
  }
  if (kbits == 24 && family == FAMILY_PHILOX && rounds == 10) {
    return launch<FAMILY_PHILOX, 10, 24>;
  }
  return nullptr;
}

}  // namespace

// Launch one bit-plane half-sweep on `stream`. family and (k0, k1) as for
// bit1_sweep_launch (hw passes Philox-10 with tag | 0x8000); accept: 0
// Metropolis, 1 greedy, 2 external field; table: TABLE_WORDS (253) host
// words, laid out as AcceptTable. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a (family, rounds, kbits, accept) that is not
// instantiated here, a shape the grid cannot cover or a geometry the kernel
// does not take. l0..l3, link_mode, csl, ysl as for bit1_sweep_launch.
extern "C" int bit1_planes_launch(void* dst, const void* src, const void* src_up,
                                  const void* src_dn, int H, int W1,
                                  uint32_t row0, uint32_t step, uint32_t tag,
                                  int color, uint32_t k0, uint32_t k1,
                                  int family, int rounds, int kbits, int accept,
                                  const uint32_t* table, const void* l0,
                                  const void* l1, const void* l2, const void* l3,
                                  int link_mode, int csl, int ysl, void* stream) {
  dim3 grid;
  Geometry geo;
  const Launch fn = find_launch(family, rounds, kbits);
  if (fn == nullptr || accept < 0 || accept > ACCEPT_FIELD || table == nullptr ||
      !grid_for(H, W1, grid) ||
      !make_geometry(l0, l1, l2, l3, link_mode, csl, ysl, H, W1, geo)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  AcceptTable tab;
  std::memcpy(&tab, table, sizeof(tab));
  fn(accept, grid, static_cast<cudaStream_t>(stream), static_cast<uint32_t*>(dst),
     static_cast<const uint32_t*>(src), static_cast<const uint32_t*>(src_up),
     static_cast<const uint32_t*>(src_dn), H, W1, row0, step, tag, color, k0, k1,
     tab, geo);
  return static_cast<int>(cudaGetLastError());
}
