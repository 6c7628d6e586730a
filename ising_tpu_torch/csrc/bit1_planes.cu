// One checkerboard color half-sweep of the 1-bit (bit1) Ising lattice, for
// Hopper (sm_90a), in the bit-plane rng modes ("...b" and hw). Replaces the
// bit-plane path of the TPU kernel ising_tpu/ops/pallas_bit1.py:_bit1_kernel
// (:369-424) with its helpers ising_tpu/ops/pallas_packed.py:_draw_plane_list
// (the k random bit-plane words of a draw block), :_hw_draw_block (here the
// salted Philox-10 stream the JAX package substitutes off the TPU) and
// pallas_bit1.py:_bitserial_lt_planes / _bitserial_field_flip (the
// bit-serial accept).
//
// Layout and walk: bit1_common.cuh, as in bit1_sweep.cu. For each row a
// thread draws KBITS plane words instead of 32 u32 draws: plane z holds
// random bit z of its 32 spins, and a spin flips where its assembled
// KBITS-bit uniform v is below its class's threshold t. The compare runs
// over the planes LSB-first as one bitwise recurrence per threshold,
// a' = t_z ? (~u | a) : (~u & a), with no per-spin compare. Plane z is lanes
// [z*W1, (z+1)*W1) of the mode's (H, KBITS*W1) draw block under the ordinary
// counter layout, so with P generator calls per word (P = KBITS/4 for
// Philox, KBITS/2 for Threefry, KBITS/16 for ChaCha) call k sits at counter
// q = gy*(P*W1) + k*W1 + j, and its output word o is plane o*P + k. All
// KBITS planes stay in registers.
//
// The thresholds are launch arguments (an AcceptTable by value, in the
// constant bank), so one build serves every temperature and field. The host
// (ops/bit1.py:accept_table) lays each threshold bit out as a whole word
// T_z, all ones or all zeros, so that a plane's step of the recurrence is
// the majority of (T_z, ~u, a): one three-input logic op (LOP3) with T_z read
// from the constant bank, for t4k and t8k and for each class of the
// external field that draws.
//
// What bounds it: 3 words of lattice traffic per word, as in bit1_sweep.cu,
// against one ChaCha block, 4 Philox-7 or 8 Threefry-13 calls per word (16
// planes), or 6 Philox-10 calls (hw, 24 planes), plus one logic op per plane
// and threshold, or with a field one per plane for each class that draws:
// 167-431 integer operations per word, so the integer pipes bound it
// (chip_smoke.py:ops_per_word). With one thread a word and no loop, the
// SASS spends 156-169 static ALU instructions a word on its index, loads and
// edge selects and 96-144 on the accept (three a plane and threshold: two
// logic ops and a select on the threshold's bit), of 356 (philox7b) to 580
// (threefry13b) ALU a word; the walk takes the first to a few a word, the
// T_z words the second to one a plane and threshold, and Threefry's round
// adds run on the FMA pipe (threefry_fma). With the field the five chains
// of the classes that draw stay: a single per-spin chain would have to
// build each plane's T_z from the class masks, five logic ops a plane
// before its own step, where the five chains take five. Measured on an
// H100 (the main loop's SASS, a word): chacha6b 242.5 ALU / 87.5 FMA,
// chacha4b 178.5 / 57.5, chacha8b 304.5 / 120, threefry13b 284 / 171, at
// 81-86% of their ALU-pipe time; philox7b 109.5 / 78.5 and hw 191 / 148, at
// about half of it: their wide multiplies set their time (chip_smoke.py
// phase 6; PERF.md).

#include <cstring>

#include "bit1_common.cuh"

namespace {

using namespace ising;

constexpr int ACCEPT_METROPOLIS = 0;
constexpr int ACCEPT_GREEDY = 1;
constexpr int ACCEPT_FIELD = 2;
constexpr int NCLASS = 10;
constexpr int MAX_KBITS = 24;

// Metropolis / greedy: lt[0][z] / lt[1][z] is all ones when bit z of t4k /
// t8k is set. Field (models/ising.py:field_kbit_thresholds): bit c of
// `draws` is set when class c flips on a draw (not always, threshold > 0);
// always[c] is all ones when class c always flips; bits[c][z] is all ones
// when bit z of class c's threshold is set. Read at constant indices only: a
// runtime index would move the struct into local memory.
struct AcceptTable {
  uint32_t lt[2][MAX_KBITS];
  uint32_t draws;
  uint32_t always[NCLASS];
  uint32_t bits[NCLASS][MAX_KBITS];
};
constexpr int TABLE_WORDS = sizeof(AcceptTable) / sizeof(uint32_t);
static_assert(TABLE_WORDS == 2 * MAX_KBITS + 1 + NCLASS + NCLASS * MAX_KBITS,
              "packed table");

// One color phase's counter stream: the step, the tag (TAG_SWEEP | color,
// salted for hw), the key (seed lo, hi; Threefry: its stream key) and `one`
// (1, a kernel argument: adds on the FMA pipe).
struct Stream {
  uint32_t step, tag, k0, k1, one;
};

// One step of the strict less-than recurrence over a plane: the majority of
// the threshold's bit word t, the complemented plane ~u and the running a,
// which is t ? (~u | a) : (~u & a) for t all ones or all zeros.
__device__ __forceinline__ uint32_t lt_step(uint32_t t, uint32_t u, uint32_t a) {
  const uint32_t nu = ~u;
  return (t & (nu | a)) | (nu & a);
}

template <int FAMILY, int R, int KBITS>
__device__ __forceinline__ void draw_planes(uint32_t gy, uint32_t w1, uint32_t j,
                                            const Stream& st, uint32_t (&pl)[KBITS]) {
  if constexpr (FAMILY == FAMILY_PHILOX) {
    static_assert(KBITS % 4 == 0, "philox planes come in fours");
    constexpr int P = KBITS / 4;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const uint64_t q = counter(gy, P * w1, k * w1 + j);
      const uint4 o = philox<R>(static_cast<uint32_t>(q),
                                static_cast<uint32_t>(q >> 32), st.step, st.tag,
                                st.k0, st.k1);
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
      const uint2 o = threefry_fma<R>(static_cast<uint32_t>(q),
                                      static_cast<uint32_t>(q >> 32), st.k0, st.k1,
                                      st.one);
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
                st.step, st.tag, st.k0, st.k1, o);
#pragma unroll
      for (int w = 0; w < 16; ++w) pl[w * P + k] = o[w];
    }
  }
}

// The flip word of row gy's word j from its neighbours.
template <int FAMILY, int R, int KBITS, int ACCEPT>
__device__ __forceinline__ uint32_t flip_word(uint32_t gy, uint32_t w1, uint32_t j,
                                              const Nbrs& n, const Stream& st,
                                              const AcceptTable& tab) {
  uint32_t pl[KBITS];
  draw_planes<FAMILY, R, KBITS>(gy, w1, j, st, pl);
  if constexpr (ACCEPT == ACCEPT_FIELD) {
    // 10-class accept (pallas_bit1.py:_bitserial_field_flip): class b*5 + n
    // by own bit b and neighbour count n. Always-classes flip outright; each
    // class that draws runs its own strict less-than chain over the planes,
    // which is the per-spin-threshold chain of the JAX helper restricted to
    // one class. Whether a class draws is the same for every thread of the
    // launch, so its chain is skipped by a uniform branch. At most five
    // classes draw: for each count n, only one of the two own bits raises
    // the energy.
    static_assert(KBITS <= MAX_KBITS, "table holds MAX_KBITS planes");
    const Count c3 = neighbour_count(n);
    const uint32_t n_eq[5] = {~(c3.n2 | c3.n1 | c3.n0), ~(c3.n2 | c3.n1) & c3.n0,
                              ~(c3.n2 | c3.n0) & c3.n1, c3.n1 & c3.n0, c3.n2};
    uint32_t flip = 0;
#pragma unroll
    for (int c = 0; c < NCLASS; ++c) {
      const uint32_t cls = (c >= 5 ? n.me : ~n.me) & n_eq[c % 5];
      flip |= cls & tab.always[c];
      if ((tab.draws >> c) & 1u) {
        uint32_t a = 0;
#pragma unroll
        for (int z = 0; z < KBITS; ++z) a = lt_step(tab.bits[c][z], pl[z], a);
        flip |= cls & a;
      }
    }
    return flip;
  } else {
    // Two-threshold accept (pallas_bit1.py:_bitserial_lt_planes): v < t4k
    // and v < t8k, LSB-first; plane 0 is the greedy e == 2 coin.
    uint32_t a4 = 0, a8 = 0;
#pragma unroll
    for (int z = 0; z < KBITS; ++z) {
      a4 = lt_step(tab.lt[0][z], pl[z], a4);
      a8 = lt_step(tab.lt[1][z], pl[z], a8);
    }
    return flip_mask<ACCEPT == ACCEPT_GREEDY>(neighbour_classes(n), pl[0], a4, a8);
  }
}

template <int FAMILY, int R, int KBITS, int ACCEPT, int LINKS, bool YSL>
__global__ void
__launch_bounds__(THREADS, min_blocks<FAMILY, R, LINKS, ACCEPT == ACCEPT_METROPOLIS>())
bit1_planes_kernel(const Sweep a, const Stream st, const AcceptTable tab) {
  const int j = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x);
  const uint32_t w1 = static_cast<uint32_t>(a.W1), uj = static_cast<uint32_t>(j);
  walk<LINKS, YSL>(a, j, [&](uint32_t gy, const Nbrs& n) {
    return flip_word<FAMILY, R, KBITS, ACCEPT>(gy, w1, uj, n, st, tab);
  });
}

template <int FAMILY, int R, int KBITS, int ACCEPT, int LINKS, bool YSL>
void launch(dim3 grid, dim3 block, cudaStream_t stream, const Sweep& a,
            const Stream& st, const AcceptTable& tab) {
  bit1_planes_kernel<FAMILY, R, KBITS, ACCEPT, LINKS, YSL><<<grid, block, 0, stream>>>(
      a, st, tab);
}

using Launch = void (*)(dim3, dim3, cudaStream_t, const Sweep&, const Stream&,
                        const AcceptTable&);

// The kernel of the geometry's link mode and replica rows.
template <int FAMILY, int R, int KBITS, int ACCEPT>
Launch with_path(int links, bool ysl) {
  if (ysl) {
    return links == LINKS_JPLANES ? launch<FAMILY, R, KBITS, ACCEPT, LINKS_JPLANES, true>
                                  : launch<FAMILY, R, KBITS, ACCEPT, LINKS_NONE, true>;
  }
  return links == LINKS_JPLANES ? launch<FAMILY, R, KBITS, ACCEPT, LINKS_JPLANES, false>
       : links == LINKS_SPLIT   ? launch<FAMILY, R, KBITS, ACCEPT, LINKS_SPLIT, false>
                                : launch<FAMILY, R, KBITS, ACCEPT, LINKS_NONE, false>;
}

// ... and of the accept: 0 Metropolis, 1 greedy, 2 external field.
template <int FAMILY, int R, int KBITS>
Launch with_accept(int accept, int links, bool ysl) {
  if (accept == ACCEPT_METROPOLIS)
    return with_path<FAMILY, R, KBITS, ACCEPT_METROPOLIS>(links, ysl);
  if (accept == ACCEPT_GREEDY) return with_path<FAMILY, R, KBITS, ACCEPT_GREEDY>(links, ysl);
  if (accept == ACCEPT_FIELD) return with_path<FAMILY, R, KBITS, ACCEPT_FIELD>(links, ysl);
  return nullptr;
}

// The (family, rounds, kbits) triples of the bit-plane modes: philox7b,
// threefry13b, chacha8b/6b/4b (k = 16) and hw (Philox-10, k = 24).
Launch find_launch(int family, int rounds, int kbits, int accept, int links, bool ysl) {
  if (kbits == 16) {
    if (family == FAMILY_PHILOX && rounds == 7)
      return with_accept<FAMILY_PHILOX, 7, 16>(accept, links, ysl);
    if (family == FAMILY_THREEFRY && rounds == 13)
      return with_accept<FAMILY_THREEFRY, 13, 16>(accept, links, ysl);
    if (family == FAMILY_CHACHA && rounds == 8)
      return with_accept<FAMILY_CHACHA, 8, 16>(accept, links, ysl);
    if (family == FAMILY_CHACHA && rounds == 6)
      return with_accept<FAMILY_CHACHA, 6, 16>(accept, links, ysl);
    if (family == FAMILY_CHACHA && rounds == 4)
      return with_accept<FAMILY_CHACHA, 4, 16>(accept, links, ysl);
  }
  if (kbits == 24 && family == FAMILY_PHILOX && rounds == 10) {
    return with_accept<FAMILY_PHILOX, 10, 24>(accept, links, ysl);
  }
  return nullptr;
}

}  // namespace

// Launch one bit-plane half-sweep on `stream`. family and (k0, k1) as for
// bit1_sweep_launch (hw passes Philox-10 with tag | 0x8000); accept: 0
// Metropolis, 1 greedy, 2 external field; table: TABLE_WORDS (299) host
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
  Sweep a{static_cast<uint32_t*>(dst), static_cast<const uint32_t*>(src),
          static_cast<const uint32_t*>(src_up), static_cast<const uint32_t*>(src_dn),
          Geometry{}, H, W1, 0, color, row0};
  dim3 grid, block;
  if (table == nullptr || !walk_grid(a, grid, block) ||
      !make_geometry(l0, l1, l2, l3, link_mode, csl, ysl, H, W1, a.geo)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Launch fn = find_launch(family, rounds, kbits, accept, link_mode, ysl != 0);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  AcceptTable tab;
  std::memcpy(&tab, table, sizeof(tab));
  fn(grid, block, static_cast<cudaStream_t>(stream), a, Stream{step, tag, k0, k1, 1u},
     tab);
  return static_cast<int>(cudaGetLastError());
}
