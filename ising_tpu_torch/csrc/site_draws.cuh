// Per-site draws and accepts shared by the uint8-plane sweeps (dense_sweep.cu,
// mxu_sweep.cu): one u32 draw per site in the layout of
// ising_tpu/ops/pallas_dense.py (_philox_draws, _threefry_draws,
// _chacha_draws: :75-131) over the generators of counter_rng.cuh, the
// 10-entry threshold table, and the mirrored three-threshold accept of
// ising_tpu/ops/mxu.py (:123-129).
//
// Draw layout for a C-wide compact row: generator call q (0 <= q < G = C/S)
// at the 64-bit counter gy*G + q gives the draws of the S sites at columns
// q + s*G, s = 0..S-1, in its output slot s: S = 4 for Philox, 2 for Threefry
// (under the per-(step, tag) stream key), 16 for ChaCha. hw is Philox-10
// with the tag salted (tag | 0x8000; the wrapper passes it so).

#pragma once

#include "counter_rng.cuh"

namespace ising {

// The (10,) u32 threshold table thr10[b*5 + n] of models/ising.py, by value.
// Read at constant indices only: a runtime index would move it into local
// memory (a stack frame).
struct Table10 {
  uint32_t t[10];
};

// Sites one generator call of the family serves.
__host__ __device__ constexpr int sites_per_call(int family) {
  return family == FAMILY_PHILOX ? 4 : family == FAMILY_THREEFRY ? 2 : 16;
}

// The draws of call q of global row gy: d[s] is the draw of column q + s*G.
template <int FAMILY, int R>
__device__ __forceinline__ void call_draws(uint32_t gy, uint32_t G, uint32_t q,
                                           uint32_t step, uint32_t tag,
                                           uint32_t k0, uint32_t k1,
                                           uint32_t (&d)[sites_per_call(FAMILY)]) {
  const uint64_t c = counter(gy, G, q);
  const uint32_t lo = static_cast<uint32_t>(c), hi = static_cast<uint32_t>(c >> 32);
  if constexpr (FAMILY == FAMILY_PHILOX) {
    const uint4 o = philox<R>(lo, hi, step, tag, k0, k1);
    d[0] = o.x;
    d[1] = o.y;
    d[2] = o.z;
    d[3] = o.w;
  } else if constexpr (FAMILY == FAMILY_THREEFRY) {
    const uint2 o = threefry<R>(lo, hi, k0, k1);
    d[0] = o.x;
    d[1] = o.y;
  } else {
    chacha<R>(lo, hi, step, tag, k0, k1, d);
  }
}

// The h = 0 accept through the mirrored count e = b ? n : 4 - n: e < 2 always
// flips, e = 2, 3, 4 take thr10[7], [8], [9] (mxu.py:126-129).
__device__ __forceinline__ uint32_t mirrored_threshold(int e, const Table10& thr) {
  return e < 2 ? 0xFFFFFFFFu : e == 2 ? thr.t[7] : e == 3 ? thr.t[8] : thr.t[9];
}

// The (family, rounds) pairs of the u32 rng modes (ising_tpu/rng.py:99-113),
// each as the instantiation L<FAMILY, R>::launch; nullptr for another pair.
template <template <int, int> class L>
auto find_u32_mode(int family, int rounds) -> decltype(&L<FAMILY_PHILOX, 10>::launch) {
  if (family == FAMILY_PHILOX && rounds == 10) return &L<FAMILY_PHILOX, 10>::launch;
  if (family == FAMILY_PHILOX && rounds == 7) return &L<FAMILY_PHILOX, 7>::launch;
  if (family == FAMILY_THREEFRY && rounds == 20) return &L<FAMILY_THREEFRY, 20>::launch;
  if (family == FAMILY_THREEFRY && rounds == 13) return &L<FAMILY_THREEFRY, 13>::launch;
  if (family == FAMILY_CHACHA && rounds == 8) return &L<FAMILY_CHACHA, 8>::launch;
  if (family == FAMILY_CHACHA && rounds == 6) return &L<FAMILY_CHACHA, 6>::launch;
  if (family == FAMILY_CHACHA && rounds == 4) return &L<FAMILY_CHACHA, 4>::launch;
  return nullptr;
}

}  // namespace ising
