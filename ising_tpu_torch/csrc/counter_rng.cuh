// Counter-based generators shared by the sweep kernels (bit1_sweep.cu,
// bit1_planes.cu, packed_sweep.cu, packed_fused.cu, dense_sweep.cu,
// mxu_sweep.cu): Philox4x32, Threefry2x32 and ChaCha of ising_tpu/rng.py, as
// ising_tpu/ops/pallas_packed.py draws them (_draw_counters,
// _philox_draw_block, _threefry_draw_block, _chacha_draw_block), the 64-bit
// spatial counter, and helpers that steer instructions between the ALU and
// FMA pipes (fma_add, flip_if_le, add_if_gt).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ising {

constexpr uint32_t PHILOX_M0 = 0xD2511F53u;
constexpr uint32_t PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u;
constexpr uint32_t PHILOX_W1 = 0xBB67AE85u;

constexpr int FAMILY_PHILOX = 0;
constexpr int FAMILY_THREEFRY = 1;
constexpr int FAMILY_CHACHA = 2;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Philox4x32-R (ising_tpu/rng.py:philox4x32): four draws per counter.
template <int R>
__device__ __forceinline__ uint4 philox(uint32_t c0, uint32_t c1, uint32_t c2,
                                        uint32_t c3, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const uint32_t hi0 = __umulhi(PHILOX_M0, c0), lo0 = PHILOX_M0 * c0;
    const uint32_t hi1 = __umulhi(PHILOX_M1, c2), lo1 = PHILOX_M1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += PHILOX_W0;
    k1 += PHILOX_W1;
  }
  return make_uint4(c0, c1, c2, c3);
}

// Threefry2x32-R with Random123's round structure
// (ising_tpu/rng.py:threefry2x32): two draws per counter.
__host__ __device__ constexpr int threefry_rot(int r) {
  return r == 0 ? 13 : r == 1 ? 15 : r == 2 ? 26 : r == 3 ? 6
       : r == 4 ? 17 : r == 5 ? 29 : r == 6 ? 16 : 24;
}

template <int R>
__device__ __forceinline__ uint2 threefry(uint32_t c0, uint32_t c1,
                                          uint32_t k0, uint32_t k1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  uint32_t x0 = c0 + ks[0];
  uint32_t x1 = c1 + ks[1];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    x0 += x1;
    x1 = rotl(x1, threefry_rot(r % 8)) ^ x0;
    if ((r + 1) % 4 == 0) {
      const int j = (r + 1) / 4;
      x0 += ks[j % 3];
      x1 += ks[(j + 1) % 3] + static_cast<uint32_t>(j);
    }
  }
  return make_uint2(x0, x1);
}

// ChaCha-R (ising_tpu/rng.py:chacha_block): 16 draws per counter. R counts
// single rounds, applied as column/diagonal pairs (R even). State:
//   [ C0 C1 C2 C3 | k0 k1 P0 P1 | P2 P3 P4 P5 | c0 c1 step tag ]
__device__ __forceinline__ void chacha_qr(uint32_t& a, uint32_t& b, uint32_t& c,
                                          uint32_t& d) {
  a += b; d = rotl(d ^ a, 16);
  c += d; b = rotl(b ^ c, 12);
  a += b; d = rotl(d ^ a, 8);
  c += d; b = rotl(b ^ c, 7);
}

template <int R>
__device__ __forceinline__ void chacha(uint32_t c0, uint32_t c1, uint32_t step,
                                       uint32_t tag, uint32_t k0, uint32_t k1,
                                       uint32_t (&out)[16]) {
  static_assert(R % 2 == 0, "chacha rounds must be even");
  const uint32_t init[16] = {
      0x61707865u, 0x3320646Eu, 0x79622D32u, 0x6B206574u, k0, k1,
      0x243F6A88u, 0x85A308D3u, 0x13198A2Eu, 0x03707344u, 0xA4093822u,
      0x299F31D0u, c0, c1, step, tag};
  uint32_t x[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = init[i];
#pragma unroll
  for (int r = 0; r < R / 2; ++r) {
    chacha_qr(x[0], x[4], x[8], x[12]);
    chacha_qr(x[1], x[5], x[9], x[13]);
    chacha_qr(x[2], x[6], x[10], x[14]);
    chacha_qr(x[3], x[7], x[11], x[15]);
    chacha_qr(x[0], x[5], x[10], x[15]);
    chacha_qr(x[1], x[6], x[11], x[12]);
    chacha_qr(x[2], x[7], x[8], x[13]);
    chacha_qr(x[3], x[4], x[9], x[14]);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = x[i] + init[i];
}

// 64-bit spatial counter q = gy * nq + k as (lo, hi): the global row gy wraps
// mod 2^32 like the JAX package's uint32 row index, and the product keeps its
// carry into the high word.
__device__ __forceinline__ uint64_t counter(uint32_t gy, uint32_t nq, uint32_t k) {
  return static_cast<uint64_t>(gy) * nq + k;
}

// a + b on the FMA pipe (IMAD a, one, b), bit for bit the 32-bit sum: `one`
// is a kernel argument (always 1), so the compiler cannot fold it back into
// an ALU add.
__device__ __forceinline__ uint32_t fma_add(uint32_t a, uint32_t b, uint32_t one) {
#ifdef __CUDA_ARCH__
  uint32_t r;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(one), "r"(b));
  return r;
#else
  return a * one + b;
#endif
}

// x ^= bit where d <= th (unsigned): the compare's predicate guards the xor,
// two ALU instructions and no select.
__device__ __forceinline__ void flip_if_le(uint32_t& x, uint32_t d, uint32_t th, uint32_t bit) {
#ifdef __CUDA_ARCH__
  asm("{\n\t.reg .pred p;\n\tsetp.le.u32 p, %1, %2;\n\t@p xor.b32 %0, %0, %3;\n\t}"
      : "+r"(x)
      : "r"(d), "r"(th), "r"(bit));
#else
  x ^= d <= th ? bit : 0u;
#endif
}

// x += bit where d > th (unsigned), on the FMA pipe: the high word of the
// 64-bit d * one + (2^32 - 1 - th) is 1 exactly where d > th (one = 1, a
// kernel argument, so the multiply-add is not folded back into an ALU add),
// and a second multiply-add moves it to bit. Two FMA-pipe instructions, no
// ALU one; x holds distinct bits, so the add is an or.
__device__ __forceinline__ void add_if_gt(uint32_t& x, uint32_t d, uint32_t th, uint32_t bit,
                                          uint32_t one) {
#ifdef __CUDA_ARCH__
  const uint64_t nth = ~th;   // zero-extended
  asm("{\n\t.reg .u64 t;\n\t.reg .u32 lo, hi;\n\t"
      "mad.wide.u32 t, %1, %3, %2;\n\t"
      "mov.b64 {lo, hi}, t;\n\t"
      "mad.lo.u32 %0, hi, %4, %0;\n\t}"
      : "+r"(x)
      : "r"(d), "l"(nth), "r"(one), "r"(bit));
#else
  x += d > th ? bit * one : 0u;
#endif
}

// Threefry2x32-R as threefry() above, with each round's add on the FMA pipe
// (fma_add), beside the rotation and xor on the ALU pipe.
template <int R>
__device__ __forceinline__ uint2 threefry_fma(uint32_t c0, uint32_t c1, uint32_t k0,
                                              uint32_t k1, uint32_t one) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  uint32_t x0 = c0 + ks[0];
  uint32_t x1 = c1 + ks[1];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    x0 = fma_add(x0, x1, one);
    x1 = rotl(x1, threefry_rot(r % 8)) ^ x0;
    if ((r + 1) % 4 == 0) {
      const int j = (r + 1) / 4;
      x0 += ks[j % 3];
      x1 += ks[(j + 1) % 3] + static_cast<uint32_t>(j);
    }
  }
  return make_uint2(x0, x1);
}

}  // namespace ising
