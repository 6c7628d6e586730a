// Scalar ChaCha-R block function — independently written twin of the
// vector implementations (ising_tpu_torch/rng.py, and the JAX package's
// ising_tpu/rng.py chacha_block), used to cross-validate them (KATs in
// tests/test_torch_native.py), a copy of ising_tpu/native/chacha.h.
//
// State layout matches rng.py exactly (NOT the RFC-7539 key schedule —
// the library keys ChaCha with a 64-bit seed plus fixed pad words):
//   [ C0 C1 C2 C3 | k0 k1 P0 P1 | P2 P3 P4 P5 | c0 c1 step tag ]
// `rounds` counts single rounds applied as column/diagonal pairs
// (rounds=8 is "ChaCha8"); even counts only, like the vector twin.

#ifndef ISING_TPU_TORCH_NATIVE_CHACHA_H_
#define ISING_TPU_TORCH_NATIVE_CHACHA_H_

#include <cstdint>

namespace ising_chacha {

static const uint32_t kConst[4] = {0x61707865u, 0x3320646Eu, 0x79622D32u,
                                   0x6B206574u};
static const uint32_t kPad[6] = {0x243F6A88u, 0x85A308D3u, 0x13198A2Eu,
                                 0x03707344u, 0xA4093822u, 0x299F31D0u};

static inline uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

static inline void qr(uint32_t& a, uint32_t& b, uint32_t& c, uint32_t& d) {
  a += b; d = rotl(d ^ a, 16);
  c += d; b = rotl(b ^ c, 12);
  a += b; d = rotl(d ^ a, 8);
  c += d; b = rotl(b ^ c, 7);
}

// One block: 16 uint32 outputs for (c0, c1, step, tag) under key (k0, k1).
static inline void block(uint32_t c0, uint32_t c1, uint32_t step,
                         uint32_t tag, uint32_t k0, uint32_t k1, int rounds,
                         uint32_t out[16]) {
  uint32_t init[16] = {kConst[0], kConst[1], kConst[2], kConst[3],
                       k0, k1, kPad[0], kPad[1],
                       kPad[2], kPad[3], kPad[4], kPad[5],
                       c0, c1, step, tag};
  uint32_t x[16];
  for (int i = 0; i < 16; ++i) x[i] = init[i];
  for (int r = 0; r < rounds / 2; ++r) {
    qr(x[0], x[4], x[8], x[12]);
    qr(x[1], x[5], x[9], x[13]);
    qr(x[2], x[6], x[10], x[14]);
    qr(x[3], x[7], x[11], x[15]);
    qr(x[0], x[5], x[10], x[15]);
    qr(x[1], x[6], x[11], x[12]);
    qr(x[2], x[7], x[8], x[13]);
    qr(x[3], x[4], x[9], x[14]);
  }
  for (int i = 0; i < 16; ++i) out[i] = x[i] + init[i];
}

}  // namespace ising_chacha

#endif  // ISING_TPU_TORCH_NATIVE_CHACHA_H_
