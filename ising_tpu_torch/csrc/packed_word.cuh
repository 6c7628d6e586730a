// What one packed word's update needs (4 bits per spin), shared by the
// half-sweep (packed_sweep.cu) and the fused both-colors step
// (packed_fused.cu), so that both take one accept and one draw layout: the
// threshold table, a word's neighbour set, the off-column word at the row's
// ends, the accept (ising_tpu/ops/pallas_packed.py:_accept_and_flip,
// :243-393) and the draws of a word or of a ChaCha pair of words.
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

#pragma once

#include "counter_rng.cuh"

namespace ising {

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

// One color phase's counter stream: the step, the tag (TAG_SWEEP | color,
// salted for hw) and the key (seed lo, hi; Threefry: its stream key).
struct Stream {
  uint32_t step, tag, k0, k1;
};

// A word's own value and the four neighbour words its fields count.
struct Word {
  uint32_t me, up, dn, same, off;
};

// Whether a site of `color` in row y looks right for its off-column
// neighbour: it sits on an odd full-lattice column (black on odd rows, white
// on even rows). The parity is the plane's row index's.
__device__ __forceinline__ bool looks_right(int color, int y) {
  return (color == 0) == static_cast<bool>(y & 1);
}

// The periodic off-column neighbour of word j in the other color's row `row`
// (pallas_packed.py:202-235): lane j - 1 or j + 1 of the same field; at the
// row's first / last lane the last / first word with every field moved one
// group (a 4-bit rotation).
__device__ __forceinline__ uint32_t off_word(const uint32_t* row, int j, int W,
                                             bool right) {
  return right ? (j == W - 1 ? rotl(row[0], 28) : row[j + 1])
               : (j == 0 ? rotl(row[W - 1], 4) : row[j - 1]);
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

// The words a thread updates in one row: word q (ChaCha: words q and
// q + W/2), loaded by load(j) -> Word and written back by store(j, new
// word). gy is the row's global index (row0 + y, mod 2^32).
template <int FAMILY, int R, int ACCEPT, class Load, class Store>
__device__ __forceinline__ void update_words(Load load, Store store, uint32_t gy,
                                             int W, int q, const Stream& s,
                                             const Thresholds& thr) {
  const uint32_t w = static_cast<uint32_t>(W);
  const Word a = load(q);
  Acceptor<ACCEPT> acc_a(a);
  if constexpr (FAMILY == FAMILY_CHACHA) {
    const Word b = load(q + W / 2);
    Acceptor<ACCEPT> acc_b(b);
    const uint64_t c = counter(gy, w / 2, static_cast<uint32_t>(q));
    uint32_t o[16];
    chacha<R>(static_cast<uint32_t>(c), static_cast<uint32_t>(c >> 32), s.step,
              s.tag, s.k0, s.k1, o);
#pragma unroll
    for (int z = 0; z < 8; ++z) {
      acc_a.take(o[2 * z], z, thr);
      acc_b.take(o[2 * z + 1], z, thr);
    }
    store(q + W / 2, b.me ^ acc_b.flip());
  } else if constexpr (FAMILY == FAMILY_PHILOX) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint64_t c = counter(gy, 2u * w, h * w + static_cast<uint32_t>(q));
      const uint4 o = philox<R>(static_cast<uint32_t>(c),
                                static_cast<uint32_t>(c >> 32), s.step, s.tag,
                                s.k0, s.k1);
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
                                  static_cast<uint32_t>(c >> 32), s.k0, s.k1);
      acc_a.take(o.x, r, thr);
      acc_a.take(o.y, r + 4, thr);
    }
  }
  store(q, a.me ^ acc_a.flip());
}

}  // namespace ising
