// What one packed word's update needs (4 bits per spin), shared by the
// half-sweep (packed_sweep.cu) and the fused both-colors step
// (packed_fused.cu), so that both take one accept and one draw layout: the
// accept (ising_tpu/ops/pallas_packed.py:_accept_and_flip, :243-393) read
// through a byte offset a field into a 32-word threshold table, and the
// draws of a word or of a ChaCha pair of words.
//
// Layout: a color plane is (H, W) 32-bit words, W = C/8 for C compact
// columns; field z (bits 4z..4z+3) of word (y, j) holds the spin at compact
// column c = z*W + j in its low bit. The four neighbour words are added as
// whole words, so each field sums its count n = 0..4 without a carry; the
// mirrored count e = b ? n : 4 - n classifies all eight fields at once
// (ge_k = e + (8 - k)*0x11111111, bit 3 of each field), and a field flips
// where its u32 draw is at or below its class's threshold (unsigned). The
// arithmetic is the JAX kernel's on any 32-bit words, not only on valid
// packed ones (carries between fields included).
//
// The accept through one byte offset: a field's threshold is a function of
// its class bits g1..g4 (bit 4z+3 of ge_1..ge_4) and, for the field table,
// its own bit b. field_offsets gathers them into the byte 4*(b + 2*g1 +
// 4*g2 + 8*g3 + 16*g4) for every field at once (even fields in the bytes
// of one word, odd fields in another; an accept leaves the bits it does not
// read at 0), and the table holds the select's result at each of the 32
// word offsets (fill_table). A field then costs one byte extract
// (__byte_perm), one shared-memory load, and a compare whose predicate
// toggles its bit of the word (flip_if_le): three ALU-pipe instructions,
// where two compares, their set bits and the class selects took about six.
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
// A thread keeps its words' counter addends (Calls) across the rows it
// updates; a row's counter is one 32 x 32 -> 64-bit multiply-add on the FMA
// pipe (gy * nq + k), which wraps with the global row gy as the JAX
// package's uint32 row index does.

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

// Words a thread updates in a row (ChaCha: the pair q, q + W/2) and the
// generator calls they take a row.
__host__ __device__ constexpr int words_per_thread(int family) {
  return family == FAMILY_CHACHA ? 2 : 1;
}
__host__ __device__ constexpr int calls_per_thread(int family) {
  return family == FAMILY_PHILOX ? 2 : family == FAMILY_THREEFRY ? 4 : 1;
}

// The accept table: word i holds the threshold of the class index i = b +
// 2*g1 + 4*g2 + 8*g3 + 16*g4 (pallas_packed.py:_accept_and_flip):
//   ACCEPT_METROPOLIS (T > 0): e <= 2 (!g3) flips; e == 3 on d <= thr[8],
//     e >= 4 (g4) on d <= thr[9];
//   ACCEPT_GREEDY (T <= 0): e < 2 (!g2) flips; e == 2 on thr[7], and as
//     above;
//   ACCEPT_FIELD: own bit 1 takes thr[5 + e], own bit 0 thr[4 - e], e the
//     highest k with g_k (0 for none).
// "Flips" is the threshold 0xFFFFFFFF: every u32 draw is at or below it.
constexpr int TABLE_WORDS = 32;

template <int ACCEPT>
__device__ __forceinline__ uint32_t table_entry(int i, const Thresholds& thr) {
  const bool b = i & 1, g1 = i & 2, g2 = i & 4, g3 = i & 8, g4 = i & 16;
  if constexpr (ACCEPT == ACCEPT_FIELD) {
    return b ? (g4 ? thr.t[9] : g3 ? thr.t[8] : g2 ? thr.t[7] : g1 ? thr.t[6] : thr.t[5])
             : (g4 ? thr.t[0] : g3 ? thr.t[1] : g2 ? thr.t[2] : g1 ? thr.t[3] : thr.t[4]);
  } else if constexpr (ACCEPT == ACCEPT_GREEDY) {
    return g2 ? (g4 ? thr.t[9] : g3 ? thr.t[8] : thr.t[7]) : 0xFFFFFFFFu;
  } else {
    return g3 ? (g4 ? thr.t[9] : thr.t[8]) : 0xFFFFFFFFu;
  }
}

// Fills the shared table, by one thread (unrolled: constant indices only).
template <int ACCEPT>
__device__ __forceinline__ void fill_table(uint32_t* table, const Thresholds& thr) {
#pragma unroll
  for (int i = 0; i < TABLE_WORDS; ++i) table[i] = table_entry<ACCEPT>(i, thr);
}

// The byte offsets of a word's eight fields into the table, from its own
// value and the whole-word sum of its four neighbours: field z = 2k in byte
// k of .x, field 2k + 1 in byte k of .y, each 4*(b + 2*(g1 + 2*g2 + 4*g3 +
// 8*g4)) <= 124, with the class bits the accept does not read (and b, but
// for the field table) left at 0.
template <int ACCEPT>
__device__ __forceinline__ uint2 field_offsets(uint32_t me, uint32_t nsum) {
  const uint32_t m1 = me & M1;
  const uint32_t mask = (m1 << 4) - m1;
  const uint32_t e = (nsum & mask) | ((0x44444444u - nsum) & ~mask);
  // each field's class nibble g1 + 2*g2 + 4*g3 + 8*g4
  uint32_t g = ((e + 0x44444444u) & M8) | (((e + 0x55555555u) & M8) >> 1);
  if constexpr (ACCEPT != ACCEPT_METROPOLIS) g |= ((e + 0x66666666u) & M8) >> 2;
  if constexpr (ACCEPT == ACCEPT_FIELD) g |= ((e + 0x77777777u) & M8) >> 3;
  uint32_t lo = (g & 0x0F0F0F0Fu) << 3, hi = (g >> 1) & 0x78787878u;
  if constexpr (ACCEPT == ACCEPT_FIELD) {
    lo |= (me & 0x01010101u) << 2;
    hi |= (me >> 2) & 0x04040404u;
  }
  return make_uint2(lo, hi);
}

// Whether a site of `color` in row y looks right for its off-column
// neighbour: it sits on an odd full-lattice column (black on odd rows, white
// on even rows). The parity is the plane's row index's.
__host__ __device__ inline bool looks_right(int color, int y) {
  return (color == 0) == static_cast<bool>(y & 1);
}

// Field z of a word whose offsets are `off` takes draw d: its bit of x
// toggles where d is at or below the table's threshold at its offset.
__device__ __forceinline__ void take(uint32_t& x, uint2 off, int z, uint32_t d,
                                     const uint32_t* table) {
  const uint32_t at = __byte_perm(z & 1 ? off.y : off.x, 0u, 0x4440 | (z >> 1));
  const uint32_t th = *reinterpret_cast<const uint32_t*>(
      reinterpret_cast<const char*>(table) + at);
  flip_if_le(x, d, th, 1u << (4 * z));
}

// A thread's generator calls: the counter addend of each (the counter of
// row gy is gy * nq + k, 64-bit).
template <int FAMILY>
struct Calls {
  uint32_t nq;
  uint64_t k[calls_per_thread(FAMILY)];

  // The calls of the thread whose first word is column q of a W-word row.
  __device__ __forceinline__ Calls(int q, int W) {
    const uint32_t w = static_cast<uint32_t>(W), u = static_cast<uint32_t>(q);
    nq = FAMILY == FAMILY_CHACHA ? w / 2 : calls_per_thread(FAMILY) * w;
#pragma unroll
    for (int r = 0; r < calls_per_thread(FAMILY); ++r) k[r] = r * w + u;
  }

  __device__ __forceinline__ uint64_t at(uint32_t gy, int r) const {
    return static_cast<uint64_t>(gy) * nq + k[r];
  }
};

// The accept of the thread's words of global row gy: x[0] (word q) and,
// for ChaCha, x[1] (word q + W/2), whose offsets are off[0], off[1]; each
// field toggles where its draw is at or below its threshold.
template <int FAMILY, int R>
__device__ __forceinline__ void accept_words(uint32_t (&x)[words_per_thread(FAMILY)],
                                             const uint2 (&off)[words_per_thread(FAMILY)],
                                             uint32_t gy, const Calls<FAMILY>& calls,
                                             const Stream& s, uint32_t one,
                                             const uint32_t* table) {
  if constexpr (FAMILY == FAMILY_CHACHA) {
    const uint64_t c = calls.at(gy, 0);
    uint32_t o[16];
    chacha<R>(static_cast<uint32_t>(c), static_cast<uint32_t>(c >> 32), s.step,
              s.tag, s.k0, s.k1, o);
#pragma unroll
    for (int z = 0; z < 8; ++z) {
      take(x[0], off[0], z, o[2 * z], table);
      take(x[1], off[1], z, o[2 * z + 1], table);
    }
  } else if constexpr (FAMILY == FAMILY_PHILOX) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint64_t c = calls.at(gy, h);
      const uint4 o = philox<R>(static_cast<uint32_t>(c),
                                static_cast<uint32_t>(c >> 32), s.step, s.tag,
                                s.k0, s.k1);
      take(x[0], off[0], h, o.x, table);
      take(x[0], off[0], 2 + h, o.y, table);
      take(x[0], off[0], 4 + h, o.z, table);
      take(x[0], off[0], 6 + h, o.w, table);
    }
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint64_t c = calls.at(gy, r);
      const uint2 o = threefry_fma<R>(static_cast<uint32_t>(c),
                                      static_cast<uint32_t>(c >> 32), s.k0, s.k1, one);
      take(x[0], off[0], r, o.x, table);
      take(x[0], off[0], r + 4, o.y, table);
    }
  }
}

}  // namespace ising
