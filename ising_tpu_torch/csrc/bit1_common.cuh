// Device code shared by the bit1 sweep kernels (bit1_sweep.cu, bit1_planes.cu):
// the neighbour words (with the replica wraps and the quenched-disorder
// links), bit-sliced adder and class masks of ising_tpu/ops/pallas_bit1.py
// (_bit1_kernel :279-363, :511-517, _neighbor_adder, _neighbor_class_masks).
// The generators are in counter_rng.cuh.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "counter_rng.cuh"

namespace ising {

// Where a site's neighbours come from: the same for every thread of a launch,
// so each branch on it is uniform. link_mode says how quenched +-J disorder
// is given (pallas_bit1.py:_bit1_kernel :313-363):
//   LINKS_NONE     ferromagnetic;
//   LINKS_JPLANES  links = this color's flag words (j_up, j_dn, j_same, j_off);
//   LINKS_SPLIT    links = the parity-split link store (vE, vO, hE, hO) of one
//                  periodic lattice (v / h flag of the sites on even / odd
//                  full-lattice columns), projected here per word.
// csl > 0: replicas csl compact columns wide (csl divides W1); ysl > 0:
// replicas ysl rows tall (ysl divides H). 0 is the periodic wrap.
constexpr int LINKS_NONE = 0;
constexpr int LINKS_JPLANES = 1;
constexpr int LINKS_SPLIT = 2;

struct Geometry {
  const uint32_t* links[4];
  int link_mode;
  int csl, ysl;
};

// Host side: a Geometry from the launcher's arguments, or false for one the
// kernels do not take (split links are the periodic path only).
inline bool make_geometry(const void* l0, const void* l1, const void* l2,
                          const void* l3, int link_mode, int csl, int ysl,
                          int H, int W1, Geometry& g) {
  g = Geometry{{static_cast<const uint32_t*>(l0), static_cast<const uint32_t*>(l1),
        static_cast<const uint32_t*>(l2), static_cast<const uint32_t*>(l3)},
       link_mode, csl, ysl};
  if (link_mode < LINKS_NONE || link_mode > LINKS_SPLIT) return false;
  if (csl < 0 || ysl < 0 || (csl && W1 % csl) || (ysl && H % ysl)) return false;
  if (link_mode == LINKS_SPLIT && (csl || ysl)) return false;
  for (const uint32_t* p : g.links) {
    if (link_mode != LINKS_NONE && p == nullptr) return false;
  }
  return true;
}

// The word (y, j) of one thread and the src words around it. Bit g of word
// (y, j) is compact column c = g*W1 + j; the off-column neighbour of c is
// c-1 or c+1: lane j-1 / j+1 of the same bit, and at the row's first / last
// lane the word one bit over (a 1-bit rotation). Black looks left on even
// rows and right on odd rows; white the mirror: a site looks right where it
// sits on an odd full-lattice column.
//
// Replicas (pallas_bit1.py:296-304, :511-517): at lane j % csl == 0 the left
// neighbour is lane j + csl - 1 of the same bit, at j % csl == csl - 1 the
// right one lane j - csl + 1 (csl divides W1, so c % csl == j % csl in every
// bit group and the wrap needs no rotation); row y % ysl == 0 takes row
// y + ysl - 1 as up, row y % ysl == ysl - 1 row y - ysl + 1 as down, and
// src_up / src_dn are not read.
//
// Disorder: the four link flags are XORed into the four neighbour words
// (never into me) before the adder, in every accept.
struct Site {
  int64_t idx;
  int y, j;
  uint32_t me, up, dn, same, off;
};

__device__ __forceinline__ bool load_site(const uint32_t* __restrict__ dst,
                                          const uint32_t* __restrict__ src,
                                          const uint32_t* __restrict__ src_up,
                                          const uint32_t* __restrict__ src_dn,
                                          int H, int W1, int color,
                                          const Geometry& g, Site& s) {
  s.idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s.idx >= static_cast<int64_t>(H) * W1) return false;
  s.y = static_cast<int>(s.idx / W1);
  s.j = static_cast<int>(s.idx - static_cast<int64_t>(s.y) * W1);
  const int64_t w1 = W1;
  const uint32_t* row = src + s.y * w1;
  const int j = s.j;
  s.me = dst[s.idx];
  s.same = row[j];
  const bool odd_col = (color == 0) == static_cast<bool>(s.y & 1);
  if (g.link_mode == LINKS_NONE && g.csl == 0 && g.ysl == 0) {
    // Periodic and ferromagnetic, the main path: a block of its own, so
    // that none of the geometry's work below is issued here.
    s.up = s.y == 0 ? src_up[j] : row[j - w1];
    s.dn = s.y == H - 1 ? src_dn[j] : row[j + w1];
    const uint32_t left = j == 0 ? rotl(row[W1 - 1], 1) : row[j - 1];
    const uint32_t right = j == W1 - 1 ? rotl(row[0], 31) : row[j + 1];
    s.off = odd_col ? right : left;
    return true;
  }
  if (g.ysl) {
    const int r = s.y % g.ysl;
    s.up = row[r == 0 ? (g.ysl - 1) * w1 + j : j - w1];
    s.dn = row[r == g.ysl - 1 ? j - (g.ysl - 1) * w1 : j + w1];
  } else {
    s.up = s.y == 0 ? src_up[j] : row[j - w1];
    s.dn = s.y == H - 1 ? src_dn[j] : row[j + w1];
  }
  uint32_t left, right;
  if (g.csl) {
    const int l = j % g.csl;
    left = row[l == 0 ? j + g.csl - 1 : j - 1];
    right = row[l == g.csl - 1 ? j - g.csl + 1 : j + 1];
  } else {
    left = j == 0 ? rotl(row[W1 - 1], 1) : row[j - 1];
    right = j == W1 - 1 ? rotl(row[0], 31) : row[j + 1];
  }
  s.off = odd_col ? right : left;
  if (g.link_mode == LINKS_JPLANES) {
    s.up ^= g.links[0][s.idx];
    s.dn ^= g.links[1][s.idx];
    s.same ^= g.links[2][s.idx];
    s.off ^= g.links[3][s.idx];
  } else if (g.link_mode == LINKS_SPLIT) {
    // A site on an odd column takes vO and its right link hO[j]; on an even
    // column vE and its left link, hO of compact column c - 1 (lane j - 1,
    // or at lane 0 the last word one bit over, as for the spins). Its
    // same-column link is hE either way; j_up is the v flag one row up
    // (row H - 1 above row 0: one periodic lattice). (A select of two
    // pointers: indexing g.links by a runtime value would put the whole
    // Geometry into local memory.)
    const uint32_t* v = odd_col ? g.links[1] : g.links[0];
    const uint32_t* hO = g.links[3] + s.y * w1;
    s.up ^= v[s.y == 0 ? (H - 1) * w1 + j : s.idx - w1];
    s.dn ^= v[s.idx];
    s.same ^= g.links[2][s.idx];
    s.off ^= odd_col ? hO[j] : (j == 0 ? rotl(hO[W1 - 1], 1) : hO[j - 1]);
  }
  return true;
}

// Bit-sliced neighbour count n = n2 n1 n0 (pallas_bit1.py:_neighbor_adder).
struct Count {
  uint32_t n0, n1, n2;
};

__device__ __forceinline__ Count neighbour_count(const Site& s) {
  const uint32_t t0 = s.up ^ s.dn, c0 = s.up & s.dn;
  const uint32_t t1 = s.same ^ s.off, c1 = s.same & s.off;
  const uint32_t c2 = t0 & t1;
  return {t0 ^ t1, c0 ^ c1 ^ c2, (c0 & c1) | (c2 & (c0 ^ c1))};
}

// Classes of the mirrored count e = b ? n : 4 - n
// (pallas_bit1.py:_neighbor_class_masks): e >= 3, e >= 4, e == 2.
struct Classes {
  uint32_t ge3, ge4, eq2;
};

__device__ __forceinline__ Classes neighbour_classes(const Site& s) {
  const Count n = neighbour_count(s);
  const uint32_t n_ge3 = n.n2 | (n.n1 & n.n0);
  const uint32_t n_le1 = ~(n.n2 | n.n1);
  const uint32_t n_eq0 = n_le1 & ~n.n0;
  return {(s.me & n_ge3) | (~s.me & n_le1), (s.me & n.n2) | (~s.me & n_eq0),
          ~n.n2 & n.n1 & ~n.n0};
}

// Metropolis accept (pallas_bit1.py:444-458): e < 2 always flips; e == 3 and
// e == 4 flip on their accept words p4, p8; the greedy quench flips e == 2
// on the coin word p0 instead of always.
template <bool GREEDY>
__device__ __forceinline__ uint32_t flip_mask(const Classes& c, uint32_t p0,
                                              uint32_t p4, uint32_t p8) {
  if constexpr (GREEDY) {
    return (~c.ge3 & ~c.eq2) | (c.eq2 & p0) | (c.ge3 & ~c.ge4 & p4) |
           (c.ge4 & p8);
  } else {
    return ~c.ge3 | (c.ge3 & ~c.ge4 & p4) | (c.ge4 & p8);
  }
}

// One thread per word of an (H, W1) plane.
inline bool grid_for(int H, int W1, dim3& grid) {
  return H > 0 && W1 > 0 && grid_for_threads(static_cast<int64_t>(H) * W1, grid);
}

}  // namespace ising
