// Device code shared by the bit1 sweep kernels (bit1_sweep.cu, bit1_planes.cu):
// the row walk down a band with its neighbour words (the replica wraps and
// the quenched-disorder links), the bit-sliced adder and the class masks of
// ising_tpu/ops/pallas_bit1.py (_bit1_kernel :279-363, :511-517,
// _neighbor_adder, _neighbor_class_masks). The generators are in
// counter_rng.cuh.
//
// Layout: a color plane is (H, W1) 32-bit words; bit g of word (y, j) is the
// spin at compact column c = g*W1 + j. The off-column neighbour of c is c-1
// or c+1: lane j-1 / j+1 of the same bit, and at the row's first / last lane
// the word one bit over (a 1-bit rotation). Black looks left on even rows
// and right on odd rows; white the mirror: a site looks right where it sits
// on an odd full-lattice column.
//
// The row walk: a thread owns one word column j and walks a band of
// BAND_ROWS rows down it with its window of src words in registers: row
// y + 1's word becomes row y's "below" and row y's becomes row y + 1's
// "above", so the thread loads one new src word a row. The off-column word
// is loaded for the row that needs it (it hits L1: the neighbouring thread
// loaded it as its own), at a byte offset and a rotation fixed for the
// thread (Side): only the row's (or a replica's) end lanes take another
// lane, and only the row's end lanes rotate. Rows alternate the side they
// look to, so rows go in pairs whose first row has the parity of the color:
// it looks left and the second right, a compile-time fact inside the pair.
// Band k starts at row k*B - color, on such a row; a lone first or last row
// takes the same code with the side chosen at run time. The grid is
// two-dimensional (word columns by bands), so no thread divides an index,
// and addresses go down the band by adds.
//
// What bounds it: the kernels are integer-bound (bit1_sweep.cu,
// bit1_planes.cu), so this code's cost is the ALU and FMA instructions it
// adds a word beside the generator and the accept. A thread a word with no
// loop (a 64-bit division for (y, j), five loads, edge and path selects)
// takes 156-169 static ALU a word there; the walk measured on an H100
// (python3 -m ising_tpu_torch.sass: the main loop by source lines) takes
// 3-10 ALU / 3-9.5 FMA a word on the ordered path and 7.5-29 / 4.5-22.5
// with link words or replica rows (every mode and accept), the classes
// 11-14 ALU and the flip 2-5.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "counter_rng.cuh"

namespace ising {

// Where a site's neighbours come from: the same for every thread of a launch.
// link_mode says how quenched +-J disorder is given
// (pallas_bit1.py:_bit1_kernel :313-363):
//   LINKS_NONE     ferromagnetic;
//   LINKS_JPLANES  links = this color's flag words (j_up, j_dn, j_same, j_off);
//   LINKS_SPLIT    links = the parity-split link store (vE, vO, hE, hO) of one
//                  periodic lattice (v / h flag of the sites on even / odd
//                  full-lattice columns), projected here per word.
// csl > 0: replicas csl compact columns wide (csl divides W1); ysl > 0:
// replicas ysl rows tall (ysl divides H). 0 is the periodic wrap. The link
// mode and whether there are replica rows are template parameters of the
// kernels (the ordered path carries neither); csl moves only a thread's
// Side. One general kernel that reads both at run time, beside the ordered
// one (two kernels a mode and accept, not five), built in 31.6 s instead of
// 48.8 s but ran the link and replica paths 1.06-1.51x slower on an H100
// (chip_smoke.py --turns, PERF.md).
constexpr int LINKS_NONE = 0;
constexpr int LINKS_JPLANES = 1;
constexpr int LINKS_SPLIT = 2;

constexpr int THREADS = 256;
constexpr int BAND_ROWS = 16;   // rows a thread walks (even: rows go in pairs)

// CTAs of THREADS threads an SM is to hold (__launch_bounds__'s second
// argument): 3, at most 80 registers a thread for 24 warps an SM to hide the
// generators' latency, in the Metropolis accept at T > 0 (METROPOLIS); 1 (no
// cap) where ptxas spills under that cap: the greedy quench's third
// threshold, the field's chains, Philox-10 (the u32 mode and hw's 24
// planes) beside the link words, and Threefry-20.
template <int FAMILY, int R, int LINKS, bool METROPOLIS>
__host__ __device__ constexpr int min_blocks() {
  return !METROPOLIS || (FAMILY == FAMILY_PHILOX && R == 10 && LINKS != LINKS_NONE) ||
                 (FAMILY == FAMILY_THREEFRY && R == 20)
             ? 1
             : 3;
}

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

// What every row of a launch shares.
struct Sweep {
  uint32_t* dst;
  const uint32_t* src;
  const uint32_t* src_up;
  const uint32_t* src_dn;
  Geometry geo;
  int H, W1, bands, color;
  uint32_t row0;
};

// A row's own word and its four neighbour words, the link flags XORed into
// the neighbours (never into me) before the adder, in every accept.
struct Nbrs {
  uint32_t me, up, dn, same, off;
};

// Bit-sliced neighbour count n = n2 n1 n0 (pallas_bit1.py:_neighbor_adder).
struct Count {
  uint32_t n0, n1, n2;
};

__device__ __forceinline__ Count neighbour_count(const Nbrs& s) {
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

__device__ __forceinline__ Classes neighbour_classes(const Nbrs& s) {
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

// Where a word's off-column neighbour lies in the same row: an offset in
// words from the word and a left rotation, fixed for a thread's word across
// its rows.
struct Side {
  int words;
  int rot;
};

// A thread's word column j and its side neighbours in rows that look left
// and right: lane j - 1 or j + 1; at the row's first / last lane the last /
// first lane one bit over (a 1-bit rotation). Replicas
// (pallas_bit1.py:296-304, :511-517): at lane j % csl == 0 the left
// neighbour is lane j + csl - 1, at j % csl == csl - 1 the right one lane
// j - csl + 1, with no rotation (csl divides W1, so c % csl == j % csl in
// every bit group).
struct Col {
  int j;
  Side left, right;

  __device__ __forceinline__ Col(int j_, int W1, int csl) : j(j_) {
    const bool first = csl ? j % csl == 0 : j == 0;
    const bool last = csl ? j % csl == csl - 1 : j == W1 - 1;
    const int span = (csl ? csl : W1) - 1;   // to the other end of the row
    left = first ? Side{span, csl ? 0 : 1} : Side{-1, 0};
    right = last ? Side{-span, csl ? 0 : 31} : Side{1, 0};
  }
};

// A thread's words in one row: of dst, of src and, with links, of the four
// link planes. A row down is a 32-bit row length added to each pointer, one
// multiply-add on the FMA pipe (IMAD.WIDE), as is a word's side offset.
template <int LINKS>
struct Row {
  uint32_t* d;
  const uint32_t* s;
  const uint32_t* l[LINKS == LINKS_NONE ? 1 : 4];

  __device__ __forceinline__ Row(const Sweep& a, int j, int y) {
    const int64_t at = static_cast<int64_t>(y) * a.W1 + j;
    d = a.dst + at;
    s = a.src + at;
    if constexpr (LINKS != LINKS_NONE) {
#pragma unroll
      for (int i = 0; i < 4; ++i) l[i] = a.geo.links[i] + at;
    }
  }

  __device__ __forceinline__ Row down(int W1) const {
    Row r = *this;
    r.d = d + W1;
    r.s = s + W1;
    if constexpr (LINKS != LINKS_NONE) {
#pragma unroll
      for (int i = 0; i < 4; ++i) r.l[i] = l[i] + W1;
    }
    return r;
  }
};

// Plane row y (y = -1: the slab's src_up row; y = H: src_dn).
__device__ __forceinline__ const uint32_t* src_row(const Sweep& a, int y) {
  return y < 0 ? a.src_up : y >= a.H ? a.src_dn : a.src + static_cast<int64_t>(y) * a.W1;
}

// The rows above and below row y: y - 1 and y + 1 (src_up and src_dn past
// the slab's edges), or with replicas ysl tall (YSL) the replica's last row
// above its first and its first below its last. r is y % ysl.
template <bool YSL>
__device__ __forceinline__ const uint32_t* above(const Sweep& a, int y, int r) {
  return src_row(a, YSL && r == 0 ? y + a.geo.ysl - 1 : y - 1);
}

template <bool YSL>
__device__ __forceinline__ const uint32_t* below(const Sweep& a, int y, int r) {
  return src_row(a, YSL && r == a.geo.ysl - 1 ? y - a.geo.ysl + 1 : y + 1);
}

// Whether a site of `color` in row y looks right for its off-column
// neighbour: it sits on an odd full-lattice column (black on odd rows, white
// on even rows).
__host__ __device__ inline bool looks_right(int color, int y) {
  return (color == 0) == static_cast<bool>(y & 1);
}

// Updates the thread's word of global row gy at `at` from its window (up,
// same) and the word below it (at dn), then moves the window a row down.
// SIDE -1 or +1: the row looks left or right; 0: the side `right` says (a
// lone row). top: the row is the plane's row 0, whose split-store up link
// is in row H - 1 (one periodic lattice). update(gy, n) returns the row's
// flip word.
template <int LINKS, int SIDE, class Update>
__device__ __forceinline__ void update_row(const Sweep& a, const Col& c, uint32_t gy,
                                           bool right, const Row<LINKS>& at,
                                           const uint32_t* dn, bool top, uint32_t& up,
                                           uint32_t& same, const Update& update) {
  if constexpr (SIDE != 0) right = SIDE > 0;
  const Side sd = right ? c.right : c.left;
  const uint32_t below = *dn;
  Nbrs n{*at.d, up, below, same, rotl(at.s[sd.words], sd.rot)};
  if constexpr (LINKS == LINKS_JPLANES) {
    n.up ^= *at.l[0];
    n.dn ^= *at.l[1];
    n.same ^= *at.l[2];
    n.off ^= *at.l[3];
  } else if constexpr (LINKS == LINKS_SPLIT) {
    // A site on an odd column takes vO and its right link hO[j]; on an even
    // column vE and its left link, hO of compact column c - 1 (lane j - 1,
    // or at lane 0 the last word one bit over, as for the spins). Its
    // same-column link is hE either way.
    const uint32_t* v = right ? at.l[1] : at.l[0];
    n.up ^= top ? v[static_cast<int64_t>(a.H - 1) * a.W1] : v[-a.W1];
    n.dn ^= *v;
    n.same ^= *at.l[2];
    n.off ^= right ? *at.l[3] : rotl(at.l[3][c.left.words], c.left.rot);
  }
  *at.d = n.me ^ update(gy, n);
  up = same;
  same = below;
}

// A row of the pair loop, at `at`, whose row below lies in the plane
// (without replica rows the loop stops short of the slab's last row); `at`
// moves a row down. With replicas ysl tall the window reloads at a
// replica's first row and the last row's below is the first; r (y % ysl)
// moves on a row.
template <int LINKS, bool YSL, int SIDE, class Update>
__device__ __forceinline__ void walk_row(const Sweep& a, const Col& c, uint32_t gy, int& r,
                                         bool top, Row<LINKS>& at, uint32_t& up,
                                         uint32_t& same, const Update& update) {
  const Row<LINKS> next = at.down(a.W1);
  const uint32_t* dn = next.s;
  if constexpr (YSL) {
    const int64_t span = static_cast<int64_t>(a.geo.ysl - 1) * a.W1;
    if (r == 0) {   // a replica's first row: its last row above it
      up = at.s[span];
      same = *at.s;
    }
    if (r == a.geo.ysl - 1) dn = at.s - span;
  }
  update_row<LINKS, SIDE>(a, c, gy, SIDE > 0, at, dn, top, up, same, update);
  at = next;
  if constexpr (YSL) r = r + 1 == a.geo.ysl ? 0 : r + 1;
}

// One thread's walk: its word column j (if it lies in the plane) down every
// band k of the launch that falls to it, each row's word updated in place
// by update(gy, n). No thread reads another thread's dst word, so the
// in-place update is race-free (the wrapper refuses dst/src overlap).
template <int LINKS, bool YSL, class Update>
__device__ __forceinline__ void walk(const Sweep& a, int j, const Update& update) {
  constexpr int B = BAND_ROWS;
  static_assert(B % 2 == 0, "rows go in pairs");
  if (j >= a.W1) return;
  const Col c(j, a.W1, a.geo.csl);
  for (int k = static_cast<int>(blockIdx.y * blockDim.y + threadIdx.y); k < a.bands;
       k += static_cast<int>(gridDim.y * blockDim.y)) {
    // band k: rows k*B - color .. (k+1)*B - color - 1, cut to 0 .. H - 1
    const int y0 = k == 0 ? 0 : k * B - a.color;
    const int y1 = (k + 1) * B - a.color < a.H ? (k + 1) * B - a.color : a.H;
    const int lead = (y0 & 1) != a.color;   // a lone first row, of the other parity
    int y = y0 + lead;
    int r = YSL ? y % a.geo.ysl : 0;
    uint32_t up, same;
    // pairs of rows y (looks left) and y + 1 (right); without replica rows
    // the last row's below (src_dn) is left to the lone rows
    if (y + 1 < y1 && (YSL || y + 2 < a.H)) {
      Row<LINKS> at(a, j, y);
      if (!(YSL && r == 0)) {
        up = above<YSL>(a, y, r)[j];
        same = *at.s;
      }
#pragma unroll 1
      for (; y + 1 < y1 && (YSL || y + 2 < a.H); y += 2) {
        const uint32_t gy = a.row0 + static_cast<uint32_t>(y);
        walk_row<LINKS, YSL, -1>(a, c, gy, r, y == 0, at, up, same, update);
        walk_row<LINKS, YSL, +1>(a, c, gy + 1, r, false, at, up, same, update);
      }
    }
    // the lone rows: the first (if it has the other parity) and the last
    // one or two
#pragma unroll 1
    for (int i = 0; i < 3; ++i) {
      const int ly = i == 0 ? (lead ? y0 : -1) : (y + i - 1 < y1 ? y + i - 1 : -1);
      if (ly < 0) continue;
      const int lr = YSL ? ly % a.geo.ysl : 0;
      const Row<LINKS> at(a, j, ly);
      up = above<YSL>(a, ly, lr)[j];
      same = *at.s;
      update_row<LINKS, 0>(a, c, a.row0 + static_cast<uint32_t>(ly),
                           looks_right(a.color, ly), at, below<YSL>(a, ly, lr) + j,
                           ly == 0, up, same, update);
    }
  }
}

// CTAs of THREADS threads: bx word columns (the smallest power of two from
// 32 to THREADS that covers the row) by THREADS / bx bands. Band k holds
// rows k*B - color .. (k+1)*B - color - 1: (H + B) / B bands cover the H + 1
// rows that color 1 shifts them over. False for a shape the grid cannot
// cover.
inline bool walk_grid(Sweep& a, dim3& grid, dim3& block) {
  if (a.H <= 0 || a.W1 <= 0 || a.H > 0x7FFFFFFF - 2 * BAND_ROWS ||
      (a.color != 0 && a.color != 1)) {
    return false;
  }
  a.bands = (a.H + BAND_ROWS) / BAND_ROWS;
  int bx = 32;
  while (bx < a.W1 && bx < THREADS) bx *= 2;
  block = dim3(bx, THREADS / bx);
  const int gy = (a.bands + static_cast<int>(block.y) - 1) / static_cast<int>(block.y);
  const int64_t gx = (static_cast<int64_t>(a.W1) + bx - 1) / bx;
  if (gx > 0x7FFFFFFF) return false;
  grid = dim3(static_cast<unsigned>(gx), gy < 65535 ? gy : 65535);
  return true;
}

}  // namespace ising
