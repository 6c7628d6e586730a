// The cluster labeler of the Swendsen-Wang update: a global union-find in
// three launches, with no passes and no host read.
//
// Replaces ising_tpu/cluster.py:_local_pass_kernel (the Pallas kernel of
// label_clusters_tiled). A labeling gives every site the minimum site id
// of its connected component under the open bonds, periodic in both axes
// or within its replica. The TPU kernel relaxes labels in passes over
// tiles until none changes: its grid walks in order and a pass is cheap
// there. On this card a pass lets a label cross one tile edge, so a
// cluster that spans the lattice took ~100 passes and a host read of a
// flag every few. Hopper has device-wide atomics and a 50 MB L2 instead,
// so the tiles are merged in device memory:
//   1. label_tile_roots_kernel, one block per (ty, tx) tile: a union-find
//      in shared memory over the open bonds inside the tile (a replica
//      wrap inside the tile included). Each run of sites joined along a
//      row within a warp's 32 sites becomes a star under its first site
//      (one warp vote); the other bonds hook one root under the other with
//      a compare-and-swap, in an order that keeps the trees shallow, finds
//      jumping pointers to their grandparents (ECL-CC). Each component
//      takes its least flat position y * X + x at its root (atomicMin;
//      the tile's row-major order is the lattice's), and every site of it
//      gets that position in the int32 parent plane: a forest in which
//      every parent is at most its site. Where every tile holds whole
//      replicas (or the whole lattice) every bond lies inside a tile, and
//      the kernel writes the least site id instead: the labeling is done.
//   2. label_hook_kernel, one block per tile, a thread per bond that may
//      leave the tile (its last column and row, and the first replica wrap
//      when the tile starts inside a replica): for an open one, find both
//      roots in the parent plane and hook the larger root under the smaller
//      with a compare-and-swap that succeeds only while it is a root,
//      retrying from the roots a failure returns.
//   3. label_flatten_kernel, one block per tile: label = the site id of
//      each site's root (the position itself on the full lattice, in
//      place); each tile root's root is found once a block and kept in
//      shared memory for the sites under it.
// Why the answer is unique: every root of phase 1 is the least position of
// its tile component, and every hook lowers a root, so the last root of a
// component is its least position whatever order the atomics take; within
// a replica ids grow with the position, so its id is the component's
// least id. The labels equal cluster.py:label_clusters bit for bit.
//
// Device-memory ordering (phases 2 and 3). Roots change only by the
// compare-and-swap, and a node that is not a root never becomes one; every
// other store (find_root's grandparent jumps in phase 2) writes an
// ancestor of the node, which is smaller than it. So no store can undo a
// hook, every chain of parents falls strictly, and a stale read (the
// volatile loads go to L2, not a private L1 copy) returns an ancestor
// that was current once: a find reaches a root, and the CAS tells whether
// it still is one. Phase 3 runs after every hook has ended (a launch
// later on the same stream), so the roots are final there, and it stores
// only roots: a grandparent jump there could land after another thread's
// root and leave a site's label short of its root.
//
// Bound: a labeling must read the two bond planes once (1 B a site each)
// and write the labels once (4 B): 6 B a site, 30.0 us at 4096^2 and
// 480.8 us at 16384^2 at 3.35 TB/s; its operations (a few per site) take
// far less. The design moves about 14 B a site (bonds and parent plane in
// phase 1, parent in and labels out in phase 3) plus the root chases of
// phases 2 and 3, which fall on the few tile roots and mostly hit L2.
// Phase 1 keeps the shared-memory trees shallow (stars along rows,
// pointer jumping) and takes tiles as large as three blocks an SM allow
// (8192 sites; 16384 for one 128 x 128 replica). Phase 2 reads only the
// ~2-3% of bonds on tile edges.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_TILE_SITES = 16384;  // cluster.py:MAX_TILE_SITES
constexpr int MAX_THREADS = 512;
constexpr int BLOCKS_PER_SM = 3;  // 64 KB tiles: three fit an SM's 227 KB
constexpr int HOOK_THREADS = 128;
// Each thread keeps a bit per site in 32-bit words.
static_assert(MAX_TILE_SITES <= 32 * MAX_THREADS, "tile too large");
static_assert((MAX_TILE_SITES & (MAX_TILE_SITES - 1)) == 0, "a power of two");

struct LabelGeometry {
  int Y, X;      // lattice
  int ysl, xsl;  // replica (Y, X: the full lattice)
  int ty, tx;    // tile
};

// rep * ysl * xsl + ym * xsl + xm for ym = y % ysl, xm = x % xsl
// (cluster.py:site_ids), without a division: (y / ysl) * (X / xsl) * ysl *
// xsl is (y - ym) * X, and (x / xsl) * ysl * xsl is (x - xm) * ysl.
__device__ __forceinline__ int site_id(const LabelGeometry& g, int y, int ym,
                                       int x, int xm) {
  return (y - ym) * g.X + ym * g.xsl + (x - xm) * g.ysl + xm;
}

// Phase 1's union-find order: a root is hooked under the other root of
// lower priority. Linking by index (row-major) would chain the runs of a
// tile's rows into trees as deep as the tile is high; a priority that
// scatters the indices (a bijection of [0, MAX_TILE_SITES): an odd
// multiplier modulo a power of two) keeps them shallow. Every hook puts a
// root under a root of lower priority at the time of the hook, so no hook
// closes a cycle. Phase 2 links by index, which makes the last root the
// least position (see the note above).
__device__ __forceinline__ int priority(int i) {
  return (int)(((unsigned)i * 40503u) & (MAX_TILE_SITES - 1));
}

// The root of i's tree, jumping each visited node to its grandparent on
// the way (Jaiganesh and Burtscher's ECL-CC). Only a root is ever hooked,
// and a node that is not a root never becomes one, so these plain stores
// never race with a hook; each stores an ancestor, which keeps the tree.
// Serves shared memory (phase 1) and device memory (phases 2 and 3).
__device__ __forceinline__ int find_root(volatile int* parent, int i) {
  int cur = parent[i];
  if (cur == i) return i;
  int prev = i, next;
  while ((next = parent[cur]) != cur) {
    parent[prev] = next;
    prev = cur;
    cur = next;
  }
  return cur;
}

// Join the trees of a and b: hook one root under the other with a
// compare-and-swap that succeeds only while it is a root; the root of
// higher priority (phase 1) or the larger root (kByIndex, phase 2) goes
// under.
template <bool kByIndex>
__device__ void unite(volatile int* parent, int a, int b) {
  a = find_root(parent, a);
  b = find_root(parent, b);
  while (a != b) {
    if (kByIndex ? a > b : priority(a) > priority(b)) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicCAS((int*)parent + b, b, a);
    if (old == b) return;
    b = find_root(parent, old);  // b was hooked meanwhile
    a = find_root(parent, a);
  }
}

__global__ void __launch_bounds__(MAX_THREADS, BLOCKS_PER_SM)
label_tile_roots_kernel(const uint8_t* __restrict__ open_r,
                        const uint8_t* __restrict__ open_d,
                        int* __restrict__ out, LabelGeometry g, int ids) {
  extern __shared__ int smem[];
  int* least = smem;                 // tile index -> position (or id)
  int* parent = smem + g.ty * g.tx;  // tile index -> union-find parent
  volatile int* vparent = parent;
  volatile int* vleast = least;
  const int y0 = blockIdx.y * g.ty, x0 = blockIdx.x * g.tx;
  const int h = min(g.ty, g.Y - y0), w = min(g.tx, g.X - x0);
  const int n = h * w;
  // Thread t takes the sites i = t + k * blockDim.x of rounds k = 0, 1, ...;
  // every thread runs the same rounds, so that the warp votes below see
  // all 32 lanes (lanes past the tile are inactive). (ly, lx) of its site
  // steps by (step_y, step_x) a round, without a division.
  const int rounds = (n + blockDim.x - 1) / blockDim.x;
  const int lane = threadIdx.x & 31;
  const int step_y = blockDim.x / w, step_x = blockDim.x - step_y * w;
  const int ly0 = threadIdx.x / w, lx0 = threadIdx.x - ly0 * w;
  // Bit k: this thread's site of round k has an open bond inside the tile
  // down (downs; across a replica wrap: down_wraps), across a replica wrap
  // to the right (wraps), or to the site before it that ends another
  // warp's run (seams).
  uint32_t downs = 0, down_wraps = 0, wraps = 0, seams = 0;

  // 1. each site's key; each run of sites joined along a row within a
  // warp's 32 sites is a star under its first site
  for (int k = 0, ly = ly0, lx = lx0; k < rounds; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    const uint32_t bit = 1u << k;
    const bool active = i < n;
    bool along = false;
    if (active) {
      const int y = y0 + ly, x = x0 + lx;
      // (no division on the full lattice)
      const int ym = g.ysl == g.Y ? y : y % g.ysl,
                xm = g.xsl == g.X ? x : x % g.xsl;
      const size_t s = (size_t)y * g.X + x;
      least[i] = ids ? site_id(g, y, ym, x, xm) : (int)s;
      // the neighbours right and down, wrapped within the replica
      const bool r_wrap = xm == g.xsl - 1, d_wrap = ym == g.ysl - 1;
      const int xr = r_wrap ? x + 1 - g.xsl : x + 1;
      const int yd = d_wrap ? y + 1 - g.ysl : y + 1;
      if (open_r[s] && xr >= x0 && xr < x0 + w) {
        if (r_wrap)
          wraps |= bit;
        else
          along = true;
      }
      if (open_d[s] && yd >= y0 && yd < y0 + h) {
        downs |= bit;
        if (d_wrap) down_wraps |= bit;
      }
      // lane 0: the site before it, along the row, is another warp's
      if (lane == 0 && lx > 0 && xm != 0 && open_r[s - 1]) seams |= bit;
    }
    // bit l: lane l's site is joined to lane l-1's, along the row
    const unsigned joined = __ballot_sync(0xffffffffu, along) << 1;
    const unsigned starts = ~joined & (0xffffffffu >> (31 - lane));
    if (active) parent[i] = i - lane + (31 - __clz(starts));
    lx += step_x;
    ly += step_y;
    if (lx >= w) {
      lx -= w;
      ++ly;
    }
  }
  __syncthreads();

  // 2. join the trees over the other open bonds inside the tile
  for (int k = 0; k < rounds; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    const uint32_t bit = 1u << k;
    if (downs & bit)
      unite<false>(vparent, i, down_wraps & bit ? i - (g.ysl - 1) * w : i + w);
    if (wraps & bit) unite<false>(vparent, i, i + 1 - g.xsl);
    if (seams & bit) unite<false>(vparent, i, i - 1);
  }
  __syncthreads();

  // 3. every site points at its root, the path to it with it. No more
  // hooks run, so roots are final and every store here stores one: none
  // can undo another's (find_root's grandparent stores could). Then each
  // root takes its component's least key.
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int r = i, p;
    while ((p = vparent[r]) != r) r = p;
    for (int c = i; c != r; c = p) {
      p = vparent[c];
      vparent[c] = r;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = parent[i];
    const int v = least[i];  // a site that is not a root is never written
    if (r != i && v < vleast[r]) atomicMin(least + r, v);
  }
  __syncthreads();

  // 4. every site takes its component's least key
  for (int k = 0, ly = ly0, lx = lx0; k < rounds; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < n) out[(size_t)(y0 + ly) * g.X + x0 + lx] = least[parent[i]];
    lx += step_x;
    ly += step_y;
    if (lx >= w) {
      lx -= w;
      ++ly;
    }
  }
}

__global__ void __launch_bounds__(HOOK_THREADS)
label_hook_kernel(const uint8_t* __restrict__ open_r,
                  const uint8_t* __restrict__ open_d, int* parent,
                  LabelGeometry g) {
  volatile int* vparent = parent;
  const int y0 = blockIdx.y * g.ty, x0 = blockIdx.x * g.tx;
  const int h = min(g.ty, g.Y - y0), w = min(g.tx, g.X - x0);
  // A right bond leaves the tile from its last column, or across the
  // first replica wrap of the tile (column cw) when the tile starts inside
  // a replica; a wrap further right lands inside the tile. Rows likewise.
  const int cw = g.xsl - 1 - x0 % g.xsl, rw = g.ysl - 1 - y0 % g.ysl;
  const int ncol = cw < w - 1 ? 2 : 1, nrow = rw < h - 1 ? 2 : 1;
  const int items = ncol * h + nrow * w;
  for (int k = threadIdx.x; k < items; k += blockDim.x) {
    int y, x, y2, x2;
    bool open;
    if (k < ncol * h) {  // a right bond
      y = y0 + (k < h ? k : k - h);
      x = x0 + (k < h ? w - 1 : cw);
      x2 = (x + 1) % g.xsl ? x + 1 : x + 1 - g.xsl;
      y2 = y;
      if (x2 >= x0 && x2 < x0 + w) continue;  // inside: phase 1 joined it
      open = open_r[(size_t)y * g.X + x];
    } else {  // a down bond
      const int j = k - ncol * h;
      y = y0 + (j < w ? h - 1 : rw);
      x = x0 + (j < w ? j : j - w);
      y2 = (y + 1) % g.ysl ? y + 1 : y + 1 - g.ysl;
      x2 = x;
      if (y2 >= y0 && y2 < y0 + h) continue;
      open = open_d[(size_t)y * g.X + x];
    }
    if (open) unite<true>(vparent, y * g.X + x, y2 * g.X + x2);
  }
}

// The root of i in device memory. Phase 3 starts from the finished forest
// (a kernel sees the stores of the kernels before it on its stream), and
// its only stores are roots, so whatever value a load returns, from L1 or
// not, is an ancestor of the node, itself only at a root: plain loads
// serve, cheaper than phase 2's volatile ones, which go to L2 each time.
__device__ __forceinline__ int root_of(const int* parent, int i) {
  int p;
  while ((p = parent[i]) != i) i = p;
  return i;
}

__global__ void __launch_bounds__(MAX_THREADS)
label_flatten_kernel(int* parent, int* labels, LabelGeometry g,
                     double inv_x) {
  extern __shared__ int memo[];  // tile index -> root of the site there
  volatile int* vmemo = memo;
  const int y0 = blockIdx.y * g.ty, x0 = blockIdx.x * g.tx;
  const int h = min(g.ty, g.Y - y0), w = min(g.tx, g.X - x0);
  const int n = h * w;
  const bool full = g.ysl == g.Y && g.xsl == g.X;
  // the sites of each thread, as in label_tile_roots_kernel
  const int rounds = (n + blockDim.x - 1) / blockDim.x;
  const int step_y = blockDim.x / w, step_x = blockDim.x - step_y * w;
  const int ly0 = threadIdx.x / w, lx0 = threadIdx.x - ly0 * w;
  for (int i = threadIdx.x; i < n; i += blockDim.x) memo[i] = -1;
  __syncthreads();
  // Nearly every site's parent is its tile root, a site of the same tile
  // (phase 2 moved only the parents of roots and of a few edge sites): one
  // thread a tile root finds its root and keeps it for the others (pass
  // 0), so the block chases each chain once, not once a site; then every
  // site takes its label (pass 1).
  for (int pass = 0; pass < 2; ++pass) {
    for (int k = 0, ly = ly0, lx = lx0; k < rounds; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      if (i < n) {
        const size_t s = (size_t)(y0 + ly) * g.X + x0 + lx;
        const int t = parent[s];
        // t's row and column: the reciprocal's quotient is off by at most
        // one (t < 2^31 loses nothing in a double)
        int ty = (int)(t * inv_x), tx = t - ty * g.X;
        if (tx < 0) {
          --ty;
          tx += g.X;
        } else if (tx >= g.X) {
          ++ty;
          tx -= g.X;
        }
        const int lt = ty >= y0 && ty < y0 + h && tx >= x0 && tx < x0 + w
                           ? (ty - y0) * w + tx - x0
                           : -1;
        if (pass == 0) {
          if (lt >= 0 && atomicCAS(memo + lt, -1, -2) == -1)
            vmemo[lt] = root_of(parent, t);
        } else {
          const int r = lt >= 0 ? vmemo[lt] : root_of(parent, t);
          if (full) {
            labels[s] = r;  // the id is the position; labels may be parent
          } else {
            const int ry = r / g.X, rx = r - ry * g.X;
            labels[s] = site_id(g, ry, ry % g.ysl, rx, rx % g.xsl);
          }
        }
      }
      lx += step_x;
      ly += step_y;
      if (lx >= w) {
        lx -= w;
        ++ly;
      }
    }
    __syncthreads();
  }
}

bool bad_geometry(int Y, int X, int ysl, int xsl) {
  return Y <= 0 || X <= 0 || ysl <= 0 || xsl <= 0 || Y % ysl || X % xsl ||
         (long long)Y * X >= (1LL << 31);
}

bool bad_tiles(int Y, int X, int ty, int tx) {
  return ty <= 0 || tx <= 0 || ty > Y || tx > X || ty * tx > MAX_TILE_SITES ||
         (Y + ty - 1) / ty > 65535;
}

}  // namespace

// Phase 1. open_r, open_d: (Y, X) bytes, 1 where the bond to the right /
// below is open; out: int32 (Y, X), not overlapping them, gets each site's
// least position in its tile component (ids != 0: its least site id).
// Tiles of (ty, tx) start at multiples of it; the last row and column of
// tiles may be short. Each launcher returns the launch's CUDA error code
// (cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int label_tile_roots_launch(const uint8_t* open_r,
                                       const uint8_t* open_d, int* out, int Y,
                                       int X, int ysl, int xsl, int ty,
                                       int tx, int ids, void* stream) {
  if (bad_geometry(Y, X, ysl, xsl) || bad_tiles(Y, X, ty, tx))
    return cudaErrorInvalidValue;
  const int sites = ty * tx;
  const int threads = min(MAX_THREADS, (sites + 31) / 32 * 32);
  const size_t smem = 2 * sizeof(int) * sites;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        label_tile_roots_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(2 * sizeof(int) * MAX_TILE_SITES));
    if (e != cudaSuccess) return e;
  }
  const LabelGeometry g{Y, X, ysl, xsl, ty, tx};
  label_tile_roots_kernel<<<dim3((X + tx - 1) / tx, (Y + ty - 1) / ty),
                            threads, smem, (cudaStream_t)stream>>>(
      open_r, open_d, out, g, ids);
  return cudaGetLastError();
}

// Phase 2. parent: int32 (Y, X), phase 1's positions; hooked in place over
// the open bonds that leave a tile of (ty, tx).
extern "C" int label_hook_launch(const uint8_t* open_r, const uint8_t* open_d,
                                 int* parent, int Y, int X, int ysl, int xsl,
                                 int ty, int tx, void* stream) {
  if (bad_geometry(Y, X, ysl, xsl) || bad_tiles(Y, X, ty, tx))
    return cudaErrorInvalidValue;
  const LabelGeometry g{Y, X, ysl, xsl, ty, tx};
  label_hook_kernel<<<dim3((X + tx - 1) / tx, (Y + ty - 1) / ty),
                      HOOK_THREADS, 0, (cudaStream_t)stream>>>(open_r, open_d,
                                                               parent, g);
  return cudaGetLastError();
}

// Phase 3. labels: int32 (Y, X), the site id of each site's root in
// parent, by tiles of (ty, tx) as phase 1's; on the full lattice labels
// may be parent itself (in place), elsewhere it must not overlap it.
extern "C" int label_flatten_launch(int* parent, int* labels, int Y, int X,
                                    int ysl, int xsl, int ty, int tx,
                                    void* stream) {
  if (bad_geometry(Y, X, ysl, xsl) || bad_tiles(Y, X, ty, tx) ||
      (labels == parent && (ysl != Y || xsl != X)))
    return cudaErrorInvalidValue;
  const int sites = ty * tx;
  const int threads = min(MAX_THREADS, (sites + 31) / 32 * 32);
  const size_t smem = sizeof(int) * sites;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        label_flatten_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(sizeof(int) * MAX_TILE_SITES));
    if (e != cudaSuccess) return e;
  }
  const LabelGeometry g{Y, X, ysl, xsl, ty, tx};
  label_flatten_kernel<<<dim3((X + tx - 1) / tx, (Y + ty - 1) / ty), threads,
                         smem, (cudaStream_t)stream>>>(parent, labels, g,
                                                       1.0 / X);
  return cudaGetLastError();
}
