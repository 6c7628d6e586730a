// One pass of the tiled cluster labeler of the Swendsen-Wang update.
//
// Replaces ising_tpu/cluster.py:_local_pass_kernel (the Pallas kernel of
// label_clusters_tiled). A labeling gives every site the minimum site id
// of its connected component under the open bonds, periodic in both axes
// or within its replica. A pass of this kernel, one block per (ty, tx)
// tile of the lattice:
//   1. reads each site's label from lab_in (the site id when lab_in is
//      null) and takes the minimum with the labels across its open bonds
//      that leave the tile (the tile edges and the periodic or replica
//      wraps), read from lab_in too;
//   2. joins the sites of every open bond inside the tile (a replica wrap
//      inside the tile included) in a union-find in shared memory: each
//      run of sites joined along a row within a warp's 32 sites becomes a
//      star under its first site (one warp vote), and the other bonds hook
//      one root under the other with a compare-and-swap, in an order that
//      keeps the trees shallow, finds jumping pointers to their
//      grandparents (ECL-CC);
//   3. takes each component's minimum label at its root (atomicMin) and
//      writes it to every site of the component in lab_out;
//   4. sets *changed to 1 when any site's label went down.
// The result is the unique tile-local fixpoint of the Pallas kernel's
// relaxation, whatever order the atomics take, so a pass is deterministic
// and equals cluster.py:local_pass_reference bit for bit. The host
// ping-pongs lab_in and lab_out between passes, so no pass reads what
// another block of it writes.
//
// Bound: a labeling must read the two bond planes once (1 B a site each)
// and write the labels once (4 B): 6 B a site, 30.0 us at 4096^2 and
// 480.8 us at 16384^2 at 3.35 TB/s; its operations (a few per site) take
// far less. A pass moves about 10 B a site (labels in and out, the bonds),
// and the labeling takes as many passes as tile edges lie on the longest
// path a cluster's least label must travel. The design converges each
// tile in one pass, with no relaxation rounds inside it, keeps the trees
// shallow (stars along rows, pointer jumping) so that the shared-memory
// work stays under the memory time, and takes tiles as large as three
// blocks an SM allow (8192 sites; 16384 for one 128 x 128 replica).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_TILE_SITES = 16384;  // cluster.py:MAX_TILE_SITES
constexpr int MAX_THREADS = 512;
constexpr int BLOCKS_PER_SM = 3;  // 64 KB tiles: three fit an SM's 227 KB
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

__device__ __forceinline__ int label_at(const int* lab, const LabelGeometry& g,
                                        int y, int ym, int x, int xm) {
  return lab ? lab[(size_t)y * g.X + x] : site_id(g, y, ym, x, xm);
}

// Union-find order: a root is hooked under the other root of lower
// priority. Linking by index (row-major) would chain the runs of a tile's
// rows into trees as deep as the tile is high; a priority that scatters the
// indices (a bijection of [0, MAX_TILE_SITES): an odd multiplier modulo a
// power of two) keeps them shallow. Every hook puts a root under a root of
// lower priority at the time of the hook, so no hook closes a cycle.
__device__ __forceinline__ int priority(int i) {
  return (int)(((unsigned)i * 40503u) & (MAX_TILE_SITES - 1));
}

// The root of i's tree, jumping each visited node to its grandparent on
// the way (Jaiganesh and Burtscher's ECL-CC). Only a root is ever hooked,
// and a node that is not a root never becomes one, so these plain stores
// never race with a hook; each stores an ancestor, which keeps the tree.
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

// Join the trees of a and b: hook the root of higher priority under the
// other with a compare-and-swap that succeeds only while it is a root.
__device__ void unite(volatile int* parent, int a, int b) {
  a = find_root(parent, a);
  b = find_root(parent, b);
  while (a != b) {
    if (priority(a) > priority(b)) {
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
cluster_label_kernel(const int* __restrict__ lab_in,
                     const uint8_t* __restrict__ open_r,
                     const uint8_t* __restrict__ open_d,
                     int* __restrict__ lab_out, int* __restrict__ changed,
                     LabelGeometry g) {
  extern __shared__ int smem[];
  int* label = smem;                 // tile index -> label
  int* parent = smem + g.ty * g.tx;  // tile index -> union-find parent
  volatile int* vparent = parent;
  volatile int* vlabel = label;
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
  int went_down = 0;

  // 1. labels, pulled across the open bonds that leave the tile; each
  // run of sites joined along a row within a warp's 32 sites is a star
  // under its first site
  for (int k = 0, ly = ly0, lx = lx0; k < rounds; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    const uint32_t bit = 1u << k;
    const bool active = i < n;
    bool along = false;
    if (active) {
      const int y = y0 + ly, x = x0 + lx;
      const int ym = y % g.ysl, xm = x % g.xsl;
      const size_t s = (size_t)y * g.X + x;
      const int own = label_at(lab_in, g, y, ym, x, xm);
      int lab = own;
      // the four neighbours, wrapped within the replica
      const bool r_wrap = xm == g.xsl - 1, l_wrap = xm == 0;
      const bool d_wrap = ym == g.ysl - 1, u_wrap = ym == 0;
      const int xr = r_wrap ? x + 1 - g.xsl : x + 1;
      const int xl = l_wrap ? x - 1 + g.xsl : x - 1;
      const int yd = d_wrap ? y + 1 - g.ysl : y + 1;
      const int yu = u_wrap ? y - 1 + g.ysl : y - 1;
      if (open_r[s]) {
        if (xr < x0 || xr >= x0 + w)
          lab = min(lab, label_at(lab_in, g, y, ym, xr, r_wrap ? 0 : xm + 1));
        else if (r_wrap)
          wraps |= bit;
        else
          along = true;
      }
      if (open_d[s]) {
        if (yd >= y0 && yd < y0 + h) {
          downs |= bit;
          if (d_wrap) down_wraps |= bit;
        } else {
          lab = min(lab, label_at(lab_in, g, yd, d_wrap ? 0 : ym + 1, x, xm));
        }
      }
      if ((xl < x0 || xl >= x0 + w) && open_r[(size_t)y * g.X + xl])
        lab = min(lab, label_at(lab_in, g, y, ym, xl,
                                l_wrap ? g.xsl - 1 : xm - 1));
      if ((yu < y0 || yu >= y0 + h) && open_d[(size_t)yu * g.X + x])
        lab = min(lab, label_at(lab_in, g, yu, u_wrap ? g.ysl - 1 : ym - 1,
                                x, xm));
      // lane 0: the site before it, along the row, is another warp's
      if (lane == 0 && lx > 0 && !l_wrap && open_r[s - 1]) seams |= bit;
      went_down |= lab < own;
      label[i] = lab;
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
      unite(vparent, i, down_wraps & bit ? i - (g.ysl - 1) * w : i + w);
    if (wraps & bit) unite(vparent, i, i + 1 - g.xsl);
    if (seams & bit) unite(vparent, i, i - 1);
  }
  __syncthreads();

  // 3. every site points at its root, the path to it with it. No more
  // hooks run, so roots are final and every store here stores one: none
  // can undo another's (find_root's grandparent stores could).
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int r = i, p;
    while ((p = vparent[r]) != r) r = p;
    for (int c = i; c != r; c = p) {
      p = vparent[c];
      vparent[c] = r;
    }
    went_down |= label[i] < label[r];  // the root's label will go down
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = parent[i];
    const int v = label[i];  // a site that is not a root is never written
    if (r != i && v < vlabel[r]) atomicMin(label + r, v);
  }
  __syncthreads();

  // 4. every site takes its component's minimum
  for (int k = 0, ly = ly0, lx = lx0; k < rounds; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < n) {
      const int r = parent[i];
      const int out = label[r];
      if (r != i) went_down |= out < label[i];
      lab_out[(size_t)(y0 + ly) * g.X + x0 + lx] = out;
    }
    lx += step_x;
    ly += step_y;
    if (lx >= w) {
      lx -= w;
      ++ly;
    }
  }
  if (__syncthreads_or(went_down) && threadIdx.x == 0) *changed = 1;
}

}  // namespace

// lab_in: int32 (Y, X) labels, or null for the site ids; open_r, open_d:
// (Y, X) bytes, 1 where the bond to the right / below is open; lab_out:
// int32 (Y, X), not overlapping lab_in; changed: one int32, set to 1 if a
// label went down. Tiles of (ty, tx) start at multiples of it; the last
// row and column of tiles may be short. Returns the launch's CUDA error
// code (cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int cluster_label_launch(const int* lab_in, const uint8_t* open_r,
                                    const uint8_t* open_d, int* lab_out,
                                    int* changed, int Y, int X, int ysl,
                                    int xsl, int ty, int tx, void* stream) {
  if (Y <= 0 || X <= 0 || ysl <= 0 || xsl <= 0 || Y % ysl || X % xsl ||
      (long long)Y * X >= (1LL << 31) || ty <= 0 || tx <= 0 || ty > Y ||
      tx > X || ty * tx > MAX_TILE_SITES)
    return cudaErrorInvalidValue;
  const int gx = (X + tx - 1) / tx, gy = (Y + ty - 1) / ty;
  if (gy > 65535) return cudaErrorInvalidValue;
  const int sites = ty * tx;
  const int threads = min(MAX_THREADS, (sites + 31) / 32 * 32);
  const size_t smem = 2 * sizeof(int) * sites;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cluster_label_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(2 * sizeof(int) * MAX_TILE_SITES));
    if (e != cudaSuccess) return e;
  }
  const LabelGeometry g{Y, X, ysl, xsl, ty, tx};
  cluster_label_kernel<<<dim3(gx, gy), threads, smem,
                         (cudaStream_t)stream>>>(lab_in, open_r, open_d,
                                                 lab_out, changed, g);
  return cudaGetLastError();
}
