// One checkerboard color half-sweep of the 1-bit (bit1) Ising lattice, for
// Hopper (sm_90a). Replaces the u32-draw path of the TPU kernel
// ising_tpu/ops/pallas_bit1.py:_bit1_kernel (Philox and Threefry counter
// modes, T > 0 and the greedy T <= 0 quench), with the counter generators of
// ising_tpu/ops/pallas_packed.py (_draw_counters, _philox_draw_block,
// _threefry_draw_block) as __device__ functions.
//
// Layout: a color plane is (H, W1) 32-bit words; bit g of word (y, j) is the
// spin at compact column c = g*W1 + j. One thread owns one word: it reads its
// own dst word and the src words around it, draws the 32 spins' uniforms,
// and writes dst in place. No thread reads another thread's dst word, so the
// in-place update is race-free (the wrapper refuses dst/src overlap).
//
// What bounds it: per color phase the lattice moves 3 words per 32 spins
// (read dst, read src, write dst: 0.375 B per spin update), while the
// generator costs 16 Threefry or 8 Philox calls per word: 866 (Threefry-13)
// or 498 (Philox-10) 32-bit integer operations per word, 27 or 16 per spin
// (chip_smoke.py:ops_per_word). At 16384^2 that is 50 MB of traffic against
// 3.6e9 or 2.1e9 integer operations, so the integer pipes bound it, not
// HBM. On an H100 SXM at 700 W the Threefry-13 build is held by the ALU
// pipe: its 791 ALU-pipe instructions per word, at 64 lanes per SM, need
// 0.198 ms of the kernel's 0.206 ms per phase (chip_smoke.py phase 6).
// The design therefore keeps every operand in registers (no shared memory),
// unrolls the generator completely for the round count (a template
// parameter), and uses the hardware __umulhi for Philox and funnel shifts
// for Threefry's rotations. Neighbouring threads take neighbouring j, so
// every load and the store coalesce.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared -Xcompiler -fPIC
// (see ising_tpu_torch/ops/kernel_lib.py). The C entry point below returns
// cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t PHILOX_M0 = 0xD2511F53u;
constexpr uint32_t PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u;
constexpr uint32_t PHILOX_W1 = 0xBB67AE85u;

constexpr int FAMILY_PHILOX = 0;
constexpr int FAMILY_THREEFRY = 1;

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

// Set bit g of the accept planes from one spin's draw (unsigned compares,
// accept <=> draw <= threshold, as every backend of the JAX package does).
template <bool GREEDY>
__device__ __forceinline__ void accept_bits(uint32_t d, int g, uint32_t thr7,
                                            uint32_t thr8, uint32_t thr9,
                                            uint32_t& p0, uint32_t& p4,
                                            uint32_t& p8) {
  p4 |= static_cast<uint32_t>(d <= thr8) << g;
  p8 |= static_cast<uint32_t>(d <= thr9) << g;
  if constexpr (GREEDY) p0 |= static_cast<uint32_t>(d <= thr7) << g;
}

template <int FAMILY, int R, bool GREEDY>
__global__ void __launch_bounds__(256)
bit1_sweep_kernel(uint32_t* __restrict__ dst, const uint32_t* __restrict__ src,
                  const uint32_t* __restrict__ src_up,
                  const uint32_t* __restrict__ src_dn, int H, int W1,
                  uint32_t row0, uint32_t step, uint32_t tag, int color,
                  uint32_t thr7, uint32_t thr8, uint32_t thr9, uint32_t k0,
                  uint32_t k1) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(H) * W1) return;
  const int y = static_cast<int>(idx / W1);
  const int j = static_cast<int>(idx - static_cast<int64_t>(y) * W1);
  const uint32_t* row = src + static_cast<int64_t>(y) * W1;

  // Neighbour words (pallas_bit1.py:279-310). The off-column neighbour of
  // compact column c is c-1 or c+1: lane j-1 / j+1 of the same bit, and at
  // the row's first / last lane the word one bit over (a 1-bit rotation).
  const uint32_t me = dst[idx];
  const uint32_t same = row[j];
  const uint32_t up = y == 0 ? src_up[j] : row[j - W1];
  const uint32_t dn = y == H - 1 ? src_dn[j] : row[j + W1];
  const uint32_t left = j == 0 ? rotl(row[W1 - 1], 1) : row[j - 1];
  const uint32_t right = j == W1 - 1 ? rotl(row[0], 31) : row[j + 1];
  const bool odd = y & 1;
  const uint32_t off = (color == 0) == odd ? right : left;

  // Bit-sliced neighbour count n = n2 n1 n0 (pallas_bit1.py:117-128) and
  // the classes of the mirrored count e = b ? n : 4 - n (:131-143).
  const uint32_t t0 = up ^ dn, c0 = up & dn;
  const uint32_t t1 = same ^ off, c1 = same & off;
  const uint32_t n0 = t0 ^ t1, c2 = t0 & t1;
  const uint32_t n1 = c0 ^ c1 ^ c2;
  const uint32_t n2 = (c0 & c1) | (c2 & (c0 ^ c1));
  const uint32_t n_ge3 = n2 | (n1 & n0);
  const uint32_t n_le1 = ~(n2 | n1);
  const uint32_t n_eq0 = n_le1 & ~n0;
  const uint32_t ge3 = (me & n_ge3) | (~me & n_le1);
  const uint32_t ge4 = (me & n2) | (~me & n_eq0);
  const uint32_t eq2 = ~n2 & n1 & ~n0;

  // Draws. Global row gy = row0 + y wraps mod 2^32 like the JAX package's
  // uint32 row index; the 64-bit counter keeps its carry into the high word.
  const uint32_t gy = row0 + static_cast<uint32_t>(y);
  uint32_t p0 = 0, p4 = 0, p8 = 0;
  if constexpr (FAMILY == FAMILY_PHILOX) {
    // nq = 8*W1 counters per row; counter s*W1 + j serves bits s, s+8,
    // s+16 and s+24 (output word g / 8 for bit g).
    const uint64_t base = static_cast<uint64_t>(gy) * (8u * static_cast<uint32_t>(W1)) + j;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const uint64_t q = base + static_cast<uint64_t>(s) * W1;
      const uint4 o = philox<R>(static_cast<uint32_t>(q),
                                static_cast<uint32_t>(q >> 32), step, tag, k0, k1);
      accept_bits<GREEDY>(o.x, s, thr7, thr8, thr9, p0, p4, p8);
      accept_bits<GREEDY>(o.y, s + 8, thr7, thr8, thr9, p0, p4, p8);
      accept_bits<GREEDY>(o.z, s + 16, thr7, thr8, thr9, p0, p4, p8);
      accept_bits<GREEDY>(o.w, s + 24, thr7, thr8, thr9, p0, p4, p8);
    }
  } else {
    // nq = 16*W1 counters per row under the per-(step, tag) stream key
    // (k0, k1); counter s*W1 + j serves bits s and s+16.
    const uint64_t base = static_cast<uint64_t>(gy) * (16u * static_cast<uint32_t>(W1)) + j;
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      const uint64_t q = base + static_cast<uint64_t>(s) * W1;
      const uint2 o = threefry<R>(static_cast<uint32_t>(q),
                                  static_cast<uint32_t>(q >> 32), k0, k1);
      accept_bits<GREEDY>(o.x, s, thr7, thr8, thr9, p0, p4, p8);
      accept_bits<GREEDY>(o.y, s + 16, thr7, thr8, thr9, p0, p4, p8);
    }
  }

  // Accept (pallas_bit1.py:444-458): e < 2 always flips; e == 3 and e == 4
  // flip on their thresholds; the greedy quench coin-flips e == 2 on thr7.
  uint32_t flip;
  if constexpr (GREEDY) {
    flip = (~ge3 & ~eq2) | (eq2 & p0) | (ge3 & ~ge4 & p4) | (ge4 & p8);
  } else {
    flip = ~ge3 | (ge3 & ~ge4 & p4) | (ge4 & p8);
  }
  dst[idx] = me ^ flip;
}

template <int FAMILY, int R>
void launch(bool greedy, dim3 grid, cudaStream_t stream, uint32_t* dst,
            const uint32_t* src, const uint32_t* up, const uint32_t* dn, int H,
            int W1, uint32_t row0, uint32_t step, uint32_t tag, int color,
            uint32_t thr7, uint32_t thr8, uint32_t thr9, uint32_t k0,
            uint32_t k1) {
  if (greedy) {
    bit1_sweep_kernel<FAMILY, R, true><<<grid, 256, 0, stream>>>(
        dst, src, up, dn, H, W1, row0, step, tag, color, thr7, thr8, thr9, k0, k1);
  } else {
    bit1_sweep_kernel<FAMILY, R, false><<<grid, 256, 0, stream>>>(
        dst, src, up, dn, H, W1, row0, step, tag, color, thr7, thr8, thr9, k0, k1);
  }
}

}  // namespace

// Launch one half-sweep on `stream`. family: 0 = Philox (k0, k1 = seed lo,
// hi), 1 = Threefry (k0, k1 = threefry_stream_key(seed, step, tag)).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a (family, rounds) pair that is not instantiated here.
extern "C" int bit1_sweep_launch(void* dst, const void* src, const void* src_up,
                                 const void* src_dn, int H, int W1,
                                 uint32_t row0, uint32_t step, uint32_t tag,
                                 int color, uint32_t thr7, uint32_t thr8,
                                 uint32_t thr9, uint32_t k0, uint32_t k1,
                                 int family, int rounds, int greedy,
                                 void* stream) {
  const int64_t words = static_cast<int64_t>(H) * W1;
  if (H <= 0 || W1 <= 0 || (words + 255) / 256 > 0x7FFFFFFF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>((words + 255) / 256));
  auto* d = static_cast<uint32_t*>(dst);
  auto* s = static_cast<const uint32_t*>(src);
  auto* u = static_cast<const uint32_t*>(src_up);
  auto* n = static_cast<const uint32_t*>(src_dn);
  auto st = static_cast<cudaStream_t>(stream);
  const bool g = greedy != 0;
  if (family == FAMILY_PHILOX && rounds == 10) {
    launch<FAMILY_PHILOX, 10>(g, grid, st, d, s, u, n, H, W1, row0, step, tag, color, thr7, thr8, thr9, k0, k1);
  } else if (family == FAMILY_PHILOX && rounds == 7) {
    launch<FAMILY_PHILOX, 7>(g, grid, st, d, s, u, n, H, W1, row0, step, tag, color, thr7, thr8, thr9, k0, k1);
  } else if (family == FAMILY_THREEFRY && rounds == 20) {
    launch<FAMILY_THREEFRY, 20>(g, grid, st, d, s, u, n, H, W1, row0, step, tag, color, thr7, thr8, thr9, k0, k1);
  } else if (family == FAMILY_THREEFRY && rounds == 13) {
    launch<FAMILY_THREEFRY, 13>(g, grid, st, d, s, u, n, H, W1, row0, step, tag, color, thr7, thr8, thr9, k0, k1);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Text of a CUDA error code, for the wrapper's exception message.
extern "C" const char* ising_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
