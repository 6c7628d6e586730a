// One checkerboard color half-sweep of the 1-bit (bit1) Ising lattice, for
// Hopper (sm_90a), in the u32-draw rng modes. Replaces the u32 path of the
// TPU kernel ising_tpu/ops/pallas_bit1.py:_bit1_kernel (:426-458: Philox,
// Threefry and ChaCha counter modes, T > 0 and the greedy T <= 0 quench),
// with its quenched-disorder links and sub-lattice replica wraps (:290-363,
// :511-517), which live in load_site (bit1_common.cuh) and so serve both
// kernels. The bit-plane modes are in bit1_planes.cu.
//
// Layout: a color plane is (H, W1) 32-bit words; bit g of word (y, j) is the
// spin at compact column c = g*W1 + j. One thread owns one word: it reads its
// own dst word and the src words around it, draws the 32 spins' uniforms,
// and writes dst in place. No thread reads another thread's dst word, so the
// in-place update is race-free (the wrapper refuses dst/src overlap).
//
// What bounds it: per color phase the lattice moves 3 words per 32 spins
// (read dst, read src, write dst: 0.375 B per spin update), while the
// generator costs 16 Threefry, 8 Philox or 2 ChaCha calls per word: 866
// (Threefry-13), 490 (Philox-10) or 912 (ChaCha-8) 32-bit integer
// operations per word (chip_smoke.py:ops_per_word). At 16384^2 that is
// 50 MB of traffic against 2-4e9 integer operations, so the integer pipes
// bound it, not HBM. Disorder adds 4 link words read per word (7 words
// moved, 117 MB), still under the operation bound of every mode. The design therefore keeps every operand in registers
// (no shared memory), unrolls the generator completely for the round count
// (a template parameter), and uses the hardware __umulhi for Philox and
// funnel shifts for the rotations. Neighbouring threads take neighbouring j,
// so every load and the store coalesce.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared -Xcompiler -fPIC
// (see ising_tpu_torch/ops/kernel_lib.py). The C entry point below returns
// cudaGetLastError() after the launch.

#include "bit1_common.cuh"

namespace {

using namespace ising;

// Set bit g of the accept words from one spin's draw (unsigned compares,
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
                  uint32_t k1, Geometry geo) {
  Site s;
  if (!load_site(dst, src, src_up, src_dn, H, W1, color, geo, s)) return;
  const Classes cls = neighbour_classes(s);
  const uint32_t gy = row0 + static_cast<uint32_t>(s.y);
  const uint32_t w1 = static_cast<uint32_t>(W1);
  const uint32_t j = static_cast<uint32_t>(s.j);
  uint32_t p0 = 0, p4 = 0, p8 = 0;
  if constexpr (FAMILY == FAMILY_PHILOX) {
    // nq = 8*W1 counters per row; counter s*W1 + j serves bits s, s+8,
    // s+16 and s+24 (output word g / 8 for bit g).
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint64_t q = counter(gy, 8u * w1, k * w1 + j);
      const uint4 o = philox<R>(static_cast<uint32_t>(q),
                                static_cast<uint32_t>(q >> 32), step, tag, k0, k1);
      accept_bits<GREEDY>(o.x, k, thr7, thr8, thr9, p0, p4, p8);
      accept_bits<GREEDY>(o.y, k + 8, thr7, thr8, thr9, p0, p4, p8);
      accept_bits<GREEDY>(o.z, k + 16, thr7, thr8, thr9, p0, p4, p8);
      accept_bits<GREEDY>(o.w, k + 24, thr7, thr8, thr9, p0, p4, p8);
    }
  } else if constexpr (FAMILY == FAMILY_THREEFRY) {
    // nq = 16*W1 counters per row under the per-(step, tag) stream key
    // (k0, k1); counter s*W1 + j serves bits s and s+16.
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const uint64_t q = counter(gy, 16u * w1, k * w1 + j);
      const uint2 o = threefry<R>(static_cast<uint32_t>(q),
                                  static_cast<uint32_t>(q >> 32), k0, k1);
      accept_bits<GREEDY>(o.x, k, thr7, thr8, thr9, p0, p4, p8);
      accept_bits<GREEDY>(o.y, k + 16, thr7, thr8, thr9, p0, p4, p8);
    }
  } else {
    // ChaCha (rng.chacha_color_draws): nq = 2*W1 blocks per row, 16 slots
    // of width 2*W1; block s*W1 + j serves bits 2*o + s (output word o).
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const uint64_t q = counter(gy, 2u * w1, k * w1 + j);
      uint32_t o[16];
      chacha<R>(static_cast<uint32_t>(q), static_cast<uint32_t>(q >> 32),
                step, tag, k0, k1, o);
#pragma unroll
      for (int w = 0; w < 16; ++w) {
        accept_bits<GREEDY>(o[w], 2 * w + k, thr7, thr8, thr9, p0, p4, p8);
      }
    }
  }
  dst[s.idx] = s.me ^ flip_mask<GREEDY>(cls, p0, p4, p8);
}

template <int FAMILY, int R>
void launch(bool greedy, dim3 grid, cudaStream_t stream, uint32_t* dst,
            const uint32_t* src, const uint32_t* up, const uint32_t* dn, int H,
            int W1, uint32_t row0, uint32_t step, uint32_t tag, int color,
            uint32_t thr7, uint32_t thr8, uint32_t thr9, uint32_t k0,
            uint32_t k1, const Geometry& geo) {
  if (greedy) {
    bit1_sweep_kernel<FAMILY, R, true><<<grid, 256, 0, stream>>>(
        dst, src, up, dn, H, W1, row0, step, tag, color, thr7, thr8, thr9, k0,
        k1, geo);
  } else {
    bit1_sweep_kernel<FAMILY, R, false><<<grid, 256, 0, stream>>>(
        dst, src, up, dn, H, W1, row0, step, tag, color, thr7, thr8, thr9, k0,
        k1, geo);
  }
}

using Launch = void (*)(bool, dim3, cudaStream_t, uint32_t*, const uint32_t*,
                        const uint32_t*, const uint32_t*, int, int, uint32_t,
                        uint32_t, uint32_t, int, uint32_t, uint32_t, uint32_t,
                        uint32_t, uint32_t, const Geometry&);

// The (family, rounds) pairs of the u32 rng modes (ising_tpu/rng.py:99-113).
Launch find_launch(int family, int rounds) {
  if (family == FAMILY_PHILOX && rounds == 10) return launch<FAMILY_PHILOX, 10>;
  if (family == FAMILY_PHILOX && rounds == 7) return launch<FAMILY_PHILOX, 7>;
  if (family == FAMILY_THREEFRY && rounds == 20) return launch<FAMILY_THREEFRY, 20>;
  if (family == FAMILY_THREEFRY && rounds == 13) return launch<FAMILY_THREEFRY, 13>;
  if (family == FAMILY_CHACHA && rounds == 8) return launch<FAMILY_CHACHA, 8>;
  if (family == FAMILY_CHACHA && rounds == 6) return launch<FAMILY_CHACHA, 6>;
  if (family == FAMILY_CHACHA && rounds == 4) return launch<FAMILY_CHACHA, 4>;
  return nullptr;
}

}  // namespace

// Launch one half-sweep on `stream`. family: 0 = Philox and 2 = ChaCha
// (k0, k1 = seed lo, hi), 1 = Threefry (k0, k1 = threefry_stream_key(seed,
// step, tag)). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a (family, rounds) pair that is not instantiated
// here, a shape the grid cannot cover or a geometry the kernel does not take.
// l0..l3, link_mode, csl, ysl: the Geometry of bit1_common.cuh (0 for none).
extern "C" int bit1_sweep_launch(void* dst, const void* src, const void* src_up,
                                 const void* src_dn, int H, int W1,
                                 uint32_t row0, uint32_t step, uint32_t tag,
                                 int color, uint32_t thr7, uint32_t thr8,
                                 uint32_t thr9, uint32_t k0, uint32_t k1,
                                 int family, int rounds, int greedy,
                                 const void* l0, const void* l1, const void* l2,
                                 const void* l3, int link_mode, int csl, int ysl,
                                 void* stream) {
  dim3 grid;
  Geometry geo;
  const Launch fn = find_launch(family, rounds);
  if (fn == nullptr || !grid_for(H, W1, grid) ||
      !make_geometry(l0, l1, l2, l3, link_mode, csl, ysl, H, W1, geo)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  fn(greedy != 0, grid, static_cast<cudaStream_t>(stream),
     static_cast<uint32_t*>(dst), static_cast<const uint32_t*>(src),
     static_cast<const uint32_t*>(src_up), static_cast<const uint32_t*>(src_dn),
     H, W1, row0, step, tag, color, thr7, thr8, thr9, k0, k1, geo);
  return static_cast<int>(cudaGetLastError());
}

// Text of a CUDA error code, for the wrapper's exception message.
extern "C" const char* ising_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
