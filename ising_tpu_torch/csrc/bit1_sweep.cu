// One checkerboard color half-sweep of the 1-bit (bit1) Ising lattice, for
// Hopper (sm_90a), in the u32-draw rng modes. Replaces the u32 path of the
// TPU kernel ising_tpu/ops/pallas_bit1.py:_bit1_kernel (:426-458: Philox,
// Threefry and ChaCha counter modes, T > 0 and the greedy T <= 0 quench),
// with its quenched-disorder links and sub-lattice replica wraps (:290-363,
// :511-517), which live in the row walk of bit1_common.cuh and so serve
// both kernels. The bit-plane modes are in bit1_planes.cu.
//
// Layout and walk: bit1_common.cuh. A thread walks a band of rows down its
// word column; for each row it draws the 32 spins' uniforms and writes its
// dst word in place.
//
// What bounds it: per color phase the lattice moves 3 words per 32 spins
// (read dst, read src, write dst: 0.375 B per spin update; 7 words with the
// four link planes), 0.015 ms at 16384^2, while the generator costs 16
// Threefry, 8 Philox or 2 ChaCha calls per word: 851 (Threefry-13), 475
// (Philox-10) or 897 (ChaCha-8) 32-bit integer operations per word with the
// accept (chip_smoke.py:ops_per_word), so the integer pipes bound it, not
// HBM. The ALU pipe (64 lanes an SM, half the integer issue rate) runs most
// of them. With one thread a word and no loop, the SASS spends 160-168
// static ALU instructions a word on its index (a 64-bit division), loads and
// edge selects and 158 on the accept's 64 compares (907 ALU / 324 FMA a word
// in Threefry-13, 525 / 296 in Philox-10). The walk takes the first to a
// few a word; the accept sets each bit by a compare whose predicate guards
// an xor (flip_if_le: 2 ALU a compare), in Threefry by two FMA-pipe
// multiply-adds instead (add_if_gt), beside its round adds there
// (threefry_fma), since its rotations and xors keep the ALU pipe the
// busier. Every operand stays in registers (no shared memory) and the
// generator is unrolled for its round count (a template parameter). A row's
// counter is one 32 x 32 -> 64-bit multiply-add a call on the FMA pipe,
// exact where the global row wraps mod 2^32. Measured on an H100 (the main
// loop's SASS, a word): Threefry-13 545.5 ALU / 483 FMA, at 77% of its
// ALU-pipe time; ChaCha-8 629 / 232 and ChaCha-6 501 / 168.5, at 90%;
// Philox-10 306.5 / 193, at 58%: its 160 wide multiplies a word, not the
// ALU, set its time (chip_smoke.py phase 6; PERF.md).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared -Xcompiler -fPIC
// (see ising_tpu_torch/ops/kernel_lib.py). The C entry point below returns
// cudaGetLastError() after the launch.

#include "bit1_common.cuh"

namespace {

using namespace ising;

// One color phase's draws and thresholds: the step, the tag (TAG_SWEEP |
// color), the key (seed lo, hi; Threefry: its stream key), the u32
// thresholds of e == 2 (greedy), e == 3 and e == 4, and `one` (1, a kernel
// argument: adds on the FMA pipe).
struct Draws {
  uint32_t step, tag, k0, k1;
  uint32_t thr7, thr8, thr9;
  uint32_t one;
};

// Whether a family's accept runs on the FMA pipe (add_if_gt: the words
// collect d > threshold, the complement of the accept): Threefry, whose
// rotations and xors keep the ALU pipe the busier one. Philox's pipe is its
// wide multiplies' and ChaCha's work is balanced already: there the compare
// sets its bit on the ALU pipe (flip_if_le). Measured on an H100 at 16384^2
// (chip_smoke.py --turns, PERF.md), flip_if_le in Threefry takes 1.043x
// (Threefry-13) and 1.029x (Threefry-20) add_if_gt's time at T > 0, 1.060x
// with split links, but 0.964x / 1.009x in the greedy quench.
template <int FAMILY>
__host__ __device__ constexpr bool fma_accept() {
  return FAMILY == FAMILY_THREEFRY;
}

// Sets bit g of the accept words from one spin's draw (unsigned compares,
// accept <=> draw <= threshold, as every backend of the JAX package does),
// or with fma_accept the bit of the complement.
template <int FAMILY, bool GREEDY>
__device__ __forceinline__ void accept_bits(uint32_t d, int g, const Draws& dr,
                                            uint32_t& p0, uint32_t& p4, uint32_t& p8) {
  if constexpr (fma_accept<FAMILY>()) {
    add_if_gt(p4, d, dr.thr8, 1u << g, dr.one);
    add_if_gt(p8, d, dr.thr9, 1u << g, dr.one);
    if constexpr (GREEDY) add_if_gt(p0, d, dr.thr7, 1u << g, dr.one);
  } else {
    flip_if_le(p4, d, dr.thr8, 1u << g);
    flip_if_le(p8, d, dr.thr9, 1u << g);
    if constexpr (GREEDY) flip_if_le(p0, d, dr.thr7, 1u << g);
  }
}

// The flip word of row gy's word j from its neighbours.
template <int FAMILY, int R, bool GREEDY>
__device__ __forceinline__ uint32_t flip_word(uint32_t gy, uint32_t w1, uint32_t j,
                                              const Nbrs& n, const Draws& dr) {
  uint32_t p0 = 0, p4 = 0, p8 = 0;
  if constexpr (FAMILY == FAMILY_PHILOX) {
    // nq = 8*W1 counters per row; counter s*W1 + j serves bits s, s+8,
    // s+16 and s+24 (output word g / 8 for bit g).
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint64_t q = counter(gy, 8u * w1, k * w1 + j);
      const uint4 o = philox<R>(static_cast<uint32_t>(q),
                                static_cast<uint32_t>(q >> 32), dr.step, dr.tag,
                                dr.k0, dr.k1);
      accept_bits<FAMILY, GREEDY>(o.x, k, dr, p0, p4, p8);
      accept_bits<FAMILY, GREEDY>(o.y, k + 8, dr, p0, p4, p8);
      accept_bits<FAMILY, GREEDY>(o.z, k + 16, dr, p0, p4, p8);
      accept_bits<FAMILY, GREEDY>(o.w, k + 24, dr, p0, p4, p8);
    }
  } else if constexpr (FAMILY == FAMILY_THREEFRY) {
    // nq = 16*W1 counters per row under the per-(step, tag) stream key
    // (k0, k1); counter s*W1 + j serves bits s and s+16.
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const uint64_t q = counter(gy, 16u * w1, k * w1 + j);
      const uint2 o = threefry_fma<R>(static_cast<uint32_t>(q),
                                      static_cast<uint32_t>(q >> 32), dr.k0, dr.k1,
                                      dr.one);
      accept_bits<FAMILY, GREEDY>(o.x, k, dr, p0, p4, p8);
      accept_bits<FAMILY, GREEDY>(o.y, k + 16, dr, p0, p4, p8);
    }
  } else {
    // ChaCha (rng.chacha_color_draws): nq = 2*W1 blocks per row, 16 slots
    // of width 2*W1; block s*W1 + j serves bits 2*o + s (output word o).
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const uint64_t q = counter(gy, 2u * w1, k * w1 + j);
      uint32_t o[16];
      chacha<R>(static_cast<uint32_t>(q), static_cast<uint32_t>(q >> 32), dr.step,
                dr.tag, dr.k0, dr.k1, o);
#pragma unroll
      for (int w = 0; w < 16; ++w) accept_bits<FAMILY, GREEDY>(o[w], 2 * w + k, dr, p0, p4, p8);
    }
  }
  if constexpr (fma_accept<FAMILY>()) {
    p0 = ~p0;
    p4 = ~p4;
    p8 = ~p8;
  }
  return flip_mask<GREEDY>(neighbour_classes(n), p0, p4, p8);
}

template <int FAMILY, int R, bool GREEDY, int LINKS, bool YSL>
__global__ void __launch_bounds__(THREADS, min_blocks<FAMILY, R, LINKS, !GREEDY>())
bit1_sweep_kernel(const Sweep a, const Draws dr) {
  const int j = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x);
  const uint32_t w1 = static_cast<uint32_t>(a.W1), uj = static_cast<uint32_t>(j);
  walk<LINKS, YSL>(a, j, [&](uint32_t gy, const Nbrs& n) {
    return flip_word<FAMILY, R, GREEDY>(gy, w1, uj, n, dr);
  });
}

template <int FAMILY, int R, bool GREEDY, int LINKS, bool YSL>
void launch(dim3 grid, dim3 block, cudaStream_t stream, const Sweep& a,
            const Draws& dr) {
  bit1_sweep_kernel<FAMILY, R, GREEDY, LINKS, YSL><<<grid, block, 0, stream>>>(a, dr);
}

using Launch = void (*)(dim3, dim3, cudaStream_t, const Sweep&, const Draws&);

// The kernel of the accept and of the geometry's link mode and replica rows.
template <int FAMILY, int R, bool GREEDY>
Launch with_path(int links, bool ysl) {
  if (ysl) {
    return links == LINKS_JPLANES ? launch<FAMILY, R, GREEDY, LINKS_JPLANES, true>
                                  : launch<FAMILY, R, GREEDY, LINKS_NONE, true>;
  }
  return links == LINKS_JPLANES ? launch<FAMILY, R, GREEDY, LINKS_JPLANES, false>
       : links == LINKS_SPLIT   ? launch<FAMILY, R, GREEDY, LINKS_SPLIT, false>
                                : launch<FAMILY, R, GREEDY, LINKS_NONE, false>;
}

template <int FAMILY, int R>
Launch with_accept(bool greedy, int links, bool ysl) {
  return greedy ? with_path<FAMILY, R, true>(links, ysl)
                : with_path<FAMILY, R, false>(links, ysl);
}

// The (family, rounds) pairs of the u32 rng modes (ising_tpu/rng.py:99-113).
Launch find_launch(int family, int rounds, bool greedy, int links, bool ysl) {
  if (family == FAMILY_PHILOX && rounds == 10)
    return with_accept<FAMILY_PHILOX, 10>(greedy, links, ysl);
  if (family == FAMILY_PHILOX && rounds == 7)
    return with_accept<FAMILY_PHILOX, 7>(greedy, links, ysl);
  if (family == FAMILY_THREEFRY && rounds == 20)
    return with_accept<FAMILY_THREEFRY, 20>(greedy, links, ysl);
  if (family == FAMILY_THREEFRY && rounds == 13)
    return with_accept<FAMILY_THREEFRY, 13>(greedy, links, ysl);
  if (family == FAMILY_CHACHA && rounds == 8)
    return with_accept<FAMILY_CHACHA, 8>(greedy, links, ysl);
  if (family == FAMILY_CHACHA && rounds == 6)
    return with_accept<FAMILY_CHACHA, 6>(greedy, links, ysl);
  if (family == FAMILY_CHACHA && rounds == 4)
    return with_accept<FAMILY_CHACHA, 4>(greedy, links, ysl);
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
  Sweep a{static_cast<uint32_t*>(dst), static_cast<const uint32_t*>(src),
          static_cast<const uint32_t*>(src_up), static_cast<const uint32_t*>(src_dn),
          Geometry{}, H, W1, 0, color, row0};
  dim3 grid, block;
  if (!walk_grid(a, grid, block) ||
      !make_geometry(l0, l1, l2, l3, link_mode, csl, ysl, H, W1, a.geo)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Launch fn = find_launch(family, rounds, greedy != 0, link_mode, ysl != 0);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  fn(grid, block, static_cast<cudaStream_t>(stream), a,
     Draws{step, tag, k0, k1, thr7, thr8, thr9, 1u});
  return static_cast<int>(cudaGetLastError());
}

// Text of a CUDA error code, for the wrapper's exception message.
extern "C" const char* ising_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
