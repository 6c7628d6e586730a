// bit1's decode: the black and white (H, W1) word planes unpacked into their
// (H, 32*W1) uint8 bit planes, one launch for both. Byte out[y, g*W1 + j] is
// bit g of word[y, j] (ising_tpu_torch/ops/bit1.py:unpack_bits1's layout).
//
// It replaces no Pallas kernel: the JAX package's decode is plain jnp
// (ising_tpu/ops/pallas_bit1.py:648, unpack_bits1 in row chunks), and so was
// the port's, 32 shifts, masks and strided copies a chunk, ~1600 launches and
// ~86 GiB of traffic a decode at 65536^2. It is here because the replica
// observables decode the whole lattice at every sample.
//
// What bounds it: bytes. At 65536^2 (W1 = 1024) a decode reads 0.54 GB of
// words and writes 4.29 GB of bytes, 1.44 ms at 3.35 TB/s, against about 32
// integer operations a word. So each word is read once and each byte written
// once: a thread loads 16 words (four 16-byte loads) and, for each bit g,
// builds the 16 bytes of that bit in registers and stores them as one 16-byte
// store, neighbouring threads on neighbouring addresses, so that a warp
// writes 512 contiguous bytes a store. The bytes of bit
// g = 8q + k of four words come from each word's (w >> k) & 0x01010101 (bits
// k, k+8, k+16, k+24 in its four bytes) by a 4 x 4 byte transpose, eight
// byte permutes for 16 bytes. The stores are streaming (st.global.cs): the 4
// GiB of output is far larger than the 50 MB L2 and nothing here reads it
// back. The grid covers both planes, one thread a vector.
//
// The vector width adapts to the shape: 16 words a thread where W1 % 16 == 0
// and every plane is 16-byte aligned, else 1 (byte stores), so that any
// H >= 1 and W1 >= 1 decodes. No warp-wide intrinsics: each thread's work is
// its own.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a (ops/kernel_lib.py). The C
// entry point below returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int SPW = 32;  // spins a word

struct Planes {
  const uint32_t* black;
  const uint32_t* white;
  uint8_t* out_black;
  uint8_t* out_white;
  int64_t H, W1;
};

// Bits k, k+8, k+16, k+24 of w, each in bit 0 of its byte.
__device__ __forceinline__ uint32_t byte_lanes(uint32_t w, int k) {
  return (w >> k) & 0x01010101u;
}

// 4 x 4 byte transpose: r[q] holds byte q of a, b, c and d, in that order.
__device__ __forceinline__ void transpose4(uint32_t a, uint32_t b, uint32_t c,
                                           uint32_t d, uint32_t r[4]) {
  const uint32_t ab01 = __byte_perm(a, b, 0x5140), ab23 = __byte_perm(a, b, 0x7362);
  const uint32_t cd01 = __byte_perm(c, d, 0x5140), cd23 = __byte_perm(c, d, 0x7362);
  r[0] = __byte_perm(ab01, cd01, 0x5410);
  r[1] = __byte_perm(ab01, cd01, 0x7632);
  r[2] = __byte_perm(ab23, cd23, 0x5410);
  r[3] = __byte_perm(ab23, cd23, 0x7632);
}

// One thread: VEC consecutive words of one row of one plane.
template <int VEC>
__global__ void __launch_bounds__(THREADS) bit1_decode_kernel(Planes p) {
  const int64_t per_row = p.W1 / VEC;
  const int64_t per_plane = p.H * per_row;
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= 2 * per_plane) return;
  const bool white = i >= per_plane;
  if (white) i -= per_plane;
  const int64_t y = i / per_row;
  const int64_t j0 = (i - y * per_row) * VEC;
  const uint32_t* src = (white ? p.white : p.black) + y * p.W1 + j0;
  uint8_t* dst = (white ? p.out_white : p.out_black) + y * SPW * p.W1 + j0;
  if constexpr (VEC == 1) {
    const uint32_t w = *src;
#pragma unroll
    for (int g = 0; g < SPW; ++g) dst[g * p.W1] = static_cast<uint8_t>((w >> g) & 1u);
  } else {
    static_assert(VEC == 16, "16 words a thread: four uint4 loads");
    uint4 words[4];
#pragma unroll
    for (int n = 0; n < 4; ++n) words[n] = __ldg(reinterpret_cast<const uint4*>(src) + n);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      uint32_t bytes[4][4];  // [load][q]: bit 8q + k of the load's four words
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        transpose4(byte_lanes(words[n].x, k), byte_lanes(words[n].y, k),
                   byte_lanes(words[n].z, k), byte_lanes(words[n].w, k), bytes[n]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        __stcs(reinterpret_cast<uint4*>(dst + (8 * q + k) * p.W1),
               make_uint4(bytes[0][q], bytes[1][q], bytes[2][q], bytes[3][q]));
      }
    }
  }
}

template <int VEC>
int launch(const Planes& p, cudaStream_t stream) {
  const int64_t blocks = (2 * p.H * (p.W1 / VEC) + THREADS - 1) / THREADS;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks)), block(THREADS);
  bit1_decode_kernel<VEC><<<grid, block, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Decode both (H, W1) word planes into the (H, 32*W1) byte planes out_black
// and out_white on `stream`. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for H < 1, W1 < 1 or a grid too large to launch.
extern "C" int bit1_decode_launch(const void* black, const void* white,
                                  void* out_black, void* out_white, int H, int W1,
                                  void* stream) {
  if (H < 1 || W1 < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Planes p{static_cast<const uint32_t*>(black), static_cast<const uint32_t*>(white),
                 static_cast<uint8_t*>(out_black), static_cast<uint8_t*>(out_white), H, W1};
  const bool aligned = ((reinterpret_cast<uintptr_t>(black) | reinterpret_cast<uintptr_t>(white) |
                         reinterpret_cast<uintptr_t>(out_black) |
                         reinterpret_cast<uintptr_t>(out_white)) & 15) == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (aligned && W1 % 16 == 0) return launch<16>(p, s);
  return launch<1>(p, s);
}
