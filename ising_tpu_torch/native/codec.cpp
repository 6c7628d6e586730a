// Native host-side utilities of the PyTorch port (ising_tpu_torch), after
// the JAX package's ising_tpu/native/codec.cpp: the same bytes and C ABI
// for the RNG twins; the hex codec moves its file in blocks.
//
// The reference carries a C host-utility layer (checked I/O wrappers,
// optimized/utils.c:33-139) and an OpenMP-parallel lattice dump
// (optimized/main.cu:1140-1209).  Python suffices for argument checking,
// but the dump/load of multi-gigabyte lattices is a real host hot path, so
// the text codec lives here; a second, independently-written Philox4x32-10
// and ChaCha-R (chacha.h) cross-check the port's rng (ising_tpu_torch/rng.py).
//
// Host code, built with g++ (native/codec.py) and exposed as a plain C ABI,
// loaded from Python with ctypes.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include "chacha.h"

extern "C" {

// ---------------------------------------------------------------------------
// Hex lattice dump: one '0'/'1' character per spin, one line per row
// (the reloadable equivalent of the reference's dumpLattice format).
// Both directions move the file in blocks of about HEX_BLOCK bytes through
// one reused buffer: a write converts whole rows into it and writes it, a
// read takes it in and converts each line with a loop the compiler
// vectorizes, so neither touches the file a byte at a time.

static const int64_t HEX_BLOCK = 8 << 20;

// Returns 0 on success, -1 on I/O error.
int ising_write_hex(const char* path, const uint8_t* bits,
                    int64_t rows, int64_t cols) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  setvbuf(f, nullptr, _IONBF, 0);
  const int64_t line = cols + 1;
  const int64_t per = HEX_BLOCK / line > 0 ? HEX_BLOCK / line : 1;
  std::vector<char> buf((size_t)((rows < per ? rows : per) * line));
  for (int64_t r0 = 0; r0 < rows; r0 += per) {
    const int64_t k = rows - r0 < per ? rows - r0 : per;
    for (int64_t r = 0; r < k; ++r) {
      const uint8_t* src = bits + (r0 + r) * cols;
      char* dst = buf.data() + r * line;
      for (int64_t c = 0; c < cols; ++c) dst[c] = (char)('0' + (src[c] & 1));
      dst[cols] = '\n';
    }
    if (fwrite(buf.data(), 1, (size_t)(k * line), f) != (size_t)(k * line)) {
      fclose(f);
      return -1;
    }
  }
  return fclose(f) == 0 ? 0 : -1;
}

// One pass over the file: the spins into out (capacity bytes, at least the
// file's size), the shape into *rows and *cols. It accepts and rejects what
// the JAX package's two-pass reader does: '\r' and empty lines are skipped;
// -1 an I/O error, -2 a line whose length differs from the first's, -3 any
// other character (whichever comes first in the file), -4 fewer spins than
// rows * cols (a short last line without its newline). Returns 0 on success.
int ising_read_hex(const char* path, uint8_t* out, int64_t capacity,
                   int64_t* rows, int64_t* cols) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  setvbuf(f, nullptr, _IONBF, 0);
  std::vector<char> buf((size_t)HEX_BLOCK);
  int64_t r = 0, c = 0, cur = 0, n = 0;
  size_t got;
  int rc = 0;
  while (rc == 0 && (got = fread(buf.data(), 1, buf.size(), f)) > 0) {
    const char* p = buf.data();
    const char* end = p + got;
    while (p < end) {
      const char* nl = (const char*)memchr(p, '\n', (size_t)(end - p));
      const int64_t len = (nl ? nl : end) - p;
      if (n + len > capacity) { rc = -1; break; }
      uint8_t* dst = out + n;
      uint8_t bad = 0;
      for (int64_t i = 0; i < len; ++i) {
        const uint8_t v = (uint8_t)(p[i] - '0');
        dst[i] = v;
        bad |= v;
      }
      int64_t kept = len;
      if (bad & 0xFE) {  // a '\r' or a character that is no spin
        kept = 0;
        for (int64_t i = 0; i < len; ++i) {
          if (p[i] == '0' || p[i] == '1') dst[kept++] = (uint8_t)(p[i] - '0');
          else if (p[i] != '\r') { rc = -3; break; }
        }
        if (rc) break;
      }
      n += kept;
      cur += kept;
      if (!nl) break;
      if (cur > 0) {
        if (c == 0) c = cur;
        else if (c != cur) { rc = -2; break; }
        ++r;
        cur = 0;
      }
      p = nl + 1;
    }
  }
  if (rc == 0 && ferror(f)) rc = -1;
  fclose(f);
  if (rc) return rc;
  if (cur > 0) { if (c == 0) c = cur; ++r; }
  if (n < r * c) return -4;
  *rows = r;
  *cols = c;
  return 0;
}

// ---------------------------------------------------------------------------
// Philox4x32-10 (independent implementation for cross-validation).

static inline void mulhilo(uint32_t a, uint32_t b, uint32_t* hi,
                           uint32_t* lo) {
  uint64_t p = (uint64_t)a * (uint64_t)b;
  *hi = (uint32_t)(p >> 32);
  *lo = (uint32_t)p;
}

void ising_philox4x32(const uint32_t ctr_in[4], const uint32_t key_in[2],
                      int rounds, uint32_t out[4]) {
  uint32_t c0 = ctr_in[0], c1 = ctr_in[1], c2 = ctr_in[2], c3 = ctr_in[3];
  uint32_t k0 = key_in[0], k1 = key_in[1];
  for (int r = 0; r < rounds; ++r) {
    uint32_t hi0, lo0, hi1, lo1;
    mulhilo(0xD2511F53u, c0, &hi0, &lo0);
    mulhilo(0xCD9E8D57u, c2, &hi1, &lo1);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    if (r != rounds - 1) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
  }
  out[0] = c0; out[1] = c1; out[2] = c2; out[3] = c3;
}

// Bulk draws matching the library's quad contract for one plane row range:
// for row y in [row0, row0+nrows), quad q_g = y*(cols/4) + (col mod cols/4),
// slot = col / (cols/4). Fills out[nrows*cols].
void ising_philox_plane(uint64_t seed, uint32_t step, uint32_t tag,
                        int64_t row0, int64_t nrows, int64_t cols,
                        uint32_t* out) {
  const int64_t g = cols / 4;
  const uint32_t key[2] = {(uint32_t)(seed & 0xFFFFFFFFu),
                           (uint32_t)(seed >> 32)};
  for (int64_t y = 0; y < nrows; ++y) {
    for (int64_t j = 0; j < g; ++j) {
      uint64_t q = (uint64_t)(row0 + y) * (uint64_t)g + (uint64_t)j;
      uint32_t ctr[4] = {(uint32_t)(q & 0xFFFFFFFFu), (uint32_t)(q >> 32),
                         step, tag};
      uint32_t o[4];
      ising_philox4x32(ctr, key, 10, o);
      for (int s = 0; s < 4; ++s) out[y * cols + s * g + j] = o[s];
    }
  }
}

// ---------------------------------------------------------------------------
// ChaCha-R (independent scalar twin; see chacha.h). Block + bulk-plane entry
// points mirroring the library's chacha draw contract
// (rng.py chacha_color_draws): one block covers 16 lane-group slots,
// draw(y, col) = out[col / g] of counter q = y*g + (col mod g), g = cols/16.

void ising_chacha_block(uint32_t c0, uint32_t c1, uint32_t step, uint32_t tag,
                        uint32_t k0, uint32_t k1, int rounds,
                        uint32_t out[16]) {
  ising_chacha::block(c0, c1, step, tag, k0, k1, rounds, out);
}

void ising_chacha_plane(uint64_t seed, uint32_t step, uint32_t tag,
                        int64_t row0, int64_t nrows, int64_t cols, int rounds,
                        uint32_t* out) {
  const int64_t g = cols / 16;
  const uint32_t k0 = (uint32_t)(seed & 0xFFFFFFFFu);
  const uint32_t k1 = (uint32_t)(seed >> 32);
  for (int64_t y = 0; y < nrows; ++y) {
    for (int64_t j = 0; j < g; ++j) {
      uint64_t q = (uint64_t)(row0 + y) * (uint64_t)g + (uint64_t)j;
      uint32_t o[16];
      ising_chacha::block((uint32_t)(q & 0xFFFFFFFFu), (uint32_t)(q >> 32),
                          step, tag, k0, k1, rounds, o);
      for (int s = 0; s < 16; ++s) out[y * cols + s * g + j] = o[s];
    }
  }
}

}  // extern "C"
