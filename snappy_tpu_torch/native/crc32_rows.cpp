// crc32 (zlib's: reflected polynomial 0xEDB88320, initial and final value
// 0xFFFFFFFF) of many buffers in one call, so that a caller's thread holds
// no interpreter lock between them. On an x86-64 host with PCLMULQDQ and
// SSE4.1 (checked at run time; the library is built without -march), runs
// of 16 bytes fold by carry-less multiplication, 64 bytes a step (the
// reflected-domain constants of Intel's "Fast CRC Computation for Generic
// Polynomials Using PCLMULQDQ", as zlib's x86 SIMD crc32 uses them); the
// rest goes by slicing by 8, 8 bytes a step through 8 tables. Little-endian
// hosts only (runtime.py checks).

#include <cstddef>
#include <cstdint>
#include <cstring>

#if defined(__x86_64__)
#include <immintrin.h>
#endif

namespace {

struct Tables {
  uint32_t t[8][256];
  Tables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0xEDB88320u & (0u - (c & 1u)));
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

const Tables kTables;

#if defined(__x86_64__)
#define SNAPPY_FOLD_TARGET __attribute__((target("pclmul,sse4.1")))

SNAPPY_FOLD_TARGET inline __m128i load(const uint8_t* q) {
  return _mm_loadu_si128(reinterpret_cast<const __m128i*>(q));
}

// x folded forward by the distance k encodes, xored into next.
SNAPPY_FOLD_TARGET inline __m128i step(__m128i x, __m128i k, __m128i next) {
  return _mm_xor_si128(_mm_xor_si128(_mm_clmulepi64_si128(x, k, 0x11), _mm_clmulepi64_si128(x, k, 0x00)), next);
}

// The state c (pre-inverted) over n bytes, n >= 64 and a multiple of 16.
SNAPPY_FOLD_TARGET uint32_t fold(const uint8_t* p, size_t n, uint32_t c) {
  const __m128i k1k2 = _mm_set_epi64x(0x01c6e41596, 0x0154442bd4);
  const __m128i k3k4 = _mm_set_epi64x(0x00ccaa009e, 0x01751997d0);
  const __m128i k5k0 = _mm_set_epi64x(0, 0x0163cd6124);
  const __m128i poly = _mm_set_epi64x(0x01f7011641, 0x01db710641);
  const __m128i low32 = _mm_setr_epi32(~0, 0, ~0, 0);
  __m128i x1 = _mm_xor_si128(load(p), _mm_cvtsi32_si128(static_cast<int>(c)));
  __m128i x2 = load(p + 16), x3 = load(p + 32), x4 = load(p + 48);
  for (p += 64, n -= 64; n >= 64; p += 64, n -= 64) {
    x1 = step(x1, k1k2, load(p));
    x2 = step(x2, k1k2, load(p + 16));
    x3 = step(x3, k1k2, load(p + 32));
    x4 = step(x4, k1k2, load(p + 48));
  }
  x1 = step(step(step(x1, k3k4, x2), k3k4, x3), k3k4, x4);
  for (; n >= 16; p += 16, n -= 16) x1 = step(x1, k3k4, load(p));
  // 128 bits to 64, then Barrett reduction to 32.
  x1 = _mm_xor_si128(_mm_srli_si128(x1, 8), _mm_clmulepi64_si128(x1, k3k4, 0x10));
  x1 = _mm_xor_si128(_mm_clmulepi64_si128(_mm_and_si128(x1, low32), k5k0, 0x00), _mm_srli_si128(x1, 4));
  __m128i x2b = _mm_and_si128(_mm_clmulepi64_si128(_mm_and_si128(x1, low32), poly, 0x10), low32);
  x1 = _mm_xor_si128(x1, _mm_clmulepi64_si128(x2b, poly, 0x00));
  return static_cast<uint32_t>(_mm_extract_epi32(x1, 1));
}

// Initialised before any call: the CPU is probed in this library's own
// static initialisation, so __builtin_cpu_init runs first.
const bool kFold = (__builtin_cpu_init(), __builtin_cpu_supports("pclmul") && __builtin_cpu_supports("sse4.1"));
#endif

uint32_t crc32(const uint8_t* p, size_t n) {
  const auto& t = kTables.t;
  uint32_t c = 0xFFFFFFFFu;
#if defined(__x86_64__)
  if (kFold && n >= 64) {
    size_t m = n & ~size_t{15};
    c = fold(p, m, c);
    p += m;
    n -= m;
  }
#endif
  for (; n >= 8; p += 8, n -= 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, p, 4);
    std::memcpy(&hi, p + 4, 4);
    lo ^= c;
    c = t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^ t[5][(lo >> 16) & 0xFF] ^ t[4][lo >> 24] ^
        t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF] ^ t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24];
  }
  for (; n; ++p, --n) c = t[0][(c ^ *p) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

}  // namespace

extern "C" void snappy_tpu_torch_crc32_rows(const uint64_t* ptrs, const int64_t* lens, int64_t n, uint32_t* out) {
  for (int64_t i = 0; i < n; ++i)
    out[i] = crc32(reinterpret_cast<const uint8_t*>(static_cast<uintptr_t>(ptrs[i])), static_cast<size_t>(lens[i]));
}
