#include "checksum.h"

#include <mutex>

#if defined(__x86_64__)
#include <nmmintrin.h>
#endif

namespace hvdtpu {

namespace {

#if defined(__x86_64__)
// SSE4.2's crc32 instruction computes this CRC (the reflected Castagnoli
// polynomial), 8 bytes an instruction: several GB/s against the tables'
// 1-2. Used when the CPU has it (every x86-64 CPU since 2008 does); the
// same values as the tables', which the tests hold it to.
__attribute__((target("sse4.2"))) uint32_t Crc32cSse42(
    const unsigned char* p, std::size_t len, uint32_t crc) {
  uint64_t c = static_cast<uint32_t>(~crc);
  while (len > 0 && (reinterpret_cast<uintptr_t>(p) & 7) != 0) {
    c = _mm_crc32_u8(static_cast<uint32_t>(c), *p++);
    --len;
  }
  while (len >= 8) {
    uint64_t word;
    __builtin_memcpy(&word, p, 8);
    c = _mm_crc32_u64(c, word);
    p += 8;
    len -= 8;
  }
  while (len > 0) {
    c = _mm_crc32_u8(static_cast<uint32_t>(c), *p++);
    --len;
  }
  return ~static_cast<uint32_t>(c);
}

bool HaveSse42() {
  static const bool have = __builtin_cpu_supports("sse4.2");
  return have;
}
#endif

// 8 slicing tables, generated once at first use (8 KiB total).
uint32_t g_tables[8][256];
std::once_flag g_tables_once;

void BuildTables() {
  constexpr uint32_t kPoly = 0x82F63B78u;  // CRC32C, reflected
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t crc = i;
    for (int j = 0; j < 8; ++j) {
      crc = (crc >> 1) ^ ((crc & 1) ? kPoly : 0);
    }
    g_tables[0][i] = crc;
  }
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t crc = g_tables[0][i];
    for (int t = 1; t < 8; ++t) {
      crc = g_tables[0][crc & 0xFF] ^ (crc >> 8);
      g_tables[t][i] = crc;
    }
  }
}

}  // namespace

uint32_t Crc32c(const void* data, std::size_t len, uint32_t crc) {
  const unsigned char* p = static_cast<const unsigned char*>(data);
#if defined(__x86_64__)
  if (HaveSse42()) return Crc32cSse42(p, len, crc);
#endif
  std::call_once(g_tables_once, BuildTables);
  crc = ~crc;
  // Byte-at-a-time until 8-byte alignment, then slicing-by-8.
  while (len > 0 && (reinterpret_cast<uintptr_t>(p) & 7) != 0) {
    crc = g_tables[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
    --len;
  }
  while (len >= 8) {
    uint64_t word;
    __builtin_memcpy(&word, p, 8);
    // Little-endian lane split (the build targets are LE; a BE port
    // would byte-swap here).
    word ^= crc;
    crc = g_tables[7][word & 0xFF] ^
          g_tables[6][(word >> 8) & 0xFF] ^
          g_tables[5][(word >> 16) & 0xFF] ^
          g_tables[4][(word >> 24) & 0xFF] ^
          g_tables[3][(word >> 32) & 0xFF] ^
          g_tables[2][(word >> 40) & 0xFF] ^
          g_tables[1][(word >> 48) & 0xFF] ^
          g_tables[0][(word >> 56) & 0xFF];
    p += 8;
    len -= 8;
  }
  while (len > 0) {
    crc = g_tables[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
    --len;
  }
  return ~crc;
}

}  // namespace hvdtpu

// The port's C entry point (elastic/durable.py loads it with ctypes).
extern "C" uint32_t hvd_torch_crc32c(const void* data, std::size_t len,
                                     uint32_t crc) {
  return hvdtpu::Crc32c(data, len, crc);
}
