// Bit-level float16 and bfloat16 <-> float32 converters used by the CPU
// reduction path (reductions accumulate in float32 for both 16-bit types).
//
// Capability parity with the reference fp16 support (/root/reference
// horovod/common/half.{h,cc}); bfloat16 is new here — it is the native TPU
// 16-bit format and gets first-class treatment.
#ifndef HVD_TPU_HALF_H
#define HVD_TPU_HALF_H

#include <cstdint>
#include <cstring>

namespace hvdtpu {

inline float HalfToFloat(uint16_t h) {
  uint32_t sign = static_cast<uint32_t>(h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1fu;
  uint32_t mant = h & 0x3ffu;
  uint32_t bits;
  if (exp == 0) {
    if (mant == 0) {
      bits = sign;  // +-0
    } else {
      // subnormal: normalize
      int shift = 0;
      while ((mant & 0x400u) == 0) {
        mant <<= 1;
        ++shift;
      }
      mant &= 0x3ffu;
      bits = sign | ((127 - 15 - shift + 1) << 23) | (mant << 13);
    }
  } else if (exp == 0x1fu) {
    bits = sign | 0x7f800000u | (mant << 13);  // inf / nan
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

inline uint16_t FloatToHalf(float f) {
  uint32_t bits;
  std::memcpy(&bits, &f, 4);
  uint32_t sign = (bits >> 16) & 0x8000u;
  int32_t exp = static_cast<int32_t>((bits >> 23) & 0xffu) - 127 + 15;
  uint32_t mant = bits & 0x7fffffu;
  if (exp >= 0x1f) {
    // overflow -> inf; preserve nan payload bit
    uint32_t nan = ((bits & 0x7fffffffu) > 0x7f800000u) ? 0x200u : 0;
    return static_cast<uint16_t>(sign | 0x7c00u | nan);
  }
  if (exp <= 0) {
    if (exp < -10) return static_cast<uint16_t>(sign);  // underflow -> 0
    // subnormal with round-to-nearest-even
    mant |= 0x800000u;
    uint32_t shift = static_cast<uint32_t>(14 - exp);
    uint32_t half_mant = mant >> shift;
    uint32_t rem = mant & ((1u << shift) - 1);
    uint32_t halfway = 1u << (shift - 1);
    if (rem > halfway || (rem == halfway && (half_mant & 1))) ++half_mant;
    return static_cast<uint16_t>(sign | half_mant);
  }
  uint16_t h = static_cast<uint16_t>(sign | (exp << 10) | (mant >> 13));
  // round-to-nearest-even on dropped 13 bits
  uint32_t rem = mant & 0x1fffu;
  if (rem > 0x1000u || (rem == 0x1000u && (h & 1))) ++h;
  return h;
}

inline float BFloat16ToFloat(uint16_t b) {
  uint32_t bits = static_cast<uint32_t>(b) << 16;
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

inline uint16_t FloatToBFloat16(float f) {
  uint32_t bits;
  std::memcpy(&bits, &f, 4);
  if ((bits & 0x7fffffffu) > 0x7f800000u) {
    return static_cast<uint16_t>((bits >> 16) | 0x40u);  // quiet nan
  }
  // round-to-nearest-even on the dropped 16 bits
  uint32_t lsb = (bits >> 16) & 1u;
  bits += 0x7fffu + lsb;
  return static_cast<uint16_t>(bits >> 16);
}

}  // namespace hvdtpu

#endif  // HVD_TPU_HALF_H
