// Host stand-in for cuda_bf16.h's bfloat16 storage type and its two
// conversions (round to nearest even; a NaN stays a quiet NaN).

#pragma once

#include <stdint.h>
#include <string.h>

struct __nv_bfloat16 {
  uint16_t bits;
};

inline float __bfloat162float(__nv_bfloat16 v) {
  const uint32_t u = (uint32_t)v.bits << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}

inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {(uint16_t)((u >> 16) | 0x40)};
  return {(uint16_t)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16)};
}
