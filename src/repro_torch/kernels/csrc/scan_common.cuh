// Payload loads and small helpers shared by the paged posting scans
// (posting_scan.cu, scan_batched_topk.cu), sm_90a.
//
// A page holds BS slot rows of d payload values, f32, bf16 or int8; the
// scans read four consecutive values at a time (16, 8 or 4 bytes,
// aligned) and widen them to f32 in registers.  int8 bytes are widened
// without the conversion unit (I2F runs at a quarter of the f32 rate on
// sm_90): with its sign bit flipped a byte reads x + 128, one byte permute
// places it in the low mantissa byte of 2^23, and one subtract of
// 2^23 + 128 leaves x exactly.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace scancommon {

constexpr unsigned kFull = 0xffffffffu;
// The dead-slot bias: distances >= BIG/2 are dead.
constexpr float kBig = 3.0e38f;

// Four consecutive payload values as f32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const int8_t* p) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
  const float off = 8388736.f;  // 2^23 + 128
  return make_float4(__uint_as_float(__byte_perm(w, 0x4b000000u, 0x7440)) - off,
                     __uint_as_float(__byte_perm(w, 0x4b000000u, 0x7441)) - off,
                     __uint_as_float(__byte_perm(w, 0x4b000000u, 0x7442)) - off,
                     __uint_as_float(__byte_perm(w, 0x4b000000u, 0x7443)) - off);
}

// 1.0 where a < b, else 0.0: one compare, no select.
__device__ __forceinline__ float lt1(float a, float b) {
  float c;
  asm("set.lt.f32.f32 %0, %1, %2;" : "=f"(c) : "f"(a), "f"(b));
  return c;
}

}  // namespace scancommon
