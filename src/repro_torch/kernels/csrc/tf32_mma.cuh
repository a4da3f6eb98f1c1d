// Split-precision TF32 tensor-core products and asynchronous staging
// (sm_90a), shared by the centroid navigation (l2_topk.cu) and the
// batched page scan (scan_batched_topk.cu); the per-query page scan
// (posting_scan.cu) uses the staging helpers only.
//
// An f32 value x is split into hi = x rounded to TF32's 10-bit mantissa
// and lo = x - hi, which is exact in f32 and below 2^-11 |x|, then cut to
// TF32 itself (truncated), so hi + lo carries ~21 significant bits.  A
// product a.b is then taken as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi (the
// a_lo.b_lo term is below 2^-22 |a||b|), each pass one `mma.sync`
// m16n8k8 with f32 accumulation.  A value that TF32
// holds exactly (int8, bf16) needs no lo part, and the product takes two
// passes.  The split is four instructions (an add and a mask for hi, a
// subtract and a mask for lo); truncating lo costs at most 2^-10 of lo.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace tf32mma {

// x ~ hi + lo, both TF32 bit patterns (low 13 bits zero): hi is x rounded
// to nearest (ties away from zero), lo is x - hi truncated.  Finite |x|
// below 2^127 assumed.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// c += A (16x8, row) * B (8x8, col).  Fragments, with g = lane / 4 and
// t = lane % 4: a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4],
// a3 = A[g+8][t+4]; b0 = B[t][g], b1 = B[t+4][g]; c0 = C[g][2t],
// c1 = C[g][2t+1], c2 = C[g+8][2t], c3 = C[g+8][2t+1].
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment at k-offset k0 of a row-major tile whose row g + 8h,
// column t + 4j lives at p[(8h) * stride + 4j] (p = &tile[g][k0 + t]).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const float* p, int stride) {
  a[0] = __float_as_uint(p[0]);
  a[1] = __float_as_uint(p[8 * stride]);
  a[2] = __float_as_uint(p[4]);
  a[3] = __float_as_uint(p[8 * stride + 4]);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

// A copy of N = 4, 8 or 16 bytes (16: bypassing L1).
template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  if constexpr (N == 16) cp_async16(smem, gmem);
  else if constexpr (N == 8) cp_async8(smem, gmem);
  else cp_async4(smem, gmem);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace tf32mma
