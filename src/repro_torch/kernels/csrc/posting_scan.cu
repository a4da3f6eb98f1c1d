// Paged posting scan (sm_90a): the per-query schedule, with and without
// the fused per-page k-min and over int8 codes, and the batched schedule
// without the k-min.
//
// Replaces four TPU kernels of src/repro/kernels/posting_scan/kernel.py:
//   * `scan_per_query` / `scan_per_query_topk` / `scan_per_query_topk_q8`:
//     page table[q, j] scored against query q;
//   * `scan_batched`: each unique page ids[i] scored against every query.
// The batched top-k forms, `scan_batched_topk` and `scan_batched_topk_q8`,
// have a tensor-core kernel of their own (scan_batched_topk.cu).
// All compute d = max(||q||^2 - 2 q.b + ||b||^2, 0) per slot.  The `_topk`
// forms add a per-slot bias (0 live, +BIG dead) and emit each (query,
// page) pair's k smallest distances with their slot indices, lowest slot
// first among equal values; the plain forms store every slot's distance.
// The payload is f32, bf16 or raw int8, converted to f32 in registers.
// The `_q8` form reads int8 codes and reconstructs b = code * scale + zero
// with the page's (scale, zero), the multiply and the add each rounded on
// their own (__fmul_rn, __fadd_rn: no FMA contraction), as the plain
// version rounds them.
//
// The kernels' contract is BS <= 32 (one lane per slot), k <= BS, and
// d % 4 == 0 with a 16-byte aligned pool, so a lane reads its slot row in
// 4-element vectors.
//
// Bounds on this card and what the design does about them:
//   * per_query at Q=1024, NB=256, BS=32, d=100: 1.7 GFLOP against the
//     probed pages (~3.2 KB each, int8), the bias (34 MB) and the
//     candidates (21 MB at k=10, 67 MB at k=32; 34 MB of distances
//     without the k-min): bytes bound.  One warp per (query, page) pair,
//     lane = slot: each lane streams its own slot row with vector loads
//     (the page's 32 rows are contiguous, so the warp reads the page once
//     through L1) and the query row by broadcast loads.  No shared
//     memory.  The q8 form dequantises in registers.
//   * batched at NB=32,768, Q=1024: 215 GFLOP of f32 FMA against 105 MB of
//     pages and 4.3 GB of distances: f32-operations bound.  A block stages
//     4 pages as f32 in shared memory once (odd row stride: conflict-free),
//     and each warp walks groups of 4 queries, staged transposed so one
//     broadcast float4 feeds 4 queries; each lane keeps a 4 pages x 4
//     queries register tile (16 FMA per 5 shared loads) and stores its
//     slot's distance: a warp writes 128 contiguous bytes.
//   * The per-query k-min is a rank select: every lane counts, over 32
//     shuffles, the lanes whose (value, lane) sorts before its own; lanes
//     of rank < k write their candidate at that rank.
// Plain C interface, loaded with ctypes; each entry returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;

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
  const char4 v = *reinterpret_cast<const char4*>(p);
  return make_float4((float)v.x, (float)v.y, (float)v.z, (float)v.w);
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }

// code * scale + zero, rounded after the multiply and after the add.
__device__ __forceinline__ float dequant(float c, float scale, float zero) {
  return __fadd_rn(__fmul_rn(c, scale), zero);
}
__device__ __forceinline__ float4 dequant4(float4 v, float scale, float zero) {
  return make_float4(dequant(v.x, scale, zero), dequant(v.y, scale, zero),
                     dequant(v.z, scale, zero), dequant(v.w, scale, zero));
}

// Rank of this lane's (v, lane) among the warp's 32 pairs; ranks < k are
// written.  Inactive lanes carry +inf, which sorts after every real value.
__device__ __forceinline__ void warp_kmin_store(float v, int lane, int k,
                                                float* od, int* oi) {
  int rank = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float o = __shfl_sync(kFull, v, j);
    rank += (o < v) || (o == v && j < lane);
  }
  if (rank < k) {
    od[rank] = v;
    oi[rank] = lane;
  }
}

constexpr int kPqWarps = 8;

// kQ8: int8 codes dequantised with sz[pair] = (scale, zero).
// kTopk: add the bias and keep the k-min; else store all BS distances.
template <typename T, bool kQ8, bool kTopk>
__global__ void __launch_bounds__(kPqWarps * 32)
scan_per_query_kernel(const int* __restrict__ table,
                      const float* __restrict__ q,
                      const T* __restrict__ blocks,
                      const float* __restrict__ bias,
                      const float* __restrict__ sz,
                      float* __restrict__ out_d, int* __restrict__ out_i,
                      int n_q, int nb, int bs, int d, int k) {
  const int lane = threadIdx.x & 31;
  const long long pair = (long long)blockIdx.x * kPqWarps + (threadIdx.x >> 5);
  if (pair >= (long long)n_q * nb) return;  // warp-uniform
  const int qi = (int)(pair / nb);
  const bool active = lane < bs;
  const long long bid = table[pair];
  const float* qrow = q + (size_t)qi * d;
  const T* row = blocks + ((size_t)bid * bs + (active ? lane : 0)) * d;
  float scale = 1.f, zero = 0.f;
  if constexpr (kQ8) {
    scale = sz[2 * pair];
    zero = sz[2 * pair + 1];
  }
  float cross = 0.f, bsq = 0.f, qsq = 0.f;
  for (int t = 0; t < d; t += 4) {
    const float4 qv = load4(qrow + t);
    float4 b = load4(row + t);
    if constexpr (kQ8) b = dequant4(b, scale, zero);
    cross = fmaf(b.x, qv.x, cross);
    cross = fmaf(b.y, qv.y, cross);
    cross = fmaf(b.z, qv.z, cross);
    cross = fmaf(b.w, qv.w, cross);
    bsq = fmaf(b.x, b.x, bsq);
    bsq = fmaf(b.y, b.y, bsq);
    bsq = fmaf(b.z, b.z, bsq);
    bsq = fmaf(b.w, b.w, bsq);
    qsq = fmaf(qv.x, qv.x, qsq);
    qsq = fmaf(qv.y, qv.y, qsq);
    qsq = fmaf(qv.z, qv.z, qsq);
    qsq = fmaf(qv.w, qv.w, qsq);
  }
  if constexpr (kTopk) {
    float dist = CUDART_INF_F;
    if (active) dist = fmaxf(qsq - 2.f * cross + bsq, 0.f) + bias[pair * bs + lane];
    warp_kmin_store(dist, lane, k, out_d + pair * k, out_i + pair * k);
  } else if (active) {
    out_d[pair * bs + lane] = fmaxf(qsq - 2.f * cross + bsq, 0.f);
  }
}

constexpr int kPages = 4;    // pages staged per block
constexpr int kQGroup = 4;   // queries per warp step
constexpr int kBWarps = 4;

// Every slot's distance, (NB, Q, BS).
template <typename T>
__global__ void __launch_bounds__(kBWarps * 32)
scan_batched_kernel(const int* __restrict__ ids,
                    const float* __restrict__ q,
                    const T* __restrict__ blocks,
                    float* __restrict__ out_d,
                    int nb, int n_q, int bs, int d, int stride) {
  extern __shared__ float4 smem4[];
  float* pg = reinterpret_cast<float*>(smem4);      // [kPages][32][stride]
  float* qt = pg + kPages * 32 * stride;            // [kBWarps][d][kQGroup]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int page0 = blockIdx.x * kPages;

  const int page_elems = 32 * d;
  for (int e = tid; e < kPages * page_elems; e += blockDim.x) {
    const int p = e / page_elems;
    const int rem = e - p * page_elems;
    const int s = rem / d;
    const int t = rem - s * d;
    float v = 0.f;
    if (page0 + p < nb && s < bs) v = to_f32(blocks[((size_t)ids[page0 + p] * bs + s) * d + t]);
    pg[(p * 32 + s) * stride + t] = v;
  }
  __syncthreads();

  float bsq[kPages];
  bool page_ok[kPages];
#pragma unroll
  for (int p = 0; p < kPages; ++p) {
    const float* r = pg + (p * 32 + lane) * stride;
    float s2 = 0.f;
    for (int t = 0; t < d; ++t) s2 = fmaf(r[t], r[t], s2);
    bsq[p] = s2;
    page_ok[p] = page0 + p < nb;
  }

  float* myq = qt + warp * d * kQGroup;
  const float4* q4 = reinterpret_cast<const float4*>(myq);
  const int n_groups = (n_q + kQGroup - 1) / kQGroup;
  for (int g = warp; g < n_groups; g += kBWarps) {
    const int qb = g * kQGroup;
    __syncwarp();
    for (int e = lane; e < kQGroup * d; e += 32) {
      const int qq = e / d;
      const int t = e - qq * d;
      myq[t * kQGroup + qq] = qb + qq < n_q ? q[(size_t)(qb + qq) * d + t] : 0.f;
    }
    __syncwarp();
    float qsq[kQGroup];
#pragma unroll
    for (int qq = 0; qq < kQGroup; ++qq) {
      float s2 = 0.f;
      for (int t = lane; t < d; t += 32) {
        const float v = myq[t * kQGroup + qq];
        s2 = fmaf(v, v, s2);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s2 += __shfl_xor_sync(kFull, s2, off);
      qsq[qq] = s2;
    }
    float acc[kPages][kQGroup];
#pragma unroll
    for (int p = 0; p < kPages; ++p)
#pragma unroll
      for (int qq = 0; qq < kQGroup; ++qq) acc[p][qq] = 0.f;
    for (int t = 0; t < d; ++t) {
      const float4 qv = q4[t];
#pragma unroll
      for (int p = 0; p < kPages; ++p) {
        const float b = pg[(p * 32 + lane) * stride + t];
        acc[p][0] = fmaf(b, qv.x, acc[p][0]);
        acc[p][1] = fmaf(b, qv.y, acc[p][1]);
        acc[p][2] = fmaf(b, qv.z, acc[p][2]);
        acc[p][3] = fmaf(b, qv.w, acc[p][3]);
      }
    }
#pragma unroll
    for (int p = 0; p < kPages; ++p) {
      if (!page_ok[p]) continue;  // warp-uniform
#pragma unroll
      for (int qq = 0; qq < kQGroup; ++qq) {
        if (qb + qq >= n_q) continue;  // warp-uniform
        const size_t o = (size_t)(page0 + p) * n_q + qb + qq;
        if (lane < bs) out_d[o * bs + lane] = fmaxf(qsq[qq] - 2.f * acc[p][qq] + bsq[p], 0.f);
      }
    }
  }
}

bool bad_shape(int bs, int d, int k) {
  return bs < 1 || bs > 32 || k < 1 || k > bs || d < 4 || d % 4 != 0;
}

template <typename T, bool kQ8, bool kTopk>
int launch_per_query(const int* table, const float* q, const void* blocks,
                     const float* bias, const float* sz, float* out_d,
                     int* out_i, int n_q, int nb, int bs, int d, int k,
                     cudaStream_t stream) {
  const long long pairs = (long long)n_q * nb;
  const long long grid = (pairs + kPqWarps - 1) / kPqWarps;
  scan_per_query_kernel<T, kQ8, kTopk><<<(unsigned)grid, kPqWarps * 32, 0, stream>>>(
      table, q, static_cast<const T*>(blocks), bias, sz, out_d, out_i, n_q, nb, bs, d, k);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_batched(const int* ids, const float* q, const void* blocks, float* out_d,
                   int nb, int n_q, int bs, int d, cudaStream_t stream) {
  const int stride = d | 1;
  const size_t smem = sizeof(float) *
      ((size_t)kPages * 32 * stride + (size_t)kBWarps * d * kQGroup);
  cudaError_t err = cudaFuncSetAttribute(
      scan_batched_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((nb + kPages - 1) / kPages);
  scan_batched_kernel<T><<<grid, kBWarps * 32, smem, stream>>>(
      ids, q, static_cast<const T*>(blocks), out_d, nb, n_q, bs, d, stride);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = int8 (the payload of `blocks`).
#define DISPATCH_DTYPE(LAUNCH, Q8, TOPK, ...)                          \
  switch (dtype) {                                                     \
    case 0: return LAUNCH<float, Q8, TOPK>(__VA_ARGS__);               \
    case 1: return LAUNCH<__nv_bfloat16, Q8, TOPK>(__VA_ARGS__);       \
    case 2: return LAUNCH<int8_t, Q8, TOPK>(__VA_ARGS__);              \
    default: return (int)cudaErrorInvalidValue;                        \
  }

extern "C" int scan_per_query_topk(const int* table, const float* q,
                                   const void* blocks, int dtype,
                                   const float* bias, float* out_d, int* out_i,
                                   int n_q, int nb, int bs, int d, int k,
                                   void* stream) {
  if (bad_shape(bs, d, k)) return (int)cudaErrorInvalidValue;
  if (n_q == 0 || nb == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  DISPATCH_DTYPE(launch_per_query, false, true, table, q, blocks, bias, nullptr,
                 out_d, out_i, n_q, nb, bs, d, k, s)
}

// Full distances (Q, NB, BS), no bias, no k-min.
extern "C" int scan_per_query(const int* table, const float* q,
                              const void* blocks, int dtype, float* out_d,
                              int n_q, int nb, int bs, int d, void* stream) {
  if (bad_shape(bs, d, 1)) return (int)cudaErrorInvalidValue;
  if (n_q == 0 || nb == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  DISPATCH_DTYPE(launch_per_query, false, false, table, q, blocks, nullptr, nullptr,
                 out_d, nullptr, n_q, nb, bs, d, 1, s)
}

// Full distances (NB, Q, BS), no bias, no k-min.
extern "C" int scan_batched(const int* ids, const float* q, const void* blocks,
                            int dtype, float* out_d, int nb, int n_q, int bs,
                            int d, void* stream) {
  if (bad_shape(bs, d, 1)) return (int)cudaErrorInvalidValue;
  if (n_q == 0 || nb == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_batched<float>(ids, q, blocks, out_d, nb, n_q, bs, d, s);
    case 1: return launch_batched<__nv_bfloat16>(ids, q, blocks, out_d, nb, n_q, bs, d, s);
    case 2: return launch_batched<int8_t>(ids, q, blocks, out_d, nb, n_q, bs, d, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// int8 codes; sz (Q, NB, 2) f32 per-page (scale, zero).
extern "C" int scan_per_query_topk_q8(const int* table, const float* q,
                                      const int8_t* codes, const float* bias,
                                      const float* sz, float* out_d, int* out_i,
                                      int n_q, int nb, int bs, int d, int k,
                                      void* stream) {
  if (bad_shape(bs, d, k)) return (int)cudaErrorInvalidValue;
  if (n_q == 0 || nb == 0) return 0;
  return launch_per_query<int8_t, true, true>(table, q, codes, bias, sz, out_d, out_i,
                                              n_q, nb, bs, d, k, (cudaStream_t)stream);
}
