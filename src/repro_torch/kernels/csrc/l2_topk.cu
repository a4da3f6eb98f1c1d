// Fused squared-L2 + per-tile k-min for centroid navigation (sm_90a).
//
// Replaces the TPU kernel `l2_topk_tiles` (src/repro/kernels/l2_topk/
// kernel.py, `_l2_topk_kernel`): for every (query row, centroid tile of
// `block_p` columns) it computes d = ||q||^2 - 2 q.c + c_sqn (c_sqn = +BIG
// for invalid or padded centroids) and emits the tile's k smallest
// distances with global indices, lowest index first among equal values.
// The caller merges the T = P / block_p per-tile candidate sets.
//
// Bound on this card: f32 arithmetic.  At search shapes (Q=1024,
// P=65,536, d=100) the cross products are 6.7 GFMA = 13.4 GFLOP against
// 26 MB of input, far above the bytes/FLOP balance, so the FMA pipes (or
// the shared-memory loads feeding them) set the time.  The TPU tile
// (128 x 512 f32 distances, 256 KB) does not fit a block's shared memory,
// so the design is instead:
//   * a block owns 32 query rows x one centroid tile (<= 512 columns);
//     each of its 8 warps owns 4 rows; each lane owns columns lane + 32 i;
//   * the query tile sits in shared memory transposed ([d][32]), so one
//     broadcast float4 load feeds a warp's 4 rows; centroids stream
//     through shared memory 64 at a time with an odd row stride, so the
//     lanes' column reads hit 32 different banks;
//   * each lane computes a 4 x 2 register tile per chunk (8 FMA per 3
//     shared loads) and keeps its 4 x 16 tile distances in registers;
//   * the k-min is k rounds of a warp argmin on (value, index) pairs with
//     ties toward the lower index; the winner's register is retired.
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>
#include <climits>

namespace {

constexpr int kRows = 32;                  // query rows per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kRows / kWarps;  // 4
constexpr int kChunk = 64;                 // centroids staged per pass
constexpr int kMaxTile = 512;              // widest centroid tile
constexpr int kPerLane = kMaxTile / 32;    // 16 distances per lane per row
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
l2_topk_tiles_kernel(const float* __restrict__ q, const float* __restrict__ c,
                     const float* __restrict__ csq, float* __restrict__ out_d,
                     int* __restrict__ out_i, int n_q, int n_p, int d, int k,
                     int block_p, int stride) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [d][kRows]
  float* cs = qs + d * kRows;                    // [kChunk][stride]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * kRows;
  const int tile = blockIdx.y;
  const int p0 = tile * block_p;
  const int n_tiles = n_p / block_p;
  const int n_chunks = block_p / kChunk;

  for (int e = tid; e < kRows * d; e += blockDim.x) {
    const int r = e / d;
    const int t = e - r * d;
    const int row = row0 + r;
    qs[t * kRows + r] = row < n_q ? q[(size_t)row * d + t] : 0.f;
  }
  __syncthreads();

  float qsq[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    float s = 0.f;
    for (int t = 0; t < d; ++t) {
      const float v = qs[t * kRows + warp * kRowsPerWarp + r];
      s = fmaf(v, v, s);
    }
    qsq[r] = s;
  }

  float dist[kRowsPerWarp][kPerLane];
  const float4* q4 = reinterpret_cast<const float4*>(qs);
#pragma unroll
  for (int ch = 0; ch < kMaxTile / kChunk; ++ch) {
    if (ch < n_chunks) {
      __syncthreads();  // the previous chunk is consumed
      const float* src = c + (size_t)(p0 + ch * kChunk) * d;
      for (int e = tid; e < kChunk * d; e += blockDim.x) {
        const int j = e / d;
        const int t = e - j * d;
        cs[j * stride + t] = src[e];
      }
      __syncthreads();
      float acc[kRowsPerWarp][2];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) acc[r][0] = acc[r][1] = 0.f;
      const float* c0p = cs + lane * stride;
      const float* c1p = cs + (lane + 32) * stride;
      for (int t = 0; t < d; ++t) {
        const float4 qv = q4[t * (kRows / 4) + warp];
        const float c0 = c0p[t];
        const float c1 = c1p[t];
        acc[0][0] = fmaf(qv.x, c0, acc[0][0]);
        acc[1][0] = fmaf(qv.y, c0, acc[1][0]);
        acc[2][0] = fmaf(qv.z, c0, acc[2][0]);
        acc[3][0] = fmaf(qv.w, c0, acc[3][0]);
        acc[0][1] = fmaf(qv.x, c1, acc[0][1]);
        acc[1][1] = fmaf(qv.y, c1, acc[1][1]);
        acc[2][1] = fmaf(qv.z, c1, acc[2][1]);
        acc[3][1] = fmaf(qv.w, c1, acc[3][1]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float cq = csq[p0 + ch * kChunk + h * 32 + lane];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
          dist[r][ch * 2 + h] = qsq[r] - 2.f * acc[r][h] + cq;
      }
    } else {
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        dist[r][ch * 2] = dist[r][ch * 2 + 1] = CUDART_INF_F;
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + warp * kRowsPerWarp + r;
    float* od = out_d + (size_t)row * n_tiles * k + (size_t)tile * k;
    int* oi = out_i + (size_t)row * n_tiles * k + (size_t)tile * k;
    for (int j = 0; j < k; ++j) {
      // lane-local min; a lane's column index grows with s, so strict <
      // keeps the lowest index among equal values
      float bv = CUDART_INF_F;
      int bi = INT_MAX;
#pragma unroll
      for (int s = 0; s < kPerLane; ++s) {
        if (dist[r][s] < bv) {
          bv = dist[r][s];
          bi = (s >> 1) * kChunk + (s & 1) * 32 + lane;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(kFull, bv, off);
        const int oi2 = __shfl_xor_sync(kFull, bi, off);
        if (ov < bv || (ov == bv && oi2 < bi)) {
          bv = ov;
          bi = oi2;
        }
      }
      if ((bi & 31) == lane) {
        const int sel = (bi / kChunk) * 2 + ((bi >> 5) & 1);
#pragma unroll
        for (int s = 0; s < kPerLane; ++s)
          if (s == sel) dist[r][s] = CUDART_INF_F;
      }
      if (lane == 0 && row < n_q) {
        od[j] = bv;
        oi[j] = bi + p0;
      }
    }
  }
}

}  // namespace

extern "C" int l2_topk_tiles_f32(const float* q, const float* c,
                                 const float* csq, float* out_d, int* out_i,
                                 int n_q, int n_p, int d, int k, int block_p,
                                 void* stream) {
  if (block_p % kChunk != 0 || block_p > kMaxTile || n_p % block_p != 0 ||
      k < 1 || k > block_p || d < 1)
    return (int)cudaErrorInvalidValue;
  if (n_q == 0 || n_p == 0) return 0;
  const int stride = d | 1;  // odd row stride: conflict-free column reads
  const size_t smem = sizeof(float) * ((size_t)d * kRows + (size_t)kChunk * stride);
  cudaError_t err = cudaFuncSetAttribute(
      l2_topk_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_q + kRows - 1) / kRows, n_p / block_p);
  l2_topk_tiles_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      q, c, csq, out_d, out_i, n_q, n_p, d, k, block_p, stride);
  return (int)cudaGetLastError();
}
