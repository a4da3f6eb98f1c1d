// Fused squared-L2 + per-tile k-min for centroid navigation (sm_90a).
//
// Replaces the TPU kernel `l2_topk_tiles` (src/repro/kernels/l2_topk/
// kernel.py, `_l2_topk_kernel`): for every (query row, centroid tile of
// `block_p` columns) it computes d = ||q||^2 - 2 q.c + c_sqn (c_sqn = +BIG
// for invalid or padded centroids; no clamp) and emits the tile's k
// smallest distances with global indices, sorted by (value, index), so the
// lowest index comes first among equal values.  The caller merges the
// T = P / block_p per-tile candidate sets.
//
// Bound on this card.  At search shapes (Q=1024, P=65,536, d=100) the
// cross products are 13.4 GFLOP against 26 MB of input: 0.20 ms on the
// f32 pipes, 0.08 ms as three TF32 tensor-core passes (495 TFLOP/s).  A
// k-round warp argmin (64 serial shuffle rounds per row) would cost more
// than the product.  This design:
//   * a block owns 32 query rows x one centroid tile (<= 512 columns),
//     8 warps, ~108 KB of shared memory at d = 100, so two blocks share an
//     SM and one's copies and barriers hide under the other's work; the
//     query tile sits in shared memory as f32; centroids stream through a
//     64-column buffer with cp.async (16-byte copies when d % 4 == 0), the
//     next chunk's copy overlapping this chunk's epilogue;
//   * the product runs on the tensor cores as `mma.sync` m16n8k8 TF32 (a
//     warp owns one 16-row m-tile x two 8-column n-tiles per chunk).
//     Precision: three passes, q_lo.c_hi + q_hi.c_lo + q_hi.c_hi, with
//     both operands split in registers (tf32_mma.cuh).  Queries (base rows
//     plus Gaussian noise) and centroids (means) are arbitrary f32, and one
//     TF32 pass would leave errors of order |q||c| 2^-11 in the cross term,
//     far above the 1e-5 |d| the navigation is held to; the split leaves
//     ~|q||c| 2^-21.  ||q||^2 and c_sqn stay f32 (FFMA, as the plain
//     version computes them).  `mma.sync` rather than `wgmma`: a
//     warpgroup's 64-row tile would double the distance tile and leave one
//     block an SM, and `mma.sync` puts the fragments in registers in a
//     layout the epilogue writes straight into the distance tile;
//   * the 32 x block_p distance tile is written to shared memory (64 KB,
//     rows padded to 520 floats: conflict-free fragment stores);
//   * selection, a warp per four rows, lane j holding columns j + 32 s: each
//     distance becomes an order-preserving uint32 key (negative values,
//     which cancellation gives, map below positive ones), and the k-th
//     smallest key T is found by a bitwise threshold search (one bit per
//     round from the highest bit where the row's min key and an upper
//     bound of T differ, counting keys below the candidate with one
//     `redux.sync`; a warp searches its four rows together); every
//     column below T is kept, then the columns equal to T in index order
//     (ballot and popc) until k are kept; the k survivors, packed as
//     (key << 32 | column), are sorted by a warp bitonic sort in shared
//     memory (the centroid buffer, free by then) and written ascending.
// What bounds it now (PERF.md, chip_smoke.py): 1.1 ms, 14x its tensor-core
// bound (0.081 ms, the three passes' FLOPs; the bytes take 0.028 ms):
// neither the tensor cores nor memory are busy.  Instruction issue and
// latency at 16 warps an SM hold it: the selection's rounds, and the
// product's splits and fragment loads.
// Registers and spills (`-Xptxas -v`, printed by every chip_smoke.py run):
// 128 registers, the cap that __launch_bounds__(256, 2) sets for two
// blocks an SM, and no spills.
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cstdint>

#include "tf32_mma.cuh"

namespace {

using namespace tf32mma;

constexpr int kRows = 32;                     // query rows per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kRows / kWarps;  // 4, in the selection
constexpr int kChunk = 64;                    // centroids staged per pass
constexpr int kMaxTile = 512;                 // widest centroid tile
constexpr int kMaxPerLane = kMaxTile / 32;    // 16 columns per lane per row
constexpr int kDistStride = kMaxTile + 8;     // distance tile row, floats
constexpr unsigned kFull = 0xffffffffu;

// Order-preserving map of an f32 onto uint32 (and back); -0 is made +0
// first, so the two zeros tie as they do in the plain version.
__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t u = __float_as_uint(f == 0.f ? 0.f : f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float key_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__global__ void __launch_bounds__(kThreads, 2)
l2_topk_tiles_kernel(const float* __restrict__ q, const float* __restrict__ c,
                     const float* __restrict__ csq, float* __restrict__ out_d,
                     int* __restrict__ out_i, int n_q, int n_p, int d, int k,
                     int block_p, int kpad, int stride, int sort_n, int vec16) {
  extern __shared__ float4 smem4[];
  float* dist = reinterpret_cast<float*>(smem4);       // [kRows][kDistStride]
  float* qs = dist + kRows * kDistStride;              // [kRows][stride]
  float* qsq = qs + kRows * stride;                    // [kRows]
  float* cbuf = qsq + kRows;                           // [kChunk][stride]
  uint64_t* sbuf = reinterpret_cast<uint64_t*>(cbuf);  // sort lists, later
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * kRows;
  const int tile = blockIdx.y;
  const int p0 = tile * block_p;
  const int n_tiles = n_p / block_p;
  const int n_chunks = block_p / kChunk;

  auto stage = [&](int ch) {
    float* dst = cbuf;
    const float* src = c + (size_t)(p0 + ch * kChunk) * d;
    if (vec16) {
      const int per_row = d / 4;
      for (int e = tid; e < kChunk * per_row; e += kThreads) {
        const int j = e / per_row;
        const int t = (e - j * per_row) * 4;
        cp_async16(dst + j * stride + t, src + (size_t)j * d + t);
      }
    } else {
      for (int e = tid; e < kChunk * d; e += kThreads) {
        const int j = e / d;
        cp_async4(dst + j * stride + (e - j * d), src + e);
      }
    }
    cp_async_commit();
  };
  stage(0);

  // zero the K padding of the centroid buffer (cp.async never writes it)
  const int pad = kpad - d;
  for (int e = tid; e < kChunk * pad; e += kThreads) {
    const int j = e / pad;
    cbuf[j * stride + d + (e - j * pad)] = 0.f;
  }
  if (d % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0) {
    const int per_row = kpad / 4;
    for (int e = tid; e < kRows * per_row; e += kThreads) {
      const int r = e / per_row;
      const int t = (e - r * per_row) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + r < n_q && t < d)
        v = *reinterpret_cast<const float4*>(q + (size_t)(row0 + r) * d + t);
      *reinterpret_cast<float4*>(qs + r * stride + t) = v;
    }
  } else {
    for (int e = tid; e < kRows * kpad; e += kThreads) {
      const int r = e / kpad;
      const int t = e - r * kpad;
      qs[r * stride + t] = (row0 + r < n_q && t < d) ? q[(size_t)(row0 + r) * d + t] : 0.f;
    }
  }

  // product: warp = (m-tile, pair of n-tiles) of each 32 x 64 chunk
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int mt = warp & 1;
  const int nt0 = (warp >> 1) * 2;
  const float* ap = qs + (mt * 16 + g) * stride + t4;
  for (int ch = 0; ch < n_chunks; ++ch) {
    cp_async_wait<0>();
    __syncthreads();  // chunk ch (and, at ch 0, the query tile) is in place
    if (ch == 0) {
      // ||q||^2 in f32, a warp per row: lane-strided partial sums, then a
      // butterfly (read by the epilogue, after the next barrier)
      for (int r = warp; r < kRows; r += kWarps) {
        float s = 0.f;
        for (int t = lane; t < d; t += 32) s = fmaf(qs[r * stride + t], qs[r * stride + t], s);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
        if (lane == 0) qsq[r] = s;
      }
    }
    float cq[2][2];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int col = p0 + ch * kChunk + (nt0 + n) * 8 + 2 * t4;
      cq[n][0] = csq[col];
      cq[n][1] = csq[col + 1];
    }
    float acc[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    for (int k0 = 0; k0 < kpad; k0 += 8) {
      uint32_t a_hi[4], a_lo[4];
      load_a(a_hi, ap + k0, stride);
#pragma unroll
      for (int j = 0; j < 4; ++j) split(__uint_as_float(a_hi[j]), a_hi[j], a_lo[j]);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float* bp = cbuf + ((nt0 + n) * 8 + g) * stride + k0 + t4;
        uint32_t b0h, b0l, b1h, b1l;
        split(bp[0], b0h, b0l);
        split(bp[4], b1h, b1l);
        mma(acc[n], a_lo, b0h, b1h);
        mma(acc[n], a_hi, b0l, b1l);
        mma(acc[n], a_hi, b0h, b1h);
      }
    }
    __syncthreads();  // the chunk is consumed: stage the next one
    if (ch + 1 < n_chunks) stage(ch + 1);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int col = ch * kChunk + (nt0 + n) * 8 + 2 * t4;
      const int r0 = mt * 16 + g;
      const int r1 = r0 + 8;
      *reinterpret_cast<float2*>(dist + r0 * kDistStride + col) = make_float2(
          qsq[r0] - 2.f * acc[n][0] + cq[n][0], qsq[r0] - 2.f * acc[n][1] + cq[n][1]);
      *reinterpret_cast<float2*>(dist + r1 * kDistStride + col) = make_float2(
          qsq[r1] - 2.f * acc[n][2] + cq[n][0], qsq[r1] - 2.f * acc[n][3] + cq[n][1]);
    }
  }
  __syncthreads();  // the distance tile is whole; the centroid buffer is free

  // selection: a warp ranks its 4 rows together, so each round of the
  // threshold search carries four independent count chains
  const int nper = block_p / 32;
  const unsigned below = (1u << lane) - 1u;
  uint64_t* sl = sbuf + warp * kRowsPerWarp * sort_n;  // [kRowsPerWarp][sort_n]
  uint32_t key[kRowsPerWarp][kMaxPerLane];
  uint32_t thr[kRowsPerWarp];
  int hb[kRowsPerWarp];
  int top = -1;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const float* dr = dist + (warp * kRowsPerWarp + rr) * kDistStride + lane;
    uint32_t kmin = 0xffffffffu, kmin2 = 0xffffffffu, kmax = 0u;
#pragma unroll
    for (int s = 0; s < kMaxPerLane; ++s) {
      key[rr][s] = 0xffffffffu;  // past the tile: never below a threshold
      if (s < nper) {
        key[rr][s] = order_key(dr[s * 32]);
        kmin2 = min(kmin2, max(kmin, key[rr][s]));
        kmin = min(kmin, key[rr][s]);
        kmax = max(kmax, key[rr][s]);
      }
    }
    // T, the k-th smallest key, lies in [min, ub]: every lane holds at
    // least j keys <= the largest of the lanes' j-th smallest (j = 1, 2)
    const uint32_t ub = __reduce_max_sync(kFull, k <= 32 ? kmin : k <= 64 ? kmin2 : kmax);
    kmin = __reduce_min_sync(kFull, kmin);
    // T: the largest key with fewer than k keys below it.  It shares the
    // bits above the highest one where min and ub differ.
    hb[rr] = kmin == ub ? -1 : 31 - __clz(kmin ^ ub);
    thr[rr] = hb[rr] < 0 ? kmin : kmin & ~((2u << hb[rr]) - 1u);
    top = max(top, hb[rr]);
  }
  for (int b = top; b >= 0; --b) {
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const uint32_t cand = thr[rr] | (1u << b);
      int c[4] = {0, 0, 0, 0};
#pragma unroll
      for (int s = 0; s < kMaxPerLane; ++s) c[s & 3] += key[rr][s] < cand;
      const int cnt = (int)__reduce_add_sync(kFull, (unsigned)((c[0] + c[1]) + (c[2] + c[3])));
      if (b <= hb[rr] && cnt < k) thr[rr] = cand;
    }
  }
  // Keep every key below T, then keys equal to T in column order until k
  // are kept; then sort the k survivors, packed as (key << 32 | column).
  // The four rows again go together: four independent chains per step.
  int eq_left[kRowsPerWarp], base[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    int lt = 0;
#pragma unroll
    for (int s = 0; s < kMaxPerLane; ++s) lt += key[rr][s] < thr[rr];
    eq_left[rr] = k - (int)__reduce_add_sync(kFull, (unsigned)lt);
    base[rr] = 0;
  }
#pragma unroll
  for (int s = 0; s < kMaxPerLane; ++s) {
    if (s >= nper) break;  // warp-uniform
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const bool eq = key[rr][s] == thr[rr];
      const unsigned em = __ballot_sync(kFull, eq);
      const bool take = key[rr][s] < thr[rr] || (eq && __popc(em & below) < eq_left[rr]);
      eq_left[rr] -= __popc(em);
      const unsigned tm = __ballot_sync(kFull, take);
      if (take)
        sl[rr * sort_n + base[rr] + __popc(tm & below)] =
            ((uint64_t)key[rr][s] << 32) | (uint32_t)(s * 32 + lane);
      base[rr] += __popc(tm);
    }
  }
  for (int j = k + lane; j < sort_n; j += 32)
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) sl[rr * sort_n + j] = ~0ull;
  __syncwarp();
  for (int size = 2; size <= sort_n; size <<= 1) {
    for (int half = size >> 1; half > 0; half >>= 1) {
      for (int i = lane; i < sort_n / 2; i += 32) {
        const int lo = 2 * i - (i & (half - 1));
        const int hi = lo + half;
        const bool up = (lo & size) == 0;
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr) {
          const uint64_t a = sl[rr * sort_n + lo];
          const uint64_t b = sl[rr * sort_n + hi];
          if ((a > b) == up) {
            sl[rr * sort_n + lo] = b;
            sl[rr * sort_n + hi] = a;
          }
        }
      }
      __syncwarp();
    }
  }
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = row0 + warp * kRowsPerWarp + rr;
    if (row >= n_q) break;  // warp-uniform
    float* od = out_d + (size_t)row * n_tiles * k + (size_t)tile * k;
    int* oi = out_i + (size_t)row * n_tiles * k + (size_t)tile * k;
    for (int j = lane; j < k; j += 32) {
      const uint64_t e = sl[rr * sort_n + j];
      od[j] = key_value((uint32_t)(e >> 32));
      oi[j] = p0 + (int)(uint32_t)e;
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
  const int kpad = (d + 7) / 8 * 8;  // K padded to the mma depth
  const int stride = kpad + 4;       // 4 mod 8: conflict-free fragment loads
  int sort_n = 1;
  while (sort_n < k) sort_n <<= 1;
  const size_t cbytes = sizeof(float) * kChunk * stride;
  const size_t sbytes = sizeof(uint64_t) * kRows * sort_n;
  const size_t smem = sizeof(float) * ((size_t)kRows * kDistStride + kRows * stride + kRows) +
                      (cbytes > sbytes ? cbytes : sbytes);
  if (smem > 232448) return (int)cudaErrorInvalidValue;  // d too large
  const int vec16 = d % 4 == 0 && reinterpret_cast<uintptr_t>(c) % 16 == 0;
  cudaError_t err = cudaFuncSetAttribute(
      l2_topk_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)  // all of L1 as shared memory: two blocks an SM
    err = cudaFuncSetAttribute(l2_topk_tiles_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_q + kRows - 1) / kRows, n_p / block_p);
  l2_topk_tiles_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      q, c, csq, out_d, out_i, n_q, n_p, d, k, block_p, kpad, stride, sort_n, vec16);
  return (int)cudaGetLastError();
}
