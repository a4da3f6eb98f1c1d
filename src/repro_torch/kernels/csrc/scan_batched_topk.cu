// Batched paged scan with a fused per-(page, query) k-min on the tensor
// cores (sm_90a).
//
// Replaces the TPU kernel `scan_batched_topk` (src/repro/kernels/
// posting_scan/kernel.py, `_scan_batched_topk_kernel`): each unique page
// ids[i] (BS <= 32 slots of d values, f32, bf16 or int8) against every
// query, d = max(||q||^2 - 2 q.b + ||b||^2, 0) + bias[i, slot], and per
// (page, query) the k smallest with their slots, ascending, lowest slot
// first among equal values; out (NB, Q, k).
//
// Bounds on this card at the spfresh-1b shapes (NB = 32,768 pages budget,
// Q = 1024, BS = 32, d = 100, k = 10): 215 GFLOP over the full budget
// (3.2 ms on the f32 pipes) and 2.68 GB of candidates (0.80 ms at
// 3.35 TB/s), which every design writes.  On the search path only the
// probed pages are live (10,393 of 32,768 on the main path): 68 GFLOP,
// 1.02 ms at f32 rates.  A warp-wide rank select (32 shuffles per pair)
// would cost more than the product.  This design:
//   * dead pages cost no product and no select.  A page whose every bias
//     entry is >= BIG/2 (the budget's padding rows, clamped to page 0, and
//     pages with no live slot) gets (BIG, slot j) for j < k written
//     directly.  Precondition: the dead bias is float32(3e38) and
//     distances are below ~1e31, as on the search path; then fmax(d, 0) +
//     3e38 rounds to float32(3e38) for every slot (its ulp is 2^104), all
//     values tie, and the plain version emits exactly these candidates
//     (the TPU kernel the same values, with slot 0 k times: its k-min
//     masks a taken slot with the same BIG);
//   * a block keeps a tile of 64 queries resident in shared memory (f32)
//     and walks a run of 64 pages, 4 per step; warp w takes page w / 2 of
//     the step against query half w % 2.  At d = 100 an int8 block holds
//     88 KB, so two blocks share an SM (16 warps); bf16 114 KB (two), f32
//     165 KB (one);
//   * pages are staged asynchronously and stay in their payload type: each
//     live page's BS * d bytes are contiguous, so a warp copies them with
//     cp.async (16 bytes a lane where the page size allows, else 4) into a
//     two-step ring while the current step computes (one barrier per
//     step); the mma's B fragments are converted to f32 as they are loaded
//     (int8 by a byte permute and one add, not the conversion unit), and
//     ||b||^2 is summed in f32 FFMA from the same fragments and reduced
//     over the quad that holds a slot;
//   * the product runs as `mma.sync` m16n8k8 TF32 with M = queries (two
//     m-tiles), N = slots (four n-tiles), K = d padded to a multiple of 16
//     and permuted within each 16 so that every operand arrives in one
//     16-byte (or 8, 4) shared load.  Precision: q = q_hi + q_lo, split in
//     registers (tf32_mma.cuh); bf16 and int8 payloads are exact in TF32,
//     so q_lo.b + q_hi.b (two passes); f32 payloads are split too, three
//     passes.  The result then carries ~2^-21 of |q||b| against the
//     1e-5 |d| tolerance the kernel is held to;
//   * the k-min costs a thread, not a warp: the accumulator tile goes to a
//     per-warp 32 x 32 staging tile in shared memory (swizzled, no bank
//     conflicts), and lane j owns query j of the warp's half: it keeps a
//     sorted list of KMAX >= k (value, slot) pairs in registers (KMAX in
//     {4, 10, 16, 32}) and inserts the page's live slots in order with
//     strict <, so the lowest slot stays first among equal values; dead
//     slots are inserted only when fewer than k slots live;
//   * the 32 queries' candidates are contiguous in (NB, Q, k): they go out
//     through the same staging tile as coalesced 128-byte rows.
// What bounds it now (PERF.md, chip_smoke.py): 6.8 ms over the full
// budget, 7.8x its tensor-core bound there (two passes over int8 pages,
// 0.87 ms of FLOPs at 495 TFLOP/s, above the 0.83 ms of bytes), and
// 2.9 ms on the main path's mix, 3.5x its bound there (0.81 ms of
// candidate bytes; the live pages' two passes take 0.28 ms).  Neither the
// tensor cores nor memory are busy: instruction issue holds it, the
// `mma.sync` TF32 operand loads and splits, and the k-min's compares and
// moves (about 5 instructions per slot and list position).
// Registers and spills (`-Xptxas -v`, printed by every chip_smoke.py run):
// 106 to 122 registers over the twelve instantiations (payload x KMAX),
// under the 128 of __launch_bounds__(256, 2), and no spills.
// Contract: 1 <= BS <= 32, 1 <= k <= BS, d % 4 == 0, a 16-byte aligned
// pool, ids in [0, B).  Plain C interface, loaded with ctypes; returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>

#include "tf32_mma.cuh"

namespace {

using namespace tf32mma;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kQTile = 64;          // queries resident per block
constexpr int kStep = kWarps / 2;   // pages per step, two warps each
constexpr int kRun = 64;            // pages per block
constexpr float kBig = 3.0e38f;
constexpr unsigned kFull = 0xffffffffu;

// Four consecutive payload values (16, 8 or 4 bytes, aligned) as f32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
// int8 to f32 without the conversion unit: with its sign bit flipped a
// byte reads x + 128, and 2^23 + (x + 128) - (2^23 + 128) = x exactly.
__device__ __forceinline__ float4 load4(const int8_t* p) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
  const float off = 8388736.f;  // 2^23 + 128
  return make_float4(__uint_as_float(__byte_perm(w, 0x4b000000u, 0x7440)) - off,
                     __uint_as_float(__byte_perm(w, 0x4b000000u, 0x7441)) - off,
                     __uint_as_float(__byte_perm(w, 0x4b000000u, 0x7442)) - off,
                     __uint_as_float(__byte_perm(w, 0x4b000000u, 0x7443)) - off);
}

// Insert (v, j) into the ascending list (ld, li): strict <, so among equal
// values the one inserted first stays first.
template <int K>
__device__ __forceinline__ void insert(float (&ld)[K], int (&li)[K], float v, int j) {
#pragma unroll
  for (int m = K - 1; m > 0; --m) {
    const bool c1 = v < ld[m - 1];
    const bool c0 = v < ld[m];
    ld[m] = c1 ? ld[m - 1] : (c0 ? v : ld[m]);
    li[m] = c1 ? li[m - 1] : (c0 ? j : li[m]);
  }
  if (v < ld[0]) {
    ld[0] = v;
    li[0] = j;
  }
}

// The staging tile [32 queries][32 slots] without padding: slot c of
// query r sits at column c ^ swz(r), a bijection of r's five bits chosen
// so that both the mma fragment stores (a lane's (g, t) spread over all 32
// banks) and the per-query row reads (32 rows at one column) are free of
// bank conflicts.
__device__ __forceinline__ int swz(int r) {
  return (r & 1) | ((r >> 3 & 1) << 1) | ((r >> 4 & 1) << 2) | ((r >> 1 & 1) << 3) |
         ((r >> 2 & 1) << 4);
}

// Shared-memory layout, in bytes from the start (every part 16-aligned).
struct Layout {
  int page_stride, pages, qs, stage, qsq, bias, live, total;
  __host__ __device__ Layout(int bs, int d, int elem, int stride) {
    page_stride = (bs * d * elem + 15) & ~15;
    pages = 0;
    qs = pages + 2 * kStep * page_stride;
    stage = qs + 4 * kQTile * stride;
    qsq = stage + 4 * kWarps * 32 * 32;
    bias = qsq + 4 * kQTile;
    live = bias + 4 * 2 * kStep * 32;
    total = live + 4 * 2 * kStep;
  }
};

template <typename T, int KMAX>
__global__ void __launch_bounds__(kThreads, 2)
scan_batched_topk_tc(const int* __restrict__ ids, const float* __restrict__ q,
                     const T* __restrict__ blocks, const float* __restrict__ bias,
                     float* __restrict__ out_d, int* __restrict__ out_i,
                     int nb, int n_q, int bs, int d, int k, int kpad, int stride,
                     int vec16) {
  constexpr bool kSplitB = sizeof(T) == 4;  // f32 payloads need a lo part
  extern __shared__ float4 smem4[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem4);
  const Layout L(bs, d, (int)sizeof(T), stride);
  unsigned char* pages = sm + L.pages;                    // [2][kStep][page_stride]
  float* qs = reinterpret_cast<float*>(sm + L.qs);        // [kQTile][stride]
  float* stg = reinterpret_cast<float*>(sm + L.stage);    // [kWarps][32][32]
  float* qsq = reinterpret_cast<float*>(sm + L.qsq);      // [kQTile]
  float* pbias = reinterpret_cast<float*>(sm + L.bias);   // [2][kStep][32]
  int* plive = reinterpret_cast<int*>(sm + L.live);       // [2][kStep]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int run0 = blockIdx.x * kRun;
  const int qt0 = blockIdx.y * kQTile;
  const int page_bytes = bs * d * (int)sizeof(T);
  const int n_steps = (min(kRun, nb - run0) + kStep - 1) / kStep;

  // Warps 0..kStep-1 each read one page's bias, decide whether it is live,
  // and start copying a live page's payload into the ring.
  auto load_step = [&](int s, int buf) {
    if (warp < kStep) {
      const int page = run0 + s * kStep + warp;
      float b = kBig;
      if (page < nb && lane < bs) b = bias[(size_t)page * bs + lane];
      pbias[(buf * kStep + warp) * 32 + lane] = b;
      const bool live = __any_sync(kFull, b < 0.5f * kBig);
      if (lane == 0) plive[buf * kStep + warp] = live;
      if (live) {
        const unsigned char* src =
            reinterpret_cast<const unsigned char*>(blocks) + (size_t)ids[page] * page_bytes;
        unsigned char* dst = pages + (buf * kStep + warp) * L.page_stride;
        if (vec16) {
          for (int e = lane * 16; e < page_bytes; e += 32 * 16) cp_async16(dst + e, src + e);
        } else {
          for (int e = lane * 4; e < page_bytes; e += 32 * 4) cp_async4(dst + e, src + e);
        }
      }
    }
    cp_async_commit();
  };
  load_step(0, 0);

  // the query tile (zero past d and past Q)
  const int per_row = kpad / 4;
  const bool vec_q = reinterpret_cast<uintptr_t>(q) % 16 == 0;  // d % 4 == 0
  for (int e = tid; e < kQTile * per_row; e += kThreads) {
    const int r = e / per_row;
    const int t = (e - r * per_row) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (qt0 + r < n_q && t < d) {
      const float* src = q + (size_t)(qt0 + r) * d + t;
      v = vec_q ? *reinterpret_cast<const float4*>(src) : make_float4(src[0], src[1], src[2], src[3]);
    }
    *reinterpret_cast<float4*>(qs + r * stride + t) = v;
  }
  // ||q||^2 in f32, a warp per query: lane-strided partial sums, butterfly
  for (int r = warp; r < kQTile; r += kWarps) {
    float s2 = 0.f;
    if (qt0 + r < n_q) {
      const float* qr = q + (size_t)(qt0 + r) * d;
      for (int t = lane; t < d; t += 32) s2 = fmaf(qr[t], qr[t], s2);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s2 += __shfl_xor_sync(kFull, s2, off);
    if (lane == 0) qsq[r] = s2;
  }

  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wp = warp >> 1;             // the warp's page in the step
  const int half = warp & 1;            // ... and its 32 queries of the tile
  const int q0 = qt0 + half * 32;
  const int n_valid = min(32, n_q - q0);
  float* st = stg + warp * 32 * 32;
  const float* ap = qs + (half * 32 + g) * stride + 4 * t4;

  for (int s = 0; s < n_steps; ++s) {
    const int buf = s & 1;
    cp_async_wait<0>();
    __syncthreads();  // step s's pages landed; step s-1 is consumed
    if (s + 1 < n_steps) load_step(s + 1, buf ^ 1);

    const int page = run0 + s * kStep + wp;
    if (page >= nb || n_valid <= 0) continue;  // warp-uniform
    const size_t out0 = ((size_t)page * n_q + q0) * k;
    if (!plive[buf * kStep + wp]) {
      for (int e = lane; e < n_valid * k; e += 32) {
        out_d[out0 + e] = kBig;
        out_i[out0 + e] = e % k;
      }
      continue;
    }
    const T* pp = reinterpret_cast<const T*>(pages + (buf * kStep + wp) * L.page_stride);
    const float* pb = pbias + (buf * kStep + wp) * 32;

    // The K axis is walked 16 values at a time, and the mma's k index is
    // permuted within each 16: lane (g, t) holds physical columns k0 + 4t
    // .. k0 + 4t + 3 of its A rows and B slot rows (one vector load each),
    // the first two feeding k-step 0 (as its columns t and t + 4), the
    // last two k-step 1.  A and B agree, so the sums are the same dot
    // products.  Slot rows past BS read other bytes of the ring: their
    // columns are never ranked, and the mma keeps columns apart.
    float acc[2][4][4];
    float bq[4];                         // ||b||^2 partials of slots 8n + g
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      bq[n] = 0.f;
#pragma unroll
      for (int m = 0; m < 2; ++m) acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.f;
    }
    for (int k0 = 0; k0 < kpad; k0 += 16) {
      const bool in_d = k0 + 4 * t4 < d;  // d % 4 == 0: all four or none
      float4 qa[2][2];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int v = 0; v < 2; ++v)
          qa[m][v] = *reinterpret_cast<const float4*>(ap + (m * 16 + v * 8) * stride + k0);
      float4 bv[4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        bv[n] = in_d ? load4(pp + (n * 8 + g) * d + k0 + 4 * t4) : make_float4(0.f, 0.f, 0.f, 0.f);
        bq[n] = fmaf(bv[n].x, bv[n].x, bq[n]);
        bq[n] = fmaf(bv[n].y, bv[n].y, bq[n]);
        bq[n] = fmaf(bv[n].z, bv[n].z, bq[n]);
        bq[n] = fmaf(bv[n].w, bv[n].w, bq[n]);
      }
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          split(ks ? qa[m][0].z : qa[m][0].x, a_hi[m][0], a_lo[m][0]);
          split(ks ? qa[m][1].z : qa[m][1].x, a_hi[m][1], a_lo[m][1]);
          split(ks ? qa[m][0].w : qa[m][0].y, a_hi[m][2], a_lo[m][2]);
          split(ks ? qa[m][1].w : qa[m][1].y, a_hi[m][3], a_lo[m][3]);
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const float f0 = ks ? bv[n].z : bv[n].x;
          const float f1 = ks ? bv[n].w : bv[n].y;
          if constexpr (kSplitB) {
            uint32_t b0h, b0l, b1h, b1l;
            split(f0, b0h, b0l);
            split(f1, b1h, b1l);
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              mma(acc[m][n], a_lo[m], b0h, b1h);
              mma(acc[m][n], a_hi[m], b0l, b1l);
              mma(acc[m][n], a_hi[m], b0h, b1h);
            }
          } else {  // exact in TF32
            const uint32_t b0 = __float_as_uint(f0);
            const uint32_t b1 = __float_as_uint(f1);
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              mma(acc[m][n], a_lo[m], b0, b1);
              mma(acc[m][n], a_hi[m], b0, b1);
            }
          }
        }
      }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {        // the quad's partials: slot 8n + g
      bq[n] += __shfl_xor_sync(kFull, bq[n], 1);
      bq[n] += __shfl_xor_sync(kFull, bq[n], 2);
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = n * 8 + 2 * t4 + h;  // slot
        const float cb = __shfl_sync(kFull, bq[n], (2 * t4 + h) * 4);
        const float cbias = pb[col];
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const int r = m * 16 + g + v * 8;  // query in the half
            st[r * 32 + (col ^ swz(r))] =
                fmaxf(qsq[half * 32 + r] - 2.f * acc[m][n][v * 2 + h] + cb, 0.f) + cbias;
          }
      }
    __syncwarp();

    float ld[KMAX];
    int li[KMAX];
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      ld[j] = CUDART_INF_F;
      li[j] = 0;
    }
    // Live slots first, in slot order; a dead slot ranks after every live
    // one (its bias is >= BIG/2, a live distance is far below), so the
    // dead ones are inserted, in slot order, only when fewer than k slots
    // live.  The list is then the one that slot order gives.
    const unsigned live = __ballot_sync(kFull, pb[lane] < 0.5f * kBig);
    const float* mine = st + lane * 32;
    const int sw = swz(lane);
    for (int j = 0; j < bs; ++j)
      if ((live >> j) & 1u) insert(ld, li, mine[j ^ sw], j);  // warp-uniform
    if (__popc(live) < k)
      for (int j = 0; j < bs; ++j)
        if (!((live >> j) & 1u)) insert(ld, li, mine[j ^ sw], j);
    __syncwarp();  // every lane has read its row; the tile takes the output
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
      if (j < k) st[lane * k + j] = ld[j];
    __syncwarp();
    for (int e = lane; e < n_valid * k; e += 32) out_d[out0 + e] = st[e];
    __syncwarp();
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
      if (j < k) st[lane * k + j] = __int_as_float(li[j]);
    __syncwarp();
    for (int e = lane; e < n_valid * k; e += 32) out_i[out0 + e] = __float_as_int(st[e]);
    __syncwarp();
  }
}

template <typename T, int KMAX>
int launch(const int* ids, const float* q, const void* blocks, const float* bias,
           float* out_d, int* out_i, int nb, int n_q, int bs, int d, int k,
           cudaStream_t stream) {
  const int kpad = (d + 15) / 16 * 16;  // K padded to two mma depths
  // a query row's stride is 16 mod 32 floats: the 16-byte loads of a
  // quarter warp (rows g, g + 1; columns 4t) then hit 32 distinct banks
  const int stride = kpad % 32 == 16 ? kpad : kpad + 16;
  const Layout L(bs, d, (int)sizeof(T), stride);
  if (L.total > 232448) return (int)cudaErrorInvalidValue;  // d too large
  const int vec16 = (bs * d * (int)sizeof(T)) % 16 == 0;
  cudaError_t err = cudaFuncSetAttribute(
      scan_batched_topk_tc<T, KMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err == cudaSuccess)  // all of L1 as shared memory: two blocks an SM
    err = cudaFuncSetAttribute(scan_batched_topk_tc<T, KMAX>,
                               cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nb + kRun - 1) / kRun, (n_q + kQTile - 1) / kQTile);
  scan_batched_topk_tc<T, KMAX><<<grid, kThreads, L.total, stream>>>(
      ids, q, static_cast<const T*>(blocks), bias, out_d, out_i, nb, n_q, bs, d, k, kpad,
      stride, vec16);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_k(const int* ids, const float* q, const void* blocks, const float* bias,
               float* out_d, int* out_i, int nb, int n_q, int bs, int d, int k,
               cudaStream_t s) {
  if (k <= 4) return launch<T, 4>(ids, q, blocks, bias, out_d, out_i, nb, n_q, bs, d, k, s);
  if (k <= 10) return launch<T, 10>(ids, q, blocks, bias, out_d, out_i, nb, n_q, bs, d, k, s);
  if (k <= 16) return launch<T, 16>(ids, q, blocks, bias, out_d, out_i, nb, n_q, bs, d, k, s);
  return launch<T, 32>(ids, q, blocks, bias, out_d, out_i, nb, n_q, bs, d, k, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = int8 (the payload of `blocks`).
extern "C" int scan_batched_topk(const int* ids, const float* q,
                                 const void* blocks, int dtype,
                                 const float* bias, float* out_d, int* out_i,
                                 int nb, int n_q, int bs, int d, int k,
                                 void* stream) {
  if (bs < 1 || bs > 32 || k < 1 || k > bs || d < 4 || d % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (n_q == 0 || nb == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return dispatch_k<float>(ids, q, blocks, bias, out_d, out_i, nb, n_q, bs, d, k, s);
    case 1: return dispatch_k<__nv_bfloat16>(ids, q, blocks, bias, out_d, out_i, nb, n_q, bs, d, k, s);
    case 2: return dispatch_k<int8_t>(ids, q, blocks, bias, out_d, out_i, nb, n_q, bs, d, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
