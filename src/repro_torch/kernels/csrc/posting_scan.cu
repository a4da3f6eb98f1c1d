// Paged posting scan (sm_90a): the per-query schedule, with and without
// the fused per-page k-min and over int8 codes.
//
// Replaces three TPU kernels of src/repro/kernels/posting_scan/kernel.py:
// `scan_per_query_topk` (#4, :164), `scan_per_query_topk_q8` (#5, :225)
// and `scan_per_query` (#2, :52): page table[q, j] scored against query
// q, one kernel template.  The batched schedule's three forms,
// `scan_batched` (#3), `scan_batched_topk` (#6) and
// `scan_batched_topk_q8` (#7), are one tensor-core kernel of their own
// (scan_batched_topk.cu).
// All compute d = max(||q||^2 - 2 q.b + ||b||^2, 0) per slot.  The `_topk`
// forms add a per-slot bias (0 live, +BIG dead) and emit each (query,
// page) pair's k smallest distances with their slot indices, lowest slot
// first among equal values; the plain forms store every slot's distance.
// The payload is f32, bf16 or raw int8; the `_q8` form reads int8 codes
// of b = code * scale + zero with the pair's (scale, zero).
//
// The kernels' contract is BS <= 32 (one lane per slot), k <= BS, and
// d % 4 == 0 with a 16-byte aligned pool, so a lane reads its slot row in
// 4-value units (16, 8 or 4 bytes).  The per-query kernel stages pages in
// shared memory, so one page must fit the 227 KB a block may take (f32 at
// BS = 32: d up to about 1,750); a larger page is refused.
//
// Bounds on this card and what the design does about them:
//   * per_query at Q=1024, NB=256, BS=32, d=100 over an int8 pool: 1.7 GFLOP
//     (0.03 ms at the f32 rate) against the pages, the bias (34 MB), the
//     table and the candidates (21 MB at k=10, 67 MB at k=32): bytes bound.
//     On a random table every probe reads its page from memory (a page
//     recurs ~1.6 times, and the 839 MB pool is 17x the 50 MB L2), ~895 MB
//     (k=10) or ~943 MB (q8, k=32): 0.27 / 0.28 ms.  On the search path half
//     the table entries are absent pages (clamped to page 0, all-BIG bias),
//     and the live pages (~33 MB) fit in L2.  The design:
//   * a block owns one query: the query row is staged once in shared memory
//     and ||q||^2 (q8: sum(q)) summed once; its 8 warps take the query's NB
//     pairs from a shared counter, so a warp that meets dead pairs takes
//     more.  The table entry and the lane's bias of a warp's pair are loaded
//     into registers two pairs ahead;
//   * dead pairs cost no page: a warp tests the pair's bias (lane = slot,
//     one 128-byte line) with a ballot of bias < BIG/2; if no slot is live
//     it loads neither the page nor (scale, zero) and writes (BIG, slots
//     0..k-1), what the plain version gives there (precondition as in
//     scan_batched_topk.cu: the dead bias is float32(3e38), distances are
//     below ~1e31);
//   * pages are staged asynchronously: a live page's BS * d payload bytes
//     are contiguous, and a warp copies them with cp.async (16 bytes a lane
//     where the page size allows, else one 4-value unit a copy) into its
//     own two-slot ring, one page ahead of the one it scores (int8 at
//     d = 100: 55 KB a block, three blocks an SM by registers);
//   * lane = slot then reads its row from shared memory one unit at a time.
//     A row is d / 4 units; where that is even the ring pads each row by
//     one unit, so the 32 lanes' reads always fall in distinct banks;
//   * int8 payloads never meet the conversion unit nor the f32 pipes: the
//     block writes q once as 2^e * Q with |Q| < 2^30 in four signed 8-bit
//     digit planes (rounding error <= 2^-31 max|q|), so each 4-byte unit
//     of a row costs four dp4a for q.code (exact in int32, combined in
//     int64 and rounded once) and one for sum(code^2) (exact), against 4
//     conversions and 8 FMA in f32.  The q8 form adds sum(code) (one dp4a)
//     and takes q.b = scale q.code + zero sum(q) and ||b||^2 = scale^2
//     sum(code^2) + 2 scale zero sum(code) + d zero^2.  The plain version
//     rounds each b to f32 twice (fl(fl(code * scale) + zero)) and sums
//     those, so the two differ by ~2^-23 (|q||b| + ||b||^2) beside their
//     f32 rounding, against the atol 1e-2 + 1e-5 |d| they are held to;
//     bf16 and f32 rows are widened (scan_common.cuh) and summed with FMA;
//   * the k-min is a warp rank select: each lane's distance goes to a
//     per-warp row in shared memory, every lane reads the 32 values as 8
//     broadcast loads and counts those below its own (set.lt.f32 and an add
//     on the f32 pipes); one __match_any_sync ranks equal values by slot.
//     Lanes of rank < k write their candidate at that rank (at k = 32 each
//     store is one 128-byte line).  #2 runs on the same kernel with every
//     pair live, each lane storing its slot's distance.
//   What bounds it now (PERF.md section 6, chip_smoke.py): on a random
//   table the page reads, ~2.5 TB/s for 3.2 KB pages at random; on the
//   search path's mix the per-pair issue and latency of the live pairs
//   (the scoring loop, the select, the stores), with the pages in L2.
//   Staging with the Tensor Memory Accelerator (one bulk copy a page on an
//   mbarrier), deeper rings and deeper bias prefetch measured no faster.
// Registers and spills (`-Xptxas -v`) are printed by every chip_smoke.py
// run.  Plain C interface, loaded with ctypes; each entry returns
// cudaGetLastError(), and its `<entry>_smem_bytes` twin answers, without
// a launch, what the launcher asks for (repro_torch.analysis.smem mirrors
// the arithmetic).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>

#include "scan_common.cuh"
#include "tf32_mma.cuh"

namespace {

using namespace scancommon;
using tf32mma::cp_async;
using tf32mma::cp_async16;
using tf32mma::cp_async4;
using tf32mma::cp_async_commit;
using tf32mma::cp_async_wait;

constexpr int kPqMaxWarps = 8;
constexpr int kSmemPerBlock = 232448;           // the most one block may take
constexpr int kSmemTwoPerSm = 233472 / 2 - 1024;  // two blocks an SM

// Shared memory of the per-query kernel, in bytes: the query row (f32),
// its digit planes (int8 payloads) and the pair counter, then one region
// per warp: its ring of `stages` pages, per ring slot the lanes' bias and
// the (scale, zero), then the select's row.
struct PqLayout {
  int stages, warps;
  int ustride;      // a staged slot row, in 4-value units (odd)
  int page_stride;  // bytes of one ring slot (16-aligned)
  int vec16;        // the page goes as 16-byte pieces (rows not padded)
  int bias_off, sz_off, sel_off, warp_bytes, q_bytes, total;
};

PqLayout pq_layout(int bs, int d, int elem, int warps, int stages) {
  PqLayout L;
  const int du = d / 4;
  L.stages = stages;
  L.warps = warps;
  L.ustride = du % 2 ? du : du + 1;
  L.page_stride = (bs * L.ustride * 4 * elem + 15) & ~15;
  L.vec16 = L.ustride == du && (bs * d * elem) % 16 == 0;
  L.bias_off = stages * L.page_stride;
  L.sz_off = L.bias_off + stages * 32 * 4;
  L.sel_off = L.sz_off + ((stages * 2 * 4 + 15) & ~15);
  L.warp_bytes = L.sel_off + 32 * 4;
  L.q_bytes = 2 * ((d * 4 + 15) & ~15) + 16;
  L.total = L.q_bytes + warps * L.warp_bytes;
  return L;
}

// kQ8: int8 codes of b = code * scale + zero, sz[pair] = (scale, zero).
// kTopk: add the bias and keep the k-min; else store all BS distances.
template <typename T, bool kQ8, bool kTopk>
__global__ void __launch_bounds__(kPqMaxWarps * 32, 2)
scan_per_query_kernel(const int* __restrict__ table,
                      const float* __restrict__ q,
                      const T* __restrict__ blocks,
                      const float* __restrict__ bias,
                      const float* __restrict__ sz,
                      float* __restrict__ out_d, int* __restrict__ out_i,
                      int nb, int bs, int d, int k, PqLayout L) {
  static_assert(!kQ8 || sizeof(T) == 1, "the q8 form reads int8 codes");
  constexpr bool kBytes = sizeof(T) == 1;    // int8 payload: integer products
  constexpr int kUnit = 4 * (int)sizeof(T);  // bytes of four values
  extern __shared__ float4 smem4[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem4);
  float* qs = reinterpret_cast<float*>(sm);
  int4* qdig = reinterpret_cast<int4*>(sm + (L.q_bytes - 16) / 2);  // [d / 4]
  int* counter = reinterpret_cast<int*>(sm + L.q_bytes - 16);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned char* ring = sm + L.q_bytes + warp * L.warp_bytes;
  float* rbias = reinterpret_cast<float*>(ring + L.bias_off);  // [stages][32]
  float* rsz = reinterpret_cast<float*>(ring + L.sz_off);      // [stages][2]
  float* sel = reinterpret_cast<float*>(ring + L.sel_off);     // [32]

  const size_t pair0 = (size_t)blockIdx.x * nb;
  const float* qrow = q + (size_t)blockIdx.x * d;
  for (int t = threadIdx.x; t < d; t += blockDim.x) qs[t] = qrow[t];
  if (threadIdx.x == 0) *counter = 0;
  __syncthreads();
  float qsq = 0.f, qsum = 0.f, qmax = 0.f;
  for (int t = lane; t < d; t += 32) {
    qsq = fmaf(qs[t], qs[t], qsq);
    qsum += qs[t];
    qmax = fmaxf(qmax, fabsf(qs[t]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    qsq += __shfl_xor_sync(kFull, qsq, off);
    qsum += __shfl_xor_sync(kFull, qsum, off);
    qmax = fmaxf(qmax, __shfl_xor_sync(kFull, qmax, off));
  }
  // int8 payloads: q_t = 2^qexp * Q_t with |Q_t| < 2^30 (rounding error
  // <= 2^-31 max|q|), Q_t = d0 + 2^8 d1 + 2^16 d2 + 2^24 d3 in signed
  // digits; digit plane i of values 4u..4u+3 is word i of qdig[u], so the
  // products with a row's four code bytes are four dp4a.
  int qexp = 0;
  if constexpr (kBytes) {
    qexp = qmax > 0.f ? ilogbf(qmax) - 29 : 0;
    signed char* dig = reinterpret_cast<signed char*>(qdig);
    for (int t = threadIdx.x; t < d; t += blockDim.x) {
      int v = __float2int_rn(ldexpf(qs[t], -qexp));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int digit = i < 3 ? (int)(signed char)(v & 0xff) : v;
        dig[((t >> 2) * 4 + i) * 4 + (t & 3)] = (signed char)digit;
        v = (v - digit) >> 8;
      }
    }
    __syncthreads();
  }

  const bool active = lane < bs;
  const int du = d / 4;
  const int page_bytes = bs * d * (int)sizeof(T);
  const int n_stages = L.stages;

  // The warp's next two pairs: index in the row (nb: none), page, and the
  // lane's bias, loaded two issues before their use.
  auto fetch = [&](int& n, int& g, float& b) {
    int p = 0;
    if (lane == 0) p = atomicAdd(counter, 1);
    n = min(__shfl_sync(kFull, p, 0), nb);
    if (n < nb) {
      g = table[pair0 + n];
      if constexpr (kTopk) b = active ? bias[(pair0 + n) * bs + lane] : kBig;
    }
  };
  int n0, n1 = nb, g0 = 0, g1 = 0;
  float b0 = kBig, b1 = kBig;
  fetch(n0, g0, b0);
  if (n0 < nb) fetch(n1, g1, b1);

  int ring_pair = -1;     // lane s: the pair in ring slot s, -1 none
  unsigned live = 0;      // bit s: ring slot s holds a live page
  // Put the next pair into ring slot s: record it, test it for a live
  // slot, start its page's copy (one commit group per call, maybe empty).
  auto issue = [&](int s) {
    const int n = n0, g = g0;
    const float b = b0;
    n0 = n1;
    g0 = g1;
    b0 = b1;
    if (n0 < nb) fetch(n1, g1, b1);
    if (lane == s) ring_pair = n < nb ? n : -1;
    if (n < nb) {
      bool any = true;
      if constexpr (kTopk) {
        rbias[s * 32 + lane] = b;
        any = __any_sync(kFull, b < 0.5f * kBig);
      }
      live = any ? live | (1u << s) : live & ~(1u << s);
      if (any) {
        const unsigned char* src =
            reinterpret_cast<const unsigned char*>(blocks) + (size_t)g * page_bytes;
        unsigned char* dst = ring + s * L.page_stride;
        if (L.vec16) {
          for (int e = lane * 16; e < page_bytes; e += 32 * 16) cp_async16(dst + e, src + e);
        } else {
          for (int r = 0; r < bs; ++r)
            for (int c = lane; c < du; c += 32)
              cp_async<kUnit>(dst + (r * L.ustride + c) * kUnit, src + (r * du + c) * kUnit);
        }
        if constexpr (kQ8) {
          if (lane < 2) cp_async4(rsz + 2 * s + lane, sz + 2 * (pair0 + n) + lane);
        }
      }
    }
    cp_async_commit();
  };

  const float4* q4 = reinterpret_cast<const float4*>(qs);
  int head = 0, tail = 0;
  for (int s = 0; s + 1 < n_stages; ++s) {
    issue(tail);
    tail = tail + 1 == n_stages ? 0 : tail + 1;
  }
  for (;;) {
    __syncwarp();  // every lane is done with slot `tail`, scored last round
    issue(tail);
    tail = tail + 1 == n_stages ? 0 : tail + 1;
    if (n_stages == 2) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncwarp();  // slot `head` has landed for every lane
    const int n = __shfl_sync(kFull, ring_pair, head);
    if (n < 0) break;  // warp-uniform; every later slot is empty too
    const size_t pair = pair0 + n;
    if (kTopk && !((live >> head) & 1u)) {
      if (lane < k) {
        out_d[pair * k + lane] = kBig;
        out_i[pair * k + lane] = lane;
      }
    } else {
      float v = CUDART_INF_F;  // lanes past BS sort after every slot
      if (active) {
        const unsigned char* row = ring + head * L.page_stride + lane * L.ustride * kUnit;
        float cross, bsq;
        if constexpr (kBytes) {
          // exact integer sums: q.code in four digit planes, sum(code^2),
          // (q8) sum(code)
          const int* w4 = reinterpret_cast<const int*>(row);
          int x0 = 0, x1 = 0, x2 = 0, x3 = 0, c2 = 0, c1 = 0;
#pragma unroll 5
          for (int t = 0; t < du; ++t) {
            const int w = w4[t];
            const int4 qw = qdig[t];
            x0 = __dp4a(w, qw.x, x0);
            x1 = __dp4a(w, qw.y, x1);
            x2 = __dp4a(w, qw.z, x2);
            x3 = __dp4a(w, qw.w, x3);
            c2 = __dp4a(w, w, c2);
            if constexpr (kQ8) c1 = __dp4a(w, 0x01010101, c1);
          }
          const long long x = x0 + 256LL * x1 + 65536LL * x2 + 16777216LL * x3;
          cross = ldexpf(__ll2float_rn(x), qexp);  // q.code, rounded once
          bsq = (float)c2;
          if constexpr (kQ8) {
            // b = code * scale + zero: q.b = scale q.code + zero sum(q),
            // ||b||^2 = scale^2 sum(code^2) + 2 scale zero sum(code) + d zero^2
            const float scale = rsz[2 * head], zero = rsz[2 * head + 1];
            cross = fmaf(scale, cross, zero * qsum);
            bsq = fmaf(scale, fmaf(scale, bsq, 2.f * zero * (float)c1), (float)d * zero * zero);
          }
        } else {
          const T* b4 = reinterpret_cast<const T*>(row);
          float a0 = 0.f, a1 = 0.f, s0 = 0.f, s1 = 0.f;
#pragma unroll 5
          for (int t = 0; t < du; ++t) {
            const float4 qv = q4[t];
            const float4 b = load4(b4 + 4 * t);
            a0 = fmaf(b.x, qv.x, a0);
            a1 = fmaf(b.y, qv.y, a1);
            a0 = fmaf(b.z, qv.z, a0);
            a1 = fmaf(b.w, qv.w, a1);
            s0 = fmaf(b.x, b.x, s0);
            s1 = fmaf(b.y, b.y, s1);
            s0 = fmaf(b.z, b.z, s0);
            s1 = fmaf(b.w, b.w, s1);
          }
          cross = a0 + a1;
          bsq = s0 + s1;
        }
        v = fmaxf(qsq - 2.f * cross + bsq, 0.f);
        if constexpr (kTopk) v += rbias[head * 32 + lane];
      }
      if constexpr (kTopk) {
        // rank = #(values below v) + #(lower lanes with v's bits)
        sel[lane] = v;
        __syncwarp();
        float below = 0.f;
#pragma unroll
        for (int j = 0; j < 32; j += 4) {
          const float4 o = *reinterpret_cast<const float4*>(sel + j);
          below += (lt1(o.x, v) + lt1(o.y, v)) + (lt1(o.z, v) + lt1(o.w, v));
        }
        const unsigned same = __match_any_sync(kFull, __float_as_uint(v));
        const int rank = (int)below + __popc(same & ((1u << lane) - 1u));
        if (rank < k) {
          out_d[pair * k + rank] = v;
          out_i[pair * k + rank] = lane;
        }
      } else if (active) {
        out_d[pair * bs + lane] = v;
      }
    }
    head = head + 1 == n_stages ? 0 : head + 1;
  }
  cp_async_wait<0>();
}

bool bad_shape(int bs, int d, int k) {
  return bs < 1 || bs > 32 || k < 1 || k > bs || d < 4 || d % 4 != 0;
}

// The most warps and stages whose shared memory lets two blocks share an
// SM (variant 0), else the most that fit one block (1); -1: refused (d
// too large), L then the last shape tried.
int pq_choose(int bs, int d, int elem, PqLayout& L) {
  static const int kShapes[][2] = {{8, 2}, {4, 2}, {2, 2}, {1, 2}, {1, 1}};
  const int caps[2] = {kSmemTwoPerSm, kSmemPerBlock};
  for (int v = 0; v < 2; ++v)
    for (const auto& ws : kShapes) {
      L = pq_layout(bs, d, elem, ws[0], ws[1]);
      if (L.total <= caps[v]) return v;
    }
  return -1;
}

// The kernel's attributes for layout L: the opt-in size, and all of L1 as
// shared memory.
template <typename T, bool kQ8, bool kTopk>
cudaError_t prepare(const PqLayout& L) {
  auto* kernel = scan_per_query_kernel<T, kQ8, kTopk>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  return err;
}

template <typename T, bool kQ8, bool kTopk>
int launch_per_query(const int* table, const float* q, const void* blocks,
                     const float* bias, const float* sz, float* out_d,
                     int* out_i, int n_q, int nb, int bs, int d, int k,
                     cudaStream_t stream) {
  PqLayout L{};
  if (pq_choose(bs, d, (int)sizeof(T), L) < 0) return (int)cudaErrorInvalidValue;
  const cudaError_t err = prepare<T, kQ8, kTopk>(L);
  if (err != cudaSuccess) return (int)err;
  scan_per_query_kernel<T, kQ8, kTopk><<<(unsigned)n_q, L.warps * 32, L.total, stream>>>(
      table, q, static_cast<const T*>(blocks), bias, sz, out_d, out_i, nb, bs, d, k, L);
  return (int)cudaGetLastError();
}

// What launch_per_query asks for, without a launch: returns the bytes of
// dynamic shared memory; shape = {variant of pq_choose, warps, stages,
// blocks an SM by the occupancy calculator (0 where refused)}.  A CUDA
// error comes back negated.
template <typename T, bool kQ8, bool kTopk>
int query_per_query(int bs, int d, int* shape) {
  PqLayout L{};
  shape[0] = pq_choose(bs, d, (int)sizeof(T), L);
  shape[1] = L.warps;
  shape[2] = L.stages;
  shape[3] = 0;
  if (shape[0] >= 0) {
    auto* kernel = scan_per_query_kernel<T, kQ8, kTopk>;
    cudaError_t err = prepare<T, kQ8, kTopk>(L);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&shape[3], kernel, L.warps * 32,
                                                          L.total);
    if (err != cudaSuccess) return -(int)err;
  }
  return L.total;
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

// The launchers' shared memory, without a launch (see query_per_query);
// a shape the entry refuses before its shared memory is reckoned (bad BS,
// k, d or dtype) returns -cudaErrorInvalidValue.
extern "C" int scan_per_query_topk_smem_bytes(int dtype, int bs, int d, int k, int* shape) {
  if (bad_shape(bs, d, k) || dtype < 0 || dtype > 2) return -(int)cudaErrorInvalidValue;
  DISPATCH_DTYPE(query_per_query, false, true, bs, d, shape)
}

extern "C" int scan_per_query_smem_bytes(int dtype, int bs, int d, int* shape) {
  if (bad_shape(bs, d, 1) || dtype < 0 || dtype > 2) return -(int)cudaErrorInvalidValue;
  DISPATCH_DTYPE(query_per_query, false, false, bs, d, shape)
}

extern "C" int scan_per_query_topk_q8_smem_bytes(int bs, int d, int k, int* shape) {
  if (bad_shape(bs, d, k)) return -(int)cudaErrorInvalidValue;
  return query_per_query<int8_t, true, true>(bs, d, shape);
}
