// Batched paged scan with a fused per-(page, query) k-min on the tensor
// cores (sm_90a), over raw payloads and over int8 codes.
//
// Replaces two TPU kernels of src/repro/kernels/posting_scan/kernel.py:
//   * `scan_batched_topk` (`_scan_batched_topk_kernel`, #6): each unique
//     page ids[i] (BS <= 32 slots of d values, f32, bf16 or int8) against
//     every query, d = max(||q||^2 - 2 q.b + ||b||^2, 0) + bias[i, slot],
//     and per (page, query) the k smallest with their slots, ascending,
//     lowest slot first among equal values; out (NB, Q, k);
//   * `scan_batched_topk_q8` (`_scan_batched_topk_q8_kernel`, #7): the same
//     over int8 codes, each page dequantised as b = code * scale + zero
//     with its sz[i] = (scale, zero), the multiply and the add each
//     rounded (as the plain version rounds them).
//
// Bounds on this card at the spfresh-1b shapes (NB = 32,768 pages budget,
// Q = 1024, BS = 32, d = 100): 215 GFLOP of products over the full
// budget, 0.87 ms as two split-TF32 passes at 495 TFLOP/s.  #6 at k = 10
// writes 2.68 GB of candidates (0.80 ms at 3.35 TB/s), so its bound is
// the product; #7 at k = min(10 * 4, BS) = 32 writes 8.59 GB (8.70 GB
// moved in all): bytes, 2.60 ms.  On the search path only the probed
// pages are live (10,393 of 32,768 rows on the main path): the product
// falls to 0.28 ms and the bounds are the stores, 0.81 ms (#6) and
// 2.58 ms (#7).  This design:
//   * dead pages cost no product and no select.  A page whose every bias
//     entry is >= BIG/2 (the budget's padding rows, clamped to page 0, and
//     pages with no live slot) gets (BIG, slot j) for j < k written
//     directly, with 16-byte stores from registers where k % 4 == 0.
//     Precondition: the dead bias is float32(3e38) and distances are below
//     ~1e31, as on the search path; then fmax(d, 0) + 3e38 rounds to
//     float32(3e38) for every slot (its ulp is 2^104), all values tie, and
//     the plain version emits exactly these candidates (the TPU kernel the
//     same values, with slot 0 k times: its k-min masks a taken slot with
//     the same BIG);
//   * a block keeps a tile of 64 queries resident in shared memory (f32)
//     and walks a run of 64 pages, 4 per step; warp w takes page w / 2 of
//     the step against query half w % 2.  At d = 100 an int8 block holds
//     88 KB, so two blocks share an SM (16 warps); bf16 114 KB (two), f32
//     165 KB (one);
//   * pages are staged asynchronously and stay in their payload type: each
//     live page's BS * d bytes are contiguous, so a warp copies them with
//     cp.async (16 bytes a lane where the page size allows, else 4) into a
//     two-step ring while the current step computes (one barrier per
//     step), and (q8) the page's (scale, zero) beside them; the mma's B
//     fragments are converted to f32 as they are loaded (int8 by a byte
//     permute and one add, not the conversion unit: scan_common.cuh), and
//     ||b||^2 is summed in f32 from the same fragments (q8: from the
//     dequantised values) and reduced over the quad that holds a slot;
//   * the product runs as `mma.sync` m16n8k8 TF32 with M = queries (two
//     m-tiles), N = slots (four n-tiles), K = d padded to a multiple of 16
//     and permuted within each 16 so that every operand arrives in one
//     16-byte (or 8, 4) shared load.  Precision: q = q_hi + q_lo, split in
//     registers (tf32_mma.cuh); bf16 and int8 payloads are exact in TF32,
//     so q_lo.b + q_hi.b (two passes); f32 payloads are split too, three
//     passes.  A dequantised value is not exact in TF32, but its code is:
//     the q8 form takes the product on the codes in two passes and forms
//     q.b = scale * (q.code) + zero * sum(q), with sum(q) summed once per
//     query tile beside ||q||^2; that differs from the plain version's
//     q.fl(fl(code * scale) + zero) by ~2^-23 |q||b|.  The result carries
//     ~2^-21 of |q||b| against the 1e-5 |d| tolerance the kernel is held
//     to;
//   * the k-min costs a thread, not a warp: the accumulator tile goes to a
//     per-warp 32 x 32 staging tile in shared memory (swizzled, no bank
//     conflicts), and lane j owns query j of the warp's half.  For k <= 16
//     it keeps a sorted list of KMAX in {4, 10, 16} (value, slot) pairs in
//     registers and inserts the page's live slots in order with strict <,
//     so the lowest slot stays first among equal values (dead slots only
//     when fewer than k live).  For k in 17..32 (KMAX = 32; #7's k = 32
//     sorts the whole row) a list would cost ~32 x 32 x 6 instructions a
//     pair, so the lane counts each slot's rank instead: slot i's rank is
//     the number of slots j < i with v_j <= v_i plus those j > i with
//     v_j < v_i, the comparison fixed per (i, j) at compile time.  Each of
//     the 496 pairs costs one compare (a set to 1.0 or 0.0) and two FMAs
//     into the ranks, kept four to an f32 word in base 64 (every word an
//     integer below 2^23, so exact): the select runs on the f32 pipes, not
//     the narrower integer one, on 40 registers of data.  Dead slots need
//     no mask: a dead value is >= BIG/2, above every live one, and the
//     dead ones tie at float32(3e38), so they rank after the live slots in
//     slot order.  A slot of rank < k is written at its rank into the
//     staging row, swizzled so that 32 lanes writing one rank hit 32 banks
//     (PERF.md section 6 lists the selects tried);
//   * the 32 queries' candidates are contiguous in (NB, Q, k): they go out
//     through the same staging tile as coalesced rows, values and slots
//     each, where k % 4 == 0 as 16-byte stores (four 128-byte lines a
//     warp store).
// What bounds it now (PERF.md section 6, chip_smoke.py): the live pages'
// instruction issue (the select, the copy-out through the staging tile,
// the product's operand loads and splits); at k = 32 the candidate stores
// overlap it only in part, over the full budget and on the main path's
// mix, where the padding rows are stores alone.
// Registers and spills (`-Xptxas -v`, printed by every chip_smoke.py run):
// sixteen instantiations (payload x KMAX, and int8 q8 x KMAX) under the
// 128 of __launch_bounds__(256, 2).
// Contract: 1 <= BS <= 32, 1 <= k <= BS, d % 4 == 0, a 16-byte aligned
// pool, ids in [0, B).  Plain C interface, loaded with ctypes; returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>

#include "scan_common.cuh"
#include "tf32_mma.cuh"

namespace {

using namespace scancommon;
using namespace tf32mma;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kQTile = 64;          // queries resident per block
constexpr int kStep = kWarps / 2;   // pages per step, two warps each
constexpr int kRun = 64;            // pages per block

// code * scale + zero, rounded after the multiply and after the add.
__device__ __forceinline__ float dequant(float c, float scale, float zero) {
  return __fadd_rn(__fmul_rn(c, scale), zero);
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

// 64^e for e in 0..3: a rank field's weight in its word.
__device__ __forceinline__ constexpr float base64(int e) {
  return e == 0 ? 1.f : e == 1 ? 64.f : e == 2 ? 4096.f : 262144.f;
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

// Shared-memory layout, in bytes from the start (every part 16-aligned):
// the fixed-size parts first, at offsets known at compile time, so that
// only the query tile's offset takes a register.
struct Layout {
  static constexpr int stage = 0;                          // [kWarps][32][32] f32
  static constexpr int qsq = stage + 4 * kWarps * 32 * 32;  // [kQTile]
  static constexpr int qsum = qsq + 4 * kQTile;             // [kQTile]
  static constexpr int bias = qsum + 4 * kQTile;            // [2][kStep][32]
  static constexpr int sz = bias + 4 * 2 * kStep * 32;      // [2][kStep][2]
  static constexpr int live = sz + 4 * 2 * kStep * 2;       // [2][kStep]
  static constexpr int pages = live + 4 * 2 * kStep;        // [2][kStep][page_stride]
  static_assert(pages % 16 == 0, "the page ring takes 16-byte copies");
  int page_stride, qs, total;                               // qs: [kQTile][stride]
  __host__ __device__ Layout(int bs, int d, int elem, int stride) {
    page_stride = (bs * d * elem + 15) & ~15;
    qs = pages + 2 * kStep * page_stride;
    total = qs + 4 * kQTile * stride;
  }
};

// kQ8: the payload is int8 codes, page i dequantised with sz[i] = (scale,
// zero) (#7); else f32, bf16 or int8 values as they are (#6).
template <typename T, int KMAX, bool kQ8>
__global__ void __launch_bounds__(kThreads, 2)
scan_batched_topk_tc(const int* __restrict__ ids, const float* __restrict__ q,
                     const T* __restrict__ blocks, const float* __restrict__ bias,
                     const float* __restrict__ sz,
                     float* __restrict__ out_d, int* __restrict__ out_i,
                     int nb, int n_q, int bs, int d, int k, int kpad, int stride,
                     int vec16, int vec_out) {
  static_assert(!kQ8 || sizeof(T) == 1, "the q8 form reads int8 codes");
  constexpr bool kSplitB = sizeof(T) == 4;  // f32 payloads need a lo part
  extern __shared__ float4 smem4[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem4);
  const Layout L(bs, d, (int)sizeof(T), stride);
  unsigned char* pages = sm + Layout::pages;
  float* qs = reinterpret_cast<float*>(sm + L.qs);
  float* stg = reinterpret_cast<float*>(sm + Layout::stage);
  float* qsq = reinterpret_cast<float*>(sm + Layout::qsq);
  float* qsum = reinterpret_cast<float*>(sm + Layout::qsum);
  float* pbias = reinterpret_cast<float*>(sm + Layout::bias);
  float* psz = reinterpret_cast<float*>(sm + Layout::sz);
  int* plive = reinterpret_cast<int*>(sm + Layout::live);

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
        if (kQ8 && lane < 2) psz[(buf * kStep + warp) * 2 + lane] = sz[(size_t)page * 2 + lane];
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
  // ||q||^2 and sum(q) in f32, a warp per query: lane-strided partial
  // sums, butterfly
  for (int r = warp; r < kQTile; r += kWarps) {
    float s2 = 0.f, s1 = 0.f;
    if (qt0 + r < n_q) {
      const float* qr = q + (size_t)(qt0 + r) * d;
      for (int t = lane; t < d; t += 32) {
        s2 = fmaf(qr[t], qr[t], s2);
        s1 += qr[t];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s2 += __shfl_xor_sync(kFull, s2, off);
      s1 += __shfl_xor_sync(kFull, s1, off);
    }
    if (lane == 0) {
      qsq[r] = s2;
      qsum[r] = s1;
    }
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
      if (vec_out) {  // k % 4 == 0: 16-byte stores, four slots each
        float4* od = reinterpret_cast<float4*>(out_d + out0);
        int4* oi = reinterpret_cast<int4*>(out_i + out0);
        const int adv = 128 % k;        // slot step of 32 vectors
        int c = (4 * lane) % k;
        for (int e = lane; e < n_valid * k / 4; e += 32) {
          od[e] = make_float4(kBig, kBig, kBig, kBig);
          oi[e] = make_int4(c, c + 1, c + 2, c + 3);
          c += adv;
          if (c >= k) c -= k;
        }
      } else {
        for (int e = lane; e < n_valid * k; e += 32) {
          out_d[out0 + e] = kBig;
          out_i[out0 + e] = e % k;
        }
      }
      continue;
    }
    const T* pp = reinterpret_cast<const T*>(pages + (buf * kStep + wp) * L.page_stride);
    const float* pb = pbias + (buf * kStep + wp) * 32;
    float scale = 1.f, zero = 0.f;
    if constexpr (kQ8) {
      scale = psz[(buf * kStep + wp) * 2];
      zero = psz[(buf * kStep + wp) * 2 + 1];
    }

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
        if constexpr (kQ8) {             // ||b||^2 of the dequantised values
          if (in_d) {
            const float x = dequant(bv[n].x, scale, zero), y = dequant(bv[n].y, scale, zero);
            const float z = dequant(bv[n].z, scale, zero), w = dequant(bv[n].w, scale, zero);
            bq[n] = fmaf(x, x, bq[n]);
            bq[n] = fmaf(y, y, bq[n]);
            bq[n] = fmaf(z, z, bq[n]);
            bq[n] = fmaf(w, w, bq[n]);
          }
        } else {
          bq[n] = fmaf(bv[n].x, bv[n].x, bq[n]);
          bq[n] = fmaf(bv[n].y, bv[n].y, bq[n]);
          bq[n] = fmaf(bv[n].z, bv[n].z, bq[n]);
          bq[n] = fmaf(bv[n].w, bv[n].w, bq[n]);
        }
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
          } else {  // exact in TF32 (q8: the codes)
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
    float rq[2][2], rz[2][2];            // the lane's four query rows:
#pragma unroll                           // ||q||^2 and (q8) zero * sum(q)
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int r = half * 32 + m * 16 + g + v * 8;
        rq[m][v] = qsq[r];
        rz[m][v] = kQ8 ? zero * qsum[r] : 0.f;
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
            float cross = acc[m][n][v * 2 + h];
            if constexpr (kQ8) cross = fmaf(scale, cross, rz[m][v]);
            st[r * 32 + (col ^ swz(r))] = fmaxf(rq[m][v] - 2.f * cross + cb, 0.f) + cbias;
          }
      }
    __syncwarp();

    const float* mine = st + lane * 32;
    const int sw = swz(lane);
    if constexpr (KMAX <= 16) {
      float ld[KMAX];
      int li[KMAX];
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        ld[j] = CUDART_INF_F;
        li[j] = 0;
      }
      // Live slots first, in slot order; a dead slot ranks after every
      // live one (its bias is >= BIG/2, a live distance is far below), so
      // the dead ones are inserted, in slot order, only when fewer than k
      // slots live.  The list is then the one that slot order gives.
      const unsigned live = __ballot_sync(kFull, pb[lane] < 0.5f * kBig);
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
    } else {
      // The rank of every slot of the row, counted: slots past BS read +inf
      // and rank after all others.  Slot j's rank starts at j (the slots
      // before it) and each pair (i < j) moves one rank: j sorts before i
      // iff v_j < v_i, else i sorts before j (so ties keep the lower slot
      // first).  The ranks are kept four to a word in base 64, as f32: a
      // field only ever holds 0..31 (j's starts at j and falls at most j
      // times, i's rises at most 31 - i times), so no carry crosses fields
      // and a word stays an integer below 2^23, exact in f32.  A compare
      // is then one set (1.0 or 0.0) and two FMAs on the f32 pipes, not
      // on the narrower integer pipe.
      float v[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) v[j] = j < bs ? mine[j ^ sw] : CUDART_INF_F;
      float rk[8];
#pragma unroll
      for (int w = 0; w < 8; ++w)
        rk[w] = (4 * w) + (4 * w + 1) * 64.f + (4 * w + 2) * 4096.f + (4 * w + 3) * 262144.f;
      // Pairs by their gap j - i, so that neighbouring compares update
      // different words.
#pragma unroll
      for (int gap = 1; gap < 32; ++gap)
#pragma unroll
        for (int i = 0; i + gap < 32; ++i) {
          const int j = i + gap;
          const float c = lt1(v[j], v[i]);  // 1 where j sorts before i
          rk[i >> 2] = fmaf(c, base64(i & 3), rk[i >> 2]);
          rk[j >> 2] = fmaf(c, -base64(j & 3), rk[j >> 2]);
        }
      uint32_t rb[8];  // the words as integers: 2^23 + w has w in its mantissa
#pragma unroll
      for (int w = 0; w < 8; ++w) rb[w] = __float_as_uint(rk[w] + 8388608.f);
      // (an opaque unpack: each pass re-reads the packed words, so the 32
      // ranks are never all live beside the values)
      auto rank = [&](int i) {
        int r;
        asm volatile("bfe.u32 %0, %1, %2, 6;" : "=r"(r) : "r"(rb[i >> 2]), "r"(6 * (i & 3)));
        return r;
      };
      // The staged rows out, coalesced.  Where k % 4 == 0, lane (b, c) of
      // (l % 4, l / 4) moves columns 4c..4c+3 of row r0 + (b & 1) + 8 (b >> 1)
      // as one 16-byte store, r0 over the eight values with bits 0 and 3
      // clear: those four rows' swizzles differ in bits 0 and 1 only, so
      // each of the four column loads meets 32 banks.  Else one row a
      // step, a column a lane.
      auto copy_out = [&](float* dst) {
        if (vec_out) {
          const int c = 4 * (lane >> 2);
          const int rb = (lane & 1) + 8 * ((lane >> 1) & 1);
#pragma unroll
          for (int it = 0; it < 8; ++it) {
            const int r = 2 * (it & 3) + 16 * (it >> 2) + rb;
            const int z = swz(r);
            const float* src = st + r * 32;
            if (r < n_valid && c < k)
              *reinterpret_cast<float4*>(dst + (size_t)r * k + c) =
                  make_float4(src[c ^ z], src[(c + 1) ^ z], src[(c + 2) ^ z], src[(c + 3) ^ z]);
          }
        } else {
          for (int r = 0; r < n_valid; ++r)
            if (lane < k) dst[(size_t)r * k + lane] = st[r * 32 + (lane ^ swz(r))];
        }
      };
      __syncwarp();  // every lane has read its row; the tile takes the output
      float* row = st + lane * 32;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = rank(i);
        if (r < k) row[r ^ sw] = v[i];
      }
      __syncwarp();
      copy_out(out_d + out0);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = rank(i);
        if (r < k) row[r ^ sw] = __int_as_float(i);
      }
      __syncwarp();
      copy_out(reinterpret_cast<float*>(out_i + out0));
      __syncwarp();
    }
  }
}

template <typename T, int KMAX, bool kQ8>
int launch(const int* ids, const float* q, const void* blocks, const float* bias,
           const float* sz, float* out_d, int* out_i, int nb, int n_q, int bs, int d,
           int k, cudaStream_t stream) {
  const int kpad = (d + 15) / 16 * 16;  // K padded to two mma depths
  // a query row's stride is 16 mod 32 floats: the 16-byte loads of a
  // quarter warp (rows g, g + 1; columns 4t) then hit 32 distinct banks
  const int stride = kpad % 32 == 16 ? kpad : kpad + 16;
  const Layout L(bs, d, (int)sizeof(T), stride);
  if (L.total > 232448) return (int)cudaErrorInvalidValue;  // d too large
  const int vec16 = (bs * d * (int)sizeof(T)) % 16 == 0;
  const int vec_out = k % 4 == 0 && reinterpret_cast<uintptr_t>(out_d) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out_i) % 16 == 0;
  auto* kernel = scan_batched_topk_tc<T, KMAX, kQ8>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err == cudaSuccess)  // all of L1 as shared memory: two blocks an SM
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nb + kRun - 1) / kRun, (n_q + kQTile - 1) / kQTile);
  kernel<<<grid, kThreads, L.total, stream>>>(ids, q, static_cast<const T*>(blocks), bias, sz,
                                              out_d, out_i, nb, n_q, bs, d, k, kpad, stride,
                                              vec16, vec_out);
  return (int)cudaGetLastError();
}

template <typename T, bool kQ8>
int dispatch_k(const int* ids, const float* q, const void* blocks, const float* bias,
               const float* sz, float* out_d, int* out_i, int nb, int n_q, int bs, int d,
               int k, cudaStream_t s) {
  if (k <= 4) return launch<T, 4, kQ8>(ids, q, blocks, bias, sz, out_d, out_i, nb, n_q, bs, d, k, s);
  if (k <= 10) return launch<T, 10, kQ8>(ids, q, blocks, bias, sz, out_d, out_i, nb, n_q, bs, d, k, s);
  if (k <= 16) return launch<T, 16, kQ8>(ids, q, blocks, bias, sz, out_d, out_i, nb, n_q, bs, d, k, s);
  return launch<T, 32, kQ8>(ids, q, blocks, bias, sz, out_d, out_i, nb, n_q, bs, d, k, s);
}

bool bad_shape(int bs, int d, int k) {
  return bs < 1 || bs > 32 || k < 1 || k > bs || d < 4 || d % 4 != 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = int8 (the payload of `blocks`).
extern "C" int scan_batched_topk(const int* ids, const float* q,
                                 const void* blocks, int dtype,
                                 const float* bias, float* out_d, int* out_i,
                                 int nb, int n_q, int bs, int d, int k,
                                 void* stream) {
  if (bad_shape(bs, d, k)) return (int)cudaErrorInvalidValue;
  if (n_q == 0 || nb == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return dispatch_k<float, false>(ids, q, blocks, bias, nullptr, out_d, out_i, nb, n_q, bs, d, k, s);
    case 1:
      return dispatch_k<__nv_bfloat16, false>(ids, q, blocks, bias, nullptr, out_d, out_i, nb, n_q,
                                              bs, d, k, s);
    case 2:
      return dispatch_k<int8_t, false>(ids, q, blocks, bias, nullptr, out_d, out_i, nb, n_q, bs, d, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// int8 codes; sz (NB, 2) f32 per-unique-page (scale, zero).
extern "C" int scan_batched_topk_q8(const int* ids, const float* q,
                                    const int8_t* codes, const float* bias,
                                    const float* sz, float* out_d, int* out_i,
                                    int nb, int n_q, int bs, int d, int k,
                                    void* stream) {
  if (bad_shape(bs, d, k)) return (int)cudaErrorInvalidValue;
  if (n_q == 0 || nb == 0) return 0;
  return dispatch_k<int8_t, true>(ids, q, codes, bias, sz, out_d, out_i, nb, n_q, bs, d, k,
                                  (cudaStream_t)stream);
}
