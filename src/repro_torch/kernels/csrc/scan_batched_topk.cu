// Batched paged scan on the tensor cores (sm_90a): every slot's distance,
// or a fused per-(page, query) k-min over raw payloads and over int8
// codes.
//
// Replaces three TPU kernels of src/repro/kernels/posting_scan/kernel.py:
//   * `scan_batched` (`_scan_batched_kernel`, #3): each unique page ids[i]
//     (BS <= 32 slots of d values, f32, bf16 or int8) against every
//     query, every slot's d = max(||q||^2 - 2 q.b + ||b||^2, 0); out
//     (NB, Q, BS).  An id of -1 is a padding page, whose rows are written
//     as float32(3e38) (the TPU kernel scores the caller's clamped page 0
//     and the caller masks it afterwards, one more pass over the output);
//   * `scan_batched_topk` (`_scan_batched_topk_kernel`, #6): the same plus
//     bias[i, slot], and per (page, query) the k smallest with their
//     slots, ascending, lowest slot first among equal values; out (NB, Q,
//     k);
//   * `scan_batched_topk_q8` (`_scan_batched_topk_q8_kernel`, #7): #6 over
//     int8 codes, each page dequantised as b = code * scale + zero with
//     its sz[i] = (scale, zero), the multiply and the add each rounded
//     (as the plain version rounds them).
//
// Bounds on this card at the spfresh-1b shapes (NB = 32,768 pages budget,
// Q = 1024, BS = 32, d = 100): 215 GFLOP of products over the full
// budget, 0.87 ms as two split-TF32 passes at 495 TFLOP/s (1.5 ms at the
// ~320 TFLOP/s that `mma.sync` reaches on this card,
// scripts/mma_sync_rate_on_card.py).  #3 writes every slot, 4.29 GB
// (4.40 GB moved with the pages): bytes, 1.31 ms, also where most rows
// are padding, since those are stores too.  #6 at k = 10 writes 2.68 GB
// of candidates (0.80 ms at 3.35 TB/s), so its bound is the product; #7
// at k = min(10 * 4, BS) = 32 writes 8.59 GB (8.70 GB moved in all):
// bytes, 2.60 ms.  On the search path only the probed pages are live
// (10,393 of 32,768 rows on the main path): the product falls to 0.28 ms
// and the bounds are the stores, 0.81 ms (#6) and 2.58 ms (#7).  This
// design:
//   * dead pages cost no product and no select.  A page whose every bias
//     entry is >= BIG/2 (the budget's padding rows, clamped to page 0, and
//     pages with no live slot) gets (BIG, slot j) for j < k written
//     directly, with 16-byte stores from registers where k % 4 == 0.
//     Precondition: the dead bias is float32(3e38) and distances are below
//     ~1e31, as on the search path; then fmax(d, 0) + 3e38 rounds to
//     float32(3e38) for every slot (its ulp is 2^104), all values tie, and
//     the plain version emits exactly these candidates (the TPU kernel the
//     same values, with slot 0 k times: its k-min masks a taken slot with
//     the same BIG).  #3's padding pages (id -1) take the same path: no
//     load, BIG in every (query, slot) of their rows;
//   * a block keeps a tile of 64 queries resident in shared memory (f32)
//     and walks a run of 64 pages, 4 per step; warp w takes page w / 2 of
//     the step against query half w % 2.  At d = 100 an int8 block holds
//     88 KB, so two blocks share an SM (16 warps); bf16 114 KB (two), f32
//     165 KB (one);
//   * where that layout passes the 227 KB a block may take (at BS = 32:
//     d above 148 for f32, 248 for bf16; #3, which keeps its query tile
//     twice, above 144 and 208), the launcher takes a wide shape for f32
//     and bf16 pages: a one-step ring (a step's pages are loaded after the
//     step before is consumed, so the copy no longer overlaps the
//     product within a block), and for f32 four warps, two pages a step.
//     At d = 256 #6 then holds 152 KB (f32) or 169 KB (bf16), #3 206 KB:
//     one block an SM.  int8 pages (#6, #7, #3) keep the default layout,
//     which at d = 256 holds 170 KB (#3 206 KB).  The largest d at BS = 32
//     is 408 (f32), 372 (bf16), 372 (int8) for #6 and #7, and 296, 292,
//     292 for #3; a larger d is refused;
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
// #3 is the mode KMAX = 0 of the same kernel: no bias, no select, k = BS.
// It differs where the select no longer hides the product's overheads:
//   * the query tile is split once per block, as the tile is staged, and
//     kept as q_hi and q_lo tiles in fragment order: a lane's A fragment
//     for one k-step and m-tile is one 16-byte load, with no split and no
//     register moves in the product loop.  The page's four B loads of a
//     16-column step issue together, and each accumulator's passes are
//     issued pass by pass over the eight (m, n) tiles.  With no staging
//     tile the block holds 83 KB at d = 100 (int8; bf16 108 KB, f32
//     160 KB);
//   * the accumulators are the output block: lane (g, t) stores its
//     slots 8n + 2t, 8n + 2t + 1 of four queries as float2 pairs straight
//     from registers (a warp store fills 32-byte sectors of 8 rows), so
//     the warp's 32 queries x BS slots go out as one contiguous 4 KB run
//     (BS = 32) without a pass through shared memory;
//   * the grid walks the 16 query tiles fastest and a block takes a run
//     of 256 pages, so the blocks of one run are resident together and
//     read its pages from L2 after the first (the 4.3 GB of stores would
//     evict them before the grid came back to the run), and the block's
//     set-up is paid once per 256 pages.
// The pairs form of #6 and #7, chosen at run time (so the kernels' names
// stay as they are): the search reads only the (page, query) pairs that
// a query probed, under 1% of the live pages x Q (0.65% at 27,700 live
// pages, Q = 1,024, 256 probe rows a query).  Given pos (NB, Q) int16, the
// row of each query's probe list that holds page i (-1: not probed; a
// page sits at most once in a row), read a step ahead:
//   * the product still runs over every live page and every query tile;
//   * a warp none of whose 32 queries probed its page skips the staging
//     tile, the select and the stores (about 4 warps in 5);
//   * a probing warp stages its tile, then sorts each probing query's row
//     with the whole warp, a bitonic network over the 32 lanes on (value
//     bits, slot), and lanes 0..k-1 store the k candidates at (query, row)
//     of a (Q, nbq, k) output.  The lane-per-query selects would hold the
//     block's barrier for the one probing lane of most such warps (1.5 ms
//     more at 27,700 pages, k = 10; PERF.md section 6);
//   * a dead page writes (BIG, slot j) at its probed pairs only; the
//     caller fills the output with (BIG, -1) first.
// What bounds it now (PERF.md section 6, chip_smoke.py): the pairs form
// the product's issue over every live page (its operand loads and splits,
// the block's step barriers): 3.1 ms at 27,700 live pages with no pair
// probed, 3.4-3.5 ms as the search probes them.  The full form the live
// pages' instruction issue (the select, the copy-out through the staging
// tile, the product); at k = 32 the candidate stores overlap it only in
// part, over the full budget and on the main path's mix, where the
// padding rows are stores alone.  #3 the
// tensor pipe and the block's step structure: its product alone is 1.5 ms
// at the measured `mma.sync` rate, its page staging, barriers and stores
// without a product 1.9 ms, and the two overlap only in part (about
// 3.1 ms over the full budget, int8).
// Registers and spills (`-Xptxas -v`, printed by every chip_smoke.py run):
// twenty-nine instantiations (payload x KMAX in {0 (#3), 4, 10, 16, 32},
// and int8 q8 x KMAX, in the default shape; f32 and bf16 x KMAX in the
// wide one), the default shape's under the 128 of
// __launch_bounds__(256, 2), the f32 wide shape's (128 threads) at most
// 167, no spills.
// Contract: 1 <= BS <= 32, 1 <= k <= BS, d % 4 == 0 and within the
// largest d above, a 16-byte aligned pool, ids in [0, B) (#3: or -1,
// padding).  Plain C interface, loaded
// with ctypes; returns cudaGetLastError().  Each entry's `<entry>_smem_bytes`
// twin answers, without a launch, what the launcher asks for
// (repro_torch.analysis.smem mirrors the arithmetic).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>

#include "scan_common.cuh"
#include "tf32_mma.cuh"

namespace {

using namespace scancommon;
using namespace tf32mma;

constexpr int kQTile = 64;          // queries resident per block
constexpr int kRun = 64;            // pages per block
constexpr int kRunAll = 256;        // ... for #3, whose block set-up is the larger share
constexpr int kSmemMax = 232448;    // dynamic shared memory a block may take (227 KB)

// The block's shape: two warps a page (one per 32-query half), so warps / 2
// pages a step, and a ring of `ring` steps of pages.  The default shape
// keeps the next step's pages in flight while one step computes.  The
// wide shape serves f32 and bf16 pages whose default ring and query tile
// pass kSmemMax (d = 256): one step of pages at a time, and for f32
// payloads four warps, two pages a step.
template <typename T, bool kWide>
struct Shape {
  static constexpr int warps = kWide && sizeof(T) == 4 ? 4 : 8;
  static constexpr int threads = warps * 32;
  static constexpr int step = warps / 2;
  static constexpr int ring = kWide ? 1 : 2;
};

// code * scale + zero, rounded after the multiply and after the add.
__device__ __forceinline__ float dequant(float c, float scale, float zero) {
  return __fadd_rn(__fmul_rn(c, scale), zero);
}

// v = hi + lo (tf32_mma.cuh's split, value by value): v becomes hi.
__device__ __forceinline__ void split4(float4& v, float4& lo) {
  uint32_t h[4], l[4];
  split(v.x, h[0], l[0]);
  split(v.y, h[1], l[1]);
  split(v.z, h[2], l[2]);
  split(v.w, h[3], l[3]);
  v = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                  __uint_as_float(h[3]));
  lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                   __uint_as_float(l[3]));
}

// #3's query tiles in fragment order: the float offset of the A fragment
// (four values) of lane `lane` for k-step ks of 16-column block kb and
// m-tile mt (16 queries of the 64-query tile).
__device__ __forceinline__ int frag_offset(int kb, int ks, int mt, int lane) {
  return (((kb * 2 + ks) * (kQTile / 16) + mt) * 32 + lane) * 4;
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
// only the query tiles' offsets take registers.  kAll (#3) has no staging
// tile and keeps the query tile split, q_hi in qs and q_lo in qlo, each
// in fragment order (frag_offset).
template <bool kAll, int kWarps, int kRing>
struct Layout {
  static constexpr int kStep = kWarps / 2;
  static constexpr int stage = 0;                          // [kWarps][32][32] f32
  static constexpr int qsq = stage + (kAll ? 0 : 4 * kWarps * 32 * 32);  // [kQTile]
  static constexpr int qsum = qsq + 4 * kQTile;             // [kQTile]
  static constexpr int bias = qsum + 4 * kQTile;            // [kRing][kStep][32]
  static constexpr int sz = bias + 4 * kRing * kStep * 32;  // [kRing][kStep][2]
  static constexpr int live = sz + 4 * kRing * kStep * 2;   // [kRing][kStep]
  static constexpr int pages = (live + 4 * kRing * kStep + 15) & ~15;  // [kRing][kStep][page_stride]
  int page_stride, qs, qlo, total;                          // qs, qlo: [kQTile][stride]
  __host__ __device__ Layout(int bs, int d, int elem, int stride) {
    page_stride = (bs * d * elem + 15) & ~15;
    qs = pages + kRing * kStep * page_stride;
    qlo = qs + 4 * kQTile * stride;
    total = qlo + (kAll ? 4 * kQTile * stride : 0);
  }
};

// kQ8: the payload is int8 codes, page i dequantised with sz[i] = (scale,
// zero) (#7); else f32, bf16 or int8 values as they are (#6).  KMAX = 0
// is #3: no bias, no k-min, every slot's distance stored (k = BS), and a
// page whose id is -1 is padding, written as BIG.
template <typename T, int KMAX, bool kQ8, bool kWide>
__global__ void __launch_bounds__(Shape<T, kWide>::threads, 2)
scan_batched_topk_tc(const int* __restrict__ ids, const float* __restrict__ q,
                     const T* __restrict__ blocks, const float* __restrict__ bias,
                     const float* __restrict__ sz,
                     float* __restrict__ out_d, int* __restrict__ out_i,
                     const int16_t* __restrict__ pos, int nbq,
                     int nb, int n_q, int bs, int d, int k, int kpad, int stride,
                     int vec16, int vec_out) {
  static_assert(!kQ8 || sizeof(T) == 1, "the q8 form reads int8 codes");
  constexpr bool kSplitB = sizeof(T) == 4;  // f32 payloads need a lo part
  constexpr bool kAll = KMAX == 0;          // #3: store every slot
  const bool pairs = !kAll && pos != nullptr;  // the probed pairs' form
  using S = Shape<T, kWide>;
  constexpr int kWarps = S::warps, kThreads = S::threads, kStep = S::step, kRing = S::ring;
  extern __shared__ float4 smem4[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem4);
  using Lay = Layout<kAll, kWarps, kRing>;
  const Lay L(bs, d, (int)sizeof(T), stride);
  unsigned char* pages = sm + Lay::pages;
  float* qs = reinterpret_cast<float*>(sm + L.qs);
  float* qlo = reinterpret_cast<float*>(sm + L.qlo);
  float* stg = reinterpret_cast<float*>(sm + Lay::stage);
  float* qsq = reinterpret_cast<float*>(sm + Lay::qsq);
  float* qsum = reinterpret_cast<float*>(sm + Lay::qsum);
  float* pbias = reinterpret_cast<float*>(sm + Lay::bias);
  float* psz = reinterpret_cast<float*>(sm + Lay::sz);
  int* plive = reinterpret_cast<int*>(sm + Lay::live);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // #3 walks the query tiles fastest, so the blocks of one page run are
  // resident together and read its pages from L2 after the first
  constexpr int run = kAll ? kRunAll : kRun;
  const int run0 = (kAll ? blockIdx.y : blockIdx.x) * run;
  const int qt0 = (kAll ? blockIdx.x : blockIdx.y) * kQTile;
  const int page_bytes = bs * d * (int)sizeof(T);
  const int n_steps = (min(run, nb - run0) + kStep - 1) / kStep;

  // Warps 0..kStep-1 each stage one page a step: its id and bias are read
  // into registers a step ahead (so no global load's latency falls between
  // two barriers); then they decide whether it is live (#3: id >= 0) and
  // start copying a live page's payload, and (q8) its (scale, zero), into
  // the ring.
  int pre_id = -1;
  float pre_b = kBig;
  auto prefetch = [&](int s) {
    const int page = run0 + s * kStep + warp;
    pre_id = warp < kStep && s < n_steps && page < nb ? ids[page] : -1;
    if constexpr (!kAll)
      pre_b = pre_id != -1 && lane < bs ? bias[(size_t)page * bs + lane] : kBig;
  };
  auto load_step = [&](int s, int buf) {
    if (warp < kStep) {
      const int page = run0 + s * kStep + warp;
      const int id = pre_id;
      bool live;
      if constexpr (kAll) {
        live = id >= 0;
      } else {
        pbias[(buf * kStep + warp) * 32 + lane] = pre_b;
        live = __any_sync(kFull, pre_b < 0.5f * kBig);
      }
      prefetch(s + 1);
      if (lane == 0) plive[buf * kStep + warp] = live;
      if (live) {
        if (kQ8 && lane < 2)
          cp_async4(psz + (buf * kStep + warp) * 2 + lane, sz + (size_t)page * 2 + lane);
        const unsigned char* src =
            reinterpret_cast<const unsigned char*>(blocks) + (size_t)id * page_bytes;
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
  prefetch(0);
  load_step(0, 0);

  // the query tile (zero past d and past Q); #3 stores it split, q_hi in
  // qs and q_lo in qlo (tf32_mma.cuh), once for all its pages
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
    if constexpr (kAll) {
      // fragment order: the four values lane (g, t) passes as one A
      // fragment of k-step ks of m-tile mt lie together, so the product
      // loads each fragment with one 16-byte load.  Columns t..t+3 of row
      // r are k-step 0's and k-step 1's columns t and t + 4 (the
      // permutation of K below), rows g or g + 8 of their m-tile.
      float4 lo;
      split4(v, lo);
      const int rh = (r >> 3) & 1;
      const int fl = (r & 7) * 4 + ((t >> 2) & 3);
      const int f0 = frag_offset(t >> 4, 0, r >> 4, fl), f1 = frag_offset(t >> 4, 1, r >> 4, fl);
      qs[f0 + rh] = v.x;
      qs[f0 + rh + 2] = v.y;
      qs[f1 + rh] = v.z;
      qs[f1 + rh + 2] = v.w;
      qlo[f0 + rh] = lo.x;
      qlo[f0 + rh + 2] = lo.y;
      qlo[f1 + rh] = lo.z;
      qlo[f1 + rh + 2] = lo.w;
    } else {
      *reinterpret_cast<float4*>(qs + r * stride + t) = v;
    }
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
  // #3 stores its accumulators as float2 pairs of slots where BS is even
  const bool pair_out = (k & 1) == 0 && reinterpret_cast<uintptr_t>(out_d) % 8 == 0;
  // The pairs form: lane j's query holds the warp's page of a step at row
  // jp of its probe list (-1: it did not probe the page), read a step ahead;
  // only such pairs are selected and stored, at (query, jp) of the (Q, nbq,
  // k) output.
  int jp_next = -1;
  auto fetch_jp = [&](int s) {
    const int page = run0 + s * kStep + wp;
    jp_next = pairs && s < n_steps && page < nb && lane < n_valid
                  ? pos[(size_t)page * n_q + q0 + lane] : -1;
  };
  fetch_jp(0);

  for (int s = 0; s < n_steps; ++s) {
    const int buf = kRing == 2 ? s & 1 : 0;
    if (kRing == 1 && s > 0) {
      __syncthreads();  // step s-1 is consumed: its slot of the ring takes step s
      load_step(s, 0);
    }
    cp_async_wait<0>();
    __syncthreads();  // step s's pages landed; step s-1 is consumed
    if (kRing == 2 && s + 1 < n_steps) load_step(s + 1, buf ^ 1);

    const int jp = jp_next;
    fetch_jp(s + 1);
    const int page = run0 + s * kStep + wp;
    if (page >= nb || n_valid <= 0) continue;  // warp-uniform
    const size_t out0 = ((size_t)page * n_q + q0) * k;
    if (!plive[buf * kStep + wp]) {  // (#3: k = BS, no slots written)
      if (pairs) {
        const size_t o = ((size_t)(q0 + lane) * nbq + jp) * k;
        if (jp >= 0)
          for (int c = 0; c < k; ++c) {
            out_d[o + c] = kBig;
            out_i[o + c] = c;
          }
        continue;
      }
      if (vec_out) {  // k % 4 == 0: 16-byte stores, four slots each
        float4* od = reinterpret_cast<float4*>(out_d + out0);
        int4* oi = reinterpret_cast<int4*>(out_i + out0);
        const int adv = 128 % k;        // slot step of 32 vectors
        int c = (4 * lane) % k;
        for (int e = lane; e < n_valid * k / 4; e += 32) {
          od[e] = make_float4(kBig, kBig, kBig, kBig);
          if constexpr (!kAll) oi[e] = make_int4(c, c + 1, c + 2, c + 3);
          c += adv;
          if (c >= k) c -= k;
        }
      } else {
        for (int e = lane; e < n_valid * k; e += 32) {
          out_d[out0 + e] = kBig;
          if constexpr (!kAll) out_i[out0 + e] = e % k;
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
      if constexpr (!kAll) {
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int v = 0; v < 2; ++v)
            qa[m][v] = *reinterpret_cast<const float4*>(ap + (m * 16 + v * 8) * stride + k0);
      }
      float4 bv[4];
      if constexpr (kAll) {  // the four loads together, then the tail's zeros
        const int kc = in_d ? k0 + 4 * t4 : 0;
#pragma unroll
        for (int n = 0; n < 4; ++n) bv[n] = load4(pp + (n * 8 + g) * d + kc);
#pragma unroll
        for (int n = 0; n < 4; ++n)
          if (!in_d) bv[n] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        if constexpr (!kAll)
          bv[n] = in_d ? load4(pp + (n * 8 + g) * d + k0 + 4 * t4)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
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
          if constexpr (kAll) {          // split when the tile was staged
            const int f = frag_offset(k0 >> 4, ks, 2 * half + m, lane);
            const uint4 hi = *reinterpret_cast<const uint4*>(qs + f);
            const uint4 lo = *reinterpret_cast<const uint4*>(qlo + f);
            a_hi[m][0] = hi.x, a_hi[m][1] = hi.y, a_hi[m][2] = hi.z, a_hi[m][3] = hi.w;
            a_lo[m][0] = lo.x, a_lo[m][1] = lo.y, a_lo[m][2] = lo.z, a_lo[m][3] = lo.w;
          } else {
            split(ks ? qa[m][0].z : qa[m][0].x, a_hi[m][0], a_lo[m][0]);
            split(ks ? qa[m][1].z : qa[m][1].x, a_hi[m][1], a_lo[m][1]);
            split(ks ? qa[m][0].w : qa[m][0].y, a_hi[m][2], a_lo[m][2]);
            split(ks ? qa[m][1].w : qa[m][1].y, a_hi[m][3], a_lo[m][3]);
          }
        }
        if constexpr (kAll) {
          // pass by pass over the eight (m, n) tiles, so that eight
          // independent mma lie between two into one accumulator (each
          // accumulator takes its passes in the order of the loop below)
          uint32_t bh[4][2], bl[4][2];
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const float f0 = ks ? bv[n].z : bv[n].x;
            const float f1 = ks ? bv[n].w : bv[n].y;
            if constexpr (kSplitB) {
              split(f0, bh[n][0], bl[n][0]);
              split(f1, bh[n][1], bl[n][1]);
            } else {
              bh[n][0] = __float_as_uint(f0);
              bh[n][1] = __float_as_uint(f1);
            }
          }
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int m = 0; m < 2; ++m) mma(acc[m][n], a_lo[m], bh[n][0], bh[n][1]);
          if constexpr (kSplitB) {
#pragma unroll
            for (int n = 0; n < 4; ++n)
#pragma unroll
              for (int m = 0; m < 2; ++m) mma(acc[m][n], a_hi[m], bl[n][0], bl[n][1]);
          }
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int m = 0; m < 2; ++m) mma(acc[m][n], a_hi[m], bh[n][0], bh[n][1]);
        } else {
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
    }
    // the product ran over every query of the tile; the select and the
    // stores only where a query of the warp probed the page
    if (pairs && !__any_sync(kFull, jp >= 0)) continue;
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
    if constexpr (kAll) {
      // #3: the accumulators are the output block.  Lane (g, t) holds
      // slots 8n + 2t and 8n + 2t + 1 of queries g, g + 8, g + 16, g + 24
      // of the half, stored as they are: a warp store covers 32 bytes of
      // each of 8 rows (whole sectors), and the 16 stores of a warp write
      // its 32 queries' BS slots, one contiguous run.
      float* o = out_d + out0 + (size_t)g * k + 2 * t4;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float cb0 = __shfl_sync(kFull, bq[n], 8 * t4);
        const float cb1 = __shfl_sync(kFull, bq[n], 8 * t4 + 4);
        const int col = n * 8 + 2 * t4;
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const float d0 = fmaxf(rq[m][v] - 2.f * acc[m][n][2 * v] + cb0, 0.f);
            const float d1 = fmaxf(rq[m][v] - 2.f * acc[m][n][2 * v + 1] + cb1, 0.f);
            float* p = o + (size_t)(m * 16 + v * 8) * k + n * 8;
            if (m * 16 + g + v * 8 < n_valid) {
              if (pair_out) {
                if (col < k) *reinterpret_cast<float2*>(p) = make_float2(d0, d1);
              } else {
                if (col < k) p[0] = d0;
                if (col + 1 < k) p[1] = d1;
              }
            }
          }
      }
    } else {
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

      if (pairs) {
        // The whole warp sorts each probing query's row in turn (most
        // probing warps hold one): lane c holds slot c's value as its bits
        // (the values are >= +0, so they order as unsigned integers; slots
        // past BS sort last) and a bitonic network over the 32 lanes sorts
        // by (value, slot), the order of the lane-per-query selects below.
        // Lanes 0..k-1 then hold the k candidates and store them as a row.
        unsigned todo = __ballot_sync(kFull, jp >= 0);
        while (todo) {
          const int r = __ffs(todo) - 1;
          todo &= todo - 1;
          const int row = __shfl_sync(kFull, jp, r);
          unsigned key = lane < bs ? __float_as_uint(st[r * 32 + (lane ^ swz(r))]) : ~0u;
          int slot = lane;
#pragma unroll
          for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
            for (int stride = size / 2; stride > 0; stride >>= 1) {
              const unsigned ok = __shfl_xor_sync(kFull, key, stride);
              const int os = __shfl_xor_sync(kFull, slot, stride);
              const bool less = ok < key || (ok == key && os < slot);
              // the lower lane of a pair keeps the lesser in an ascending
              // run, the greater in a descending one
              if (less == (((lane & stride) == 0) == ((lane & size) == 0))) {
                key = ok;
                slot = os;
              }
            }
          const size_t o = ((size_t)(q0 + r) * nbq + row) * k;
          if (lane < k) {
            out_d[o + lane] = __uint_as_float(key);
            out_i[o + lane] = slot;
          }
        }
        continue;
      }

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
}

template <typename T, int KMAX, bool kWide>
Layout<KMAX == 0, Shape<T, kWide>::warps, Shape<T, kWide>::ring> layout_of(int bs, int d,
                                                                           int stride) {
  return {bs, d, (int)sizeof(T), stride};
}

// The kernel's attributes for `smem` bytes: the opt-in size, and all of
// L1 as shared memory (two blocks an SM where the layout allows).
template <typename T, int KMAX, bool kQ8, bool kWide>
cudaError_t prepare(int smem) {
  auto* kernel = scan_batched_topk_tc<T, KMAX, kQ8, kWide>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  return err;
}

template <typename T, int KMAX, bool kQ8, bool kWide>
int launch_as(const int* ids, const float* q, const void* blocks, const float* bias,
              const float* sz, float* out_d, int* out_i, const int16_t* pos, int nbq, int nb,
              int n_q, int bs, int d, int k, int kpad, int stride, cudaStream_t stream) {
  const auto L = layout_of<T, KMAX, kWide>(bs, d, stride);
  const int vec16 = (bs * d * (int)sizeof(T)) % 16 == 0;
  const int vec_out = k % 4 == 0 && reinterpret_cast<uintptr_t>(out_d) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out_i) % 16 == 0;
  const cudaError_t err = prepare<T, KMAX, kQ8, kWide>(L.total);
  if (err != cudaSuccess) return (int)err;
  constexpr int run = KMAX == 0 ? kRunAll : kRun;
  const int runs = (nb + run - 1) / run, qtiles = (n_q + kQTile - 1) / kQTile;
  const dim3 grid = KMAX == 0 ? dim3(qtiles, runs) : dim3(runs, qtiles);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  scan_batched_topk_tc<T, KMAX, kQ8, kWide><<<grid, Shape<T, kWide>::threads, L.total, stream>>>(
      ids, q, static_cast<const T*>(blocks), bias, sz, out_d, out_i, pos, nbq, nb, n_q, bs, d, k,
      kpad, stride, vec16, vec_out);
  return (int)cudaGetLastError();
}

// K padded to two mma depths, and a query row's stride: 16 mod 32 floats,
// so the 16-byte loads of a quarter warp (rows g, g + 1; columns 4t) hit
// 32 distinct banks.
int kpad_of(int d) { return (d + 15) / 16 * 16; }
int stride_of(int kpad) { return kpad % 32 == 16 ? kpad : kpad + 16; }

// The shape the launcher takes: the default where its layout fits (0),
// else, for f32 and bf16 pages, the wide one (1); -1: refused (d too
// large; int8 pages take no wide shape).  `bytes`: the layout's size (if
// refused, the last one tried).
template <typename T, int KMAX>
int shape_of(int bs, int d, int stride, int* bytes) {
  *bytes = layout_of<T, KMAX, false>(bs, d, stride).total;
  if (*bytes <= kSmemMax) return 0;
  if (sizeof(T) == 1) return -1;
  *bytes = layout_of<T, KMAX, true>(bs, d, stride).total;
  return *bytes <= kSmemMax ? 1 : -1;
}

template <typename T, int KMAX, bool kQ8>
int launch(const int* ids, const float* q, const void* blocks, const float* bias,
           const float* sz, float* out_d, int* out_i, const int16_t* pos, int nbq, int nb,
           int n_q, int bs, int d, int k, cudaStream_t stream) {
  const int kpad = kpad_of(d), stride = stride_of(kpad);
  int bytes;
  const int shape = shape_of<T, KMAX>(bs, d, stride, &bytes);
  if (shape < 0) return (int)cudaErrorInvalidValue;  // d too large
  if constexpr (sizeof(T) == 1)
    return launch_as<T, KMAX, kQ8, false>(ids, q, blocks, bias, sz, out_d, out_i, pos, nbq,
                                          nb, n_q, bs, d, k, kpad, stride, stream);
  else if (shape == 0)
    return launch_as<T, KMAX, kQ8, false>(ids, q, blocks, bias, sz, out_d, out_i, pos, nbq,
                                          nb, n_q, bs, d, k, kpad, stride, stream);
  else
    return launch_as<T, KMAX, kQ8, true>(ids, q, blocks, bias, sz, out_d, out_i, pos, nbq,
                                         nb, n_q, bs, d, k, kpad, stride, stream);
}

// Blocks an SM of one instantiation at `smem` bytes, by the occupancy
// calculator (after the attributes the launcher sets).
template <typename T, int KMAX, bool kQ8, bool kWide>
cudaError_t occupancy(int smem, int* blocks) {
  auto* kernel = scan_batched_topk_tc<T, KMAX, kQ8, kWide>;
  cudaError_t err = prepare<T, KMAX, kQ8, kWide>(smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, Shape<T, kWide>::threads,
                                                        smem);
  return err;
}

// What launch asks for, without a launch: returns the bytes of dynamic
// shared memory; shape = {shape_of's variant, warps, stages (the ring),
// blocks an SM by the occupancy calculator (0 where refused)}.  A CUDA
// error comes back negated.
template <typename T, int KMAX, bool kQ8>
int query(int bs, int d, int* shape) {
  int bytes;
  shape[0] = shape_of<T, KMAX>(bs, d, stride_of(kpad_of(d)), &bytes);
  const bool wide = sizeof(T) != 1 && shape[0] != 0;
  shape[1] = wide ? Shape<T, true>::warps : Shape<T, false>::warps;
  shape[2] = wide ? Shape<T, true>::ring : Shape<T, false>::ring;
  shape[3] = 0;
  cudaError_t err = cudaSuccess;
  if constexpr (sizeof(T) == 1) {
    if (shape[0] == 0) err = occupancy<T, KMAX, kQ8, false>(bytes, &shape[3]);
  } else {
    if (shape[0] == 0) err = occupancy<T, KMAX, kQ8, false>(bytes, &shape[3]);
    if (shape[0] == 1) err = occupancy<T, KMAX, kQ8, true>(bytes, &shape[3]);
  }
  return err == cudaSuccess ? bytes : -(int)err;
}

template <typename T, bool kQ8>
int query_k(int bs, int d, int k, int* shape) {
  if (k <= 4) return query<T, 4, kQ8>(bs, d, shape);
  if (k <= 10) return query<T, 10, kQ8>(bs, d, shape);
  if (k <= 16) return query<T, 16, kQ8>(bs, d, shape);
  return query<T, 32, kQ8>(bs, d, shape);
}

template <typename T, bool kQ8>
int dispatch_k(const int* ids, const float* q, const void* blocks, const float* bias,
               const float* sz, float* out_d, int* out_i, const int16_t* pos, int nbq, int nb,
               int n_q, int bs, int d, int k, cudaStream_t s) {
  if (k <= 4)
    return launch<T, 4, kQ8>(ids, q, blocks, bias, sz, out_d, out_i, pos, nbq, nb, n_q, bs, d, k, s);
  if (k <= 10)
    return launch<T, 10, kQ8>(ids, q, blocks, bias, sz, out_d, out_i, pos, nbq, nb, n_q, bs, d, k, s);
  if (k <= 16)
    return launch<T, 16, kQ8>(ids, q, blocks, bias, sz, out_d, out_i, pos, nbq, nb, n_q, bs, d, k, s);
  return launch<T, 32, kQ8>(ids, q, blocks, bias, sz, out_d, out_i, pos, nbq, nb, n_q, bs, d, k, s);
}

bool bad_shape(int bs, int d, int k) {
  return bs < 1 || bs > 32 || k < 1 || k > bs || d < 4 || d % 4 != 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = int8 (the payload of `blocks`).
// Every slot's distance, (NB, Q, BS), no bias, no k-min; ids[i] = -1 is a
// padding page, written as BIG.
extern "C" int scan_batched(const int* ids, const float* q, const void* blocks,
                            int dtype, float* out_d, int nb, int n_q, int bs,
                            int d, void* stream) {
  if (bad_shape(bs, d, bs)) return (int)cudaErrorInvalidValue;
  if (n_q == 0 || nb == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch<float, 0, false>(ids, q, blocks, nullptr, nullptr, out_d, nullptr, nullptr, 0,
                                     nb, n_q, bs, d, bs, s);
    case 1:
      return launch<__nv_bfloat16, 0, false>(ids, q, blocks, nullptr, nullptr, out_d, nullptr,
                                             nullptr, 0, nb, n_q, bs, d, bs, s);
    case 2:
      return launch<int8_t, 0, false>(ids, q, blocks, nullptr, nullptr, out_d, nullptr, nullptr,
                                      0, nb, n_q, bs, d, bs, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// pos: null for the full (NB, Q, k) output; else the pairs form, pos (NB,
// Q) int16 the row of each query's probe list holding page i (-1: not
// probed), out (Q, nbq, k), written at the probed pairs only (the caller
// fills the rest).
extern "C" int scan_batched_topk(const int* ids, const float* q,
                                 const void* blocks, int dtype,
                                 const float* bias, float* out_d, int* out_i,
                                 int nb, int n_q, int bs, int d, int k,
                                 const int16_t* pos, int nbq, void* stream) {
  if (bad_shape(bs, d, k) || (pos && nbq < 1)) return (int)cudaErrorInvalidValue;
  if (n_q == 0 || nb == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return dispatch_k<float, false>(ids, q, blocks, bias, nullptr, out_d, out_i, pos, nbq, nb,
                                      n_q, bs, d, k, s);
    case 1:
      return dispatch_k<__nv_bfloat16, false>(ids, q, blocks, bias, nullptr, out_d, out_i, pos,
                                              nbq, nb, n_q, bs, d, k, s);
    case 2:
      return dispatch_k<int8_t, false>(ids, q, blocks, bias, nullptr, out_d, out_i, pos, nbq, nb,
                                       n_q, bs, d, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// int8 codes; sz (NB, 2) f32 per-unique-page (scale, zero); pos as above.
extern "C" int scan_batched_topk_q8(const int* ids, const float* q,
                                    const int8_t* codes, const float* bias,
                                    const float* sz, float* out_d, int* out_i,
                                    int nb, int n_q, int bs, int d, int k,
                                    const int16_t* pos, int nbq, void* stream) {
  if (bad_shape(bs, d, k) || (pos && nbq < 1)) return (int)cudaErrorInvalidValue;
  if (n_q == 0 || nb == 0) return 0;
  return dispatch_k<int8_t, true>(ids, q, codes, bias, sz, out_d, out_i, pos, nbq, nb, n_q, bs,
                                  d, k, (cudaStream_t)stream);
}

// The launchers' shared memory, without a launch (see query); a shape the
// entry refuses before its shared memory is reckoned (bad BS, k, d or
// dtype) returns -cudaErrorInvalidValue.
extern "C" int scan_batched_smem_bytes(int dtype, int bs, int d, int* shape) {
  if (bad_shape(bs, d, bs)) return -(int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return query<float, 0, false>(bs, d, shape);
    case 1: return query<__nv_bfloat16, 0, false>(bs, d, shape);
    case 2: return query<int8_t, 0, false>(bs, d, shape);
    default: return -(int)cudaErrorInvalidValue;
  }
}

extern "C" int scan_batched_topk_smem_bytes(int dtype, int bs, int d, int k, int* shape) {
  if (bad_shape(bs, d, k)) return -(int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return query_k<float, false>(bs, d, k, shape);
    case 1: return query_k<__nv_bfloat16, false>(bs, d, k, shape);
    case 2: return query_k<int8_t, false>(bs, d, k, shape);
    default: return -(int)cudaErrorInvalidValue;
  }
}

extern "C" int scan_batched_topk_q8_smem_bytes(int bs, int d, int k, int* shape) {
  if (bad_shape(bs, d, k)) return -(int)cudaErrorInvalidValue;
  return query_k<int8_t, true>(bs, d, k, shape);
}
