// Blockwise N-pair loss kernels for Hopper (sm_90a): the five tile sweeps
// of the streaming engine, which never materializes the N x M pair
// matrix (or, with the similarity cache, writes it once and streams it
// back).
//
// Replaces (npairloss_tpu/ops/pallas_npair.py):
//   npair_stats_kernel <- _make_stats_kernel (:287), launched by _run_stats (:589)
//   npair_hist_kernel  <- _make_hist_kernel (:355), launched by _run_hist (:628)
//   npair_loss_kernel  <- _make_loss_kernel (:388), launched by _run_loss (:658)
//   npair_grad_kernel<query-major> <- _make_gq_kernel (:458), _run_bwd (:683)
//   npair_grad_kernel<pool-major>  <- _make_gdb_kernel (:483), _run_bwd (:683)
//   npair_grad_tc_kernel: the same two in the bf16 mode, on tensor cores
//
// The single-pass bf16 mode (the Pallas kernels' matmul precision
// DEFAULT, pallas_npair.py:170-186, :473-478, :498-503): every product
// reads bf16-rounded operands and accumulates in fp32.  The caller
// rounds the features once per loss (npl_round_bf16: round to nearest
// even, widened back to fp32, and the same rows as a bf16 copy, [rows]
// [ld16], zero past d).  Every sim of that mode comes from the tensor
// cores: one shared tile (sim_tiles_tc, its 64-deep slices by
// sim_slice_tc: wgmma.m64n128k16 of the bf16 rows, fp32 accumulators),
// used by stats and the recompute hist and loss sweeps (their bf16
// instantiations, npair_stats_kernel<true> and npair_*_kernel<false, L,
// true>), and sim_slice_tc for the recompute gq/gdb's shares; the pair
// epilogues read its staged tile as they read the FMA tile.  gq and gdb
// build their weight tile w from those sims as in the fp32 mode, round
// it to bf16 and multiply it by the bf16 rows on the tensor cores too
// (npair_grad_tc_kernel).
//
// Bound on an H100 SXM (67 TFLOP/s fp32 on the FMA pipes, 989 TFLOP/s
// bf16 on the tensor cores, 3.35 TB/s HBM).  In the fp32 mode every sweep
// that recomputes its sims does 2 N M D flop on the FMA pipes and is
// bound by operations (N = M = 32768, D = 512: 16.4 ms); fp32 gq and gdb
// add their own 2 N M D product (16.4 ms with the cache, 32.8 ms
// recomputing).  The cached hist and loss sweeps read the N x M fp32
// cache once and are bound by bytes (4.29 GB: 1.28 ms).  In the bf16
// mode the same 2 N M D flop run at the bf16 peak: 1.1 ms a recompute
// sweep, so stats is bound by its cache write (1.28 ms) and the
// recompute hist and loss by their product (1.1 ms) — in practice by
// their epilogues and the operand slices' L2 traffic (each block
// streams its 128 query rows again for every pool tile); the bf16 gq
// and gdb: cached, the cache's bytes (1.28 ms) bound them, not their
// product (1.1 ms); recomputing, the card's least time for the sims and
// the product together is 2.2 ms.
//
// One order for every sim, in each mode, in every kernel.  fp32: sim(q,
// i) is one __fmaf_rn chain over k = 0..D-1 in increasing k, starting at
// +0, whichever operand a block owns (fmaf rounds a*b + c once, so the
// operands' roles do not matter); the chain never holds -0, so zero
// padding past the ends (fmaf(0, 0, acc) == acc) changes no sum.  bf16:
// sim(q, i) is sim_slice_tc's: A always the query row, B always the pool
// row, 16-deep blocks of k in increasing order, the first overwriting
// the accumulator (scale-d 0), the k tail past ld16 zero-filled to a
// whole 64-deep slice; the finished sim staged as v + 0, so never -0
// (sortable_key orders -0 below +0).  Each gradient element is one
// __fmaf_rn chain over the other axis in increasing index (fp32), or the
// tensor cores' sum over the other tiles in increasing order (bf16).  So
// in either mode the cache the stats kernel writes equals what every
// recompute sweep computes, pool-major sims equal query-major ones,
// cached and recompute variants give the same bits, and no float
// atomics appear anywhere: repeat runs are bit-identical.
//
// The FMA-bound main loop (sim_tiles), shared by stats and the recompute
// hist and loss sweeps:
//   * Shared loads per FMA.  A block of 256 threads computes a 128 x
//     128 tile; each thread an 8 x 8 micro-tile (rows and columns
//     {4 l .. 4 l + 3} and {64 + 4 l ..}), reading both operands as
//     float4 from shared memory: 256 FMAs per 16 LDS.128.  Operand
//     slices are [rows][32 k] with the 16-byte chunks XOR-swizzled by
//     row / 4, so the 16 distinct rows a warp reads hit distinct banks.
//   * Loads overlap the FMAs.  Operands stream through a ring of
//     kStages = 3 slices of 32 k in dynamic shared memory, filled by
//     16-byte cp.async.cg copies (zero-filled past the ends), one commit
//     group per slice, waited with cp.async.wait_group: while a slice
//     is consumed the next two are in flight — across tile boundaries,
//     so a tile's epilogue runs while the next tile's first slices load.
//   * The finished tile goes to shared memory (float4, rows 136 floats
//     apart so a warp's float4 reads are conflict-free) with its 128 pool
//     labels; two threads then share each row, thread (r, j) taking the
//     4-column chunks 2u + j, u = 0..15, for the kernel's epilogue.
//   * Filling the card.  A block owns 128 query rows.  Where those row
//     tiles fill the card badly (N = 8192: 64 tiles for 132 SMs), the
//     pool axis is split over the CTAs of a thread-block cluster (2, 4
//     or 8, whichever fills the most SMs: pool_splits); rank 0 combines
//     the ranks' per-row partials through distributed shared memory in
//     rank order.
//
// The tensor-core tile (sim_tiles_tc), the bf16 mode's in their place:
//   * Both operands K-major bf16 slices of 64 k ([128 rows][64], 128-byte
//     swizzled), a ring of kStages 32 KB slots (query rows, then pool
//     rows) filled by 16-byte cp.async, zero past the ends; warp group w
//     multiplies query rows [64 w, 64 w + 64) by the 128 pool rows, 4
//     wgmma.m64n128k16 a slice, the accumulators in registers.
//   * The finished fragment goes to the same staged tile (float2 stores:
//     a half warp's hit 32 banks) with its labels, and the epilogue reads
//     it as it reads sim_tiles' tile, but a tile's 16 chunks a thread are
//     spread over the next tile's slices: each runs between a slice's
//     wgmma commit and its wait, so the epilogue overlaps the product.
//     Nothing reads the accumulator between commit and wait.
//   * The same shared memory as the FMA ring (a 32-k fp32 slice and a
//     64-k bf16 slice are both 128 bytes a row), 1 KB aligned.
//
// npair_stats_kernel: the stats epilogue also writes the tile to the sim
// cache with 16-byte stores, straight from registers (sim_tiles) or from
// the staged tile (sim_tiles_tc); per row it keeps the
// running min/max, counts, 16-bin digit-0 histograms (16 compares into
// registers) and the K-slot buffer (a sorted per-thread buffer in shared
// memory, duplicates as distinct entries).  Min, max, integer counts,
// histogram sums and the K-largest multiset are exact in any order, so
// the split sweep equals the unsplit one bit for bit (stats_plain(splits=)
// in blockwise_npair.py is the plain mirror).
//
// npair_hist_kernel and npair_loss_kernel replace _make_hist_kernel and
// _make_loss_kernel: per query row, the prefix-matched 16-bin histogram
// of one radix digit per active side; the selected pairs' I and D sums of
// exp(s - max_all) and their counts.  Each has two variants:
//   * Recompute (no cache): bound by operations, as stats is.  The tiles
//     come from the stats kernel's loop (sim_tiles; sim_tiles_tc in the
//     bf16 mode), and the epilogue reads the staged tile row-wise.
//   * Cached: bound by bytes.  cache_tiles streams the block's rows of the
//     cache in stages of 128 rows x 32 columns through a kCStages-deep ring
//     of 16-byte cp.async copies (4-byte where rows are not 16-byte
//     aligned, M % 4 != 0), with each stage's pool labels, so bytes keep
//     arriving while the epilogue runs; small enough for two blocks per SM.
//   * Both variants split the pool axis by pool_splits(n, m, 2) (two
//     resident blocks per SM: N = 8192 takes 4 ranks, N = 32768 none), so
//     the split is one function of (n, m) for both.
//   * One I/D summation order per row, shared by the two variants, so cache
//     on = off bit for bit (the gradient reads I and I + D): thread (r, j)
//     sums, in one fp32 chain, the chunks 2u + j of every 128-column tile
//     of its rank's range, tiles in order; the row's two chains are added,
//     then the ranks' partials in rank order.  cache_tiles hands its
//     epilogue the same chunks in the same order as sim_tiles does
//     (loss_plain in blockwise_npair.py mirrors the order).
//   * The histogram counts with shared-memory integer atomics per (side,
//     bin, row): exact in any order, one atomic per matching key and side
//     where a register histogram spends 16 compare-adds.
//   * The loss epilogue is branch-free: one exp per pair, added to the I
//     or the D chain by selection (a branch per pair diverges within a
//     warp and cost more on the card than the exps it skips).
//   * Element-wise maths in explicit __f*_rn intrinsics (expf is the
//     full-precision libdevice exp), so no FMA contraction moves a
//     rounding; masking is by selection, never by multiplying with a 0
//     mask (a query with no pairs has max_all = -FLT_MAX and exp
//     overflows).  Rows >= n and columns >= m read 0 and fall outside
//     both masks; the self pair is column row + self_offset.
//   * The hist kernel reads a device flag and, when the pos_topk fast
//     path already holds, writes zeros and returns, so the fallback needs
//     no host sync.
//
// npair_grad_kernel (gq and gdb):
//   * The gradient keeps its 128 x 128 accumulator (a band of 128 output
//     rows x a chunk of 128 of the D columns) in registers through the
//     whole sweep over the other axis and writes each element once, with
//     16-byte stores: no read-modify-write of the output per tile.
//   * The weight tile (128 band rows x 128 other rows) is built once per
//     (band, other tile) and reused for all D columns: the D-chunks of a
//     band form a cluster of kS = ceil(D / 128) CTAs, rounded up to 4 or
//     8 (D > 1024 loops over further chunks).  Each CTA builds 128 / kS
//     of the tile's rows — from the cache (its share staged through the
//     ring by 4-byte cp.async) plus the pair_weight epilogue, or from its
//     own sims, so each sim is computed once — and stores them into every
//     CTA's copy of the tile through distributed shared memory (stores do
//     not wait on a round trip); the tile is double-buffered, so one
//     cluster barrier per other tile is the only synchronisation.  The
//     grid is kS x bands (N = 8192, D = 1024: 512 CTAs; N = 32768, D =
//     512: 1024).
//
// npair_grad_tc_kernel (gq and gdb in the bf16 mode): the same grid,
// cluster and weight shares, with the product on the tensor cores.
//   * The recompute variant's share of sims comes from sim_slice_tc (A the
//     query rows, B the pool rows, as everywhere): gq's kBT / kS own rows
//     are queries, padded to warp group 0's 64 rows by the slot's next
//     rows; gdb's are pool rows, padded to 128 likewise, against both
//     warp groups' 64 other (query) rows.  The padding's sims are never
//     read.  The share then lands canonicalised in its ring slot exactly
//     as a cached share does, and one weight epilogue serves both.
//   * The weight tile is stored as bf16 where it is built, in wgmma's
//     128-byte-swizzled layout (32 KB, double-buffered); X comes from the
//     bf16 copy by 16-byte cp.async straight into a swizzled,
//     double-buffered tile: half the shared memory and L2 traffic of the
//     fp32 tiles.
//   * Each of the block's two warp groups multiplies 64 of the band's
//     rows by the block's 128 D columns: 8 wgmma.m64n128k16 an other
//     tile (zero weights and zero-filled rows past the ends), the
//     accumulators in registers through the sweep, tiles in increasing
//     order.
//   * The product overlaps the weight epilogue: tile t's wgmma group is
//     committed, tile t + 1's share built and pushed while it runs, and
//     only then wgmma.wait_group and the cluster barrier.  Both warp
//     groups build and multiply (no producer warp group): the build is
//     the longer part, and a producer would leave half the threads idle
//     through it.  The product is issued unconditionally in its pass's
//     loop and nothing reads its accumulator before the wait, or ptxas
//     waits for it at once (its C7517 note).
//   * The epilogue's parts, each measured (tools/kernel_breakdown.py):
//     the cached share lands [own row][other row] for both roles (pool-
//     major transposed by its 4-byte copies), so a warp builds one row's
//     128 weights and its pushes to each rank are 256 contiguous bytes;
//     labels and pool-major query terms are read 16 bytes for 4 columns;
//     the async-proxy fence is the reader's, at CTA scope, after the
//     barrier (a writer's fence at cluster scope is a MEMBAR a tile).
//   * One tile shape and instruction sequence for the cached and the
//     recompute variant on equal weight bits, so they agree bit for bit;
//     no atomics, so repeat launches do too.
//
// The 16-byte operand copies need D % 4 == 0 and 16-byte aligned rows:
// the wrappers zero-pad D (which changes no sim) where it is not.

#include <cooperative_groups.h>
#include <float.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kBins = 16;          // 4-bit radix digits
constexpr int kMaxTopK = 32;  // MAX_TOPK in ops/blockwise_npair.py

constexpr int kBT = 128;           // block tile rows, both axes
constexpr int kBK = 32;            // depth of one ring slice
constexpr int kStages = 3;         // ring depth
constexpr int kSimStride = 136;    // row stride of the staged sim tile
constexpr int kWStride = 132;      // grad: row stride of weight tiles
constexpr int kMaxCluster = 8;     // portable cluster size
constexpr int kStatFields = 5 + 2 * kBins;  // per-row partials before K
constexpr int kCW = 32;            // cached hist/loss: columns per stage
constexpr int kCStages = 5;        // cached hist/loss: ring depth

// MiningMethod (ops/npair_loss.py).
enum Method { HARD = 0, EASY = 1, RAND = 2, RELATIVE_HARD = 3, RELATIVE_EASY = 4 };

// x rounded to bf16 (round to nearest even) and widened back.
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// dst[i] = bf16_round(src[i]) for i < rows * d, 16 bytes at a time where
// both are 16-byte aligned and the count % 4 == 0, one element at a time
// otherwise; dst16 [rows][ld16] the same values as bf16, zero past d,
// one 16-byte chunk of 8 a thread.  vec == 2 (ld16 == d, a
// multiple of 8, and every pointer 16-byte aligned): both in one pass, 8
// elements a thread.
__global__ void __launch_bounds__(256) round_bf16_kernel(
    const float* __restrict__ src, float* __restrict__ dst,
    __nv_bfloat16* __restrict__ dst16, long long rows, int d, int ld16,
    int vec) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x;
  const long long count = rows * d;
  if (vec == 2) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (long long i = first; i < count / 8; i += stride) {
      const float4 a = s4[2 * i], b = s4[2 * i + 1];
      d4[2 * i] = make_float4(bf16_round(a.x), bf16_round(a.y),
                              bf16_round(a.z), bf16_round(a.w));
      d4[2 * i + 1] = make_float4(bf16_round(b.x), bf16_round(b.y),
                                  bf16_round(b.z), bf16_round(b.w));
      const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
      unsigned w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
        w[e] = *reinterpret_cast<const unsigned*>(&h);
      }
      reinterpret_cast<uint4*>(dst16)[i] = make_uint4(w[0], w[1], w[2], w[3]);
    }
    return;
  }
  if (vec) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (long long i = first; i < count / 4; i += stride) {
      const float4 v = s4[i];
      d4[i] = make_float4(bf16_round(v.x), bf16_round(v.y), bf16_round(v.z),
                          bf16_round(v.w));
    }
  } else {
    for (long long i = first; i < count; i += stride)
      dst[i] = bf16_round(src[i]);
  }
  const int per_row = ld16 / 8;
  for (long long i = first; i < rows * per_row; i += stride) {
    const long long r = i / per_row;
    const int c = static_cast<int>(i % per_row) * 8;
    const float* row = src + r * d;
    unsigned w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = c + 2 * e;
      const __nv_bfloat162 v = __floats2bfloat162_rn(
          k < d ? row[k] : 0.f, k + 1 < d ? row[k + 1] : 0.f);
      w[e] = *reinterpret_cast<const unsigned*>(&v);
    }
    *reinterpret_cast<uint4*>(dst16 + r * ld16 + c) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__device__ __forceinline__ unsigned sortable_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Add one key's digit 0 to a 16-bin register histogram.
__device__ __forceinline__ void hist_add(int h[kBins], unsigned key) {
  const unsigned bin = key >> 28;
#pragma unroll
  for (int b = 0; b < kBins; ++b) h[b] += (bin == static_cast<unsigned>(b));
}

// selection_predicates (ops/npair_loss.py), cu:80-119, as selections
// on the (uniform) method, not a switch.
__device__ __forceinline__ bool pos_pred(int method, float s, float pt) {
  return method == HARD            ? s < pt
         : method == RAND          ? true
         : method == RELATIVE_HARD ? s <= pt
                                   : s >= pt;
}
__device__ __forceinline__ bool neg_pred(int method, float s, float nt) {
  return method == HARD            ? s > nt
         : method == RAND          ? true
         : method == RELATIVE_HARD ? s >= nt
                                   : s <= nt;
}

struct Pair {
  bool same, diff;
};

// The (same, diff) masks of pair (q, i): the self pair (i == q +
// self_offset) and pairs past the ends are in neither.
template <typename L>
__device__ __forceinline__ Pair pair_of(int q, int i, L lq, L li, int n,
                                        int m, int self_offset) {
  const bool ok = q < n && i < m && i != q + self_offset;
  const bool same_lbl = lq == li;
  return {ok && same_lbl, ok && !same_lbl};
}

// A label held as its 32-bit pattern, as the kernel's label type.
template <typename L>
__device__ __forceinline__ L label_as(int bits) {
  if constexpr (std::is_same<L, float>::value)
    return __int_as_float(bits);
  else
    return bits;
}

// The same for labels held as 32-bit patterns: compared as float32 when
// f32 (so +0 == -0 and 0.2 != 0.7), else as int32.  The stats and grad
// kernels take labels so, one instantiation for both label types.
__device__ __forceinline__ Pair pair_bits(int q, int i, int lq, int li,
                                          bool f32, int n, int m,
                                          int self_offset) {
  const bool ok = q < n && i < m && i != q + self_offset;
  const bool same_lbl =
      f32 ? __int_as_float(lq) == __int_as_float(li) : lq == li;
  return {ok && same_lbl, ok && !same_lbl};
}

// ------------------------------------------- Hopper building blocks

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !full (the
// source is then not read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// At most kPending of this thread's newest commit groups are still in
// flight: with kPending = ring depth - 2, the oldest in-flight stage has
// landed.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}
__device__ __forceinline__ void cp_async_wait_ring() {
  cp_async_wait<kStages - 2>();
}
// 4 bytes global -> shared, asynchronously; zero-filled when !full.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

// The bf16 mode on Hopper's tensor cores: the sim tile (sim_tiles_tc,
// every bf16 sweep's sims) and gq/gdb's product (npair_grad_tc_kernel).
// Their operands sit in shared memory as wgmma reads them: bf16 tiles of
// 128 rows x 128 columns, each two 64-column halves [128 rows][64] one
// after the other, or slices of one such half, every 8-row block of
// 128-byte rows swizzled by 128 bytes (16-byte chunk c of row r at chunk
// c ^ r % 8, the period 1024 bytes, so each half or slice starts 1 KB
// aligned).
constexpr int kTileBf16 = kBT * kBT;  // elements of one bf16 tile
constexpr int kK16 = 64;              // depth of one bf16 sim slice
constexpr int kSlice16 = kBT * kK16;  // elements of one 128-row sim slice

// Offset (elements) of (row r, column c) in a swizzled bf16 tile.
__device__ __forceinline__ int sw128(int r, int c) {
  return (c >> 6) * (kBT * 64) + r * 64 +
         ((((c >> 3) & 7) ^ (r & 7)) << 3) + (c & 7);
}

// A wgmma shared-memory descriptor of the 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units).
__device__ __forceinline__ unsigned long long wgmma_desc(unsigned addr,
                                                         unsigned lbo,
                                                         unsigned sbo) {
  return static_cast<unsigned long long>((addr & 0x3FFFF) >> 4) |
         (static_cast<unsigned long long>(lbo >> 4) << 16) |
         (static_cast<unsigned long long>(sbo >> 4) << 32) | (1ull << 62);
}

// d (64 x 128 fp32, the warp group's accumulator fragment) = a (64 x 16
// bf16, K-major) @ b (16 x 128 bf16; N-major when kBNMajor, else K-major:
// 128 rows of 16) + (add ? d : 0), asynchronously.
template <int kBNMajor = 1>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 unsigned long long a,
                                                 unsigned long long b,
                                                 int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(add), "n"(kBNMajor));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accesses of the accumulator across the
// asynchronous product's issue and wait.  Only where no product is in
// flight: a read of its registers there makes ptxas wait for it.
__device__ __forceinline__ void pin(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// Generic-proxy writes to this block's shared memory that a barrier made
// visible to this thread (its own stores and cp.async copies, the
// cluster's stores into it) before its wgmma reads them through the async
// proxy.  On the reading side, at CTA scope: a writer's fence at cluster
// scope costs ~1 ms more at the stretch (a MEMBAR per thread and tile).
__device__ __forceinline__ void fence_to_wgmma() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// The shared memory above p from its next 1 KB boundary (the swizzle's
// period): `p` must leave 1 KB of slack.
__device__ __forceinline__ float* align1k(void* p) {
  return reinterpret_cast<float*>(static_cast<unsigned char*>(p) +
                                  ((1024 - (smem_u32(p) & 1023)) & 1023));
}

// Rows [r0, r0 + kRows) x k [k0, k0 + 64) of bf16 rows [rows][ld16] into
// a swizzled [kRows][64] slice (sw128's first half); past the ends
// zero-filled (ld16 % 8 == 0: a 16-byte copy is wholly in or out).
template <int kRows>
__device__ __forceinline__ void load_rows16_slice(
    __nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src, int rows,
    int r0, int ld16, int k0) {
  constexpr int kChunks = kRows * (kK16 / 8);
#pragma unroll
  for (int e = 0; e < (kChunks + kThreads - 1) / kThreads; ++e) {
    const int idx = threadIdx.x + e * kThreads;
    if (kChunks % kThreads == 0 || idx < kChunks) {
      const int r = idx >> 3, c = (idx & 7) * 8, row = r0 + r, k = k0 + c;
      const bool in = row < rows && k < ld16;
      cp_async16(reinterpret_cast<float*>(dst + sw128(r, c)),
                 reinterpret_cast<const float*>(
                     in ? src + static_cast<long long>(row) * ld16 + k : src),
                 in);
    }
  }
}

// The one bf16 sim function: acc (the warp group's 64 x 128 fragment)
// continues sim(query row, pool row) over one 64-deep slice, 4
// wgmma.m64n128k16 in increasing k; A is always the 64 query rows (a), B
// always the 128 pool rows (b), both K-major slices at 1 KB-aligned shared
// addresses.  The first slice of a tile starts from zero (scale-d 0).
// Asynchronous: the caller waits (wgmma_wait_all) before it reads acc or
// refills the slices.
__device__ __forceinline__ void sim_slice_tc(float (&acc)[64], unsigned a,
                                             unsigned b, bool first) {
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < kK16 / 16; ++k)
    wgmma_m64n128k16<0>(acc, wgmma_desc(a + 32 * k, 16, 1024),
                        wgmma_desc(b + 32 * k, 16, 1024), k > 0 || !first);
  wgmma_commit();
}

// A finished sim as it is staged: -0 becomes +0.  A tensor-core sum can
// end at -0 where the FMA chain (which starts at +0) cannot, and
// sortable_key orders -0 below +0.
__device__ __forceinline__ float canon0(float v) { return __fadd_rn(v, 0.f); }

// Row (or column) i in 0..7 of the 8 x 8 micro-tile of lane l (0..15).
__device__ __forceinline__ int frag(int l, int i) {
  return ((i >> 2) << 6) + l * 4 + (i & 3);
}

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}
__device__ __forceinline__ int comp(const int4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Offset of chunk q (k = 4q .. 4q+3) of row r in a [rows][kBK] slice.
__device__ __forceinline__ int swz(int r, int q) {
  return r * kBK + 4 * (q ^ ((r >> 2) & 7));
}

// Rows [r0, r0 + kRows) x k [k0, k0 + kBK) of a row-major [rows, d]
// matrix into a swizzled slice; past the ends zero-filled.
template <int kRows>
__device__ __forceinline__ void load_operand_slice(
    float* buf, const float* __restrict__ src, int rows, int r0, int d,
    int k0) {
  constexpr int kChunks = kRows * (kBK / 4);
#pragma unroll
  for (int e = 0; e < (kChunks + kThreads - 1) / kThreads; ++e) {
    const int idx = threadIdx.x + e * kThreads;
    if (kChunks % kThreads == 0 || idx < kChunks) {
      const int r = idx >> 3, q = idx & 7, row = r0 + r, k = k0 + 4 * q;
      const bool in = row < rows && k < d;
      cp_async16(buf + swz(r, q),
                 in ? src + static_cast<long long>(row) * d + k : src, in);
    }
  }
}

// Row i of the kMA rows of a thread's micro-tile in lane ty: the 8 x 8
// layout when kMA == 8, else kMA consecutive rows.
template <int kMA>
__device__ __forceinline__ int arow(int ty, int i) {
  return kMA == 8 ? frag(ty, i) : ty * kMA + i;
}

// acc[i][j] continues sim(a row i, b row j) over the slice's 32 k, one
// __fmaf_rn per k in increasing k.  a rows: arow<kMA>(ty, i); b rows:
// frag(tx, j).  Within a quarter warp the a
// reads are one address (broadcast) and the b reads 8 rows whose chunks
// the swizzle puts in 8 distinct bank groups.
template <int kMA>
__device__ __forceinline__ void sim_slice(const float* a, const float* b,
                                          int ty, int tx,
                                          float (&acc)[kMA][8]) {
#pragma unroll 4
  for (int q = 0; q < kBK / 4; ++q) {
    float4 av[kMA];
#pragma unroll
    for (int i = 0; i < kMA; ++i)
      av[i] = *reinterpret_cast<const float4*>(
          a + swz(arow<kMA>(ty, i), q));
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 bv =
          *reinterpret_cast<const float4*>(b + swz(frag(tx, j), q));
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < kMA; ++i)
          acc[i][j] = __fmaf_rn(comp(av[i], e), comp(bv, e), acc[i][j]);
    }
  }
}

// --------------------------------------------------- the shared sweeps

// The 128 x 128 sim tiles of query rows [q0, q0 + 128) against pool
// tiles [ct0, ct1), in order, each sim one __fmaf_rn chain (sim_slice
// over the ring's 32-k slices).  For each finished tile, emit(row, i, v)
// sees its float4s in registers (row within the block, i the pool
// column of v.x) as they go to `tile` (row stride kSimStride); the
// tile's pool labels go to plab; after a __syncthreads, epi(i0) reads
// both.  The ring runs across tile boundaries, so the next tile's first
// slices load while epi runs.
template <typename Emit, typename Epi>
__device__ __forceinline__ void sim_tiles(
    float* ring, float* tile, int* plab, const float* __restrict__ feats,
    const float* __restrict__ pool, const int* __restrict__ pool_labels,
    int n, int m, int d, int q0, int ct0, int ct1, Emit emit, Epi epi) {
  const int t = threadIdx.x, ty = t >> 4, tx = t & 15;
  const int nk = (d + kBK - 1) / kBK;
  const int total = (ct1 - ct0) * nk;  // ring slices of this block

  // Slice g: k-slice g % nk of the block's (g / nk)-th pool tile.
  auto issue = [&](int g) {
    if (g < total) {
      float* buf = ring + (g % kStages) * (2 * kBT * kBK);
      const int k0 = (g % nk) * kBK;
      load_operand_slice<kBT>(buf, feats, n, q0, d, k0);
      load_operand_slice<kBT>(buf + kBT * kBK, pool, m,
                              (ct0 + g / nk) * kBT, d, k0);
    }
    cp_async_commit();
  };

  for (int g = 0; g < kStages - 1; ++g) issue(g);
  float acc[8][8];
  for (int g = 0; g < total; ++g) {
    const int kk = g % nk;
    if (kk == 0) {
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
    }
    cp_async_wait_ring();
    __syncthreads();  // slice g is in; slice g-1's buffer is free
    issue(g + kStages - 1);
    const float* buf = ring + (g % kStages) * (2 * kBT * kBK);
    sim_slice<8>(buf, buf + kBT * kBK, ty, tx, acc);
    if (kk != nk - 1) continue;

    // The finished tile to shared memory.  The sync at the top of this
    // slice ordered these writes after the last epilogue's reads.
    const int i0 = (ct0 + g / nk) * kBT;
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int row = frag(ty, a);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = h * 64 + tx * 4;
        const float4 v = make_float4(acc[a][4 * h], acc[a][4 * h + 1],
                                     acc[a][4 * h + 2], acc[a][4 * h + 3]);
        *reinterpret_cast<float4*>(tile + row * kSimStride + col) = v;
        emit(row, i0 + col, v);
      }
    }
    if (t < kBT) plab[t] = i0 + t < m ? pool_labels[i0 + t] : 0;
    __syncthreads();
    epi(i0);
  }
}

// The bf16 mode's sim tiles on the tensor cores, in place of sim_tiles:
// the 128 x 128 tiles of query rows [q0, q0 + 128) against pool tiles
// [ct0, ct1), in order, from the bf16 rows (feats16, pool16: [rows][ld16],
// zero past d).  Their 64-deep slices stream through a ring of kStages
// 32 KB slots at `ring` (1 KB aligned: the query rows, then the pool
// rows), one commit group a slice; warp group wg multiplies query rows
// [64 wg, 64 wg + 64) by the tile's 128 pool rows (sim_slice_tc).  A
// finished fragment goes canonicalised (canon0) to `tile` (row stride
// kSimStride) with its pool labels in plab; epi(i0, u0, u1) then reads
// the staged tile's 4-column chunks u0 .. u1 - 1 of the 16 each thread
// takes (sim_tiles' epilogue reads all 16 at once), spread over the next
// tile's slices, so that it runs while their products do; the last
// tile's after the sweep.
template <typename Epi>
__device__ __forceinline__ void sim_tiles_tc(
    __nv_bfloat16* ring, float* tile, int* plab,
    const __nv_bfloat16* __restrict__ feats16,
    const __nv_bfloat16* __restrict__ pool16, int ld16,
    const int* __restrict__ pool_labels, int n, int m, int q0, int ct0,
    int ct1, Epi epi) {
  const int t = threadIdx.x, wg = t >> 7, lw = (t >> 5) & 3, ln = t & 31;
  const int nk = (ld16 + kK16 - 1) / kK16;
  const int total = (ct1 - ct0) * nk;  // ring slices of this block

  // Slice g: k-slice g % nk of the block's (g / nk)-th pool tile.
  auto issue = [&](int g) {
    if (g < total) {
      __nv_bfloat16* buf = ring + (g % kStages) * 2 * kSlice16;
      const int k0 = (g % nk) * kK16;
      load_rows16_slice<kBT>(buf, feats16, n, q0, ld16, k0);
      load_rows16_slice<kBT>(buf + kSlice16, pool16, m,
                             (ct0 + g / nk) * kBT, ld16, k0);
    }
    cp_async_commit();
  };

  for (int g = 0; g < kStages - 1; ++g) issue(g);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int staged = -1;  // the staged tile's first pool column, its epilogue due
  for (int g = 0; g < total; ++g) {
    const int kk = g % nk;
    cp_async_wait_ring();
    // Slice g is in; slice g - 1's products, which every warp group
    // waited for, are done with its slot, which the next issue refills.
    __syncthreads();
    issue(g + kStages - 1);
    fence_to_wgmma();
    const unsigned a = smem_u32(ring + (g % kStages) * 2 * kSlice16);
    sim_slice_tc(acc, a + wg * 64 * 128, a + kSlice16 * 2, kk == 0);
    // Nothing reads acc until the wait (else ptxas waits at once).
    if (staged >= 0)
      epi(staged, kBT / 8 * kk / nk, kBT / 8 * (kk + 1) / nk);
    wgmma_wait_all();
    if (kk != nk - 1) continue;
    pin(acc);
    __syncthreads();  // the last tile's epilogue is done with `tile`
    // Thread (warp w, lane l) holds rows 64 wg + 16 w + l / 4 (+ 8) and
    // columns 8 j + 2 (l % 4) (+ 1): a half warp's float2s hit 32 banks.
    const int i0 = (ct0 + g / nk) * kBT;
    const int r0 = wg * 64 + lw * 16 + (ln >> 2);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(tile + (r0 + 8 * h) * kSimStride + 8 * j +
                                   2 * (ln & 3)) =
            make_float2(canon0(acc[4 * j + 2 * h]),
                        canon0(acc[4 * j + 2 * h + 1]));
    if (t < kBT) plab[t] = i0 + t < m ? pool_labels[i0 + t] : 0;
    staged = i0;
  }
  if (staged >= 0) {
    __syncthreads();  // the last tile is staged
    epi(staged, 0, kBT / 8);
  }
}

// Offset of 4-column chunk c of row r in a cached stage ([kBT][kCW]
// floats): XOR-swizzled by (r & 3) << 1, so the 8 lanes of a quarter
// warp (rows 4a .. 4a + 3, chunks 2u and 2u + 1) read 8 distinct bank
// groups.
__device__ __forceinline__ int stage_at(int r, int c) {
  return r * kCW + 4 * (c ^ ((r & 3) << 1));
}

// Rows [q0, q0 + 128) of the N x M sim cache over pool tiles [ct0, ct1),
// streamed in stages of kCW columns through a kCStages-deep ring of
// cp.async copies — 16 bytes each when `vec` (M % 4 == 0, an aligned
// cache), else 4 — with each stage's pool labels; past the ends
// zero-filled.  Thread (r, j) calls chunk(v, labels, i) for the 4-column
// chunks 2u + j of each stage in turn (i the pool column of v.x): over a
// 128-column tile, the chunks sim_tiles' epilogue reads, in its order.
template <typename Chunk>
__device__ __forceinline__ void cache_tiles(
    float* ring, const float* __restrict__ sims,
    const int* __restrict__ pool_labels, int n, int m, int q0, int ct0,
    int ct1, bool vec, Chunk chunk) {
  constexpr int kStage = kBT * kCW + kCW;  // the sims, then the labels
  constexpr int kVec = kBT * kCW / 4 / kThreads;  // 16-byte copies a stage
  const int t = threadIdx.x, r = t >> 1, j = t & 1;
  const int total = (ct1 - ct0) * (kBT / kCW);  // stages of this block
  // A thread's 16-byte copies land at the same places of every stage;
  // only their column moves, kCW a stage.
  const float* src[kVec];
  int dst[kVec], col[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    const int idx = t + e * kThreads, row = idx >> 3, c = idx & 7;
    col[e] = ct0 * kBT + 4 * c;
    // Rows past the end stay at the base pointer and copy nothing.
    src[e] = q0 + row < n ? sims + static_cast<long long>(q0 + row) * m +
                                col[e]
                          : nullptr;
    dst[e] = stage_at(row, c);
  }
  auto issue = [&](int g) {
    if (g < total) {
      float* buf = ring + (g % kCStages) * kStage;
      const int i0 = ct0 * kBT + g * kCW;
      if (vec) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const bool in = src[e] != nullptr && col[e] + g * kCW < m;
          cp_async16(buf + dst[e], in ? src[e] + g * kCW : sims, in);
        }
      } else {
#pragma unroll 4
        for (int e = 0; e < kBT * kCW / kThreads; ++e) {
          const int idx = t + e * kThreads, row = idx / kCW, col = idx % kCW;
          const int q = q0 + row, i = i0 + col;
          const bool in = q < n && i < m;
          cp_async4(buf + stage_at(row, col >> 2) + (col & 3),
                    in ? sims + static_cast<long long>(q) * m + i : sims,
                    in);
        }
      }
      if (t < kCW) {
        const bool in = i0 + t < m;
        cp_async4(buf + kBT * kCW + t,
                  reinterpret_cast<const float*>(pool_labels +
                                                 (in ? i0 + t : 0)),
                  in);
      }
    }
    cp_async_commit();
  };

  for (int g = 0; g < kCStages - 1; ++g) issue(g);
  for (int g = 0; g < total; ++g) {
    cp_async_wait<kCStages - 2>();
    __syncthreads();  // stage g is in; stage g-1's buffer is free
    issue(g + kCStages - 1);
    const float* buf = ring + (g % kCStages) * kStage;
    const int i0 = ct0 * kBT + g * kCW;
#pragma unroll
    for (int u = 0; u < kCW / 8; ++u) {
      const int c = 2 * u + j;
      chunk(*reinterpret_cast<const float4*>(buf + stage_at(r, c)),
            *reinterpret_cast<const int4*>(buf + kBT * kCW + 4 * c),
            i0 + 4 * c);
    }
  }
}

// Shared memory (floats) of a hist or loss sweep before the kernel's own
// partials: the cached ring, or the recompute ring, tile and labels (the
// fp32 ring's 32-k slices and the bf16 ring's 64-k slices are both 128
// bytes a row; the bf16 mode's ring starts at the next 1 KB boundary, so
// its kernels take 1 KB more: kAlignSlack).
__host__ __device__ constexpr int sweep_smem_floats(bool cached) {
  return cached ? kCStages * (kBT * kCW + kCW)
                : kStages * 2 * kBT * kBK + kBT * kSimStride + kBT;
}
constexpr int kAlignSlack = 1024;
static_assert(kStages * 2 * kBT * kBK == kStages * kSlice16,
              "the fp32 and bf16 rings are the same size");

// The block's rows of the pool range [ct0, ct1) through chunk(v, labels,
// i), from the cache or recomputed (kTC: on the tensor cores from the
// bf16 rows, `smem` 1 KB aligned): either way thread (r, j) sees row r's
// chunks 2u + j of each 128-column tile, tiles in order.
template <bool kCached, bool kTC, typename Chunk>
__device__ __forceinline__ void sweep(
    float* smem, const float* __restrict__ feats,
    const float* __restrict__ pool, const int* __restrict__ pool_labels,
    const float* __restrict__ sims, bool vec, int n, int m, int d,
    const __nv_bfloat16* __restrict__ feats16,
    const __nv_bfloat16* __restrict__ pool16, int ld16, int q0, int ct0,
    int ct1, Chunk chunk) {
  if constexpr (kCached) {
    cache_tiles(smem, sims, pool_labels, n, m, q0, ct0, ct1, vec, chunk);
  } else if constexpr (kTC) {
    float* tile = smem + kStages * 2 * kBT * kBK;
    int* plab = reinterpret_cast<int*>(tile + kBT * kSimStride);
    const int r = threadIdx.x >> 1, j = threadIdx.x & 1;
    sim_tiles_tc(reinterpret_cast<__nv_bfloat16*>(smem), tile, plab,
                 feats16, pool16, ld16, pool_labels, n, m, q0, ct0, ct1,
                 [&](int i0, int u0, int u1) {
                   for (int u = u0; u < u1; ++u) {
                     const int c0 = 4 * (2 * u + j);
                     chunk(*reinterpret_cast<const float4*>(
                               tile + r * kSimStride + c0),
                           *reinterpret_cast<const int4*>(plab + c0),
                           i0 + c0);
                   }
                 });
  } else {
    float* tile = smem + kStages * 2 * kBT * kBK;
    int* plab = reinterpret_cast<int*>(tile + kBT * kSimStride);
    const int r = threadIdx.x >> 1, j = threadIdx.x & 1;
    sim_tiles(smem, tile, plab, feats, pool, pool_labels, n, m, d, q0, ct0,
              ct1, [](int, int, float4) {}, [&](int i0) {
#pragma unroll 2
                for (int u = 0; u < kBT / 8; ++u) {
                  const int c0 = 4 * (2 * u + j);
                  chunk(*reinterpret_cast<const float4*>(
                            tile + r * kSimStride + c0),
                        *reinterpret_cast<const int4*>(plab + c0), i0 + c0);
                }
              });
  }
}

// ------------------------------------------------------------ stats

// Dynamic shared memory of the stats kernel (floats): the operand ring,
// the sim tile (later the per-row partials), the pool tile's labels, the
// K-slot buffers (kTC: after kAlignSlack bytes).
__host__ __device__ constexpr int stats_smem_floats(int k) {
  return kStages * 2 * kBT * kBK + kBT * kSimStride + kBT + k * kThreads;
}

// Grid: (splits, row tiles) in clusters of (splits, 1, 1).  Block (s, y)
// owns queries [128 y, 128 y + 128) and pool tiles [T s / S, T (s+1) / S)
// of T = ceil(m / 128).  kTC: the bf16 mode, its sims from the bf16 rows
// on the tensor cores (sim_tiles_tc); else sim_tiles' FMA chains.
template <bool kTC>
__global__ void __launch_bounds__(kThreads, 1) npair_stats_kernel(
    const float* __restrict__ feats, const int* __restrict__ labels,
    const float* __restrict__ pool, const int* __restrict__ pool_labels,
    int label_f32, int n, int m, int d, int self_offset,
    float* __restrict__ min_w, float* __restrict__ max_b,
    float* __restrict__ max_a, int* __restrict__ cnt_s,
    int* __restrict__ cnt_d, int* __restrict__ hist_s,
    int* __restrict__ hist_d, float* __restrict__ topk, int k,
    float* __restrict__ sims_out, const __nv_bfloat16* __restrict__ feats16,
    const __nv_bfloat16* __restrict__ pool16, int ld16) {
  extern __shared__ __align__(16) float smem[];
  float* ring = kTC ? align1k(smem) : smem;
  float* tile = ring + kStages * 2 * kBT * kBK;
  int* plab = reinterpret_cast<int*>(tile + kBT * kSimStride);
  float* topk_buf = reinterpret_cast<float*>(plab + kBT);  // [k][kThreads]
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const bool f32 = label_f32 != 0;
  const int t = threadIdx.x;
  const int r = t >> 1, j = t & 1;  // epilogue: row r, half j
  const int q0 = blockIdx.y * kBT, q = q0 + r;
  const int lq = q < n ? labels[q] : 0;
  const int col_tiles = (m + kBT - 1) / kBT;
  const int ct0 = col_tiles * rank / splits;
  const int ct1 = col_tiles * (rank + 1) / splits;
  const bool vec_emit = (m & 3) == 0;

  float mn = FLT_MAX, mxb = -FLT_MAX, mxa = -FLT_MAX;
  int cs = 0, cd = 0;
  int hs[kBins], hd[kBins];
#pragma unroll
  for (int b = 0; b < kBins; ++b) hs[b] = hd[b] = 0;
  for (int s = 0; s < k; ++s) topk_buf[s * kThreads + t] = -FLT_MAX;

  // The finished tile also goes to the cache: straight from registers
  // (sim_tiles), or in the epilogue from the staged tile (sim_tiles_tc).
  auto emit = [&](int row, int i, float4 v) {
    if (sims_out == nullptr || q0 + row >= n) return;
    float* dst = sims_out + static_cast<long long>(q0 + row) * m + i;
    if (vec_emit) {
      if (i < m) *reinterpret_cast<float4*>(dst) = v;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (i + e < m) dst[e] = comp(v, e);
    }
  };
  auto epi = [&](int i0, int u0 = 0, int u1 = kBT / 8) {
    // Thread (r, j) takes columns 4 (2u + j) .. + 3 of row r: all 16
    // chunks at once (sim_tiles, constant bounds), or u0 .. u1 - 1.
#pragma unroll 1
    for (int u = kTC ? u0 : 0; u < (kTC ? u1 : kBT / 8); ++u) {
      const int c0 = 4 * (2 * u + j);
      const float4 v4 =
          *reinterpret_cast<const float4*>(tile + r * kSimStride + c0);
      // (if constexpr: a plain if keeps emit in the fp32 epilogue's
      // closure, which cost its kernel 2.8 %.)
      if constexpr (kTC) emit(r, i0 + c0, v4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + e;
        const float v = comp(v4, e);
        const Pair p =
            pair_bits(q, i0 + c, lq, plab[c], f32, n, m, self_offset);
        if (p.same) {
          mn = fminf(mn, v);
          ++cs;
          if (hist_s != nullptr) hist_add(hs, sortable_key(v));
          if (k > 0 && v > topk_buf[(k - 1) * kThreads + t]) {
            // Sorted insert, descending; equal values stay distinct slots.
            int at = k - 1;
            while (at > 0 && topk_buf[(at - 1) * kThreads + t] < v) {
              topk_buf[at * kThreads + t] = topk_buf[(at - 1) * kThreads + t];
              --at;
            }
            topk_buf[at * kThreads + t] = v;
          }
        } else if (p.diff) {
          mxb = fmaxf(mxb, v);
          ++cd;
          if (hist_d != nullptr) hist_add(hd, sortable_key(v));
        }
        if (p.same || p.diff) mxa = fmaxf(mxa, v);
      }
    }
  };
  if constexpr (kTC)
    sim_tiles_tc(reinterpret_cast<__nv_bfloat16*>(ring), tile, plab, feats16,
                 pool16, ld16, pool_labels, n, m, q0, ct0, ct1, epi);
  else
    sim_tiles(ring, tile, plab, feats, pool, pool_labels, n, m, d, q0, ct0,
              ct1, emit, epi);

  // The row's two halves (lanes t, t ^ 1 of one warp).
  mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, 1));
  mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, 1));
  mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, 1));
  cs += __shfl_xor_sync(0xffffffffu, cs, 1);
  cd += __shfl_xor_sync(0xffffffffu, cd, 1);
#pragma unroll
  for (int b = 0; b < kBins; ++b) {
    hs[b] += __shfl_xor_sync(0xffffffffu, hs[b], 1);
    hd[b] += __shfl_xor_sync(0xffffffffu, hd[b], 1);
  }
  __syncthreads();  // the last epilogue is done with the tile
  // Per-row partials, field-major: part[f * kBT + row].
  float* part = tile;
  if (j == 0) {
    part[0 * kBT + r] = mn;
    part[1 * kBT + r] = mxb;
    part[2 * kBT + r] = mxa;
    part[3 * kBT + r] = __int_as_float(cs);
    part[4 * kBT + r] = __int_as_float(cd);
#pragma unroll
    for (int b = 0; b < kBins; ++b) {
      part[(5 + b) * kBT + r] = __int_as_float(hs[b]);
      part[(5 + kBins + b) * kBT + r] = __int_as_float(hd[b]);
    }
    // Merge the row's two descending buffers into K descending slots.
    int a0 = 0, a1 = 0;
    for (int s = 0; s < k; ++s) {
      const float v0 = a0 < k ? topk_buf[a0 * kThreads + t] : -FLT_MAX;
      const float v1 = a1 < k ? topk_buf[a1 * kThreads + t + 1] : -FLT_MAX;
      const bool take1 = v1 > v0;
      part[(kStatFields + s) * kBT + r] = take1 ? v1 : v0;
      a0 += !take1;
      a1 += take1;
    }
  }
  if (splits > 1)
    cluster.sync();  // every rank's partials are written
  else
    __syncthreads();
  // Rank 0 combines the ranks' partials in rank order (all exact).
  if (rank == 0 && t < kBT && q0 + t < n) {
    const int qq = q0 + t;
    const float* src[kMaxCluster];
    for (int s = 0; s < splits; ++s)
      src[s] = s == 0 ? part : cluster.map_shared_rank(part, s);
    float a = FLT_MAX, b = -FLT_MAX, c = -FLT_MAX;
    int ns = 0, nd = 0;
    for (int s = 0; s < splits; ++s) {
      a = fminf(a, src[s][0 * kBT + t]);
      b = fmaxf(b, src[s][1 * kBT + t]);
      c = fmaxf(c, src[s][2 * kBT + t]);
      ns += __float_as_int(src[s][3 * kBT + t]);
      nd += __float_as_int(src[s][4 * kBT + t]);
    }
    min_w[qq] = a;
    max_b[qq] = b;
    max_a[qq] = c;
    cnt_s[qq] = ns;
    cnt_d[qq] = nd;
    for (int side = 0; side < 2; ++side) {
      int* h = side == 0 ? hist_s : hist_d;
      if (h == nullptr) continue;
      for (int bin = 0; bin < kBins; ++bin) {
        int sum = 0;
        for (int s = 0; s < splits; ++s)
          sum += __float_as_int(src[s][(5 + side * kBins + bin) * kBT + t]);
        h[static_cast<long long>(qq) * kBins + bin] = sum;
      }
    }
    int at[kMaxCluster];
    for (int s = 0; s < splits; ++s) at[s] = 0;
    for (int slot = 0; slot < k; ++slot) {
      int best = 0;
      float bv = -FLT_MAX;
      for (int s = 0; s < splits; ++s) {
        const float cand =
            at[s] < k ? src[s][(kStatFields + at[s]) * kBT + t] : -FLT_MAX;
        if (s == 0 || cand > bv) {
          bv = cand;
          best = s;
        }
      }
      ++at[best];
      topk[static_cast<long long>(qq) * k + slot] = bv;
    }
  }
  if (splits > 1) cluster.sync();  // no rank leaves while rank 0 reads
}

// ------------------------------------------------------- hist and loss

// Grid and cluster as the stats kernel's, the pool axis split by
// pool_splits(n, m, 2) for both variants.  Labels arrive as 32-bit
// patterns and compare as L (float32: +0 == -0, 0.2 != 0.7).  kTC (with
// !kCached): the bf16 mode's recompute variant, its sims from the bf16
// rows on the tensor cores (its shared memory after kAlignSlack bytes).

// Dynamic shared memory (bytes): the sweep's, then per (side, bin, row)
// counters.
__host__ __device__ constexpr size_t hist_smem_bytes(bool cached) {
  return sizeof(float) * (sweep_smem_floats(cached) + 2 * kBins * kBT);
}

template <bool kCached, typename L, bool kTC = false>
__global__ void __launch_bounds__(kThreads, kCached ? 2 : 1)
    npair_hist_kernel(const float* __restrict__ feats,
                      const int* __restrict__ labels,
                      const float* __restrict__ pool,
                      const int* __restrict__ pool_labels,
                      const float* __restrict__ sims, int vec, int n, int m,
                      int d, int self_offset, int sides, int same0,
                      int same1, const unsigned* __restrict__ prefix0,
                      const unsigned* __restrict__ prefix1, int digit,
                      const unsigned char* __restrict__ skip,
                      int* __restrict__ out0, int* __restrict__ out1,
                      const __nv_bfloat16* __restrict__ feats16,
                      const __nv_bfloat16* __restrict__ pool16, int ld16) {
  extern __shared__ __align__(16) float smem_raw[];
  float* smem = kTC ? align1k(smem_raw) : smem_raw;
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x, r = t >> 1;
  const int q0 = blockIdx.y * kBT, q = q0 + r;
  if (skip != nullptr && *skip) {
    // The pos_topk fast path holds: this sweep's result is not used.
    if (rank == 0)
      for (int idx = t; idx < kBT * kBins; idx += kThreads) {
        if (q0 + idx / kBins >= n) break;
        out0[q0 * kBins + idx] = 0;
        if (sides > 1) out1[q0 * kBins + idx] = 0;
      }
    return;
  }
  int* cnt = reinterpret_cast<int*>(smem + sweep_smem_floats(kCached));
  for (int idx = t; idx < 2 * kBins * kBT; idx += kThreads) cnt[idx] = 0;
  const int col_tiles = (m + kBT - 1) / kBT;
  const L lq = label_as<L>(q < n ? labels[q] : 0);
  const unsigned p0 = q < n ? prefix0[q] : 0u;
  const unsigned p1 = (sides > 1 && q < n) ? prefix1[q] : 0u;
  const int hi = 32 - 4 * digit, lo = 28 - 4 * digit;

  // Each key whose higher digits match the side's prefix adds one to its
  // (side, bin, row) counter.
  auto chunk = [&](float4 v, int4 l, int i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const Pair p = pair_of(q, i + e, lq, label_as<L>(comp(l, e)), n, m,
                             self_offset);
      const unsigned key = sortable_key(comp(v, e));
      const int bin = static_cast<int>((key >> lo) & (kBins - 1));
      if ((same0 ? p.same : p.diff) && (key >> hi) == p0)
        atomicAdd(cnt + bin * kBT + r, 1);
      if (sides > 1 && (same1 ? p.same : p.diff) && (key >> hi) == p1)
        atomicAdd(cnt + (kBins + bin) * kBT + r, 1);
    }
  };
  sweep<kCached, kTC>(smem, feats, pool, pool_labels, sims, vec != 0, n, m,
                      d, feats16, pool16, ld16, q0,
                      col_tiles * rank / splits,
                      col_tiles * (rank + 1) / splits, chunk);

  if (splits > 1)
    cluster.sync();  // every rank's counters are final
  else
    __syncthreads();
  // Rank 0 sums the ranks' counters (exact in any order); a row's 16
  // bins go out as four 16-byte stores.
  if (rank == 0 && t < kBT && q0 + t < n) {
    for (int side = 0; side < sides; ++side) {
      int h[kBins];
#pragma unroll
      for (int b = 0; b < kBins; ++b) h[b] = 0;
      for (int s = 0; s < splits; ++s) {
        const int* src = s == 0 ? cnt : cluster.map_shared_rank(cnt, s);
#pragma unroll
        for (int b = 0; b < kBins; ++b)
          h[b] += src[(side * kBins + b) * kBT + t];
      }
      int4* dst = reinterpret_cast<int4*>((side == 0 ? out0 : out1) +
                                          static_cast<long long>(q0 + t) *
                                              kBins);
#pragma unroll
      for (int b = 0; b < kBins / 4; ++b)
        dst[b] = make_int4(h[4 * b], h[4 * b + 1], h[4 * b + 2],
                           h[4 * b + 3]);
    }
  }
  if (splits > 1) cluster.sync();  // no rank leaves while rank 0 reads
}

// Dynamic shared memory (bytes): the sweep's, then four per-row partials.
__host__ __device__ constexpr size_t loss_smem_bytes(bool cached) {
  return sizeof(float) * (sweep_smem_floats(cached) + 4 * kBT);
}

template <bool kCached, typename L, bool kTC = false>
__global__ void __launch_bounds__(kThreads, kCached ? 2 : 1)
    npair_loss_kernel(const float* __restrict__ feats,
                      const int* __restrict__ labels,
                      const float* __restrict__ pool,
                      const int* __restrict__ pool_labels,
                      const float* __restrict__ sims, int vec, int n, int m,
                      int d, int self_offset, int ap, int an,
                      float margin_ident, float margin_diff,
                      const float* __restrict__ pos_thr,
                      const float* __restrict__ neg_thr,
                      const float* __restrict__ max_all,
                      float* __restrict__ isum, float* __restrict__ dsum,
                      float* __restrict__ inum, float* __restrict__ dnum,
                      const __nv_bfloat16* __restrict__ feats16,
                      const __nv_bfloat16* __restrict__ pool16, int ld16) {
  extern __shared__ __align__(16) float smem_raw[];
  float* smem = kTC ? align1k(smem_raw) : smem_raw;
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x, r = t >> 1, j = t & 1;
  const int q0 = blockIdx.y * kBT, q = q0 + r;
  const bool live = q < n;
  const int col_tiles = (m + kBT - 1) / kBT;
  const L lq = label_as<L>(live ? labels[q] : 0);
  const float pt = live ? __fadd_rn(pos_thr[q], margin_ident) : 0.f;
  const float nt = live ? __fadd_rn(neg_thr[q], margin_diff) : 0.f;
  const float mx = live ? max_all[q] : 0.f;

  // One fp32 chain per sum and thread, in the sweep's chunk order.
  float is = 0.f, ds = 0.f;
  int ic = 0, dc = 0;
  auto chunk = [&](float4 v, int4 l, int i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float s = comp(v, e);
      const Pair p = pair_of(q, i + e, lq, label_as<L>(comp(l, e)), n, m,
                             self_offset);
      const bool sp = p.same && pos_pred(ap, s, pt);
      const bool sn = p.diff && neg_pred(an, s, nt);
      // Branch-free: exp for every pair (inf where max_all = -FLT_MAX,
      // and then not selected), added to a chain by selection.
      const float x = expf(__fsub_rn(s, mx));
      is = sp ? __fadd_rn(is, x) : is;
      ds = sn ? __fadd_rn(ds, x) : ds;
      ic += sp;
      dc += sn;
    }
  };
  sweep<kCached, kTC>(smem, feats, pool, pool_labels, sims, vec != 0, n, m,
                      d, feats16, pool16, ld16, q0,
                      col_tiles * rank / splits,
                      col_tiles * (rank + 1) / splits, chunk);

  // The row's two chains (lanes t, t ^ 1 of one warp): chain 0 + chain 1.
  is = __fadd_rn(is, __shfl_xor_sync(0xffffffffu, is, 1));
  ds = __fadd_rn(ds, __shfl_xor_sync(0xffffffffu, ds, 1));
  ic += __shfl_xor_sync(0xffffffffu, ic, 1);
  dc += __shfl_xor_sync(0xffffffffu, dc, 1);
  float* part = smem + sweep_smem_floats(kCached);  // [4][kBT]
  if (j == 0) {
    part[r] = is;
    part[kBT + r] = ds;
    part[2 * kBT + r] = __int_as_float(ic);
    part[3 * kBT + r] = __int_as_float(dc);
  }
  if (splits > 1)
    cluster.sync();  // every rank's partials are written
  else
    __syncthreads();
  // Rank 0 adds the ranks' partials in rank order.
  if (rank == 0 && t < kBT && q0 + t < n) {
    float a = part[t], b = part[kBT + t];
    int na = __float_as_int(part[2 * kBT + t]);
    int nb = __float_as_int(part[3 * kBT + t]);
    for (int s = 1; s < splits; ++s) {
      const float* src = cluster.map_shared_rank(part, s);
      a = __fadd_rn(a, src[t]);
      b = __fadd_rn(b, src[kBT + t]);
      na += __float_as_int(src[2 * kBT + t]);
      nb += __float_as_int(src[3 * kBT + t]);
    }
    isum[q0 + t] = a;
    dsum[q0 + t] = b;
    inum[q0 + t] = static_cast<float>(na);
    dnum[q0 + t] = static_cast<float>(nb);
  }
  if (splits > 1) cluster.sync();  // no rank leaves while rank 0 reads
}

// ------------------------------------------------------- gq and gdb

// Per-query terms of the weight tile (_weight_tile, cu:405-446).
struct QueryTerms {
  float pt, nt, mx, a, b;
};

__device__ __forceinline__ float inv0(float den) {
  return den != 0.f ? __fdiv_rn(1.f, den) : 0.f;
}

__device__ __forceinline__ QueryTerms make_terms(
    float pos_thr, float neg_thr, float max_all, float isum, float asum,
    float valid, float margin_ident, float margin_diff, float scale_g) {
  const float scale = __fmul_rn(scale_g, valid);
  const float ia = inv0(asum);
  return {__fadd_rn(pos_thr, margin_ident), __fadd_rn(neg_thr, margin_diff),
          max_all, __fmul_rn(__fadd_rn(-inv0(isum), ia), scale),
          __fmul_rn(ia, scale)};
}

__device__ __forceinline__ QueryTerms query_terms(
    int q, float margin_ident, float margin_diff, const float* pos_thr,
    const float* neg_thr, const float* max_all, const float* isum,
    const float* asum, const float* valid, float scale_g) {
  return make_terms(pos_thr[q], neg_thr[q], max_all[q], isum[q], asum[q],
                    valid[q], margin_ident, margin_diff, scale_g);
}

// w = (-p1 + p2 + p3) * valid * g / N for one pair: a_q on a selected
// positive, b_q on a selected negative, 0 elsewhere — by selection, never
// by a multiplied mask (exp overflows to inf where max_all = -FLT_MAX,
// and is then not selected).  Branch-free: exp is evaluated for every
// pair, so the 16 weights of a thread interleave.
__device__ __forceinline__ float pair_weight(float v, Pair p, int ap, int an,
                                             const QueryTerms& qt) {
  const bool sp = p.same && pos_pred(ap, v, qt.pt);
  const bool sn = p.diff && neg_pred(an, v, qt.nt);
  const float e = __fmul_rn(expf(__fsub_rn(v, qt.mx)), sp ? qt.a : qt.b);
  return (sp || sn) ? e : 0.f;
}

// Floats of one ring slice's payload: a 32-row X slice of 128 columns;
// the cached variant's share of one cache tile (kBT / kS rows x 128); or
// the recompute variant's 32-k slice of the block's kBT / kS weight rows
// and of the 128 other rows.
template <bool kCached, int kS>
__host__ __device__ constexpr int grad_payload_floats() {
  return kCached ? (kBT / kS * kBT > kBK * kBT ? kBT / kS * kBT : kBK * kBT)
                 : ((kBT / kS + kBT) * kBK > kBK * kBT ? (kBT / kS + kBT) * kBK
                                                       : kBK * kBT);
}
// The first slice of each other tile also carries the next tile's rows'
// labels and, pool-major, their six per-query inputs.
constexpr int kRaw = 7 * kBT;

template <bool kCached, int kS>
__host__ __device__ constexpr size_t grad_smem_bytes() {
  return sizeof(float) * (kStages * (grad_payload_floats<kCached, kS>() + kRaw) +
                          2 * kBT * kWStride) +
         sizeof(QueryTerms) * (2 * kBT + kBT / kS) +
         sizeof(int) * (2 * kBT + kBT / kS);
}

// The gradient of one band of 128 output rows and one chunk of 128 of
// its D columns.  pool_major = 0: gq = w @ pool, the band is 128
// queries and the other axis the pool; 1: gdb = w^T @ feats, the band
// is 128 pool rows and the other axis the queries.  Grid: (kS, bands) in
// clusters of (kS, 1, 1); rank s takes chunks s, s + kS, ... and builds
// rows [s kBT / kS, (s+1) kBT / kS) of every weight tile, which it
// stores into every rank's double-buffered tile (distributed shared
// memory stores do not wait); one cluster barrier per other tile then
// makes the whole tile visible everywhere.
template <bool kCached, int kS>
__global__ void __launch_bounds__(kThreads, 1) npair_grad_kernel(
    const float* __restrict__ feats, const int* __restrict__ labels,
    const float* __restrict__ pool, const int* __restrict__ pool_labels,
    int label_f32, int pool_major, const float* __restrict__ sims, int n,
    int m, int d, int self_offset, int ap, int an, float margin_ident,
    float margin_diff, const float* __restrict__ pos_thr,
    const float* __restrict__ neg_thr, const float* __restrict__ max_all,
    const float* __restrict__ isum, const float* __restrict__ asum,
    const float* __restrict__ valid, const float* __restrict__ g,
    float* __restrict__ out) {
  static_assert(kS == 4 || kS == 8, "a cluster of 4 or 8");
  constexpr int kRs = kBT / kS;   // weight rows this block builds
  constexpr int kMA = 8 / kS;     // ... per thread (recompute)
  constexpr int kMain = grad_payload_floats<kCached, kS>();
  constexpr int kStage = kMain + kRaw;
  constexpr int kXSlices = kBT / kBK;
  constexpr int kGroups = kRs * kBT / 4 / kThreads;  // cached: float4s
  const bool pm = pool_major != 0;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* wl = ring + kStages * kStage;  // 2 x [kBT][kWStride] weight tiles
  // Per other tile, double-buffered: its rows' labels and (pool-major)
  // query terms.
  QueryTerms* xqt = reinterpret_cast<QueryTerms*>(wl + 2 * kBT * kWStride);
  QueryTerms* oqt = xqt + 2 * kBT;
  int* xlab = reinterpret_cast<int*>(oqt + kRs);
  int* olab = xlab + 2 * kBT;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const bool f32 = label_f32 != 0;
  const int t = threadIdx.x, ty = t >> 4, tx = t & 15;
  const int own_rows = pm ? m : n;
  const int other_rows = pm ? n : m;
  const float* own_op = pm ? pool : feats;
  const float* xop = pm ? feats : pool;  // the product's operand
  const int o0 = blockIdx.y * kBT;
  const int sr0 = o0 + rank * kRs;  // the weight rows this block builds
  // dot_normalizer = the query count in the backward (cu:427).
  const float scale_g = __fdiv_rn(g[0], static_cast<float>(n));
  const int x_tiles = (other_rows + kBT - 1) / kBT;
  const int nk = (d + kBK - 1) / kBK;
  const int passes = ((d + kBT - 1) / kBT + kS - 1) / kS;
  const int n_a = kCached ? 1 : nk;  // weight-source slices per tile

  // The ring's slice sequence: per pass, per other tile, n_a slices for
  // the weight share (the cache share, or the sims' operands) then, when
  // the pass has columns, kXSlices X slices.
  auto per_tile = [&](int p) {
    return n_a + ((p * kS + rank) * kBT < d ? kXSlices : 0);
  };
  auto issue = [&](int gi) {
    int p = 0, rem = gi;
    for (; p < passes; ++p) {
      const int per = x_tiles * per_tile(p);
      if (rem < per) break;
      rem -= per;
    }
    if (p < passes) {
      const int per = per_tile(p);
      const int xt = rem / per, x0 = xt * kBT, s = rem % per;
      float* buf = ring + (gi % kStages) * kStage;
      const int nx0 = xt + 1 < x_tiles ? x0 + kBT : 0;  // the next tile
      if (s == 0 && t < kBT) {
        const int x = nx0 + t;
        const bool in = x < other_rows, iq = x < n;
        const int* lab = pm ? labels : pool_labels;
        cp_async4(buf + kMain + t,
                  reinterpret_cast<const float*>(in ? lab + x : lab), in);
        if (pm) {
          const float* vec[6] = {pos_thr, neg_thr, max_all, isum, asum, valid};
#pragma unroll
          for (int j = 0; j < 6; ++j)
            cp_async4(buf + kMain + (1 + j) * kBT + t,
                      iq ? vec[j] + x : vec[j], iq);
        }
      }
      if (s < n_a && kCached) {
        // Query-major: [r][c] = sims[sr0 + r][x0 + c]; pool-major:
        // [c][r] = sims[x0 + c][sr0 + r] — consecutive threads on
        // consecutive cache columns either way.
#pragma unroll
        for (int e = 0; e < kRs * kBT / kThreads; ++e) {
          const int idx = t + e * kThreads;
          const int q = pm ? x0 + idx / kRs : sr0 + idx / kBT;
          const int i = pm ? sr0 + idx % kRs : x0 + idx % kBT;
          const bool in = q < n && i < m;
          cp_async4(buf + idx,
                    in ? sims + static_cast<long long>(q) * m + i : sims, in);
        }
      } else if (s < n_a) {
        load_operand_slice<kRs>(buf, own_op, own_rows, sr0, d, s * kBK);
        load_operand_slice<kBT>(buf + kRs * kBK, xop, other_rows, x0, d,
                                s * kBK);
      } else {
        const int c0 = (p * kS + rank) * kBT, xr0 = x0 + (s - n_a) * kBK;
#pragma unroll
        for (int e = 0; e < kBK * kBT / 4 / kThreads; ++e) {
          const int idx = t + e * kThreads, rr = idx >> 5, c4 = idx & 31;
          const int row = xr0 + rr, col = c0 + 4 * c4;
          const bool in = row < other_rows && col < d;
          cp_async16(buf + rr * kBT + 4 * c4,
                     in ? xop + static_cast<long long>(row) * d + col : xop,
                     in);
        }
      }
    }
    cp_async_commit();
  };

  // The current other tile's labels and terms (buffer tc & 1).
  const int* xl = xlab;
  const QueryTerms* xq = xqt;
  // Weight of element (r, c) of this block's share: own row sr0 + r,
  // other row x0 + c, from its sim v.
  auto weight = [&](int r, int c, int x0, float v) {
    const int q = pm ? x0 + c : sr0 + r;
    const int i = pm ? sr0 + r : x0 + c;
    const Pair p = pair_bits(q, i, pm ? xl[c] : olab[r],
                             pm ? olab[r] : xl[c], f32, n, m, self_offset);
    return pair_weight(v, p, ap, an, pm ? xq[c] : oqt[r]);
  };
  // The next tile's labels and terms, from the raw rows its first slice
  // brought, into buffer b.
  auto next_terms = [&](const float* raw, int b) {
    if (t < kBT) {
      xlab[b * kBT + t] = __float_as_int(raw[t]);
      if (pm)
        xqt[b * kBT + t] =
            make_terms(raw[kBT + t], raw[2 * kBT + t], raw[3 * kBT + t],
                       raw[4 * kBT + t], raw[5 * kBT + t], raw[6 * kBT + t],
                       margin_ident, margin_diff, scale_g);
    }
  };
  // Four weights of share row r, columns c .. c + 3, into every rank's
  // weight tile wt.
  auto push = [&](float* wt, int r, int c, float4 w) {
    const int off = (rank * kRs + r) * kWStride + c;
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      float* dst = s == rank ? wt : cluster.map_shared_rank(wt, s);
      *reinterpret_cast<float4*>(dst + off) = w;
    }
  };

  if (t < kRs) {
    const int o = sr0 + t;
    olab[t] = o < own_rows ? (pm ? pool_labels : labels)[o] : 0;
    if (!pm && o < n)
      oqt[t] = query_terms(o, margin_ident, margin_diff, pos_thr, neg_thr,
                           max_all, isum, asum, valid, scale_g);
  }
  if (t < kBT) {  // the first other tile's, into buffer 0
    xlab[t] = t < other_rows ? (pm ? labels : pool_labels)[t] : 0;
    if (pm && t < n)
      xqt[t] = query_terms(t, margin_ident, margin_diff, pos_thr, neg_thr,
                           max_all, isum, asum, valid, scale_g);
  }
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  int gi = 0, tc = 0;
  for (int p = 0; p < passes; ++p) {
    const int c0 = (p * kS + rank) * kBT;
    const bool cols = c0 < d;
    float acc[8][8];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
    for (int xt = 0; xt < x_tiles; ++xt, ++tc) {
      const int x0 = xt * kBT;
      // This tile's labels and terms were written during the last tile
      // (or before the sweep); the next tile's go to the other buffer,
      // whose last readers passed the previous cluster barrier.
      xl = xlab + (tc & 1) * kBT;
      xq = xqt + (tc & 1) * kBT;
      // The other blocks may still run the product of tile tc - 1 from
      // their other buffer; tile tc - 2's product, which read this one,
      // ended before the last cluster barrier.
      float* wt = wl + (tc & 1) * kBT * kWStride;
      if (kCached) {
        cp_async_wait_ring();
        __syncthreads();  // the cache share is in
        issue(gi + kStages - 1);
        const float* cs = ring + (gi % kStages) * kStage;
        ++gi;
        next_terms(cs + kMain, (tc + 1) & 1);
#pragma unroll
        for (int e = 0; e < kGroups; ++e) {
          const int idx = t + e * kThreads;
          // Query-major: a warp takes 128 columns of one row; pool-major:
          // 32 rows of 4 columns (the share is stored [c][r]).
          const int r = pm ? idx % kRs : idx / (kBT / 4);
          const int c = 4 * (pm ? idx / kRs : idx % (kBT / 4));
          float v[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            v[k] = pm ? cs[(c + k) * kRs + r] : cs[r * kBT + c + k];
          push(wt, r, c,
               make_float4(weight(r, c, x0, v[0]), weight(r, c + 1, x0, v[1]),
                           weight(r, c + 2, x0, v[2]),
                           weight(r, c + 3, x0, v[3])));
        }
      } else {
        float sacc[kMA][8];
#pragma unroll
        for (int a = 0; a < kMA; ++a)
#pragma unroll
          for (int b = 0; b < 8; ++b) sacc[a][b] = 0.f;
        for (int s = 0; s < nk; ++s, ++gi) {
          cp_async_wait_ring();
          __syncthreads();
          issue(gi + kStages - 1);
          const float* buf = ring + (gi % kStages) * kStage;
          if (s == 0) next_terms(buf + kMain, (tc + 1) & 1);
          sim_slice<kMA>(buf, buf + kRs * kBK, ty, tx, sacc);
        }
#pragma unroll
        for (int a = 0; a < kMA; ++a) {
          const int r = arow<kMA>(ty, a);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = h * 64 + tx * 4;
            push(wt, r, c,
                 make_float4(weight(r, c, x0, sacc[a][4 * h]),
                             weight(r, c + 1, x0, sacc[a][4 * h + 1]),
                             weight(r, c + 2, x0, sacc[a][4 * h + 2]),
                             weight(r, c + 3, x0, sacc[a][4 * h + 3])));
          }
        }
      }
      cluster.sync();  // every rank's rows of tile tc are in wt
      if (!cols) continue;
      // out[band] += W @ X[x0 .. x0 + 128, c0 .. c0 + 128), in increasing
      // other index for every element.
      for (int xs = 0; xs < kXSlices; ++xs, ++gi) {
        cp_async_wait_ring();
        __syncthreads();
        issue(gi + kStages - 1);
        const float* xb = ring + (gi % kStages) * kStage;
#pragma unroll 4
        for (int qd = 0; qd < kBK / 4; ++qd) {
          float4 wv[8];
#pragma unroll
          for (int a = 0; a < 8; ++a)
            wv[a] = *reinterpret_cast<const float4*>(
                wt + frag(ty, a) * kWStride + xs * kBK + 4 * qd);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float* xr = xb + (4 * qd + e) * kBT;
            const float4 b0 = *reinterpret_cast<const float4*>(xr + tx * 4);
            const float4 b1 =
                *reinterpret_cast<const float4*>(xr + 64 + tx * 4);
#pragma unroll
            for (int a = 0; a < 8; ++a) {
              const float w = comp(wv[a], e);
              acc[a][0] = __fmaf_rn(w, b0.x, acc[a][0]);
              acc[a][1] = __fmaf_rn(w, b0.y, acc[a][1]);
              acc[a][2] = __fmaf_rn(w, b0.z, acc[a][2]);
              acc[a][3] = __fmaf_rn(w, b0.w, acc[a][3]);
              acc[a][4] = __fmaf_rn(w, b1.x, acc[a][4]);
              acc[a][5] = __fmaf_rn(w, b1.y, acc[a][5]);
              acc[a][6] = __fmaf_rn(w, b1.z, acc[a][6]);
              acc[a][7] = __fmaf_rn(w, b1.w, acc[a][7]);
            }
          }
        }
      }
    }
    if (cols) {
      // Each output element written once, 16 bytes at a time.
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int row = o0 + frag(ty, a);
        if (row >= own_rows) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = c0 + h * 64 + tx * 4;
          if (col < d)
            *reinterpret_cast<float4*>(out + static_cast<long long>(row) * d +
                                       col) =
                make_float4(acc[a][4 * h], acc[a][4 * h + 1],
                            acc[a][4 * h + 2], acc[a][4 * h + 3]);
        }
      }
    }
  }
  cluster.sync();  // no block leaves while another may still store to it
}

// ------------------------------------------ gq and gdb on tensor cores

// Floats of one ring slot's weight source: the cached variant's share of
// a cache tile (kBT / kS own rows x 128, rows kWStride apart), or the
// recompute variant's 64-deep bf16 sim slice of the block's kBT / kS own
// rows and the 128 other rows ([rows][64], 128-byte swizzled), whose
// first kBT / kS x kWStride floats later hold the finished share of sims.
template <bool kCached, int kS>
__host__ __device__ constexpr int tc_source_floats() {
  return kCached ? kBT / kS * kWStride : (kBT / kS + kBT) * kK16 / 2;
}
// A slot: the weight source, then the next other tile's raw rows (kRaw;
// recompute: 8 kBT floats, so that every slot starts 1 KB aligned).
template <bool kCached, int kS>
__host__ __device__ constexpr int tc_stage_floats() {
  return tc_source_floats<kCached, kS>() + (kCached ? kRaw : 8 * kBT);
}

// Dynamic shared memory (bytes): 1 KB to align the tiles, two weight and
// two X tiles, the ring, query terms and labels.
template <bool kCached, int kS>
__host__ __device__ constexpr size_t grad_tc_smem_bytes() {
  return 1024 + 4 * kTileBf16 * sizeof(__nv_bfloat16) +
         sizeof(float) * (kStages * tc_stage_floats<kCached, kS>() +
                          2 * 5 * kBT) +
         sizeof(QueryTerms) * (kBT / kS) + sizeof(int) * (2 * kBT + kBT / kS);
}

// gq (pool_major = 0) or gdb (1) in the bf16 mode: out[band, chunk] =
// sum over other tiles, in increasing order, of bf16(W tile) @ bf16(X
// tile), accumulated in fp32 by the tensor cores.  Grid, cluster and the
// weight tile's construction as npair_grad_kernel's: rank s builds rows
// [s kBT / kS, (s+1) kBT / kS) of every weight tile (from the cache, or
// from its own sims on the tensor cores: sim_slice_tc, the one bf16 sim
// function), rounds them to bf16 and stores them swizzled into every
// rank's double-buffered tile.  X comes as bf16 rows (pool16 for gq,
// feats16 for gdb; row stride ld16, zero past d), streamed by 16-byte
// cp.async straight into a double-buffered swizzled tile.  Warp
// group w multiplies band rows [64 w, 64 w + 64) by the 128 columns of
// the block's D chunk: 8 wgmma.m64n128k16 a tile, the accumulator in
// registers through the sweep.  The product of tile t runs while the
// block builds tile t + 1's weights; then wgmma.wait_group and one
// cluster barrier, after which tile t's buffers are free everywhere.
template <bool kCached, int kS>
__global__ void __launch_bounds__(kThreads, 1) npair_grad_tc_kernel(
    const float* __restrict__ feats, const int* __restrict__ labels,
    const float* __restrict__ pool, const int* __restrict__ pool_labels,
    int label_f32, int pool_major, const float* __restrict__ sims, int n,
    int m, int d, int self_offset, int ap, int an, float margin_ident,
    float margin_diff, const float* __restrict__ pos_thr,
    const float* __restrict__ neg_thr, const float* __restrict__ max_all,
    const float* __restrict__ isum, const float* __restrict__ asum,
    const float* __restrict__ valid, const float* __restrict__ g,
    const __nv_bfloat16* __restrict__ feats16,
    const __nv_bfloat16* __restrict__ pool16, int ld16, int vec,
    float* __restrict__ out) {
  static_assert(kS == 4 || kS == 8, "a cluster of 4 or 8");
  constexpr int kRs = kBT / kS;   // weight rows this block builds
  constexpr int kSrc = tc_source_floats<kCached, kS>();
  constexpr int kStage = tc_stage_floats<kCached, kS>();
  constexpr int kQuads = kRs * kBT / 4 / kThreads;  // 4 weights each
  const bool pm = pool_major != 0;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  // The same offset in every block, so the cluster's stores land alike.
  __nv_bfloat16* wl = reinterpret_cast<__nv_bfloat16*>(
      smem_tc + ((1024 - (smem_u32(smem_tc) & 1023)) & 1023));
  __nv_bfloat16* xs = wl + 2 * kTileBf16;  // 2 X tiles
  float* ring = reinterpret_cast<float*>(xs + 2 * kTileBf16);
  // Per other tile, double-buffered: its rows' labels and (pool-major)
  // query terms, field by field ([2][5][kBT]: four columns' fields are 16
  // bytes); then this block's own rows' labels and (query-major) terms.
  float* xterms = ring + kStages * kStage;
  int* xlab = reinterpret_cast<int*>(xterms + 2 * 5 * kBT);
  QueryTerms* oqt = reinterpret_cast<QueryTerms*>(xlab + 2 * kBT);
  int* olab = reinterpret_cast<int*>(oqt + kRs);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const bool f32 = label_f32 != 0;
  const int t = threadIdx.x, wg = t >> 7, lw = (t >> 5) & 3, ln = t & 31;
  const int own_rows = pm ? m : n;
  const int other_rows = pm ? n : m;
  const __nv_bfloat16* own16 = pm ? pool16 : feats16;  // for the sims
  const __nv_bfloat16* x16 = pm ? feats16 : pool16;  // the product's rows
  const int o0 = blockIdx.y * kBT;
  const int sr0 = o0 + rank * kRs;  // the weight rows this block builds
  const float scale_g = __fdiv_rn(g[0], static_cast<float>(n));
  const int x_tiles = (other_rows + kBT - 1) / kBT;
  const int nk = (ld16 + kK16 - 1) / kK16;  // recompute: sim slices a tile
  const int passes = ((d + kBT - 1) / kBT + kS - 1) / kS;
  const int tiles = passes * x_tiles;      // other tiles over all passes
  const int n_a = kCached ? 1 : nk;        // weight-source slots a tile
  auto chunk0 = [&](int tc) { return ((tc / x_tiles) * kS + rank) * kBT; };

  // Weight-source slot wi (tile wi / n_a, part wi % n_a) into the ring,
  // with the next tile's raw rows in its first part.
  auto issue_w = [&](int wi) {
    if (wi < tiles * n_a) {
      const int s = wi % n_a, x0 = (wi / n_a % x_tiles) * kBT;
      float* buf = ring + (wi % kStages) * kStage;
      const int nx0 = x0 + kBT < other_rows ? x0 + kBT : 0;  // the next tile
      if (s == 0 && t < kBT) {
        const int x = nx0 + t;
        const bool in = x < other_rows, iq = x < n;
        const int* lab = pm ? labels : pool_labels;
        cp_async4(buf + kSrc + t,
                  reinterpret_cast<const float*>(in ? lab + x : lab), in);
        if (pm) {
          const float* vec[6] = {pos_thr, neg_thr, max_all, isum, asum, valid};
#pragma unroll
          for (int j = 0; j < 6; ++j)
            cp_async4(buf + kSrc + (1 + j) * kBT + t,
                      iq ? vec[j] + x : vec[j], iq);
        }
      }
      if constexpr (kCached) {
        // [r][c], own row r and other row c, rows kWStride apart: query-
        // major sims[sr0 + r][x0 + c], 16 bytes a copy where the cache's
        // rows are 16-byte aligned (M % 4 == 0: a copy is then wholly in
        // or out); pool-major sims[x0 + c][sr0 + r], transposed by 4-byte
        // copies (consecutive threads on consecutive cache columns).
        if (vec && !pm) {
#pragma unroll
          for (int e = 0; e < kRs * kBT / 4 / kThreads; ++e) {
            const int idx = t + e * kThreads, r = idx / (kBT / 4);
            const int c = 4 * (idx % (kBT / 4));
            const bool in = sr0 + r < n && x0 + c < m;
            cp_async16(buf + r * kWStride + c,
                       in ? sims + static_cast<long long>(sr0 + r) * m + x0 +
                                c
                          : sims,
                       in);
          }
        } else {
#pragma unroll 4
          for (int e = 0; e < kRs * kBT / kThreads; ++e) {
            const int idx = t + e * kThreads;
            const int r = pm ? idx % kRs : idx / kBT;
            const int c = pm ? idx / kRs : idx % kBT;
            const int q = pm ? x0 + c : sr0 + r, i = pm ? sr0 + r : x0 + c;
            const bool in = q < n && i < m;
            cp_async4(buf + r * kWStride + c,
                      in ? sims + static_cast<long long>(q) * m + i : sims,
                      in);
          }
        }
      } else {
        __nv_bfloat16* b16 = reinterpret_cast<__nv_bfloat16*>(buf);
        load_rows16_slice<kRs>(b16, own16, own_rows, sr0, ld16, s * kK16);
        load_rows16_slice<kBT>(b16 + kRs * kK16, x16, other_rows, x0, ld16,
                               s * kK16);
      }
    }
    cp_async_commit();
  };
  // Tile tc's X rows x [x0, x0 + 128) x columns of the block's chunk into
  // X buffer tc & 1 (nothing where the block's pass has no columns).
  auto issue_x = [&](int tc) {
    const int c0 = chunk0(tc);
    if (tc < tiles && c0 < d) {
      const int x0 = (tc % x_tiles) * kBT;
      __nv_bfloat16* dst = xs + (tc & 1) * kTileBf16;
#pragma unroll
      for (int e = 0; e < kTileBf16 / 8 / kThreads; ++e) {
        const int idx = t + e * kThreads, r = idx >> 4, c = (idx & 15) * 8;
        const int row = x0 + r, col = c0 + c;
        const bool in = row < other_rows && col < ld16;
        cp_async16(reinterpret_cast<float*>(dst + sw128(r, c)),
                   reinterpret_cast<const float*>(
                       in ? x16 + static_cast<long long>(row) * ld16 + col
                          : x16),
                   in);
      }
    }
    cp_async_commit();
  };

  const int* xl = xlab;
  const float* xq = xterms;
  auto set_terms = [&](int b, int c, const QueryTerms& qt) {
    float* f = xterms + b * 5 * kBT + c;
    f[0] = qt.pt;
    f[1 * kBT] = qt.nt;
    f[2 * kBT] = qt.mx;
    f[3 * kBT] = qt.a;
    f[4 * kBT] = qt.b;
  };
  // Weights of elements (r, c .. c + 3) of this block's share (c % 4 ==
  // 0): own row sr0 + r, other rows x0 + c .., from their sims v (rounded
  // to bf16 when stored).  The four columns' labels and terms are read 16
  // bytes at a time.
  auto weights4 = [&](int r, int c, int x0, float4 v) {
    const int4 lab = *reinterpret_cast<const int4*>(xl + c);
    float4 f[5] = {};
    if (pm)
#pragma unroll
      for (int j = 0; j < 5; ++j)
        f[j] = *reinterpret_cast<const float4*>(xq + j * kBT + c);
    float wv[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int q = pm ? x0 + c + k : sr0 + r;
      const int i = pm ? sr0 + r : x0 + c + k;
      const int lc = comp(lab, k);
      const Pair p = pair_bits(q, i, pm ? lc : olab[r], pm ? olab[r] : lc,
                               f32, n, m, self_offset);
      const QueryTerms qt =
          pm ? QueryTerms{comp(f[0], k), comp(f[1], k), comp(f[2], k),
                          comp(f[3], k), comp(f[4], k)}
             : oqt[r];
      wv[k] = pair_weight(comp(v, k), p, ap, an, qt);
    }
    return make_float4(wv[0], wv[1], wv[2], wv[3]);
  };
  auto next_terms = [&](const float* raw, int b) {
    if (t < kBT) {
      xlab[b * kBT + t] = __float_as_int(raw[t]);
      if (pm)
        set_terms(b, t,
                  make_terms(raw[kBT + t], raw[2 * kBT + t],
                             raw[3 * kBT + t], raw[4 * kBT + t],
                             raw[5 * kBT + t], raw[6 * kBT + t],
                             margin_ident, margin_diff, scale_g));
    }
  };
  // Every rank's weight tiles, mapped once.
  __nv_bfloat16* wl_at[kS];
#pragma unroll
  for (int s = 0; s < kS; ++s)
    wl_at[s] = s == rank ? wl : cluster.map_shared_rank(wl, s);
  // Weights of share row r, columns c .. c + 3 (c % 4 == 0: 8 bytes of
  // one swizzle chunk), rounded to bf16, into every rank's weight tile
  // (buffer b): a warp's 32 stores are one row's 256 bytes.
  auto push4 = [&](int b, int r, int c, float4 w) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(w.x, w.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(w.z, w.w);
    const uint2 v = make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                               *reinterpret_cast<const unsigned*>(&hi));
    const int off = b * kTileBf16 + sw128(rank * kRs + r, c);
#pragma unroll
    for (int s = 0; s < kS; ++s)
      *reinterpret_cast<uint2*>(wl_at[s] + off) = v;
  };

  if (t < kRs) {
    const int o = sr0 + t;
    olab[t] = o < own_rows ? (pm ? pool_labels : labels)[o] : 0;
    if (!pm && o < n)
      oqt[t] = query_terms(o, margin_ident, margin_diff, pos_thr, neg_thr,
                           max_all, isum, asum, valid, scale_g);
  }
  if (t < kBT) {  // the first other tile's, into buffer 0
    xlab[t] = t < other_rows ? (pm ? labels : pool_labels)[t] : 0;
    if (pm && t < n)
      set_terms(0, t, query_terms(t, margin_ident, margin_diff, pos_thr,
                                  neg_thr, max_all, isum, asum, valid,
                                  scale_g));
  }
  for (int s = 0; s < kStages - 1; ++s) issue_w(s);
  issue_x(0);
  // Every block of the cluster runs before any stores into it.
  cluster.sync();

  // Tile tc's weight share into weight buffer tc & 1 of every rank.  That
  // buffer was read last by tile tc - 2's products, which every block
  // finished before the last cluster barrier; tile tc - 1's product runs
  // on meanwhile.
  int wi = 0;
  auto build = [&](int tc) {
    const int x0 = (tc % x_tiles) * kBT;
    xl = xlab + (tc & 1) * kBT;
    xq = xterms + (tc & 1) * 5 * kBT;
    const float* cs;  // the share's sims: [own row][other row], kWStride
    if constexpr (kCached) {
      cp_async_wait_ring();
      __syncthreads();  // the cache share is in
      issue_w(wi + kStages - 1);
      cs = ring + (wi % kStages) * kStage;
      ++wi;
      next_terms(cs + kSrc, (tc + 1) & 1);
    } else {
      // The share's sims on the tensor cores (sim_slice_tc: A the query
      // rows, B the pool rows).  gq: warp group 0 multiplies the kRs own
      // (query) rows, padded to its 64 by the slot's next rows, whose sims
      // are not read, by the 128 other rows; gdb: each warp group 64 of
      // the other (query) rows by the kRs own (pool) rows, padded to 128
      // likewise.  The main product of the last tile may still run: a
      // wait here waits for it too.
      static_assert(kRs * kWStride <= kSrc, "the share fits its slot");
      const bool mine = pm || wg == 0;
      float sacc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) sacc[i] = 0.f;
      for (int s = 0; s < nk; ++s, ++wi) {
        cp_async_wait_ring();
        __syncthreads();  // slice s is in; slice s - 1's slot is free
        issue_w(wi + kStages - 1);
        const float* buf = ring + (wi % kStages) * kStage;
        if (s == 0) next_terms(buf + kSrc, (tc + 1) & 1);
        if (mine) {
          fence_to_wgmma();
          const unsigned own = smem_u32(buf), oth = own + kRs * 128;
          sim_slice_tc(sacc, pm ? oth + wg * 64 * 128 : own, pm ? own : oth,
                       s == 0);
          wgmma_wait_all();
        }
      }
      // Then canonicalised into the last slot as a cached share lands.
      float* share = ring + ((wi - 1) % kStages) * kStage;
      if (mine) pin(sacc);
      __syncthreads();  // every warp group's product is done with the slot
      if (mine) {
        const int fr = wg * 64 + lw * 16 + (ln >> 2);
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int row = fr + 8 * h, col = 8 * j + 2 * (ln & 3) + e;
              if (pm ? col < kRs : row < kRs)
                share[pm ? col * kWStride + row : row * kWStride + col] =
                    canon0(sacc[4 * j + 2 * h + e]);
            }
      }
      __syncthreads();  // the share is in
      cs = share;
    }
#pragma unroll
    for (int e = 0; e < kQuads; ++e) {
      // A warp takes the 128 columns of one row, 4 a thread.
      const int idx = t + e * kThreads, r = idx / (kBT / 4);
      const int c = 4 * (idx % (kBT / 4));
      const float4 v = *reinterpret_cast<const float4*>(cs + r * kWStride +
                                                        c);
      push4(tc & 1, r, c, weights4(r, c, x0, v));
    }
  };
  // Tile tc's X copies are older than the weight slots issued since; the
  // block's last product ends; then every rank's share of tile tc is
  // everywhere, and tile tc - 1's buffers are free.
  auto tile_sync = [&]() {
    cp_async_wait_ring();
    wgmma_wait_all();
    cluster.sync();  // tile tc's weights everywhere; tile tc - 1's buffers free
    fence_to_wgmma();
  };

  // The warp group's 64 x 128 fragment: thread (warp w, lane l) holds
  // rows 16 w + l / 4 (+ 8) and columns 8 j + 2 (l % 4) (+ 1), j < 16.
  // Each pass's first product overwrites it (scale-d 0), and a product
  // in flight is read by nothing but the next product until the wait: so
  // the loop over a pass's tiles issues one unconditionally, and ptxas
  // needs no wait of its own.
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  auto product = [&](int tc, bool first) {
    const unsigned wa = smem_u32(wl + (tc & 1) * kTileBf16) + wg * 64 * 128;
    const unsigned xa = smem_u32(xs + (tc & 1) * kTileBf16);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kBT / 16; ++k)
      wgmma_m64n128k16(
          acc,
          // W: K-major, k16 step k at byte 32 (k % 4) of its half.
          wgmma_desc(wa + (k >> 2) * kBT * 128 + (k & 3) * 32, 16, 1024),
          // X: N-major, rows 16 k ..; the column halves 16 KB apart.
          wgmma_desc(xa + k * 16 * 128, kBT * 128, 1024), k > 0 || !first);
    wgmma_commit();  // it runs on through the next tile's build
  };
  int tc = 0;
  for (int p = 0; p < passes; ++p) {
    const int c0 = (p * kS + rank) * kBT;
    if (c0 >= d) {  // no columns this pass: the weight shares alone
      for (int xt = 0; xt < x_tiles; ++xt, ++tc) {
        build(tc);
        tile_sync();
        issue_x(tc + 1);
      }
      continue;
    }
    for (int xt = 0; xt < x_tiles; ++xt, ++tc) {
      build(tc);
      tile_sync();
      product(tc, xt == 0);
      issue_x(tc + 1);  // its buffer's last product (tile tc - 1) is done
    }
    wgmma_wait_all();
    pin(acc);
    // Each output element written once.
    const int r0 = o0 + wg * 64 + lw * 16 + (ln >> 2);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = c0 + 8 * j + 2 * (ln & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h;
        if (row < own_rows && col < d)
          *reinterpret_cast<float2*>(out + static_cast<long long>(row) * d +
                                     col) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
  cluster.sync();  // no block leaves while another may still store to it
}

// ------------------------------------------------------- launchers

inline unsigned tiles128(int rows) {
  return static_cast<unsigned>((rows + kBT - 1) / kBT);
}

inline bool bad_dims(int n, int m, int d) { return n < 1 || m < 1 || d < 1; }

// A sweep's pool-axis split: of 1, 2, 4, 8 (at most the pool's tiles),
// the one whose blocks fill the card's SMs, per_sm resident blocks each,
// best over whole waves; the smaller on a tie within 1 %.
inline int pool_splits(int n, int m, int per_sm) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long rows = tiles128(n), cols = tiles128(m);
  const long long slots = static_cast<long long>(sms) * per_sm;
  int best = 1;
  double best_fill = 0.0;
  for (int s = 1; s <= kMaxCluster && s <= cols; s *= 2) {
    const long long blocks = rows * s;
    const long long waves = (blocks + slots - 1) / slots;
    const double fill = static_cast<double>(blocks) / (waves * slots);
    if (fill > best_fill + 0.01) {
      best = s;
      best_fill = fill;
    }
  }
  return best;
}

template <typename K, typename... Args>
cudaError_t launch_cluster(K kernel, dim3 grid, int cluster_x, size_t smem,
                           cudaStream_t s, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster_x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// feats16 non-null: the bf16 mode on the tensor cores.
int launch_stats(const float* feats, const void* labels, const float* pool,
                 const void* pool_labels, int label_f32, int n, int m, int d,
                 int self_offset, float* min_w, float* max_b, float* max_a,
                 int* cnt_s, int* cnt_d, int* hist_s, int* hist_d,
                 float* topk, int k, float* sims_out,
                 const __nv_bfloat16* feats16, const __nv_bfloat16* pool16,
                 int ld16, cudaStream_t s) {
  const int splits = pool_splits(n, m, 1);
  const bool tc = feats16 != nullptr;
  const size_t smem =
      sizeof(float) * stats_smem_floats(k) + (tc ? kAlignSlack : 0);
  return static_cast<int>(launch_cluster(
      tc ? npair_stats_kernel<true> : npair_stats_kernel<false>,
      dim3(splits, tiles128(n)), splits, smem, s, feats,
      static_cast<const int*>(labels), pool,
      static_cast<const int*>(pool_labels), label_f32, n, m, d, self_offset,
      min_w, max_b, max_a, cnt_s, cnt_d, hist_s, hist_d, topk, k, sims_out,
      feats16, pool16, ld16));
}

// The cached variants copy 16 bytes at a time where the cache's rows are
// 16-byte aligned.
inline int vec_rows(const float* sims, int m) {
  return m % 4 == 0 && reinterpret_cast<uintptr_t>(sims) % 16 == 0;
}

// The recompute variants (sims null) in the bf16 mode (feats16 non-null)
// run on the tensor cores; the cached variants read only the cache.
template <typename L>
int launch_hist(const float* feats, const int* labels, const float* pool,
                const int* pool_labels, const float* sims, int n, int m,
                int d, int self_offset, int sides, int same0, int same1,
                const unsigned* prefix0, const unsigned* prefix1, int digit,
                const unsigned char* skip, int* out0, int* out1,
                const __nv_bfloat16* feats16, const __nv_bfloat16* pool16,
                int ld16, cudaStream_t s) {
  const int splits = pool_splits(n, m, 2);
  const dim3 grid(splits, tiles128(n));
  const bool cached = sims != nullptr, tc = !cached && feats16 != nullptr;
  return static_cast<int>(launch_cluster(
      cached ? npair_hist_kernel<true, L>
      : tc   ? npair_hist_kernel<false, L, true>
             : npair_hist_kernel<false, L>,
      grid, splits, hist_smem_bytes(cached) + (tc ? kAlignSlack : 0), s,
      feats, labels, pool, pool_labels, sims,
      cached ? vec_rows(sims, m) : 0, n, m, d, self_offset, sides, same0,
      same1, prefix0, prefix1, digit, skip, out0, out1, feats16, pool16,
      ld16));
}

template <typename L>
int launch_loss(const float* feats, const int* labels, const float* pool,
                const int* pool_labels, const float* sims, int n, int m,
                int d, int self_offset, int ap, int an, float mi, float md,
                const float* pos_thr, const float* neg_thr,
                const float* max_all, float* isum, float* dsum, float* inum,
                float* dnum, const __nv_bfloat16* feats16,
                const __nv_bfloat16* pool16, int ld16, cudaStream_t s) {
  const int splits = pool_splits(n, m, 2);
  const dim3 grid(splits, tiles128(n));
  const bool cached = sims != nullptr, tc = !cached && feats16 != nullptr;
  return static_cast<int>(launch_cluster(
      cached ? npair_loss_kernel<true, L>
      : tc   ? npair_loss_kernel<false, L, true>
             : npair_loss_kernel<false, L>,
      grid, splits, loss_smem_bytes(cached) + (tc ? kAlignSlack : 0), s,
      feats, labels, pool, pool_labels, sims,
      cached ? vec_rows(sims, m) : 0, n, m, d, self_offset, ap, an, mi, md,
      pos_thr, neg_thr, max_all, isum, dsum, inum, dnum, feats16, pool16,
      ld16));
}

// The cluster of D-chunks: ceil(D / 128) rounded up to 4 or 8.  For D <=
// 384 some blocks have no columns: they build their rows of each
// weight tile and skip the product (a cache share then fits one ring
// stage, and the recompute variant's rows stay 2 or 1 per thread).
inline int grad_cluster(int d) { return (d + kBT - 1) / kBT <= 4 ? 4 : 8; }

template <bool kCached, int kS>
int launch_grad_s(const float* feats, const int* labels, const float* pool,
                  const int* pool_labels, int label_f32, int pool_major,
                  const float* sims, int n, int m, int d, int self_offset,
                  int ap, int an, float mi, float md, const float* pos_thr,
                  const float* neg_thr, const float* max_all,
                  const float* isum, const float* asum, const float* valid,
                  const float* g, const __nv_bfloat16* feats16,
                  const __nv_bfloat16* pool16, int ld16, float* out,
                  cudaStream_t s) {
  const dim3 grid(kS, tiles128(pool_major ? m : n));
  if (feats16 != nullptr)
    return static_cast<int>(launch_cluster(
        npair_grad_tc_kernel<kCached, kS>, grid, kS,
        grad_tc_smem_bytes<kCached, kS>(), s, feats, labels, pool,
        pool_labels, label_f32, pool_major, sims, n, m, d, self_offset, ap,
        an, mi, md, pos_thr, neg_thr, max_all, isum, asum, valid, g, feats16,
        pool16, ld16, sims != nullptr ? vec_rows(sims, m) : 0, out));
  return static_cast<int>(launch_cluster(
      npair_grad_kernel<kCached, kS>, grid, kS,
      grad_smem_bytes<kCached, kS>(),
      s, feats, labels, pool, pool_labels, label_f32, pool_major, sims, n, m,
      d, self_offset, ap, an, mi, md, pos_thr, neg_thr, max_all, isum, asum,
      valid, g, out));
}

template <bool kCached>
int launch_grad(const float* feats, const int* labels, const float* pool,
                const int* pool_labels, int label_f32, int pool_major,
                const float* sims, int n, int m, int d, int self_offset,
                int ap, int an, float mi, float md, const float* pos_thr,
                const float* neg_thr, const float* max_all,
                const float* isum, const float* asum, const float* valid,
                const float* g, const __nv_bfloat16* feats16,
                const __nv_bfloat16* pool16, int ld16, float* out,
                cudaStream_t s) {
#define NPL_GRAD_S(S)                                                       \
  return launch_grad_s<kCached, S>(                                         \
      feats, labels, pool, pool_labels, label_f32, pool_major, sims, n, m,  \
      d, self_offset, ap, an, mi, md, pos_thr, neg_thr, max_all, isum, asum, \
      valid, g, feats16, pool16, ld16, out, s)
  if (grad_cluster(d) == 4) NPL_GRAD_S(4);
  NPL_GRAD_S(8);
#undef NPL_GRAD_S
}

// Checks the bf16 mode's rows: both or neither of feats16 and pool16;
// ld16 % 8 == 0, ld16 >= d, both 16-byte aligned.
inline bool bad_rows16(const void* feats16, const void* pool16, int ld16,
                       int d) {
  auto off16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if ((feats16 == nullptr) != (pool16 == nullptr)) return true;
  return feats16 != nullptr &&
         (ld16 % 8 != 0 || ld16 < d || off16(feats16) || off16(pool16));
}

}  // namespace

// ------------------------------------------------------- C interface
//
// Every pointer is device memory; labels are int32 (label_f32 = 0) or
// float32 (1); a null `sims` selects the recompute variant, a non-null
// one the cached variant.  Every variant that reads feats and pool needs
// D % 4 == 0 and 16-byte aligned rows (the wrappers pad).  feats16 and
// pool16 null: the fp32 mode.  Else the bf16 mode on the tensor cores:
// feats and pool come rounded (npl_round_bf16), and feats16 / pool16 hold
// the same rows as bf16, [rows][ld16], ld16 % 8 == 0, ld16 >= d, zero past
// d, 16-byte aligned; every sim is then the tensor cores' sum of their
// products (stats; the recompute hist, loss, gq and gdb), and gq/gdb
// multiply their weight tile by pool16 / feats16.  Entries return the
// cudaError_t of their launch.

extern "C" {

int npl_npair_stats(const void* feats, const void* labels, const void* pool,
                    const void* pool_labels, int n, int m, int d,
                    int self_offset, int label_f32, void* min_w, void* max_b,
                    void* max_a, void* cnt_s, void* cnt_d, void* hist_s,
                    void* hist_d, void* topk, int k, void* sims_out,
                    const void* feats16, const void* pool16, int ld16,
                    void* stream) {
  if (bad_dims(n, m, d) || d % 4 != 0 || k < 0 || k > kMaxTopK ||
      (k > 0) != (topk != nullptr) || bad_rows16(feats16, pool16, ld16, d))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto fo = [](void* p) { return static_cast<float*>(p); };
  auto io = [](void* p) { return static_cast<int*>(p); };
  auto b = [](const void* p) { return static_cast<const __nv_bfloat16*>(p); };
  return launch_stats(f(feats), labels, f(pool), pool_labels, label_f32, n,
                      m, d, self_offset, fo(min_w), fo(max_b), fo(max_a),
                      io(cnt_s), io(cnt_d), io(hist_s), io(hist_d), fo(topk),
                      k, fo(sims_out), b(feats16), b(pool16), ld16, s);
}

int npl_npair_hist(const void* feats, const void* labels, const void* pool,
                   const void* pool_labels, const void* sims, int n, int m,
                   int d, int self_offset, int label_f32, int sides,
                   int same0, int same1, const void* prefix0,
                   const void* prefix1, int digit, const void* skip,
                   void* out0, void* out1, const void* feats16,
                   const void* pool16, int ld16, void* stream) {
  if (bad_dims(n, m, d) || sides < 1 || sides > 2 || digit < 1 ||
      digit > 7 || (sims == nullptr && d % 4 != 0) ||
      bad_rows16(feats16, pool16, ld16, d))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(feats);
  const int* l = static_cast<const int*>(labels);
  const int* pl = static_cast<const int*>(pool_labels);
  const float* p = static_cast<const float*>(pool);
  const float* c = static_cast<const float*>(sims);
  const unsigned* p0 = static_cast<const unsigned*>(prefix0);
  const unsigned* p1 = static_cast<const unsigned*>(prefix1);
  const unsigned char* sk = static_cast<const unsigned char*>(skip);
  int* o0 = static_cast<int*>(out0);
  int* o1 = static_cast<int*>(out1);
  const auto* f16 = static_cast<const __nv_bfloat16*>(feats16);
  const auto* p16 = static_cast<const __nv_bfloat16*>(pool16);
  if (label_f32)
    return launch_hist<float>(f, l, p, pl, c, n, m, d, self_offset, sides,
                              same0, same1, p0, p1, digit, sk, o0, o1, f16,
                              p16, ld16, s);
  return launch_hist<int>(f, l, p, pl, c, n, m, d, self_offset, sides, same0,
                          same1, p0, p1, digit, sk, o0, o1, f16, p16, ld16,
                          s);
}

int npl_npair_loss(const void* feats, const void* labels, const void* pool,
                   const void* pool_labels, const void* sims, int n, int m,
                   int d, int self_offset, int label_f32, int ap, int an,
                   float margin_ident, float margin_diff, const void* pos_thr,
                   const void* neg_thr, const void* max_all, void* isum,
                   void* dsum, void* inum, void* dnum, const void* feats16,
                   const void* pool16, int ld16, void* stream) {
  if (bad_dims(n, m, d) || (sims == nullptr && d % 4 != 0) ||
      bad_rows16(feats16, pool16, ld16, d))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto fo = [](void* p) { return static_cast<float*>(p); };
  auto li = [](const void* p) { return static_cast<const int*>(p); };
  auto b = [](const void* p) { return static_cast<const __nv_bfloat16*>(p); };
#define NPL_LOSS(L)                                                          \
  return launch_loss<L>(f(feats), li(labels), f(pool), li(pool_labels),      \
                        f(sims), n, m, d, self_offset, ap, an, margin_ident, \
                        margin_diff, f(pos_thr), f(neg_thr), f(max_all),     \
                        fo(isum), fo(dsum), fo(inum), fo(dnum), b(feats16),  \
                        b(pool16), ld16, s)
  if (label_f32) NPL_LOSS(float);
  NPL_LOSS(int);
#undef NPL_LOSS
}

// pool_major = 0: gq [n, d] = w @ pool; 1: gdb [m, d] = w^T @ feats.
int npl_npair_grad(const void* feats, const void* labels, const void* pool,
                   const void* pool_labels, const void* sims, int n, int m,
                   int d, int self_offset, int label_f32, int ap, int an,
                   float margin_ident, float margin_diff, const void* pos_thr,
                   const void* neg_thr, const void* max_all, const void* isum,
                   const void* asum, const void* valid, const void* g,
                   int pool_major, void* out, const void* feats16,
                   const void* pool16, int ld16, void* stream) {
  if (bad_dims(n, m, d) || d % 4 != 0 ||
      bad_rows16(feats16, pool16, ld16, d))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto li = [](const void* p) { return static_cast<const int*>(p); };
  auto b = [](const void* p) { return static_cast<const __nv_bfloat16*>(p); };
  float* o = static_cast<float*>(out);
#define NPL_GRAD(C)                                                          \
  return launch_grad<C>(f(feats), li(labels), f(pool), li(pool_labels),      \
                        label_f32, pool_major, f(sims), n, m, d, self_offset, \
                        ap, an, margin_ident, margin_diff, f(pos_thr),       \
                        f(neg_thr), f(max_all), f(isum), f(asum), f(valid),  \
                        f(g), b(feats16), b(pool16), ld16, o, s)
  if (sims != nullptr) NPL_GRAD(true);
  NPL_GRAD(false);
#undef NPL_GRAD
}

// The bf16 mode's operands, once per loss: dst [rows * d] = src rounded
// to bf16 (round to nearest even) and widened back to fp32, and dst16
// [rows][ld16] = the same as bf16, zero past d (ld16 % 8 == 0, ld16 >= d).
int npl_round_bf16(const void* src, void* dst, void* dst16, long long rows,
                   int d, int ld16, void* stream) {
  if (rows < 0 || d < 1 || dst == nullptr || dst16 == nullptr ||
      ld16 % 8 != 0 || ld16 < d ||
      reinterpret_cast<uintptr_t>(dst16) % 16 != 0)
    return cudaErrorInvalidValue;
  const long long count = rows * d;
  if (count == 0) return cudaSuccess;
  const float* x = static_cast<const float*>(src);
  float* y = static_cast<float*>(dst);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0;
  int vec = count % 4 == 0 && aligned ? 1 : 0;
  if (ld16 == d && d % 8 == 0 && aligned) vec = 2;
  const long long work = vec == 2 ? count / 8 : vec ? count / 4 : count;
  const long long want = (work + 255) / 256;
  const int blocks = static_cast<int>(want < 132 * 8 ? want : 132 * 8);
  round_bf16_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, static_cast<__nv_bfloat16*>(dst16), rows, d, ld16, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
