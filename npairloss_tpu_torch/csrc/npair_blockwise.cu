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
//
// Bound on an H100 (67 TFLOP/s fp32 outside the tensor cores, 3.35 TB/s
// HBM).  Every sweep that recomputes its sims does 2 N M D flop and is
// bound by operations (at N = M = 32768, D = 512: 16.4 ms); gq and gdb
// add their own 2 N M D product (16.4 ms with the cache, 32.8 ms
// recomputing).  The cached hist and loss sweeps read the N x M fp32
// cache once and are bound by bytes (4.29 GB: 1.28 ms).
//
// Design.  A block of 256 threads owns a 64-row tile of its output axis
// (queries; pool rows for gdb) and loops over 64-row tiles of the other
// axis, keeping its outputs resident — running minima and maxima,
// counts, histogram bins, the K-slot buffer, the I/D sums — or, for the
// gradients, read-modify-writing rows of the output that no other block
// touches.  No atomics anywhere, so repeat runs are bit-identical.
//   * One sim function, one order: sim(q, i) is one __fmaf_rn chain over
//     k = 0..D-1 (sim_tile), whichever operand a block owns, so the sims
//     a pool-major gdb block computes equal the query-major ones, and
//     the cache the stats kernel writes equals what every recompute
//     sweep computes.  The cached and recompute variants of a sweep
//     differ only in produce_tile; everything after it is one code
//     path, so they give the same bits.
//   * The sim tile: each thread accumulates a 4 x 4 micro-tile from
//     16-deep slices of both operands staged in shared memory, then the
//     tile goes to shared memory, where four threads share each tile row
//     for the epilogue (16 columns each) and combine with warp shuffles
//     in a fixed order at the end.
//   * Ragged edges by bounds: rows >= n and columns >= m read 0 and fall
//     outside both masks; the self pair is column row + self_offset.
//   * Element-wise maths in explicit __f*_rn intrinsics (expf is the
//     full-precision libdevice exp), so no FMA contraction moves a
//     rounding; masking is by selection, never by multiplying with a 0
//     mask (a query with no pairs has max_all = -FLT_MAX and exp
//     overflows).
//   * The K-slot buffer keeps the K largest masked same-label sims per
//     query, duplicates as distinct entries: each thread keeps a sorted
//     buffer of its columns in shared memory, and the row's four buffers
//     merge into K descending slots padded with -FLT_MAX.
//   * The radix histograms count with 16 compares per element into
//     registers (no scatter).  The hist kernel reads a device flag and,
//     when the pos_topk fast path already holds, writes zeros and
//     returns, so the fallback needs no host sync.

#include <float.h>

#include "common.cuh"

namespace {

constexpr int kT = 64;             // rows of a tile, both axes
constexpr int kTK = 16;            // depth of a staged operand slice
constexpr int kThreads = 256;
constexpr int kRowThreads = 4;     // threads sharing one tile row
constexpr int kCols = kT / kRowThreads;  // columns per thread
constexpr int kBins = 16;          // 4-bit radix digits
constexpr int kMaxTopK = 32;  // MAX_TOPK in ops/blockwise_npair.py

// MiningMethod (ops/npair_loss.py).
enum Method { HARD = 0, EASY = 1, RAND = 2, RELATIVE_HARD = 3, RELATIVE_EASY = 4 };

struct TileSmem {
  union {
    struct {
      float a[kTK][kT + 4];  // owned rows' slice, k-major
      float b[kTK][kT + 4];  // other rows' slice, k-major
    } op;
    float x[kT][kT + 4];     // the gradient's operand rows
  } u;
  float s[kT][kT + 1];       // the sim tile, then the weight tile
};

// The one fp32 dot product of every kernel here: for owned rows
// [o0, o0+64) of `own` and rows [x0, x0+64) of `other` (both row-major,
// D columns), acc[a][b] = sum_k own[ty+16a][k] * other[tx+16b][k] as one
// __fmaf_rn chain in increasing k.  Rows past the ends read 0; slices
// past D are zero-padded, and fmaf(0, 0, acc) == acc exactly because the
// chain starts at +0 and so never holds -0.
__device__ __forceinline__ void sim_tile(const float* __restrict__ own,
                                         int own_rows, int o0,
                                         const float* __restrict__ other,
                                         int other_rows, int x0, int d,
                                         TileSmem& sm, float acc[4][4]) {
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  for (int k0 = 0; k0 < d; k0 += kTK) {
#pragma unroll
    for (int e = 0; e < kT * kTK / kThreads; ++e) {
      const int idx = t + e * kThreads, r = idx / kTK, kk = idx % kTK;
      const int k = k0 + kk;
      const bool kin = k < d;
      sm.u.op.a[kk][r] = (kin && o0 + r < own_rows)
                             ? own[static_cast<long long>(o0 + r) * d + k]
                             : 0.f;
      sm.u.op.b[kk][r] = (kin && x0 + r < other_rows)
                             ? other[static_cast<long long>(x0 + r) * d + k]
                             : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = sm.u.op.a[kk][ty + 16 * a];
#pragma unroll
      for (int b = 0; b < 4; ++b) bv[b] = sm.u.op.b[kk][tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          acc[a][b] = __fmaf_rn(av[a], bv[b], acc[a][b]);
    }
    __syncthreads();
  }
}

// Fill sm.s[own][other] for the tile at (q0, i0): recomputed by sim_tile
// or read from the N x M cache.  kPoolMajor: the block owns pool rows
// (gdb), so sm.s[r][c] = sim(q0 + c, i0 + r).  emit (query-major only)
// also writes the recomputed tile to the cache.
template <bool kCached, bool kPoolMajor>
__device__ __forceinline__ void produce_tile(
    const float* __restrict__ feats, const float* __restrict__ pool,
    const float* __restrict__ sims, float* __restrict__ emit, int n, int m,
    int d, int q0, int i0, TileSmem& sm) {
  const int t = threadIdx.x;
  if (kCached) {
#pragma unroll
    for (int e = 0; e < kT * kT / kThreads; ++e) {
      const int idx = t + e * kThreads;
      // Consecutive threads read consecutive cache columns (pool rows).
      const int col = idx % kT, row = idx / kT;
      const int q = q0 + row, i = i0 + col;
      const float v = (q < n && i < m)
                          ? sims[static_cast<long long>(q) * m + i]
                          : 0.f;
      if (kPoolMajor)
        sm.s[col][row] = v;
      else
        sm.s[row][col] = v;
    }
  } else {
    float acc[4][4];
    if (kPoolMajor)
      sim_tile(pool, m, i0, feats, n, q0, d, sm, acc);
    else
      sim_tile(feats, n, q0, pool, m, i0, d, sm, acc);
    const int ty = t / 16, tx = t % 16;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int r = ty + 16 * a, c = tx + 16 * b;
        sm.s[r][c] = acc[a][b];
        if (!kPoolMajor && emit != nullptr && q0 + r < n && i0 + c < m)
          emit[static_cast<long long>(q0 + r) * m + i0 + c] = acc[a][b];
      }
  }
  __syncthreads();
}

__device__ __forceinline__ unsigned sortable_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Add one key's digit to a 16-bin register histogram, if its higher
// digits match the prefix (digit 0: always).
__device__ __forceinline__ void hist_add(int h[kBins], unsigned key,
                                         int digit, unsigned prefix) {
  if (digit > 0 && (key >> (32 - 4 * digit)) != prefix) return;
  const unsigned bin = (key >> (28 - 4 * digit)) & (kBins - 1);
#pragma unroll
  for (int b = 0; b < kBins; ++b) h[b] += (bin == static_cast<unsigned>(b));
}

// Sum (ints) or reduce across the four threads of a tile row, in a fixed
// order: lane j ends with (v_j + v_j^1) + (v_j^2 + v_j^3).
__device__ __forceinline__ int row_sum(int v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}
__device__ __forceinline__ float row_fsum(float v) {
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return v;
}
__device__ __forceinline__ float row_min(float v) {
  v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fminf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float row_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// selection_predicates (ops/npair_loss.py), cu:80-119.
__device__ __forceinline__ bool pos_pred(int method, float s, float pt) {
  switch (method) {
    case HARD: return s < pt;
    case EASY: return s >= pt;
    case RAND: return true;
    case RELATIVE_HARD: return s <= pt;
    default: return s >= pt;
  }
}
__device__ __forceinline__ bool neg_pred(int method, float s, float nt) {
  switch (method) {
    case HARD: return s > nt;
    case EASY: return s <= nt;
    case RAND: return true;
    case RELATIVE_HARD: return s >= nt;
    default: return s <= nt;
  }
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

// ------------------------------------------------------------ stats

template <typename L>
__global__ void __launch_bounds__(kThreads) npair_stats_kernel(
    const float* __restrict__ feats, const L* __restrict__ labels,
    const float* __restrict__ pool, const L* __restrict__ pool_labels,
    int n, int m, int d, int self_offset, float* __restrict__ min_w,
    float* __restrict__ max_b, float* __restrict__ max_a,
    int* __restrict__ cnt_s, int* __restrict__ cnt_d,
    int* __restrict__ hist_s, int* __restrict__ hist_d,
    float* __restrict__ topk, int k, float* __restrict__ sims_out) {
  __shared__ TileSmem sm;
  __shared__ L plab[kT];
  extern __shared__ float topk_buf[];  // [k][kThreads]
  const int t = threadIdx.x, r = t / kRowThreads, j = t % kRowThreads;
  const int q0 = blockIdx.x * kT, q = q0 + r;
  const L lq = q < n ? labels[q] : L(0);
  float mn = FLT_MAX, mxb = -FLT_MAX, mxa = -FLT_MAX;
  int cs = 0, cd = 0;
  int hs[kBins], hd[kBins];
#pragma unroll
  for (int b = 0; b < kBins; ++b) hs[b] = hd[b] = 0;
  for (int s = 0; s < k; ++s) topk_buf[s * kThreads + t] = -FLT_MAX;

  for (int i0 = 0; i0 < m; i0 += kT) {
    if (t < kT) plab[t] = i0 + t < m ? pool_labels[i0 + t] : L(0);
    produce_tile<false, false>(feats, pool, nullptr, sims_out, n, m, d, q0,
                               i0, sm);
    for (int u = 0; u < kCols; ++u) {
      const int c = j * kCols + u, i = i0 + c;
      const float v = sm.s[r][c];
      const Pair p = pair_of(q, i, lq, plab[c], n, m, self_offset);
      if (p.same) {
        mn = fminf(mn, v);
        ++cs;
        if (hist_s != nullptr) hist_add(hs, sortable_key(v), 0, 0u);
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
        if (hist_d != nullptr) hist_add(hd, sortable_key(v), 0, 0u);
      }
      if (p.same || p.diff) mxa = fmaxf(mxa, v);
    }
    __syncthreads();  // sm.s and plab are rewritten by the next tile
  }

  mn = row_min(mn);
  mxb = row_max(mxb);
  mxa = row_max(mxa);
  cs = row_sum(cs);
  cd = row_sum(cd);
#pragma unroll
  for (int b = 0; b < kBins; ++b) {
    hs[b] = row_sum(hs[b]);
    hd[b] = row_sum(hd[b]);
  }
  if (j == 0 && q < n) {
    min_w[q] = mn;
    max_b[q] = mxb;
    max_a[q] = mxa;
    cnt_s[q] = cs;
    cnt_d[q] = cd;
#pragma unroll
    for (int b = 0; b < kBins; ++b) {
      if (hist_s != nullptr) hist_s[q * kBins + b] = hs[b];
      if (hist_d != nullptr) hist_d[q * kBins + b] = hd[b];
    }
  }
  if (k > 0) {
    __syncthreads();
    if (j == 0 && q < n) {
      // Merge the row's four descending buffers into K descending slots.
      int at[kRowThreads] = {0, 0, 0, 0};
      for (int s = 0; s < k; ++s) {
        int best = 0;
        float bv = -FLT_MAX;
        for (int w = 0; w < kRowThreads; ++w) {
          const float cand =
              at[w] < k ? topk_buf[at[w] * kThreads + t + w] : -FLT_MAX;
          if (w == 0 || cand > bv) {
            bv = cand;
            best = w;
          }
        }
        ++at[best];
        topk[static_cast<long long>(q) * k + s] = bv;
      }
    }
  }
}

// ------------------------------------------------------------- hist

template <bool kCached, typename L>
__global__ void __launch_bounds__(kThreads) npair_hist_kernel(
    const float* __restrict__ feats, const L* __restrict__ labels,
    const float* __restrict__ pool, const L* __restrict__ pool_labels,
    const float* __restrict__ sims, int n, int m, int d, int self_offset,
    int sides, int same0, int same1, const unsigned* __restrict__ prefix0,
    const unsigned* __restrict__ prefix1, int digit,
    const unsigned char* __restrict__ skip, int* __restrict__ out0,
    int* __restrict__ out1) {
  __shared__ TileSmem sm;
  __shared__ L plab[kT];
  const int t = threadIdx.x, r = t / kRowThreads, j = t % kRowThreads;
  const int q0 = blockIdx.x * kT, q = q0 + r;
  if (skip != nullptr && *skip) {
    // The pos_topk fast path holds: this sweep's result is not used.
    for (int idx = t; idx < kT * kBins; idx += kThreads) {
      const int qq = q0 + idx / kBins;
      if (qq >= n) continue;
      out0[q0 * kBins + idx] = 0;
      if (sides > 1) out1[q0 * kBins + idx] = 0;
    }
    return;
  }
  const L lq = q < n ? labels[q] : L(0);
  const unsigned p0 = q < n ? prefix0[q] : 0u;
  const unsigned p1 = (sides > 1 && q < n) ? prefix1[q] : 0u;
  int h0[kBins], h1[kBins];
#pragma unroll
  for (int b = 0; b < kBins; ++b) h0[b] = h1[b] = 0;

  for (int i0 = 0; i0 < m; i0 += kT) {
    if (t < kT) plab[t] = i0 + t < m ? pool_labels[i0 + t] : L(0);
    produce_tile<kCached, false>(feats, pool, sims, nullptr, n, m, d, q0, i0,
                                 sm);
    for (int u = 0; u < kCols; ++u) {
      const int c = j * kCols + u;
      const Pair p = pair_of(q, i0 + c, lq, plab[c], n, m, self_offset);
      if (!(p.same || p.diff)) continue;
      const unsigned key = sortable_key(sm.s[r][c]);
      if (same0 ? p.same : p.diff) hist_add(h0, key, digit, p0);
      if (sides > 1 && (same1 ? p.same : p.diff)) hist_add(h1, key, digit, p1);
    }
    __syncthreads();
  }
#pragma unroll
  for (int b = 0; b < kBins; ++b) {
    h0[b] = row_sum(h0[b]);
    h1[b] = row_sum(h1[b]);
  }
  if (j == 0 && q < n) {
#pragma unroll
    for (int b = 0; b < kBins; ++b) {
      out0[q * kBins + b] = h0[b];
      if (sides > 1) out1[q * kBins + b] = h1[b];
    }
  }
}

// ------------------------------------------------------------- loss

template <bool kCached, typename L>
__global__ void __launch_bounds__(kThreads) npair_loss_kernel(
    const float* __restrict__ feats, const L* __restrict__ labels,
    const float* __restrict__ pool, const L* __restrict__ pool_labels,
    const float* __restrict__ sims, int n, int m, int d, int self_offset,
    int ap, int an, float margin_ident, float margin_diff,
    const float* __restrict__ pos_thr, const float* __restrict__ neg_thr,
    const float* __restrict__ max_all, float* __restrict__ isum,
    float* __restrict__ dsum, float* __restrict__ inum,
    float* __restrict__ dnum) {
  __shared__ TileSmem sm;
  __shared__ L plab[kT];
  const int t = threadIdx.x, r = t / kRowThreads, j = t % kRowThreads;
  const int q0 = blockIdx.x * kT, q = q0 + r;
  const bool live = q < n;
  const L lq = live ? labels[q] : L(0);
  const float pt = live ? __fadd_rn(pos_thr[q], margin_ident) : 0.f;
  const float nt = live ? __fadd_rn(neg_thr[q], margin_diff) : 0.f;
  const float mx = live ? max_all[q] : 0.f;
  float is = 0.f, ds = 0.f;
  int ic = 0, dc = 0;
  for (int i0 = 0; i0 < m; i0 += kT) {
    if (t < kT) plab[t] = i0 + t < m ? pool_labels[i0 + t] : L(0);
    produce_tile<kCached, false>(feats, pool, sims, nullptr, n, m, d, q0, i0,
                                 sm);
    for (int u = 0; u < kCols; ++u) {
      const int c = j * kCols + u;
      const float v = sm.s[r][c];
      const Pair p = pair_of(q, i0 + c, lq, plab[c], n, m, self_offset);
      if (p.same && pos_pred(ap, v, pt)) {
        is = __fadd_rn(is, expf(__fsub_rn(v, mx)));
        ++ic;
      } else if (p.diff && neg_pred(an, v, nt)) {
        ds = __fadd_rn(ds, expf(__fsub_rn(v, mx)));
        ++dc;
      }
    }
    __syncthreads();
  }
  is = row_fsum(is);
  ds = row_fsum(ds);
  ic = row_sum(ic);
  dc = row_sum(dc);
  if (j == 0 && live) {
    isum[q] = is;
    dsum[q] = ds;
    inum[q] = static_cast<float>(ic);
    dnum[q] = static_cast<float>(dc);
  }
}

// ------------------------------------------------------- gq and gdb

// Per-query terms of the weight tile (_weight_tile, cu:405-446).
struct QueryTerms {
  float pt, nt, mx, a, b;
};

__device__ __forceinline__ float inv0(float den) {
  return den != 0.f ? __fdiv_rn(1.f, den) : 0.f;
}

__device__ __forceinline__ QueryTerms query_terms(
    int q, float margin_ident, float margin_diff, const float* pos_thr,
    const float* neg_thr, const float* max_all, const float* isum,
    const float* asum, const float* valid, float scale_g) {
  const float scale = __fmul_rn(scale_g, valid[q]);
  const float ia = inv0(asum[q]);
  return {__fadd_rn(pos_thr[q], margin_ident),
          __fadd_rn(neg_thr[q], margin_diff), max_all[q],
          __fmul_rn(__fadd_rn(-inv0(isum[q]), ia), scale),
          __fmul_rn(ia, scale)};
}

// w = (-p1 + p2 + p3) * valid * g / N for one pair: a_q on a selected
// positive, b_q on a selected negative, 0 elsewhere — by selection, never
// by a multiplied mask.
__device__ __forceinline__ float pair_weight(float v, Pair p, int ap, int an,
                                             const QueryTerms& qt) {
  const bool sp = p.same && pos_pred(ap, v, qt.pt);
  const bool sn = p.diff && neg_pred(an, v, qt.nt);
  if (!(sp || sn)) return 0.f;
  return __fmul_rn(expf(__fsub_rn(v, qt.mx)), sp ? qt.a : qt.b);
}

// kPoolMajor = false: gq = w @ pool, a block owns 64 queries and loops
// over pool tiles.  kPoolMajor = true: gdb = w^T @ feats, a block owns 64
// pool rows and loops over query tiles.  Each output element is one
// __fmaf_rn chain over the other axis in increasing order, read from and
// written back to the block's own output rows between tiles.
template <bool kCached, bool kPoolMajor, typename L>
__global__ void __launch_bounds__(kThreads) npair_grad_kernel(
    const float* __restrict__ feats, const L* __restrict__ labels,
    const float* __restrict__ pool, const L* __restrict__ pool_labels,
    const float* __restrict__ sims, int n, int m, int d, int self_offset,
    int ap, int an, float margin_ident, float margin_diff,
    const float* __restrict__ pos_thr, const float* __restrict__ neg_thr,
    const float* __restrict__ max_all, const float* __restrict__ isum,
    const float* __restrict__ asum, const float* __restrict__ valid,
    const float* __restrict__ g, float* __restrict__ out) {
  __shared__ TileSmem sm;
  __shared__ QueryTerms qt[kT];
  __shared__ L qlab[kT], plab[kT];
  const int t = threadIdx.x, r = t / kRowThreads, j = t % kRowThreads;
  const int ty = t / 16, tx = t % 16;
  const int own0 = blockIdx.x * kT;
  const int own_rows = kPoolMajor ? m : n;
  const int other_rows = kPoolMajor ? n : m;
  const float* xop = kPoolMajor ? feats : pool;  // the product's operand
  // dot_normalizer = the query count in the backward (cu:427).
  const float scale_g = __fdiv_rn(g[0], static_cast<float>(n));

  for (int x0 = 0; x0 < other_rows; x0 += kT) {
    const int q0 = kPoolMajor ? x0 : own0, i0 = kPoolMajor ? own0 : x0;
    if (t < kT) {
      const int q = q0 + t, i = i0 + t;
      plab[t] = i < m ? pool_labels[i] : L(0);
      qlab[t] = q < n ? labels[q] : L(0);
      if (q < n)
        qt[t] = query_terms(q, margin_ident, margin_diff, pos_thr, neg_thr,
                            max_all, isum, asum, valid, scale_g);
    }
    produce_tile<kCached, kPoolMajor>(feats, pool, sims, nullptr, n, m, d,
                                      q0, i0, sm);
    // The weight tile, in place of the sims.
    for (int u = 0; u < kCols; ++u) {
      const int c = j * kCols + u;
      const int ql = kPoolMajor ? c : r, pl = kPoolMajor ? r : c;
      const Pair p = pair_of(q0 + ql, i0 + pl, qlab[ql], plab[pl], n, m,
                             self_offset);
      sm.s[r][c] = (p.same || p.diff)
                       ? pair_weight(sm.s[r][c], p, ap, an, qt[ql])
                       : 0.f;
    }
    __syncthreads();
    // out[own rows] += W @ X[x0 .. x0+64), 64 columns of D at a time.
    for (int d0 = 0; d0 < d; d0 += kT) {
#pragma unroll
      for (int e = 0; e < kT * kT / kThreads; ++e) {
        const int idx = t + e * kThreads, row = idx / kT, col = idx % kT;
        sm.u.x[row][col] =
            (x0 + row < other_rows && d0 + col < d)
                ? xop[static_cast<long long>(x0 + row) * d + d0 + col]
                : 0.f;
      }
      __syncthreads();
      // A 4 x 4 register tile per thread, as in sim_tile; each element
      // is still one fmaf chain over c in increasing order.
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int row = own0 + ty + 16 * a, col = d0 + tx + 16 * b;
          acc[a][b] = (x0 > 0 && row < own_rows && col < d)
                          ? out[static_cast<long long>(row) * d + col]
                          : 0.f;
        }
#pragma unroll 8
      for (int c = 0; c < kT; ++c) {
        float wv[4], xv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) wv[a] = sm.s[ty + 16 * a][c];
#pragma unroll
        for (int b = 0; b < 4; ++b) xv[b] = sm.u.x[c][tx + 16 * b];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            acc[a][b] = __fmaf_rn(wv[a], xv[b], acc[a][b]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int row = own0 + ty + 16 * a, col = d0 + tx + 16 * b;
          if (row < own_rows && col < d)
            out[static_cast<long long>(row) * d + col] = acc[a][b];
        }
      __syncthreads();
    }
  }
}

// ------------------------------------------------------- launchers

inline unsigned tiles(int rows) {
  return static_cast<unsigned>((rows + kT - 1) / kT);
}

inline bool bad_dims(int n, int m, int d) { return n < 1 || m < 1 || d < 1; }

template <typename L>
int launch_stats(const float* feats, const void* labels, const float* pool,
                 const void* pool_labels, int n, int m, int d,
                 int self_offset, float* min_w, float* max_b, float* max_a,
                 int* cnt_s, int* cnt_d, int* hist_s, int* hist_d,
                 float* topk, int k, float* sims_out, cudaStream_t s) {
  const size_t dyn = static_cast<size_t>(k) * kThreads * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      npair_stats_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dyn));
  if (err != cudaSuccess) return static_cast<int>(err);
  npair_stats_kernel<L><<<tiles(n), kThreads, dyn, s>>>(
      feats, static_cast<const L*>(labels), pool,
      static_cast<const L*>(pool_labels), n, m, d, self_offset, min_w, max_b,
      max_a, cnt_s, cnt_d, hist_s, hist_d, topk, k, sims_out);
  return static_cast<int>(cudaGetLastError());
}

template <typename L>
int launch_hist(const float* feats, const void* labels, const float* pool,
                const void* pool_labels, const float* sims, int n, int m,
                int d, int self_offset, int sides, int same0, int same1,
                const unsigned* prefix0, const unsigned* prefix1, int digit,
                const unsigned char* skip, int* out0, int* out1,
                cudaStream_t s) {
  const L* lq = static_cast<const L*>(labels);
  const L* lp = static_cast<const L*>(pool_labels);
  if (sims != nullptr)
    npair_hist_kernel<true, L><<<tiles(n), kThreads, 0, s>>>(
        feats, lq, pool, lp, sims, n, m, d, self_offset, sides, same0, same1,
        prefix0, prefix1, digit, skip, out0, out1);
  else
    npair_hist_kernel<false, L><<<tiles(n), kThreads, 0, s>>>(
        feats, lq, pool, lp, sims, n, m, d, self_offset, sides, same0, same1,
        prefix0, prefix1, digit, skip, out0, out1);
  return static_cast<int>(cudaGetLastError());
}

template <typename L>
int launch_loss(const float* feats, const void* labels, const float* pool,
                const void* pool_labels, const float* sims, int n, int m,
                int d, int self_offset, int ap, int an, float mi, float md,
                const float* pos_thr, const float* neg_thr,
                const float* max_all, float* isum, float* dsum, float* inum,
                float* dnum, cudaStream_t s) {
  const L* lq = static_cast<const L*>(labels);
  const L* lp = static_cast<const L*>(pool_labels);
  if (sims != nullptr)
    npair_loss_kernel<true, L><<<tiles(n), kThreads, 0, s>>>(
        feats, lq, pool, lp, sims, n, m, d, self_offset, ap, an, mi, md,
        pos_thr, neg_thr, max_all, isum, dsum, inum, dnum);
  else
    npair_loss_kernel<false, L><<<tiles(n), kThreads, 0, s>>>(
        feats, lq, pool, lp, sims, n, m, d, self_offset, ap, an, mi, md,
        pos_thr, neg_thr, max_all, isum, dsum, inum, dnum);
  return static_cast<int>(cudaGetLastError());
}

template <bool kPoolMajor, typename L>
int launch_grad(const float* feats, const void* labels, const float* pool,
                const void* pool_labels, const float* sims, int n, int m,
                int d, int self_offset, int ap, int an, float mi, float md,
                const float* pos_thr, const float* neg_thr,
                const float* max_all, const float* isum, const float* asum,
                const float* valid, const float* g, float* out,
                cudaStream_t s) {
  const L* lq = static_cast<const L*>(labels);
  const L* lp = static_cast<const L*>(pool_labels);
  const unsigned grid = tiles(kPoolMajor ? m : n);
  if (sims != nullptr)
    npair_grad_kernel<true, kPoolMajor, L><<<grid, kThreads, 0, s>>>(
        feats, lq, pool, lp, sims, n, m, d, self_offset, ap, an, mi, md,
        pos_thr, neg_thr, max_all, isum, asum, valid, g, out);
  else
    npair_grad_kernel<false, kPoolMajor, L><<<grid, kThreads, 0, s>>>(
        feats, lq, pool, lp, sims, n, m, d, self_offset, ap, an, mi, md,
        pos_thr, neg_thr, max_all, isum, asum, valid, g, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ------------------------------------------------------- C interface
//
// Every pointer is device memory; labels are int32 (label_f32 = 0) or
// float32 (1); a null `sims` selects the recompute variant, a non-null
// one the cached variant.  Entries return cudaGetLastError() of their
// launch.

extern "C" {

int npl_npair_stats(const void* feats, const void* labels, const void* pool,
                    const void* pool_labels, int n, int m, int d,
                    int self_offset, int label_f32, void* min_w, void* max_b,
                    void* max_a, void* cnt_s, void* cnt_d, void* hist_s,
                    void* hist_d, void* topk, int k, void* sims_out,
                    void* stream) {
  if (bad_dims(n, m, d) || k < 0 || k > kMaxTopK || (k > 0) != (topk != nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto fo = [](void* p) { return static_cast<float*>(p); };
  auto io = [](void* p) { return static_cast<int*>(p); };
  if (label_f32)
    return launch_stats<float>(f(feats), labels, f(pool), pool_labels, n, m,
                               d, self_offset, fo(min_w), fo(max_b),
                               fo(max_a), io(cnt_s), io(cnt_d), io(hist_s),
                               io(hist_d), fo(topk), k, fo(sims_out), s);
  return launch_stats<int>(f(feats), labels, f(pool), pool_labels, n, m, d,
                           self_offset, fo(min_w), fo(max_b), fo(max_a),
                           io(cnt_s), io(cnt_d), io(hist_s), io(hist_d),
                           fo(topk), k, fo(sims_out), s);
}

int npl_npair_hist(const void* feats, const void* labels, const void* pool,
                   const void* pool_labels, const void* sims, int n, int m,
                   int d, int self_offset, int label_f32, int sides,
                   int same0, int same1, const void* prefix0,
                   const void* prefix1, int digit, const void* skip,
                   void* out0, void* out1, void* stream) {
  if (bad_dims(n, m, d) || sides < 1 || sides > 2 || digit < 1 || digit > 7)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(feats);
  const float* p = static_cast<const float*>(pool);
  const float* c = static_cast<const float*>(sims);
  const unsigned* p0 = static_cast<const unsigned*>(prefix0);
  const unsigned* p1 = static_cast<const unsigned*>(prefix1);
  const unsigned char* sk = static_cast<const unsigned char*>(skip);
  int* o0 = static_cast<int*>(out0);
  int* o1 = static_cast<int*>(out1);
  if (label_f32)
    return launch_hist<float>(f, labels, p, pool_labels, c, n, m, d,
                              self_offset, sides, same0, same1, p0, p1, digit,
                              sk, o0, o1, s);
  return launch_hist<int>(f, labels, p, pool_labels, c, n, m, d, self_offset,
                          sides, same0, same1, p0, p1, digit, sk, o0, o1, s);
}

int npl_npair_loss(const void* feats, const void* labels, const void* pool,
                   const void* pool_labels, const void* sims, int n, int m,
                   int d, int self_offset, int label_f32, int ap, int an,
                   float margin_ident, float margin_diff, const void* pos_thr,
                   const void* neg_thr, const void* max_all, void* isum,
                   void* dsum, void* inum, void* dnum, void* stream) {
  if (bad_dims(n, m, d)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto fo = [](void* p) { return static_cast<float*>(p); };
  if (label_f32)
    return launch_loss<float>(f(feats), labels, f(pool), pool_labels, f(sims),
                              n, m, d, self_offset, ap, an, margin_ident,
                              margin_diff, f(pos_thr), f(neg_thr), f(max_all),
                              fo(isum), fo(dsum), fo(inum), fo(dnum), s);
  return launch_loss<int>(f(feats), labels, f(pool), pool_labels, f(sims), n,
                          m, d, self_offset, ap, an, margin_ident, margin_diff,
                          f(pos_thr), f(neg_thr), f(max_all), fo(isum),
                          fo(dsum), fo(inum), fo(dnum), s);
}

// pool_major = 0: gq [n, d] = w @ pool; 1: gdb [m, d] = w^T @ feats.
int npl_npair_grad(const void* feats, const void* labels, const void* pool,
                   const void* pool_labels, const void* sims, int n, int m,
                   int d, int self_offset, int label_f32, int ap, int an,
                   float margin_ident, float margin_diff, const void* pos_thr,
                   const void* neg_thr, const void* max_all, const void* isum,
                   const void* asum, const void* valid, const void* g,
                   int pool_major, void* out, void* stream) {
  if (bad_dims(n, m, d)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* o = static_cast<float*>(out);
#define NPL_GRAD(PM, LT)                                                     \
  return launch_grad<PM, LT>(f(feats), labels, f(pool), pool_labels,         \
                             f(sims), n, m, d, self_offset, ap, an,          \
                             margin_ident, margin_diff, f(pos_thr),          \
                             f(neg_thr), f(max_all), f(isum), f(asum),       \
                             f(valid), f(g), o, s)
  if (pool_major) {
    if (label_f32) NPL_GRAD(true, float);
    NPL_GRAD(true, int);
  }
  if (label_f32) NPL_GRAD(false, float);
  NPL_GRAD(false, int);
#undef NPL_GRAD
}

}  // extern "C"
