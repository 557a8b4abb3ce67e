// GoogLeNet stem kernels for Hopper (sm_90a): across-channel LRN forward
// (plain and with the denominator cache) and backward (from the cache or
// recomputing it), conv epilogue bias + ReLU, and bias + ReLU + SAME
// max-pool.
//
// Replaces (npairloss_tpu/ops/pallas_stem.py):
//   lrn_fwd        <- _lrn_fwd_kernel (:121), launched by _lrn_fwd_call (:172)
//   lrn_fwd_cached <- _lrn_fwd_cached_kernel (:128), _lrn_fwd_call (:172)
//   lrn_bwd        <- _lrn_bwd_kernel (:136), _lrn_bwd_call (:202)
//   lrn_bwd_cached <- _lrn_bwd_cached_kernel (:151), _lrn_bwd_call (:202)
//   bias_relu      <- _bias_relu_kernel (:308), launched by _fused_bias_relu (:318)
//   bias_relu_pool <- _bias_relu_pool_kernel (:383), launched by
//                     _fused_bias_relu_pool (:417)
//
// Bound on an H100 (3.35 TB/s HBM, 67 TFLOP/s fp32 outside the tensor
// cores): all are memory-bound by a wide margin — a few tens of flops
// per element at most against 4 (fp32) or 2 (bf16) bytes each way.
//   lrn_fwd:        2 * rows * C * sizeof(T) bytes
//   lrn_fwd_cached: rows * C * (2 * sizeof(T) + 4) bytes
//   lrn_bwd:        3 * rows * C * sizeof(T) bytes
//   lrn_bwd_cached: rows * C * (3 * sizeof(T) + 4) bytes
//   bias_relu:      2 * n * sizeof(T) + 4 * C bytes
//   bias_relu_pool: (N*H*W*C + N*Ho*Wo*C) * sizeof(T) + 4 * C bytes
//
// Design.  Math is fp32 whatever the storage type; results are rounded
// once, to the input's type, on the store — the Pallas kernels' rule.
//   * LRN forward (lrn_fwd_vec_kernel): a persistent grid, about the SM
//     count times the resident blocks per SM, strides over tiles of NHWC
//     rows.  Each thread owns one 16-byte vector of channels of one row
//     of a tile and reads x once with 16-byte loads; the next tile's load
//     is issued before the current tile's math.  x goes to shared memory
//     in rows padded with zeros (double-buffered: one barrier a tile), so
//     each channel's window of x^2 is read as aligned float4s into
//     registers and summed by lrn_denominator_staged with no bounds check;
//     out (and the cached d) leave by 16-byte stores.  The sum runs in the
//     Pallas _win_sum's order (lo = size/2, hi = size-1-size/2, zero fill);
//     d^-beta is (sqrt(rsqrt(d)))^3 for beta = 0.75 and exp(-beta*log d)
//     otherwise, as the reference computes it.  Another window than 5, C
//     not a multiple of the vector, or operands off 16-byte alignment take
//     the scalar path (lrn_fwd_kernel: one tile per block staged in shared
//     memory, element by element), which does the same operations in the
//     same order: both paths give the same bits, and the cached d is the
//     backward's recomputed d bit for bit.
//   * LRN backward (lrn_bwd_vec_kernel): a persistent grid, about the SM
//     count times the resident blocks per SM, strides over tiles of rows.
//     Each thread owns one 16-byte vector of channels (4 fp32 or 8 bf16)
//     of one row and reads x, g and the cached d once each with 16-byte
//     loads; the next tile's loads are issued before the current tile's
//     math, so they are in flight while it runs.  f = d^-beta, f / d and
//     u = g x f / d are computed once per element in registers; u goes to
//     shared memory in rows padded with zeros, so the transposed window
//     reads three or four aligned float4s and needs no bounds check; dx
//     leaves with 16-byte stores.  One barrier per tile (u is double-
//     buffered); the recompute variant also stages x, padded the same
//     way, and sums each channel's window of x^2 from registers in
//     lrn_denominator's order (a second barrier).  Operands that are not
//     16-byte aligned, C not a multiple of the vector, or another window
//     than 5 take the kernel's scalar path (lrn_bwd_kernel: one tile per
//     block, element by element).  Both paths do the same operations in
//     the same order, so the cached and recompute variants and both paths
//     give the same bits.
//   * bias + ReLU (bias_relu_vec_kernel): a persistent grid of one wave
//     (the resident blocks on the card, fewer for a small call).  x is
//     read as 16-byte vectors with non-allocating loads, out written with
//     streaming stores: neither is read again.  The lanes are a multiple
//     of C / V (V = 4 fp32 or 8 bf16), so the vectors a lane visits all
//     hold the same V channels: its V bias values are read once, into
//     registers, and the loop has no index division.  Each lane loads
//     kBiasReluUnroll vectors before it stores any.  C not a multiple of
//     the vector, operands off 16-byte alignment, or a grid with fewer
//     lanes than C / V take the scalar path (bias_relu_kernel: one
//     element a lane, its channel carried forward by an add and a compare).
//     Both compute relu(x + b) with one fp32 add, a max that keeps NaN
//     and one rounding on the store: the plain version's bits.
//   * bias + ReLU + pool: one wave of resident blocks; each block takes a
//     run of consecutive output rows of the batch and a chunk of output
//     columns.  On the stem's 3 x 3 / s2 window with 16-byte vectors
//     (bias_relu_pool3s2_kernel) each thread owns two adjacent output
//     columns of one channel vector and walks down the run: per input row
//     it issues the five column loads the two windows share, predicated,
//     the next output row's before the current row's math; it applies
//     bias and ReLU in registers (the pre-pool activation never reaches
//     device memory), takes each column's horizontal 3-tap max, then the
//     vertical max in registers.  The last input row of output row oh is
//     the first of oh + 1: its maxima are kept, not reloaded.  Other
//     windows, C not a multiple of the vector, or unaligned operands take
//     the general kernel (any window and stride, one channel of one
//     output column a thread, scalar accesses).  Index math is
//     32-bit, once per thread.  SAME padding is asymmetric (pad_lo =
//     total/2); padded taps count as zero, which equals the -inf fill of
//     the reference after the ReLU because a SAME window always holds one
//     real tap and every real tap is >= 0 or NaN.
//   * Every max keeps NaN, as jnp.maximum and torch.maximum do (fmaxf
//     would drop it).

#include <float.h>
#include <limits.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>

#include "common.cuh"

// The larger of a and b, or NaN where either is NaN.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// ------------------------------------------------- 16-byte vectors
//
// A vector is 16 bytes of T: 4 fp32 or 8 bf16 elements.  Held raw (uint4)
// while in flight, as fp32 for the math.

template <typename T>
struct Vec {
  static constexpr int kN = 16 / sizeof(T);
};

__device__ __forceinline__ uint4 ld_raw(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void unpack(uint4 q, float* v, float) {
  v[0] = __uint_as_float(q.x);
  v[1] = __uint_as_float(q.y);
  v[2] = __uint_as_float(q.z);
  v[3] = __uint_as_float(q.w);
}

__device__ __forceinline__ void unpack(uint4 q, float* v, __nv_bfloat16) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // little-endian: the lower half first
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack(const float* v, float) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}

__device__ __forceinline__ uint4 pack(const float* v, __nv_bfloat16) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// n consecutive fp32 values (n a multiple of 4, p 16-byte aligned).
template <int N>
__device__ __forceinline__ void ld_f32(const float* p, float* v) {
#pragma unroll
  for (int i = 0; i < N; i += 4) unpack(ld_raw(p + i), v + i, 0.f);
}

template <int N>
__device__ __forceinline__ void st_f32(float* p, const float* v) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<uint4*>(p + i) = pack(v + i, 0.f);
}

// One 16-byte vector of T (p aligned) from its fp32 values.
template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float* v) {
  *reinterpret_cast<uint4*>(p) = pack(v, T());
}

// ---------------------------------------------------------------- LRN

// d = k + a * sum_{o=-lo..hi} row[ch+o]^2 (zero fill), lowest offset
// first.  The definition of the denominator: the forward kernels and the
// scalar recomputing backward call it, and lrn_denominator_staged repeats
// its operations for the vector backward, so the cached and the
// recomputed d are the same bits.
__device__ __forceinline__ float lrn_denominator(const float* row, int ch,
                                                 int c, int lo, int hi,
                                                 float a, float k) {
  float win = 0.f;
  for (int o = -lo; o <= hi; ++o) {
    const int cc = ch + o;
    const float v = (cc >= 0 && cc < c) ? row[cc] : 0.f;
    win += __fmul_rn(v, v);  // no FMA contraction: square, then add
  }
  return __fadd_rn(k, __fmul_rn(a, win));
}

// lrn_denominator over a window staged in registers: w[o] for o = -LO..HI,
// zeros in place of the channels outside the row — the same operations in
// the same order, so the same bits (the vector backward's recompute).
template <int LO, int HI>
__device__ __forceinline__ float lrn_denominator_staged(const float* w,
                                                       float a, float k) {
  float win = 0.f;
#pragma unroll
  for (int o = -LO; o <= HI; ++o) win += __fmul_rn(w[o], w[o]);
  return __fadd_rn(k, __fmul_rn(a, win));
}

__device__ __forceinline__ float lrn_pow_neg_beta(float d, float beta) {
  if (beta == 0.75f) {
    const float r = sqrtf(rsqrtf(d));
    return r * r * r;
  }
  return expf(-beta * logf(d));
}

// kCached: also store the fp32 denominator d (the training residual).
// The scalar path, for any window, alignment and C: one tile of rows per
// block, element by element; lrn_fwd_vec_kernel below is the path of
// aligned vectors.
template <typename T, bool kCached>
__global__ void lrn_fwd_kernel(const T* __restrict__ x, T* __restrict__ out,
                               float* __restrict__ dout, long long rows,
                               int c, int tile_rows, int lo, int hi, float a,
                               float beta, float k) {
  extern __shared__ float xs[];
  const long long r0 = static_cast<long long>(blockIdx.x) * tile_rows;
  const long long left = rows - r0;
  const int nr = static_cast<int>(left < tile_rows ? left : tile_rows);
  const int n = nr * c;
  const T* xb = x + r0 * c;
  T* ob = out + r0 * c;
  for (int i = threadIdx.x; i < n; i += blockDim.x) xs[i] = npl_to_float(xb[i]);
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int ch = i % c;
    const float d = lrn_denominator(xs + (i - ch), ch, c, lo, hi, a, k);
    if (kCached) dout[r0 * c + i] = d;
    ob[i] = npl_from_float<T>(xs[i] * lrn_pow_neg_beta(d, beta));
  }
}

// The vector path's window and the zeros staged on each side of a row:
// at least the half window, and a multiple of 4 so the staged vectors
// stay 16-byte aligned.
constexpr int kLrnVecSize = 5;
constexpr int kLrnPad = 4;
// The same out (and d) as lrn_fwd_kernel, for a window of kLrnVecSize and
// C a multiple of the vector width (at most kThreads vectors a row), every
// operand 16-byte aligned.  A tile is tile_rows = kThreads / (C / V) rows;
// thread (r, ch0) owns channels ch0..ch0+V-1 of tile row r.  x is staged
// in zero-padded rows, double-buffered (one barrier a tile), and each
// channel's window of x^2 is summed from registers by
// lrn_denominator_staged, lrn_denominator's operations in its order: the
// scalar path's bits.
template <typename T, bool kCached>
__global__ void __launch_bounds__(256)
lrn_fwd_vec_kernel(const T* __restrict__ x, T* __restrict__ out,
                   float* __restrict__ dout, long long rows, int c,
                   int tile_rows, long long ntiles, float a, float beta,
                   float k) {
  constexpr int V = Vec<T>::kN;
  constexpr int LO = kLrnVecSize / 2, HI = kLrnVecSize - 1 - kLrnVecSize / 2;
  constexpr int P = kLrnPad;
  extern __shared__ float4 lrn_smem4[];
  float* const smem = reinterpret_cast<float*>(lrn_smem4);
  const int sc = c + 2 * P;  // a staged row: P zeros, C values, P zeros
  const int tile_s = tile_rows * sc;
  const int vpr = c / V;
  const int r = threadIdx.x / vpr;
  const int ch0 = (threadIdx.x - r * vpr) * V;
  const bool active = r < tile_rows;
  // Zero every staged row's pads once; nothing writes them later.
  for (int i = threadIdx.x; i < 2 * tile_rows; i += blockDim.x) {
    float* const row = smem + i * sc;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      row[j] = 0.f;
      row[P + c + j] = 0.f;
    }
  }
  __syncthreads();

  // The next tile's x (16 bytes), in flight.
  uint4 nx = make_uint4(0, 0, 0, 0);
  long long tile = blockIdx.x;
  {
    const long long row = tile * tile_rows + r;
    if (active && row < rows) nx = ld_raw(x + row * c + ch0);
  }
  int buf = 0;
  for (; tile < ntiles; tile += gridDim.x, buf ^= 1) {
    const long long row = tile * tile_rows + r;
    const bool valid = active && row < rows;
    float xv[V];
    unpack(nx, xv, T());
    {  // issue the next tile's load before this tile's math
      const long long nrow = (tile + gridDim.x) * tile_rows + r;
      if (active && tile + gridDim.x < ntiles && nrow < rows)
        nx = ld_raw(x + nrow * c + ch0);
    }
    float* const xrow = smem + buf * tile_s + r * sc;
    if (valid) st_f32<V>(xrow + P + ch0, xv);
    __syncthreads();
    if (valid) {
      float xw[V + 2 * P];  // x of channels ch0-P .. ch0+V+P-1, zeros outside
      ld_f32<V + 2 * P>(xrow + ch0, xw);
      float dv[V], o[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        dv[j] = lrn_denominator_staged<LO, HI>(xw + P + j, a, k);
        o[j] = xv[j] * lrn_pow_neg_beta(dv[j], beta);
      }
      store_vec(out + row * c + ch0, o);
      if (kCached) st_f32<V>(dout + row * c + ch0, dv);
    }
  }
}

// dx = g f - c2 x W^T(g x f / d), f = d^-beta, W^T the window with lo and
// hi swapped (pallas_stem.py:157-162); every product and the difference
// rounded on its own (no FMA), as the plain version computes them.
// kCached reads d; otherwise d is recomputed from the staged x row by
// lrn_denominator, the forward's own function.  This is the scalar path,
// for any window, alignment and C: one tile of rows per block, element
// by element; lrn_bwd_vec_kernel below is the path of aligned vectors.
template <typename T, bool kCached>
__global__ void lrn_bwd_kernel(const T* __restrict__ x,
                               const T* __restrict__ g,
                               const float* __restrict__ dcache,
                               T* __restrict__ dx, long long rows, int c,
                               int tile_rows, int lo, int hi, float a,
                               float beta, float k, float c2) {
  extern __shared__ float smem[];
  const long long r0 = static_cast<long long>(blockIdx.x) * tile_rows;
  const long long left = rows - r0;
  const int nr = static_cast<int>(left < tile_rows ? left : tile_rows);
  const int n = nr * c;
  float* xs = smem;                    // x of the tile
  float* us = smem + tile_rows * c;    // g x f / d of the tile
  const long long off = r0 * c;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    xs[i] = npl_to_float(x[off + i]);
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int ch = i % c;
    const float d = kCached ? dcache[off + i]
                            : lrn_denominator(xs + (i - ch), ch, c, lo, hi,
                                              a, k);
    const float f = lrn_pow_neg_beta(d, beta);
    const float gv = npl_to_float(g[off + i]);
    us[i] = __fmul_rn(__fmul_rn(gv, xs[i]), __fdiv_rn(f, d));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int ch = i % c;
    const float* urow = us + (i - ch);
    float t = 0.f;
    for (int o = -hi; o <= lo; ++o) {  // the transposed window
      const int cc = ch + o;
      t = __fadd_rn(t, (cc >= 0 && cc < c) ? urow[cc] : 0.f);
    }
    const float d = kCached ? dcache[off + i]
                            : lrn_denominator(xs + (i - ch), ch, c, lo, hi,
                                              a, k);
    const float f = lrn_pow_neg_beta(d, beta);
    const float gv = npl_to_float(g[off + i]);
    dx[off + i] = npl_from_float<T>(
        __fsub_rn(__fmul_rn(gv, f), __fmul_rn(__fmul_rn(c2, xs[i]), t)));
  }
}

// The same dx as lrn_bwd_kernel, for a window of kLrnVecSize and C a
// multiple of the vector width (at most kThreads vectors a row), every
// operand 16-byte aligned.  A tile is tile_rows = kThreads / (C / V)
// rows; thread (r, ch0) owns channels ch0..ch0+V-1 of tile row r.
template <typename T, bool kCached>
__global__ void __launch_bounds__(256)
lrn_bwd_vec_kernel(const T* __restrict__ x, const T* __restrict__ g,
                   const float* __restrict__ dcache, T* __restrict__ dx,
                   long long rows, int c, int tile_rows, long long ntiles,
                   float a, float beta, float k, float c2) {
  constexpr int V = Vec<T>::kN;
  constexpr int LO = kLrnVecSize / 2, HI = kLrnVecSize - 1 - kLrnVecSize / 2;
  constexpr int P = kLrnPad;
  constexpr int NBUF = kCached ? 2 : 3;  // u twice (alternate tiles), x
  extern __shared__ float4 lrn_smem4[];
  float* const smem = reinterpret_cast<float*>(lrn_smem4);
  const int sc = c + 2 * P;  // a staged row: P zeros, C values, P zeros
  const int tile_s = tile_rows * sc;
  float* const xs = smem + 2 * tile_s;  // recompute: the tile's x
  const int vpr = c / V;
  const int r = threadIdx.x / vpr;
  const int ch0 = (threadIdx.x - r * vpr) * V;
  const bool active = r < tile_rows;
  // Zero every staged row's pads once; nothing writes them later.
  for (int i = threadIdx.x; i < NBUF * tile_rows; i += blockDim.x) {
    float* const row = smem + i * sc;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      row[j] = 0.f;
      row[P + c + j] = 0.f;
    }
  }
  __syncthreads();

  // The next tile's x, g (16 bytes each) and d (V floats), in flight.
  uint4 nx = make_uint4(0, 0, 0, 0), ng = nx, nd[V / 4];
#pragma unroll
  for (int i = 0; i < V / 4; ++i) nd[i] = nx;
  long long tile = blockIdx.x;
  {
    const long long row = tile * tile_rows + r;
    if (active && row < rows) {
      const long long off = row * c + ch0;
      nx = ld_raw(x + off);
      ng = ld_raw(g + off);
      if (kCached) {
#pragma unroll
        for (int i = 0; i < V / 4; ++i) nd[i] = ld_raw(dcache + off + 4 * i);
      }
    }
  }
  int buf = 0;
  for (; tile < ntiles; tile += gridDim.x, buf ^= 1) {
    const long long row = tile * tile_rows + r;
    const bool valid = active && row < rows;
    float xv[V], gv[V], dv[V];
    unpack(nx, xv, T());
    unpack(ng, gv, T());
    if (kCached) {
#pragma unroll
      for (int i = 0; i < V / 4; ++i) unpack(nd[i], dv + 4 * i, 0.f);
    }
    {  // issue the next tile's loads before this tile's math
      const long long nrow = (tile + gridDim.x) * tile_rows + r;
      if (active && tile + gridDim.x < ntiles && nrow < rows) {
        const long long off = nrow * c + ch0;
        nx = ld_raw(x + off);
        ng = ld_raw(g + off);
        if (kCached) {
#pragma unroll
          for (int i = 0; i < V / 4; ++i)
            nd[i] = ld_raw(dcache + off + 4 * i);
        }
      }
    }
    float* const urow = smem + buf * tile_s + r * sc + P;
    if (!kCached) {
      if (valid) st_f32<V>(xs + r * sc + P + ch0, xv);
      __syncthreads();
    }
    float f[V];
    if (valid) {
      float u[V];
      if (!kCached) {  // x of channels ch0-P .. ch0+V+P-1, zeros outside
        float xw[V + 2 * P];
        ld_f32<V + 2 * P>(xs + r * sc + ch0, xw);
#pragma unroll
        for (int j = 0; j < V; ++j)
          dv[j] = lrn_denominator_staged<LO, HI>(xw + P + j, a, k);
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = dv[j];
        f[j] = lrn_pow_neg_beta(d, beta);
        u[j] = __fmul_rn(__fmul_rn(gv[j], xv[j]), __fdiv_rn(f[j], d));
      }
      st_f32<V>(urow + ch0, u);
    }
    __syncthreads();
    if (valid) {
      float wv[V + 2 * P];  // u of channels ch0-P .. ch0+V+P-1
      ld_f32<V + 2 * P>(urow + ch0 - P, wv);
      float o[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float t = 0.f;
#pragma unroll
        for (int oo = -HI; oo <= LO; ++oo)  // the transposed window
          t = __fadd_rn(t, wv[P + j + oo]);
        o[j] = __fsub_rn(__fmul_rn(gv[j], f[j]),
                         __fmul_rn(__fmul_rn(c2, xv[j]), t));
      }
      store_vec(dx + row * c + ch0, o);
    }
  }
}

// ------------------------------------------------------ bias + ReLU

// 16 bytes through the non-coherent path, not allocated in L1, and a
// streaming (evict-first) store: bias + ReLU touches each byte once.
__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ void st_stream(void* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// relu(x + b) on one vector of T: fp32 add, a max that keeps NaN, one
// rounding to T.
template <typename T>
__device__ __forceinline__ uint4 bias_relu_vec(uint4 q, const float* b) {
  constexpr int V = Vec<T>::kN;
  float v[V];
  unpack(q, v, T());
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = nan_max(__fadd_rn(v[j], b[j]), 0.f);
  return pack(v, T());
}

// The vector path.  Lane l of `lanes` (a multiple of cv = C / V) owns the
// vectors l, l + lanes, l + 2 lanes, ... of x: all hold channels
// (l % cv) * V .. + V - 1.
template <typename T, int kU>
__global__ void __launch_bounds__(256)
bias_relu_vec_kernel(const T* __restrict__ x, const float* __restrict__ bias,
                     T* __restrict__ out, long long nvec, int cv,
                     long long lanes) {
  constexpr int V = Vec<T>::kN;
  const long long lane =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const int ch0 = static_cast<int>(lane % cv) * V;
  float b[V];
#pragma unroll
  for (int j = 0; j < V; ++j) b[j] = __ldg(bias + ch0 + j);
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* ov = reinterpret_cast<uint4*>(out);
  for (long long v = lane; v < nvec; v += kU * lanes) {
    uint4 q[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const long long i = v + u * lanes;
      q[u] = i < nvec ? ld_stream(xv + i) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const long long i = v + u * lanes;
      if (i < nvec) st_stream(ov + i, bias_relu_vec<T>(q[u], b));
    }
  }
}

// The scalar path (any C and alignment): lane l of `lanes` owns the
// elements l, l + lanes, ...; its channel advances by step = lanes % c
// from one to the next.
template <typename T>
__global__ void __launch_bounds__(256)
bias_relu_kernel(const T* __restrict__ x, const float* __restrict__ bias,
                 T* __restrict__ out, long long n, int c, long long lanes,
                 int step) {
  const long long lane =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  int ch = static_cast<int>(lane % c);
  for (long long i = lane; i < n; i += lanes) {
    const float y = __fadd_rn(npl_to_float(x[i]), __ldg(bias + ch));
    out[i] = npl_from_float<T>(nan_max(y, 0.f));
    ch += step;
    if (ch >= c) ch -= c;
  }
}

// --------------------------------------------- bias + ReLU + max-pool

// Both pool kernels: block -> (run of `run` consecutive output rows of the
// batch, image after image, and chunk of blockDim.x column items), one
// wave of resident blocks over the whole batch.  Each thread walks its
// run down the rows; where the window is one row taller than the stride,
// the last input row of output row oh is the first of oh + 1, and its
// maxima are kept, not reloaded (anew at the run's start and at each new
// image).

// The general path (any window and stride, any C and alignment): one
// channel of one output column a thread; per input row, the max over its
// window taps of relu(x + bias), zero fill for taps outside the image.
template <typename T>
__global__ void __launch_bounds__(256)
bias_relu_pool_kernel(const T* __restrict__ x, const float* __restrict__ bias,
                      T* __restrict__ out, int n, int h, int w, int c,
                      int ho, int wo, int window, int stride, int pad_h,
                      int pad_w, int run, int chunks) {
  const int chunk = blockIdx.x % chunks;
  const int gr0 = blockIdx.x / chunks * run;
  const int gr1 = min(gr0 + run, n * ho);
  const int item = chunk * blockDim.x + threadIdx.x;
  if (item >= wo * c) return;
  const int ow = item / c;
  const int ch = item - ow * c;
  const int wc = w * c;
  int img = gr0 / ho, oh = gr0 - img * ho;
  const T* xi = x + static_cast<long long>(img) * h * wc + ch;
  T* oi = out + (static_cast<long long>(img) * ho * wo + ow) * c + ch;
  const float bv = __ldg(bias + ch);
  const int w0 = ow * stride - pad_w;
  const bool reuse = window == stride + 1;
  bool fresh = true;
  float carry = 0.f;  // the max of the last input row of oh - 1
  for (int gr = gr0; gr < gr1; ++gr) {
    const int h0 = oh * stride - pad_h;
    const bool kept = reuse && !fresh;
    float m = 0.f;
    for (int di = 0; di < window; ++di) {
      const int hh = h0 + di;
      if (hh < 0 || hh >= h) continue;
      float hm = 0.f;
      if (kept && di == 0) {
        hm = carry;
      } else {
        const T* const row = xi + hh * wc;
        for (int dj = 0; dj < window; ++dj) {
          const int ww = w0 + dj;
          if (ww < 0 || ww >= w) continue;
          hm = nan_max(hm, nan_max(npl_to_float(row[ww * c]) + bv, 0.f));
        }
      }
      m = nan_max(m, hm);
      if (di == window - 1) carry = hm;
    }
    oi[oh * wo * c] = npl_from_float<T>(m);
    fresh = false;
    if (++oh == ho) {
      oh = 0;
      xi += static_cast<long long>(h) * wc;
      oi += static_cast<long long>(ho) * wo * c;
      fresh = true;
    }
  }
}

// The stem's 3 x 3 / s2 window on 16-byte vectors: kPoolCols adjacent
// output columns a thread, which share their edge taps, so one input row
// is 2 kPoolCols + 1 column loads, all issued (predicated) before the
// math, and the next output row's loads are issued before the current
// row's math.
constexpr int kPoolCols = 2;

// The 2 kCols + 1 columns from col0 of one input row, raw; zeros where
// the row or a column lies outside the image (`row` is clamped inside).
template <typename T, int kCols>
__device__ __forceinline__ void pool3_load(const T* row, bool row_ok,
                                           int col0, int w, int c,
                                           uint4 (&raw)[2 * kCols + 1]) {
#pragma unroll
  for (int t = 0; t < 2 * kCols + 1; ++t) {
    const int ww = col0 + t;
    raw[t] = row_ok && ww >= 0 && ww < w ? ld_raw(row + ww * c)
                                         : make_uint4(0, 0, 0, 0);
  }
}

// relu(x + bias) of those columns (0 outside the image: the zero fill),
// and the horizontal 3-tap max of each of the kCols output columns.
template <typename T, int kCols>
__device__ __forceinline__ void pool3_max(const uint4 (&raw)[2 * kCols + 1],
                                          bool row_ok, int col0, int w,
                                          const float* bv,
                                          float (&hm)[kCols][Vec<T>::kN]) {
  constexpr int V = Vec<T>::kN;
  constexpr int NC = 2 * kCols + 1;
  float y[NC][V];
#pragma unroll
  for (int t = 0; t < NC; ++t) {
    const int ww = col0 + t;
    const bool ok = row_ok && ww >= 0 && ww < w;
    unpack(raw[t], y[t], T());
#pragma unroll
    for (int j = 0; j < V; ++j)
      y[t][j] = ok ? nan_max(y[t][j] + bv[j], 0.f) : 0.f;
  }
#pragma unroll
  for (int q = 0; q < kCols; ++q) {
#pragma unroll
    for (int j = 0; j < V; ++j)
      hm[q][j] = nan_max(nan_max(y[2 * q][j], y[2 * q + 1][j]),
                         y[2 * q + 2][j]);
  }
}

// Items are (group of kCols output columns, vector); down the run, the
// input rows of output row oh are 2 oh - pad_h + {0, 1, 2}, and row + 0 is
// row + 2 of oh - 1.
template <typename T, int kCols>
__global__ void __launch_bounds__(256)
bias_relu_pool3s2_kernel(const T* __restrict__ x,
                         const float* __restrict__ bias, T* __restrict__ out,
                         int n, int h, int w, int c, int ho, int wo,
                         int pad_h, int pad_w, int run, int chunks) {
  constexpr int V = Vec<T>::kN;
  constexpr int NC = 2 * kCols + 1;
  const int chunk = blockIdx.x % chunks;
  const int gr0 = blockIdx.x / chunks * run;
  const int gr1 = min(gr0 + run, n * ho);
  const int vpr = c / V;
  const int groups = (wo + kCols - 1) / kCols;
  const int item = chunk * blockDim.x + threadIdx.x;
  if (item >= groups * vpr) return;
  const int grp = item / vpr;
  const int ch0 = (item - grp * vpr) * V;
  const int ow0 = grp * kCols;
  const int wc = w * c;
  int img = gr0 / ho, oh = gr0 - img * ho;
  const T* xi = x + static_cast<long long>(img) * h * wc + ch0;
  T* oi = out + (static_cast<long long>(img) * ho * wo + ow0) * c + ch0;
  float bv[V];
#pragma unroll
  for (int j = 0; j < V; ++j) bv[j] = __ldg(bias + ch0 + j);
  const int col0 = 2 * ow0 - pad_w;
  // Input row r of the current image: its clamped pointer, and whether it
  // lies inside.
  auto row_at = [&](const T* img_x, int r) {
    return img_x + min(max(r, 0), h - 1) * wc;
  };
  auto inside = [&](int r) { return r >= 0 && r < h; };
  float carry[kCols][V];
  uint4 n1[NC], n2[NC];  // rows + 1 and + 2 of the next output row
  {
    const int h0 = 2 * oh - pad_h;
    uint4 r0[NC];
    pool3_load<T, kCols>(row_at(xi, h0), inside(h0), col0, w, c, r0);
    pool3_load<T, kCols>(row_at(xi, h0 + 1), inside(h0 + 1), col0, w, c, n1);
    pool3_load<T, kCols>(row_at(xi, h0 + 2), inside(h0 + 2), col0, w, c, n2);
    pool3_max<T, kCols>(r0, inside(h0), col0, w, bv, carry);
  }
  for (int gr = gr0; gr < gr1; ++gr) {
    const int h1 = 2 * oh - pad_h + 1, h2 = h1 + 1;
    uint4 c1[NC], c2[NC];
#pragma unroll
    for (int t = 0; t < NC; ++t) {
      c1[t] = n1[t];
      c2[t] = n2[t];
    }
    // The next output row: oh + 1, or row 0 of the next image.
    const bool next_image = oh + 1 == ho;
    const int noh = next_image ? 0 : oh + 1;
    const T* const nxi = next_image ? xi + static_cast<long long>(h) * wc : xi;
    if (gr + 1 < gr1) {
      const int n1r = 2 * noh - pad_h + 1;
      pool3_load<T, kCols>(row_at(nxi, n1r), inside(n1r), col0, w, c, n1);
      pool3_load<T, kCols>(row_at(nxi, n1r + 1), inside(n1r + 1), col0, w, c,
                           n2);
    }
    float r1[kCols][V], r2[kCols][V];
    pool3_max<T, kCols>(c1, inside(h1), col0, w, bv, r1);
    pool3_max<T, kCols>(c2, inside(h2), col0, w, bv, r2);
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      float m[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        m[j] = nan_max(nan_max(carry[q][j], r1[q][j]), r2[q][j]);
        carry[q][j] = r2[q][j];
      }
      if (ow0 + q < wo) store_vec(oi + oh * wo * c + q * c, m);
    }
    oh = noh;
    xi = nxi;
    if (next_image) {
      oi += static_cast<long long>(ho) * wo * c;
      if (gr + 1 < gr1) {  // the new image's first input row, anew
        const int h0 = -pad_h;
        uint4 r0[NC];
        pool3_load<T, kCols>(row_at(xi, h0), inside(h0), col0, w, c, r0);
        pool3_max<T, kCols>(r0, inside(h0), col0, w, bv, carry);
      }
    }
  }
}

// ------------------------------------------------------- C interface

static constexpr int kThreads = 256;
static constexpr int kLrnTileElems = 8192;  // 32 KB of fp32 per block
// The backward stages two fp32 tiles (x and g x f / d): 2 x 16 KB.
static constexpr int kLrnBwdTileElems = 4096;

static bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Resident blocks of `kernel` with `threads` threads and `smem` bytes of
// dynamic shared memory on the whole card, into *slots.  Queried once per
// (kernel, threads, smem, device) and kept: the launchers ask on every
// call.  A failed query returns its error (and is asked again next time).
template <typename K>
static cudaError_t resident_slots(K kernel, int threads, size_t smem,
                                  int* slots) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, size_t, int>, int> known;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple(reinterpret_cast<const void*>(kernel),
                                   threads, smem, dev);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = known.find(key);
  if (it != known.end()) {
    *slots = it->second;
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *slots = known[key] = sms * per_sm;
  return cudaSuccess;
}

template <typename T, bool kCached>
static void launch_lrn_fwd_scalar(const void* x, void* out, float* dout,
                                  long long rows, int c, int size,
                                  float alpha_over_size, float beta, float k,
                                  cudaStream_t s) {
  const int tile_rows = kLrnTileElems / c;
  const unsigned blocks =
      static_cast<unsigned>((rows + tile_rows - 1) / tile_rows);
  const size_t smem = static_cast<size_t>(tile_rows) * c * sizeof(float);
  const int lo = size / 2, hi = size - 1 - size / 2;
  lrn_fwd_kernel<T, kCached><<<blocks, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), dout, rows, c,
      tile_rows, lo, hi, alpha_over_size, beta, k);
}

// The vector path where the window is kLrnVecSize, C a multiple of the
// vector width and every operand 16-byte aligned; else the scalar path.
template <typename T, bool kCached>
static cudaError_t launch_lrn_fwd_t(const void* x, void* out, float* dout,
                                    long long rows, int c, int size,
                                    float alpha_over_size, float beta,
                                    float k, cudaStream_t s) {
  constexpr int V = Vec<T>::kN;
  if (!(size == kLrnVecSize && c % V == 0 && c / V <= kThreads &&
        aligned16(x) && aligned16(out) && (!kCached || aligned16(dout)))) {
    launch_lrn_fwd_scalar<T, kCached>(x, out, dout, rows, c, size,
                                      alpha_over_size, beta, k, s);
    return cudaSuccess;
  }
  const int tile_rows = kThreads / (c / V);
  const long long ntiles = (rows + tile_rows - 1) / tile_rows;
  const size_t smem =
      2 * static_cast<size_t>(tile_rows) * (c + 2 * kLrnPad) * sizeof(float);
  auto kern = lrn_fwd_vec_kernel<T, kCached>;
  int slots = 0;  // smem <= 2 * 256 * (V + 8) floats: under 48 KB
  const cudaError_t err = resident_slots(kern, kThreads, smem, &slots);
  if (err != cudaSuccess) return err;
  const long long grid = std::min<long long>(slots, ntiles);
  kern<<<static_cast<unsigned>(grid), kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), dout, rows, c,
      tile_rows, ntiles, alpha_over_size, beta, k);
  return cudaSuccess;
}

template <bool kCached>
static int launch_lrn_fwd(const void* x, void* out, float* dout,
                          long long rows, int c, int size,
                          float alpha_over_size, float beta, float k,
                          int dtype, void* stream) {
  if (rows < 1 || c < 1 || c > kLrnTileElems || size < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == NPL_F32) {
    err = launch_lrn_fwd_t<float, kCached>(x, out, dout, rows, c, size,
                                           alpha_over_size, beta, k, s);
  } else if (dtype == NPL_BF16) {
    err = launch_lrn_fwd_t<__nv_bfloat16, kCached>(
        x, out, dout, rows, c, size, alpha_over_size, beta, k, s);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Whether the vector path takes these operands.
template <typename T, bool kCached>
static bool lrn_bwd_vec_fits(const void* x, const void* g, const float* d,
                             const void* dx, int c, int size) {
  constexpr int V = Vec<T>::kN;
  return size == kLrnVecSize && c % V == 0 && c / V <= kThreads &&
         aligned16(x) && aligned16(g) && aligned16(dx) &&
         (!kCached || aligned16(d));
}

template <typename T, bool kCached>
static cudaError_t launch_lrn_bwd_vec(const void* x, const void* g,
                                      const float* d, void* dx,
                                      long long rows, int c,
                                      float alpha_over_size, float beta,
                                      float k, float c2, cudaStream_t s) {
  constexpr int V = Vec<T>::kN;
  const int tile_rows = kThreads / (c / V);
  const long long ntiles = (rows + tile_rows - 1) / tile_rows;
  const size_t smem = (kCached ? 2 : 3) * static_cast<size_t>(tile_rows) *
                      (c + 2 * kLrnPad) * sizeof(float);
  int slots = 0;
  const cudaError_t err = resident_slots(lrn_bwd_vec_kernel<T, kCached>,
                                         kThreads, smem, &slots);
  if (err != cudaSuccess) return err;
  const long long grid = std::min<long long>(slots, ntiles);
  lrn_bwd_vec_kernel<T, kCached><<<static_cast<unsigned>(grid), kThreads,
                                   smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), d,
      static_cast<T*>(dx), rows, c, tile_rows, ntiles, alpha_over_size, beta,
      k, c2);
  return cudaSuccess;
}

template <typename T, bool kCached>
static void launch_lrn_bwd_scalar(const void* x, const void* g,
                                  const float* d, void* dx, long long rows,
                                  int c, int size, float alpha_over_size,
                                  float beta, float k, float c2,
                                  cudaStream_t s) {
  const int tile_rows = kLrnBwdTileElems / c;
  const unsigned blocks =
      static_cast<unsigned>((rows + tile_rows - 1) / tile_rows);
  const size_t smem = 2 * static_cast<size_t>(tile_rows) * c * sizeof(float);
  const int lo = size / 2, hi = size - 1 - size / 2;
  lrn_bwd_kernel<T, kCached><<<blocks, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), d,
      static_cast<T*>(dx), rows, c, tile_rows, lo, hi, alpha_over_size, beta,
      k, c2);
}

template <typename T, bool kCached>
static cudaError_t launch_lrn_bwd_t(const void* x, const void* g,
                                    const float* d, void* dx, long long rows,
                                    int c, int size, float alpha_over_size,
                                    float beta, float k, float c2,
                                    cudaStream_t s) {
  if (lrn_bwd_vec_fits<T, kCached>(x, g, d, dx, c, size))
    return launch_lrn_bwd_vec<T, kCached>(x, g, d, dx, rows, c,
                                          alpha_over_size, beta, k, c2, s);
  launch_lrn_bwd_scalar<T, kCached>(x, g, d, dx, rows, c, size,
                                    alpha_over_size, beta, k, c2, s);
  return cudaSuccess;
}

template <bool kCached>
static int launch_lrn_bwd(const void* x, const void* g, const float* d,
                          void* dx, long long rows, int c, int size,
                          float alpha_over_size, float beta, float k,
                          float c2, int dtype, void* stream) {
  if (rows < 1 || c < 1 || c > kLrnBwdTileElems || size < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == NPL_F32) {
    err = launch_lrn_bwd_t<float, kCached>(x, g, d, dx, rows, c, size,
                                           alpha_over_size, beta, k, c2, s);
  } else if (dtype == NPL_BF16) {
    err = launch_lrn_bwd_t<__nv_bfloat16, kCached>(
        x, g, d, dx, rows, c, size, alpha_over_size, beta, k, c2, s);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Threads a block for `items` (column, vector) items of an output row:
// the largest multiple of 32 in 64..256 that divides them (no idle
// lanes), else 128; fewer for a narrow row.
static int pool_threads(long long items) {
  int threads = 128;
  for (int t = 256; t >= 64; t -= 32) {
    if (items % t == 0) {
      threads = t;
      break;
    }
  }
  if (items < threads) threads = static_cast<int>((items + 31) / 32 * 32);
  return threads;
}

// The 3 x 3 / s2 kernel on 16-byte vectors where the window is the stem's,
// C is a multiple of the vector width and x and out are aligned; else the
// general kernel, one channel a thread.
template <typename T>
static int launch_pool_t(const void* x, const float* b, void* out, int n,
                         int h, int w, int c, int ho, int wo, int window,
                         int stride, int pad_h, int pad_w, cudaStream_t s) {
  constexpr int V = Vec<T>::kN;
  const bool s2 = window == 3 && stride == 2 && c % V == 0 &&
                  aligned16(x) && aligned16(out);
  const long long items =
      s2 ? static_cast<long long>((wo + kPoolCols - 1) / kPoolCols) * (c / V)
         : static_cast<long long>(wo) * c;
  if (items > INT_MAX) return cudaErrorInvalidValue;
  const int threads = pool_threads(items);
  const int chunks = static_cast<int>((items + threads - 1) / threads);
  int slots = 0;
  const cudaError_t err =
      s2 ? resident_slots(bias_relu_pool3s2_kernel<T, kPoolCols>, threads, 0,
                          &slots)
         : resident_slots(bias_relu_pool_kernel<T>, threads, 0, &slots);
  if (err != cudaSuccess) return static_cast<int>(err);
  // One wave: the batch's n * ho output rows in equal runs, one run a
  // block per chunk.
  const int rows = n * ho;
  const int parts = std::max(1, slots / chunks);
  const int run = (rows + parts - 1) / parts;
  const long long blocks =
      static_cast<long long>((rows + run - 1) / run) * chunks;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>(blocks);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (s2) {
    bias_relu_pool3s2_kernel<T, kPoolCols><<<grid, threads, 0, s>>>(
        xt, b, ot, n, h, w, c, ho, wo, pad_h, pad_w, run, chunks);
  } else {
    bias_relu_pool_kernel<T><<<grid, threads, 0, s>>>(
        xt, b, ot, n, h, w, c, ho, wo, window, stride, pad_h, pad_w, run,
        chunks);
  }
  return static_cast<int>(cudaGetLastError());
}

// Vectors a lane loads before it stores (the vector path).
static constexpr int kBiasReluUnroll = 4;

// The vector path's grid and lanes where it takes the operands (C and n
// multiples of the vector width, x and out aligned, and one wave holding
// at least C / V lanes); *lanes = 0 where they take the scalar path.  One
// wave of resident blocks, fewer when the call has less work than
// kBiasReluUnroll vectors a lane.
template <typename T>
static cudaError_t bias_relu_vec_plan(const void* x, const void* out,
                                      long long n, int c, long long* grid,
                                      long long* lanes) {
  constexpr int V = Vec<T>::kN;
  constexpr long long kPerBlock = static_cast<long long>(kThreads) *
                                  kBiasReluUnroll;
  *lanes = 0;
  if (!(c % V == 0 && n % V == 0 && aligned16(x) && aligned16(out)))
    return cudaSuccess;
  int slots = 0;
  const cudaError_t err = resident_slots(
      bias_relu_vec_kernel<T, kBiasReluUnroll>, kThreads, 0, &slots);
  if (err != cudaSuccess) return err;
  const int cv = c / V;
  *grid = std::min<long long>(slots, (n / V + kPerBlock - 1) / kPerBlock);
  *lanes = *grid * kThreads / cv * cv;
  return cudaSuccess;
}

template <typename T>
static int launch_bias_relu_t(const void* x, const float* b, void* out,
                              long long n, int c, cudaStream_t s) {
  constexpr int V = Vec<T>::kN;
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  long long grid = 0, lanes = 0;
  cudaError_t err = bias_relu_vec_plan<T>(x, out, n, c, &grid, &lanes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (lanes > 0) {
    bias_relu_vec_kernel<T, kBiasReluUnroll>
        <<<static_cast<unsigned>(grid), kThreads, 0, s>>>(xt, b, ot, n / V,
                                                          c / V, lanes);
    return static_cast<int>(cudaGetLastError());
  }
  int slots = 0;
  err = resident_slots(bias_relu_kernel<T>, kThreads, 0, &slots);
  if (err != cudaSuccess) return static_cast<int>(err);
  grid = std::min<long long>(slots, (n + kThreads - 1) / kThreads);
  lanes = grid * kThreads;
  bias_relu_kernel<T><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
      xt, b, ot, n, c, lanes, static_cast<int>(lanes % c));
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

const char* npl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int npl_lrn_fwd(const void* x, void* out, long long rows, int c, int size,
                float alpha_over_size, float beta, float k, int dtype,
                void* stream) {
  return launch_lrn_fwd<false>(x, out, nullptr, rows, c, size,
                               alpha_over_size, beta, k, dtype, stream);
}

int npl_lrn_fwd_cached(const void* x, void* out, void* d, long long rows,
                       int c, int size, float alpha_over_size, float beta,
                       float k, int dtype, void* stream) {
  return launch_lrn_fwd<true>(x, out, static_cast<float*>(d), rows, c, size,
                              alpha_over_size, beta, k, dtype, stream);
}

// d == nullptr: recompute the denominator (lrn_bwd); else read it
// (lrn_bwd_cached).
int npl_lrn_bwd(const void* x, const void* g, const void* d, void* dx,
                long long rows, int c, int size, float alpha_over_size,
                float beta, float k, float c2, int dtype, void* stream) {
  const float* dc = static_cast<const float*>(d);
  if (dc != nullptr)
    return launch_lrn_bwd<true>(x, g, dc, dx, rows, c, size,
                                alpha_over_size, beta, k, c2, dtype, stream);
  return launch_lrn_bwd<false>(x, g, nullptr, dx, rows, c, size,
                               alpha_over_size, beta, k, c2, dtype, stream);
}

int npl_bias_relu(const void* x, const void* bias, void* out, long long n,
                  int c, int dtype, void* stream) {
  if (n < 1 || c < 1 || n % c != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (dtype == NPL_F32)
    return launch_bias_relu_t<float>(x, b, out, n, c, s);
  if (dtype == NPL_BF16)
    return launch_bias_relu_t<__nv_bfloat16>(x, b, out, n, c, s);
  return cudaErrorInvalidValue;
}

// *vector = 1 where npl_bias_relu takes the vector path for these
// operands, 0 where it takes the scalar path.
int npl_bias_relu_path(const void* x, const void* out, long long n, int c,
                       int dtype, int* vector) {
  if (n < 1 || c < 1 || n % c != 0) return cudaErrorInvalidValue;
  long long grid = 0, lanes = 0;
  cudaError_t err;
  if (dtype == NPL_F32)
    err = bias_relu_vec_plan<float>(x, out, n, c, &grid, &lanes);
  else if (dtype == NPL_BF16)
    err = bias_relu_vec_plan<__nv_bfloat16>(x, out, n, c, &grid, &lanes);
  else
    return cudaErrorInvalidValue;
  *vector = lanes > 0;
  return static_cast<int>(err);
}

int npl_bias_relu_pool(const void* x, const void* bias, void* out, int n,
                       int h, int w, int c, int ho, int wo, int window,
                       int stride, int pad_h, int pad_w, int dtype,
                       void* stream) {
  if (n < 1 || h < 1 || w < 1 || c < 1 || ho < 1 || wo < 1 || window < 1 ||
      stride < 1 || pad_h < 0 || pad_w < 0 ||
      static_cast<long long>(h) * w * c > INT_MAX ||
      static_cast<long long>(ho) * wo * c > INT_MAX ||
      static_cast<long long>(n) * ho > INT_MAX)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (dtype == NPL_F32)
    return launch_pool_t<float>(x, b, out, n, h, w, c, ho, wo, window,
                                stride, pad_h, pad_w, s);
  if (dtype == NPL_BF16)
    return launch_pool_t<__nv_bfloat16>(x, b, out, n, h, w, c, ho, wo,
                                        window, stride, pad_h, pad_w, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
