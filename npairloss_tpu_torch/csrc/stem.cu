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
//   * LRN: one block per tile of NHWC rows.  The tile's C channels per
//     row are staged once in shared memory (coalesced loads along the
//     contiguous channel axis), then every thread sums its channel
//     window out of shared memory with zero fill at the edges
//     (lo = size/2, hi = size-1-size/2), in the same order as the
//     Pallas _win_sum.  d^-beta is (sqrt(rsqrt(d)))^3 for beta = 0.75
//     and exp(-beta*log d) otherwise, as the reference computes it.
//     The backward stages x and u = g x f / d of a tile (two passes
//     with a barrier between), then sums u over the transposed window.
//     The cached and recompute variants share one body: d comes from
//     the cache or from the forward's own lrn_denominator, so the two
//     give the same bits.
//   * bias + ReLU: grid-stride elementwise, bias read through the cache.
//   * bias + ReLU + pool: one thread per pooled output; neighbouring
//     threads take neighbouring channels so every tap load is
//     coalesced.  The pre-pool activation exists only in registers — it
//     never reaches device memory.  SAME padding is asymmetric
//     (pad_lo = total/2); padded taps are skipped, which equals a zero
//     fill after the ReLU because a SAME window always holds one real
//     tap and every real tap is >= 0.

#include <float.h>

#include "common.cuh"

// ---------------------------------------------------------------- LRN

// d = k + a * sum_{o=-lo..hi} row[ch+o]^2 (zero fill), lowest offset
// first.  The one definition of the denominator: the forward kernels and
// the recomputing backward all call it, so the cached and the recomputed
// d are the same bits.
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

__device__ __forceinline__ float lrn_pow_neg_beta(float d, float beta) {
  if (beta == 0.75f) {
    const float r = sqrtf(rsqrtf(d));
    return r * r * r;
  }
  return expf(-beta * logf(d));
}

// kCached: also store the fp32 denominator d (the training residual).
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

// dx = g f - c2 x W^T(g x f / d), f = d^-beta, W^T the window with lo and
// hi swapped (pallas_stem.py:157-162); every product and the difference
// rounded on its own (no FMA), as the plain version computes them.
// kCached reads d; otherwise d is recomputed from the staged x row by
// lrn_denominator, the forward's own function.
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

// ------------------------------------------------------ bias + ReLU

template <typename T>
__global__ void bias_relu_kernel(const T* __restrict__ x,
                                 const float* __restrict__ bias,
                                 T* __restrict__ out, long long n, int c) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const float y = npl_to_float(x[i]) + __ldg(bias + i % c);
    out[i] = npl_from_float<T>(fmaxf(y, 0.f));
  }
}

// --------------------------------------------- bias + ReLU + max-pool

template <typename T>
__global__ void bias_relu_pool_kernel(const T* __restrict__ x,
                                      const float* __restrict__ bias,
                                      T* __restrict__ out, int n, int h,
                                      int w, int c, int ho, int wo,
                                      int window, int stride, int pad_h,
                                      int pad_w) {
  const long long total = static_cast<long long>(n) * ho * wo * c;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += step) {
    const int ch = static_cast<int>(i % c);
    long long t = i / c;
    const int ow = static_cast<int>(t % wo);
    t /= wo;
    const int oh = static_cast<int>(t % ho);
    const long long b = t / ho;
    const float bv = __ldg(bias + ch);
    const int h0 = oh * stride - pad_h;
    const int w0 = ow * stride - pad_w;
    float m = 0.f;
    for (int di = 0; di < window; ++di) {
      const int hh = h0 + di;
      if (hh < 0 || hh >= h) continue;
      const T* row = x + ((b * h + hh) * w) * c + ch;
      for (int dj = 0; dj < window; ++dj) {
        const int ww = w0 + dj;
        if (ww < 0 || ww >= w) continue;
        m = fmaxf(m, fmaxf(npl_to_float(row[static_cast<long long>(ww) * c]) + bv, 0.f));
      }
    }
    out[i] = npl_from_float<T>(m);
  }
}

// ------------------------------------------------------- C interface

static constexpr int kThreads = 256;
static constexpr int kLrnTileElems = 8192;  // 32 KB of fp32 per block
// The backward stages two fp32 tiles (x and g x f / d): 2 x 16 KB.
static constexpr int kLrnBwdTileElems = 4096;

template <bool kCached>
static int launch_lrn_fwd(const void* x, void* out, float* dout,
                          long long rows, int c, int size,
                          float alpha_over_size, float beta, float k,
                          int dtype, void* stream) {
  if (rows < 1 || c < 1 || c > kLrnTileElems || size < 1)
    return cudaErrorInvalidValue;
  const int tile_rows = kLrnTileElems / c;
  const unsigned blocks =
      static_cast<unsigned>((rows + tile_rows - 1) / tile_rows);
  const size_t smem = static_cast<size_t>(tile_rows) * c * sizeof(float);
  const int lo = size / 2, hi = size - 1 - size / 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == NPL_F32) {
    lrn_fwd_kernel<float, kCached><<<blocks, kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), dout, rows,
        c, tile_rows, lo, hi, alpha_over_size, beta, k);
  } else if (dtype == NPL_BF16) {
    lrn_fwd_kernel<__nv_bfloat16, kCached><<<blocks, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(out), dout, rows, c, tile_rows, lo, hi,
        alpha_over_size, beta, k);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kCached>
static int launch_lrn_bwd(const void* x, const void* g, const float* d,
                          void* dx, long long rows, int c, int size,
                          float alpha_over_size, float beta, float k,
                          float c2, int dtype, void* stream) {
  if (rows < 1 || c < 1 || c > kLrnBwdTileElems || size < 1)
    return cudaErrorInvalidValue;
  const int tile_rows = kLrnBwdTileElems / c;
  const unsigned blocks =
      static_cast<unsigned>((rows + tile_rows - 1) / tile_rows);
  const size_t smem = 2 * static_cast<size_t>(tile_rows) * c * sizeof(float);
  const int lo = size / 2, hi = size - 1 - size / 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == NPL_F32) {
    lrn_bwd_kernel<float, kCached><<<blocks, kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), d,
        static_cast<float*>(dx), rows, c, tile_rows, lo, hi,
        alpha_over_size, beta, k, c2);
  } else if (dtype == NPL_BF16) {
    lrn_bwd_kernel<__nv_bfloat16, kCached><<<blocks, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(g), d,
        static_cast<__nv_bfloat16*>(dx), rows, c, tile_rows, lo, hi,
        alpha_over_size, beta, k, c2);
  } else {
    return cudaErrorInvalidValue;
  }
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
  if (n < 1 || c < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = npl_grid(n, kThreads);
  const float* b = static_cast<const float*>(bias);
  if (dtype == NPL_F32) {
    bias_relu_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), b, static_cast<float*>(out), n, c);
  } else if (dtype == NPL_BF16) {
    bias_relu_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), b,
        static_cast<__nv_bfloat16*>(out), n, c);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

int npl_bias_relu_pool(const void* x, const void* bias, void* out, int n,
                       int h, int w, int c, int ho, int wo, int window,
                       int stride, int pad_h, int pad_w, int dtype,
                       void* stream) {
  if (n < 1 || h < 1 || w < 1 || c < 1 || ho < 1 || wo < 1 || window < 1 ||
      stride < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = static_cast<long long>(n) * ho * wo * c;
  const unsigned grid = npl_grid(total, kThreads);
  const float* b = static_cast<const float*>(bias);
  if (dtype == NPL_F32) {
    bias_relu_pool_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), b, static_cast<float*>(out), n, h, w,
        c, ho, wo, window, stride, pad_h, pad_w);
  } else if (dtype == NPL_BF16) {
    bias_relu_pool_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), b,
        static_cast<__nv_bfloat16*>(out), n, h, w, c, ho, wo, window,
        stride, pad_h, pad_w);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
