// Fused IVF probe for Hopper (sm_90a): per query, gather each probed
// cluster's (cap, D) slab, dot-score it against the query, and merge it
// into a running top-kl — one launch for the whole (query, probe) sweep.
//
// Replaces npairloss_tpu/ops/pallas_ivf.py::_probe_kernel (:110), launched
// by fused_probe_topk (:186).
//
// Bound on an H100: memory.  Every probed slab row is read once
// (D * sizeof(slab) bytes) for 2 * D flops, far below the card's
// flop-per-byte balance; the least time is the probed rows' bytes over
// 3.35 TB/s.  Padding rows (row id -1) and clusters a query does not own
// are never read.
//
// Design.  The Pallas grid walks (query b, probe j) in order, carrying the
// running best across the sequential probe axis in VMEM.  Blocks on a GPU
// run in no order, so here ONE block owns one query and a loop over its
// probes replaces the sequential grid axis; the running best never
// leaves shared memory.  Per probe the block
//   1. reads the probed cluster id itself (stage 1, the centroid pick,
//      stays plain torch: it is one small matmul and a sort);
//   2. streams the cluster's rows: each warp takes a row, its lanes read
//      consecutive 16-byte chunks (coalesced, kUnroll of them in flight
//      per lane; single elements where 16 bytes do not divide a row) and
//      accumulate fp32 FMAs against the query held in shared memory,
//      then reduce with shuffles.  A slab
//      element is used exactly once, so it goes from memory straight to
//      registers; the reused operand, the query row, is the one staged in
//      shared memory.  Scoring modes follow pallas_ivf.py:140-153: fp32
//      is plain fp32 (no TF32); bf16 rounds q and the slab to bf16 and
//      accumulates in fp32; int8 converts the slab exactly and multiplies
//      the dot by the cluster's scale;
//   3. masks padding rows, unowned clusters and invalid slots to -FLT_MAX;
//   4. merges: the work array is [running best (kl) ; this tile (cap)] and
//      kl block-wide extract-max passes pick the new best.  Ties go to the
//      lower work position, so an equal score in the running best beats
//      the tile and a lower cap position beats a higher one — the
//      lowest-index rule of lax.top_k the Pallas merge keeps
//      (pallas_ivf.py:157-177).  An extracted slot drops to -inf, below
//      every masked (-FLT_MAX) slot, so no slot is taken twice.

#include <float.h>
#include <limits.h>
#include <math.h>

#include "common.cuh"

// scoring codes passed from Python: 0 = fp32, 1 = bf16, 2 = int8.
enum NplScoring { NPL_SCORE_F32 = 0, NPL_SCORE_BF16 = 1, NPL_SCORE_INT8 = 2 };

static constexpr int kProbeThreads = 512;
// 16-byte vector loads in flight per lane per row (8 x 16 B for fp32 at
// D = 1024): what keeps enough bytes in flight with one block per query.
static constexpr int kUnroll = 8;

template <typename TG>
struct VecOf {
  static constexpr int kElems = 16 / static_cast<int>(sizeof(TG));
};

// acc += q[0:n] . (16 bytes of slab elements), fp32 FMAs in order.
template <typename TG>
__device__ __forceinline__ float npl_dot16(const float* q, const uint4& v,
                                           float acc) {
  const TG* e = reinterpret_cast<const TG*>(&v);
#pragma unroll
  for (int k = 0; k < VecOf<TG>::kElems; ++k)
    acc = fmaf(q[k], npl_to_float(e[k]), acc);
  return acc;
}

__device__ __forceinline__ void npl_argmax_step(float& bv, int& bi, float ov,
                                                int oi) {
  if (ov > bv || (ov == bv && oi < bi)) {
    bv = ov;
    bi = oi;
  }
}

template <typename TG, bool kRoundQ>
__global__ void ivf_probe_kernel(const float* __restrict__ q,
                                 const TG* __restrict__ packed,
                                 const int* __restrict__ rows,
                                 const int* __restrict__ lids,
                                 const int* __restrict__ owned,
                                 const float* __restrict__ scale,
                                 float* __restrict__ out_s,
                                 int* __restrict__ out_r, int n_probes,
                                 int cap, int d, int kl, bool vec) {
  extern __shared__ float smem[];
  const int nw = kl + cap;
  float* qs = smem;                              // d
  float* wv = qs + d;                            // kl + cap work values
  int* wr = reinterpret_cast<int*>(wv + nw);     // kl + cap work rows
  float* nv = reinterpret_cast<float*>(wr + nw); // kl new best values
  int* nr = reinterpret_cast<int*>(nv + kl);     // kl new best rows
  __shared__ float red_v[32];
  __shared__ int red_i[32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int i = tid; i < d; i += blockDim.x) {
    float v = q[static_cast<long long>(b) * d + i];
    if (kRoundQ) v = __bfloat162float(__float2bfloat16_rn(v));
    qs[i] = v;
  }
  for (int i = tid; i < kl; i += blockDim.x) {
    wv[i] = -FLT_MAX;
    wr[i] = 0;
  }
  __syncthreads();

  for (int j = 0; j < n_probes; ++j) {
    const int lid = lids[b * n_probes + j];
    const bool ok = owned[b * n_probes + j] != 0;
    const int* rrow = rows + static_cast<long long>(lid) * cap;
    const float sc = scale != nullptr ? scale[lid] : 1.f;
    for (int t = warp; t < cap; t += nwarps) {
      const int rid = rrow[t];
      const bool valid = ok && rid >= 0;  // uniform across the warp
      float acc = 0.f;
      if (valid) {
        const TG* g = packed + (static_cast<long long>(lid) * cap + t) * d;
        if (vec) {
          // 16-byte chunks, lane-strided (coalesced), kUnroll in flight.
          constexpr int kv = VecOf<TG>::kElems;
          const uint4* g4 = reinterpret_cast<const uint4*>(g);
          const int nchunks = d / kv;
          for (int c0 = lane; c0 < nchunks; c0 += 32 * kUnroll) {
            uint4 v[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              const int ci = c0 + 32 * u;
              if (ci < nchunks) v[u] = __ldg(g4 + ci);
            }
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              const int ci = c0 + 32 * u;
              if (ci < nchunks) acc = npl_dot16<TG>(qs + ci * kv, v[u], acc);
            }
          }
        } else {
#pragma unroll 4
          for (int i = lane; i < d; i += 32)
            acc = fmaf(qs[i], npl_to_float(g[i]), acc);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, off);
      }
      if (lane == 0) {
        wv[kl + t] = valid ? (scale != nullptr ? acc * sc : acc) : -FLT_MAX;
        wr[kl + t] = rid;
      }
    }
    __syncthreads();

    for (int p = 0; p < kl; ++p) {
      float bv = -INFINITY;
      int bi = INT_MAX;
      // Ascending strided scan: the first maximum a thread sees is its
      // lowest index, so a strict '>' keeps the tie rule per thread.
      for (int i = tid; i < nw; i += blockDim.x) {
        const float v = wv[i];
        if (v > bv) {
          bv = v;
          bi = i;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, bv, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        npl_argmax_step(bv, bi, ov, oi);
      }
      if (lane == 0) {
        red_v[warp] = bv;
        red_i[warp] = bi;
      }
      __syncthreads();
      if (warp == 0) {
        bv = lane < nwarps ? red_v[lane] : -INFINITY;
        bi = lane < nwarps ? red_i[lane] : INT_MAX;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_down_sync(0xffffffffu, bv, off);
          const int oi = __shfl_down_sync(0xffffffffu, bi, off);
          npl_argmax_step(bv, bi, ov, oi);
        }
        if (lane == 0) {
          nv[p] = bv;
          nr[p] = wr[bi];
          wv[bi] = -INFINITY;
        }
      }
      __syncthreads();
    }
    for (int i = tid; i < kl; i += blockDim.x) {
      wv[i] = nv[i];
      wr[i] = nr[i];
    }
    __syncthreads();
  }

  for (int i = tid; i < kl; i += blockDim.x) {
    out_s[static_cast<long long>(b) * kl + i] = wv[i];
    out_r[static_cast<long long>(b) * kl + i] = wr[i];
  }
}

template <typename TG, bool kRoundQ>
static int launch_probe(const float* q, const void* packed, const int* rows,
                        const int* lids, const int* owned, const float* scale,
                        float* out_s, int* out_r, int b, int n_probes,
                        int cap, int d, int kl, cudaStream_t s) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(d) + 2 * (kl + cap) + 2 * kl);
  auto kern = ivf_probe_kernel<TG, kRoundQ>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // Vector loads need 16-byte rows and a 16-byte aligned slab.
  const bool vec = (static_cast<size_t>(d) * sizeof(TG)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(packed) % 16 == 0;
  kern<<<b, kProbeThreads, smem, s>>>(q, static_cast<const TG*>(packed), rows,
                                      lids, owned, scale, out_s, out_r,
                                      n_probes, cap, d, kl, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int npl_ivf_probe(const void* q, const void* packed,
                             const void* rows, const void* lids,
                             const void* owned, const void* scale,
                             void* out_s, void* out_r, int b, int n_probes,
                             int cap, int d, int kl, int scoring,
                             void* stream) {
  if (b < 1 || n_probes < 1 || cap < 1 || d < 1 || kl < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const int* r = static_cast<const int*>(rows);
  const int* l = static_cast<const int*>(lids);
  const int* o = static_cast<const int*>(owned);
  const float* sc = static_cast<const float*>(scale);
  float* os = static_cast<float*>(out_s);
  int* orr = static_cast<int*>(out_r);
  switch (scoring) {
    case NPL_SCORE_F32:
      return launch_probe<float, false>(qf, packed, r, l, o, nullptr, os, orr,
                                        b, n_probes, cap, d, kl, s);
    case NPL_SCORE_BF16:
      return launch_probe<__nv_bfloat16, true>(qf, packed, r, l, o, nullptr,
                                               os, orr, b, n_probes, cap, d,
                                               kl, s);
    case NPL_SCORE_INT8:
      return launch_probe<int8_t, true>(qf, packed, r, l, o, sc, os, orr, b,
                                        n_probes, cap, d, kl, s);
    default:
      return cudaErrorInvalidValue;
  }
}
