// Fused IVF probe for Hopper (sm_90a): per query, gather each probed
// cluster's (cap, D) slab, dot-score it against the query, and keep the
// top-kl — one launch for the whole (query, probe) sweep.
//
// Replaces npairloss_tpu/ops/pallas_ivf.py::_probe_kernel (:110), launched
// by fused_probe_topk (:186).
//
// Bound on an H100: memory.  Every probed slab row is read once
// (D * sizeof(slab) bytes) for 2 * D flops, far below the card's
// flop-per-byte balance; the least time is the probed rows' bytes, per
// (query, probe), over 3.35 TB/s.  Padding rows (row id -1) and clusters a
// query does not own are never read.  Queries of one launch that probe the
// same cluster may find its rows in the 50 MB L2, so a run can read faster
// than that bound; the bound over each probed cluster counted once is the
// floor then.
//
// What is computed.  The Pallas grid walks (query b, probe j) in order and
// merges each probe's tile into a running top-kl by repeated extract-max,
// lowest position first on ties (lax.top_k's rule).  That sequential merge
// has a closed form: the running best after the last probe is the stable
// top-kl of the concatenation
//     [kl filler slots (-FLT_MAX, row 0) ; probe 0's cap slots ; probe 1's ;
//      ...]
// — every slot of the running best precedes every slot of the next tile,
// and a dropped slot stays beaten.  So each candidate gets one 64-bit key,
// the order-preserving bits of its score in the high word (-0.0 taken as
// +0.0: the merge compares with '>', so the two zeros tie) and 0xFFFFFFFF
// minus its position in that concatenation in the low word; keys are
// unique and "larger key" is exactly "higher score, then lower position".
// The top-kl keys can then be found in any order, in parallel.  A slot
// whose score is not above -FLT_MAX (masked, padding, unowned) always
// loses to the kl fillers and is never a candidate.
//
// Design.
//   * Spread: one wave of one CTA an SM.  A query is a thread-block
//     cluster of cs CTAs, the largest (at most 16) such that the card
//     runs all B clusters at once (cudaOccupancyMaxActiveClusters: a
//     cluster stays within a GPC, so fewer than SMs / cs may fit); CTA
//     `rank` takes row chunk `rank` (cap / cs rows) of every probe.  At
//     B = 32 that is about 4 CTAs a query; the old design ran one CTA per
//     query (32 of 132 SMs busy).
//   * Stream: a ring of slab rows in shared memory filled by bulk copies
//     (TMA, no registers held).  A bulk copy of one 1 KB row costs about
//     as much as one of 8 KB, so a slot takes a span of consecutive rows
//     (about 8 KB: 2 fp32, 4 bf16 or 8 int8 rows at D = 1024), copied up
//     to its last valid row; the ring takes as many slots as fit, at most
//     180 KB (22 at D = 1024).  The last warp produces: it reads a step's
//     row ids, then copies each span that holds a valid row into the next
//     slot once freed (an mbarrier pair a slot: full when its bytes land,
//     empty when its consumer is done), writing the span's row ids and
//     position beside it.  The other 15 warps consume, a slot at a time:
//     warp c takes fills c, c + 15, ..., scores the span's valid rows out
//     of shared memory, a warp a row, reducing by shuffles, and frees the
//     slot.  Parity waits cannot tell a phase from the one two laps back,
//     and bulk copies land out of order: so a consumer first waits until
//     the producer has claimed the slot for its fill (a sequence word a
//     slot, written before the fill's arrival), by when the fill before
//     has landed, and the producer's lanes converge after each step.  The
//     query is staged once per CTA (rounded to bf16 for bf16 and int8
//     scoring), and each consumer lane keeps its share in registers (the
//     ring takes D <= 1024: 32 floats a lane).  int8 is widened with a
//     byte permute into the float 2^23 + (v + 128) and one subtraction
//     (exact), not a conversion instruction.  Longer rows, rows whose
//     bytes are not 16-byte multiples, or a slab off 16-byte alignment,
//     take element loads by every warp instead.
//     Scoring modes follow pallas_ivf.py:140-153: fp32 is plain fp32 (no
//     TF32); bf16 rounds q and the slab to bf16 and accumulates in fp32;
//     int8 converts the slab exactly and multiplies the dot by the
//     cluster's scale.
//   * Select, with no serial extract-max: each warp keeps its own top-kl
//     keys (with their gallery rows) in shared memory and a threshold (its
//     kl-th key).  A scored row above the threshold is appended to the
//     warp's buffer (ballot and popcount, no atomics); a full buffer, and
//     the last one, is merged by rank counting: each key's rank is the
//     number of larger keys, and keys of rank < kl land at their rank.
//     The CTA merges its warps' lists the same way (one barrier) and
//     stores its list into rank 0's shared memory (distributed shared
//     memory); after one cluster barrier rank 0 ranks the cluster's lists
//     and writes the query's top-kl, filling the slots no real candidate
//     reached with (-FLT_MAX, row 0).  No second launch, no global round
//     trip.
//   * Shared memory holds the ring, the query and kl-sized lists: it does
//     not grow with cap, so any cap runs.  kl is capped at kMaxKl.

#include <cooperative_groups.h>
#include <float.h>
#include <limits.h>

#include <algorithm>
#include <array>
#include <map>
#include <mutex>
#include <tuple>

#include "common.cuh"

namespace cg = cooperative_groups;

// scoring codes passed from Python: 0 = fp32, 1 = bf16, 2 = int8.
enum NplScoring { NPL_SCORE_F32 = 0, NPL_SCORE_BF16 = 1, NPL_SCORE_INT8 = 2 };

static constexpr int kProbeThreads = 512;
static constexpr int kProbeWarps = kProbeThreads / 32;
static constexpr int kProducerWarp = kProbeWarps - 1;
// A warp's candidate buffer, in keys; merged when a ballot could overflow.
static constexpr int kKeyBuf = 64;
static constexpr int kMaxKl = 256;
static constexpr int kClusterLarge = 16;
// The row ring's largest size, a slot's target (a slot takes a span of
// consecutive rows, one bulk copy: a copy of one 1 KB row costs about as
// much as one of 8 KB), and the shared memory a CTA may use.
static constexpr size_t kMaxRingBytes = 180 * 1024;
static constexpr size_t kSpanBytes = 8 * 1024;
static constexpr int kMaxSpan = 32;
// Row ids a producer lane prefetches for the next step: a step is at most
// 32 * kStageLoads rows.
static constexpr int kStageLoads = 8;
// q floats a consumer lane holds in registers.
static constexpr int kQRegs = 32;
static constexpr size_t kSmemLimit = 232448 - 1024;  // static shared too
static constexpr unsigned kEndOfRows = 0xFFFFFFFFu;

typedef unsigned long long Key;

struct ProbeArgs {
  const float* q;
  const void* packed;
  const int* rows;
  const int* lids;
  const int* owned;
  const float* scale;
  float* out_s;
  int* out_r;
  int n_probes, cap, d, kl;
  int chunk_rows;          // rows a CTA takes of each probed cluster
  int slots;               // ring slots; 0: element loads
  int span;                // consecutive rows a slot holds (<= 32)
};

__device__ __forceinline__ Key probe_key(float s, unsigned pos) {
  unsigned u = __float_as_uint(s);
  if (u == 0x80000000u) u = 0u;  // -0.0 ties +0.0, as the merge's '>'
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<Key>(u) << 32) | (0xFFFFFFFFu - pos);
}

__device__ __forceinline__ float key_score(Key k) {
  const unsigned u = static_cast<unsigned>(k >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u);
}

template <typename TG>
struct VecOf {
  static constexpr int kElems = 16 / static_cast<int>(sizeof(TG));
};

// ------------------------------------------- mbarriers and bulk copies

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(Key* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(Key* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(Key* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` of *bar has completed.  A wait
// that outlasts 2^32 cycles (about 2 s) traps: a broken handshake fails
// the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(Key* bar, unsigned parity) {
  long long start = -1;
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (start < 0) start = now;
    if (now - start > (1ll << 32)) __trap();
  }
}

// One bulk copy (TMA, no tensor map) of `bytes` (a multiple of 16, both
// ends 16-byte aligned) into this CTA's shared memory; completes on *bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, Key* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ------------------------------------------------------------ scoring

// acc += q . (16 bytes of slab elements), fp32 FMAs in element order, q
// (held in registers) as the scoring mode rounds it.
__device__ __forceinline__ float dot16(const float* q, uint4 v, float acc,
                                        float) {
  acc = fmaf(q[0], __uint_as_float(v.x), acc);
  acc = fmaf(q[1], __uint_as_float(v.y), acc);
  acc = fmaf(q[2], __uint_as_float(v.z), acc);
  return fmaf(q[3], __uint_as_float(v.w), acc);
}

__device__ __forceinline__ float dot16(const float* q, uint4 v, float acc,
                                        __nv_bfloat16) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc = fmaf(q[2 * i], __uint_as_float(w[i] << 16), acc);
    acc = fmaf(q[2 * i + 1], __uint_as_float(w[i] & 0xffff0000u), acc);
  }
  return acc;
}

__device__ __forceinline__ float dot16(const float* q, uint4 v, float acc,
                                        int8_t) {
  const uint32_t w[4] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u,
                         v.z ^ 0x80808080u, v.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x =
          __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7540 + e));
      acc = fmaf(q[4 * i + e], x - 8388736.f, acc);
    }
  }
  return acc;
}

// A warp's top-kl: keys and their gallery rows side by side, the list
// in [0, kl), the buffer of candidates in [kl, kl + kKeyBuf), then kl of
// scratch.
struct WarpTop {
  Key* key;
  int* row;
  int n, nb;  // keys in the list, in the buffer
  Key thr;    // the list's kl-th key once it holds kl, else 0
};

// Keep the kl largest keys of the list and the buffer in the list, in
// descending order (each key lands at its rank: the keys are unique, so
// the ranks are a permutation).  One warp.
__device__ __forceinline__ void warp_merge(WarpTop& w, int kl, int lane) {
  __syncwarp();
  Key* const tk = w.key + kl + kKeyBuf;
  int* const tr = w.row + kl + kKeyBuf;
  const int end = kl + w.nb;
  for (int e = lane; e < end; e += 32) {
    if (e >= w.n && e < kl) continue;
    const Key x = w.key[e];
    int r = 0;
    for (int f = 0; f < w.n; ++f) r += w.key[f] > x;
    for (int f = kl; f < end; ++f) r += w.key[f] > x;
    if (r < kl) {
      tk[r] = x;
      tr[r] = w.row[e];
    }
  }
  __syncwarp();
  w.n = min(kl, w.n + w.nb);
  w.nb = 0;
  for (int e = lane; e < w.n; e += 32) {
    w.key[e] = tk[e];
    w.row[e] = tr[e];
  }
  __syncwarp();
  w.thr = w.n == kl ? w.key[kl - 1] : 0ull;
}

// A scored row into the warp's top-kl: a candidate above the warp's
// threshold goes to its buffer (ballot, no atomics); a buffer that the
// next ballot could overflow is merged.  Called by the whole warp.
__device__ __forceinline__ void offer(WarpTop& w, int kl, int lane,
                                      bool cand, Key key, int row) {
  cand = cand && key > w.thr;
  const unsigned m = __ballot_sync(0xffffffffu, cand);
  if (m != 0u) {  // uniform over the warp
    if (cand) {
      const int at = kl + w.nb + __popc(m & ((1u << lane) - 1u));
      w.key[at] = key;
      w.row[at] = row;
    }
    w.nb += __popc(m);
    if (w.nb > kKeyBuf - 32) warp_merge(w, kl, lane);
  }
}

template <typename TG, bool kRoundQ>
__global__ void __launch_bounds__(kProbeThreads, 1)
ivf_probe_kernel(const ProbeArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / cs;
  const int kl = a.kl;
  const int ns = a.slots;
  const int span = a.span;
  constexpr int kv = VecOf<TG>::kElems;
  const int row_bytes = a.d * static_cast<int>(sizeof(TG));
  const int slot_bytes = span * row_bytes;
  const int rv = ns > 0 ? a.d / kv : 0;
  const int d4 = (a.d + 3) & ~3;
  const int wstride = 2 * kl + kKeyBuf;  // a warp's list, buffer, scratch
  // Spans the producer takes a step: distinct slots, at most 32 * kStageLoads
  // rows.
  const int w = max(1, min(min(32, ns), 32 * kStageLoads / span));
  extern __shared__ float4 probe_smem4[];
  unsigned char* const ring = reinterpret_cast<unsigned char*>(probe_smem4);
  float* const qs = reinterpret_cast<float*>(ring + ns * slot_bytes);  // d4
  Key* const keys = reinterpret_cast<Key*>(qs + d4);   // warps * wstride
  Key* const cta = keys + kProbeWarps * wstride;       // kl
  Key* const gath = cta + kl;                          // cs * kl (rank 0)
  Key* const full = gath + kClusterLarge * kl;         // ns
  Key* const empty = full + ns;                        // ns
  int* const rows = reinterpret_cast<int*>(empty + ns);  // warps * wstride
  int* const cta_row = rows + kProbeWarps * wstride;     // kl
  int* const gath_row = cta_row + kl;                    // cs * kl (rank 0)
  unsigned* const mseq = reinterpret_cast<unsigned*>(gath_row +
                                                     kClusterLarge * kl);
  unsigned* const mpos = mseq + ns;                      // ns
  int* const mcount = reinterpret_cast<int*>(mpos + ns);  // ns
  float* const mscale = reinterpret_cast<float*>(mcount + ns);  // ns
  int* const mrow = reinterpret_cast<int*>(mscale + ns);        // ns * span
  int* const stage = mrow + ns * span;                          // w * span
  int* const ulid = stage + w * span;  // n_probes, then usc: n_probes
  float* const usc = reinterpret_cast<float*>(ulid + a.n_probes);
  __shared__ int wn[kProbeWarps];
  __shared__ int cta_n;
  __shared__ int gath_n[kClusterLarge];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int e = tid; e < d4; e += kProbeThreads) {
    float v = e < a.d ? a.q[static_cast<long long>(b) * a.d + e] : 0.f;
    if (kRoundQ) v = __bfloat162float(__float2bfloat16_rn(v));
    qs[e] = v;
  }
  for (int i = tid; i < ns; i += kProbeThreads) {
    mbar_init(full + i, 1);
    mbar_init(empty + i, 1);
    mseq[i] = kEndOfRows;  // no fill has claimed the slot yet
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  __syncthreads();

  WarpTop top = {keys + warp * wstride, rows + warp * wstride, 0, 0, 0ull};
  // This CTA's rows of every probed cluster: chunk `rank` of cs.
  const int t0 = rank * a.chunk_rows;
  const int t1 = min(a.cap, t0 + a.chunk_rows);
  if (ns > 0 && warp == kProducerWarp) {
    // The producer: the spans of this CTA's rows of each probe, in order,
    // each one bulk copy (up to its last valid row) into the next slot
    // once its consumer freed it; a span without a valid row is skipped.
    // A step takes at most w spans, so its slots are distinct; the next
    // step's row ids are loaded while this step's copies are issued.
    for (int j = lane; j < a.n_probes; j += 32) {  // each probe's slab
      const int lid = a.lids[b * a.n_probes + j];
      ulid[j] = a.owned[b * a.n_probes + j] != 0 ? lid : -1;
      usc[j] = a.scale != nullptr ? a.scale[lid] : 1.f;
    }
    __syncwarp();
    const int per = w * span;
    // The steps: probe k's rows [tb, min(t1, tb + per)); false at the end.
    auto next_step = [&](int& k, int& tb) {
      if (k >= 0) tb += per;
      while (k < 0 || tb >= t1) {
        if (++k >= a.n_probes) return false;
        tb = t0;
        if (ulid[k] < 0) tb = t1;  // a probe this slab does not own
      }
      return true;
    };
    auto load_ids = [&](int k, int tb, int (&ids)[kStageLoads]) {
      const int* rrow = a.rows + static_cast<long long>(ulid[k]) * a.cap;
#pragma unroll
      for (int i = 0; i < kStageLoads; ++i) {
        const int r = lane + 32 * i;
        ids[i] = r < per && tb + r < t1 ? __ldg(rrow + tb + r) : -1;
      }
    };
    int k = -1, tb = t0;
    int ids[kStageLoads];
    bool more = next_step(k, tb);
    if (more) load_ids(k, tb, ids);
    unsigned seq = 0;
    while (more) {
#pragma unroll
      for (int i = 0; i < kStageLoads; ++i)
        if (lane + 32 * i < per) stage[lane + 32 * i] = ids[i];
      const int ck = k, ctb = tb;
      more = next_step(k, tb);
      if (more) load_ids(k, tb, ids);
      __syncwarp();
      int last = -1;  // this lane's span: its last valid row
      if (lane < w)
        for (int r = 0; r < span; ++r)
          if (stage[lane * span + r] >= 0) last = r;
      const unsigned m = __ballot_sync(0xffffffffu, last >= 0);
      if (last >= 0) {
        const unsigned sq = seq + __popc(m & ((1u << lane) - 1u));
        const int slot = static_cast<int>(sq % ns);
        mbar_wait(empty + slot, ((sq / ns) & 1u) ^ 1u);
        for (int r = 0; r <= last; ++r)
          mrow[slot * span + r] = stage[lane * span + r];
        const int t = ctb + lane * span;
        mpos[slot] = static_cast<unsigned>(kl + ck * a.cap + t);
        mcount[slot] = last + 1;
        mscale[slot] = usc[ck];
        *reinterpret_cast<volatile unsigned*>(mseq + slot) = sq;
        mbar_expect_tx(full + slot, (last + 1) * row_bytes);
        bulk_load(ring + slot * slot_bytes,
                  static_cast<const unsigned char*>(a.packed) +
                      (static_cast<long long>(ulid[ck]) * a.cap + t) *
                          row_bytes,
                  (last + 1) * row_bytes, full + slot);
      }
      seq += __popc(m);
      // Every lane's wait of this step is over before the next step's
      // waits begin (and its span's row ids are read before the stage
      // is refilled): a wait for a slot's release must not start while
      // the fill before it is still waiting, or its parity would
      // mistake the release two laps back for the one it needs.
      __syncwarp();
    }
    // One end marker for each consumer warp, after the same rule.
    for (int k0 = 0; k0 < kProducerWarp; k0 += w) {
      const int k = k0 + lane;
      if (lane < w && k < kProducerWarp) {
        const unsigned sq = seq + k;
        const int slot = static_cast<int>(sq % ns);
        mbar_wait(empty + slot, ((sq / ns) & 1u) ^ 1u);
        mcount[slot] = -1;
        *reinterpret_cast<volatile unsigned*>(mseq + slot) = sq;
        mbar_arrive(full + slot);
      }
      __syncwarp();
    }
  } else if (ns > 0) {
    // Each lane's share of q (the ring takes D <= 32 * kQRegs), in
    // registers: vectors ci = lane + 32 i of the row.
    constexpr int kVecs = kQRegs / kv;
    float qr[kQRegs];
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int ci = lane + 32 * i;
#pragma unroll
      for (int e = 0; e < kv; ++e)
        qr[i * kv + e] = ci < rv ? qs[ci * kv + e] : 0.f;
    }
    // The consumers: warp c takes fills c, c + 15, ...  It first waits
    // until the producer has claimed the slot for its fill (mseq): the
    // slot's fill before has then landed, so the parity wait that follows
    // cannot mistake it (bulk copies land out of order).  Then it scores
    // the span's valid rows out of shared memory, a warp a row, and frees
    // the slot.
    for (unsigned sq = warp;; sq += kProducerWarp) {
      const int slot = static_cast<int>(sq % ns);
      while (*reinterpret_cast<volatile unsigned*>(mseq + slot) != sq)
        __nanosleep(20);
      mbar_wait(full + slot, (sq / ns) & 1u);
      const int count = mcount[slot];
      if (count >= 0) {
        const unsigned pos = mpos[slot];
        const float sc = mscale[slot];
        for (int k = 0; k < count; ++k) {
          const int rid = mrow[slot * span + k];
          float acc = 0.f;
          if (rid >= 0) {
            const uint4* row = reinterpret_cast<const uint4*>(
                ring + slot * slot_bytes + k * row_bytes);
#pragma unroll
            for (int i = 0; i < kVecs; ++i) {
              const int ci = lane + 32 * i;
              if (ci < rv) acc = dot16(qr + i * kv, row[ci], acc, TG());
            }
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            acc += __shfl_xor_sync(0xffffffffu, acc, off);
          const float s = a.scale != nullptr ? acc * sc : acc;
          offer(top, kl, lane, lane == 0 && rid >= 0 && s > -FLT_MAX,
                probe_key(s, pos + k), rid);
        }
      }
      __syncwarp();  // every lane's reads of the slot are done
      if (lane == 0) mbar_arrive(empty + slot);
      if (count < 0) break;
    }
  } else {
    // Rows that are no 16-byte multiple, or a slab off 16-byte alignment:
    // every warp scores rows with element loads, a warp a row.
    for (int j = 0; j < a.n_probes; ++j) {
      const int lid = a.lids[b * a.n_probes + j];
      if (a.owned[b * a.n_probes + j] == 0) continue;  // uniform
      const int* rrow = a.rows + static_cast<long long>(lid) * a.cap;
      const float sc = a.scale != nullptr ? a.scale[lid] : 1.f;
      const unsigned pos0 = static_cast<unsigned>(kl + j * a.cap);
      for (int tb = t0; tb < t1; tb += kProbeWarps) {  // uniform over the CTA
        const int t = tb + warp;
        const int rid = t < t1 ? __ldg(rrow + t) : -1;
        float acc = 0.f;
        if (rid >= 0) {
          const TG* gp = static_cast<const TG*>(a.packed) +
                         (static_cast<long long>(lid) * a.cap + t) * a.d;
#pragma unroll 4
          for (int e = lane; e < a.d; e += 32)
            acc = fmaf(qs[e], npl_to_float(gp[e]), acc);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, off);
        const float s = a.scale != nullptr ? acc * sc : acc;
        offer(top, kl, lane, lane == 0 && rid >= 0 && s > -FLT_MAX,
              probe_key(s, pos0 + static_cast<unsigned>(t)), rid);
      }
    }
  }
  if (top.nb > 0) warp_merge(top, kl, lane);
  if (lane == 0) wn[warp] = top.n;
  __syncthreads();

  // The CTA's top-kl of its warps' lists (each sorted), by rank.
  for (int e = tid; e < kProbeWarps * kl; e += kProbeThreads) {
    const int w = e / kl, i = e - w * kl;
    if (i >= wn[w]) continue;
    const Key x = keys[w * wstride + i];
    int r = 0;
    for (int w2 = 0; w2 < kProbeWarps; ++w2) {
      const Key* l2 = keys + w2 * wstride;
      for (int f = 0; f < wn[w2]; ++f) r += l2[f] > x;
    }
    if (r < kl) {
      cta[r] = x;
      cta_row[r] = rows[w * wstride + i];
    }
  }
  if (tid == 0) {
    int tot = 0;
    for (int w = 0; w < kProbeWarps; ++w) tot += wn[w];
    cta_n = min(kl, tot);
  }
  __syncthreads();

  // Every CTA's list into rank 0's shared memory (distributed shared
  // memory stores); after one cluster barrier rank 0 ranks them all and
  // writes the query's top-kl, the others are done.
  {
    Key* const to_key = cluster.map_shared_rank(gath, 0) + rank * kl;
    int* const to_row = cluster.map_shared_rank(gath_row, 0) + rank * kl;
    for (int i = tid; i < cta_n; i += kProbeThreads) {
      to_key[i] = cta[i];
      to_row[i] = cta_row[i];
    }
    if (tid == 0) *cluster.map_shared_rank(gath_n + rank, 0) = cta_n;
  }
  cluster.sync();
  if (rank != 0) return;
  const long long ob = static_cast<long long>(b) * kl;
  int tot = 0;
  for (int r2 = 0; r2 < cs; ++r2) tot += gath_n[r2];
  for (int f = tid; f < cs * kl; f += kProbeThreads) {
    const int r2 = f / kl;
    if (f - r2 * kl >= gath_n[r2]) continue;
    const Key x = gath[f];
    int r = 0;
    for (int r3 = 0; r3 < cs; ++r3)
      for (int e = 0; e < gath_n[r3]; ++e) r += gath[r3 * kl + e] > x;
    if (r < kl) {
      a.out_s[ob + r] = key_score(x);
      a.out_r[ob + r] = gath_row[f];
    }
  }
  // The slots no real candidate reached: the fillers.
  for (int i = min(kl, tot) + tid; i < kl; i += kProbeThreads) {
    a.out_s[ob + i] = -FLT_MAX;
    a.out_r[ob + i] = 0;
  }
}

// The ring (ns slots of `span` rows), q, the warps' lists, the CTA's
// list, rank 0's gathered lists (room for the largest cluster), each with
// its rows, the slots' barriers, metadata and row ids, the producer's
// stage of row ids, and the slab and scale of each of the CTA's units.
static size_t probe_smem(int d, int kl, int ns, int span, size_t row_bytes,
                         int units) {
  const size_t d4 = (static_cast<size_t>(d) + 3) & ~static_cast<size_t>(3);
  const size_t lists = static_cast<size_t>(kProbeWarps) * (2 * kl + kKeyBuf) +
                       static_cast<size_t>(1 + kClusterLarge) * kl;
  const size_t slots = static_cast<size_t>(ns);
  return slots * span * row_bytes + sizeof(float) * d4 +
         (sizeof(Key) + sizeof(int)) * lists +
         (2 * sizeof(Key) + 4 * sizeof(int)) * slots +
         sizeof(int) * (slots + std::min<size_t>(32, slots)) * span +
         (sizeof(int) + sizeof(float)) * static_cast<size_t>(units);
}

// How many clusters of c CTAs of `kernel` with `smem` bytes the card
// runs at once, for c = 1..kClusterLarge (0 where it cannot), asked once
// per (kernel, smem, device).  A failed query returns its error.
template <typename K>
static cudaError_t active_clusters(K kernel, size_t smem,
                                   std::array<int, kClusterLarge + 1>* out) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, size_t, int>,
                  std::array<int, kClusterLarge + 1>>
      known;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto key =
      std::make_tuple(reinterpret_cast<const void*>(kernel), smem, dev);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = known.find(key);
  if (it != known.end()) {
    *out = it->second;
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  std::array<int, kClusterLarge + 1> n = {};
  for (int c = 1; c <= kClusterLarge; ++c) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(c);
    cfg.blockDim = dim3(kProbeThreads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&n[c], kernel, &cfg);
    if (err != cudaSuccess) {
      n[c] = 0;  // a size the card refuses (beyond its largest cluster)
      cudaGetLastError();
    }
  }
  *out = known[key] = n;
  return cudaSuccess;
}

template <typename TG, bool kRoundQ>
static int launch_probe(ProbeArgs a, int b, cudaStream_t s) {
  auto kern = ivf_probe_kernel<TG, kRoundQ>;
  cudaError_t err;
  // The ring: bulk copies need 16-byte rows and a 16-byte aligned slab.
  // A slot holds a span of consecutive rows, about kSpanBytes (2 fp32,
  // 4 bf16 or 8 int8 rows at D = 1024), and as many slots as fit beside
  // the rest in one SM's shared memory, at most kMaxRingBytes (22 slots,
  // 176 KB, at D = 1024).  Rows longer than D = 32 * kQRegs, rows the
  // ring cannot hold two slots of, or unaligned ones, take element loads,
  // a warp a row.
  const size_t row_bytes = static_cast<size_t>(a.d) * sizeof(TG);
  a.slots = 0;
  a.span = 1;
  if (row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(a.packed) % 16 == 0 &&
      a.d <= 32 * kQRegs) {
    const int span = static_cast<int>(std::max<size_t>(
        1, std::min<size_t>(kMaxSpan, kSpanBytes / row_bytes)));
    const size_t rest = probe_smem(a.d, a.kl, 0, span, row_bytes, a.n_probes);
    const size_t per_slot =
        probe_smem(a.d, a.kl, 32, span, row_bytes, a.n_probes) -
        probe_smem(a.d, a.kl, 31, span, row_bytes, a.n_probes);
    if (rest < kSmemLimit) {
      const size_t fit = std::min((kSmemLimit - rest) / per_slot,
                                  kMaxRingBytes / (span * row_bytes));
      if (fit >= 2) {
        a.slots = static_cast<int>(fit);
        a.span = span;
      }
    }
  }
  // Each CTA takes one row chunk of every probe: n_probes units.
  const size_t smem =
      probe_smem(a.d, a.kl, a.slots, a.span, row_bytes, a.n_probes);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // The cluster: the most CTAs a query such that the B clusters run in
  // one wave (the card may hold fewer clusters of c than SMs / c: a
  // cluster stays within a GPC); one CTA if even that takes waves.  CTA
  // `rank` takes row chunk `rank` of every probe.
  std::array<int, kClusterLarge + 1> active;
  err = active_clusters(kern, smem, &active);
  if (err != cudaSuccess) return static_cast<int>(err);
  int cs = 1;
  for (int c = 2; c <= std::min(kClusterLarge, a.cap); ++c)
    if (active[c] >= b) cs = c;
  a.chunk_rows = (a.cap + cs - 1) / cs;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(b) * cs);
  cfg.blockDim = dim3(kProbeThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, a);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

extern "C" int npl_ivf_probe(const void* q, const void* packed,
                             const void* rows, const void* lids,
                             const void* owned, const void* scale,
                             void* out_s, void* out_r, int b, int n_probes,
                             int cap, int d, int kl, int scoring,
                             void* stream) {
  // Positions kl + j * cap + t must fit the key's low word (and an int).
  if (b < 1 || n_probes < 1 || cap < 1 || d < 1 || kl < 1 || kl > kMaxKl ||
      b > INT_MAX / kClusterLarge ||
      static_cast<long long>(n_probes) * cap + kl > INT_MAX)
    return cudaErrorInvalidValue;
  ProbeArgs a = {};
  a.q = static_cast<const float*>(q);
  a.packed = packed;
  a.rows = static_cast<const int*>(rows);
  a.lids = static_cast<const int*>(lids);
  a.owned = static_cast<const int*>(owned);
  a.scale = scoring == NPL_SCORE_INT8 ? static_cast<const float*>(scale)
                                      : nullptr;
  a.out_s = static_cast<float*>(out_s);
  a.out_r = static_cast<int*>(out_r);
  a.n_probes = n_probes;
  a.cap = cap;
  a.d = d;
  a.kl = kl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (scoring) {
    case NPL_SCORE_F32:
      return launch_probe<float, false>(a, b, s);
    case NPL_SCORE_BF16:
      return launch_probe<__nv_bfloat16, true>(a, b, s);
    case NPL_SCORE_INT8:
      return launch_probe<int8_t, true>(a, b, s);
    default:
      return cudaErrorInvalidValue;
  }
}
