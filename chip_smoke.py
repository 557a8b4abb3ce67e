#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``npairloss_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--seed 0]

Phases (any failure raises, exits nonzero and prints no result line):

1. the card: ``nvidia-smi`` name and power limit, torch version and
   compute capability (must be 9.0); TF32 off for fp32 parity;
2. build the CUDA kernels from ``npairloss_tpu_torch/csrc/`` with nvcc
   (one process per source, started together);
3. hold each kernel against its plain PyTorch version on the card at
   the serving path's shapes — LRN and bias+ReLU at (32,56,56,64) and
   (32,56,56,192), bias+ReLU+pool at (32,112,112,64), in fp32 and bf16
   (the pool bit for bit, also with NaN planted, and timed beside
   ``F.max_pool2d`` over a ``channels_last`` tensor of the same shape, a
   read-rate yardstick; bias+ReLU keeps NaN where the plain version
   does);
   the IVF probe at B=32 against the phase-4 index, probes 8, k 10, in
   fp32/bf16/int8 (and once at D = 100, the kernel's element-wise
   path) — with the error against a stated tolerance and the
   median time from CUDA events (L2 flushed before every timed launch)
   beside the least time the card could take;
4. the serving path: a synthetic 60,502-row x 1024 gallery in 11,316
   identities (the SOP test split's size), an IVF index (~246 clusters),
   a ``googlenet_pallas`` engine at 224x224 (bf16, seeded trunk) with
   ``probe_impl="fused"``, and ~40 JSONL records (raw images, gallery
   rows, one bad line) through ``RetrievalServer.run_jsonl``; every
   answer, the top-1 self-match, the drain invariant, all four launch
   counters > 0, an exhaustive-probe recall of 1.0 against the flat
   engine, and the trunk on the card against the trunk on the CPU;
3b. the LRN training kernels (``lrn_fwd_cached``, ``lrn_bwd_cached``,
   ``lrn_bwd``) at (120,56,56,64) and (120,56,56,192) in fp32 and bf16
   against their plain versions, cached and recompute dx bit for bit,
   timed beside their bound, the plain versions and
   ``F.local_response_norm`` (forward; its backward alone on a saved
   graph); the LRN backward and the pool off their vector paths (C =
   100 at (2,7,9,100), and operands off 16-byte alignment), and the
   pool's general kernel at a 7 x 7 / s2 window; then the
   phase-3 forward kernels again at batch 120;
5. the training path: ``python -m npairloss_tpu_torch train`` in-process
   on ``examples/googlenet_cub_solver.prototxt`` cut to 6 iterations
   (test_iter 2, display 1, snapshot 0), ``googlenet_pallas`` at batch
   120 (60 x 2), 224x224, fp32, synthetic batches: every loss and
   metric finite, the training kernels launched by the steps and the
   uncached LRN forward by the iter-0 TEST, a nonzero gradient on every
   parameter, and the median step ms over steps 2-6; one more step under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync inside a
   step); then a ``torch.profiler`` breakdown of three more steps, and
   the solver's pinned batch upload against a pageable synchronous copy;
5b. one step twice from the same weights and batch, LRN cache on and
   off (``LRN_CACHE_AUTO_BYTES = 0``, which launches ``lrn_bwd``): the
   gradients bit for bit (cuDNN deterministic); then the step at batch 8
   on the card against the CPU;
5c. ``REFERENCE_CONFIG`` mining on 120 x 1024 unit features: from the
   card's sims, thresholds, masks and counts equal the CPU's exactly,
   and the loss agrees within 1e-5;
6. the five blockwise kernels (``csrc/npair_blockwise.cu``) at N = M =
   120 and 8192, D = 1024, against their plain sweeps: from the stats
   kernel's own emitted sims, minima, maxima, counts, histograms and
   the K-slot buffer bit for bit, I/D sums within 1e-4 relative, gq/gdb
   within 1e-5 / 1e-4 of their largest entry; the sims within 1e-5 of
   cuBLAS; cached and recompute variants bit for bit; every kernel, cached
   and recompute, launched twice gives the same bits; the plain loss sweep
   in the kernel's I/D order (its cluster split for this card); each timed
   beside its bound and
   its plain sweep, stats/gq/gdb also as a multiple of cuBLAS's fp32
   ``feats @ feats.T`` and a share of the fp32 peak; the hist kernel's
   early return timed alone;
6b. ``train --engine blockwise`` in-process on the phase-5 solver cut,
   the net's mining swapped for the reference's (GLOBAL/RELATIVE_HARD
   AP, LOCAL/HARD AN), zero biases: finite losses and metrics, the
   kernels launched by the steps, no host sync in a step, selected
   pairs > 0, ``--pos-topk 0`` (the hist kernel's radix path) equal to
   the fast path, and one step through the dense and the blockwise
   engines from the same weights and batch;
6c. the 32,768 pool x 512 dims of STRETCH.json, loss and backward, for
   REFERENCE_CONFIG, LOCAL/RAND and a two-sided radix config (GLOBAL/
   RELATIVE_HARD on both sides: 7 hist sweeps of two sides): sim cache on
   and off bit for bit, ``pos_topk`` 8 and 0 equal; all five kernels
   (cached and recompute) launched twice give the same bits; each
   kernel's time per call (and, as in phase 6, against cuBLAS), the hist
   kernel's early return, and ``torch.amax`` over the cache as a read-rate
   yardstick for the cached sweeps;
7. a ``{"kernels": [...]}`` line (launches of the serving kernels from
   phase 4, of the training kernels from phase 5, of ``lrn_bwd`` from
   the phase-5b recompute step, of the blockwise kernels from phase
   6b); then the card line; then the last line
   ``{"ok": true, "device": {...}}``.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS = {"fp32": 67e12, "bf16": 989e12, "int8": 1979e12}

TOL = {
    # fp32: same operation order as the plain version; rsqrt/exp/log may
    # differ by an ulp between the kernel and torch's own kernels.
    "stem_fp32": 1e-5,
    # bf16 storage: one bf16 ulp (2^-8 relative) at values up to ~4.
    "stem_bf16": 3e-2,
    # LRN training kernels in bf16: dx ~ g * f reaches |7| on randn
    # inputs, where one bf16 ulp is 2^-5; one ulp below 8 is 2^-4.
    "lrn_train_bf16": 6.25e-2,
    # probe scores: fp32 sums over D=1024 in another order.
    "probe": 1e-5,
    # card vs CPU, one training step of googlenet_pallas at batch 8
    # (fp32, TF32 off): the loss relative; each parameter's gradient error
    # relative to the norm of the whole step gradient — cuDNN and the CPU
    # sum ~60 convolutions in other orders (see check_train_step).
    "step_loss_rel": 1e-5,
    "step_grad_rel": 1e-3,
    # REFERENCE_CONFIG loss, card vs CPU, each from its own matmul.
    "mining_loss": 1e-5,
}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    if not lines:
        fail("nvidia-smi printed no card")
    return lines[0]


class Timer:
    """Median device time of one call, L2 flushed before each launch."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(32 << 20, dtype=torch.float32,
                                 device="cuda")  # 128 MB > 50 MB L2

    def ms(self, fn, iters: int = 15, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(statistics.median(times))


def library_ms(timer, fn):
    """Time of the one PyTorch call that computes the same function (a
    yardstick, used nowhere in the port); None where there is none or
    PyTorch has no kernel for the dtype."""
    if fn is None:
        return None
    try:
        return timer.ms(fn)
    except (RuntimeError, NotImplementedError) as e:
        log(f"[kernel] library call unavailable: {e}")
        return None


def bound_ms(nbytes: float, ops: float, kind: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def synthetic_gallery(seed: int, n: int = 60502, ids: int = 11316,
                      dim: int = 1024):
    """Unit rows, each its identity's random centre plus noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sizes = 5 + (np.arange(ids) < n - 5 * ids)
    labels = np.repeat(np.arange(ids, dtype=np.int32), sizes)
    rng.shuffle(labels)
    centres = rng.standard_normal((ids, dim), dtype=np.float32)
    centres /= np.linalg.norm(centres, axis=1, keepdims=True)
    noise = rng.standard_normal((n, dim), dtype=np.float32)
    noise *= 0.5 / np.sqrt(dim)
    emb = centres[labels] + noise
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    return emb.astype(np.float32), labels


# -- phase 3: stem kernels ----------------------------------------------------


def same_nan_and_bits(torch, a, b) -> bool:
    """Equal as torch.equal, with NaN in the same places."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and bool(
        torch.equal(a.masked_fill(na, 0), b.masked_fill(nb, 0)))


def with_nans(x, step: int = 997):
    """A copy of x with NaN planted every ``step`` elements."""
    xn = x.clone()
    xn.view(-1)[::step] = float("nan")
    return xn


def pool_matches_plain(torch, stem, x, bias, nan_step: int = 997,
                       window: int = 3, stride: int = 2) -> bool:
    """The pool kernel gives the plain version's bits on x and on x with
    NaN planted, NaN positions included (one add and maxima: no rounding
    order)."""
    return all(same_nan_and_bits(
        torch, stem.fused_bias_relu_pool(t, bias, window, stride),
        stem.bias_relu_pool_plain(t, bias, window, stride))
        for t in (x, with_nans(x, nan_step)))


def check_stem(torch, timer, detail, batch=32, key="stem"):
    """The forward stem kernels at ``batch`` (32: one serving bucket;
    120: one training batch)."""
    import torch.nn.functional as F

    from npairloss_tpu_torch.ops import stem

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {"lrn": [], "bias_relu": [], "bias_relu_pool": []}
    for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        tol = TOL[f"stem_{tag}"]
        size = 4 if tag == "fp32" else 2
        for c in (64, 192):
            shape = (batch, 56, 56, c)
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            b = torch.randn((c,), generator=gen, device="cuda") * 0.1
            n = x.numel()
            for name, kern, plain, args, lib in (
                    ("lrn", stem.lrn_fwd, stem.lrn_plain, (x,),
                     lambda: F.local_response_norm(
                         x.permute(0, 3, 1, 2), 5, 1e-4, 0.75, 1.0)),
                    ("bias_relu", stem.fused_bias_relu,
                     stem.bias_relu_plain, (x, b), None)):
                got = kern(*args)
                want = plain(*args)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                if not err <= tol:
                    fail(f"{name} {tag} {shape}: max_abs_err {err} > {tol}")
                if name == "bias_relu":  # NaN kept, as the plain version
                    xn = with_nans(x)
                    if not torch.equal(torch.isnan(kern(xn, b)),
                                       torch.isnan(plain(xn, b))):
                        fail(f"bias_relu {tag} {shape}: NaN positions "
                             "differ from the plain version")
                nbytes = 2 * n * size + (4 * c if name == "bias_relu" else 0)
                ops = n * (14 if name == "lrn" else 2)
                bms, by = bound_ms(nbytes, ops, "fp32")
                row = {"shape": list(shape), "dtype": tag,
                       "max_abs_err": err, "tol": tol,
                       "ms": timer.ms(lambda: kern(*args)),
                       "plain_ms": timer.ms(lambda: plain(*args)),
                       "bound_ms": bms, "bound_by": by,
                       "library_ms": library_ms(timer, lib)}
                rows[name].append(row)
                log(f"[kernel] {name} {tag} {shape}: {json.dumps(row)}")
        shape = (batch, 112, 112, 64)
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        b = torch.randn((64,), generator=gen, device="cuda") * 0.1
        got = stem.fused_bias_relu_pool(x, b)
        want = stem.bias_relu_pool_plain(x, b)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if not pool_matches_plain(torch, stem, x, b):
            fail(f"bias_relu_pool {tag} {shape}: not the plain version's "
                 "bits")
        nbytes = (x.numel() + got.numel()) * size + 4 * 64
        bms, by = bound_ms(nbytes, 9 * 2 * got.numel(), "fp32")
        xcl = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC memory
        row = {"shape": list(shape), "dtype": tag, "max_abs_err": err,
               "tol": 0.0,
               "ms": timer.ms(lambda: stem.fused_bias_relu_pool(x, b)),
               "plain_ms": timer.ms(
                   lambda: stem.bias_relu_pool_plain(x, b)),
               "bound_ms": bms, "bound_by": by, "library_ms": None,
               # F.max_pool2d over a channels_last tensor of the same
               # shape reads and writes the same bytes: a read-rate
               # yardstick, not the same function.
               "max_pool2d_yardstick_ms": timer.ms(
                   lambda: F.max_pool2d(xcl, 3, 2, padding=1))}
        rows["bias_relu_pool"].append(row)
        log(f"[kernel] bias_relu_pool {tag} {shape}: {json.dumps(row)}")
    detail[key] = rows
    return rows


# -- phase 3b: LRN training kernels -------------------------------------------


def check_lrn_train(torch, timer, detail):
    """lrn_fwd_cached, lrn_bwd_cached and lrn_bwd at the training path's
    shapes, against their plain versions; cached and recompute dx must be
    the same bits."""
    import torch.nn.functional as F

    from npairloss_tpu_torch.ops import stem

    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = {"lrn_fwd_cached": [], "lrn_bwd_cached": [], "lrn_bwd": []}
    for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        tol = TOL["stem_fp32"] if tag == "fp32" else TOL["lrn_train_bf16"]
        size = 4 if tag == "fp32" else 2
        for c in (64, 192):
            shape = (120, 56, 56, c)
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            n = x.numel()
            out, d = stem.lrn_fwd_cached(x)
            out_p, d_p = stem.lrn_fwd_cached_plain(x)
            dx_c = stem.lrn_bwd_cached(x, g, d)
            dx_r = stem.lrn_bwd(x, g)
            dx_p = stem.lrn_bwd_plain(x, g, d_p)
            torch.cuda.synchronize()
            if not torch.equal(dx_c, dx_r):
                fail(f"lrn_bwd_cached and lrn_bwd differ {tag} {shape}")
            errs = {
                "lrn_fwd_cached": max(
                    (out.float() - out_p.float()).abs().max().item(),
                    (d - d_p).abs().max().item()),
                "lrn_bwd_cached": (dx_c.float() - dx_p.float()).abs().max()
                .item(),
                "lrn_bwd": (dx_r.float() - dx_p.float()).abs().max().item(),
            }
            for name, err in errs.items():
                if not err <= tol:
                    fail(f"{name} {tag} {shape}: max_abs_err {err} > {tol}")
            # The library yardstick: F.local_response_norm forward, and its
            # backward alone through autograd on a saved graph.
            xl = x.detach().requires_grad_()
            try:
                yl = F.local_response_norm(xl.permute(0, 3, 1, 2), 5, 1e-4,
                                           0.75, 1.0)
                gl = g.permute(0, 3, 1, 2)
                lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
                    yl, xl, gl, retain_graph=True)
            except (RuntimeError, NotImplementedError) as e:
                log(f"[kernel] library LRN graph unavailable: {e}")
                lib_bwd = None
            lib_fwd = lambda: F.local_response_norm(  # noqa: E731
                x.permute(0, 3, 1, 2), 5, 1e-4, 0.75, 1.0)
            cases = (
                ("lrn_fwd_cached", lambda: stem.lrn_fwd_cached(x),
                 lambda: stem.lrn_fwd_cached_plain(x), n * (2 * size + 4),
                 14 * n, lib_fwd),
                ("lrn_bwd_cached", lambda: stem.lrn_bwd_cached(x, g, d),
                 lambda: stem.lrn_bwd_plain(x, g, d), n * (3 * size + 4),
                 24 * n, lib_bwd),
                ("lrn_bwd", lambda: stem.lrn_bwd(x, g),
                 lambda: stem.lrn_bwd_plain(x, g), n * 3 * size, 36 * n,
                 lib_bwd),
            )
            for name, kern, plain, nbytes, ops, lib in cases:
                bms, by = bound_ms(nbytes, ops, "fp32")
                row = {"shape": list(shape), "dtype": tag,
                       "max_abs_err": errs[name], "tol": tol,
                       "ms": timer.ms(kern), "plain_ms": timer.ms(plain),
                       "bound_ms": bms, "bound_by": by,
                       "library_ms": library_ms(timer, lib)}
                rows[name].append(row)
                log(f"[kernel] {name} {tag} {shape}: {json.dumps(row)}")
            del xl, lib_bwd
    log("[kernel] lrn_bwd_cached == lrn_bwd bit for bit at every shape")
    detail["lrn_train"] = rows
    return rows


def check_stem_scalar_paths(torch, detail, seed: int = 5):
    """The LRN backward and bias+ReLU+pool kernels off their vector paths:
    C = 100 (bf16: not a multiple of the 8-wide vector) with odd H/W (the
    asymmetric SAME pads), and operands one element off 16-byte alignment;
    and the pool's general kernel at a 7 x 7 / s2 window on aligned
    operands.  The pool must give the plain version's bits, NaN positions
    included; the LRN dx cached = recompute bit for bit and within the
    phase-3b tolerance of the plain version."""
    from npairloss_tpu_torch.ops import stem

    gen = torch.Generator(device="cuda").manual_seed(seed)
    tols = {"fp32": TOL["stem_fp32"], "bf16": TOL["lrn_train_bf16"]}
    rows = []
    for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        for shape, offset in (((2, 7, 9, 100), 0), ((2, 7, 9, 100), 1)):
            n = shape[0] * shape[1] * shape[2] * shape[3]

            def make():
                buf = torch.randn(n + offset, generator=gen, device="cuda")
                return buf.to(dtype)[offset:].view(shape)

            x, g = make(), make()
            b = torch.randn((shape[3],), generator=gen, device="cuda")
            _, d = stem.lrn_fwd_cached(x)
            dx_c = stem.lrn_bwd_cached(x, g, d)
            err = (dx_c.float() - stem.lrn_bwd_plain(x, g, d).float()
                   ).abs().max().item()
            same = bool(torch.equal(dx_c, stem.lrn_bwd(x, g)))
            pool = pool_matches_plain(torch, stem, x, b, nan_step=97)
            rows.append({"kernel": "scalar_paths", "shape": list(shape),
                         "dtype": tag, "offset_elems": offset,
                         "lrn_max_abs_err": err,
                         "lrn_cached_equals_recompute": same,
                         "pool_same_bits_as_plain": pool,
                         "ok": same and pool and err <= tols[tag]})
        shape = (2, 15, 15, 64)
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        b = torch.randn((64,), generator=gen, device="cuda")
        pool = pool_matches_plain(torch, stem, x, b, nan_step=97, window=7)
        rows.append({"kernel": "pool_window_7_stride_2", "shape": list(shape),
                     "dtype": tag, "pool_same_bits_as_plain": pool,
                     "ok": pool})
    log(f"[kernel] scalar paths: {json.dumps(rows)}")
    bad = [r for r in rows if not r["ok"]]
    if bad:
        fail(f"stem kernels off their vector paths: {bad}")
    detail["stem_scalar_paths"] = rows


# -- phase 3: probe kernel ----------------------------------------------------


def check_probe_odd_dim(torch, detail):
    """The probe kernel's element-wise path: D = 100 is no multiple of a
    16-byte vector in any scoring dtype.  Ragged clusters, one empty."""
    from npairloss_tpu_torch.ops.ivf_probe import (
        NEG_FILL,
        probe_select,
        probe_topk,
        probe_topk_plain,
    )
    from npairloss_tpu_torch.serve.ivf import quantize_int8

    gen = torch.Generator(device="cuda").manual_seed(2)
    kc, cap, d, b = 5, 37, 100, 7
    packed = torch.randn((kc, cap, d), generator=gen, device="cuda")
    rows = torch.arange(kc * cap, dtype=torch.int32,
                        device="cuda").reshape(kc, cap)
    rows[1] = -1
    rows[3, 20:] = -1
    q = torch.randn((b, d), generator=gen, device="cuda")
    _, lids, owned = probe_select(q, torch.randn((kc, d), generator=gen,
                                                 device="cuda"),
                                  rows.max(1).values >= 0, 4, 0, kc)
    owned = owned.to(torch.int32).contiguous()
    errs = {}
    for scoring, (slab, scale) in (
            ("fp32", (packed, None)),
            ("bf16", (packed.to(torch.bfloat16), None)),
            ("int8", quantize_int8(packed))):
        args = (q, slab, rows, lids, owned, scale)
        s_k, r_k = probe_topk(*args, kl=10, scoring=scoring)
        s_p, r_p = probe_topk_plain(*args, kl=10, scoring=scoring)
        torch.cuda.synchronize()
        real = s_p > NEG_FILL * 0.5
        err = (s_k - s_p).abs()[real].max().item()
        if not err <= TOL["probe"] or not torch.equal(r_k[real], r_p[real]):
            fail(f"probe D=100 {scoring}: err {err}, rows differ: "
                 f"{not torch.equal(r_k[real], r_p[real])}")
        errs[scoring] = err
    log(f"[kernel] ivf_probe element-wise path (D=100): {json.dumps(errs)}")
    detail["probe_odd_dim"] = errs


def check_probe(torch, timer, index, queries, detail):
    import numpy as np

    from npairloss_tpu_torch.ops.ivf_probe import (
        NEG_FILL,
        probe_select,
        probe_topk,
        probe_topk_plain,
    )

    layout = index.layout
    q = torch.as_tensor(queries, device="cuda")
    probes, k = 8, 10
    _, lids, owned = probe_select(q, layout.centroids, layout.cluster_valid,
                                  probes, 0, layout.packed.shape[0])
    owned = owned.to(torch.int32).contiguous()
    cap, d = layout.cap, index.dim
    kl = min(k, probes * cap)
    lids_np = lids.cpu().numpy()
    valid_rows = int((layout.rows[lids.long()] >= 0).sum().item())
    out = {}
    for scoring in ("fp32", "bf16", "int8"):
        slab, scale = index.scored_arrays(scoring)
        args = (q, slab, layout.rows, lids, owned, scale)
        s_k, r_k = probe_topk(*args, kl=kl, scoring=scoring)
        s_p, r_p = probe_topk_plain(*args, kl=kl, scoring=scoring)
        torch.cuda.synchronize()
        real = s_p > NEG_FILL * 0.5
        err = (s_k - s_p).abs()[real].max().item()
        if not err <= TOL["probe"]:
            fail(f"probe {scoring}: max_abs_err {err} > {TOL['probe']}")
        # Rows must agree except inside a score tie (within 2 tol).
        sp = s_p.cpu().numpy()
        mism = (r_k != r_p).cpu().numpy() & real.cpu().numpy()
        gap = np.full(sp.shape, np.inf, np.float32)
        gap[:, 1:] = np.minimum(gap[:, 1:], np.abs(np.diff(sp, axis=1)))
        gap[:, :-1] = np.minimum(gap[:, :-1], np.abs(np.diff(sp, axis=1)))
        if (mism & (gap > 2 * TOL["probe"])).any():
            fail(f"probe {scoring}: rows differ outside score ties")
        el = slab.element_size()
        nbytes = (valid_rows * d * el + lids_np.size * cap * 4
                  + q.numel() * 4 + 2 * lids_np.size * 4
                  + q.shape[0] * kl * 8
                  + (lids_np.size * 4 if scale is not None else 0))
        bms, by = bound_ms(nbytes, 2.0 * valid_rows * d, scoring)
        row = {"batch": int(q.shape[0]), "probes": probes, "k": k,
               "cap": cap, "dim": d, "scoring": scoring,
               "probed_rows": valid_rows, "max_abs_err": err,
               "tol": TOL["probe"], "row_mismatches_in_ties": int(mism.sum()),
               "ms": timer.ms(lambda: probe_topk(*args, kl=kl,
                                                 scoring=scoring)),
               "plain_ms": timer.ms(lambda: probe_topk_plain(
                   *args, kl=kl, scoring=scoring)),
               "bound_ms": bms, "bound_by": by, "library_ms": None}
        out[scoring] = row
        log(f"[kernel] ivf_probe {scoring}: {json.dumps(row)}")
    detail["probe"] = out
    return out


# -- phase 4: the serving path ------------------------------------------------


def drive_path(torch, seed, index, emb, detail):
    import numpy as np

    from npairloss_tpu_torch.models import get_model
    from npairloss_tpu_torch.ops import _build
    from npairloss_tpu_torch.serve.batcher import BatcherConfig
    from npairloss_tpu_torch.serve.engine import EngineConfig, QueryEngine
    from npairloss_tpu_torch.serve.index import GalleryIndex
    from npairloss_tpu_torch.serve.ivf import topk_recall
    from npairloss_tpu_torch.serve.server import (
        Freshness,
        RetrievalServer,
        ServerConfig,
    )

    rng = np.random.default_rng(seed + 1)
    model = get_model("googlenet_pallas", device="cuda", seed=seed)
    cfg = EngineConfig(top_k=10, buckets=(1, 8, 32), probes=8,
                       probe_impl="fused")
    engine = QueryEngine(index, cfg, model=model)
    t0 = time.perf_counter()
    engine.warmup((224, 224, 3))
    log(f"[path] warmup {time.perf_counter() - t0:.3f} s")

    images = rng.standard_normal((8, 224, 224, 3), dtype=np.float32)
    gal_rows = rng.choice(emb.shape[0], size=30, replace=False)
    records = []
    for i, r in enumerate(gal_rows):
        records.append({"id": f"g{i}", "embedding": emb[r].tolist()})
        if i % 4 == 0 and i // 4 < len(images):
            records.append({"id": f"x{i // 4}",
                            "input": images[i // 4].tolist()})
    lines = [json.dumps(r) for r in records]
    lines.insert(17, "{this is not json")
    server = RetrievalServer(
        engine,
        BatcherConfig(max_batch=32, max_delay_ms=5.0, max_queue=256),
        ServerConfig(poll_s=0.01),
        freshness=Freshness.collect(index=index, index_path="synthetic"))
    out = io.StringIO()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    rc = server.run_jsonl(io.StringIO("\n".join(lines) + "\n"), out)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _build.launch_counts()
    log(f"[path] launches {json.dumps(launches)}")
    if rc != 0:
        fail(f"run_jsonl returned {rc}")
    answers = [json.loads(ln) for ln in out.getvalue().splitlines()]
    summary = answers[-1]
    by_id = {a.get("id"): a for a in answers[:-1]}
    if summary.get("event") != "serve_drain":
        fail("the last JSONL line is not the drain summary")
    bad = [a for a in answers[:-1] if a.get("id") is None]
    if len(bad) != 1 or "error" not in bad[0]:
        fail(f"the bad line must answer one error, got {bad}")
    for rec in records:
        a = by_id.get(rec["id"])
        if a is None or "error" in a or len(a["neighbors"]) != 10:
            fail(f"record {rec['id']} not answered: {a}")
        scores = [n["score"] for n in a["neighbors"]]
        if not all(np.isfinite(scores)) or scores != sorted(scores,
                                                            reverse=True):
            fail(f"record {rec['id']}: bad scores {scores}")
    for i, r in enumerate(gal_rows):
        top = by_id[f"g{i}"]["neighbors"][0]
        if top["row"] != int(r) or not top["score"] > 0.99:
            fail(f"gallery row {r}: top-1 is {top}")
    n_q = len(records)
    if not (summary["queries"] == n_q and summary["answered"] == n_q
            and summary["errors"] == 1 and summary["errors_refused"] == 1
            and summary["rejected"] == 0
            and summary["queries_dropped"] == 0
            and summary["queries"] == summary["answered"]
            + summary["errors"] - summary["errors_refused"]
            + summary["rejected"]):
        fail(f"drain invariant broken: {summary}")
    for name in ("lrn_fwd", "fused_bias_relu", "fused_bias_relu_pool",
                 "probe_topk"):
        if launches.get(name, 0) < 1:
            fail(f"kernel {name} was not launched on the path")
    log(f"[path] answered {summary['answered']} of {n_q} queries + 1 bad "
        f"line in {wall:.3f} s: p50 {summary['p50_ms']} ms, p99 "
        f"{summary['p99_ms']} ms, {n_q / wall:.1f} queries/s through "
        f"run_jsonl")

    # Steady-state IVF query throughput at the largest bucket.
    q32 = emb[gal_rows[:30]]
    q32 = np.concatenate([q32, emb[gal_rows[:2]]])
    for _ in range(3):
        engine.query(q32)
    torch.cuda.synchronize()
    reps = 50
    t0 = time.perf_counter()
    for _ in range(reps):
        engine.query(q32)
    qps = reps * 32 / (time.perf_counter() - t0)
    t_enc = time.perf_counter()
    engine.encode(images)
    enc_ms = (time.perf_counter() - t_enc) * 1e3
    log(f"[path] steady state: {qps:.1f} queries/s (fused IVF, bucket 32, "
        f"embedding queries); encode of 8 images {enc_ms:.3f} ms")

    # Exhaustive probing must reproduce the flat engine exactly.
    queries = np.concatenate([emb[gal_rows], engine.encode(images)])
    full = QueryEngine(index, EngineConfig(
        top_k=10, buckets=(1, 8, 32), probes=index.n_clusters,
        probe_impl="fused"))
    flat = QueryEngine(GalleryIndex.build(
        index.host_emb, index.host_labels, ids=index.ids, normalize=False,
        device="cuda"), EngineConfig(top_k=10, buckets=(1, 8, 32)))
    recall = topk_recall(full.query(queries)["rows"],
                         flat.query(queries)["rows"])
    log(f"[path] probes=clusters ({index.n_clusters}) vs flat: "
        f"topk_recall {recall}")
    if recall != 1.0:
        fail(f"exhaustive IVF recall {recall} != 1.0")

    # The trunk on the card (kernels, fp32) against the trunk on the CPU
    # (plain versions, fp32) on the same weights and two images.
    m_gpu = get_model("googlenet_pallas", device="cuda", seed=seed,
                      dtype=torch.float32)
    m_cpu = get_model("googlenet_pallas", device="cpu", seed=seed,
                      dtype=torch.float32)
    m_cpu.load_state_dict(m_gpu.state_dict())
    x2 = torch.as_tensor(images[:2])
    with torch.inference_mode():
        e_gpu = m_gpu(x2.cuda()).cpu()
        e_cpu = m_cpu(x2)
        e_bf16 = model(x2.cuda()).float().cpu()
    enc_err = (e_gpu - e_cpu).abs().max().item()
    cos_bf16 = (e_bf16 * e_cpu).sum(1).min().item()
    log(f"[path] trunk fp32 card vs CPU: max_abs_err {enc_err}; bf16 card "
        f"vs fp32 CPU: min cosine {cos_bf16}")
    if not enc_err <= 1e-4 or not cos_bf16 > 0.99:
        fail("trunk on the card disagrees with the CPU reference")
    detail["path"] = {"summary": summary, "launches": launches,
                      "wall_s": wall, "steady_qps": qps,
                      "encode8_ms": enc_ms, "recall_full": recall,
                      "trunk_fp32_err": enc_err, "trunk_bf16_cos": cos_bf16}
    return launches, summary, qps


# -- phase 5: the training path -----------------------------------------------


def drive_train(torch, seed, detail):
    """``npairloss_tpu_torch.cli train`` on the shipped GoogLeNet/CUB
    solver, cut to 6 iterations: googlenet_pallas, batch 120 (60 x 2),
    224x224, fp32, synthetic identity batches."""
    import contextlib
    import math
    import re

    from npairloss_tpu_torch import cli
    from npairloss_tpu_torch.data.synthetic import synthetic_identity_batches
    from npairloss_tpu_torch.ops import _build
    from npairloss_tpu_torch.train import solver as tsolver

    work = os.path.join("build", "train_smoke")
    os.makedirs(work, exist_ok=True)
    text = open(os.path.join("examples", "googlenet_cub_solver.prototxt")
                ).read()
    for key, val in (("max_iter", 6), ("test_iter", 2), ("display", 1),
                     ("snapshot", 0)):
        text, n = re.subn(rf"(?m)^{key}:.*$", f"{key}: {val}", text)
        if n != 1:
            fail(f"solver prototxt has {n} '{key}:' lines")
    solver_path = os.path.join(work, "solver.prototxt")
    events_path = os.path.join(work, "events.jsonl")
    with open(solver_path, "w") as f:
        f.write(text)
    if os.path.exists(events_path):
        os.remove(events_path)

    # Time each Solver.step between two synchronizes, and read the
    # launch counters when the first step starts (after the iter-0 TEST).
    seen = {"solver": None, "after_test": None, "ms": []}
    orig_step = tsolver.Solver.step

    def timed_step(self, inputs, labels):
        if seen["after_test"] is None:
            seen["after_test"] = _build.launch_counts()
        seen["solver"] = self
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = orig_step(self, inputs, labels)
        torch.cuda.synchronize()
        seen["ms"].append((time.perf_counter() - t0) * 1e3)
        return m

    out = io.StringIO()
    tsolver.Solver.step = timed_step
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(["train", "--solver", solver_path, "--net",
                           "examples/googlenet_cub.prototxt", "--model",
                           "googlenet_pallas", "--synthetic", "--log-json",
                           events_path, "--seed", str(seed)])
        torch.cuda.synchronize()
    finally:
        tsolver.Solver.step = orig_step
    wall = time.perf_counter() - t0
    total = _build.launch_counts()
    for ln in out.getvalue().splitlines():
        log(f"[train] {ln}")
    if rc != 0:
        fail(f"train returned {rc}")
    final = json.loads(out.getvalue().strip().splitlines()[-1])
    events = [json.loads(ln) for ln in open(events_path)]
    displays = [e for e in events if e["event"] == "display"]
    tests = [e for e in events if e["event"] == "test"]
    if [e["iteration"] for e in displays] != [1, 2, 3, 4, 5, 6] \
            or [e["iteration"] for e in tests] != [0]:
        fail(f"unexpected event stream: {[(e['event'], e['iteration']) for e in events]}")
    for rec in events + [final]:
        bad = {k: v for k, v in rec.items()
               if isinstance(v, float) and not math.isfinite(v)}
        if bad:
            fail(f"non-finite values in {rec.get('event', 'final')}: {bad}")
    after_test = seen["after_test"]
    in_train = {k: total[k] - after_test[k] for k in total}
    log(f"[train] launches during the iter-0 TEST {json.dumps(after_test)}; "
        f"during the 6 train steps {json.dumps(in_train)}")
    if after_test["lrn_fwd"] < 1 or after_test["lrn_fwd_cached"] != 0:
        fail("the TEST forward did not run the uncached LRN kernel alone")
    for name in ("lrn_fwd_cached", "lrn_bwd_cached", "fused_bias_relu",
                 "fused_bias_relu_pool"):
        if in_train[name] < 1:
            fail(f"kernel {name} was not launched by the train steps")
    solver = seen["solver"]
    zero = [n for n, p in solver.params.items()
            if p.grad is None or not bool((p.grad != 0).any())]
    if zero or "conv1.Conv_0.weight" not in solver.params:
        fail(f"parameters without a gradient after a step: {zero}")
    # The solver keeps the host off the card inside a step (metrics stay
    # on the device, the batch goes up asynchronously from pinned
    # memory): one more step with PyTorch's sync debug mode at "error"
    # raises on any synchronizing call.
    x, lab = next(synthetic_identity_batches(240, 60, 2, (224, 224, 3),
                                             seed=seed + 5))
    solver.step(x, lab)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        solver.step(x, lab)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("[train] a step under torch.cuda.set_sync_debug_mode('error') made "
        "no host sync")
    step_ms = statistics.median(seen["ms"][1:])
    batch = 120
    log(f"[train] {len(solver.params)} parameters, all with a nonzero "
        f"gradient; step ms {[round(t, 3) for t in seen['ms']]}; median "
        f"over steps 2-6 {step_ms:.3f} ms = {batch / step_ms * 1e3:.1f} "
        f"images/s; whole command {wall:.1f} s")
    detail["train"] = {"final": final, "events": events,
                       "launches_test": after_test,
                       "launches_train": in_train, "step_ms": seen["ms"],
                       "median_step_ms": step_ms,
                       "images_per_s": batch / step_ms * 1e3, "wall_s": wall,
                       "profile": profile_train_step(torch, solver, x, lab),
                       "upload": compare_batch_upload(torch, solver, seed)}
    return in_train, step_ms


def compare_batch_upload(torch, solver, seed, steps=6):
    """The solver's batch upload (pinned memory, asynchronous copy)
    against a synchronous copy from pageable memory: median ms of
    ``steps`` synchronized steps on the same fresh batches, in turns
    pinned, pageable, pageable, pinned.  A measurement, not a check."""
    import numpy as np

    from npairloss_tpu_torch.data.synthetic import synthetic_identity_batches
    from npairloss_tpu_torch.train import solver as tsolver

    gen = synthetic_identity_batches(240, 60, 2, (224, 224, 3),
                                     seed=seed + 6)
    batches = [next(gen) for _ in range(steps)]

    def pageable(self, inputs, labels):
        return (torch.as_tensor(np.asarray(inputs), device=self.device),
                torch.as_tensor(np.asarray(labels), device=self.device))

    pinned = tsolver.Solver._put
    out = {"pinned": [], "pageable": []}
    try:
        for name in ("pinned", "pageable", "pageable", "pinned"):
            tsolver.Solver._put = pinned if name == "pinned" else pageable
            ms = []
            for x, lab in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                solver.step(x, lab)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            out[name].append(statistics.median(ms))
    finally:
        tsolver.Solver._put = pinned
    log(f"[upload] median step ms, pinned + async copy {out['pinned']} vs "
        f"pageable + sync copy {out['pageable']}")
    return out


# Kernel-name patterns of a training step's device time, first match wins.
STEP_CATEGORIES = (
    ("blockwise kernels (csrc/npair_blockwise.cu)", ("npair_",)),
    ("stem kernels (csrc/stem.cu)", ("lrn_fwd_kernel", "lrn_bwd_kernel",
                                     "lrn_bwd_vec_kernel", "bias_relu")),
    ("host-device copies", ("memcpy",)),
    ("pooling", ("pool",)),
    ("layout transposes", ("nhwc", "nchw", "transpose")),
    ("convolution (cuDNN)", ("conv", "xmma", "implicit", "wgrad", "dgrad",
                             "fprop", "winograd", "fft", "cudnn")),
    ("matmul (cuBLAS)", ("gemm", "gemv", "cutlass")),
)


def profile_train_step(torch, solver, x, lab, steps=3):
    """Where a step's device time goes: ``torch.profiler`` over ``steps``
    more steps of the phase-5 solver on one batch, kernels grouped by
    name.  A measurement, not a check: with no device records it says
    'not measured'."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            solver.step(x, lab)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.events() if e.device_type == cuda]
    if not kernels:
        log("[profile] the profiler recorded no device time: not measured")
        return None
    by_cat, by_name = {}, {}
    for e in kernels:
        ms = (e.time_range.end - e.time_range.start) / 1e3 / steps
        name = e.name.lower()
        cat = next((c for c, pats in STEP_CATEGORIES
                    if any(p in name for p in pats)), "elementwise and other")
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
    busy = sum(by_cat.values())
    log(f"[profile] per step: wall {wall:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / wall:.1f} %, idle {100 * (1 - busy / wall):.1f} %)")
    for cat, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        log(f"[profile]   {cat}: {ms:.3f} ms ({100 * ms / busy:.1f} %)")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    for name, ms in top:
        log(f"[profile]   top kernel {ms:.3f} ms  {name[:110]}")
    return {"wall_ms": wall, "busy_ms": busy, "by_category_ms": by_cat,
            "top_kernels_ms": dict(top)}


def _grads(torch, model, x, lab, cfg):
    """Loss and every parameter gradient of one step's forward/backward
    (no update)."""
    from npairloss_tpu_torch.ops.npair_loss import npair_loss

    for p in model.parameters():
        p.grad = None
    loss = npair_loss(model(x), lab, cfg)
    loss.backward()
    return loss.detach(), {n: p.grad.detach().clone()
                           for n, p in model.named_parameters()}


def check_train_step(torch, seed, detail):
    """Phase 5b: one step with the LRN cache on and off (bitwise equal
    gradients), then the same step at batch 8 on the card and on the CPU."""
    import numpy as np

    from npairloss_tpu_torch.data.synthetic import synthetic_identity_batches
    from npairloss_tpu_torch.models import get_model
    from npairloss_tpu_torch.ops import _build, stem
    from npairloss_tpu_torch.ops.npair_loss import NPairLossConfig

    cfg = NPairLossConfig()  # googlenet_cub.prototxt: LOCAL/RAND both sides
    model = get_model("googlenet_pallas", device="cuda", seed=seed,
                      dtype=torch.float32)
    x_np, lab_np = next(synthetic_identity_batches(240, 60, 2,
                                                   (224, 224, 3), seed=seed))
    x = torch.as_tensor(x_np, device="cuda")
    lab = torch.as_tensor(lab_np, device="cuda")
    budget = stem.LRN_CACHE_AUTO_BYTES
    cudnn = torch.backends.cudnn
    det, bench = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        _build.reset_launch_counts()
        loss_c, g_c = _grads(torch, model, x, lab, cfg)
        cached = _build.launch_counts()
        stem.LRN_CACHE_AUTO_BYTES = 0
        _build.reset_launch_counts()
        loss_r, g_r = _grads(torch, model, x, lab, cfg)
        recompute = _build.launch_counts()
    finally:
        stem.LRN_CACHE_AUTO_BYTES = budget
        cudnn.deterministic, cudnn.benchmark = det, bench
    torch.cuda.synchronize()
    if cached["lrn_bwd_cached"] != 2 or cached["lrn_bwd"] != 0 \
            or recompute["lrn_bwd"] != 2 or recompute["lrn_bwd_cached"] != 0:
        fail(f"cache switch did not pick the kernels: cached {cached}, "
             f"recompute {recompute}")
    differ = [n for n in g_c if not torch.equal(g_c[n], g_r[n])]
    if differ or not torch.equal(loss_c, loss_r):
        fail(f"cached vs recompute step: gradients differ in {differ}")
    log(f"[step] batch 120: LRN cache on and off give bit-identical loss "
        f"and {len(g_c)} parameter gradients (lrn_bwd_cached "
        f"{cached['lrn_bwd_cached']} vs lrn_bwd {recompute['lrn_bwd']} "
        f"launches)")
    del g_c, g_r

    # The card's step against the CPU's.  A random BN-free GoogLeNet maps
    # all images to nearly one embedding, so each parameter's gradient is
    # a sum of near-equal per-image terms that cancel: measured against
    # its OWN norm, rounding alone moves a gradient by up to a few 1e-3
    # (the CPU's two convolution backends, oneDNN and native, already
    # differ by 2.5e-3 on this step).  So each parameter's error is held
    # against the norm of the whole step gradient (the scale of the
    # update it feeds); its own-norm error is printed beside it.  Zero
    # biases and flat-colour images (one random colour each) keep the
    # trunk furthest from collapse (oneDNN vs native on the CPU: 1e-4 by
    # this measure); the init's 0.2 biases on noise images put even this
    # measure at 6e-3 card vs CPU.
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
    m_cpu = get_model("googlenet_pallas", device="cpu", seed=seed,
                      dtype=torch.float32)
    m_cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    rng = np.random.default_rng(seed + 11)
    x8 = torch.as_tensor(rng.uniform(-3, 3, (8, 1, 1, 3)).astype(
        np.float32)).expand(8, 224, 224, 3).contiguous()
    lab8 = torch.as_tensor(np.repeat(np.arange(4), 2))
    loss_g, g_g = _grads(torch, model, x8.cuda(), lab8.cuda(), cfg)
    loss_h, g_h = _grads(torch, m_cpu, x8, lab8, cfg)
    loss_rel = abs(loss_g.item() - loss_h.item()) / max(abs(loss_h.item()),
                                                        1e-30)
    total = torch.sqrt(sum(g.double().pow(2).sum() for g in g_h.values()))
    diff = {n: (g_g[n].cpu() - g_h[n]).double().norm() for n in g_h}
    grad_rel = {n: (d / total).item() for n, d in diff.items()}
    own_rel = {n: (d / g_h[n].double().norm().clamp_min(1e-30)).item()
               for n, d in diff.items()}
    worst = max(grad_rel, key=grad_rel.get)
    worst_own = max(own_rel, key=own_rel.get)
    log(f"[step] batch 8 card vs CPU: loss {loss_g.item():.8g} vs "
        f"{loss_h.item():.8g} (rel {loss_rel:.3g}); worst gradient error "
        f"over the step's gradient norm {grad_rel[worst]:.3g} ({worst}); "
        f"over its own norm {own_rel[worst_own]:.3g} ({worst_own})")
    if not loss_rel <= TOL["step_loss_rel"] \
            or not grad_rel[worst] <= TOL["step_grad_rel"]:
        fail("the training step on the card disagrees with the CPU")
    detail["train_step"] = {"cache_launches": cached,
                            "recompute_launches": recompute,
                            "batch8_loss_rel": loss_rel,
                            "batch8_grad_rel_max": grad_rel[worst],
                            "batch8_worst_param": worst,
                            "batch8_own_rel_max": own_rel[worst_own],
                            "batch8_worst_own_param": worst_own}
    return recompute


def check_reference_mining(torch, seed, detail):
    """Phase 5c: REFERENCE_CONFIG (GLOBAL/RELATIVE_HARD AP, LOCAL/HARD
    AN) on 120 x 1024 unit features: from the card's sims, thresholds,
    masks and counts equal the CPU's exactly; the loss within 1e-5."""
    import numpy as np

    from npairloss_tpu_torch.ops import npair_loss as nl

    rng = np.random.default_rng(seed + 7)
    feats = rng.standard_normal((120, 1024)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    labels = rng.permutation(np.repeat(np.arange(60), 2)).astype(np.int64)
    cfg = nl.REFERENCE_CONFIG
    f_g = torch.as_tensor(feats, device="cuda")
    l_g = torch.as_tensor(labels, device="cuda")
    sims_g = f_g @ f_g.T

    def mine(sims, lab):
        same, diff = nl.pair_masks(lab, lab, 0, lab.shape[0])
        pos, neg, mx = nl.mining_thresholds(sims, same, diff, cfg)
        sel = nl.selection_mask(sims, same, diff, pos, neg, cfg)
        return {"same": same, "diff": diff, "pos_thr": pos, "neg_thr": neg,
                "max_all": mx, "sel": sel,
                "ident_num": (same & sel).sum(1), "diff_num": (diff & sel).sum(1)}

    got = mine(sims_g, l_g)
    want = mine(sims_g.cpu(), l_g.cpu())
    differ = [k for k in want if not torch.equal(got[k].cpu(), want[k])]
    if differ:
        fail(f"REFERENCE_CONFIG mining differs card vs CPU in {differ}")
    loss_g = nl.npair_loss(f_g, l_g, cfg).item()
    loss_h = nl.npair_loss(torch.as_tensor(feats), torch.as_tensor(labels),
                           cfg).item()
    log(f"[mining] REFERENCE_CONFIG from the card's sims: thresholds, masks "
        f"and counts equal the CPU's ({int(got['ident_num'].sum())} "
        f"positive, {int(got['diff_num'].sum())} negative pairs); loss "
        f"{loss_g:.8g} vs CPU {loss_h:.8g}")
    if not abs(loss_g - loss_h) <= TOL["mining_loss"]:
        fail(f"REFERENCE_CONFIG loss differs: {loss_g} vs {loss_h}")
    detail["reference_mining"] = {"loss_gpu": loss_g, "loss_cpu": loss_h,
                                  "pairs_pos": int(got["ident_num"].sum()),
                                  "pairs_neg": int(got["diff_num"].sum())}


# -- phase 6: the blockwise N-pair kernels ------------------------------------

BLOCKWISE_KERNELS = ("npair_stats", "npair_hist", "npair_loss", "npair_gq",
                     "npair_gdb")


def unit_batch(torch, seed, n, d):
    """n unit rows on the card in n/2 identities of 2, shuffled."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    f = torch.randn((n, d), generator=gen, device="cuda")
    f = (f / f.norm(dim=1, keepdim=True)).contiguous()
    lab = (torch.randperm(n, generator=gen, device="cuda") // 2).to(
        torch.int32)
    return f, lab


def _rel_close(a, b):
    """max |a - b| / |b| over entries."""
    diff = (a - b).abs()
    scale = b.abs().clamp_min(1e-30)
    return float((diff / scale).max().item()) if diff.numel() else 0.0


def _abs_err(torch, a, b):
    """max |a - b| over entries in fp64; equal entries add 0, so +-FLT_MAX
    paddings that agree count as agreeing."""
    a, b = a.double(), b.double()
    diff = torch.where(a == b, 0.0, (a - b).abs())
    return float(diff.max().item()) if diff.numel() else 0.0


def _same_bits(torch, a, b, what):
    """Fail unless two launches on the same inputs gave the same bits
    (tensors, or tuples of tensors and Nones)."""
    if isinstance(a, torch.Tensor):
        a, b = (a,), (b,)
    for x, y in zip(a, b):
        if (x is None) != (y is None) or (
                x is not None and not torch.equal(x, y)):
            fail(f"{what}: two launches on the same inputs differ")


def _vs_cublas(ms, cublas_ms, flop):
    """A fused sweep's time as a multiple of cuBLAS's bare fp32 product
    in the same run, and its share of the 67 TFLOP/s fp32 peak."""
    return {"x_cublas": ms / cublas_ms,
            "fp32_peak_share": flop / (ms * 1e-3) / PEAK_OPS["fp32"]}


def check_blockwise_kernels(torch, timer, detail, seed,
                            sizes=((120, 1024), (8192, 1024))):
    """The five kernels of csrc/npair_blockwise.cu against their plain
    sweeps on the card.  From the stats kernel's own emitted sims the
    plain stats, hist and loss sweeps must give bit-equal minima, maxima,
    counts, histograms and K-slot buffers; I/D sums within 1e-4
    relative, gq/gdb within 1e-5 (N = 120) or 1e-4 (N = 8192) of their
    largest entry (the plain sweeps sum in cuBLAS's and torch's order);
    the emitted sims within 1e-5 of ``feats @ feats.T`` (cuBLAS, TF32
    off); cached and recompute variants bit for bit, and each launched
    twice the same bits.  Each row's
    ``max_abs_err`` is the largest absolute difference kernel vs plain
    over the outputs this run compared.  ``timer`` None: check only."""
    from npairloss_tpu_torch.ops import blockwise_npair as bw
    from npairloss_tpu_torch.ops import npair_loss as nl
    from npairloss_tpu_torch.ops.rank_select import sortable_key

    mm = nl.MiningMethod
    cfgs = {"reference": nl.REFERENCE_CONFIG,
            "local_rand": nl.NPairLossConfig(),
            "relative": nl.NPairLossConfig(
                ap_mining_method=mm.RELATIVE_EASY, identsn=-0.5,
                an_mining_method=mm.RELATIVE_HARD, diffsn=-0.3)}
    rows = {k: [] for k in BLOCKWISE_KERNELS}
    out = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n, d in sizes:
        f, lab = unit_batch(torch, seed + n, n, d)
        grad_tol = 1e-5 if n <= 120 else 1e-4
        bn = bm = min(512, n)
        # The plain loss sweep in the kernel's I/D order on this card.
        splits = bw.pool_splits(n, n, sms)
        rec = {"n": n, "d": d, "hist_loss_splits": splits}
        # -- stats, every option on
        st = bw.npair_stats(f, lab, f, lab, hist_same=True, hist_diff=True,
                            topk=8, emit_sims=True)
        st_r = bw.npair_stats(f, lab, f, lab, hist_same=True,
                              hist_diff=True, topk=8)
        st_2 = bw.npair_stats(f, lab, f, lab, hist_same=True,
                              hist_diff=True, topk=8, emit_sims=True)
        _same_bits(torch, st, st_2, f"npair_stats N={n}")
        del st_2
        sims = st.sims
        ref = f @ f.T
        torch.cuda.synchronize()
        rec["sims_vs_cublas"] = (sims - ref).abs().max().item()
        if not rec["sims_vs_cublas"] <= 1e-5:
            fail(f"npair_stats N={n}: emitted sims off cuBLAS by "
                 f"{rec['sims_vs_cublas']}")
        pst = bw.stats_plain(f, lab, f, lab, hist_same=True, hist_diff=True,
                             topk=8, sims=sims, bn=bn, bm=bm)
        errs = [rec["sims_vs_cublas"]]
        for name in bw.Stats._fields[:8]:
            errs.append(_abs_err(torch, getattr(st, name), getattr(pst, name)))
            if not torch.equal(getattr(st, name), getattr(pst, name)):
                fail(f"npair_stats N={n}: {name} differs from the plain "
                     "sweep on the kernel's sims")
            if not torch.equal(getattr(st, name), getattr(st_r, name)):
                fail(f"npair_stats N={n}: {name} differs with emit off")
        rec["stats_abs_err"] = max(errs)
        del ref, st_r, pst
        # -- hist: two sides, digits 1 and 5, prefixes of real pairs
        nxt = (torch.arange(n, device="cuda") + 1) % n
        keys = sortable_key(sims.gather(1, nxt[:, None])[:, 0])
        rec["hist_abs_err"] = 0.0
        for digit in (1, 5):
            pre = [keys >> (32 - 4 * digit), (keys ^ 1) >> (32 - 4 * digit)]
            args = (f, lab, f, lab, [True, False], pre, digit)
            h_c = bw.npair_hist(*args, sims=sims)
            h_r = bw.npair_hist(*args)
            h_p = bw.hist_plain(*args, sims=sims, bn=bn, bm=bm)
            skip = torch.ones((), dtype=torch.bool, device="cuda")
            h_s = bw.npair_hist(*args, sims=sims, skip=skip)
            _same_bits(torch, h_c, bw.npair_hist(*args, sims=sims),
                       f"npair_hist cached N={n} digit {digit}")
            _same_bits(torch, h_r, bw.npair_hist(*args),
                       f"npair_hist recompute N={n} digit {digit}")
            torch.cuda.synchronize()
            for a, b, c, s in zip(h_c, h_r, h_p, h_s):
                rec["hist_abs_err"] = max(rec["hist_abs_err"],
                                          _abs_err(torch, a, c),
                                          _abs_err(torch, b, c))
                if not (torch.equal(a, b) and torch.equal(a, c)):
                    fail(f"npair_hist N={n} digit {digit}: kernel, "
                         "recompute and plain differ")
                if bool((s != 0).any()):
                    fail(f"npair_hist N={n}: skip flag did not zero")
            rec[f"hist_digit{digit}_counted"] = int(h_c[0].sum() +
                                                    h_c[1].sum())
        # -- loss, gq, gdb per mining config, from the engine's own
        # thresholds
        g = torch.ones((), device="cuda")
        for cname, cfg in cfgs.items():
            _, _, res = bw._forward(f, lab, cfg, bn, bm, True, 8)
            thr = (res["pos_thr"], res["neg_thr"], res["max_all"])
            l_c = bw.npair_loss(f, lab, f, lab, *thr, cfg, sims=sims)
            l_r = bw.npair_loss(f, lab, f, lab, *thr, cfg)
            l_p = bw.loss_plain(f, lab, f, lab, *thr, cfg, sims=sims,
                                bn=bn, splits=splits)
            _same_bits(torch, l_c, bw.npair_loss(f, lab, f, lab, *thr, cfg,
                                                 sims=sims),
                       f"npair_loss cached N={n} {cname}")
            _same_bits(torch, l_r, bw.npair_loss(f, lab, f, lab, *thr, cfg),
                       f"npair_loss recompute N={n} {cname}")
            valid = torch.ones(n, device="cuda")
            gargs = (f, lab, f, lab, *thr, res["ident_sum"], res["all_sum"],
                     valid, g, cfg)
            grads = {}
            for name, kern, pm in (("npair_gq", bw.npair_gq, False),
                                   ("npair_gdb", bw.npair_gdb, True)):
                grads[name] = (kern(*gargs, sims=sims), kern(*gargs),
                               bw.grad_plain(*gargs, pm, sims=sims, bn=bn,
                                             bm=bm))
                _same_bits(torch, grads[name][0], kern(*gargs, sims=sims),
                           f"{name} cached N={n} {cname}")
                _same_bits(torch, grads[name][1], kern(*gargs),
                           f"{name} recompute N={n} {cname}")
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(l_c, l_r)):
                fail(f"npair_loss N={n} {cname}: cached and recompute differ")
            if not (torch.equal(l_c[2], l_p[2]) and torch.equal(l_c[3],
                                                               l_p[3])):
                fail(f"npair_loss N={n} {cname}: pair counts differ")
            sum_err = max(_rel_close(l_c[0], l_p[0]),
                          _rel_close(l_c[1], l_p[1]))
            if not sum_err <= 1e-4:
                fail(f"npair_loss N={n} {cname}: I/D sums off by {sum_err}")
            rec[f"{cname}_sum_rel_err"] = sum_err
            # Rows whose I and D sums equal the kernel-order plain sweep's
            # bit for bit (the rest differ by their exps' ulps).
            rec[f"{cname}_sums_bit_equal_rows"] = int(
                ((l_c[0] == l_p[0]) & (l_c[1] == l_p[1])).sum())
            rec[f"{cname}_loss_abs_err"] = max(
                _abs_err(torch, a, b) for a, b in zip(l_c, l_p))
            rec[f"{cname}_pairs"] = [int(l_c[2].sum()), int(l_c[3].sum())]
            for name, (gc, gr, gp) in grads.items():
                if not torch.equal(gc, gr):
                    fail(f"{name} N={n} {cname}: cached and recompute differ")
                err = ((gc - gp).abs().max() /
                       gp.abs().max().clamp_min(1e-30)).item()
                if not err <= grad_tol:
                    fail(f"{name} N={n} {cname}: {err} of the largest entry")
                rec[f"{cname}_{name}_err"] = err
                rec[f"{cname}_{name}_abs_err"] = _abs_err(torch, gc, gp)
            if cname == "reference":
                path = (thr, res, gargs)
        log(f"[blockwise] N={n} D={d}: kernels = plain sweeps on the "
            f"kernel's sims; cached = recompute; repeat launches the same "
            f"bits; {json.dumps(rec)}")
        out[n] = rec
        if timer is None:
            continue
        # -- times at the path's variants (REFERENCE_CONFIG, sim cache on)
        thr, res, gargs = path
        nm, nd = n * n, n * d
        flop = 2.0 * n * n * d

        cublas = out[n]["cublas_sim_ms"] = timer.ms(lambda: f @ f.T)
        log(f"[kernel] N={n} D={d}: cuBLAS fp32 sim product feats @ "
            f"feats.T alone (not a yardstick of the fused kernels): "
            f"{cublas:.4f} ms")

        def row(name, kern, plain, nbytes, ops, err, variant):
            bms, by = bound_ms(nbytes, ops, "fp32")
            r = {"n": n, "d": d, "variant": variant, "max_abs_err": err,
                 "ms": timer.ms(kern),
                 "plain_ms": timer.ms(plain, iters=5, warmup=1),
                 "bound_ms": bms, "bound_by": by, "library_ms": None}
            rows[name].append(r)
            extra = (_vs_cublas(r["ms"], cublas, ops) if name in (
                "npair_stats", "npair_gq", "npair_gdb") else {})
            log(f"[kernel] {name} {variant} N={n} D={d}: "
                f"{json.dumps({**r, **extra})}")

        row("npair_stats",
            lambda: bw.npair_stats(f, lab, f, lab, hist_same=True, topk=8,
                                   emit_sims=True),
            lambda: bw.stats_plain(f, lab, f, lab, hist_same=True, topk=8,
                                   emit_sims=True, bn=bn, bm=bm),
            8 * nd + 4 * nm + 4 * n * (5 + 16 + 8), flop,
            out[n]["stats_abs_err"], "hist_same+topk8+emit")
        pre = [keys >> 28, keys >> 28]
        for cached in (True, False):
            s_ = sims if cached else None
            row("npair_hist",
                lambda: bw.npair_hist(f, lab, f, lab, [True, False], pre, 1,
                                      sims=s_),
                lambda: bw.hist_plain(f, lab, f, lab, [True, False], pre, 1,
                                      sims=s_, bn=bn, bm=bm),
                (4 * nm if cached else 8 * nd) + 4 * n * (1 + 2 + 32),
                0.0 if cached else flop, out[n]["hist_abs_err"],
                "cached" if cached else "recompute")
            row("npair_loss",
                lambda: bw.npair_loss(f, lab, f, lab, *thr,
                                      nl.REFERENCE_CONFIG, sims=s_),
                lambda: bw.loss_plain(f, lab, f, lab, *thr,
                                      nl.REFERENCE_CONFIG, sims=s_, bn=bn,
                                      splits=splits),
                (4 * nm if cached else 8 * nd) + 4 * n * (1 + 3 + 4),
                3.0 * nm + (0 if cached else flop),
                out[n]["reference_loss_abs_err"],
                "cached" if cached else "recompute")
            for name, kern, pm in (("npair_gq", bw.npair_gq, False),
                                   ("npair_gdb", bw.npair_gdb, True)):
                row(name, lambda: kern(*gargs, sims=s_),
                    lambda: bw.grad_plain(*gargs, pm, sims=s_, bn=bn, bm=bm),
                    (4 * nm + 8 * nd if cached else 12 * nd) + 4 * n * 7,
                    flop * (1 if cached else 2),
                    out[n][f"reference_{name}_abs_err"],
                    "cached" if cached else "recompute")
        # The early return of the path's 7 hist launches per step (the
        # pos_topk fast path holds): one side, the cache on.
        skip = torch.ones((), dtype=torch.bool, device="cuda")
        out[n]["hist_skip_ms"] = timer.ms(lambda: bw.npair_hist(
            f, lab, f, lab, [True], pre[:1], 1, sims=sims, skip=skip))
        log(f"[kernel] npair_hist early return N={n}: "
            f"{out[n]['hist_skip_ms']:.4f} ms")
        del sims, keys
    detail["blockwise_kernels"] = {"checks": out, "rows": rows}
    return rows


# -- phase 6b: the blockwise training path ------------------------------------


def blockwise_net(work):
    """examples/googlenet_cub.prototxt with its mining swapped for the
    reference's shipped config (examples/resnet50_global_relhard.prototxt:
    48-59, usage/def.prototxt's values)."""
    import re

    net = open(os.path.join("examples", "googlenet_cub.prototxt")).read()
    mining = ("npair_loss_param {\n        margin_ident: 0\n"
              "        margin_diff: -0.05\n        identsn: -0.0\n"
              "        diffsn: -0.3\n        ap_mining_region: GLOBAL\n"
              "        ap_mining_method: RELATIVE_HARD\n"
              "        an_mining_region: LOCAL\n"
              "        an_mining_method: HARD\n    }")
    net, k = re.subn(r"npair_loss_param \{[^}]*\}", mining, net)
    if k != 1:
        fail(f"googlenet_cub.prototxt has {k} npair_loss_param blocks")
    path = os.path.join(work, "googlenet_cub_relhard.prototxt")
    with open(path, "w") as fh:
        fh.write(net)
    return path


def _zero_biases(get_model):
    """``get_model`` whose trunks start with zero biases: the init's 0.2
    biases collapse the BN-free trunk onto one embedding, and mining
    then has nothing to tell apart."""
    def wrapped(*a, **kw):
        import torch

        model = get_model(*a, **kw)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith("bias"):
                    p.zero_()
        return model

    return wrapped


def drive_blockwise_train(torch, seed, detail, dense_step_ms):
    """``train --engine blockwise`` in-process on the GoogLeNet/CUB solver
    cut as in phase 5, with the reference's mining, zero biases."""
    import contextlib
    import math
    import re

    import npairloss_tpu_torch.models as models
    from npairloss_tpu_torch import cli
    from npairloss_tpu_torch.data.synthetic import synthetic_identity_batches
    from npairloss_tpu_torch.ops import _build
    from npairloss_tpu_torch.ops import blockwise_npair as bw
    from npairloss_tpu_torch.train import solver as tsolver

    work = os.path.join("build", "train_smoke")
    os.makedirs(work, exist_ok=True)
    text = open(os.path.join("examples", "googlenet_cub_solver.prototxt")
                ).read()
    for key, val in (("max_iter", 6), ("test_iter", 2), ("display", 1),
                     ("snapshot", 0)):
        text, n = re.subn(rf"(?m)^{key}:.*$", f"{key}: {val}", text)
        if n != 1:
            fail(f"solver prototxt has {n} '{key}:' lines")
    solver_path = os.path.join(work, "solver_blockwise.prototxt")
    with open(solver_path, "w") as fh:
        fh.write(text)
    net_path = blockwise_net(work)

    seen = {"solver": None, "after_test": None, "ms": []}
    orig_step = tsolver.Solver.step

    def timed_step(self, inputs, labels):
        if seen["after_test"] is None:
            seen["after_test"] = _build.launch_counts()
        seen["solver"] = self
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = orig_step(self, inputs, labels)
        torch.cuda.synchronize()
        seen["ms"].append((time.perf_counter() - t0) * 1e3)
        return m

    def run(extra, tag):
        events = os.path.join(work, f"events_{tag}.jsonl")
        if os.path.exists(events):
            os.remove(events)
        seen.update(after_test=None, ms=[])
        out = io.StringIO()
        orig_get = models.get_model
        tsolver.Solver.step = timed_step
        models.get_model = _zero_biases(orig_get)
        _build.reset_launch_counts()
        try:
            with contextlib.redirect_stdout(out):
                rc = cli.main(["train", "--solver", solver_path, "--net",
                               net_path, "--model", "googlenet_pallas",
                               "--synthetic", "--log-json", events, "--seed",
                               str(seed), "--engine", "blockwise", *extra])
            torch.cuda.synchronize()
        finally:
            tsolver.Solver.step = orig_step
            models.get_model = orig_get
        total = _build.launch_counts()
        for ln in out.getvalue().splitlines():
            log(f"[blockwise-train {tag}] {ln}")
        if rc != 0:
            fail(f"train --engine blockwise {tag} returned {rc}")
        evs = [json.loads(ln) for ln in open(events)]
        final = json.loads(out.getvalue().strip().splitlines()[-1])
        for r in evs + [final]:
            bad = {k: v for k, v in r.items()
                   if isinstance(v, float) and not math.isfinite(v)}
            if bad:
                fail(f"non-finite values in {tag} {r.get('event')}: {bad}")
        after = seen["after_test"]
        in_train = {k: total[k] - after[k] for k in total}
        return evs, in_train, list(seen["ms"])

    t0 = time.perf_counter()
    events, launches, ms = run([], "main")
    wall = time.perf_counter() - t0
    displays = [e for e in events if e["event"] == "display"]
    if [e["iteration"] for e in displays] != [1, 2, 3, 4, 5, 6]:
        fail(f"unexpected blockwise event stream: {events}")
    log(f"[blockwise-train] launches during the 6 steps "
        f"{json.dumps({k: launches[k] for k in BLOCKWISE_KERNELS})}")
    for name in ("npair_stats", "npair_loss", "npair_gq", "npair_gdb",
                 "lrn_fwd_cached", "lrn_bwd_cached"):
        if launches[name] < 1:
            fail(f"kernel {name} was not launched by the blockwise steps")
    step_ms = statistics.median(ms[1:])
    log(f"[blockwise-train] step ms {[round(t, 3) for t in ms]}; median over "
        f"steps 2-6 {step_ms:.3f} ms = {120 / step_ms * 1e3:.1f} images/s "
        f"(phase 5 dense engine, LOCAL/RAND: {dense_step_ms:.3f} ms); "
        f"whole command {wall:.1f} s")

    solver = seen["solver"]
    x_np, lab_np = next(synthetic_identity_batches(240, 60, 2, (224, 224, 3),
                                                   seed=seed + 21))
    solver.step(x_np, lab_np)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        solver.step(x_np, lab_np)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("[blockwise-train] a blockwise step under set_sync_debug_mode"
        "('error') made no host sync")

    # The random trunk maps every image to nearly one embedding (ROADMAP
    # Queue 3): its sims have next to no spread, and mining on them says
    # little.  Read the spread here; the mining checks run on features
    # that have it.
    cfg = solver.loss_cfg
    with torch.no_grad():
        emb = solver.model(torch.as_tensor(x_np, device="cuda"))
        path_spread = _sim_spread(torch, emb)
        path_loss = bw.blockwise_npair_loss(
            emb, torch.as_tensor(lab_np, device="cuda"), cfg).item()
    log(f"[blockwise-train] the path's embeddings after 8 steps: std of "
        f"their cosine sims {path_spread:.6g} (random unit rows in "
        f"{emb.shape[1]} dims: {emb.shape[1] ** -0.5:.4g}), loss "
        f"{path_loss:.9g} (log {emb.shape[0] - 1} = "
        f"{math.log(emb.shape[0] - 1):.9g})")
    mining = check_mining_with_spread(torch, seed, solver)

    # The radix path through the CLI: --pos-topk 0, one step.
    ev0, launches0, _ = run(["--pos-topk", "0", "--max_iter", "1"], "radix")
    if launches0["npair_hist"] < 7:
        fail(f"--pos-topk 0 ran {launches0['npair_hist']} hist sweeps")
    l_fast = displays[0]["loss"]
    l_radix = [e for e in ev0 if e["event"] == "display"][0]["loss"]
    rel = abs(l_fast - l_radix) / max(abs(l_fast), 1e-30)
    log(f"[blockwise-train] first-step loss, pos_topk 8 {l_fast!r} vs 0 "
        f"{l_radix!r} (rel {rel:.3g}); hist launches "
        f"{launches0['npair_hist']}")
    if not rel <= 1e-6:
        fail("the radix path's first-step loss differs from the fast path")
    log("[blockwise-train] profile of the blockwise step:")
    profile = profile_train_step(torch, solver, x_np, lab_np)
    detail["blockwise_train"] = {
        "profile": profile,
        "events": events, "launches": launches, "launches_radix": launches0,
        "step_ms": ms, "median_step_ms": step_ms,
        "dense_median_step_ms": dense_step_ms,
        "path_sim_spread": path_spread, "path_loss": path_loss,
        "mining_with_spread": mining,
        "first_loss_fast": l_fast, "first_loss_radix": l_radix,
        "engine_check": check_engines_agree(torch, seed, cfg)}
    return launches, launches0, step_ms


# Std of the cosine sims below which a batch's embeddings count as
# collapsed; random unit rows in 1024 dims give 1024 ** -0.5 = 0.031.
SPREAD_FLOOR = 0.01


def _sim_spread(torch, emb):
    """Std of the off-diagonal cosine sims of ``emb``'s rows: near 0
    when they collapse onto one direction."""
    e = torch.nn.functional.normalize(emb.detach().float(), dim=1)
    sims = e @ e.T
    off = ~torch.eye(e.shape[0], dtype=torch.bool, device=e.device)
    return float(sims[off].std().item())


def check_mining_with_spread(torch, seed, solver):
    """The path's loss, ``Solver.compute_loss`` with the path's mining
    config, on 120 x 1024 unit features whose sims have spread (std above
    ``SPREAD_FLOOR``, or the check fails): positive and negative pairs
    selected; pos_topk 8 vs 0 the same thresholds, counts and loss bit
    for bit; the dense and blockwise engines' loss within 1e-5 relative
    and feature gradients within 1e-4 of the dense gradient's norm."""
    from npairloss_tpu_torch.ops import blockwise_npair as bw
    from npairloss_tpu_torch.train.solver import Solver

    f, lab = unit_batch(torch, seed + 29, 120, 1024)
    spread = _sim_spread(torch, f)
    if not spread > SPREAD_FLOOR:
        fail(f"mining check features have no spread: std {spread}")
    cfg = solver.loss_cfg
    fast = bw.blockwise_npair_loss_with_aux(f, lab, cfg, pos_topk=8)
    radix = bw.blockwise_npair_loss_with_aux(f, lab, cfg, pos_topk=0)
    pairs = [int(fast[1]["ident_num"].sum().item()),
             int(fast[1]["diff_num"].sum().item())]
    same = torch.equal(fast[0], radix[0]) and all(
        torch.equal(fast[1][k], radix[1][k]) for k in fast[1])
    got = {}
    for engine in ("dense", "blockwise"):
        s = Solver(solver.model, cfg, solver.cfg, solver.top_ks,
                   loss_weight=solver.loss_weight, engine=engine,
                   sim_cache=solver.sim_cache, pos_topk=solver.pos_topk)
        x = f.clone().requires_grad_()
        loss, metrics = s.compute_loss(x, lab)
        loss.backward()
        got[engine] = (loss.item(), x.grad,
                       {k: float(v) for k, v in metrics.items()})
    (l_d, g_d, m_d), (l_b, g_b, m_b) = got["dense"], got["blockwise"]
    loss_rel = abs(l_b - l_d) / max(abs(l_d), 1e-30)
    grad_rel = ((g_b - g_d).norm() / g_d.norm().clamp_min(1e-30)).item()
    log(f"[blockwise-train] mining on 120 x 1024 unit features (sim std "
        f"{spread:.4g}), the path's config: {pairs[0]} positive and "
        f"{pairs[1]} negative pairs; pos_topk 8 vs 0 bit-equal {same}; "
        f"compute_loss dense vs blockwise: loss {l_d:.9g} vs {l_b:.9g} "
        f"(rel {loss_rel:.3g}), feature gradient error over its norm "
        f"{grad_rel:.3g}; metrics {m_d} vs {m_b}")
    if not (pairs[0] > 0 and pairs[1] > 0 and same):
        fail("blockwise mining on features with spread is off")
    if not loss_rel <= 1e-5 or not grad_rel <= 1e-4:
        fail("dense and blockwise engines disagree on features with spread")
    return {"sim_spread": spread, "pairs": pairs, "fast_eq_radix": same,
            "loss_dense": l_d, "loss_blockwise": l_b, "loss_rel": loss_rel,
            "feature_grad_rel": grad_rel, "metrics_dense": m_d,
            "metrics_blockwise": m_b}


def check_engines_agree(torch, seed, cfg):
    """One step's loss and gradients from the same zero-bias weights and
    batch through the dense and the blockwise engine (cuDNN
    deterministic): loss within 1e-5 relative, each parameter's gradient
    within 1e-4 of the norm of the step's whole gradient.  The random
    trunk's embeddings have next to no spread (printed), so this holds
    the engines' plumbing through the trunk, not their mining."""
    from npairloss_tpu_torch.data.synthetic import synthetic_identity_batches
    from npairloss_tpu_torch.models import get_model
    from npairloss_tpu_torch.ops.blockwise_npair import blockwise_npair_loss
    from npairloss_tpu_torch.ops.npair_loss import npair_loss

    model = get_model("googlenet_pallas", device="cuda", seed=seed,
                      dtype=torch.float32)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
    model.train()
    x_np, lab_np = next(synthetic_identity_batches(240, 60, 2, (224, 224, 3),
                                                   seed=seed + 23))
    x = torch.as_tensor(x_np, device="cuda")
    lab = torch.as_tensor(lab_np, device="cuda")
    cudnn = torch.backends.cudnn
    det, bench = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    out = {}
    try:
        for engine, fn in (("dense", npair_loss),
                           ("blockwise", blockwise_npair_loss)):
            for p in model.parameters():
                p.grad = None
            emb = model(x)
            spread = _sim_spread(torch, emb)
            loss = fn(emb, lab, cfg)
            loss.backward()
            out[engine] = (loss.item(), {n: p.grad.detach().clone()
                                         for n, p in model.named_parameters()})
    finally:
        cudnn.deterministic, cudnn.benchmark = det, bench
    (l_d, g_d), (l_b, g_b) = out["dense"], out["blockwise"]
    loss_rel = abs(l_b - l_d) / max(abs(l_d), 1e-30)
    total = torch.sqrt(sum(g.double().pow(2).sum() for g in g_d.values()))
    rel = {n: ((g_b[n] - g_d[n]).double().norm() / total).item() for n in g_d}
    worst = max(rel, key=rel.get)
    log(f"[blockwise-train] one step dense vs blockwise: loss {l_d:.9g} vs "
        f"{l_b:.9g} (rel {loss_rel:.3g}); worst gradient error over the "
        f"step's gradient norm {rel[worst]:.3g} ({worst}); std of the "
        f"embedding's cosine sims {spread:.6g}")
    if not loss_rel <= 1e-5 or not rel[worst] <= 1e-4:
        fail("dense and blockwise engines disagree on one step")
    return {"loss_dense": l_d, "loss_blockwise": l_b, "loss_rel": loss_rel,
            "grad_rel_max": rel[worst], "worst_param": worst,
            "sim_spread": spread}


# -- phase 6c: the stretch size --------------------------------------------------


def check_stretch(torch, timer, detail, seed, n=32768, d=512):
    """Loss + backward at the 32,768 pool and 512 dims of STRETCH.json on
    synthetic unit features: REFERENCE_CONFIG, LOCAL/RAND and a two-sided
    radix config; sim cache on vs off bit-identical in loss and gradient;
    pos_topk 8 vs 0 the same thresholds and loss; each kernel's time per
    call."""
    import math

    from npairloss_tpu_torch.ops import _build
    from npairloss_tpu_torch.ops import blockwise_npair as bw
    from npairloss_tpu_torch.ops import npair_loss as nl
    from npairloss_tpu_torch.ops.rank_select import sortable_key

    f, lab = unit_batch(torch, seed + 3, n, d)
    out = {"n": n, "d": d,
           "cache_auto": nl.resolve_sim_cache_auto(n * n * 4, "blockwise",
                                                   f.device)}
    if not out["cache_auto"]:
        fail(f"the sim cache did not auto-enable at N={n}")

    def run(cfg, **kw):
        x = f.clone().requires_grad_()
        _build.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, aux = bw.blockwise_npair_loss_with_aux(x, lab, cfg, **kw)
        loss.backward()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = {k: v for k, v in _build.launch_counts().items()
                  if k in BLOCKWISE_KERNELS}
        return loss.detach(), aux, x.grad, wall, counts

    ref = nl.REFERENCE_CONFIG
    # Positives and negatives both GLOBAL/RELATIVE_HARD: the radix path,
    # 7 hist sweeps of two sides each.
    radix_both = nl.NPairLossConfig(
        margin_ident=ref.margin_ident, margin_diff=ref.margin_diff,
        identsn=ref.identsn, diffsn=ref.diffsn,
        ap_mining_region=nl.MiningRegion.GLOBAL,
        ap_mining_method=nl.MiningMethod.RELATIVE_HARD,
        an_mining_region=nl.MiningRegion.GLOBAL,
        an_mining_method=nl.MiningMethod.RELATIVE_HARD)
    for cname, cfg in (("reference", ref), ("local_rand", nl.NPairLossConfig()),
                       ("radix_both", radix_both)):
        on = run(cfg, sim_cache=True)
        off = run(cfg, sim_cache=False)
        if not (torch.equal(on[0], off[0]) and torch.equal(on[2], off[2])
                and all(torch.equal(on[1][k], off[1][k]) for k in on[1])):
            fail(f"stretch {cname}: cache on and off differ")
        rec = {"loss": on[0].item(), "wall_ms_cache_on": on[3],
               "wall_ms_cache_off": off[3], "launches": on[4],
               "pairs": [int(on[1]["ident_num"].sum().item()),
                         int(on[1]["diff_num"].sum().item())]}
        if cname == "radix_both" and on[4]["npair_hist"] != 7:
            fail(f"stretch {cname}: {on[4]['npair_hist']} hist sweeps, "
                 "expected 7")
        if cname == "reference":
            radix = run(cfg, sim_cache=True, pos_topk=0)
            if not (torch.equal(on[0], radix[0]) and all(
                    torch.equal(on[1][k], radix[1][k]) for k in on[1])):
                fail("stretch reference: pos_topk 8 and 0 differ")
            rec["wall_ms_radix"] = radix[3]
            rec["launches_radix"] = radix[4]
        if not (math.isfinite(rec["loss"])
                and bool(torch.isfinite(on[2]).all())):
            fail(f"stretch {cname}: non-finite loss or gradient")
        log(f"[stretch] N={n} D={d} {cname}: cache on = off bit for bit"
            f"{', pos_topk 8 = 0' if cname == 'reference' else ''}; "
            f"{json.dumps(rec)}")
        out[cname] = rec
        del on, off

    # Each kernel per call at the stretch size (the path's cached
    # variants, and the recompute variants).
    cfg = nl.REFERENCE_CONFIG
    bn = bm = 512
    _, _, res = bw._forward(f, lab, cfg, bn, bm, True, 8)
    sims = res["sims"]
    thr = (res["pos_thr"], res["neg_thr"], res["max_all"])
    valid = torch.ones(n, device="cuda")
    g = torch.ones((), device="cuda")
    gargs = (f, lab, f, lab, *thr, res["ident_sum"], res["all_sum"], valid,
             g, cfg)
    pre = [sortable_key(sims[:, 1]) >> 28]  # digit-1 prefixes of real pairs
    nm, flop = float(n) * n, 2.0 * n * n * d
    # Each kernel twice on the same inputs: the same bits.
    st_kw = dict(hist_same=True, topk=8, emit_sims=True)
    _same_bits(torch, bw.npair_stats(f, lab, f, lab, **st_kw),
               bw.npair_stats(f, lab, f, lab, **st_kw),
               f"stretch npair_stats N={n}")
    hist_args = (f, lab, f, lab, [True, False], pre * 2, 1)
    for s_ in (sims, None):
        _same_bits(torch, bw.npair_hist(*hist_args, sims=s_),
                   bw.npair_hist(*hist_args, sims=s_),
                   f"stretch npair_hist N={n}")
        _same_bits(torch, bw.npair_loss(f, lab, f, lab, *thr, cfg, sims=s_),
                   bw.npair_loss(f, lab, f, lab, *thr, cfg, sims=s_),
                   f"stretch npair_loss N={n}")
    for name, kern in (("npair_gq", bw.npair_gq), ("npair_gdb", bw.npair_gdb)):
        for s_ in (sims, None):
            _same_bits(torch, kern(*gargs, sims=s_), kern(*gargs, sims=s_),
                       f"stretch {name} N={n}")
    torch.cuda.synchronize()
    log(f"[stretch] N={n} D={d}: stats, hist, loss, gq, gdb (cached and "
        "recompute) launched twice give the same bits")
    out["cublas_sim_ms"] = timer.ms(lambda: f @ f.T, iters=5, warmup=1)
    log(f"[stretch] cuBLAS fp32 sim product feats @ feats.T alone: "
        f"{out['cublas_sim_ms']:.3f} ms")
    # One PyTorch read of the same cache: a read-rate yardstick for the
    # cached sweeps (not the same function).
    out["amax_cache_ms"] = timer.ms(lambda: torch.amax(sims, dim=1),
                                    iters=5, warmup=1)
    log(f"[stretch] torch.amax over the {n} x {n} cache: "
        f"{out['amax_cache_ms']:.3f} ms")
    skip = torch.ones((), dtype=torch.bool, device="cuda")
    out["hist_skip_ms"] = timer.ms(lambda: bw.npair_hist(
        f, lab, f, lab, [True], pre, 1, sims=sims, skip=skip))
    log(f"[stretch] npair_hist early return N={n}: "
        f"{out['hist_skip_ms']:.4f} ms")
    times = {}
    for name, fn, nbytes, ops in (
            ("npair_stats+emit", lambda: bw.npair_stats(
                f, lab, f, lab, hist_same=True, topk=8, emit_sims=True),
             8 * n * d + 4 * nm, flop),
            ("npair_hist cached", lambda: bw.npair_hist(
                f, lab, f, lab, [True], pre, 1, sims=sims), 4 * nm, 0.0),
            ("npair_hist recompute", lambda: bw.npair_hist(
                f, lab, f, lab, [True], pre, 1), 8 * n * d, flop),
            ("npair_hist cached, 2 sides", lambda: bw.npair_hist(
                *hist_args, sims=sims), 4 * nm, 0.0),
            ("npair_hist recompute, 2 sides", lambda: bw.npair_hist(
                *hist_args), 8 * n * d, flop),
            ("npair_loss cached", lambda: bw.npair_loss(
                f, lab, f, lab, *thr, cfg, sims=sims), 4 * nm, 3 * nm),
            ("npair_loss recompute", lambda: bw.npair_loss(
                f, lab, f, lab, *thr, cfg), 8 * n * d, flop + 3 * nm),
            ("npair_gq cached", lambda: bw.npair_gq(*gargs, sims=sims),
             4 * nm + 8 * n * d, flop),
            ("npair_gq recompute", lambda: bw.npair_gq(*gargs),
             12 * n * d, 2 * flop),
            ("npair_gdb cached", lambda: bw.npair_gdb(*gargs, sims=sims),
             4 * nm + 8 * n * d, flop),
            ("npair_gdb recompute", lambda: bw.npair_gdb(*gargs),
             12 * n * d, 2 * flop)):
        bms, by = bound_ms(nbytes, ops, "fp32")
        times[name] = {"ms": timer.ms(fn, iters=5, warmup=1),
                       "bound_ms": bms, "bound_by": by}
        if name.startswith(("npair_stats", "npair_gq", "npair_gdb")):
            times[name].update(_vs_cublas(times[name]["ms"],
                                          out["cublas_sim_ms"], ops))
        log(f"[stretch] {name} N={n} D={d}: {json.dumps(times[name])}")
    out["kernel_ms"] = times
    detail["stretch"] = out
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = card_line()
    cc = torch.cuda.get_device_capability(0)
    log(f"[card] {card}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"capability {cc[0]}.{cc[1]} devices {torch.cuda.device_count()}")
    if cc != (9, 0):
        fail(f"need compute capability 9.0 (sm_90a), got {cc}")

    from npairloss_tpu_torch.device import resolve_device
    from npairloss_tpu_torch.ops import _build
    from npairloss_tpu_torch.serve.ivf import IVFIndex

    resolve_device("cuda")  # TF32 off for fp32 parity
    t0 = time.perf_counter()
    _build.library()
    info = _build.build_info
    log(f"[build] {info['path']} in {time.perf_counter() - t0:.2f} s "
        f"(cached: {info['cached']})")
    # ptxas -v: each kernel's name, then its spills, registers and shared
    # memory.
    for ln in str(info.get("log", "")).splitlines():
        if ("registers" in ln or "spill" in ln or "rc " in ln
                or "entry function" in ln):
            log(f"[build] {ln.strip()}")

    detail: dict = {"card": card}
    emb, labels = synthetic_gallery(args.seed)
    t0 = time.perf_counter()
    index = IVFIndex.build_ivf(emb, labels, normalize=False, iters=10,
                               seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    log(f"[index] {index.size} rows x {index.dim} -> {index.n_clusters} "
        f"clusters, cap {index.layout.cap}, built in "
        f"{time.perf_counter() - t0:.3f} s")

    timer = Timer(torch)
    stem_rows = check_stem(torch, timer, detail)
    rng_rows = torch.Generator().manual_seed(args.seed)
    pick = torch.randperm(emb.shape[0], generator=rng_rows)[:32].numpy()
    check_probe_odd_dim(torch, detail)
    probe_rows = check_probe(torch, timer, index, emb[pick], detail)
    train_rows = check_lrn_train(torch, timer, detail)
    check_stem_scalar_paths(torch, detail)
    check_stem(torch, timer, detail, batch=120, key="stem_train")
    del timer
    launches, summary, qps = drive_path(torch, args.seed, index, emb, detail)
    del index
    train_launches, dense_step_ms = drive_train(torch, args.seed, detail)
    recompute_launches = check_train_step(torch, args.seed, detail)
    check_reference_mining(torch, args.seed, detail)
    bw_rows = check_blockwise_kernels(torch, Timer(torch), detail, args.seed)
    bw_launches, bw_radix_launches, _ = drive_blockwise_train(
        torch, args.seed, detail, dense_step_ms)
    check_stretch(torch, Timer(torch), detail, args.seed)

    def entry(name, source, replaces, rows, counter, path=None):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": (path or launches)[counter],
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": sum(r["ms"] for r in rows),
                "plain_ms": sum(r["plain_ms"] for r in rows),
                "bound_ms": sum(r["bound_ms"] for r in rows),
                "bound_by": rows[0]["bound_by"],
                "library_ms": (sum(r["library_ms"] for r in rows)
                               if all(r["library_ms"] is not None
                                      for r in rows) else None)}

    # One entry per kernel at the path's own calls: bf16 stem shapes for
    # one 32-image encode (LRN and bias+ReLU run twice each), the fp32
    # probe for one 32-query bucket; the LRN training kernels at one fp32
    # batch-120 training step (both LRN sites), with the launches of the
    # phase-5 train steps (lrn_bwd: of the phase-5b step with the cache
    # budget at 0, the path's recompute configuration).
    path_bf16 = lambda rows: [r for r in rows if r["dtype"] == "bf16"]  # noqa: E731
    path_fp32 = lambda rows: [r for r in rows if r["dtype"] == "fp32"]  # noqa: E731
    kernels = [
        entry("lrn_fwd", "npairloss_tpu_torch/csrc/stem.cu",
              "npairloss_tpu/ops/pallas_stem.py:121",
              path_bf16(stem_rows["lrn"]), "lrn_fwd"),
        entry("bias_relu", "npairloss_tpu_torch/csrc/stem.cu",
              "npairloss_tpu/ops/pallas_stem.py:308",
              path_bf16(stem_rows["bias_relu"]), "fused_bias_relu"),
        entry("bias_relu_pool", "npairloss_tpu_torch/csrc/stem.cu",
              "npairloss_tpu/ops/pallas_stem.py:383",
              path_bf16(stem_rows["bias_relu_pool"]),
              "fused_bias_relu_pool"),
        entry("ivf_probe", "npairloss_tpu_torch/csrc/ivf_probe.cu",
              "npairloss_tpu/ops/pallas_ivf.py:110",
              [probe_rows["fp32"]], "probe_topk"),
        entry("lrn_fwd_cached", "npairloss_tpu_torch/csrc/stem.cu",
              "npairloss_tpu/ops/pallas_stem.py:128",
              path_fp32(train_rows["lrn_fwd_cached"]), "lrn_fwd_cached",
              train_launches),
        entry("lrn_bwd", "npairloss_tpu_torch/csrc/stem.cu",
              "npairloss_tpu/ops/pallas_stem.py:136",
              path_fp32(train_rows["lrn_bwd"]), "lrn_bwd",
              recompute_launches),
        entry("lrn_bwd_cached", "npairloss_tpu_torch/csrc/stem.cu",
              "npairloss_tpu/ops/pallas_stem.py:151",
              path_fp32(train_rows["lrn_bwd_cached"]), "lrn_bwd_cached",
              train_launches),
    ]
    # The blockwise kernels at the phase-6b path's shape (N = 120, D =
    # 1024, sim cache on: the cached variants), with the launches of the
    # six blockwise train steps — for npair_hist, of the --pos-topk 0
    # step, where its sweeps do the radix work (with the 8-slot buffer
    # they return at once).
    path_120 = lambda rows, variant: [  # noqa: E731
        r for r in rows if r["n"] == 120 and r["variant"] == variant]
    src = "npairloss_tpu_torch/csrc/npair_blockwise.cu"
    kernels += [
        entry("npair_stats", src, "npairloss_tpu/ops/pallas_npair.py:287",
              path_120(bw_rows["npair_stats"], "hist_same+topk8+emit"),
              "npair_stats", bw_launches),
        entry("npair_hist", src, "npairloss_tpu/ops/pallas_npair.py:355",
              path_120(bw_rows["npair_hist"], "cached"), "npair_hist",
              bw_radix_launches),
        entry("npair_loss", src, "npairloss_tpu/ops/pallas_npair.py:388",
              path_120(bw_rows["npair_loss"], "cached"), "npair_loss",
              bw_launches),
        entry("npair_gq", src, "npairloss_tpu/ops/pallas_npair.py:458",
              path_120(bw_rows["npair_gq"], "cached"), "npair_gq",
              bw_launches),
        entry("npair_gdb", src, "npairloss_tpu/ops/pallas_npair.py:483",
              path_120(bw_rows["npair_gdb"], "cached"), "npair_gdb",
              bw_launches),
    ]
    idle = [k["name"] for k in kernels if k["launches"] < 1]
    if idle:
        fail(f"kernels not launched on their path: {idle}")
    detail["kernels"] = kernels
    detail["seconds"] = time.perf_counter() - t_start
    try:
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "chip_smoke_detail.json"),
                  "w") as f:
            json.dump(detail, f, indent=1, default=str)
    except OSError as e:
        log(f"[detail] not written: {e}")
    log(f"[done] {detail['seconds']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
