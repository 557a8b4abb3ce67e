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
   (the LRN bit for bit; the pool too, also with NaN planted, and timed
   beside ``F.max_pool2d`` over a ``channels_last`` tensor of the same
   shape, a read-rate yardstick; bias+ReLU bit for bit too, NaN planted,
   on its vector path as its launch counters show);
   the IVF probe against the phase-4 index at buckets B = 1, 8 and 32,
   probes 8 and 16, k 10, in fp32/bf16/int8 (its plain version, the
   one-shot key merge, first held to the sequential merge bit for bit),
   on planted duplicate rows (rows and scores equal in every slot), at a
   cap of 40,000 (past the old kernel's shared-memory limit) and at D =
   100 (bf16 and int8 take the kernel's element-wise path) — with the
   error against a stated tolerance and the median time from CUDA events
   (L2 flushed before every timed launch) beside the least time the card
   could take;
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
   graph), the forward's out and d bit for bit; the LRN forward and
   backward, bias+ReLU and the pool off their vector paths (C = 100 at
   (2,7,9,100), and operands off 16-byte alignment; bias+ReLU also at
   the odd C = 3, each call on the path its counters show), and the
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
5d. the training path on list files: 100 x 4 TRAIN and 30 x 4 TEST PPM
   images (240-400 px a side, from the seed) under ``build/data_smoke/``,
   the GoogLeNet/CUB net with only ``root_folder`` and ``source``
   rewritten, ``train --native require`` (no ``--synthetic``) on the
   phase-5 solver cut: the native runtime decodes and resizes to 256²,
   the card crops, mirrors and subtracts the mean; finite losses, every
   batch (120,224,224,3) fp32 on the card, an iter-0 TEST pass, the stem
   kernels launched (bias+ReLU on its vector path), the TEST batch on
   the card equal to the CPU's, a loader batch with no host sync; the
   median step ms beside phase 5's and the loader's wait per step;
5e. snapshots, resume, preemption and the eval commands, on 5d's data
   and the phase-5 cut, under ``build/snap_smoke/``: (a) ``train
   --native require`` in a subprocess (max_iter 6, snapshot 2, display
   1, --snapshot-keep 2), SIGTERM after ``iter 3``: exit 75, a committed
   snapshot at the printed iteration k that the validator accepts, no
   ``.tmp-`` dir; relaunched with ``--resume auto``: "resuming from
   iteration k", exit 0, the snapshot steps the retention rule leaves;
   (b) solver A trains 6 steps on six fixed batches (snapshot at 3), a
   fresh solver B restores iter 3 and trains steps 4-6: parameters,
   buffers and momentum bit for bit (cuDNN deterministic); the commit
   and restore ms and the snapshot's bytes; (c) ``extract --resume
   <iter 6> --phase TEST --batches 4`` (120 x 1024) equals the restored
   model's eval-mode forward bit for bit, rows of unit norm within 1e-5,
   the stem's forward kernels launched; ``test`` finite; (d) ``eval
   --ks 1 10 100 1000`` over phase 4's 60,502 x 1024 gallery, 2,048
   seeded rows' hits equal to the CPU's outside boundary ties, ``eval
   --nmi`` on 5,924 rows of 100 identities; (e) ``time`` at batch 120,
   each stage positive and trunk forward <= forward <= forward+backward;
4b. the serving tier (after 5e, whose iter-6 snapshot it serves), under
   ``build/tier_smoke/``: phase 4's gallery committed flat with ``index
   --emb/--labels/--out``; ``serve --index-prefix ... --index-kind ivf
   --ivf-clusters 246 --probe-impl fused --replicas 2 --wal-dir ...
   --wal-checkpoint-every 4 --snapshot <iter 6> --model googlenet_pallas``
   built in-process by the CLI's ``build_server`` and run by
   ``run_http`` on an ephemeral port: 512 single queries, 64 bodies of
   32 and 16 raw images from 8 client threads, a bad body (400) and an
   unknown path (404), ``/healthz``; every query answered, each gallery
   row its own top-1, the probe and three stem kernels launched; the
   restored trunk on the card against the CPU; ``serve.replica_crash``
   under load with no client error; 16 ingest records of 256 rows (ids
   from 10^6) acked with their seq, four checkpoints, the WAL GC'd to
   the last; each sampled new row its own top-1; the probe kernel
   against its plain version at the grown cap; then the in-process tier
   drained and the same configuration as a ``serve --http 0``
   subprocess: 8 more records acked, SIGKILL before a checkpoint, a
   restart that loads the watermark-16 checkpoint and replays exactly
   the 8 records above it, each sampled acked row its own top-1 and
   present once; SIGTERM under load: exit 75, the drain record, and a
   final checkpoint that holds every acked row once; HTTP p50/p99,
   ack, checkpoint, replay and restart times beside the card line;
5f. the Inception-BN trunk and the precision policies: ``train --model
   googlenet_bn --precision mxu`` in-process on the phase-5 solver cut
   (batch 120, 224², synthetic), on the dense engine, with ``--engine
   blockwise`` (the reference's mining; the five kernels in their bf16
   mode, every launch of the steps in that mode by the per-mode
   counters), with ``--remat``, and ``--precision fp32_parity``: finite
   losses and metrics, a nonzero gradient on every parameter, every
   BatchNorm's running statistics moved, no stem kernel launched, no
   host sync in a step, the median step ms over steps 2-6; one mxu step
   with and without remat bit for bit (gradients and running
   statistics, cuDNN deterministic) and their peak allocated memory; a
   snapshot at iter 3 and a resume equal to the uninterrupted run bit
   for bit, running statistics included; the std of the init trunks'
   cosine sims (googlenet_bn beside the BN-free googlenet_pallas);
5g. the trunk learns: the ACCURACY.md recipe (googlenet_bn at 96², 16
   identities x 2, REFERENCE_CONFIG, lr 0.05 fixed, momentum 0.9, no
   weight decay, noise 0.6, seed 0, 200 steps) through the port's
   Solver under fp32_parity on the dense engine and under mxu on the
   blockwise engine: each run's last-step Recall@1 >= 0.95, the curves
   every 20 steps and each run's seconds;
5h. sync-free stepping: ``train`` in-process on the phase-5 solver cut to
   12 iterations (display 4, snapshot 4; batch 120, 224²; the CLI's own
   synthetic batches made up front, since the host's generator is slower
   than a step), once synchronously and once with ``--pipeline``, in four
   configurations — ``googlenet_bn`` under ``mxu`` dense and blockwise
   (the reference's mining: the five kernels in their bf16 mode), and
   ``googlenet_pallas`` fp32 dense and blockwise (stem kernels 7, 9, 10,
   11 in the graph) — with cuDNN deterministic: display lines and
   ``--log-json`` records byte for byte, parameters, momentum and
   running statistics bit for bit, 2 eager warm-up steps then one
   capture and 10 graph replays, each kernel's launches per replay
   counted and the run's launches equal to the synchronous run's, no
   upload and one window read per boundary on the training thread
   under a strict ``HostSyncMonitor`` (each replay's dispatch under
   sync debug mode "error"); the median step ms over steps 2-12 (CUDA
   events after each step), the idle share from a profile of three
   more steps against it, ``controller.blocked``, the capture's ms and
   the graph pool's bytes; then the drills on both loops
   (``googlenet_pallas`` fp32 dense): ``step.nan_loss`` at steps 7-9
   with ``--divergence-patience 3`` rolls back to iter 4 and
   quarantines iter 8, ``--divergence-action halt`` exits 1, a
   ``RollbackRequest`` set from another thread is taken at iter 8, and
   SIGTERM before step 6 flushes the window, snapshots iter 6 and exits
   75, and a resume from it equals the uninterrupted run bit for bit;
5i. distribution: (a) ``train --mesh 1 --engine ring`` and ``--engine
   dense`` in-process on ``googlenet_bn`` under ``mxu`` (the phase-5
   solver cut, batch 120, 224², the CLI's synthetic stream, cuDNN
   deterministic) in one NCCL process group of world size 1: per step
   the losses within ``DIST_TOL``, the Recall@k tops equal, the
   parameters after 6 steps within ``DIST_TOL`` of their norm; each
   engine's median step ms, the ring's passes timed on three more
   steps; in the same group the mesh's all-gather, all-reduces, vote
   and barrier against the identity, then 2 steps of the dense engine
   through ``Solver(mesh=build_mesh())`` and of the ring under the
   reference's mining against dense without a mesh, each run's NCCL
   calls counted (no ring hop at one rank: ``parallel.meshcheck`` runs
   those on several cards); (b) what NCCL says when asked for two
   ranks on the one card
   (printed), then two spawned ranks on ``cuda:0`` over gloo by
   declaration (a card's tensors through host memory), global batch 120
   (60 a rank), dense and ring, 4 steps: the two ranks' parameters bit
   for bit after every step, ring against dense within ``DIST_TOL``,
   the synced BatchNorm forward (``fp32_parity``) against one rank's on
   the whole batch, and the unsynced one beyond that limit, the
   gloo-through-host step ms; (c) ``train --mesh
   2`` outside a process group, ``--mp 2`` and ``--pipeline`` over two
   ranks on the card exit 2 naming their ROADMAP entries;
5j. run telemetry and the perf observatory: ``train`` in-process on the
   phase-5h cut (12 iterations, display 4, no snapshot, no iteration-0
   TEST, the CLI's synthetic batches made up front, cuDNN
   deterministic) on ``googlenet_bn`` under ``mxu``, dense and blockwise
   (its bf16 mode), with ``--telemetry-dir --health-metrics
   --mining-health --perf-metrics``: (a) the synchronous loop — the run
   directory valid (manifest, every row's envelope, the trace), every
   ``train`` row holding every health key of its engine with finite
   values, the ``perf`` rows' ``step_flops`` equal to the count of the
   same configuration's step on the CPU and their ``mfu`` in (0, 1), the
   decomposition of the run's trace reconciled exactly (its categories
   printed); (b) the same with ``--pipeline`` — every non-``perf`` row
   and the ``--log-json`` stream equal to (a)'s byte for byte, the
   strict sync monitor clean, the blockwise five (bf16 mode) and
   ``round_bf16`` launched by every replay; (c) dense, in turns in one
   process: the median step ms over steps 2-6 with telemetry and health
   against without, synchronous and pipelined; (d) ``prof --step
   train`` at batch 120 (the report validated, the top regions printed
   with their bound class) and ``time`` at batch 120 (``step_flops`` and
   ``mfu`` printed); (e) any failure above, a latched telemetry failure
   included, fails the phase;
6. the five blockwise kernels (``csrc/npair_blockwise.cu``) at N = M =
   120 and 8192, D = 1024, in their fp32 mode (matmul precision
   HIGHEST) and their bf16 mode (DEFAULT: bf16-rounded operands, the
   gq/gdb weight tile rounded in the kernel), against their plain
   sweeps in the same mode: from the stats
   kernel's own emitted sims, minima, maxima, counts, histograms and
   the K-slot buffer bit for bit, I/D sums within 1e-4 relative, gq/gdb
   within 1e-5 / 1e-4 of their largest entry; the sims within 1e-5 of
   cuBLAS's product of the mode's operands (in the bf16 mode its bf16
   product of the same bf16 rows, which every bf16 kernel that multiplies
   rows is handed as ``rows16``); cached and recompute variants
   bit for bit; every kernel, cached
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
   yardstick for the cached sweeps; then the bf16 mode, every sim on
   the tensor cores (the shared wgmma sim tile of stats, the recompute
   hist and loss, and the recompute gq/gdb): in the three configs cache
   on = off (loss, aux, both gradients) and, for REFERENCE_CONFIG,
   ``pos_topk`` 8 = 0 bit for bit; every kernel (cached and recompute)
   launched twice the same bits and against its plain sweep on the
   kernel's own sims, the sims within 1e-5 of cuBLAS's bf16 product of
   the same bf16 rows and never -0; HGMMA in the SASS of every bf16
   instantiation (stats, the recompute hist and loss, the four gq/gdb;
   ``cuobjdump -sass``) and in no fp32 stats/hist/loss; the same checks
   at N = M = 1000 with D = 68 (a gq/gdb cluster of 4) and D = 1028 (a
   cluster of 8), and on a batch of zero and orthogonal rows; each
   kernel's time beside the fp32 mode's and its bound at the dense bf16
   peak, with cuBLAS's bf16 ``rows16 @ rows16.T`` beside stats, hist and
   loss and its bf16 product of the materialised 32,768² weight matrix by
   the bf16 rows beside gq/gdb (yardsticks, timings only);
7. the ResNet and ViT trunk families and Caffe interchange, under
   ``build/trunk_smoke/`` (cuDNN deterministic): (a) ``train`` in-process
   on ``examples/resnet50_sop_solver.prototxt`` cut to 6 iterations
   (display 1, snapshot 3; ResNet-50 at batch 128 = 64 x 2, 224², pre-made
   synthetic batches) under ``mxu``, dense and ``--engine blockwise``
   (the net's mining swapped for the reference's, as in 6b), each
   synchronously and with ``--pipeline``: finite losses, display
   lines and ``--log-json`` records byte for byte, the final state bit
   for bit, one capture and 4 replays, the blockwise run's bf16 five and
   ``round_bf16`` launched; step ms over steps 2-6 and peak memory; a
   ``--resume`` from the dense run's iter-3 snapshot ends on its state bit
   for bit; (b) ``resnet50`` under ``fp32_parity`` on 4 images of 224²,
   card against CPU on weights carried by ``models/convert.py``: the
   training-mode forward and one backward within ``P7_TOL``; (c) ``train
   --model vit_b16 --precision mxu --engine blockwise`` on the
   GoogLeNet/CUB cut with the reference's mining (batch 120, 224²):
   finite losses, the five launched,
   step ms; the ``fp32_parity`` forward of 2 images card against CPU;
   ``prof --step train`` for ``vit_b16`` and ``resnet50``: at batch 8
   (``fp32_parity``) the card's step FLOPs equal to the CPU's count, at
   batch 120 / 128 (``mxu``) the report and its MFU; (d)
   ``tools.vit_stretch --batch 4096 --image 64 --steps 3 --mining
   flagship``: ms/step, embeddings/s, peak memory, the five launched;
   (e) ``.caffemodel`` files of a random ``resnet50`` and a plain
   ``googlenet`` written by the port's codec, ``import-caffemodel`` ->
   ``train --weights`` -> ``export-caffemodel --snapshot`` ->
   ``import-caffemodel`` bit for bit; GoogLeNet also through ``test
   --caffe-pad`` and ``train --caffe-solverstate`` (iteration 3 resumed,
   steps 4-5, the exported solverstate's momentum and iteration equal to
   the snapshot's); (f) ``serve --model resnet50`` and ``--model
   vit_b16`` (``cli.build_server``, buckets of 1, the fused probe) over
   an IVF gallery of 2,048 of the trunk's own embeddings: 38 raw 224²
   queries answered, each equal to a direct forward plus the scan
   engine (the probe's plain version; scores within ``TOL["serve_trunk"]``,
   rows outside ties), the probe launched once a query;
8. observability of serving and the fleet, under ``build/obs_smoke/``:
   (a) ``serve --telemetry-dir`` through ``cli.build_server`` at phase
   4's configuration (IVF 246 clusters, probes 8, the fused probe, top-k
   10, buckets 1/8/32, ``googlenet_pallas`` bf16 at 224²) with 2
   replicas and metrics window 16, over HTTP, beside the same index and
   trunk without telemetry: phase 4's 38 queries in one body, 3 turns
   each in alternation; the first turn's answers equal without the
   freshness ages, the run dir's manifest, row envelopes and trace
   valid, every ``serve/*`` span present, one dispatch lane per replica,
   ⌊38/16⌋ window rows after the first turn, the drain's latency split
   equal to the split of the spans after the server's construction (no
   warm-up span among them), the probe and the three stem kernels
   launched (their counts printed), per-query p50/p99 with and without
   telemetry; (b) ``prof --step serve --gallery 60502 --dim 1024
   --buckets 1,8,32``: the report valid, its regions with their bound
   class, ms per query at bucket 32 and its MFU; (c) 5i (b)'s two
   spawned ranks on cuda:0 over gloo take 4 more googlenet_bn mxu dense
   steps under fleet telemetry (in 5i's pool, before the later phases
   fill the card), then ``prof --fleet`` and ``timeline`` over that run
   dir: the fleet report, the merged trace and the timeline
   valid, both ranks present, ``fleet_comms.json``'s gradient
   all-reduce claim equal to the parameter bytes; the straggler, the
   skew and the all-reduce's rate printed; (d) ``device-query``:
   platform ``gpu``, the card's name, ``bytes_limit`` > 0; (e) ``train
   --debug-checks`` on the phase-5h cut (googlenet_pallas fp32, 6
   steps): records byte for byte with the run without it; with
   ``step.nan_loss`` armed the run ends rc 0 with the NaN in its display
   row, as the JAX CLI's does (the check precedes the loop's poison); a
   parameter set to NaN before step 3 stops the run with the JAX CLI's
   ``FloatingPointError`` naming the metric;
9. a ``{"kernels": [...]}`` line (launches of the serving kernels from
   phase 4, of the training kernels from phase 5, of ``lrn_bwd`` from
   the phase-5b recompute step, of the blockwise kernels from phase
   6b; the five blockwise kernels again as ``<name>:bf16``, their bf16
   mode, with its launches in phase 5f's blockwise run; the bf16 entries
   name their tensor-core kernels, and stats carries cuBLAS's bf16
   ``rows16 @ rows16.T`` as ``library_ms``, hist and loss none: the
   path's cached variants compute no product; phase 7's launches of the
   bf16 five, ``round_bf16`` and the probe as ``launches_phase7``; phase
   8 (a)'s launches of the probe and the three stem kernels as
   ``launches_phase8``); then the card line; then the last line
   ``{"ok": true, "device": {...}}``.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
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
    # A served answer's scores against a direct bf16 trunk forward of
    # the same image and the plain probe: cuBLAS may take another bf16
    # GEMM algorithm for one call than for another of the same shape, so
    # a ViT-B/16 embedding at batch 1 is reproducible to bf16 noise only
    # (served vs direct: a self-score of 0.99994, so |dq| = 0.011 bounds
    # every score's move; 3.7e-3 seen on an H100); ResNet's cuDNN
    # convolutions agreed within 6e-7.
    "serve_trunk": 2e-2,
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
    sizes = n // ids + (np.arange(ids) < n % ids)
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
    """A copy of x with NaN planted every ``step`` elements, at x's
    storage offset (so with x's alignment: an operand off 16-byte
    alignment stays off it)."""
    off = x.storage_offset()
    xn = x.new_empty(off + x.numel())[off:].view(x.shape)
    xn.copy_(x)
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


def bias_relu_matches_plain(torch, stem, x, bias, nan_step: int = 997):
    """fused_bias_relu on x and on x with NaN planted: (the plain
    version's bits on both, NaN positions included; the launches and
    scalar-path launches its counters gained)."""
    f = stem.fused_bias_relu
    before = (f.launches, f.scalar_launches)
    same = all(same_nan_and_bits(torch, f(t, bias),
                                 stem.bias_relu_plain(t, bias))
               for t in (x, with_nans(x, nan_step)))
    return same, {"launches": f.launches - before[0],
                  "scalar_launches": f.scalar_launches - before[1]}


def check_bias_relu_path(torch, stem, x, bias, path, what):
    """Fail unless bias_relu_matches_plain holds and both calls took the
    kernel's ``path`` ("vector" or "scalar"); returns the counts."""
    same, counts = bias_relu_matches_plain(torch, stem, x, bias)
    if not same:
        fail(f"bias_relu {what}: not the plain version's bits")
    want = {"launches": 2, "scalar_launches": 2 if path == "scalar" else 0}
    if counts != want:
        fail(f"bias_relu {what}: launch counters {counts}, expected the "
             f"{path} path {want}")
    return counts


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
                if name == "lrn" and not torch.equal(got, want):
                    fail(f"lrn_fwd {tag} {shape}: not the plain version's "
                         "bits")
                if name == "bias_relu":  # bit for bit, NaN kept
                    check_bias_relu_path(torch, stem, x, b, "vector",
                                         f"{tag} {shape}")
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
            if not (torch.equal(out, out_p) and torch.equal(d, d_p)):
                fail(f"lrn_fwd_cached {tag} {shape}: not the plain "
                     "version's bits")
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
    """The LRN, bias+ReLU and bias+ReLU+pool kernels off their vector
    paths: C = 100 (bf16: not a multiple of the 8-wide vector) with odd
    H/W (the asymmetric SAME pads), and operands one element off 16-byte
    alignment; the pool's general kernel at a 7 x 7 / s2 window on aligned
    operands; bias+ReLU at the odd C = 3 (an odd element count).  The
    pool, bias+ReLU and the LRN forward (out and d, cached and not) must
    give the plain version's bits, the pool's and bias+ReLU's NaN
    positions included, bias+ReLU on the path its launch counters show
    (fp32 C = 100 aligned: the vector path; the rest: the scalar path);
    the LRN dx cached = recompute bit for bit and within the phase-3b
    tolerance of the plain version."""
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
            out, d = stem.lrn_fwd_cached(x)
            out_p, d_p = stem.lrn_fwd_cached_plain(x)
            fwd = bool(torch.equal(out, out_p) and torch.equal(d, d_p)
                       and torch.equal(stem.lrn_fwd(x), out_p))
            dx_c = stem.lrn_bwd_cached(x, g, d)
            err = (dx_c.float() - stem.lrn_bwd_plain(x, g, d).float()
                   ).abs().max().item()
            same = bool(torch.equal(dx_c, stem.lrn_bwd(x, g)))
            pool = pool_matches_plain(torch, stem, x, b, nan_step=97)
            relu_path = ("vector" if tag == "fp32" and offset == 0
                         else "scalar")
            relu = check_bias_relu_path(torch, stem, x, b, relu_path,
                                        f"{tag} {shape} offset {offset}")
            rows.append({"kernel": "scalar_paths", "shape": list(shape),
                         "dtype": tag, "offset_elems": offset,
                         "lrn_fwd_same_bits_as_plain": fwd,
                         "lrn_max_abs_err": err,
                         "lrn_cached_equals_recompute": same,
                         "pool_same_bits_as_plain": pool,
                         "bias_relu_path": relu_path,
                         "bias_relu_counts": relu,
                         "ok": fwd and same and pool and err <= tols[tag]})
        shape = (3, 5, 7, 3)  # odd C, odd element count
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        b = torch.randn((3,), generator=gen, device="cuda")
        relu = check_bias_relu_path(torch, stem, x, b, "scalar",
                                    f"{tag} {shape}")
        rows.append({"kernel": "bias_relu_odd_c", "shape": list(shape),
                     "dtype": tag, "bias_relu_path": "scalar",
                     "bias_relu_counts": relu, "ok": True})
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


def _rows_agree_outside_ties(np, s_p, r_k, r_p, real, what,
                             tol=TOL["probe"]):
    """Rows must agree except inside a score tie (within 2 tol); returns
    the number of rows that differ inside ties."""
    sp = s_p.cpu().numpy()
    mism = (r_k != r_p).cpu().numpy() & real.cpu().numpy()
    gap = np.full(sp.shape, np.inf, np.float32)
    diff = np.abs(np.diff(sp, axis=1))
    gap[:, 1:] = np.minimum(gap[:, 1:], diff)
    gap[:, :-1] = np.minimum(gap[:, :-1], diff)
    if (mism & (gap > 2 * tol)).any():
        fail(f"{what}: rows differ outside score ties")
    return int(mism.sum())


def _probe_against_plain(torch, np, args, kl, scoring, what):
    """The kernel against its plain version (the one-shot merge), which
    must equal the sequential merge bit for bit; (scores, rows, error,
    rows differing inside ties)."""
    from npairloss_tpu_torch.ops.ivf_probe import (
        NEG_FILL,
        probe_topk,
        probe_topk_oneshot_plain,
        probe_topk_plain,
    )

    s_k, r_k = probe_topk(*args, kl=kl, scoring=scoring)
    s_p, r_p = probe_topk_oneshot_plain(*args, kl=kl, scoring=scoring)
    s_q, r_q = probe_topk_plain(*args, kl=kl, scoring=scoring)
    torch.cuda.synchronize()
    if not (torch.equal(s_p, s_q) and torch.equal(r_p, r_q)):
        fail(f"{what}: the one-shot and sequential plain merges differ")
    real = s_p > NEG_FILL * 0.5
    if not (torch.equal(s_k[~real], s_p[~real])
            and torch.equal(r_k[~real], r_p[~real])):
        fail(f"{what}: filler slots differ from the plain version's")
    err = (s_k - s_p).abs()[real].max().item() if real.any() else 0.0
    if not err <= TOL["probe"]:
        fail(f"{what}: max_abs_err {err} > {TOL['probe']}")
    ties = _rows_agree_outside_ties(np, s_p, r_k, r_p, real, what)
    return s_k, r_k, s_p, r_p, err, ties


def check_probe_odd_dim(torch, detail):
    """The probe kernel's element-wise path: D = 100 is no multiple of a
    16-byte vector in bf16 and int8 (fp32 rows are 25 vectors).  Ragged
    clusters, one empty."""
    import numpy as np

    from npairloss_tpu_torch.ops.ivf_probe import NEG_FILL, probe_select
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
        _, r_k, s_p, r_p, err, _ = _probe_against_plain(
            torch, np, args, 10, scoring, f"probe D=100 {scoring}")
        real = s_p > NEG_FILL * 0.5
        if not torch.equal(r_k[real], r_p[real]):
            fail(f"probe D=100 {scoring}: rows differ")
        errs[scoring] = err
    log(f"[kernel] ivf_probe element-wise path (D=100): {json.dumps(errs)}")
    detail["probe_odd_dim"] = errs


def check_probe_duplicates(torch, detail, seed: int = 4):
    """Planted duplicate rows, within a cluster (positions 3 and 7 of
    every cluster) and across clusters (row 0 of cluster 2i + 1 copies
    row 0 of cluster 2i), an empty cluster and ragged tails, probes 8
    and 16, B = 32 queries of which 16 equal duplicated rows.  Entries
    are k/8, |k| <= 8, so every score is exact in any summation order:
    scores and rows must equal the plain version's in every slot, so the
    tie rule (score, then the lowest position of [probe 0's tile; probe
    1's; ...]) is the kernel's own."""
    from npairloss_tpu_torch.ops.ivf_probe import probe_select
    from npairloss_tpu_torch.serve.ivf import quantize_int8

    import numpy as np

    gen = torch.Generator(device="cuda").manual_seed(seed)
    kc, cap, d, bq = 16, 322, 1024, 32

    def dyadic(*shape):
        return torch.randint(-8, 9, shape, generator=gen,
                             device="cuda").float() / 8

    packed = dyadic(kc, cap, d)
    packed[:, 7] = packed[:, 3]
    packed[1::2, 0] = packed[0::2, 0]
    rows = torch.arange(kc * cap, dtype=torch.int32,
                        device="cuda").reshape(kc, cap)
    rows[:, 300:] = -1
    rows[5] = -1
    q = torch.cat([packed[:8, 3], packed[0::2, 0], dyadic(bq - 16, d)])
    valid = rows >= 0
    cents = (packed * valid[:, :, None]).sum(1) / valid.sum(1).clamp(
        min=1)[:, None]
    out = {}
    for probes in (8, 16):
        _, lids, owned = probe_select(q, cents, valid.any(1), probes, 0, kc)
        owned = owned.to(torch.int32).contiguous()
        for scoring, (slab, scale) in (
                ("fp32", (packed, None)),
                ("bf16", (packed.to(torch.bfloat16), None)),
                ("int8", quantize_int8(packed))):
            args = (q, slab, rows, lids, owned, scale)
            what = f"probe duplicates probes {probes} {scoring}"
            s_k, r_k, s_p, r_p, _, _ = _probe_against_plain(
                torch, np, args, 10, scoring, what)
            if not (torch.equal(s_k, s_p) and torch.equal(r_k, r_p)):
                fail(f"{what}: not the plain version's scores and rows")
            ties = int((s_p[:, 1:] == s_p[:, :-1]).sum().item())
            if ties < 8:
                fail(f"{what}: only {ties} tied neighbours")
            out[f"probes{probes}_{scoring}"] = {"tied_neighbours": ties,
                                                "equal": True}
    log(f"[kernel] ivf_probe planted duplicates: {json.dumps(out)}")
    detail["probe_duplicates"] = out


def check_probe_large_cap(torch, timer, detail, seed: int = 6):
    """A cluster capacity the old kernel refused (its shared memory grew
    with cap: 28,000 rows at D = 1024): KC = 2, cap 40,000, D = 1024,
    fp32 (328 MB of slab, unit rows), B = 8, both clusters probed."""
    import numpy as np

    from npairloss_tpu_torch.ops.ivf_probe import probe_select, probe_topk

    gen = torch.Generator(device="cuda").manual_seed(seed)
    kc, cap, d, bq, kl = 2, 40000, 1024, 8, 10
    packed = torch.randn((kc, cap, d), generator=gen, device="cuda")
    packed /= packed.norm(dim=2, keepdim=True)  # unit rows, as a gallery's
    rows = torch.arange(kc * cap, dtype=torch.int32,
                        device="cuda").reshape(kc, cap)
    rows[1, 39000:] = -1
    q = torch.randn((bq, d), generator=gen, device="cuda")
    q /= q.norm(dim=1, keepdim=True)
    _, lids, owned = probe_select(q, torch.randn((kc, d), generator=gen,
                                                 device="cuda"),
                                  torch.ones(kc, dtype=torch.bool,
                                             device="cuda"), 2, 0, kc)
    owned = owned.to(torch.int32).contiguous()
    args = (q, packed, rows, lids, owned, None)
    _, _, _, _, err, ties = _probe_against_plain(
        torch, np, args, kl, "fp32", "probe cap 40000")
    valid_rows = int((rows[lids.long()] >= 0).sum().item())
    bms, by = bound_ms(valid_rows * d * 4, 2.0 * valid_rows * d, "fp32")
    row = {"batch": bq, "probes": 2, "cap": cap, "dim": d,
           "slab_bytes": packed.numel() * 4, "max_abs_err": err,
           "row_mismatches_in_ties": ties,
           "ms": timer.ms(lambda: probe_topk(*args, kl=kl, scoring="fp32")),
           "bound_ms": bms, "bound_by": by}
    log(f"[kernel] ivf_probe cap 40000: {json.dumps(row)}")
    detail["probe_large_cap"] = row


def check_probe(torch, timer, index, queries, detail):
    """The probe at the serving path's buckets B = 1, 8, 32 and probes 8
    and 16 (16 exceeds a portable cluster: a CTA takes two probes), each
    scoring against the plain version and timed; the plain version timed
    at the path's own call (B = 32, probes 8).  Beside each time, the
    bound over each (query, probe)'s rows and the one over each probed
    cluster read once (queries sharing a cluster may hit the L2); the
    plain version timed at probes 8."""
    import numpy as np

    from npairloss_tpu_torch.ops.ivf_probe import (
        probe_select,
        probe_topk,
        probe_topk_oneshot_plain,
    )

    layout = index.layout
    cap, d, k = layout.cap, index.dim, 10
    out, sweep = {}, []
    for probes in (8, 16):
        for bq in (1, 8, 32):
            q = torch.as_tensor(queries[:bq], device="cuda")
            _, lids, owned = probe_select(q, layout.centroids,
                                          layout.cluster_valid, probes, 0,
                                          layout.packed.shape[0])
            owned = owned.to(torch.int32).contiguous()
            kl = min(k, probes * cap)
            valid_rows = int((layout.rows[lids.long()] >= 0).sum().item())
            uniq = torch.unique(lids.long())
            unique_rows = int((layout.rows[uniq] >= 0).sum().item())
            main = bq == 32 and probes == 8
            for scoring in ("fp32", "bf16", "int8"):
                slab, scale = index.scored_arrays(scoring)
                args = (q, slab, layout.rows, lids, owned, scale)
                what = f"probe B={bq} probes {probes} {scoring}"
                _, _, _, _, err, ties = _probe_against_plain(
                    torch, np, args, kl, scoring, what)
                el = slab.element_size()
                side = (lids.numel() * cap * 4 + q.numel() * 4
                        + 2 * lids.numel() * 4 + bq * kl * 8
                        + (lids.numel() * 4 if scale is not None else 0))
                bms, by = bound_ms(valid_rows * d * el + side,
                                   2.0 * valid_rows * d, scoring)
                row = {"batch": bq, "probes": probes, "k": k, "cap": cap,
                       "dim": d, "scoring": scoring,
                       "probed_rows": valid_rows,
                       "probed_unique_rows": unique_rows,
                       "max_abs_err": err, "tol": TOL["probe"],
                       "row_mismatches_in_ties": ties,
                       "ms": timer.ms(lambda: probe_topk(
                           *args, kl=kl, scoring=scoring)),
                       "plain_ms": (timer.ms(lambda: probe_topk_oneshot_plain(
                           *args, kl=kl, scoring=scoring))
                                    if probes == 8 else None),
                       "bound_ms": bms, "bound_by": by,
                       "bound_unique_ms": bound_ms(
                           unique_rows * d * el + side,
                           2.0 * valid_rows * d, scoring)[0],
                       "library_ms": None}
                sweep.append(row)
                if main:
                    out[scoring] = row
                log(f"[kernel] ivf_probe {what}: {json.dumps(row)}")
    detail["probe"] = out
    detail["probe_sweep"] = sweep
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
        ServerConfig(poll_s=0.01, explicit_drops=True),
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


def cut_solver(work: str, name: str = "solver.prototxt",
               source: str = os.path.join("examples",
                                          "googlenet_cub_solver.prototxt"),
               **over) -> str:
    """The GoogLeNet/CUB solver (or the solver at ``source``) cut to 6
    iterations (test_iter 2, display 1, snapshot 0; ``over`` replaces
    these or other keys), written under ``work`` as ``name``; returns its
    path."""
    import re

    os.makedirs(work, exist_ok=True)
    text = open(source).read()
    keys = {"max_iter": 6, "test_iter": 2, "display": 1, "snapshot": 0}
    keys.update(over)
    for key, val in keys.items():
        text, n = re.subn(rf"(?m)^{key}:.*$", f"{key}: {val}", text)
        if n != 1:
            fail(f"solver prototxt has {n} '{key}:' lines")
    path = os.path.join(work, name)
    with open(path, "w") as f:
        f.write(text)
    return path


def drive_train(torch, seed, detail):
    """``npairloss_tpu_torch.cli train`` on the shipped GoogLeNet/CUB
    solver, cut to 6 iterations: googlenet_pallas, batch 120 (60 x 2),
    224x224, fp32, synthetic identity batches."""
    import contextlib
    import math

    from npairloss_tpu_torch import cli
    from npairloss_tpu_torch.data.synthetic import synthetic_identity_batches
    from npairloss_tpu_torch.ops import _build
    from npairloss_tpu_torch.train import solver as tsolver

    work = os.path.join("build", "train_smoke")
    solver_path = cut_solver(work)
    events_path = os.path.join(work, "events.jsonl")
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
                       "profile": profile_train_step(
                           torch, lambda: solver.step(x, lab)),
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
    ("blockwise kernels (csrc/npair_blockwise.cu)", ("npair_",
                                                     "round_bf16_")),
    ("stem kernels (csrc/stem.cu)", ("lrn_fwd_", "lrn_bwd_", "bias_relu_")),
    ("host-device copies", ("memcpy",)),
    ("pooling", ("pool",)),
    ("layout transposes", ("nhwc", "nchw", "transpose")),
    ("convolution (cuDNN)", ("conv", "xmma", "implicit", "wgrad", "dgrad",
                             "fprop", "winograd", "fft", "cudnn")),
    ("matmul (cuBLAS)", ("gemm", "gemv", "cutlass")),
    # PyTorch's own kernels: BatchNorm's arithmetic and statistics, ReLU,
    # casts, the optimizer's updates.
    ("torch elementwise and reductions", ("elementwise_kernel",
                                          "reduce_kernel")),
)


def step_category(name: str) -> str:
    """The STEP_CATEGORIES entry a kernel's name falls in."""
    name = name.lower()
    return next((c for c, pats in STEP_CATEGORIES
                 if any(p in name for p in pats)), "other")


def profile_train_step(torch, step, steps=3):
    """Where a step's device time goes: ``torch.profiler`` over ``steps``
    more calls of ``step`` (a training step, with its batch's loading
    where that is part of it), kernels grouped by name, the stem kernels
    also one by one.  A measurement, not a check: with no device records
    it says 'not measured'."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
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
        cat = step_category(e.name)
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
    other = sorted(((n, ms) for n, ms in by_name.items()
                    if step_category(n) == "other"), key=lambda kv: -kv[1])
    for name, ms in other[:3]:
        log(f"[profile]   top other {ms:.3f} ms  {name[:110]}")
    stem = {n: ms for n, ms in by_name.items()
            if step_category(n) == "stem kernels (csrc/stem.cu)"}
    for name, ms in sorted(stem.items(), key=lambda kv: -kv[1]):
        log(f"[profile]   stem kernel {ms:.3f} ms  {name[:110]}")
    return {"wall_ms": wall, "busy_ms": busy, "by_category_ms": by_cat,
            "top_kernels_ms": dict(top), "top_other_ms": dict(other[:3]),
            "stem_kernels_ms": stem}


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


# -- phase 5d: the training path on list files -------------------------------


def write_ppm_dataset(root, prefix, seed, ids, per_id, sides=(240, 400)):
    """``ids`` identities x ``per_id`` PPM images named ``prefix``* under
    ``root``, each side drawn from ``sides`` (so the native resize runs),
    each identity a random colour under uniform noise; writes their list
    file (``relative/path label`` rows) and returns its path."""
    import numpy as np

    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    rows = []
    for ident in range(ids):
        colour = rng.integers(40, 216, 3).astype(np.int16)
        for k in range(per_id):
            h, w = (int(v) for v in rng.integers(sides[0], sides[1] + 1, 2))
            noise = rng.integers(-40, 41, (h, w, 3), dtype=np.int16)
            img = (colour + noise).astype(np.uint8)
            name = f"{prefix}{ident:04d}_{k}.ppm"
            with open(os.path.join(root, name), "wb") as f:
                f.write(b"P6\n%d %d\n255\n" % (w, h) + img.tobytes())
            rows.append(f"{name} {ident}")
    src = os.path.join(root, f"{prefix}list.txt")
    with open(src, "w") as f:
        f.write("\n".join(rows) + "\n")
    return src


def drive_list_train(torch, seed, detail, synthetic_step_ms,
                     net="examples/googlenet_cub.prototxt", train_ids=100,
                     test_ids=30, per_id=4, sides=(240, 400)):
    """Phase 5d: ``train`` on list files with ``--native require``, no
    ``--synthetic``: the shipped GoogLeNet/CUB net with only
    ``root_folder`` and ``source`` rewritten to PPM images written here
    (``train_ids`` x ``per_id`` TRAIN, ``test_ids`` x ``per_id`` TEST),
    the phase-5 solver cut, ``googlenet_pallas`` fp32.  Checks: finite
    losses and metrics, every batch on the card at the net's shape
    (random crop and mirror on the card for TRAIN, centre crop for TEST),
    an iter-0 TEST pass, the stem kernels launched by the steps (bias+ReLU
    on its vector path), the TEST loader's batch on the card equal to the
    same loader's on the CPU, and a ``next`` of the loader with no host
    sync.  Reports the median step ms beside phase 5's synthetic step and
    the loader's median wait per step."""
    import contextlib
    import math

    from npairloss_tpu_torch import cli
    from npairloss_tpu_torch.config.schema import load_net
    from npairloss_tpu_torch.data import loader as dloader
    from npairloss_tpu_torch.ops import _build, stem
    from npairloss_tpu_torch.train import solver as tsolver

    work = os.path.join("build", "data_smoke")
    images = os.path.join(work, "images")
    t0 = time.perf_counter()
    train_src = write_ppm_dataset(images, "train_", seed + 10, train_ids,
                                  per_id, sides)
    test_src = write_ppm_dataset(images, "test_", seed + 11, test_ids,
                                 per_id, sides)
    log(f"[data] wrote {train_ids * per_id} TRAIN and {test_ids * per_id} "
        f"TEST PPM images (sides {sides[0]}-{sides[1]} px) in "
        f"{time.perf_counter() - t0:.2f} s")
    text = open(net).read()
    net_cfg = load_net(net)
    for phase, src in (("TRAIN", train_src), ("TEST", test_src)):
        old = f'source: "{net_cfg.data[phase].source}"'
        if text.count(old) != 1:
            fail(f"net has {text.count(old)} lines '{old}'")
        text = text.replace(old, f'source: "{src}"')
    for phase in ("TRAIN", "TEST"):
        old = f'root_folder: "{net_cfg.data[phase].root_folder}"'
        text = text.replace(old, f'root_folder: "{images}/"')
    net_path = os.path.join(work, "net.prototxt")
    with open(net_path, "w") as f:
        f.write(text)
    net_cfg = load_net(net_path)
    solver_path = cut_solver(work)
    events_path = os.path.join(work, "events.jsonl")
    if os.path.exists(events_path):
        os.remove(events_path)

    seen = {"after_test": None, "step_ms": [], "wait_ms": [], "batches": [],
            "solver": None}
    orig_step = tsolver.Solver.step
    orig_next = dloader.NativeMultibatchLoader.__next__

    def timed_step(self, inputs, labels):
        if seen["after_test"] is None:
            seen["after_test"] = _build.launch_counts()
        seen["solver"] = self
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = orig_step(self, inputs, labels)
        torch.cuda.synchronize()
        seen["step_ms"].append((time.perf_counter() - t0) * 1e3)
        return m

    def timed_next(self):
        t0 = time.perf_counter()
        x, lab = orig_next(self)
        if self.train:
            seen["wait_ms"].append((time.perf_counter() - t0) * 1e3)
        seen["batches"].append(("TRAIN" if self.train else "TEST",
                                tuple(x.shape), x.device.type, str(x.dtype),
                                lab.device.type))
        return x, lab

    out = io.StringIO()
    tsolver.Solver.step = timed_step
    dloader.NativeMultibatchLoader.__next__ = timed_next
    _build.reset_launch_counts()
    scalar0 = stem.fused_bias_relu.scalar_launches
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(["train", "--solver", solver_path, "--net",
                           net_path, "--model", "googlenet_pallas",
                           "--native", "require", "--log-json",
                           events_path, "--seed", str(seed)])
        torch.cuda.synchronize()
    finally:
        tsolver.Solver.step = orig_step
        dloader.NativeMultibatchLoader.__next__ = orig_next
    wall = time.perf_counter() - t0
    total = _build.launch_counts()
    for ln in out.getvalue().splitlines():
        log(f"[list-train] {ln}")
    if rc != 0:
        fail(f"train on list files returned {rc}")
    final = json.loads(out.getvalue().strip().splitlines()[-1])
    events = [json.loads(ln) for ln in open(events_path)]
    if [(e["event"], e["iteration"]) for e in events] != \
            [("test", 0)] + [("display", i) for i in range(1, 7)]:
        fail(f"unexpected event stream: "
             f"{[(e['event'], e['iteration']) for e in events]}")
    for rec in events + [final]:
        bad = {k: v for k, v in rec.items()
               if isinstance(v, float) and not math.isfinite(v)}
        if bad:
            fail(f"non-finite values in {rec.get('event', 'final')}: {bad}")
    crop = net_cfg.data["TRAIN"].transform.crop_size
    want = {"TRAIN": (net_cfg.data["TRAIN"].batch_size, crop, crop, 3),
            "TEST": (net_cfg.data["TEST"].batch_size, crop, crop, 3)}
    bad = [b for b in seen["batches"]
           if (b[1], b[2], b[3], b[4]) != (want[b[0]], "cuda",
                                           "torch.float32", "cuda")]
    phases = [b[0] for b in seen["batches"]]
    if bad or phases.count("TEST") < 2 or phases.count("TRAIN") < 6:
        fail(f"list-file batches off the card or off shape: {bad or phases}")
    after_test = seen["after_test"]
    in_train = {k: total[k] - after_test[k] for k in total}
    for name in ("lrn_fwd_cached", "lrn_bwd_cached", "fused_bias_relu",
                 "fused_bias_relu_pool"):
        if in_train[name] < 1:
            fail(f"kernel {name} was not launched by the list-file steps")
    scalar = stem.fused_bias_relu.scalar_launches - scalar0
    if scalar:
        fail(f"bias_relu took its scalar path {scalar} times on the path")

    # The TEST loader (centre crop, mean, no random draw) on the card
    # equals the same loader on the CPU; one more batch under PyTorch's
    # sync debug mode at "error": the loader makes no host sync.
    d_test = net_cfg.data["TEST"]
    with dloader.multibatch_loader(d_test, net_cfg.transformer, seed=1,
                                   native="require", device="cuda") as a, \
            dloader.multibatch_loader(d_test, net_cfg.transformer, seed=1,
                                      native="require", device="cpu") as b:
        (xa, la), (xb, lb) = next(a), next(b)
        if not (torch.equal(xa.cpu(), xb) and torch.equal(la.cpu(), lb)):
            fail("the TEST batch on the card differs from the CPU's")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            next(a)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    # Where a step on list files goes, its batch's next() included (the
    # native runtime's copy out of its ring, the upload, the crop, mirror
    # and mean on the card).
    solver = seen["solver"]
    log("[list-train] profile of a list-file step, its next() included:")
    with dloader.multibatch_loader(net_cfg.data["TRAIN"],
                                   net_cfg.transformer, seed=2,
                                   native="require", device="cuda") as ldr:
        solver.step(*next(ldr))
        profile = profile_train_step(torch, lambda: solver.step(*next(ldr)))
    step_ms = statistics.median(seen["step_ms"][1:])
    wait_ms = statistics.median(seen["wait_ms"][1:])
    batch = want["TRAIN"][0]
    log(f"[list-train] step ms {[round(t, 3) for t in seen['step_ms']]}; "
        f"median over steps 2-6 {step_ms:.3f} ms = "
        f"{batch / step_ms * 1e3:.1f} images/s (phase 5, synthetic: "
        f"{synthetic_step_ms:.3f} ms); loader wait per step "
        f"{[round(t, 3) for t in seen['wait_ms']]}, median over steps 2-6 "
        f"{wait_ms:.3f} ms; TEST batch card = CPU; a loader batch made no "
        f"host sync; whole command {wall:.1f} s")
    detail["list_train"] = {
        "final": final, "events": events, "launches_train": in_train,
        "step_ms": seen["step_ms"], "median_step_ms": step_ms,
        "synthetic_median_step_ms": synthetic_step_ms,
        "wait_ms": seen["wait_ms"], "median_wait_ms": wait_ms,
        "batches": seen["batches"], "wall_s": wall, "profile": profile}
    return in_train, step_ms, net_path


# -- phase 5e: snapshots, resume, preemption and the eval commands -----------

SNAP_WORK = os.path.join("build", "snap_smoke")


def retention(k, max_iter=6, every=2, keep=2):
    """The snapshot steps the JAX package's retention rule leaves after a
    run preempted at step k (cadence commits, then the emergency commit
    at k) and after its relaunch to ``max_iter``: GC keeps the newest
    ``keep`` after every commit."""
    def commit(steps, s):
        return sorted(set(steps) | {s})[-keep:]

    first = []
    for s in range(1, k + 1):
        if s % every == 0:
            first = commit(first, s)
    first = commit(first, k)
    final = first
    for s in range(k + 1, max_iter + 1):
        if s % every == 0:
            final = commit(final, s)
    return first, final


def preemption_drill(seed, net_path, detail, card):
    """5e (a): ``train --native require`` in a subprocess on the list
    files of 5d (max_iter 6, snapshot 2, display 1, --snapshot-keep 2),
    SIGTERM once it prints ``iter 3``: exit 75, a committed snapshot at
    the printed iteration k that the validator accepts, no ``.tmp-`` dir;
    the same command with ``--resume auto``: "resuming from iteration k",
    exit 0, the snapshot steps the retention rule leaves."""
    import re
    import shutil
    import signal

    from npairloss_tpu_torch.resilience import snapshot as snap

    work = os.path.join(SNAP_WORK, "drill")
    shutil.rmtree(work, ignore_errors=True)
    solver_path = cut_solver(work, snapshot=2)
    prefix = os.path.join(work, "m_")
    argv = [sys.executable, "-m", "npairloss_tpu_torch", "train",
            "--solver", solver_path, "--net", net_path, "--model",
            "googlenet_pallas", "--native", "require", "--snapshot-keep",
            "2", "--snapshot_prefix", prefix, "--seed", str(seed)]
    t0 = time.perf_counter()
    lines, sent = [], None
    with open(os.path.join(work, "stderr.txt"), "w") as err:
        proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=err,
                                text=True)
        try:
            for ln in proc.stdout:
                lines.append(ln.rstrip("\n"))
                if sent is None and re.match(r"iter 3 lr=", ln):
                    proc.send_signal(signal.SIGTERM)
                    sent = time.perf_counter()
            rc = proc.wait(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    first_s = time.perf_counter() - t0
    for ln in lines:
        log(f"[drill] {ln}")
    if sent is None:
        fail("the preempted run never printed 'iter 3'")
    if rc != 75:
        err = open(os.path.join(work, "stderr.txt")).read()
        fail(f"the preempted run exited {rc}, not 75 (stderr: "
             f"{err[-2000:]})")
    recs = [json.loads(ln) for ln in lines if ln.startswith('{"preempted"')]
    if len(recs) != 1:
        fail(f"no single preempted record in the output: {recs}")
    k = recs[0]["iteration"]
    path = os.path.abspath(f"{prefix}iter_{k}.ckpt")
    if k < 3 or recs[0]["snapshot"] != path:
        fail(f"unexpected preempted record {recs[0]}")
    if snap.validate_snapshot(path)["step"] != k:
        fail(f"the emergency snapshot {path} is not at step {k}")
    tmp = [n for n in os.listdir(work) if snap.TMP_MARKER in n]
    want_first, want_final = retention(k)
    got_first = [s for s, _ in snap.list_snapshots(prefix)]
    if tmp or got_first != want_first:
        fail(f"after the preemption: snapshots {got_first} (want "
             f"{want_first}), tmp dirs {tmp}")
    t0 = time.perf_counter()
    proc = subprocess.run(argv + ["--resume", "auto"], capture_output=True,
                          text=True, timeout=300)
    second_s = time.perf_counter() - t0
    for ln in proc.stdout.splitlines():
        log(f"[drill-resume] {ln}")
    got_final = [s for s, _ in snap.list_snapshots(prefix)]
    if proc.returncode != 0 \
            or f"resuming from iteration {k}" not in proc.stdout:
        fail(f"the relaunch exited {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
    if got_final != want_final:
        fail(f"after the relaunch: snapshots {got_final}, want {want_final}")
    for _, p in snap.list_snapshots(prefix):
        snap.validate_snapshot(p)
    log(f"[drill] SIGTERM after 'iter 3' -> exit 75 with a committed "
        f"snapshot at iteration {k} (kept {got_first}); the relaunch with "
        f"--resume auto resumed at {k} and exited 0 (kept {got_final}); "
        f"{first_s:.1f} s + {second_s:.1f} s of subprocess wall ({card})")
    detail["drill"] = {"k": k, "first": got_first, "final": got_final,
                       "first_s": first_s, "second_s": second_s}


def _net_solver(torch, seed, solver_cfg, net_cfg):
    from npairloss_tpu_torch.models import get_model
    from npairloss_tpu_torch.train.solver import Solver

    model = get_model("googlenet_pallas", device="cuda", seed=seed,
                      dtype=torch.float32)
    return Solver(model, net_cfg.loss.loss, solver_cfg,
                  param_mults=net_cfg.param_mults,
                  loss_weight=(net_cfg.loss.loss_weights[0]
                               if net_cfg.loss.loss_weights else 1.0))


def check_resume_bits(torch, seed, detail, card):
    """5e (b): solver A trains 6 steps on six fixed synthetic batches with
    a snapshot at 3 (and 6); a freshly built solver B restores iter 3 and
    trains steps 4-6 on batches 3-5: parameters, buffers and momentum
    equal A's bit for bit (cuDNN deterministic).  Returns A's iter-6
    snapshot and the launches of A's six steps."""
    import dataclasses
    import shutil

    from npairloss_tpu_torch.config.schema import load_net, load_solver
    from npairloss_tpu_torch.data.synthetic import synthetic_identity_batches
    from npairloss_tpu_torch.ops import _build
    from npairloss_tpu_torch.resilience import snapshot as snap

    work = os.path.join(SNAP_WORK, "bits")
    shutil.rmtree(work, ignore_errors=True)
    solver_cfg, _ = load_solver(cut_solver(work, snapshot=3, display=0))
    solver_cfg = dataclasses.replace(
        solver_cfg, test_interval=0, snapshot_prefix=os.path.join(work, "m_"))
    net_cfg = load_net("examples/googlenet_cub.prototxt")
    gen = synthetic_identity_batches(240, 60, 2, (224, 224, 3),
                                     seed=seed + 20)
    batches = [next(gen) for _ in range(6)]
    cudnn = torch.backends.cudnn
    det, bench = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        a = _net_solver(torch, seed, solver_cfg, net_cfg)
        commit_ms = []
        commit = a.save_snapshot

        def timed_commit(step):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = commit(step)
            commit_ms.append((time.perf_counter() - t0) * 1e3)
            return path

        a.save_snapshot = timed_commit
        _build.reset_launch_counts()
        a.train(iter(batches), num_iters=6, log_fn=lambda s: None)
        torch.cuda.synchronize()
        launches = _build.launch_counts()
        b = _net_solver(torch, seed + 1, solver_cfg, net_cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b.restore_snapshot(a.snapshot_path(3))
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        if b.iteration != 3:
            fail(f"restored iteration {b.iteration}, not 3")
        b.train(iter(batches[3:]), num_iters=6, log_fn=lambda s: None)
        torch.cuda.synchronize()
    finally:
        cudnn.deterministic, cudnn.benchmark = det, bench
    sa, sb = a.state_dict(), b.state_dict()
    differ = [k for k in sa if not torch.equal(sa[k], sb[k])]
    if set(sa) != set(sb) or differ:
        fail(f"resumed run differs from the uninterrupted one in {differ}")
    for name in ("lrn_fwd_cached", "lrn_bwd_cached", "fused_bias_relu",
                 "fused_bias_relu_pool"):
        if launches[name] < 1:
            fail(f"kernel {name} was not launched by solver A's steps")
    snap6 = a.snapshot_path(6)
    mapped = snap.read_state(snap6, torch.device("cuda"))
    if any(t.device.type != "cuda" for t in mapped.values()):
        fail("a restore did not map the snapshot onto the card")
    del mapped
    state_bytes = os.path.getsize(os.path.join(snap6, snap.STATE_NAME))
    model_bytes = sum(v.numel() * v.element_size() for k, v in sa.items()
                      if k.startswith("model/"))
    mom_bytes = sum(v.numel() * v.element_size() for k, v in sa.items()
                    if k.startswith("momentum/"))
    log(f"[resume] solver B restored iter 3 and trained steps 4-6: "
        f"{len(sa)} tensors equal solver A's bit for bit; commit ms "
        f"{[round(t, 3) for t in commit_ms]} (iters 3, 6), restore "
        f"{restore_ms:.3f} ms, snapshot {state_bytes} bytes (trunk "
        f"parameters and buffers {model_bytes}, momentum {mom_bytes}); "
        f"launches in A's 6 steps {json.dumps(launches)} ({card})")
    detail["resume_bits"] = {"commit_ms": commit_ms, "restore_ms": restore_ms,
                             "state_bytes": state_bytes,
                             "model_bytes": model_bytes,
                             "momentum_bytes": mom_bytes,
                             "launches": launches}
    return snap6, launches


def check_extract_test(torch, seed, detail, net_path, snap6, card):
    """5e (c): ``extract --resume <iter 6> --phase TEST --batches 4`` on
    5d's TEST list file (the net's TEST batch is 30, so 120 x 1024 rows)
    equals the restored model's eval-mode forward on the same batches bit
    for bit, rows of unit norm within 1e-5, the stem's forward kernels
    launched; ``test`` prints finite metrics."""
    import contextlib
    import math

    import numpy as np

    from npairloss_tpu_torch import cli
    from npairloss_tpu_torch.data import loader as dloader
    from npairloss_tpu_torch.ops import _build

    solver_path = os.path.join(SNAP_WORK, "bits", "solver.prototxt")
    out_prefix = os.path.join(SNAP_WORK, "features")
    argv = ["extract", "--solver", solver_path, "--net", net_path,
            "--model", "googlenet_pallas", "--native", "require",
            "--resume", snap6, "--phase", "TEST", "--batches", "4",
            "--out", out_prefix, "--seed", str(seed)]
    cudnn = torch.backends.cudnn
    det, bench = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    out = io.StringIO()
    try:
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        extract_s = time.perf_counter() - t0
        launches = _build.launch_counts()
        if rc != 0:
            fail(f"extract returned {rc}")
        solver, net_cfg, _ = cli._build_solver(
            cli.build_parser().parse_args(argv))
        with dloader.multibatch_loader(net_cfg.data["TEST"],
                                       net_cfg.transformer, seed=1,
                                       native="require",
                                       device="cuda") as ldr:
            refs, labs = [], []
            with torch.no_grad():
                for _ in range(4):
                    x, lab = next(ldr)
                    refs.append(solver.model.eval()(x).float().cpu().numpy())
                    labs.append(lab.cpu().numpy())
        ref, ref_lab = np.concatenate(refs), np.concatenate(labs)
    finally:
        cudnn.deterministic, cudnn.benchmark = det, bench
    log(f"[extract] {out.getvalue().strip()}")
    emb = np.load(out_prefix + ".emb.npy")
    labels = np.load(out_prefix + ".labels.npy")
    norms = np.linalg.norm(emb.astype(np.float64), axis=1)
    if emb.shape != (120, 1024) or not np.array_equal(emb, ref) \
            or not np.array_equal(labels, ref_lab):
        fail(f"extract's {emb.shape} embeddings differ from the restored "
             "model's forward")
    if not np.abs(norms - 1.0).max() <= 1e-5:
        fail(f"extracted rows off unit norm by {np.abs(norms - 1).max()}")
    for name in ("lrn_fwd", "fused_bias_relu", "fused_bias_relu_pool"):
        if launches[name] < 1:
            fail(f"kernel {name} was not launched by extract")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["test", "--solver", solver_path, "--net", net_path,
                       "--model", "googlenet_pallas", "--native", "require",
                       "--resume", snap6, "--iterations", "2", "--seed",
                       str(seed)])
    metrics = json.loads(out.getvalue().strip().splitlines()[-1])
    if rc != 0 or not metrics or not all(math.isfinite(v)
                                         for v in metrics.values()):
        fail(f"test returned {rc}: {metrics}")
    log(f"[extract] {emb.shape[0]} x {emb.shape[1]} embeddings equal the "
        f"restored model's forward bit for bit, row norms within "
        f"{np.abs(norms - 1).max():.3g} of 1; launches "
        f"{json.dumps(launches)}; whole command {extract_s:.2f} s ({card}); "
        f"test {json.dumps(metrics)}")
    detail["extract"] = {"launches": launches, "test": metrics,
                         "wall_s": extract_s,
                         "norm_err": float(np.abs(norms - 1).max())}
    return launches


def _boundary_tie(np, emb, labels, row, k, tol=1e-5):
    """Whether query ``row``'s hit at k can flip with rounding: its best
    same-label sim (fp64) within ``tol`` of its k-th largest sim."""
    sims = emb @ emb[row].astype(np.float64)
    sims[row] = -np.inf
    kth = np.partition(sims, -k)[-k]
    same = labels == labels[row]
    same[row] = False
    return same.any() and abs(sims[same].max() - kth) <= tol


def check_eval(torch, seed, detail, emb, labels, card):
    """5e (d): ``eval --ks 1 10 100 1000`` on the card over phase 4's
    60,502 x 1024 gallery; for 2,048 seeded query rows the per-row hits
    equal a CPU computation of the same rows outside boundary ties; then
    ``eval --nmi`` on a 5,924-row, 100-identity set (CUB-200-2011's test
    split size)."""
    import contextlib
    import math

    import numpy as np

    from npairloss_tpu_torch import cli
    from npairloss_tpu_torch.ops.eval_retrieval import first_hit_ranks

    os.makedirs(SNAP_WORK, exist_ok=True)
    prefix = os.path.join(SNAP_WORK, "gallery")
    np.save(prefix + ".emb.npy", emb)
    np.save(prefix + ".labels.npy", labels)
    ks = (1, 10, 100, 1000)
    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["eval", "--prefix", prefix, "--ks",
                       *map(str, ks)])
    eval_ms = (time.perf_counter() - t0) * 1e3
    if rc != 0:
        fail(f"eval returned {rc}")
    rec = json.loads(out.getvalue().strip().splitlines()[-1])
    rng = np.random.default_rng(seed + 40)
    rows = np.sort(rng.choice(emb.shape[0], 2048, replace=False))
    t0 = time.perf_counter()
    r_card = first_hit_ranks(torch.as_tensor(emb, device="cuda"),
                             torch.as_tensor(labels, device="cuda"), max(ks),
                             rows=torch.as_tensor(rows)).cpu().numpy()
    torch.cuda.synchronize()
    rows_ms = (time.perf_counter() - t0) * 1e3
    r_cpu = first_hit_ranks(torch.as_tensor(emb), torch.as_tensor(labels),
                            max(ks), query_block=256,
                            rows=torch.as_tensor(rows)).numpy()
    ties = 0
    for k in ks:
        for i in np.nonzero((r_card < k) != (r_cpu < k))[0]:
            if not _boundary_tie(np, emb, labels, rows[i], k):
                fail(f"row {rows[i]}: hit at {k} on the card "
                     f"{r_card[i] < k}, on the CPU {r_cpu[i] < k}, and no "
                     "boundary tie")
            ties += 1
    sub = {f"recall_at_{k}": float((r_card < k).mean()) for k in ks}
    # NMI on the size of CUB-200-2011's test split.
    nmi_emb, nmi_lab = synthetic_gallery(seed + 41, n=5924, ids=100)
    nmi_prefix = os.path.join(SNAP_WORK, "cub_test")
    np.save(nmi_prefix + ".emb.npy", nmi_emb)
    np.save(nmi_prefix + ".labels.npy", nmi_lab)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["eval", "--prefix", nmi_prefix, "--ks", "1", "2",
                       "4", "8", "--nmi"])
    nmi_ms = (time.perf_counter() - t0) * 1e3
    nmi_rec = json.loads(out.getvalue().strip().splitlines()[-1])
    if rc != 0 or not (math.isfinite(nmi_rec.get("nmi", float("nan")))
                       and 0.0 <= nmi_rec["nmi"] <= 1.0):
        fail(f"eval --nmi returned {rc}: {nmi_rec}")
    log(f"[eval] {json.dumps(rec)} in {eval_ms:.1f} ms ({card}); 2,048 "
        f"seeded rows: per-row hits card = CPU at every k ({ties} boundary "
        f"ties), their recall {json.dumps(sub)}, {rows_ms:.1f} ms on the "
        f"card; --nmi on 5,924 x 1024 (100 identities): "
        f"{json.dumps(nmi_rec)} in {nmi_ms:.1f} ms")
    detail["eval"] = {"record": rec, "eval_ms": eval_ms, "ties": ties,
                      "rows_recall": sub, "rows_ms": rows_ms,
                      "nmi_record": nmi_rec, "nmi_ms": nmi_ms}


def check_time(torch, seed, detail, step_ms, card):
    """5e (e): ``time`` at batch 120 on the phase-5 cut: every stage
    positive and trunk forward <= forward <= forward+backward."""
    import contextlib

    from npairloss_tpu_torch import cli
    from npairloss_tpu_torch.ops import _build

    out = io.StringIO()
    _build.reset_launch_counts()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["time", "--solver",
                       os.path.join(SNAP_WORK, "bits", "solver.prototxt"),
                       "--net", "examples/googlenet_cub.prototxt", "--model",
                       "googlenet_pallas", "--iterations", "20", "--batch",
                       "120", "--seed", str(seed)])
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    if rc != 0:
        fail(f"time returned {rc}")
    rec = json.loads(out.getvalue().strip().splitlines()[-1])
    stages = [rec["trunk_forward_ms"], rec["forward_ms"],
              rec["forward_backward_ms"]]
    if min(stages) <= 0 or not stages[0] <= stages[1] <= stages[2]:
        fail(f"time's stages out of order or not positive: {rec}")
    log(f"[time] {json.dumps(rec)} ({card}); phase 5's median step "
        f"{step_ms:.3f} ms; launches {json.dumps(launches)}")
    detail["time"] = {"record": rec, "launches": launches,
                      "phase5_step_ms": step_ms}


def drive_resilience(torch, seed, detail, net_path, emb, labels, step_ms):
    """Phase 5e: (a) the preemption drill, (b) resume bit for bit, (c)
    extract and test from a snapshot, (d) eval over the serving gallery
    and NMI, (e) time."""
    card = detail["card"]
    t0 = time.perf_counter()
    preemption_drill(seed, net_path, detail, card)
    snap6, train_launches = check_resume_bits(torch, seed, detail, card)
    extract_launches = check_extract_test(torch, seed, detail, net_path,
                                          snap6, card)
    check_eval(torch, seed, detail, emb, labels, card)
    check_time(torch, seed, detail, step_ms, card)
    log(f"[5e] {time.perf_counter() - t0:.1f} s")
    return train_launches, extract_launches


# -- phase 4b: the serving tier -----------------------------------------------

TIER_WORK = os.path.join("build", "tier_smoke")
TIER_CLIENTS = 8


def _http_call(port, method, path, body=None, timeout=120.0):
    """(status, decoded JSON body, wall ms) of one localhost request."""
    import http.client

    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        raw = resp.read()
        return resp.status, json.loads(raw or b"null"), \
            (time.perf_counter() - t0) * 1e3
    finally:
        conn.close()


def _pcts(ms):
    import numpy as np

    return {"n": len(ms), "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99))}


def _tier_args(prefix, wal_dir, snap_path, seed, every=4):
    return ["serve", "--index-prefix", prefix, "--index-kind", "ivf",
            "--ivf-clusters", "246", "--probes", "8", "--probe-impl",
            "fused", "--top-k", "10", "--buckets", "1,8,32", "--replicas",
            "2", "--wal-dir", wal_dir, "--wal-checkpoint-every", str(every),
            "--snapshot", snap_path, "--model", "googlenet_pallas",
            "--input-size", "224", "--poll-s", "0.01", "--explicit-drops",
            "--seed", str(seed)]


def _tier_load(port, emb, rows, bodies, images, extra=()):
    """Clients on TIER_CLIENTS threads: one query per gallery row in
    ``rows``, ``bodies`` (lists of rows, 32 each) as bodies of 32, raw
    ``images``, and ``extra`` (method, path, body) requests.  Returns
    the replies by kind and the latency lists."""
    from concurrent.futures import ThreadPoolExecutor

    jobs = ([("single", int(r), json.dumps(
        {"id": f"s{int(r)}", "embedding": emb[r].tolist()}))
        for r in rows]
        + [("body", [int(r) for r in b], "\n".join(json.dumps(
            {"id": f"b{int(r)}", "embedding": emb[r].tolist()}) for r in b))
           for b in bodies]
        + [("image", i, json.dumps({"id": f"x{i}",
                                    "input": images[i].tolist()}))
           for i in range(len(images))])

    def run(job):
        kind, key, body = job
        return kind, key, _http_call(port, "POST", "/query", body)

    with ThreadPoolExecutor(TIER_CLIENTS) as pool:
        replies = list(pool.map(run, jobs))
        others = list(pool.map(lambda e: _http_call(port, *e), extra))
    lat = {"single": [], "body": [], "image": []}
    for kind, key, (code, out, ms) in replies:
        if code != 200:
            fail(f"4b: a {kind} query answered {code}: {out}")
        lat[kind].append(ms)
        answers = out if kind == "body" else [out]
        keys = key if kind == "body" else [key]
        for k, a in zip(keys, answers):
            if "neighbors" not in a or len(a["neighbors"]) != 10:
                fail(f"4b: {kind} query {k} not answered: {a}")
            if kind != "image" and (a["neighbors"][0]["row"] != k
                                    or not a["neighbors"][0]["score"]
                                    > 0.99):
                fail(f"4b: gallery row {k}: top-1 is {a['neighbors'][0]}")
    return lat, others


def _probe_at_grown_cap(torch, timer, index, queries):
    """The probe kernel against its plain version on the grown layout
    (B = 32, probes 8, fp32): (row of numbers)."""
    import numpy as np

    from npairloss_tpu_torch.ops.ivf_probe import (
        probe_select,
        probe_topk,
        probe_topk_oneshot_plain,
    )

    layout = index.layout
    q = torch.as_tensor(queries, device="cuda")
    _, lids, owned = probe_select(q, layout.centroids, layout.cluster_valid,
                                  8, 0, layout.packed.shape[0])
    owned = owned.to(torch.int32).contiguous()
    kl = min(10, 8 * layout.cap)
    args = (q, layout.packed, layout.rows, lids, owned, None)
    _, _, _, _, err, ties = _probe_against_plain(
        torch, np, args, kl, "fp32", "4b probe at the grown cap")
    valid_rows = int((layout.rows[lids.long()] >= 0).sum().item())
    side = (lids.numel() * layout.cap * 4 + q.numel() * 4
            + 2 * lids.numel() * 4 + 32 * kl * 8)
    bms, by = bound_ms(valid_rows * index.dim * 4 + side,
                       2.0 * valid_rows * index.dim, "fp32")
    return {"batch": 32, "probes": 8, "cap": layout.cap,
            "probed_rows": valid_rows, "max_abs_err": err,
            "tol": TOL["probe"], "row_mismatches_in_ties": ties,
            "ms": timer.ms(lambda: probe_topk(*args, kl=kl, scoring="fp32")),
            "plain_ms": timer.ms(lambda: probe_topk_oneshot_plain(
                *args, kl=kl, scoring="fp32")),
            "bound_ms": bms, "bound_by": by}


def _ingest_rows(seed, gallery, n_ids=1536, per_id=4, first_id=10 ** 6):
    """New identities near the gallery's own (a new product resembles a
    catalogued one, so it lands in the clusters a probe of it scores
    highest; a uniformly random direction in 1024 dims is near no
    centroid, and a probe of 8 would find it only by chance): each
    centre a random gallery row plus noise, each row its centre plus
    the synthetic gallery's noise, unit norm; ids from ``first_id``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    dim = gallery.shape[1]
    anchors = rng.choice(gallery.shape[0], size=n_ids, replace=False)
    centres = gallery[anchors] + rng.standard_normal(
        (n_ids, dim), dtype=np.float32) * (0.5 / np.sqrt(dim))
    centres /= np.linalg.norm(centres, axis=1, keepdims=True)
    labels = np.repeat(np.arange(n_ids, dtype=np.int32) + 20000, per_id)
    rows = centres[labels - 20000] + rng.standard_normal(
        (n_ids * per_id, dim), dtype=np.float32) * (0.5 / np.sqrt(dim))
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    return (rows.astype(np.float32), labels,
            np.arange(first_id, first_id + n_ids * per_id, dtype=np.int64))


def _send_ingest(port, rows, labels, ids, first, n_records, per=256):
    acks, ms = [], []
    for r in range(n_records):
        sl = slice(first + r * per, first + (r + 1) * per)
        body = json.dumps({"id": f"ingest{first // per + r}", "ingest": {
            "ids": ids[sl].tolist(), "labels": labels[sl].tolist(),
            "embeddings": rows[sl].tolist()}})
        code, ack, t = _http_call(port, "POST", "/query", body)
        if code != 200 or ack.get("ingested") != per \
                or not isinstance(ack.get("seq"), int):
            fail(f"4b: ingest record {r} answered {code}: {ack}")
        acks.append(ack)
        ms.append(t)
    return acks, ms


class _TierProc:
    """``python -m npairloss_tpu_torch serve --http 0`` on the card: its
    port from the ``serve_listening`` line, stderr to a file."""

    def __init__(self, argv, err_path):
        self.t0 = time.perf_counter()
        self.err = open(err_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "npairloss_tpu_torch", *argv,
             "--http", "0"], stdout=subprocess.PIPE, stderr=self.err,
            text=True)
        line = self.proc.stdout.readline()
        if not line:
            self.proc.wait(timeout=60)
            self.err.close()
            fail(f"4b: serve exited {self.proc.returncode} before listening:"
                 f" {open(err_path).read()[-3000:]}")
        self.port = json.loads(line)["port"]

    def finish(self, timeout=300):
        out = self.proc.stdout.read()
        rc = self.proc.wait(timeout=timeout)
        self.err.close()
        return rc, out

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.err.close()


def drive_serving_tier(torch, seed, detail, emb, labels, snap_path):
    """Phase 4b: the serving tier on the card at phase 4's width (see the
    module docstring): the in-process ``serve --http`` tier with two
    replicas, a WAL and a restored trunk; a replica crash; ingest with
    checkpoints; a SIGKILL and a SIGTERM drill on a subprocess."""
    import shutil
    import signal
    import threading

    import numpy as np

    from npairloss_tpu_torch import cli
    from npairloss_tpu_torch.models import get_model
    from npairloss_tpu_torch.ops import _build
    from npairloss_tpu_torch.resilience import failpoints
    from npairloss_tpu_torch.resilience.wal import wal_info
    from npairloss_tpu_torch.serve.index import index_info, load_newest
    from npairloss_tpu_torch.train.solver import (
        load_inference_state,
        restore_for_inference,
    )

    card = detail["card"]
    t_phase = time.perf_counter()
    work = os.path.abspath(TIER_WORK)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    prefix = os.path.join(work, "g_")
    wal_dir = os.path.join(work, "wal")
    np.save(os.path.join(work, "emb.npy"), emb)
    np.save(os.path.join(work, "labels.npy"), labels)
    if cli.main(["index", "--emb", os.path.join(work, "emb.npy"),
                 "--labels", os.path.join(work, "labels.npy"), "--out",
                 prefix + "0001.gidx", "--no-normalize"]) != 0:
        fail("4b: index --emb/--labels/--out failed")
    out = {"card": card}

    # 1. The in-process tier: serve --http through cli.build_server.
    args = cli.build_parser().parse_args(
        _tier_args(prefix, wal_dir, snap_path, seed))
    t0 = time.perf_counter()
    server, wal = cli.build_server(args)
    out["build_s"] = time.perf_counter() - t0
    index = server.engine.index
    cap0 = index.layout.cap
    log(f"[4b] tier built in {out['build_s']:.1f} s: {index.size} rows, "
        f"{index.n_clusters} clusters (cap {cap0}), 2 replicas, trunk from "
        f"{snap_path}")
    _build.reset_launch_counts()
    runner = threading.Thread(target=lambda: out.update(
        rc_inprocess=server.run_http(0)), daemon=True)
    runner.start()
    deadline = time.monotonic() + 60.0
    while server.http_port is None:
        if time.monotonic() > deadline or not runner.is_alive():
            fail("4b: run_http did not start listening")
        time.sleep(0.01)
    port = server.http_port
    rng = np.random.default_rng(seed + 40)
    singles = rng.choice(emb.shape[0], size=512, replace=False)
    bodies = rng.choice(emb.shape[0], size=(64, 32), replace=False)
    images = rng.standard_normal((16, 224, 224, 3), dtype=np.float32)
    lat2, others = _tier_load(port, emb, singles, bodies, images, extra=[
        ("POST", "/query", "{this is not json"), ("GET", "/nope", None),
        ("GET", "/healthz", None)])
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    if others[0][0] != 400 or others[1][0] != 404:
        fail(f"4b: a bad body / unknown path answered {others[:2]}")
    code, health, _ = others[2]
    for key in ("ok", "draining", "queries", "answered", "replicas",
                "replicas_alive", "ingest", "probe_impl", "p99_ms"):
        if code != 200 or key not in health:
            fail(f"4b: /healthz lacks {key}: {code} {health}")
    for name in ("probe_topk", "lrn_fwd", "fused_bias_relu",
                 "fused_bias_relu_pool"):
        if launches.get(name, 0) < 1:
            fail(f"4b: kernel {name} was not launched by the tier")
    n_q = 512 + 64 * 32 + 16
    s = server.summary()
    if not (s["queries"] == s["answered"] == n_q and s["errors"] == 0
            and s["queries_dropped"] == 0):
        fail(f"4b: counters after the load: {s}")
    out["launches"] = {k: launches[k] for k in (
        "probe_topk", "lrn_fwd", "fused_bias_relu", "fused_bias_relu_pool")}
    out["latency_2_replicas"] = {k: _pcts(v) for k, v in lat2.items()}
    log(f"[4b] {n_q} queries over HTTP from {TIER_CLIENTS} clients, 2 "
        f"replicas: {json.dumps(out['latency_2_replicas'])}; launches "
        f"{json.dumps(out['launches'])} ({card})")

    # The restored trunk on the card against the CPU.
    st_gpu = restore_for_inference(snap_path, device="cuda")
    st_cpu = restore_for_inference(snap_path, device="cpu")
    m_gpu = load_inference_state(get_model(
        "googlenet_pallas", device="cuda", dtype=torch.float32), st_gpu)
    m_cpu = load_inference_state(get_model(
        "googlenet_pallas", device="cpu", dtype=torch.float32), st_cpu)
    x2 = torch.as_tensor(images[:2])
    with torch.inference_mode():
        e_gpu = m_gpu(x2.cuda()).cpu()
        e_cpu = m_cpu(x2)
    served = torch.as_tensor(server.engine.encode(images[:2]))
    enc_err = (e_gpu - e_cpu).abs().max().item()
    cos = (served * torch.nn.functional.normalize(e_cpu, dim=1)).sum(1)
    out["trunk_fp32_err"] = enc_err
    out["trunk_served_bf16_cos"] = cos.min().item()
    log(f"[4b] restored trunk fp32 card vs CPU: max_abs_err {enc_err}; "
        f"served bf16 vs fp32 CPU: min cosine {cos.min().item()}")
    if not enc_err <= 1e-4 or not cos.min().item() > 0.99:
        fail("4b: the restored trunk on the card disagrees with the CPU")
    del m_gpu, m_cpu, st_gpu, st_cpu

    # 2. A replica crash under load.
    failpoints.arm("serve.replica_crash", times=1, delay=4)
    lat1, _ = _tier_load(port, emb, singles[:256], bodies[:32], [])
    failpoints.reset()
    s = server.summary()
    if server.replicaset.alive_count != 1 or s["errors"] != 0 \
            or s["queries"] != s["answered"] + s["errors"] \
            - s["errors_refused"] + s["rejected"]:
        fail(f"4b: after serve.replica_crash: alive "
             f"{server.replicaset.alive_count}, {s}")
    out["latency_1_live_replica"] = {k: _pcts(v) for k, v in lat1.items()
                                     if v}
    log(f"[4b] serve.replica_crash: 0 client errors, 1 live replica: "
        f"{json.dumps(out['latency_1_live_replica'])} ({card})")

    # 3. Ingest: 16 records of 256 rows, a checkpoint every 4.
    new_rows, new_labels, new_ids = _ingest_rows(seed + 41, emb)
    acks, ack_ms = _send_ingest(port, new_rows, new_labels, new_ids, 0, 16)
    if [a["seq"] for a in acks] != list(range(1, 17)):
        fail(f"4b: ingest seqs {[a['seq'] for a in acks]}")
    ckpts = sorted(n for n in os.listdir(work) if n.startswith("g_w"))
    want = [f"g_w{w:012d}.gidx" for w in (4, 8, 12, 16)]
    if ckpts != want:
        fail(f"4b: checkpoints {ckpts}, want {want}")
    info = wal_info(wal_dir)
    if info["segments"] != 1 or info["first_seq"] != 16:
        fail(f"4b: the WAL is not GC'd to watermark 16: {info}")
    publish_ms = list(server._checkpoint_fn.__self__.publish_ms)
    probe_new = rng.choice(4096, size=256, replace=False)
    jobs = [json.dumps({"id": int(r), "embedding": new_rows[r].tolist()})
            for r in probe_new]
    for r, body in zip(probe_new, jobs):
        code, a, _ = _http_call(port, "POST", "/query", body)
        top = a["neighbors"][0] if code == 200 else a
        if code != 200 or top["gallery_id"] != int(new_ids[r]):
            fail(f"4b: ingested row {int(new_ids[r])}: top-1 {top}")
    cap1 = index.layout.cap
    if not cap1 > cap0:
        fail(f"4b: the ingest did not grow the cap ({cap0} -> {cap1})")
    timer = Timer(torch)
    out["probe_grown_cap"] = _probe_at_grown_cap(
        torch, timer, index, new_rows[probe_new[:32]])
    del timer
    out["ingest_ack"] = _pcts(ack_ms)
    out["checkpoint_publish_ms"] = publish_ms
    log(f"[4b] 16 ingest records (4,096 rows): ack {json.dumps(out['ingest_ack'])}"
        f" (append + fsync + apply), checkpoints {ckpts} in "
        f"{[round(t, 1) for t in publish_ms]} ms, WAL GC'd to seq 16; cap "
        f"{cap0} -> {cap1}; probe at the grown cap "
        f"{json.dumps(out['probe_grown_cap'])} ({card})")

    # 4. Drain the in-process tier; then the SIGKILL drill.
    server.preempt.request()
    runner.join(timeout=300)
    wal.close()
    if out.get("rc_inprocess") != 75:
        fail(f"4b: run_http returned {out.get('rc_inprocess')}")
    newest = load_newest(prefix, device="cpu")[0]
    if not newest.endswith("g_w000000000016.gidx"):
        fail(f"4b: the newest commit after the drain is {newest}")
    del server, index
    _release(torch)
    argv = _tier_args(prefix, wal_dir, snap_path, seed, every=16)
    p = _TierProc(argv, os.path.join(work, "serve1.err"))
    try:
        acks2, ack2_ms = _send_ingest(p.port, new_rows, new_labels, new_ids,
                                      16 * 256, 8)
        if [a["seq"] for a in acks2] != list(range(17, 25)):
            fail(f"4b: drill seqs {[a['seq'] for a in acks2]}")
        p.proc.send_signal(signal.SIGKILL)
        rc, _ = p.finish()
    finally:
        p.kill()
    if rc != -signal.SIGKILL:
        fail(f"4b: the SIGKILLed serve exited {rc}")
    t_restart = time.perf_counter()
    p = _TierProc(argv, os.path.join(work, "serve2.err"))
    try:
        code, first, _ = _http_call(p.port, "POST", "/query", json.dumps(
            {"id": "first", "embedding": new_rows[-1].tolist()}))
        out["restart_to_first_answer_s"] = time.perf_counter() - t_restart
        if code != 200 or first["neighbors"][0]["gallery_id"] \
                != int(new_ids[6143]):
            fail(f"4b: the first answer after the restart: {code} {first}")
        code, health, _ = _http_call(p.port, "GET", "/healthz")
        rec = health["ingest"]["recovery"]
        if not (rec["index_path"].endswith("g_w000000000016.gidx")
                and rec["base_watermark"] == 16 and rec["replayed"] == 8
                and rec["replayed_rows"] == 2048):
            fail(f"4b: the restart's recovery: {rec}")
        out["wal_replay_ms"] = rec["replay_ms"]
        sample = np.concatenate([rng.choice(4096, 120, replace=False),
                                 4096 + rng.choice(2048, 136,
                                                   replace=False)])
        for r in sample:
            code, a, _ = _http_call(p.port, "POST", "/query", json.dumps(
                {"id": int(r), "embedding": new_rows[r].tolist()}))
            nb = a["neighbors"] if code == 200 else [a, a]
            if nb[0]["gallery_id"] != int(new_ids[r]) \
                    or nb[1]["gallery_id"] == int(new_ids[r]):
                fail(f"4b: acked row {int(new_ids[r])} after the restart: "
                     f"{nb[:2]}")

        # 5. SIGTERM with queries in flight.
        stop, replies = threading.Event(), []

        def client(k):
            i = 0
            while not stop.is_set():
                r = int(singles[(k * 64 + i) % 512])
                try:
                    replies.append((r, _http_call(
                        p.port, "POST", "/query",
                        json.dumps({"id": r,
                                    "embedding": emb[r].tolist()}))))
                except OSError:
                    return
                i += 1

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(TIER_CLIENTS)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 120.0
        while len(replies) < 64:
            if time.monotonic() > deadline:
                fail("4b: the restarted serve answers no load")
            time.sleep(0.01)
        p.proc.send_signal(signal.SIGTERM)
        time.sleep(0.5)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        rc, stdout = p.finish()
    finally:
        stop_all = locals().get("stop")
        if stop_all is not None:
            stop_all.set()
        p.kill()
    drain = json.loads(stdout.strip().splitlines()[-1])
    ok = [(r, body) for r, (c, body, _) in replies if c == 200]
    codes = {c for _, (c, _, _) in replies}
    if rc != 75 or drain.get("event") != "serve_drain":
        fail(f"4b: SIGTERM: exit {rc}, last line {drain}")
    if not codes <= {200, 503} or any(
            b["neighbors"][0]["row"] != r for r, b in ok):
        fail(f"4b: SIGTERM: replies {codes}")
    if not (drain["queries"] == drain["answered"] >= len(ok)
            and drain["queries_dropped"] == 0
            and drain["ingest"]["checkpoint_watermark"] == 24):
        fail(f"4b: SIGTERM drain record: {drain}")
    final_path, final = load_newest(prefix, device="cpu")
    ids = final.ids
    if not final_path.endswith("g_w000000000024.gidx") \
            or np.unique(ids).shape[0] != ids.shape[0] \
            or ids.shape[0] != emb.shape[0] + 6144 \
            or not np.isin(new_ids, ids).all():
        fail(f"4b: the final checkpoint {final_path} holds {ids.shape[0]} "
             "ids: an acked row is missing or doubled")
    out["drill"] = {"ack_ms": _pcts(ack2_ms), "sigterm_answered":
                    drain["answered"], "late_503": 503 in codes,
                    "final": os.path.basename(final_path),
                    "final_rows": int(ids.shape[0])}
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[4b] SIGKILL after 8 acks -> restart loaded "
        f"{os.path.basename(rec['index_path'])}, replayed 8 records (2,048 "
        f"rows) in {out['wal_replay_ms']:.1f} ms, first answer "
        f"{out['restart_to_first_answer_s']:.1f} s after the restart; "
        f"SIGTERM under load -> exit 75, {drain['answered']} answered, 503s "
        f"{503 in codes}, final {out['drill']['final']} "
        f"({ids.shape[0]} rows, every acked row once) ({card})")
    log(f"[4b] {out['wall_s']:.1f} s")
    detail["serving_tier"] = out
    return out


# -- phases 5f and 5g: the Inception-BN trunk, the precision policies -------

BN_RUNS = (
    # (tag, train argv after the model, net): the blockwise run mines as
    # the reference does, so its hist sweeps run too.
    ("mxu", ["--precision", "mxu"], "cub"),
    ("mxu_blockwise", ["--precision", "mxu", "--engine", "blockwise"],
     "relhard"),
    ("mxu_remat", ["--precision", "mxu", "--remat"], "cub"),
    ("fp32_parity", ["--precision", "fp32_parity"], "cub"),
)


def _bn_solver(torch, seed, policy, **kw):
    """A googlenet_bn Solver on the GoogLeNet/CUB net's loss."""
    from npairloss_tpu_torch.config.schema import load_net, load_solver
    from npairloss_tpu_torch.models import get_model
    from npairloss_tpu_torch.train.solver import Solver

    solver_cfg, _ = load_solver(cut_solver(os.path.join("build",
                                                        "train_smoke")))
    net_cfg = load_net("examples/googlenet_cub.prototxt")
    remat = kw.pop("remat", False)
    model = get_model("googlenet_bn", device="cuda", seed=seed, policy=policy,
                      remat=remat)
    return Solver(model, net_cfg.loss.loss, kw.pop("cfg", solver_cfg),
                  param_mults=net_cfg.param_mults, precision=policy, **kw)


def _bn_train_run(torch, seed, tag, extra, net_path, work):
    """One in-process ``train --model googlenet_bn <extra>`` run on the
    phase-5 solver cut; returns (solver, events, launches of the six
    steps with the bf16-mode ones as ``<kernel>:bf16``, step ms)."""
    import contextlib
    import math

    from npairloss_tpu_torch import cli
    from npairloss_tpu_torch.ops import _build
    from npairloss_tpu_torch.train import solver as tsolver

    events_path = os.path.join(work, f"events_bn_{tag}.jsonl")
    if os.path.exists(events_path):
        os.remove(events_path)
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

    argv = ["train", "--solver", cut_solver(work), "--net", net_path,
            "--model", "googlenet_bn", *extra, "--synthetic", "--log-json",
            events_path, "--seed", str(seed)]
    out = io.StringIO()
    tsolver.Solver.step = timed_step
    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        torch.cuda.synchronize()
    finally:
        tsolver.Solver.step = orig_step
    for ln in out.getvalue().splitlines():
        log(f"[bn-train {tag}] {ln}")
    if rc != 0:
        fail(f"train --model googlenet_bn {' '.join(extra)} returned {rc}")
    events = [json.loads(ln) for ln in open(events_path)]
    final = json.loads(out.getvalue().strip().splitlines()[-1])
    for rec in events + [final]:
        bad = {k: v for k, v in rec.items()
               if isinstance(v, float) and not math.isfinite(v)}
        if bad:
            fail(f"non-finite values in bn {tag} {rec.get('event')}: {bad}")
    if [e["iteration"] for e in events if e["event"] == "display"] != [
            1, 2, 3, 4, 5, 6]:
        fail(f"unexpected bn {tag} event stream: {events}")
    c0, c1 = seen["after_test"], _build.launch_counts()
    launches = {k: c1[k] - c0[k] for k in c1}
    return seen["solver"], events, launches, list(seen["ms"])


def check_bn_solver_state(torch, solver, tag):
    """Every parameter has a nonzero gradient after the last step, every
    BatchNorm's running statistics moved off their init (0, 1), and one
    more step makes no host sync."""
    from npairloss_tpu_torch.data.synthetic import synthetic_identity_batches
    from npairloss_tpu_torch.models.layers import BatchNorm

    zero = [n for n, p in solver.params.items()
            if p.grad is None or not bool((p.grad != 0).any())]
    if zero:
        fail(f"bn {tag}: parameters without a gradient: {zero[:5]}")
    bns = [m for m in solver.model.modules() if isinstance(m, BatchNorm)]
    still = [i for i, m in enumerate(bns)
             if not bool((m.mean != 0).any()) or not bool((m.var != 1).any())]
    if not bns or still:
        fail(f"bn {tag}: running statistics did not move in {still}")
    x, lab = next(synthetic_identity_batches(240, 60, 2, (224, 224, 3),
                                             seed=31))
    solver.step(x, lab)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        solver.step(x, lab)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return len(solver.params), len(bns)


def check_remat_bits(torch, seed):
    """One mxu step from the same weights and batch with and without
    remat (cuDNN deterministic): gradients and running statistics bit for
    bit; each step's peak of allocated memory."""
    from npairloss_tpu_torch.data.synthetic import synthetic_identity_batches

    x, lab = next(synthetic_identity_batches(240, 60, 2, (224, 224, 3),
                                             seed=seed + 33))
    cudnn = torch.backends.cudnn
    det, bench = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    out = {}
    try:
        for remat in (False, True):
            s = _bn_solver(torch, seed, "mxu", remat=remat)
            s.step(x, lab)  # warm: cuDNN plans, the allocator
            s.init(seed)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            s.step(x, lab)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            out[remat] = ({n: p.grad.clone() for n, p in s.params.items()},
                          {n: b.clone() for n, b in s.model.named_buffers()},
                          peak, peak - base)
            del s
    finally:
        cudnn.deterministic, cudnn.benchmark = det, bench
    (g0, b0, p0, d0), (g1, b1, p1, d1) = out[False], out[True]
    differ = [n for n in g0 if not torch.equal(g0[n], g1[n])]
    differ += [n for n in b0 if not torch.equal(b0[n], b1[n])]
    if differ or set(g0) != set(g1) or set(b0) != set(b1):
        fail(f"remat changed the step in {differ[:5]}")
    return {"peak_bytes": p0, "peak_bytes_remat": p1,
            "step_bytes": d0, "step_bytes_remat": d1,
            "tensors_equal": len(g0) + len(b0)}


def check_bn_resume_bits(torch, seed):
    """mxu solver A trains 6 steps on fixed batches with a snapshot at 3;
    a fresh solver B restores it and trains steps 4-6: parameters, BN
    running statistics and momentum equal A's bit for bit (cuDNN
    deterministic)."""
    import dataclasses
    import shutil

    from npairloss_tpu_torch.config.schema import load_solver
    from npairloss_tpu_torch.data.synthetic import synthetic_identity_batches

    work = os.path.join(SNAP_WORK, "bn_bits")
    shutil.rmtree(work, ignore_errors=True)
    cfg, _ = load_solver(cut_solver(work, snapshot=3, display=0))
    cfg = dataclasses.replace(cfg, test_interval=0,
                              snapshot_prefix=os.path.join(work, "bn_"))
    gen = synthetic_identity_batches(240, 60, 2, (224, 224, 3),
                                     seed=seed + 34)
    batches = [next(gen) for _ in range(6)]
    cudnn = torch.backends.cudnn
    det, bench = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        a = _bn_solver(torch, seed, "mxu", cfg=cfg)
        a.train(iter(batches), num_iters=6, log_fn=lambda s: None)
        b = _bn_solver(torch, seed + 1, "mxu", cfg=cfg)
        b.restore_snapshot(a.snapshot_path(3))
        if b.iteration != 3:
            fail(f"bn resume restored iteration {b.iteration}, not 3")
        b.train(iter(batches[3:]), num_iters=6, log_fn=lambda s: None)
        torch.cuda.synchronize()
    finally:
        cudnn.deterministic, cudnn.benchmark = det, bench
    sa, sb = a.state_dict(), b.state_dict()
    differ = [k for k in sa if not torch.equal(sa[k], sb[k])]
    stats = [k for k in sa if k.endswith((".mean", ".var"))]
    if set(sa) != set(sb) or differ or not stats:
        fail(f"bn resume differs from the uninterrupted run in {differ[:5]}")
    return {"tensors_equal": len(sa), "running_stats": len(stats)}


def profile_bn_step(torch, solver, step_ms):
    """Where an mxu googlenet_bn step's device time goes: three more
    steps under ``torch.profiler`` (``profile_train_step``), and the
    device's busy time against the unprofiled median step of the same
    run, whose complement is the step's idle share.  None where the
    profiler recorded no device time."""
    from npairloss_tpu_torch.data.synthetic import synthetic_identity_batches

    x, lab = next(synthetic_identity_batches(240, 60, 2, (224, 224, 3),
                                             seed=32))
    prof = profile_train_step(torch, lambda: solver.step(x, lab))
    if prof is None:
        return None
    prof["median_step_ms"] = step_ms
    prof["idle_share"] = 1.0 - prof["busy_ms"] / step_ms
    log(f"[bn-train mxu] device busy {prof['busy_ms']:.3f} ms of the "
        f"unprofiled median step {step_ms:.3f} ms: idle "
        f"{100 * prof['idle_share']:.1f} %")
    return prof


def init_sim_spread(torch, seed):
    """Std of the cosine sims of the init trunks' embeddings of one
    batch-120 synthetic batch: googlenet_bn (train mode: batch
    statistics, as a step sees it; eval mode: the init's running
    statistics) beside the BN-free googlenet_pallas."""
    from npairloss_tpu_torch.data.synthetic import synthetic_identity_batches
    from npairloss_tpu_torch.models import get_model

    x, _ = next(synthetic_identity_batches(240, 60, 2, (224, 224, 3),
                                           seed=seed + 35))
    x = torch.as_tensor(x, device="cuda")
    out = {}
    with torch.no_grad():
        for name, kw in (("googlenet_bn", {"policy": "mxu"}),
                         ("googlenet_pallas", {"dtype": torch.float32})):
            m = get_model(name, device="cuda", seed=seed, **kw)
            out[f"{name}_train"] = _sim_spread(torch, m.train()(x))
            m = get_model(name, device="cuda", seed=seed, **kw)
            out[f"{name}_eval"] = _sim_spread(torch, m.eval()(x))
    return out


def drive_bn_train(torch, seed, detail):
    """Phase 5f: ``train --model googlenet_bn --precision mxu`` at batch
    120, 224², on the dense and the blockwise engine (the kernels' bf16
    mode), with ``--remat``, and under ``fp32_parity``; then remat and
    resume bit for bit and the init trunks' sim spread.  Returns the
    blockwise run's launches."""
    card = detail["card"]
    t_start = time.perf_counter()
    work = os.path.join("build", "train_smoke")
    os.makedirs(work, exist_ok=True)
    nets = {"cub": "examples/googlenet_cub.prototxt",
            "relhard": blockwise_net(work)}
    runs = {}
    for tag, extra, net in BN_RUNS:
        t0 = time.perf_counter()
        solver, events, launches, ms = _bn_train_run(
            torch, seed, tag, extra, nets[net], work)
        n_params, n_bn = check_bn_solver_state(torch, solver, tag)
        med = statistics.median(ms[1:])
        rec = {"step_ms": ms, "median_step_ms": med,
               "images_per_s": 120 / med * 1e3,
               "peak_bytes": torch.cuda.max_memory_allocated(),
               "matmul_precision": solver.matmul_precision,
               "policy": solver.precision_policy.name,
               "launches": {k: v for k, v in launches.items() if v},
               "wall_s": time.perf_counter() - t0,
               "last": [e for e in events if e["event"] == "display"][-1]}
        log(f"[bn-train {tag}] {n_params} parameters with a nonzero "
            f"gradient, {n_bn} BatchNorms' running statistics moved, no "
            f"host sync in a step; step ms {[round(t, 3) for t in ms]}, "
            f"median over steps 2-6 {med:.3f} ms = "
            f"{rec['images_per_s']:.1f} images/s; policy {rec['policy']}, "
            f"loss gemms {rec['matmul_precision']}; launches "
            f"{json.dumps(rec['launches'])}; {rec['wall_s']:.1f} s ({card})")
        runs[tag] = rec
        if tag == "mxu":
            rec["profile"] = profile_bn_step(torch, solver, med)
        if tag == "mxu_blockwise":
            bw_launches = launches
            short = [k for k in BLOCKWISE_KERNELS
                     if launches.get(f"{k}:bf16", 0) < 6
                     or launches[f"{k}:bf16"] != launches[k]]
            if short or launches.get("round_bf16", 0) < 6:
                fail(f"the blockwise mxu run did not launch {short} in "
                     "their bf16 mode, or round_bf16, on every step")
        elif any(launches.get(k, 0) for k in BLOCKWISE_KERNELS) or any(
                launches.get(k, 0) for k in (
                    "lrn_fwd", "lrn_fwd_cached", "lrn_bwd_cached",
                    "fused_bias_relu", "fused_bias_relu_pool",
                    "round_bf16")):
            fail(f"bn {tag} launched a stem or blockwise kernel: {launches}")
        del solver
    remat = check_remat_bits(torch, seed)
    log(f"[bn-train] one mxu step with and without --remat: "
        f"{remat['tensors_equal']} gradients and running statistics bit "
        f"for bit; peak allocated {remat['peak_bytes']} vs "
        f"{remat['peak_bytes_remat']} bytes with remat (the step's own: "
        f"{remat['step_bytes']} vs {remat['step_bytes_remat']}) ({card})")
    resume = check_bn_resume_bits(torch, seed)
    log(f"[bn-train] mxu resume at iter 3: {resume['tensors_equal']} "
        f"tensors ({resume['running_stats']} running statistics) equal the "
        "uninterrupted run's bit for bit")
    spread = init_sim_spread(torch, seed)
    log(f"[bn-train] std of the init trunks' cosine sims at batch 120: "
        f"{json.dumps(spread)}")
    if not spread["googlenet_bn_train"] > SPREAD_FLOOR:
        fail(f"the BN trunk's init embeddings collapse: {spread}")
    wall = time.perf_counter() - t_start
    log(f"[5f] {wall:.1f} s")
    detail["bn_train"] = {"runs": runs, "remat": remat, "resume": resume,
                          "init_sim_spread": spread, "wall_s": wall}
    return bw_launches


# The ACCURACY.md recipe (scripts/accuracy_baseline.py:243-291).
LEARN_STEPS = 200
LEARN_BAR = 0.95


def drive_bn_learning(torch, seed, detail):
    """Phase 5g: googlenet_bn at 96², 16 identities x 2, REFERENCE_CONFIG,
    lr 0.05 fixed, momentum 0.9, no weight decay, noise 0.6, seed 0, 200
    steps through the port's Solver; once under fp32_parity on the dense
    engine, once under mxu on the blockwise engine.  Each run's last-step
    Recall@1 must reach the file's bar."""
    from npairloss_tpu_torch.data.synthetic import synthetic_identity_batches
    from npairloss_tpu_torch.models import get_model
    from npairloss_tpu_torch.ops import _build
    from npairloss_tpu_torch.ops.npair_loss import REFERENCE_CONFIG
    from npairloss_tpu_torch.train.solver import Solver, SolverConfig

    card = detail["card"]
    t_start = time.perf_counter()
    out = {}
    for policy, engine in (("fp32_parity", "dense"), ("mxu", "blockwise")):
        cfg = SolverConfig(base_lr=0.05, lr_policy="fixed", momentum=0.9,
                           weight_decay=0.0, display=0, test_interval=0,
                           snapshot=0, random_seed=0)
        model = get_model("googlenet_bn", device="cuda", seed=0,
                          policy=policy)
        solver = Solver(model, REFERENCE_CONFIG, cfg, engine=engine,
                        precision=policy)
        batches = synthetic_identity_batches(16, 16, 2, (96, 96, 3),
                                             noise=0.6, seed=0)
        _build.reset_launch_counts()
        curve = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for it in range(LEARN_STEPS):
            m = solver.step(*next(batches))
            if it % 20 == 0 or it == LEARN_STEPS - 1:
                curve.append((it, float(m["loss"]),
                              float(m["retrieve_top1"])))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        modes = {k: v for k, v in _build.launch_counts().items()
                 if k.endswith(":bf16") or k == "round_bf16"}
        tag = f"{policy}/{engine}"
        log(f"[bn-learn {tag}] (step, loss, Recall@1) every 20 steps: "
            f"{curve}; {secs:.2f} s for {LEARN_STEPS} steps ({card})")
        if engine == "blockwise" and modes["npair_stats:bf16"] < LEARN_STEPS:
            fail(f"bn-learn {tag}: the stats kernel ran "
                 f"{modes['npair_stats:bf16']} times in its bf16 mode")
        out[tag] = {"curve": curve, "seconds": secs,
                    "last_recall1": curve[-1][2],
                    "bf16_launches": {k: v for k, v in modes.items() if v}}
        if not curve[-1][2] >= LEARN_BAR:
            fail(f"bn-learn {tag}: last-step Recall@1 {curve[-1][2]} below "
                 f"the bar {LEARN_BAR}")
        del solver, model
    wall = time.perf_counter() - t_start
    log(f"[5g] {wall:.1f} s")
    detail["bn_learning"] = {**out, "wall_s": wall}
    return out


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


def bf16_product(torch, a16):
    """cuBLAS's bf16 product ``a16 @ a16.T`` of bf16 rows with fp32 output
    (``kernel_breakdown.bf16_gemm``): the emitted sims' reference and the
    library yardstick of the bf16 stats and recompute hist/loss sweeps."""
    from npairloss_tpu_torch.tools.kernel_breakdown import bf16_gemm

    return bf16_gemm(torch, a16)


def check_blockwise_kernels(torch, timer, detail, seed,
                            sizes=((120, 1024), (8192, 1024)),
                            modes=("fp32", "bf16")):
    """The five kernels of csrc/npair_blockwise.cu against their plain
    sweeps on the card, in each mode: ``fp32`` (matmul precision
    HIGHEST) and ``bf16`` (DEFAULT: the products read bf16-rounded
    operands, gq/gdb round their weight tile).  In the bf16 mode the
    kernels get the features rounded by ``round_bf16`` (itself held to
    ``.to(torch.bfloat16).float()`` bit for bit), the plain sweeps the
    features as they are, which they round.  From the stats kernel's
    own emitted sims the plain stats, hist and loss sweeps must give
    bit-equal minima, maxima, counts, histograms and K-slot buffers; I/D
    sums within 1e-4 relative, gq/gdb within 1e-5 (N = 120) or 1e-4
    (N = 8192) of their largest entry (the plain sweeps sum in cuBLAS's
    and torch's order); the emitted sims within 1e-5 of cuBLAS's product
    of the mode's operands (``feats @ feats.T``, TF32 off; bf16-rounded
    in the bf16 mode); cached and recompute variants bit for bit, and
    each launched twice the same bits.  Each row's ``max_abs_err`` is
    the largest absolute difference kernel vs plain over the outputs this
    run compared.  Times: every kernel in both modes; the plain sweeps
    the median of 5 calls, one call in the bf16 mode at N = 8192.
    ``timer`` None: check only."""
    from npairloss_tpu_torch.ops import blockwise_npair as bw
    from npairloss_tpu_torch.ops import npair_loss as nl
    from npairloss_tpu_torch.ops.rank_select import sortable_key

    mm = nl.MiningMethod
    cfgs = {"reference": nl.REFERENCE_CONFIG,
            "local_rand": nl.NPairLossConfig(),
            "relative": nl.NPairLossConfig(
                ap_mining_method=mm.RELATIVE_EASY, identsn=-0.5,
                an_mining_method=mm.RELATIVE_HARD, diffsn=-0.3)}
    rows = {k: [] for k in BLOCKWISE_KERNELS + ("round_bf16",)}
    out = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n, d in sizes:
        f, lab = unit_batch(torch, seed + n, n, d)
        for mode in modes:
            rec = _blockwise_size_mode(torch, timer, bw, nl, sortable_key,
                                       cfgs, rows, f, lab, n, d, mode, sms)
            out[f"{n}/{mode}"] = rec
    detail["blockwise_kernels"] = {"checks": out, "rows": rows}
    return rows


def _blockwise_size_mode(torch, timer, bw, nl, sortable_key, cfgs, rows, f,
                         lab, n, d, mode, sms):
    mp = {"fp32": None, "bf16": "default"}[mode]
    kw = {"matmul_precision": mp}
    grad_tol = 1e-5 if n <= 120 else 1e-4
    bn = bm = min(512, n)
    # The plain loss sweep in the kernel's I/D order on this card.
    splits = bw.pool_splits(n, n, sms)
    rec = {"n": n, "d": d, "mode": mode, "hist_loss_splits": splits}
    # The kernels' operands: the bf16 mode's rounded once, as the engine
    # does; the plain sweeps round f themselves.  Every bf16 kernel that
    # multiplies rows reads their bf16 copy (``rows16``, which the plain
    # sweeps take and do not read).
    fk = f
    if mode == "bf16":
        fk, fk16 = bw.round_bf16(f)
        kw["rows16"] = fk16
        if not (torch.equal(fk.view(torch.int32),
                            nl.bf16_round(f).view(torch.int32))
                and torch.equal(fk16.view(torch.int16),
                                bw._rows16_plain(f).view(torch.int16))):
            fail(f"round_bf16 N={n}: differs from .to(torch.bfloat16)")
        _same_bits(torch, (fk, fk16), bw.round_bf16(f),
                   f"round_bf16 N={n}")
    # -- stats, every option on
    st = bw.npair_stats(fk, lab, fk, lab, hist_same=True, hist_diff=True,
                        topk=8, emit_sims=True, **kw)
    st_r = bw.npair_stats(fk, lab, fk, lab, hist_same=True, hist_diff=True,
                          topk=8, **kw)
    st_2 = bw.npair_stats(fk, lab, fk, lab, hist_same=True, hist_diff=True,
                          topk=8, emit_sims=True, **kw)
    _same_bits(torch, st, st_2, f"npair_stats N={n} {mode}")
    del st_2
    sims = st.sims
    if mode == "bf16":
        ref = bf16_product(torch, fk16)()
    else:
        ref = f @ f.T
    torch.cuda.synchronize()
    rec["sims_vs_cublas"] = (sims - ref).abs().max().item()
    if not rec["sims_vs_cublas"] <= 1e-5:
        fail(f"npair_stats N={n} {mode}: emitted sims off cuBLAS by "
             f"{rec['sims_vs_cublas']}")
    if mode == "bf16":
        rec["sims_vs_fp32_product"] = (sims - f @ f.T).abs().max().item()
    pst = bw.stats_plain(f, lab, f, lab, hist_same=True, hist_diff=True,
                         topk=8, sims=sims, bn=bn, bm=bm, **kw)
    errs = [rec["sims_vs_cublas"]]
    for name in bw.Stats._fields[:8]:
        errs.append(_abs_err(torch, getattr(st, name), getattr(pst, name)))
        if not torch.equal(getattr(st, name), getattr(pst, name)):
            fail(f"npair_stats N={n} {mode}: {name} differs from the plain "
                 "sweep on the kernel's sims")
        if not torch.equal(getattr(st, name), getattr(st_r, name)):
            fail(f"npair_stats N={n} {mode}: {name} differs with emit off")
    rec["stats_abs_err"] = max(errs)
    del ref, st_r, pst
    # -- hist: two sides, digits 1 and 5, prefixes of real pairs
    nxt = (torch.arange(n, device="cuda") + 1) % n
    keys = sortable_key(sims.gather(1, nxt[:, None])[:, 0])
    rec["hist_abs_err"] = 0.0
    for digit in (1, 5):
        pre = [keys >> (32 - 4 * digit), (keys ^ 1) >> (32 - 4 * digit)]
        args = (fk, lab, fk, lab, [True, False], pre, digit)
        h_c = bw.npair_hist(*args, sims=sims, **kw)
        h_r = bw.npair_hist(*args, **kw)
        h_p = bw.hist_plain(f, lab, f, lab, *args[4:], sims=sims, bn=bn,
                            bm=bm, **kw)
        skip = torch.ones((), dtype=torch.bool, device="cuda")
        h_s = bw.npair_hist(*args, sims=sims, skip=skip, **kw)
        _same_bits(torch, h_c, bw.npair_hist(*args, sims=sims, **kw),
                   f"npair_hist cached N={n} {mode} digit {digit}")
        _same_bits(torch, h_r, bw.npair_hist(*args, **kw),
                   f"npair_hist recompute N={n} {mode} digit {digit}")
        torch.cuda.synchronize()
        for a, b, c, s in zip(h_c, h_r, h_p, h_s):
            rec["hist_abs_err"] = max(rec["hist_abs_err"],
                                      _abs_err(torch, a, c),
                                      _abs_err(torch, b, c))
            if not (torch.equal(a, b) and torch.equal(a, c)):
                fail(f"npair_hist N={n} {mode} digit {digit}: kernel, "
                     "recompute and plain differ")
            if bool((s != 0).any()):
                fail(f"npair_hist N={n} {mode}: skip flag did not zero")
        rec[f"hist_digit{digit}_counted"] = int(h_c[0].sum() + h_c[1].sum())
    # -- loss, gq, gdb per mining config, from the engine's own
    # thresholds
    g = torch.ones((), device="cuda")
    for cname, cfg in cfgs.items():
        _, _, res = bw._forward(f, lab, cfg, bn, bm, True, 8, mp)
        thr = (res["pos_thr"], res["neg_thr"], res["max_all"])
        l_c = bw.npair_loss(fk, lab, fk, lab, *thr, cfg, sims=sims, **kw)
        l_r = bw.npair_loss(fk, lab, fk, lab, *thr, cfg, **kw)
        l_p = bw.loss_plain(f, lab, f, lab, *thr, cfg, sims=sims, bn=bn,
                            splits=splits, **kw)
        _same_bits(torch, l_c, bw.npair_loss(fk, lab, fk, lab, *thr, cfg,
                                             sims=sims, **kw),
                   f"npair_loss cached N={n} {mode} {cname}")
        _same_bits(torch, l_r, bw.npair_loss(fk, lab, fk, lab, *thr, cfg,
                                             **kw),
                   f"npair_loss recompute N={n} {mode} {cname}")
        valid = torch.ones(n, device="cuda")
        rest = (*thr, res["ident_sum"], res["all_sum"], valid, g, cfg)
        gargs, pargs = (fk, lab, fk, lab, *rest), (f, lab, f, lab, *rest)
        grads = {}
        for name, kern, pm in (("npair_gq", bw.npair_gq, False),
                               ("npair_gdb", bw.npair_gdb, True)):
            grads[name] = (kern(*gargs, sims=sims, **kw),
                           kern(*gargs, **kw),
                           bw.grad_plain(*pargs, pm, sims=sims, bn=bn, bm=bm,
                                         **kw))
            _same_bits(torch, grads[name][0],
                       kern(*gargs, sims=sims, **kw),
                       f"{name} cached N={n} {mode} {cname}")
            _same_bits(torch, grads[name][1], kern(*gargs, **kw),
                       f"{name} recompute N={n} {mode} {cname}")
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(l_c, l_r)):
            fail(f"npair_loss N={n} {mode} {cname}: cached and recompute "
                 "differ")
        if not (torch.equal(l_c[2], l_p[2]) and torch.equal(l_c[3], l_p[3])):
            fail(f"npair_loss N={n} {mode} {cname}: pair counts differ")
        sum_err = max(_rel_close(l_c[0], l_p[0]), _rel_close(l_c[1], l_p[1]))
        if not sum_err <= 1e-4:
            fail(f"npair_loss N={n} {mode} {cname}: I/D sums off by "
                 f"{sum_err}")
        rec[f"{cname}_sum_rel_err"] = sum_err
        # Rows whose I and D sums equal the kernel-order plain sweep's bit
        # for bit (the rest differ by their exps' ulps).
        rec[f"{cname}_sums_bit_equal_rows"] = int(
            ((l_c[0] == l_p[0]) & (l_c[1] == l_p[1])).sum())
        rec[f"{cname}_loss_abs_err"] = max(
            _abs_err(torch, a, b) for a, b in zip(l_c, l_p))
        rec[f"{cname}_pairs"] = [int(l_c[2].sum()), int(l_c[3].sum())]
        for name, (gc, gr, gp) in grads.items():
            if not torch.equal(gc, gr):
                fail(f"{name} N={n} {mode} {cname}: cached and recompute "
                     "differ")
            err = ((gc - gp).abs().max() /
                   gp.abs().max().clamp_min(1e-30)).item()
            if not err <= grad_tol:
                fail(f"{name} N={n} {mode} {cname}: {err} of the largest "
                     "entry")
            rec[f"{cname}_{name}_err"] = err
            rec[f"{cname}_{name}_abs_err"] = _abs_err(torch, gc, gp)
        if cname == "reference":
            path = (thr, gargs, pargs)
    log(f"[blockwise] N={n} D={d} {mode}: kernels = plain sweeps on the "
        f"kernel's sims; cached = recompute; repeat launches the same "
        f"bits; {json.dumps(rec)}")
    if timer is None:
        return rec
    # -- times at the path's variants (REFERENCE_CONFIG, sim cache on)
    thr, gargs, pargs = path
    nm, nd = n * n, n * d
    flop = 2.0 * n * n * d
    peak = "bf16" if mode == "bf16" else "fp32"
    # The plain sweeps at N = 8192 take ~0.1-1 s a call: the bf16 mode's
    # get one call each (the fp32 mode's the median of 5, as before).
    plain_iters = (5, 1) if n <= 120 or mode == "fp32" else (1, 0)

    gemm16 = None
    if mode == "fp32":
        cublas = rec["cublas_sim_ms"] = timer.ms(lambda: f @ f.T)
        log(f"[kernel] N={n} D={d}: cuBLAS fp32 sim product feats @ "
            f"feats.T alone (not a yardstick of the fused kernels): "
            f"{cublas:.4f} ms")
    else:
        cublas = None
        # The bf16 stats, hist and loss sweeps' yardstick: the sims alone.
        gemm16 = rec["cublas_bf16_ms"] = timer.ms(bf16_product(torch, fk16))
        log(f"[kernel] N={n} D={d}: cuBLAS bf16 rows16 @ rows16.T "
            f"(fp32 output): {gemm16:.4f} ms")

    def row(name, kern, plain, nbytes, ops, err, variant):
        bms, by = bound_ms(nbytes, ops, peak)
        r = {"n": n, "d": d, "mode": mode, "variant": variant,
             "max_abs_err": err, "ms": timer.ms(kern),
             "plain_ms": timer.ms(plain, iters=plain_iters[0],
                                  warmup=plain_iters[1]),
             "bound_ms": bms, "bound_by": by,
             "library_ms": gemm16 if name == "npair_stats" or (
                 variant == "recompute"
                 and name in ("npair_hist", "npair_loss")) else None}
        fp32_row = [x for x in rows[name] if x["n"] == n
                    and x["variant"] == variant and x["mode"] == "fp32"]
        if fp32_row:
            r["fp32_mode_ms"] = fp32_row[0]["ms"]
        rows[name].append(r)
        extra = (_vs_cublas(r["ms"], cublas, ops) if cublas and name in (
            "npair_stats", "npair_gq", "npair_gdb") else {})
        log(f"[kernel] {name} {variant} {mode} N={n} D={d}: "
            f"{json.dumps({**r, **extra})}")

    # Bytes: the self-pool's N x D operand read once (feats is pool).
    if mode == "bf16":
        row("round_bf16", lambda: bw.round_bf16(f),
            lambda: (nl.bf16_round(f), bw._rows16_plain(f)), 10 * nd, 0.0,
            0.0, "N x D")
    row("npair_stats",
        lambda: bw.npair_stats(fk, lab, fk, lab, hist_same=True, topk=8,
                               emit_sims=True, **kw),
        lambda: bw.stats_plain(f, lab, f, lab, hist_same=True, topk=8,
                               emit_sims=True, bn=bn, bm=bm, **kw),
        4 * nd + 4 * nm + 4 * n * (5 + 16 + 8), flop,
        rec["stats_abs_err"], "hist_same+topk8+emit")
    pre = [keys >> 28, keys >> 28]
    for cached in (True, False):
        s_ = sims if cached else None
        row("npair_hist",
            lambda: bw.npair_hist(fk, lab, fk, lab, [True, False], pre, 1,
                                  sims=s_, **kw),
            lambda: bw.hist_plain(f, lab, f, lab, [True, False], pre, 1,
                                  sims=s_, bn=bn, bm=bm, **kw),
            (4 * nm if cached else 4 * nd) + 4 * n * (1 + 2 + 32),
            0.0 if cached else flop, rec["hist_abs_err"],
            "cached" if cached else "recompute")
        row("npair_loss",
            lambda: bw.npair_loss(fk, lab, fk, lab, *thr,
                                  nl.REFERENCE_CONFIG, sims=s_, **kw),
            lambda: bw.loss_plain(f, lab, f, lab, *thr, nl.REFERENCE_CONFIG,
                                  sims=s_, bn=bn, splits=splits, **kw),
            (4 * nm if cached else 4 * nd) + 4 * n * (1 + 3 + 4),
            3.0 * nm + (0 if cached else flop),
            rec["reference_loss_abs_err"],
            "cached" if cached else "recompute")
        for name, kern, pm in (("npair_gq", bw.npair_gq, False),
                               ("npair_gdb", bw.npair_gdb, True)):
            row(name, lambda: kern(*gargs, sims=s_, **kw),
                lambda: bw.grad_plain(*pargs, pm, sims=s_, bn=bn, bm=bm,
                                      **kw),
                (4 * nm + 8 * nd if cached else 8 * nd) + 4 * n * 7,
                flop * (1 if cached else 2),
                rec[f"reference_{name}_abs_err"],
                "cached" if cached else "recompute")
    if mode == "fp32":
        # The early return of the path's 7 hist launches per step (the
        # pos_topk fast path holds): one side, the cache on.
        skip = torch.ones((), dtype=torch.bool, device="cuda")
        rec["hist_skip_ms"] = timer.ms(lambda: bw.npair_hist(
            f, lab, f, lab, [True], pre[:1], 1, sims=sims, skip=skip))
        log(f"[kernel] npair_hist early return N={n}: "
            f"{rec['hist_skip_ms']:.4f} ms")
    return rec


# -- phase 6b: the blockwise training path ------------------------------------


def blockwise_net(work, source=os.path.join("examples",
                                            "googlenet_cub.prototxt")):
    """examples/googlenet_cub.prototxt (or the net at ``source``) with its
    mining swapped for the reference's shipped config
    (examples/resnet50_global_relhard.prototxt: 48-59,
    usage/def.prototxt's values)."""
    import re

    net = open(source).read()
    mining = ("npair_loss_param {\n        margin_ident: 0\n"
              "        margin_diff: -0.05\n        identsn: -0.0\n"
              "        diffsn: -0.3\n        ap_mining_region: GLOBAL\n"
              "        ap_mining_method: RELATIVE_HARD\n"
              "        an_mining_region: LOCAL\n"
              "        an_mining_method: HARD\n    }")
    net, k = re.subn(r"npair_loss_param \{[^}]*\}", mining, net)
    if k != 1:
        fail(f"{source} has {k} npair_loss_param blocks")
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, os.path.basename(source).replace(
        ".prototxt", "_relhard.prototxt"))
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
    profile = profile_train_step(torch, lambda: solver.step(x_np, lab_np))
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


def stretch_plain_ms(torch, bw, f, lab, thr, gargs, sims, pre, cfg, splits,
                     **kw):
    """One call of each plain sweep at the stretch (4096-row tiles; the
    plain version of each kernel variant the stretch times), its wall ms
    between two synchronizes: a median of several calls would take
    minutes."""
    big = {"bn": 4096, "bm": 4096}

    def once(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    out = {"npair_stats+emit": once(lambda: bw.stats_plain(
        f, lab, f, lab, hist_same=True, topk=8, emit_sims=True, **big,
        **kw))}
    for cached, s_ in (("cached", sims), ("recompute", None)):
        out[f"npair_hist {cached}"] = once(lambda: bw.hist_plain(
            f, lab, f, lab, [True], pre, 1, sims=s_, **big, **kw))
        out[f"npair_loss {cached}"] = once(lambda: bw.loss_plain(
            f, lab, f, lab, *thr, cfg, sims=s_, splits=splits, **big, **kw))
        for name, pm in (("npair_gq", False), ("npair_gdb", True)):
            out[f"{name} {cached}"] = once(lambda: bw.grad_plain(
                *gargs, pm, sims=s_, **big, **kw))
    return out


def stretch_configs(nl):
    """The stretch's mining configs: REFERENCE_CONFIG, LOCAL/RAND, and
    positives and negatives both GLOBAL/RELATIVE_HARD (the radix path, 7
    hist sweeps of two sides each)."""
    ref = nl.REFERENCE_CONFIG
    return {"reference": ref, "local_rand": nl.NPairLossConfig(),
            "radix_both": nl.NPairLossConfig(
                margin_ident=ref.margin_ident, margin_diff=ref.margin_diff,
                identsn=ref.identsn, diffsn=ref.diffsn,
                ap_mining_region=nl.MiningRegion.GLOBAL,
                ap_mining_method=nl.MiningMethod.RELATIVE_HARD,
                an_mining_region=nl.MiningRegion.GLOBAL,
                an_mining_method=nl.MiningMethod.RELATIVE_HARD)}


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

    for cname, cfg in stretch_configs(nl).items():
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
             4 * n * d + 4 * nm, flop),
            ("npair_hist cached", lambda: bw.npair_hist(
                f, lab, f, lab, [True], pre, 1, sims=sims), 4 * nm, 0.0),
            ("npair_hist recompute", lambda: bw.npair_hist(
                f, lab, f, lab, [True], pre, 1), 4 * n * d, flop),
            ("npair_hist cached, 2 sides", lambda: bw.npair_hist(
                *hist_args, sims=sims), 4 * nm, 0.0),
            ("npair_hist recompute, 2 sides", lambda: bw.npair_hist(
                *hist_args), 4 * n * d, flop),
            ("npair_loss cached", lambda: bw.npair_loss(
                f, lab, f, lab, *thr, cfg, sims=sims), 4 * nm, 3 * nm),
            ("npair_loss recompute", lambda: bw.npair_loss(
                f, lab, f, lab, *thr, cfg), 4 * n * d, flop + 3 * nm),
            ("npair_gq cached", lambda: bw.npair_gq(*gargs, sims=sims),
             4 * nm + 8 * n * d, flop),
            ("npair_gq recompute", lambda: bw.npair_gq(*gargs),
             8 * n * d, 2 * flop),
            ("npair_gdb cached", lambda: bw.npair_gdb(*gargs, sims=sims),
             4 * nm + 8 * n * d, flop),
            ("npair_gdb recompute", lambda: bw.npair_gdb(*gargs),
             8 * n * d, 2 * flop)):
        bms, by = bound_ms(nbytes, ops, "fp32")
        times[name] = {"ms": timer.ms(fn, iters=5, warmup=1),
                       "bound_ms": bms, "bound_by": by}
        if name.startswith(("npair_stats", "npair_gq", "npair_gdb")):
            times[name].update(_vs_cublas(times[name]["ms"],
                                          out["cublas_sim_ms"], ops))
        log(f"[stretch] {name} N={n} D={d}: {json.dumps(times[name])}")
    splits = bw.pool_splits(n, n, torch.cuda.get_device_properties(
        0).multi_processor_count)
    plain = stretch_plain_ms(torch, bw, f, lab, thr, gargs, sims, pre, cfg,
                             splits)
    for name, ms in plain.items():
        times[name]["plain_ms"] = ms
    log(f"[stretch] plain sweeps, one call each (ms): {json.dumps(plain)}")
    out["kernel_ms"] = times
    detail["stretch"] = out
    return out


# Off the stretch's round shapes for the bf16 mode's tensor cores: N = M =
# 1000 (a partial last tile), D = 68 (gq/gdb a cluster of 4, three blocks
# without columns; the bf16 rows padded to 72, two 64-deep sim slices, the
# second mostly zero) and D = 1028 (a cluster of 8, a second pass of
# columns; 17 sim slices).
GRAD_TC_EDGES = ((1000, 68), (1000, 1028))

# The bf16 instantiations that must run on the tensor cores, as their
# names' templates read (mangled, as cuobjdump -sass prints them, or not):
# npair_grad_tc_kernel<cached, kS>, npair_stats_kernel<true> and the
# recompute npair_hist_kernel / npair_loss_kernel<false, L, true>.
TC_KERNELS = {
    "npair_grad_tc_kernel": (r"npair_grad_tc_kernel(I|<)", 4),
    "npair_stats_kernel<true>": (r"npair_stats_kernel(ILb1EE|<true>)", 1),
    "npair_hist_kernel<false, L, true>": (
        r"npair_hist_kernel(ILb0E[if]Lb1EE|<false, (int|float), true>)", 2),
    "npair_loss_kernel<false, L, true>": (
        r"npair_loss_kernel(ILb0E[if]Lb1EE|<false, (int|float), true>)", 2),
}


def tc_sass(detail):
    """``cuobjdump -sass`` of the built library: every bf16 instantiation
    of ``TC_KERNELS`` must hold HGMMA, the tensor cores' warp-group
    product, and no fp32 instantiation of stats, hist or loss may."""
    import re

    from npairloss_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", _build.build_info["path"]],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    found = {k: {} for k in TC_KERNELS}
    fp32 = {}
    for block in sass.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        kinds = [k for k, (pat, _) in TC_KERNELS.items()
                 if re.search(pat, name)]
        if kinds:
            found[kinds[0]][name] = block.count("HGMMA")
        elif re.search(r"npair_(stats|hist|loss)_kernel", name):
            fp32[name] = block.count("HGMMA")
    log(f"[tc] HGMMA instructions per bf16 instantiation: "
        f"{json.dumps(found)}; fp32 stats/hist/loss: {json.dumps(fp32)}")
    for kind, (_, count) in TC_KERNELS.items():
        if len(found[kind]) != count or not all(found[kind].values()):
            fail(f"the bf16 {kind} SASS lacks HGMMA (or an instantiation is "
                 f"missing): {found[kind]}")
    if not fp32 or any(fp32.values()):
        fail(f"the fp32 stats/hist/loss instantiations: {fp32}")
    detail["tc_hgmma"] = found
    return found


def bf16_engine_bits(torch, bw, nl, f, lab, what):
    """Loss + backward in the bf16 mode in each of ``stretch_configs``:
    sim cache on = off bit for bit in the loss, the aux outputs and the
    gradient (the cached sweeps read stats' sims, the recompute ones and
    gq/gdb sum their own: both roles, pool-major and query-major), and
    for REFERENCE_CONFIG ``pos_topk`` 8 = 0; finite.  Returns the walls
    and launches."""
    import math

    from npairloss_tpu_torch.ops import _build

    def run(cfg, **kw):
        x = f.clone().requires_grad_()
        _build.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, aux = bw.blockwise_npair_loss_with_aux(
            x, lab, cfg, matmul_precision="default", **kw)
        loss.backward()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        return (loss.detach(), aux, x.grad, wall,
                {k: v for k, v in _build.launch_counts().items() if v})

    out = {}
    for cname, cfg in stretch_configs(nl).items():
        on = run(cfg, sim_cache=True)
        others = [("cache off", run(cfg, sim_cache=False))]
        if cname == "reference":
            others.append(("pos_topk 0", run(cfg, sim_cache=True,
                                             pos_topk=0)))
        rec = {"loss": on[0].item(), "wall_ms_cache_on": on[3],
               "launches": on[4]}
        for tag, other in others:
            if not (torch.equal(on[0], other[0])
                    and torch.equal(on[2], other[2])
                    and all(torch.equal(on[1][k], other[1][k])
                            for k in on[1])):
                fail(f"{what} bf16 {cname}: {tag} differs from cache on")
            rec[f"wall_ms_{tag.replace(' ', '_')}"] = other[3]
        if not (math.isfinite(rec["loss"])
                and bool(torch.isfinite(on[2]).all())):
            fail(f"{what} bf16 {cname}: non-finite loss or gradient")
        out[cname] = rec
        del on, others
    log(f"[bf16] {what}: cache on = off bit for bit in {list(out)}, "
        f"pos_topk 8 = 0; {json.dumps(out)}")
    return out


def bf16_kernel_checks(torch, bw, nl, sortable_key, f, lab, what, big,
                       splits):
    """The five kernels in the bf16 mode on ``round_bf16(f)`` and its bf16
    rows: each launched twice the same bits; the emitted sims within 1e-5
    of cuBLAS's bf16 product of the same rows and never -0; stats, hist
    (two sides, digit 1) and loss against their plain sweeps on the
    kernel's own sims (``big``-row tiles; the loss sweep in the kernels'
    I/D order at ``splits``): minima, maxima, counts, histograms and K-slot
    buffers bit for bit, I/D sums within 1e-4 relative; cached =
    recompute bit for bit for hist, loss, gq and gdb, gq/gdb within 1e-4
    of the plain sweep's largest entry.  Returns the errors and, for the
    timings, the inputs."""
    cfg = nl.REFERENCE_CONFIG
    n = f.shape[0]
    fk, fk16 = bw.round_bf16(f)
    if not (torch.equal(fk.view(torch.int32),
                        nl.bf16_round(f).view(torch.int32))
            and torch.equal(fk16.view(torch.int16),
                            bw._rows16_plain(f).view(torch.int16))):
        fail(f"{what} bf16: round_bf16 differs from .to(torch.bfloat16)")
    kw = {"matmul_precision": "default", "rows16": fk16}
    _, _, res = bw._forward(f, lab, cfg, 512, 512, True, 8, "default")
    thr = (res["pos_thr"], res["neg_thr"], res["max_all"])
    rest = (*thr, res["ident_sum"], res["all_sum"],
            torch.ones(n, device="cuda"), torch.ones((), device="cuda"), cfg)
    gargs, pargs = (fk, lab, fk, lab, *rest), (f, lab, f, lab, *rest)
    st_kw = dict(hist_same=True, hist_diff=True, topk=8, emit_sims=True,
                 **kw)
    st = bw.npair_stats(fk, lab, fk, lab, **st_kw)
    _same_bits(torch, st, bw.npair_stats(fk, lab, fk, lab, **st_kw),
               f"{what} bf16 npair_stats")
    sims = st.sims
    errs = {"sims_vs_cublas":
            (sims - bf16_product(torch, fk16)()).abs().max().item(),
            "exact_zero_sims": int((sims == 0).sum().item()),
            "negative_zero_sims": int(((sims == 0)
                                       & torch.signbit(sims)).sum().item())}
    if not errs["sims_vs_cublas"] <= 1e-5:
        fail(f"{what} bf16: emitted sims off cuBLAS by {errs}")
    if errs["negative_zero_sims"]:
        fail(f"{what} bf16: the cache holds -0 sims: {errs}")
    if not torch.equal(res["sims"], sims):
        fail(f"{what} bf16: the engine's cache differs from npair_stats'")
    pst = bw.stats_plain(f, lab, f, lab, sims=sims, bn=big, bm=big,
                         **{**st_kw, "emit_sims": False})
    for name in bw.Stats._fields[:8]:
        a, b = getattr(st, name), getattr(pst, name)
        if (a is None) != (b is None) or (a is not None
                                          and not torch.equal(a, b)):
            fail(f"{what} bf16 npair_stats: {name} differs from the plain "
                 "sweep on the kernel's sims")
    del pst
    pre = [sortable_key(sims[:, 1]) >> 28]  # digit-1 prefixes of real pairs
    hist_args = (fk, lab, fk, lab, [True, False], pre * 2, 1)
    h_c = bw.npair_hist(*hist_args, sims=sims, **kw)
    h_r = bw.npair_hist(*hist_args, **kw)
    h_p = bw.hist_plain(f, lab, f, lab, *hist_args[4:], sims=sims, bn=big,
                        bm=big, **kw)
    _same_bits(torch, h_c, bw.npair_hist(*hist_args, sims=sims, **kw),
               f"{what} bf16 npair_hist cached")
    _same_bits(torch, h_r, bw.npair_hist(*hist_args, **kw),
               f"{what} bf16 npair_hist recompute")
    if not all(torch.equal(a, b) and torch.equal(a, c)
               for a, b, c in zip(h_c, h_r, h_p)):
        fail(f"{what} bf16 npair_hist: kernel, recompute and plain differ")
    l_c = bw.npair_loss(fk, lab, fk, lab, *thr, cfg, sims=sims, **kw)
    l_r = bw.npair_loss(fk, lab, fk, lab, *thr, cfg, **kw)
    _same_bits(torch, l_c, bw.npair_loss(fk, lab, fk, lab, *thr, cfg,
                                         sims=sims, **kw),
               f"{what} bf16 npair_loss")
    _same_bits(torch, l_r, bw.npair_loss(fk, lab, fk, lab, *thr, cfg, **kw),
               f"{what} bf16 npair_loss recompute")
    l_p = bw.loss_plain(f, lab, f, lab, *thr, cfg, sims=sims, bn=big,
                        bm=big, splits=splits, **kw)
    if not (all(torch.equal(a, b) for a, b in zip(l_c, l_r))
            and torch.equal(l_c[2], l_p[2]) and torch.equal(l_c[3], l_p[3])):
        fail(f"{what} bf16 npair_loss: cached, recompute and plain counts "
             "differ")
    errs["loss_sum_rel_err"] = max(_rel_close(l_c[0], l_p[0]),
                                   _rel_close(l_c[1], l_p[1]))
    if not errs["loss_sum_rel_err"] <= 1e-4:
        fail(f"{what} bf16 npair_loss: I/D sums off by {errs}")
    del l_p
    for name, kern, pm in (("npair_gq", bw.npair_gq, False),
                           ("npair_gdb", bw.npair_gdb, True)):
        gc = kern(*gargs, sims=sims, **kw)
        gr = kern(*gargs, **kw)
        _same_bits(torch, gc, kern(*gargs, sims=sims, **kw),
                   f"{what} bf16 {name} cached")
        _same_bits(torch, gr, kern(*gargs, **kw),
                   f"{what} bf16 {name} recompute")
        gp = bw.grad_plain(*pargs, pm, sims=sims, bn=big, bm=big, **kw)
        errs[f"{name}_err"] = ((gc - gp).abs().max()
                               / gp.abs().max().clamp_min(1e-30)).item()
        if not torch.equal(gc, gr) or not errs[f"{name}_err"] <= 1e-4:
            fail(f"{what} bf16 {name}: cached/recompute differ or "
                 f"{errs[f'{name}_err']} off the plain sweep")
        del gc, gr, gp
    torch.cuda.synchronize()
    log(f"[bf16] {what}: every kernel (cached and recompute) launched "
        f"twice gives the same bits and agrees with its plain sweep on the "
        f"kernel's sims: {json.dumps(errs)}")
    return errs, dict(fk=fk, fk16=fk16, sims=sims, thr=thr, res=res,
                      gargs=gargs, pargs=pargs, pre=pre, kw=kw)


def signed_zero_batch(torch, seed, n=640, d=64):
    """n rows in n/2 identities of 2 whose sims hold many exact zeros,
    signed either way by the FMA chain's rules: rows of +0 and of -0,
    rows of one sign only (every product with a zero row then -0 or +0
    alike), and signed basis vectors (orthogonal to each other); the rest
    unit rows."""
    f, lab = unit_batch(torch, seed, n, d)
    k = n // 8
    f[0:k] = 0.0
    f[k:2 * k] = -0.0
    f[2 * k:3 * k] = -(d ** -0.5)
    f[3 * k:4 * k] = d ** -0.5
    eye = torch.eye(d, device="cuda")
    f[4 * k:5 * k] = eye[torch.arange(k, device="cuda") % d]
    f[5 * k:6 * k] = -eye[torch.arange(k, device="cuda") % d]
    return f.contiguous(), lab


def check_bf16_edges(torch, bw, nl, sortable_key, seed, sms):
    """The bf16 mode's checks of the stretch (``bf16_engine_bits``,
    ``bf16_kernel_checks``) at ``GRAD_TC_EDGES`` and on a batch with
    zero and orthogonal rows (``signed_zero_batch``); the engine's bf16
    rows equal ``.to(torch.bfloat16)`` zero-padded there."""
    out = {}
    batches = [(f"N={n} D={d}", unit_batch(torch, seed + 11 + d, n, d))
               for n, d in GRAD_TC_EDGES]
    batches.append(("signed zero N=640 D=64",
                    signed_zero_batch(torch, seed + 12)))
    for what, (f, lab) in batches:
        n = f.shape[0]
        out[what] = {"engine": bf16_engine_bits(torch, bw, nl, f, lab, what)}
        out[what]["kernels"] = bf16_kernel_checks(
            torch, bw, nl, sortable_key, f, lab, what, 512,
            bw.pool_splits(n, n, sms))[0]
    return out


def check_stretch_bf16(torch, timer, detail, seed, n=32768, d=512):
    """The stretch in the kernels' bf16 mode (matmul precision DEFAULT),
    every sim on the tensor cores: ``bf16_engine_bits`` (loss + backward
    in the three mining configs, cache on = off and ``pos_topk`` 8 = 0
    bit for bit) and ``bf16_kernel_checks`` (all five kernels, cached and
    recompute, launched twice the same bits and against their plain
    sweeps on the kernel's own emitted sims at 4096-row tiles; the sims
    within 1e-5 of cuBLAS's bf16 product and never -0); HGMMA in every
    bf16 instantiation (``tc_sass``); the same checks at
    ``GRAD_TC_EDGES`` and on zero and orthogonal rows
    (``check_bf16_edges``); each kernel's time beside the fp32 mode's
    (phase 6c), its bound at the dense bf16 peak and the yardsticks:
    cuBLAS's bf16 ``rows16 @ rows16.T`` beside stats, hist and loss, its
    bf16 ``W @ rows`` beside gq/gdb.  The kernels get the features
    rounded once by ``round_bf16`` (bit for bit ``.to(torch.bfloat16)``),
    the plain sweeps the features as they are."""
    from npairloss_tpu_torch.ops import blockwise_npair as bw
    from npairloss_tpu_torch.ops import npair_loss as nl
    from npairloss_tpu_torch.ops.rank_select import sortable_key

    t_start = time.perf_counter()
    f, lab = unit_batch(torch, seed + 3, n, d)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits = bw.pool_splits(n, n, sms)
    out = {"n": n, "d": d,
           "engine": bf16_engine_bits(torch, bw, nl, f, lab, "stretch")}
    ref = out["engine"]["reference"]
    out.update(loss=ref["loss"], wall_ms_cache_on=ref["wall_ms_cache_on"],
               wall_ms_cache_off=ref["wall_ms_cache_off"],
               launches=ref["launches"])
    errs, inp = bf16_kernel_checks(torch, bw, nl, sortable_key, f, lab,
                                   "stretch", 4096, splits)
    out["errors"] = errs
    # Every bf16 instantiation on the tensor cores; the shapes off the
    # stretch's and the signed zeros.
    tc_sass(out)
    out["edges"] = check_bf16_edges(torch, bw, nl, sortable_key, seed, sms)

    fk, fk16, sims, thr = inp["fk"], inp["fk16"], inp["sims"], inp["thr"]
    res, gargs, pargs, pre, kw = (inp["res"], inp["gargs"], inp["pargs"],
                                  inp["pre"], inp["kw"])
    cfg = nl.REFERENCE_CONFIG
    fp32_ms = detail.get("stretch", {}).get("kernel_ms", {})
    nm, flop = float(n) * n, 2.0 * n * n * d
    st_kw = dict(hist_same=True, topk=8, emit_sims=True, **kw)
    gemm16 = out["cublas_bf16_ms"] = timer.ms(bf16_product(torch, fk16),
                                              iters=5, warmup=1)
    log(f"[stretch-bf16] cuBLAS bf16 rows16 @ rows16.T (fp32 output), the "
        f"yardstick of stats and the recompute hist and loss: "
        f"{gemm16:.3f} ms")
    times = {}
    for name, fn, nbytes, ops in (
            ("round_bf16", lambda: bw.round_bf16(f),
             10 * n * d, 0.0),
            ("npair_stats+emit", lambda: bw.npair_stats(
                fk, lab, fk, lab, **st_kw), 4 * n * d + 4 * nm, flop),
            ("npair_hist cached", lambda: bw.npair_hist(
                fk, lab, fk, lab, [True], pre, 1, sims=sims, **kw), 4 * nm,
             0.0),
            ("npair_hist recompute", lambda: bw.npair_hist(
                fk, lab, fk, lab, [True], pre, 1, **kw), 4 * n * d, flop),
            ("npair_loss cached", lambda: bw.npair_loss(
                fk, lab, fk, lab, *thr, cfg, sims=sims, **kw), 4 * nm,
             3 * nm),
            ("npair_loss recompute", lambda: bw.npair_loss(
                fk, lab, fk, lab, *thr, cfg, **kw), 4 * n * d,
             flop + 3 * nm),
            ("npair_gq cached", lambda: bw.npair_gq(*gargs, sims=sims,
                                                    **kw),
             4 * nm + 8 * n * d, flop),
            ("npair_gq recompute", lambda: bw.npair_gq(*gargs, **kw),
             8 * n * d, 2 * flop),
            ("npair_gdb cached", lambda: bw.npair_gdb(*gargs, sims=sims,
                                                      **kw),
             4 * nm + 8 * n * d, flop),
            ("npair_gdb recompute", lambda: bw.npair_gdb(*gargs, **kw),
             8 * n * d, 2 * flop)):
        bms, by = bound_ms(nbytes, ops, "bf16")
        times[name] = {"ms": timer.ms(fn, iters=5, warmup=1),
                       "bound_ms": bms, "bound_by": by,
                       "fp32_mode_ms": fp32_ms.get(name, {}).get("ms")}
        if name.startswith("npair_stats") or name in (
                "npair_hist recompute", "npair_loss recompute"):
            times[name]["cublas_bf16_sims_ms"] = gemm16
        log(f"[stretch-bf16] {name} N={n} D={d}: {json.dumps(times[name])}")
    plain = stretch_plain_ms(torch, bw, f, lab, thr, pargs, sims, pre, cfg,
                             splits, matmul_precision="default")
    plain["round_bf16"] = timer.ms(
        lambda: (nl.bf16_round(f), bw._rows16_plain(f)), iters=5, warmup=1)
    for name, ms in plain.items():
        times[name]["plain_ms"] = ms
    log(f"[stretch-bf16] plain sweeps, one call each (ms): "
        f"{json.dumps(plain)}")
    # A yardstick beside gq/gdb, never called by the port (the kernels
    # never build W): cuBLAS's bf16 product of the materialised N x N
    # weight matrix by the bf16 rows, the weights' build not timed.
    valid = torch.ones(n, device="cuda")
    g = torch.ones((), device="cuda")
    same, diff = bw._tile_masks(lab, lab, (0, n), (0, n), 0)
    pt, nt = bw._margined(thr[0], thr[1], cfg)
    a, b = bw._query_terms(res["ident_sum"], res["all_sum"], valid, g, n)
    w16 = bw._weight_tile(sims, same, diff, pt[:, None], nt[:, None],
                          thr[2][:, None], a[:, None], b[:, None], cfg,
                          bf16=True).to(torch.bfloat16)
    del same, diff
    for name, w_ in (("npair_gq", w16), ("npair_gdb", w16.T)):
        ms = timer.ms(lambda: torch.matmul(w_, fk16), iters=5, warmup=1)
        for variant in ("cached", "recompute"):
            times[f"{name} {variant}"]["cublas_bf16_w_ms"] = ms
        log(f"[stretch-bf16] {name}: cuBLAS bf16 W @ rows ({n} x {n} W "
            f"materialised): {ms:.3f} ms")
    del w16
    out["kernel_ms"] = times
    out["wall_s"] = time.perf_counter() - t_start
    log(f"[stretch-bf16] {out['wall_s']:.1f} s")
    detail["stretch_bf16"] = out
    return out


# -- phase 5h: sync-free stepping ---------------------------------------------

PIPE_WORK = os.path.join("build", "pipe_smoke")
# (tag, train argv after the solver, net): the phase-5 solver cut to 12
# iterations, display 4, snapshot 4; each run once per loop.
PIPE_RUNS = (
    ("bn_mxu", ["--model", "googlenet_bn", "--precision", "mxu"], "cub"),
    ("bn_mxu_blockwise", ["--model", "googlenet_bn", "--precision", "mxu",
                          "--engine", "blockwise"], "relhard"),
    ("pallas_fp32", ["--model", "googlenet_pallas"], "cub"),
    ("pallas_fp32_blockwise", ["--model", "googlenet_pallas", "--engine",
                               "blockwise"], "relhard"),
)
# Kernels each configuration's captured step must launch on every replay.
PIPE_KERNELS = {
    "bn_mxu": (),
    "bn_mxu_blockwise": tuple(f"{k}:bf16_launches" for k in BLOCKWISE_KERNELS)
    + ("round_bf16:launches",),
    "pallas_fp32": ("lrn_fwd_cached:launches", "lrn_bwd_cached:launches",
                    "fused_bias_relu:launches",
                    "fused_bias_relu_pool:launches"),
    "pallas_fp32_blockwise": tuple(f"{k}:launches" for k in BLOCKWISE_KERNELS)
    + ("lrn_fwd_cached:launches", "lrn_bwd_cached:launches",
       "fused_bias_relu:launches", "fused_bias_relu_pool:launches"),
}
PIPE_ITERS = 12
# The drills skip the iteration-0 TEST pass (eager in both loops).
NO_TEST = {"test_initialization": "false"}


def _pipe_train(torch, seed, tag, argv, pipeline, batches=None, hook=None,
                synthetic=True, **cut):
    """One in-process ``train`` on the phase-5h cut: ``argv`` after the
    solver, ``--pipeline`` when ``pipeline``.  ``batches`` replaces the
    TRAIN data (a list, from index 0); ``hook(solver, loop, n)`` runs
    before the n-th step's dispatch (1-based); a pipelined run carries a
    strict ``HostSyncMonitor``.  Each step's end is stamped with a CUDA
    event.  Returns a dict: rc, stdout lines, events, the solver, step
    ms (steps 2-12), the launches of the steps, the monitor's counts."""
    import contextlib

    from npairloss_tpu_torch import cli
    from npairloss_tpu_torch.ops import _build
    from npairloss_tpu_torch.pipeline import HostSyncMonitor
    from npairloss_tpu_torch.train import solver as tsolver

    work = os.path.join(PIPE_WORK, f"{tag}_{'pipe' if pipeline else 'sync'}")
    import shutil

    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    events_path = os.path.join(work, "events.jsonl")
    seen = {"solver": None, "marks": [], "after_test": None, "n": 0,
            "monitor": None}
    orig = {"train": tsolver.Solver.train, "step": tsolver.Solver.step,
            "pipe": tsolver.Solver._pipelined_step}

    def train(self, *a, **kw):
        seen["solver"] = self
        if pipeline:
            seen["monitor"] = self.sync_monitor = HostSyncMonitor(
                strict=True)
        return orig["train"](self, *a, **kw)

    def stamped(fn, loop):
        def run(self, *a, **kw):
            if seen["after_test"] is None:
                seen["after_test"] = _build.launch_counts()
            seen["n"] += 1
            if hook is not None:
                hook(self, loop, seen["n"])
            out = fn(self, *a, **kw)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            seen["marks"].append(ev)
            return out
        return run

    orig_data = cli._build_data

    def data(args, net_cfg, phase, input_shape, s, device):
        if phase == "TRAIN" and batches is not None:
            return iter(batches)
        return orig_data(args, net_cfg, phase, input_shape, s, device)

    cut = {"max_iter": PIPE_ITERS, "display": 4, "snapshot": 4, **cut}
    full = ["train", "--solver", cut_solver(work, **cut),
            *argv, "--log-json", events_path, "--seed", str(seed),
            "--snapshot_prefix", os.path.join(work, "snap_")]
    if synthetic:
        full.append("--synthetic")
    if pipeline:
        full.append("--pipeline")
    out = io.StringIO()
    tsolver.Solver.train = train
    tsolver.Solver.step = stamped(orig["step"], "sync")
    tsolver.Solver._pipelined_step = stamped(orig["pipe"], "pipe")
    cli._build_data = data
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(full)
        torch.cuda.synchronize()
    finally:
        tsolver.Solver.train = orig["train"]
        tsolver.Solver.step = orig["step"]
        tsolver.Solver._pipelined_step = orig["pipe"]
        cli._build_data = orig_data
    wall = time.perf_counter() - t0
    marks = seen["marks"]
    ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    c0, c1 = seen["after_test"] or {}, _build.launch_counts()
    events = ([json.loads(ln) for ln in open(events_path)]
              if os.path.exists(events_path) else [])
    mon = seen["monitor"]
    solver = seen["solver"]
    return {"rc": rc, "lines": out.getvalue().splitlines(),
            "stats": dict(solver.pipeline_stats) if solver else {},
            "events": events, "solver": seen["solver"], "step_ms": ms,
            "launches": {k: c1[k] - c0.get(k, 0) for k in c1
                         if c1[k] - c0.get(k, 0)},
            "sync_counts": mon.counts() if mon else None,
            "violations": mon.violations() if mon else None,
            "wall_s": wall, "work": work}


def _state_equal(torch, a, b):
    """Names of the tensors where two solvers (or state dicts) differ,
    and how many were compared."""
    sa = a if isinstance(a, dict) else a.state_dict()
    sb = b if isinstance(b, dict) else b.state_dict()
    differ = [k for k in sa if k not in sb or not torch.equal(sa[k], sb[k])]
    return differ + sorted(set(sb) - set(sa)), len(sa)


def _profile_pipe_step(torch, solver, step_ms):
    """Three more replays of the captured step under ``torch.profiler``
    (``profile_train_step``); the idle share against the run's median."""
    from npairloss_tpu_torch.data.synthetic import synthetic_identity_batches
    from npairloss_tpu_torch.device import upload

    x, lab = next(synthetic_identity_batches(240, 60, 2, (224, 224, 3),
                                             seed=32))
    x, lab = upload(x, solver.device), upload(lab, solver.device)
    cap = solver._window.capacity
    solver._clear_ring()
    prof = profile_train_step(
        torch, lambda: solver._pipelined_step(x, lab, cap))
    if prof is not None:
        prof["idle_share"] = 1.0 - prof["busy_ms"] / step_ms
    return prof


def _profile_sync_step(torch, solver, step_ms):
    from npairloss_tpu_torch.data.synthetic import synthetic_identity_batches

    x, lab = next(synthetic_identity_batches(240, 60, 2, (224, 224, 3),
                                             seed=32))
    prof = profile_train_step(torch, lambda: solver.step(x, lab))
    if prof is not None:
        prof["idle_share"] = 1.0 - prof["busy_ms"] / step_ms
    return prof


def _masked_events(events, work):
    """The events as JSON text with the run's own directory masked out
    (text, so NaN compares equal to NaN)."""
    return json.dumps(events).replace(os.path.abspath(work), "<work>")


def _masked_lines(run):
    """A run's stdout lines with its own directory masked out."""
    return [ln.replace(os.path.abspath(run["work"]), "<work>")
            for ln in run["lines"]]


def check_pipeline_config(torch, seed, tag, argv, batches, card):
    """One phase-5h configuration, once per loop: streams byte for byte,
    final state bit for bit, replays counted, launches per step equal,
    no mid-window host sync; step ms, idle share, blocked waits, the
    capture's ms and the graph pool's bytes."""
    from npairloss_tpu_torch.train.solver import PIPELINE_WARMUP_STEPS

    runs = {}
    for loop in ("sync", "pipe"):
        r = _pipe_train(torch, seed, tag, argv, loop == "pipe",
                        batches=batches.from_index(0))
        if r["rc"] != 0:
            fail(f"5h {tag} {loop}: train returned {r['rc']}: "
                 f"{r['lines'][-5:]}")
        if len(r["step_ms"]) != PIPE_ITERS - 1:
            fail(f"5h {tag} {loop}: {len(r['step_ms']) + 1} steps stamped")
        r["median_ms"] = statistics.median(r["step_ms"])
        runs[loop] = r
    s, p = runs["sync"], runs["pipe"]
    # The final states before the profiles below step them further.
    differ, n = _state_equal(torch, s["solver"], p["solver"])
    if differ:
        fail(f"5h {tag}: final state differs in {differ[:5]}")
    final = {k: v.clone() for k, v in s["solver"].state_dict().items()}
    for loop, r in runs.items():
        prof = (_profile_pipe_step if loop == "pipe" else _profile_sync_step)
        r["profile"] = prof(torch, r["solver"], r["median_ms"])
    if s["lines"] != p["lines"]:
        diff = [(a, b) for a, b in zip(s["lines"], p["lines"]) if a != b]
        fail(f"5h {tag}: display lines differ: {diff[:3]}")
    if _masked_events(s["events"], s["work"]) != \
            _masked_events(p["events"], p["work"]):
        fail(f"5h {tag}: --log-json streams differ")
    stats = p["stats"]
    replays = PIPE_ITERS - PIPELINE_WARMUP_STEPS
    if stats["replays"] != replays or stats["captures"] != 1 \
            or stats["eager_steps"] != PIPELINE_WARMUP_STEPS:
        fail(f"5h {tag}: expected {PIPELINE_WARMUP_STEPS} warm-up steps, "
             f"one capture and {replays} replays: {stats}")
    if s["launches"] != p["launches"]:
        fail(f"5h {tag}: launches differ: sync {s['launches']} pipe "
             f"{p['launches']}")
    per_replay = stats["launches_per_replay"]
    short = [k for k in PIPE_KERNELS[tag] if per_replay.get(k, 0) < 1]
    if short:
        fail(f"5h {tag}: the captured step does not launch {short}: "
             f"{per_replay}")
    counts = p["sync_counts"]
    if p["violations"] or counts["put_guarded"] or \
            counts["get_guarded"] != PIPE_ITERS // 4:
        fail(f"5h {tag}: host transfers on the training thread: {counts} "
             f"{p['violations']}")
    idle = {k: (r["profile"] or {}).get("idle_share") for k, r in
            runs.items()}
    rec = {
        "sync_median_step_ms": s["median_ms"],
        "pipe_median_step_ms": p["median_ms"],
        "pipe_median_replay_ms": statistics.median(
            p["step_ms"][PIPELINE_WARMUP_STEPS:]),
        "sync_step_ms": s["step_ms"], "pipe_step_ms": p["step_ms"],
        "sync_idle_share": idle["sync"], "pipe_idle_share": idle["pipe"],
        "sync_busy_ms": (s["profile"] or {}).get("busy_ms"),
        "pipe_busy_ms": (p["profile"] or {}).get("busy_ms"),
        "blocked": stats["blocked"], "capture_ms": stats["capture_ms"][0],
        "pool_bytes": stats["pool_bytes"][0], "replays": stats["replays"],
        "launches": p["launches"], "launches_per_replay": per_replay,
        "sync_counts": counts, "tensors_equal": n,
        "wall_s": {k: r["wall_s"] for k, r in runs.items()},
        "sync_profile": s["profile"], "pipe_profile": p["profile"],
    }
    fmt = lambda v: "not measured" if v is None else f"{100 * v:.1f} %"  # noqa: E731
    log(f"[5h {tag}] streams byte for byte, {n} tensors bit for bit, "
        f"{stats['replays']} replays after {PIPELINE_WARMUP_STEPS} warm-up "
        f"steps; median step ms over steps 2-12 sync {s['median_ms']:.3f} "
        f"pipelined {p['median_ms']:.3f} (replays "
        f"{rec['pipe_median_replay_ms']:.3f}); idle sync "
        f"{fmt(idle['sync'])} pipelined {fmt(idle['pipe'])}; blocked "
        f"{stats['blocked']}; capture {rec['capture_ms']:.1f} ms; graph "
        f"pool {rec['pool_bytes']} bytes; window reads on the training "
        f"thread {counts['get_guarded']}, uploads there "
        f"{counts['put_guarded']}; per replay {json.dumps(per_replay)} "
        f"({card})")
    return rec, final


def check_pipeline_list_files(torch, seed, net_path, card):
    """Phase 5d's list files through both loops (``--native require``,
    googlenet_pallas fp32): the loader's ``__next__`` — its upload from
    pinned memory and its augmentation on the card, drawn from its
    device generator — runs on the staging thread's stream in the
    pipelined loop; the streams and the final state must not move."""
    from npairloss_tpu_torch.train.solver import PIPELINE_WARMUP_STEPS

    argv = ["--net", net_path, "--model", "googlenet_pallas", "--native",
            "require"]
    runs = {loop: _pipe_train(torch, seed, "list", argv, loop == "pipe",
                              synthetic=False)
            for loop in ("sync", "pipe")}
    s, p = runs["sync"], runs["pipe"]
    if s["rc"] or p["rc"]:
        fail(f"5h list files: rc {s['rc']} / {p['rc']}")
    if _masked_lines(s) != _masked_lines(p) or _masked_events(
            s["events"], s["work"]) != _masked_events(p["events"], p["work"]):
        fail("5h list files: the streams differ")
    differ, n = _state_equal(torch, s["solver"], p["solver"])
    if differ:
        fail(f"5h list files: final state differs in {differ[:5]}")
    if p["stats"]["replays"] != PIPE_ITERS - PIPELINE_WARMUP_STEPS:
        fail(f"5h list files: {p['stats']}")
    med = {k: statistics.median(r["step_ms"]) for k, r in runs.items()}
    log(f"[5h list] train --native require on phase 5d's PPM list files: "
        f"streams byte for byte, {n} tensors bit for bit, "
        f"{p['stats']['replays']} replays; median step ms over steps 2-12 "
        f"sync {med['sync']:.3f} pipelined {med['pipe']:.3f} ({card})")
    return {"sync_median_step_ms": med["sync"],
            "pipe_median_step_ms": med["pipe"],
            "sync_step_ms": s["step_ms"], "pipe_step_ms": p["step_ms"],
            "tensors_equal": n, "stats": p["stats"]}


def check_pipeline_refusals(torch, card):
    """No fallback: a step that cannot be captured (a host read inside
    it) raises ``PipelineCaptureError`` after the warm-up steps and never
    runs eagerly in the graph's place; a staging-thread error surfaces
    from the loop as ``PrefetchStageError`` with its batch index.  A
    small mlp on the card; run last, after every other phase."""
    from npairloss_tpu_torch.data.synthetic import synthetic_identity_batches
    from npairloss_tpu_torch.models import get_model
    from npairloss_tpu_torch.pipeline import PrefetchStageError
    from npairloss_tpu_torch.resilience import failpoints
    from npairloss_tpu_torch.train.solver import (
        PIPELINE_WARMUP_STEPS,
        PipelineCaptureError,
        Solver,
        SolverConfig,
    )

    def solver():
        cfg = SolverConfig(base_lr=0.1, lr_policy="fixed", display=0,
                           snapshot=0, test_interval=0, pipeline=True)
        return Solver(get_model("mlp", device="cuda", input_shape=(16,),
                                hidden=(32,), embedding_dim=16, seed=0), cfg=cfg)

    def batches():
        return synthetic_identity_batches(8, 8, 2, (16,), seed=1)

    s = solver()
    orig = s.compute_loss

    def reading(emb, labels):
        loss, metrics = orig(emb, labels)
        loss.item()  # a host read inside the step
        return loss, metrics

    s.compute_loss = reading
    try:
        s.train(batches(), num_iters=6, log_fn=lambda m: None)
        fail("a step with a host read inside it was not refused")
    except PipelineCaptureError as e:
        msg = str(e)
    if "chip_smoke.py" not in msg:
        fail(f"the capture error does not name the failing call: {msg}")
    st = s.pipeline_stats
    if st["eager_steps"] != PIPELINE_WARMUP_STEPS or st["replays"] \
            or s.iteration != PIPELINE_WARMUP_STEPS:
        fail(f"the refused capture ran steps anyway: {st}")
    torch.cuda.synchronize()
    s = solver()
    failpoints.reset()
    failpoints.arm("pipeline.stage", times=1, delay=4)
    try:
        s.train(batches(), num_iters=8, log_fn=lambda m: None)
        fail("a staging error did not surface")
    except PrefetchStageError as e:
        if e.batch_index != 4 or s.iteration != 4:
            fail(f"staging error at batch {e.batch_index}, iteration "
                 f"{s.iteration}")
    finally:
        failpoints.reset()
    torch.cuda.synchronize()
    log(f"[5h refusals] a host read in the step: PipelineCaptureError "
        f"after {PIPELINE_WARMUP_STEPS} warm-up steps, no replay ({msg}); "
        f"pipeline.stage at batch 4: PrefetchStageError(batch_index=4) "
        f"at iteration 4 ({card})")
    return {"capture_error": msg}


class _TrainBatches:
    """The CLI's own TRAIN batches (``_build_data``'s synthetic stream,
    seed 0), the first ``n`` made up front and then cycled: the host's
    generator takes ~0.4 s a batch at 224², longer than a step, so a run
    fed by it measures the generator.  A resumed run takes them from its
    snapshot's index."""

    def __init__(self, n=PIPE_ITERS, ids=60):
        from npairloss_tpu_torch.data.synthetic import (
            synthetic_identity_batches,
        )

        gen = synthetic_identity_batches(4 * ids, ids, 2, (224, 224, 3),
                                         seed=0)
        self._made = [next(gen) for _ in range(n)]

    def __getitem__(self, i):
        return self._made[i % len(self._made)]

    def from_index(self, start=0):
        i = start
        while True:
            yield self[i]
            i += 1


def pipeline_drills(torch, seed, argv, reference, batches, card):
    """The resilience drills on both loops (googlenet_pallas fp32,
    dense): a NaN streak rolled back, a halt, a requested rollback set
    from another thread, SIGTERM mid-window then ``--resume``."""
    import signal
    import threading

    from npairloss_tpu_torch.resilience import RollbackRequest, failpoints
    from npairloss_tpu_torch.train import solver as tsolver
    from npairloss_tpu_torch.resilience.snapshot import (
        QUARANTINE_SUFFIX,
        list_snapshots,
    )

    out = {}

    def both(name, extra, arm):
        res = {}
        for loop in ("sync", "pipe"):
            failpoints.reset()
            failpoints.arm(*arm[0], **arm[1])
            try:
                res[loop] = _pipe_train(torch, seed, f"drill_{name}",
                                        argv + extra, loop == "pipe",
                                        batches=batches.from_index(0),
                                        **NO_TEST)
            finally:
                failpoints.reset()
        return res["sync"], res["pipe"]

    def ev_keys(r):
        return [(e["event"], e["iteration"]) for e in r["events"]]

    # (1) step.nan_loss at steps 7-9, patience 3: rollback to iter 4,
    # the iter-8 snapshot (committed mid-streak) quarantined.
    quarantined = []
    orig_q = tsolver.quarantine_snapshots

    def recording(prefix, min_step):
        moved = orig_q(prefix, min_step)
        quarantined.append([os.path.basename(m) for m in moved])
        return moved

    tsolver.quarantine_snapshots = recording
    try:
        s, p = both("nan", ["--divergence-patience", "3"],
                    arm=(("step.nan_loss",), {"times": 3, "delay": 6}))
    finally:
        tsolver.quarantine_snapshots = orig_q
    want_q = ["snap_iter_8.ckpt" + QUARANTINE_SUFFIX]
    for loop, r, q in (("sync", s, quarantined[:1]),
                       ("pipe", p, quarantined[1:])):
        rb = [e for e in r["events"] if e["event"] == "rollback"]
        snaps = [k for k, _ in list_snapshots(os.path.join(r["work"],
                                                           "snap_"))]
        if r["rc"] != 0 or len(rb) != 1 or rb[0]["iteration"] != 9 \
                or rb[0]["to_iteration"] != 4 or q != [want_q] \
                or snaps != [4, 8, 12]:
            fail(f"5h drill nan {loop}: rc {r['rc']}, rollbacks {rb}, "
                 f"quarantined {q}, snapshots {snaps}")
    cut = [e["event"] for e in s["events"]].index("rollback") + 1
    if ev_keys(s) != ev_keys(p) or _masked_events(
            s["events"][:cut], s["work"]) != _masked_events(
            p["events"][:cut], p["work"]):
        fail(f"5h drill nan: streams differ: {ev_keys(s)} vs {ev_keys(p)}")
    out["nan_rollback"] = ev_keys(s)
    log(f"[5h drill] step.nan_loss x3 at step 7, patience 3: both loops "
        f"rolled back at iter 9 to iter 4, quarantined iter 8; events "
        f"{ev_keys(s)} (the same on both; after the rollback the pipelined "
        "loop trains on later batches: it spent 10-12 before its window "
        "read)")

    # (2) --divergence-action halt: DivergenceError, exit 1.
    s, p = both("halt", ["--divergence-patience", "3",
                         "--divergence-action", "halt"],
                arm=(("step.nan_loss",), {"times": 3, "delay": 6}))
    if s["rc"] != 1 or p["rc"] != 1 or _masked_events(
            s["events"], s["work"]) != _masked_events(p["events"], p["work"]):
        fail(f"5h drill halt: rc {s['rc']}/{p['rc']}, events "
             f"{ev_keys(s)} vs {ev_keys(p)}")
    out["halt"] = ev_keys(s)
    log(f"[5h drill] --divergence-action halt: exit 1 on both loops, "
        f"events {ev_keys(s)}")

    # (3) a RollbackRequest set from another thread when batch 8 is
    # pulled (by the staging thread, in the pipelined loop): taken at
    # iter 8 by both loops (display 0: the window closes at the
    # snapshot cadence, 4).
    class Requesting:
        def __init__(self):
            self.i = 0
            self.solver = None

        def __iter__(self):
            return self

        def __next__(self):
            self.i += 1
            if self.i == 8:
                t = threading.Thread(
                    target=self.solver.request_rollback,
                    args=(RollbackRequest(reason="drill",
                                          before_wall_time=time.time()),))
                t.start()
                t.join()
            return batches[self.i - 1]

    res = {}
    for loop in ("sync", "pipe"):
        failpoints.reset()
        req = Requesting()

        def remember(solver, loop, n, req=req):
            req.solver = solver

        res[loop] = _pipe_train(torch, seed, "drill_request", argv,
                                loop == "pipe", batches=req,
                                hook=remember, display=0, **NO_TEST)
    s, p = res["sync"], res["pipe"]
    for loop, r in res.items():
        rb = [e for e in r["events"] if e["event"] == "rollback"]
        if r["rc"] != 0 or len(rb) != 1 or not rb[0].get("requested") \
                or rb[0]["iteration"] != 8 or rb[0]["to_iteration"] != 4:
            fail(f"5h drill request {loop}: rc {r['rc']}, rollbacks {rb}")
    if _masked_events(s["events"], s["work"]) != _masked_events(
            p["events"], p["work"]) or _masked_lines(s) != _masked_lines(p):
        fail(f"5h drill request: streams differ: {ev_keys(s)} vs "
             f"{ev_keys(p)}")
    differ, _ = _state_equal(torch, s["solver"], p["solver"])
    if differ:
        fail(f"5h drill request: final state differs in {differ[:5]}")
    out["requested_rollback"] = ev_keys(s)
    log("[5h drill] RollbackRequest from another thread at batch 8: taken "
        "at iter 8 on both loops, rolled back to iter 4; streams byte for "
        "byte, final state bit for bit")

    # (4) SIGTERM before step 6 (mid-window): the partial window flushed,
    # the emergency snapshot, exit 75; --resume auto from there equals
    # the uninterrupted run bit for bit.
    def sigterm(solver, loop, n):
        if n == 6:
            os.kill(os.getpid(), signal.SIGTERM)

    res = {}
    for loop in ("sync", "pipe"):
        r = _pipe_train(torch, seed, "drill_sigterm", argv, loop == "pipe",
                        batches=batches.from_index(0), hook=sigterm,
                        **NO_TEST)
        last = json.loads(r["lines"][-1]) if r["lines"] else {}
        solver = r["solver"]
        if r["rc"] != 75 or not last.get("preempted") \
                or last.get("iteration") != 6 or solver.iteration != 6 \
                or len(solver._loss_window) != 6:
            fail(f"5h drill sigterm {loop}: rc {r['rc']}, {last}, loss "
                 f"window {len(solver._loss_window)}")
        snaps = [k for k, _ in list_snapshots(os.path.join(r["work"],
                                                           "snap_"))]
        if snaps != [4, 6]:
            fail(f"5h drill sigterm {loop}: snapshots {snaps}")
        resumed = _pipe_train(torch, seed, "drill_sigterm_resume",
                              argv + ["--resume", os.path.join(
                                  r["work"], "snap_iter_6.ckpt")],
                              loop == "pipe", batches=batches.from_index(6),
                              **NO_TEST)
        if resumed["rc"] != 0 or resumed["solver"].iteration != PIPE_ITERS:
            fail(f"5h drill sigterm {loop}: resume rc {resumed['rc']}")
        differ, n = _state_equal(torch, resumed["solver"], reference)
        if differ:
            fail(f"5h drill sigterm {loop}: resumed state differs from the "
                 f"uninterrupted run in {differ[:5]}")
        res[loop] = r
    if _masked_events(res["sync"]["events"], res["sync"]["work"]) != \
            _masked_events(res["pipe"]["events"], res["pipe"]["work"]):
        fail("5h drill sigterm: streams differ")
    out["sigterm"] = ev_keys(res["sync"])
    log(f"[5h drill] SIGTERM before step 6: both loops flushed steps 5-6, "
        f"committed iter 6, exit 75; --resume from it equals the "
        f"uninterrupted run bit for bit ({n} tensors) ({card})")
    return out



def drive_pipeline(torch, seed, detail, list_net):
    """Phase 5h: ``train --pipeline`` against the synchronous loop in four
    configurations at batch 120, 224², then the resilience drills on both
    loops.  cuDNN deterministic for the bitwise comparisons."""
    card = detail["card"]
    t_start = time.perf_counter()
    os.makedirs(PIPE_WORK, exist_ok=True)
    nets = {"cub": "examples/googlenet_cub.prototxt",
            "relhard": blockwise_net(PIPE_WORK)}
    # Whether a wait on a CUDA event counts as a host sync for PyTorch's
    # sync debug mode (the dispatch controller's wait is one).
    ev = torch.cuda.Event()
    ev.record()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ev.synchronize()
        event_trips = False
    except RuntimeError:
        event_trips = True
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log(f"[5h] a CUDA event's synchronize under sync debug mode 'error' "
        f"{'raises' if event_trips else 'passes'} (the controller's wait "
        "stays outside the guarded dispatch either way)")
    cudnn = torch.backends.cudnn
    det, bench = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    configs = {}
    reference = None
    t0 = time.perf_counter()
    batches = _TrainBatches()
    log(f"[5h] {PIPE_ITERS} synthetic batches made in "
        f"{time.perf_counter() - t0:.1f} s")
    try:
        for tag, argv, net in PIPE_RUNS:
            rec, final = check_pipeline_config(
                torch, seed, tag, ["--net", nets[net], *argv], batches, card)
            configs[tag] = rec
            if tag == "pallas_fp32":
                reference = final
            del final
            _release(torch)
        argv = dict((t, a) for t, a, _ in PIPE_RUNS)["pallas_fp32"]
        drills = pipeline_drills(torch, seed, ["--net", nets["cub"], *argv],
                                 reference, batches, card)
        list_files = check_pipeline_list_files(torch, seed, list_net, card)
    finally:
        cudnn.deterministic, cudnn.benchmark = det, bench
    del reference
    _release(torch)
    wall = time.perf_counter() - t_start
    log(f"[5h] {wall:.1f} s")
    detail["pipeline"] = {"configs": configs, "drills": drills,
                          "list_files": list_files,
                          "event_sync_trips_debug_mode": event_trips,
                          "wall_s": wall}
    return configs


# -- phase 5j: run telemetry and the perf observatory --------------------------

TEL_WORK = os.path.join("build", "tel_smoke")
# (tag, train argv after the solver, net): googlenet_bn under mxu, dense
# on the CUB net's mining, blockwise (bf16 mode) on the reference's.
TEL_RUNS = (
    ("bn_mxu", ["--model", "googlenet_bn", "--precision", "mxu"], "cub"),
    ("bn_mxu_blockwise", ["--model", "googlenet_bn", "--precision", "mxu",
                          "--engine", "blockwise"], "relhard"),
)
TEL_FLAGS = ["--health-metrics", "--mining-health", "--perf-metrics"]
# The health keys every train row carries, per engine (pair hardness
# needs the dense engine's pair matrix, as in JAX).
HEALTH_KEYS = ("grad_norm", "param_norm", "update_norm", "update_ratio",
               "emb_mag_mean", "emb_mag_max")
PAIR_KEYS = ("mined_pos_per_query", "mined_neg_per_query",
             "ap_threshold_mean", "an_threshold_mean", "ap_an_margin_mean",
             "ap_an_margin_p10", "an_saturation")


def _tel_rows(run_dir):
    rows = [json.loads(ln) for ln in open(os.path.join(run_dir,
                                                       "metrics.jsonl"))]
    return rows


def _cpu_step_flops(torch, seed, argv, batches):
    """The count of the same configuration's first step on the CPU
    (``Solver._counted`` around the step body, as the card's loop
    counts it)."""
    from npairloss_tpu_torch import cli

    args = cli.build_parser().parse_args(
        ["train", "--solver", cut_solver(os.path.join(TEL_WORK, "cpu")),
         *argv, "--device", "cpu", "--synthetic", "--seed", str(seed)])
    built = cli._build_solver(args)
    if isinstance(built, int):
        fail(f"5j: the CPU solver was refused ({built})")
    solver = built[0]
    x, lab = solver._put(*batches[0])
    solver._counted(solver._train_body, x, lab, solver.rate_fn(0))
    flops = solver._step_flops
    del solver, built
    return flops


def check_telemetry_config(torch, seed, tag, argv, batches, card):
    """5j (a) and (b) for one configuration; returns its record."""
    from npairloss_tpu_torch.obs import REQUIRED_KEYS, validate_chrome_trace
    from npairloss_tpu_torch.obs.perf.decompose import decompose_step_time
    from npairloss_tpu_torch.train.solver import PIPELINE_WARMUP_STEPS

    runs = {}
    for loop in ("sync", "pipe"):
        tel = os.path.join(PIPE_WORK, f"{tag}_{loop}", "tel")
        r = _pipe_train(torch, seed, tag, argv + ["--telemetry-dir", tel,
                                                  *TEL_FLAGS],
                        loop == "pipe", batches=batches.from_index(0),
                        snapshot=0, **NO_TEST)
        if r["rc"] != 0:
            fail(f"5j {tag} {loop}: train returned {r['rc']}: "
                 f"{r['lines'][-5:]}")
        if r["solver"]._telemetry_failed:
            fail(f"5j {tag} {loop}: telemetry failed (latched)")
        man = json.load(open(os.path.join(tel, "manifest.json")))
        if man["config"]["health_metrics"] is not True:
            fail(f"5j {tag} {loop}: manifest {man['config']}")
        rows = _tel_rows(tel)
        bad = [r_ for r_ in rows if any(k not in r_ for k in REQUIRED_KEYS)]
        if bad:
            fail(f"5j {tag} {loop}: rows without the envelope: {bad[:1]}")
        trace = json.load(open(os.path.join(tel, "trace.json")))
        err = validate_chrome_trace(trace)
        if err:
            fail(f"5j {tag} {loop}: trace.json: {err}")
        r.update(rows=rows, trace=trace, tel=tel)
        runs[loop] = r
    want = HEALTH_KEYS + (PAIR_KEYS if "blockwise" not in tag else ())
    cpu_flops = _cpu_step_flops(torch, seed, argv, batches)
    out = {"cpu_step_flops": cpu_flops}
    for loop, r in runs.items():
        train = [x for x in r["rows"] if x["phase"] == "train"]
        if len(train) != PIPE_ITERS:
            fail(f"5j {tag} {loop}: {len(train)} train rows")
        for row in train:
            missing = [k for k in want if k not in row]
            nonfinite = [k for k, v in row.items() if isinstance(v, float)
                         and not math.isfinite(v)]
            if missing or nonfinite:
                fail(f"5j {tag} {loop} step {row['step']}: missing "
                     f"{missing}, non-finite {nonfinite}")
        perf = [x for x in r["rows"] if x["phase"] == "perf"]
        if [x["step"] for x in perf] != [8, 12]:
            fail(f"5j {tag} {loop}: perf rows at {[x['step'] for x in perf]}")
        for row in perf:
            if row.get("step_flops") != cpu_flops:
                fail(f"5j {tag} {loop}: step_flops {row.get('step_flops')} "
                     f"!= the CPU's count {cpu_flops}")
            if not 0.0 < row.get("mfu", -1.0) < 1.0:
                fail(f"5j {tag} {loop}: mfu {row.get('mfu')}")
        events = [e for e in r["trace"]["traceEvents"] if e.get("ph") == "X"]
        t0 = min(e["ts"] for e in events)
        wall = (max(e["ts"] + e["dur"] for e in events) - t0) / 1e3
        dec = decompose_step_time(events, wall)
        gap = sum(dec["parts"].values()) + dec["unattributed_ms"] \
            - dec["wall_ms"]
        if abs(gap) > 1e-6:
            fail(f"5j {tag} {loop}: decomposition off by {gap} ms")
        spans = sorted({e["name"] for e in events})
        windows = [(x["step"], x["ms_per_step"], x.get("mfu"))
                   for x in perf]
        log(f"[5j {tag} {loop}] {len(train)} train rows with {len(want)} "
            f"health keys, finite; perf rows (step, ms_per_step, mfu) "
            f"{windows}; step_flops {perf[0]['step_flops']:.6e} = CPU count; "
            f"decomposition of {dec['wall_ms']:.3f} ms: "
            f"{json.dumps(dec['parts'])}, unattributed "
            f"{dec['unattributed_ms']:.3f}; spans {spans} ({card})")
        out[loop] = {"perf": perf, "decomposition": dec, "spans": spans,
                     "step_ms": r["step_ms"]}
    s, p = runs["sync"], runs["pipe"]

    def plain(rows):
        return [json.dumps({k: v for k, v in x.items()
                            if k not in ("wall_time", "run_id")},
                           sort_keys=True)
                for x in rows if x["phase"] != "perf"]

    if plain(s["rows"]) != plain(p["rows"]):
        diff = [(a, b) for a, b in zip(plain(s["rows"]), plain(p["rows"]))
                if a != b]
        fail(f"5j {tag}: sync and pipelined rows differ: {diff[:2]}")
    if _masked_events(s["events"], s["work"]) != \
            _masked_events(p["events"], p["work"]):
        fail(f"5j {tag}: --log-json streams differ")
    stats, counts = p["stats"], p["sync_counts"]
    if stats["replays"] != PIPE_ITERS - PIPELINE_WARMUP_STEPS \
            or stats["captures"] != 1:
        fail(f"5j {tag}: {stats}")
    if p["violations"] or counts["put_guarded"] or \
            counts["get_guarded"] != PIPE_ITERS // 4:
        fail(f"5j {tag}: host transfers on the training thread: {counts} "
             f"{p['violations']}")
    per_replay = stats.get("launches_per_replay", {})
    short = [k for k in PIPE_KERNELS[tag] if per_replay.get(k, 0) < 1]
    if short:
        fail(f"5j {tag}: the captured step does not launch {short}")
    log(f"[5j {tag}] sync and pipelined rows byte for byte "
        f"({len(plain(s['rows']))} rows, health included); strict monitor "
        f"clean ({counts}); per replay {json.dumps(per_replay)}")
    out["launches_per_replay"] = per_replay
    return out


def telemetry_overhead(torch, seed, argv, batches, card):
    """5j (c): the dense configuration with and without telemetry and
    health, synchronous then pipelined, in turns; median step ms over
    steps 2-6."""
    out = {}
    for loop in ("sync", "pipe"):
        for on in (False, True, False, True):
            extra = (["--telemetry-dir",
                      os.path.join(TEL_WORK, f"ovh_{loop}_{len(out)}"),
                      *TEL_FLAGS] if on else [])
            r = _pipe_train(torch, seed, "overhead", argv + extra,
                            loop == "pipe", batches=batches.from_index(0),
                            max_iter=6, snapshot=0, **NO_TEST)
            if r["rc"] != 0:
                fail(f"5j overhead {loop}: train returned {r['rc']}")
            ms = statistics.median(r["step_ms"][:5])
            out.setdefault(f"{loop}_{'on' if on else 'off'}", []).append(ms)
    log(f"[5j overhead] median step ms over steps 2-6, in turns (off, on, "
        f"off, on): sync off {out['sync_off']} on {out['sync_on']}, "
        f"pipelined off {out['pipe_off']} on {out['pipe_on']} ({card})")
    return out


def check_prof_and_time(torch, card):
    """5j (d): ``prof --step train`` and ``time`` at batch 120."""
    from npairloss_tpu_torch import cli
    from npairloss_tpu_torch.obs.perf.report import validate_report

    out_dir = os.path.join(TEL_WORK, "prof")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["prof", "--step", "train", "--model", "googlenet_bn",
                       "--precision", "mxu", "--batch", "120", "--steps",
                       "4", "--out", out_dir])
    if rc != 0:
        fail(f"5j prof: rc {rc}: {buf.getvalue()[-500:]}")
    report = json.load(open(os.path.join(out_dir, "perf_report.json")))
    err = validate_report(report)
    if err:
        fail(f"5j prof: {err}")
    if not report["peaks"]["known"]:
        fail(f"5j prof: no peaks for {report['device_kind']!r}")
    tot = report["totals"]
    top = [(r["region"], f"{r['flops']:.3e}", f"{r['bytes']:.3e}",
            r["bound"], r["pct_flops"]) for r in report["regions"][:8]]
    # The ops that move the bytes, and their time at the HBM roofline.
    ops = [(o["op"], o["calls"], f"{o['bytes']:.3e}",
            round(o["bytes"] / HBM_BYTES_PER_S * 1e3, 3))
           for o in tot["ops"][:10]]
    log(f"[5j prof] {report['timing']}; totals flops "
        f"{tot['flops_counted']:.6e} bytes {tot['bytes_counted']:.6e} "
        f"({tot['bytes_counted'] / HBM_BYTES_PER_S * 1e3:.3f} ms at the "
        f"HBM peak); decomposition {json.dumps(report['decomposition'])}; "
        f"top regions (region, flops, bytes, bound, %flops) {top}; top ops "
        f"by bytes (op, calls, bytes, ms at the HBM peak) {ops} ({card})")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["time", "--net", "examples/googlenet_cub.prototxt",
                       "--model", "googlenet_bn", "--precision", "mxu",
                       "--batch", "120", "--iterations", "5"])
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    if rc != 0 or not rec.get("step_flops") or \
            not 0.0 < rec.get("mfu", -1.0) < 1.0:
        fail(f"5j time: rc {rc}, {rec}")
    log(f"[5j time] {json.dumps(rec)} ({card})")
    return {"prof": {"timing": report["timing"],
                     "regions": report["regions"], "totals": tot,
                     "decomposition": report["decomposition"]},
            "time": rec}


def drive_telemetry(torch, seed, detail):
    """Phase 5j (see the module docstring)."""
    card = detail["card"]
    t_start = time.perf_counter()
    os.makedirs(TEL_WORK, exist_ok=True)
    nets = {"cub": "examples/googlenet_cub.prototxt",
            "relhard": blockwise_net(TEL_WORK)}
    cudnn = torch.backends.cudnn
    det, bench = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    batches = _TrainBatches(n=4)
    out = {}
    try:
        for tag, argv, net in TEL_RUNS:
            out[tag] = check_telemetry_config(
                torch, seed, tag, ["--net", nets[net], *argv], batches, card)
            _release(torch)
        out["overhead"] = telemetry_overhead(
            torch, seed, ["--net", nets["cub"], *TEL_RUNS[0][1]], batches,
            card)
        _release(torch)
        out.update(check_prof_and_time(torch, card))
    finally:
        cudnn.deterministic, cudnn.benchmark = det, bench
    _release(torch)
    out["wall_s"] = time.perf_counter() - t_start
    log(f"[5j] {out['wall_s']:.1f} s")
    detail["telemetry"] = out


# -- phase 5i: distribution ----------------------------------------------------

DIST_WORK = os.path.join("build", "dist_smoke")
DIST_STEPS = 4
DIST_TOL = {
    # G = 1: both engines form the sims with one N x N product and pick
    # the same thresholds; the ring adds its one block to zeros.  Loss
    # relative, parameters against the parameter vector's norm after 6
    # steps (cuDNN deterministic: the same trunk in both runs).
    "g1_loss_rel": 1e-5,
    "g1_param_rel": 1e-4,
    # G = 2: the ring sums its two blocks in hop order where dense sums
    # the gathered row at once; 4 steps of the bf16 trunk on top.
    "g2_loss_rel": 1e-4,
    "g2_param_rel": 1e-3,
    # The synced BatchNorm forward (fp32_parity, unit embeddings) at G = 2
    # against G = 1 on the whole batch.  Sound, the per-rank sums are only
    # added in another order (3.96e-6 on the H100); with each rank's
    # statistics over its own 60 rows (the fault this catches) the same
    # reading must come out above the limit, and the phase checks that.
    "bn_forward_abs": 1e-4,
}
# The collectives of torch.distributed that the port's mesh calls; 5i (a)
# counts them while the NCCL group of world size 1 runs each path.
_COLLECTIVES = ("all_gather_into_tensor", "all_reduce", "barrier",
                "batch_isend_irecv")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _param_rel(torch, a, b) -> float:
    """||a - b|| / ||b|| over every parameter (host tensors)."""
    num = sum(float(((a[k].double() - b[k].double()) ** 2).sum())
              for k in b)
    den = sum(float((b[k].double() ** 2).sum()) for k in b)
    return (num / max(den, 1e-300)) ** 0.5


def _ring_pass_ms(torch, solver, batch, steps=3):
    """Median ms of each ring pass over ``steps`` extra steps (synchronized
    around each pass, so these steps are not timed as steps)."""
    from npairloss_tpu_torch.parallel import ring

    names = ("_stats_pass", "_ring_thresholds", "_loss_pass",
             "_backward_pass")
    orig = {n: getattr(ring, n) for n in names}
    times = {n: [] for n in names}

    def timed(name):
        def fn(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig[name](*a, **k)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return fn

    try:
        for n in names:
            setattr(ring, n, timed(n))
        for _ in range(steps):
            solver.step(*batch)
    finally:
        for n in names:
            setattr(ring, n, orig[n])
    return {n.strip("_"): statistics.median(v) for n, v in times.items()}


@contextlib.contextmanager
def _counting_collectives(counts):
    """Count each call of ``_COLLECTIVES`` made inside."""
    import torch.distributed as dist

    orig = {n: getattr(dist, n) for n in _COLLECTIVES}

    def counted(name):
        def fn(*a, **k):
            counts[name] = counts.get(name, 0) + 1
            return orig[name](*a, **k)
        return fn

    try:
        for n in _COLLECTIVES:
            setattr(dist, n, counted(n))
        yield counts
    finally:
        for n, f in orig.items():
            setattr(dist, n, f)


def check_dist_nccl_paths(torch, seed, solver_path, card):
    """5i (a), inside the NCCL group of world size 1: the mesh's
    collectives held against the identity, then 2 steps of the dense
    engine through ``Solver(mesh=build_mesh())`` (its gather and the
    database-role all-reduce) and of the ring under the reference's
    shipped mining (its overflow vote, an all-reduce max), each against
    the dense engine without a mesh; the NCCL calls of each run counted.
    At one rank ``Mesh.shift`` makes no hop, so ``batch_isend_irecv``
    does not run here."""
    from npairloss_tpu_torch.ops.npair_loss import REFERENCE_CONFIG
    from npairloss_tpu_torch.parallel import build_mesh

    mesh = build_mesh()
    if mesh.backend != "nccl" or mesh.size != 1:
        fail(f"5i: expected a one-rank NCCL mesh, got {mesh}")
    gen = torch.Generator(device=mesh.device).manual_seed(seed)
    x = torch.randn(120, 1024, device=mesh.device, generator=gen)
    direct: dict = {}
    with _counting_collectives(direct):
        identity = {
            "all_gather": torch.equal(mesh.all_gather(x), x),
            "all_reduce_sum": torch.equal(mesh.all_reduce_sum(x), x),
            "all_reduce_max": torch.equal(mesh.all_reduce_max(x), x),
            "agree": mesh.agree(True) and not mesh.agree(False),
        }
        mesh.barrier()
    torch.cuda.synchronize()
    if not all(identity.values()) or any(
            direct.get(n, 0) < 1 for n in _COLLECTIVES[:3]):
        fail(f"5i: the NCCL collectives at one rank: {identity} {direct}")
    batches = _dist_batches(seed, 2)
    runs = {}
    for tag, engine, m in (("dense_no_mesh", "dense", None),
                           ("dense_mesh", "dense", mesh),
                           ("ring_mesh", "ring", mesh)):
        solver = _dist_solver(torch, seed, "mxu", engine, m, solver_path,
                              loss=REFERENCE_CONFIG)
        calls: dict = {}
        losses = []
        with _counting_collectives(calls):
            for xb, lab in batches:
                losses.append(float(solver.step(xb, lab)["loss"]))
        torch.cuda.synchronize()
        runs[tag] = {"losses": losses, "nccl_calls": calls,
                     "params": {n: p.detach().float().cpu().clone()
                                for n, p in solver.params.items()}}
        del solver
        _release(torch)
    ref = runs["dense_no_mesh"]
    steps = len(batches)
    want = {"dense_mesh": {"all_gather_into_tensor": 2 * steps,
                           "all_reduce": steps},
            "ring_mesh": {"all_reduce": steps}}
    rec = {"backend": mesh.backend, "identity": identity,
           "direct_nccl_calls": direct}
    for tag, need in want.items():
        r = runs[tag]
        loss_rel = max(abs(a - b) / max(abs(b), 1e-30)
                       for a, b in zip(r["losses"], ref["losses"]))
        prel = _param_rel(torch, r["params"], ref["params"])
        rec[tag] = {"loss_rel": loss_rel, "param_rel": prel,
                    "params_bit_equal": all(
                        torch.equal(r["params"][k], ref["params"][k])
                        for k in ref["params"]),
                    "nccl_calls": r["nccl_calls"]}
        short = {n: c for n, c in need.items()
                 if r["nccl_calls"].get(n, 0) < c}
        if short or loss_rel > DIST_TOL["g1_loss_rel"] \
                or prel > DIST_TOL["g1_param_rel"]:
            fail(f"5i: {tag} at one NCCL rank vs dense without a mesh "
                 f"(NCCL calls short of {short}): {rec[tag]}")
    log(f"[5i nccl] one-rank NCCL group: all_gather, all_reduce sum/max, "
        f"agree and barrier equal the identity ({direct}); {steps} steps "
        f"under the reference's mining vs dense without a mesh: dense "
        f"through the mesh loss rel {rec['dense_mesh']['loss_rel']:.3g}, "
        f"parameters rel {rec['dense_mesh']['param_rel']:.3g} (bit for "
        f"bit: {rec['dense_mesh']['params_bit_equal']}), NCCL calls "
        f"{rec['dense_mesh']['nccl_calls']}; ring loss rel "
        f"{rec['ring_mesh']['loss_rel']:.3g}, parameters rel "
        f"{rec['ring_mesh']['param_rel']:.3g}, NCCL calls "
        f"{rec['ring_mesh']['nccl_calls']} (tol {DIST_TOL['g1_loss_rel']} / "
        f"{DIST_TOL['g1_param_rel']}; no ring hop at one rank) ({card})")
    return rec


def check_dist_one_rank(torch, seed, detail):
    """5i (a): ``train --mesh 1 --engine ring`` and ``--engine dense`` on
    googlenet_bn mxu at batch 120, 224², 6 steps of the CLI's synthetic
    stream, in one NCCL process group of world size 1; then
    :func:`check_dist_nccl_paths` in the same group."""
    from npairloss_tpu_torch.parallel import (
        initialize_distributed,
        shutdown_distributed,
    )

    card = detail["card"]
    os.makedirs(DIST_WORK, exist_ok=True)
    cudnn = torch.backends.cudnn
    det, bench = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    initialize_distributed(f"localhost:{_free_port()}", 1, 0)
    import torch.distributed as dist

    backend = dist.get_backend()
    runs, params, ring_passes = {}, {}, None
    try:
        for engine in ("ring", "dense"):
            solver, events, _, ms = _bn_train_run(
                torch, seed, f"5i-{engine}",
                ["--precision", "mxu", "--mesh", "1", "--engine", engine],
                "examples/googlenet_cub.prototxt", DIST_WORK)
            if engine == "ring" and (solver.mesh is None
                                     or solver.mesh.backend != "nccl"):
                fail(f"the ring ran without the NCCL mesh: {solver.mesh}")
            rows = [e for e in events if e["event"] == "display"]
            runs[engine] = {"rows": rows, "step_ms": ms,
                            "median_step_ms": statistics.median(ms[1:])}
            params[engine] = {n: p.detach().float().cpu().clone()
                              for n, p in solver.params.items()}
            if engine == "ring":
                from npairloss_tpu_torch.data.synthetic import (
                    synthetic_identity_batches,
                )

                x, lab = next(synthetic_identity_batches(
                    240, 60, 2, (224, 224, 3), seed=seed + 7))
                ring_passes = _ring_pass_ms(torch, solver, (x, lab))
            del solver
            _release(torch)
        nccl = check_dist_nccl_paths(
            torch, seed,
            os.path.abspath(cut_solver(DIST_WORK, "solver_g1.prototxt")),
            card)
    finally:
        cudnn.deterministic, cudnn.benchmark = det, bench
        shutdown_distributed()
    loss_rel = max(abs(r["loss"] - d["loss"]) / max(abs(d["loss"]), 1e-30)
                   for r, d in zip(runs["ring"]["rows"],
                                   runs["dense"]["rows"]))
    discrete = [k for k in ("retrieve_top1", "retrieve_top5",
                            "retrieve_top10")
                if any(r[k] != d[k] for r, d in zip(runs["ring"]["rows"],
                                                    runs["dense"]["rows"]))]
    prel = _param_rel(torch, params["ring"], params["dense"])
    same_bits = all(torch.equal(params["ring"][k], params["dense"][k])
                    for k in params["dense"])
    rec = {"backend": backend, "loss_rel": loss_rel,
           "metrics_differ": discrete, "param_rel": prel,
           "params_bit_equal": same_bits,
           "ring_median_step_ms": runs["ring"]["median_step_ms"],
           "dense_median_step_ms": runs["dense"]["median_step_ms"],
           "ring_step_ms": runs["ring"]["step_ms"],
           "dense_step_ms": runs["dense"]["step_ms"],
           "ring_pass_ms": ring_passes, "nccl_paths": nccl}
    log(f"[5i g1] backend {backend}, world size 1: ring vs dense over 6 "
        f"steps, loss max rel {loss_rel:.3g} (tol {DIST_TOL['g1_loss_rel']}),"
        f" discrete metrics differ: {discrete or 'none'}, parameters rel "
        f"{prel:.3g} (tol {DIST_TOL['g1_param_rel']}, bit for bit: "
        f"{same_bits}); median step ms over steps 2-6: ring "
        f"{rec['ring_median_step_ms']:.3f}, dense "
        f"{rec['dense_median_step_ms']:.3f}; the ring's passes (ms, "
        f"synchronized): {json.dumps({k: round(v, 3) for k, v in ring_passes.items()})} ({card})")
    if loss_rel > DIST_TOL["g1_loss_rel"] or discrete \
            or prel > DIST_TOL["g1_param_rel"]:
        fail(f"5i: ring and dense disagree at G = 1: {rec}")
    return rec


def _dist_solver(torch, seed, policy, engine, mesh, solver_path,
                 loss=None):
    """A googlenet_bn Solver of the CUB net (its loss, or ``loss``) on
    ``mesh`` (None: no mesh, on the card)."""
    from npairloss_tpu_torch.config.schema import load_net, load_solver
    from npairloss_tpu_torch.models import get_model
    from npairloss_tpu_torch.train.solver import Solver

    solver_cfg, _ = load_solver(solver_path)
    net_cfg = load_net("examples/googlenet_cub.prototxt")
    model = get_model("googlenet_bn",
                      device=mesh.device if mesh is not None else "cuda:0",
                      seed=seed, policy=policy)
    return Solver(model, loss or net_cfg.loss.loss, solver_cfg,
                  param_mults=net_cfg.param_mults, precision=policy,
                  engine=engine, mesh=mesh)


def _dist_batches(seed, n):
    from npairloss_tpu_torch.data.synthetic import synthetic_identity_batches

    gen = synthetic_identity_batches(240, 60, 2, (224, 224, 3), seed=seed)
    return [next(gen) for _ in range(n)]


def _dist_rank_train(mesh, seed, engine, solver_path):
    """Rank task of 5i (b): ``DIST_STEPS`` steps of googlenet_bn mxu on
    this rank's 60 rows of each 120-row global batch; per step the
    metrics, a digest of every parameter's bytes and the step ms; the
    final parameters (rank 0)."""
    import hashlib

    import torch

    from npairloss_tpu_torch.parallel import shard_batch

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    solver = _dist_solver(torch, seed, "mxu", engine, mesh, solver_path)
    rows, digests, ms = [], [], []
    for x, lab in _dist_batches(seed, DIST_STEPS):
        xs, ls = shard_batch(mesh, (x, lab))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = solver.step(xs, ls)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        rows.append({k: float(v) for k, v in m.items()})
        h = hashlib.sha256()
        for p in solver.params.values():
            h.update(p.detach().cpu().numpy().tobytes())
        digests.append(h.hexdigest())
    final = ({n: p.detach().float().cpu().numpy()
              for n, p in solver.params.items()} if mesh.rank == 0 else None)
    return rows, digests, ms, final


def _dist_rank_bn_forward(mesh, seed):
    """Rank task: the BatchNorm forward of googlenet_bn under fp32_parity,
    train mode, on this rank's rows of the first global batch, synced
    (with the synced running statistics' digest) and, to show what the
    check would see of that fault, with each rank's own statistics."""
    import hashlib

    import torch

    from npairloss_tpu_torch.models import get_model
    from npairloss_tpu_torch.models.layers import sync_batch_norm
    from npairloss_tpu_torch.parallel import shard_batch

    torch.backends.cudnn.deterministic = True
    x, lab = _dist_batches(seed, 1)[0]
    xs, _ = shard_batch(mesh, (x, lab))
    out = []
    for over in (mesh, None):
        model = get_model("googlenet_bn", device=mesh.device, seed=seed,
                          policy="fp32_parity").train()
        sync_batch_norm(model, over)
        with torch.no_grad():
            out.append(model(xs).float().cpu().numpy())
        if over is not None:
            h = hashlib.sha256()
            for b in model.buffers():
                h.update(b.cpu().numpy().tobytes())
        del model
    return out[0], h.hexdigest(), out[1]


def _dist_rank_nccl_probe(mesh):
    import torch

    t = torch.ones(4, device=mesh.device)
    return float(mesh.all_reduce_sum(t).sum())


def _nccl_two_ranks_probe(card):
    """What NCCL says when asked for two ranks on one card: its error,
    printed (the phase then runs over gloo by declaration)."""
    from npairloss_tpu_torch.parallel.launch import RankPool

    path = os.path.abspath(os.path.join(DIST_WORK, "pg_nccl_probe"))
    if os.path.exists(path):
        os.remove(path)
    t0 = time.perf_counter()
    try:
        with RankPool(2, f"file://{path}", device="cuda:0", backend="nccl",
                      threads=0, timeout_s=90) as pool:
            out = pool.run(_dist_rank_nccl_probe)
        said = f"no error: all_reduce gave {out}"
    except (RuntimeError, TimeoutError) as e:
        lines = [ln.strip() for ln in str(e).splitlines() if ln.strip()]
        keep = [ln for ln in lines if "NCCL" in ln or "nccl" in ln
                or "Error" in ln]
        said = " | ".join((keep or lines)[-4:])[:600]
    log(f"[5i nccl probe] two ranks on cuda:0 over NCCL: {said} "
        f"({time.perf_counter() - t0:.1f} s; {card})")
    return said


def check_dist_two_ranks(torch, seed, detail):
    """5i (b): two spawned ranks on cuda:0, global batch 120 (60 a rank),
    googlenet_bn mxu, dense and ring, ``DIST_STEPS`` steps, over gloo
    through host memory; and the synced BatchNorm forward at G = 2
    against G = 1 on the whole batch."""
    from npairloss_tpu_torch.models import get_model
    from npairloss_tpu_torch.parallel.launch import RankPool

    card = detail["card"]
    os.makedirs(DIST_WORK, exist_ok=True)
    probe = _nccl_two_ranks_probe(card)
    solver_path = os.path.abspath(cut_solver(DIST_WORK, "solver_g2.prototxt"))
    path = os.path.abspath(os.path.join(DIST_WORK, "pg_gloo"))
    if os.path.exists(path):
        os.remove(path)
    _release(torch)
    t0 = time.perf_counter()
    out = {}
    with RankPool(2, f"file://{path}", device="cuda:0", backend="gloo",
                  threads=0, timeout_s=300) as pool:
        spawn_s = time.perf_counter() - t0
        for engine in ("dense", "ring"):
            out[engine] = pool.run(_dist_rank_train, seed, engine,
                                   solver_path)
        bn = pool.run(_dist_rank_bn_forward, seed)
        # Phase 8 (c)'s run: the same ranks under fleet telemetry (its
        # report and timeline are read in phase 8).
        detail["fleet_run"] = fleet_ranks(pool, seed, solver_path)
    for engine, ranks in out.items():
        for step in range(DIST_STEPS):
            if ranks[0][1][step] != ranks[1][1][step]:
                fail(f"5i: {engine} ranks' parameters differ after step "
                     f"{step + 1}")
            if ranks[0][0][step] != ranks[1][0][step]:
                fail(f"5i: {engine} ranks report different metrics")
    d_rows, r_rows = out["dense"][0][0], out["ring"][0][0]
    loss_rel = max(abs(r["loss"] - d["loss"]) / max(abs(d["loss"]), 1e-30)
                   for r, d in zip(r_rows, d_rows))
    final = {k: torch.from_numpy(v) for k, v in out["ring"][0][3].items()}
    ref = {k: torch.from_numpy(v) for k, v in out["dense"][0][3].items()}
    prel = _param_rel(torch, final, ref)
    import numpy as np

    emb2 = np.concatenate([bn[0][0], bn[1][0]])
    emb2_unsynced = np.concatenate([bn[0][2], bn[1][2]])
    if bn[0][1] != bn[1][1]:
        fail("5i: the ranks' running statistics differ after the synced "
             "forward")
    cudnn = torch.backends.cudnn
    det = cudnn.deterministic
    cudnn.deterministic = True
    try:
        model = get_model("googlenet_bn", device="cuda", seed=seed,
                          policy="fp32_parity").train()
        x, _ = _dist_batches(seed, 1)[0]
        with torch.no_grad():
            emb1 = model(torch.from_numpy(x).cuda()).float().cpu().numpy()
    finally:
        cudnn.deterministic = det
    del model
    _release(torch)
    bn_err = float(np.abs(emb2 - emb1).max())
    bn_unsynced = float(np.abs(emb2_unsynced - emb1).max())
    rec = {"nccl_probe": probe, "backend": "gloo (through host memory)",
           "spawn_s": spawn_s, "loss_rel": loss_rel, "param_rel": prel,
           "bn_forward_max_abs": bn_err,
           "bn_forward_unsynced_max_abs": bn_unsynced,
           "ranks_bit_equal_every_step": True,
           "dense_step_ms": out["dense"][0][2],
           "ring_step_ms": out["ring"][0][2],
           "dense_median_step_ms": statistics.median(out["dense"][0][2][1:]),
           "ring_median_step_ms": statistics.median(out["ring"][0][2][1:]),
           "wall_s": time.perf_counter() - t0}
    log(f"[5i g2] two ranks on cuda:0 over gloo through host memory (not "
        f"NCCL): ranks' parameters bit for bit after each of "
        f"{DIST_STEPS} steps (dense and ring); ring vs dense loss max rel "
        f"{loss_rel:.3g} (tol {DIST_TOL['g2_loss_rel']}), parameters rel "
        f"{prel:.3g} (tol {DIST_TOL['g2_param_rel']}); synced BatchNorm "
        f"forward G = 2 vs G = 1 max abs {bn_err:.3g} (tol "
        f"{DIST_TOL['bn_forward_abs']}; each rank's own statistics: "
        f"{bn_unsynced:.3g}, must exceed it); gloo-through-host median "
        f"step ms "
        f"over steps 2-{DIST_STEPS}: dense "
        f"{rec['dense_median_step_ms']:.1f}, ring "
        f"{rec['ring_median_step_ms']:.1f}; spawn {spawn_s:.1f} s ({card})")
    if loss_rel > DIST_TOL["g2_loss_rel"] or prel > DIST_TOL["g2_param_rel"] \
            or bn_err > DIST_TOL["bn_forward_abs"] \
            or bn_unsynced <= DIST_TOL["bn_forward_abs"]:
        fail(f"5i: two-rank checks failed: {rec}")
    return rec


def check_dist_refusals(torch, card):
    """``train --mesh 2`` outside a process group, ``--mp 2`` and
    ``--pipeline`` over two ranks on the card exit 2 naming their
    ROADMAP entries."""
    import contextlib
    import logging

    from npairloss_tpu_torch import cli

    solver = cut_solver(DIST_WORK, "solver_refusal.prototxt")
    base = ["train", "--solver", solver, "--model", "googlenet_bn",
            "--synthetic"]
    got = {}

    class _Grab(logging.Handler):
        def __init__(self):
            super().__init__()
            self.lines = []

        def emit(self, record):
            self.lines.append(record.getMessage())

    for tag, extra, want in (
            ("mesh2", ["--mesh", "2"], "torchrun --nproc-per-node 2"),
            ("mp2", ["--mp", "2"], "entry 'partition.py and --mp'")):
        grab = _Grab()
        logging.getLogger("npairloss_tpu_torch").addHandler(grab)
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli.main(base + extra)
        finally:
            logging.getLogger("npairloss_tpu_torch").removeHandler(grab)
        msg = " ".join(grab.lines)
        if rc != 2 or want not in msg:
            fail(f"5i: train {' '.join(extra)} gave rc {rc}: {msg}")
        got[tag] = msg
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "npairloss_tpu_torch", *base, "--pipeline",
         "--mesh", "2", "--coordinator", f"localhost:{port}",
         "--num-processes", "2", "--process-id", str(i)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    for i, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            fail("5i: train --pipeline --mesh 2 did not exit")
        if p.returncode != 2 or "--pipeline over a mesh on a card" not in err:
            fail(f"5i: train --pipeline --mesh 2 rank {i} gave rc "
                 f"{p.returncode}: {err[-800:]}")
        got[f"pipeline_rank{i}"] = err.strip().splitlines()[-1]
    log(f"[5i refusals] --mesh 2 without a group, --mp 2, and --pipeline "
        f"over two ranks on the card each exit 2 naming their ROADMAP "
        f"entries ({card})")
    return got


def drive_distribution(torch, seed, detail):
    """Phase 5i: the G = 1 NCCL runs, the two ranks on the card, the
    refusals."""
    t_start = time.perf_counter()
    g1 = check_dist_one_rank(torch, seed, detail)
    g2 = check_dist_two_ranks(torch, seed, detail)
    refusals = check_dist_refusals(torch, detail["card"])
    wall = time.perf_counter() - t_start
    log(f"[5i] {wall:.1f} s")
    detail["distribution"] = {"g1": g1, "g2": g2, "refusals": refusals,
                              "wall_s": wall}


# -- phase 7: the ResNet and ViT trunk families, Caffe interchange -------------

TRUNK_WORK = os.path.join("build", "trunk_smoke")
RESNET_SOLVER = os.path.join("examples", "resnet50_sop_solver.prototxt")
RESNET_NET = os.path.join("examples", "resnet50_sop.prototxt")
P7_ITERS = 6
P7_KERNELS = tuple(f"{k}:bf16" for k in BLOCKWISE_KERNELS) + ("round_bf16",)
# (pool rows, embedding width) of the new trunks' blockwise losses.
P7_WIDTHS = ((128, 2048), (120, 768), (4096, 768))
P7_TOL = {
    # fp32_parity, card (cuDNN/cuBLAS, TF32 off) vs CPU: unit embeddings,
    # and each parameter's gradient error against the whole gradient's
    # norm (53 BatchNorms and 53 convolutions summed in other orders).
    "emb": 1e-4,
    "grad_rel": 1e-3,
}


def _cli(argv):
    """``cli.main(argv)`` in-process: (rc, stdout lines)."""
    from npairloss_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue().splitlines()


def _finite_events(events, what):
    for rec in events:
        bad = {k: v for k, v in rec.items()
               if isinstance(v, float) and not math.isfinite(v)}
        if bad:
            fail(f"{what}: non-finite values in {rec.get('event')}: {bad}")


def _p7_run(torch, seed, tag, argv, pipeline, batches, start=0, **cut):
    """One phase-7 ``train`` on the ResNet-50/SOP solver cut to 6
    iterations (display 1, snapshot 3), fed the pre-made batches from
    ``start``; the peak allocated bytes beside ``_pipe_train``'s
    record."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cut = {"max_iter": P7_ITERS, "display": 1, "snapshot": 3,
           "source": RESNET_SOLVER, **cut}
    r = _pipe_train(torch, seed, tag, argv, pipeline,
                    batches=batches.from_index(start), **cut)
    r["peak_bytes"] = torch.cuda.max_memory_allocated()
    if r["rc"] != 0:
        fail(f"7 {tag} {'pipe' if pipeline else 'sync'}: train returned "
             f"{r['rc']}: {r['lines'][-5:]}")
    _finite_events(r["events"], f"7 {tag}")
    for ln in r["lines"]:
        log(f"[7 {tag}{' pipe' if pipeline else ''}] {ln}")
    return r


def drive_resnet_train(torch, seed, detail):
    """7 (a): ``examples/resnet50_sop_solver.prototxt`` (ResNet-50, batch
    128 = 64 x 2, 224²) under ``mxu``, dense (the SOP net's mining) and
    blockwise (the reference's), synchronous and ``--pipeline``, and a
    resume from the dense run's iter-3 snapshot.  Returns the blockwise
    run's launches."""
    from npairloss_tpu_torch.train.solver import PIPELINE_WARMUP_STEPS

    card = detail["card"]
    t0 = time.perf_counter()
    batches = _TrainBatches(P7_ITERS, ids=64)
    log(f"[7a] {P7_ITERS} synthetic batches of 128 made in "
        f"{time.perf_counter() - t0:.1f} s")
    rec, finals = {}, {}
    launches = None
    # The blockwise runs take the reference's mining (GLOBAL/RELATIVE_HARD
    # AP: the hist kernel's path), the SOP net's LOCAL/RAND AP needs no
    # selection sweep.
    nets = {"dense": [], "blockwise": [
        "--net", blockwise_net(TRUNK_WORK, RESNET_NET)]}
    for engine in ("dense", "blockwise"):
        runs = {}
        for pipe in (False, True):
            runs[pipe] = _p7_run(torch, seed, f"r50_{engine}",
                                 ["--precision", "mxu", "--engine", engine,
                                  *nets[engine]], pipe, batches)
        s, p = runs[False], runs[True]
        disp = [e["iteration"] for e in s["events"]
                if e["event"] == "display"]
        if disp != list(range(1, P7_ITERS + 1)):
            fail(f"7a {engine}: display iterations {disp}")
        if s["solver"].model.__class__.__name__ != "ResNetEmbedding" or \
                s["solver"].model.embedding_dim != 2048:
            fail(f"7a {engine}: the solver's trunk is not ResNet-50")
        if _masked_lines(s) != _masked_lines(p):
            fail(f"7a {engine}: display lines differ sync vs pipelined")
        if _masked_events(s["events"], s["work"]) != \
                _masked_events(p["events"], p["work"]):
            fail(f"7a {engine}: --log-json records differ")
        differ, n = _state_equal(torch, s["solver"], p["solver"])
        if differ:
            fail(f"7a {engine}: final state differs in {differ[:5]}")
        st = p["stats"]
        if st["captures"] != 1 or \
                st["replays"] != P7_ITERS - PIPELINE_WARMUP_STEPS:
            fail(f"7a {engine}: expected one capture and "
                 f"{P7_ITERS - PIPELINE_WARMUP_STEPS} replays: {st}")
        if s["launches"] != p["launches"]:
            fail(f"7a {engine}: launches sync {s['launches']} pipelined "
                 f"{p['launches']}")
        if engine == "blockwise":
            short = [k for k in P7_KERNELS if s["launches"].get(k, 0) < 1]
            if short:
                fail(f"7a: the blockwise mxu steps did not launch {short}: "
                     f"{s['launches']}")
            launches = s["launches"]
        finals[engine] = {k: v.clone()
                          for k, v in s["solver"].state_dict().items()}
        rec[engine] = {
            "sync_step_ms": s["step_ms"], "pipe_step_ms": p["step_ms"],
            "sync_median_ms": statistics.median(s["step_ms"]),
            "pipe_median_ms": statistics.median(p["step_ms"]),
            "sync_peak_bytes": s["peak_bytes"],
            "pipe_peak_bytes": p["peak_bytes"],
            "launches": s["launches"], "tensors_equal": n,
            "capture_ms": st["capture_ms"][0],
            "pool_bytes": st["pool_bytes"][0], "replays": st["replays"],
            "final_loss": [e for e in s["events"]
                           if e["event"] == "display"][-1].get("loss")}
        log(f"[7a {engine}] ResNet-50 batch 128 224² mxu: median step ms "
            f"over steps 2-6 sync {rec[engine]['sync_median_ms']:.3f} "
            f"pipelined {rec[engine]['pipe_median_ms']:.3f} "
            f"({128 / rec[engine]['sync_median_ms'] * 1e3:.1f} images/s "
            f"sync); peak {s['peak_bytes'] / 2**30:.2f} / "
            f"{p['peak_bytes'] / 2**30:.2f} GiB; records byte for byte, "
            f"{n} tensors bit for bit, {st['replays']} replays of one "
            f"capture; launches {json.dumps(s['launches'])} ({card})")
        snap3 = os.path.join(s["work"], "snap_iter_3.ckpt")
        del runs, s, p
        _release(torch)
    # Resume from the dense run's iter-3 snapshot: steps 4-6 on batches
    # 3-5 end on the uninterrupted run's state bit for bit.
    r = _p7_run(torch, seed, "r50_resume",
                ["--precision", "mxu", "--engine", "dense", "--resume",
                 snap3], False, batches, start=3)
    disp = [e["iteration"] for e in r["events"] if e["event"] == "display"]
    if disp != list(range(4, P7_ITERS + 1)):
        fail(f"7a resume: display iterations {disp}, wanted 4-6")
    differ, n = _state_equal(torch, r["solver"].state_dict(),
                             finals["dense"])
    if differ:
        fail(f"7a resume: state after resuming at 3 differs from the "
             f"uninterrupted run in {differ[:5]}")
    log(f"[7a] resumed at iteration 3 and trained to 6: {n} tensors bit "
        f"for bit against the uninterrupted run")
    rec["resume_tensors_equal"] = n
    del r, finals
    _release(torch)
    return rec, launches


def _grad_rel(torch, got, want):
    """Largest per-parameter gradient error against the norm of the
    whole gradient."""
    norm = math.sqrt(sum(float((g.double() ** 2).sum())
                         for g in want.values()))
    return max(float((got[k].cpu() - want[k]).abs().max())
               for k in want) / norm


def check_trunk_parity(torch, seed, name, n, backward, detail_key, detail):
    """7 (b)/(c): ``name`` under ``fp32_parity`` on ``n`` images of 224²,
    the card against the CPU on the same weights carried across by
    ``models/convert.py``: the training-mode forward, and with
    ``backward`` one backward of a probe objective."""
    import numpy as np

    from npairloss_tpu_torch.models import convert, get_model

    rng = np.random.default_rng(seed + 70)
    x = torch.from_numpy(rng.uniform(-1, 1, (n, 224, 224, 3))
                         .astype(np.float32))
    m_gpu = get_model(name, device="cuda", seed=seed + 1,
                      policy="fp32_parity", input_shape=(224, 224, 3)).train()
    m_cpu = get_model(name, device="cpu", seed=seed + 2,
                      policy="fp32_parity", input_shape=(224, 224, 3)).train()
    params, stats = convert.to_jax_params(m_gpu, with_batch_stats=True)
    convert.load_jax_params(m_cpu, params, stats)
    probe = torch.from_numpy(rng.standard_normal(
        (n, m_gpu.embedding_dim)).astype(np.float32))
    t0 = time.perf_counter()
    out = {}
    for dev, m in (("cuda", m_gpu), ("cpu", m_cpu)):
        with torch.set_grad_enabled(backward):
            emb = m(x.to(dev))
            if backward:
                (emb * probe.to(dev)).sum().backward()
        out[dev] = (emb.detach().cpu(),
                    {k: p.grad.detach().cpu() for k, p in
                     m.named_parameters()} if backward else None)
    emb_err = float((out["cuda"][0] - out["cpu"][0]).abs().max())
    rec = {"emb_err": emb_err, "images": n, "wall_s": time.perf_counter()
           - t0}
    if backward:
        rec["grad_rel"] = _grad_rel(torch, out["cuda"][1], out["cpu"][1])
    log(f"[7 parity {name}] fp32_parity, {n} images 224², card vs CPU: "
        f"embedding max_abs_err {emb_err:.3g}"
        + (f", gradient error {rec['grad_rel']:.3g} of the gradient's norm"
           if backward else "") + f" (tolerances {P7_TOL})")
    if not emb_err <= P7_TOL["emb"] or \
            (backward and not rec["grad_rel"] <= P7_TOL["grad_rel"]):
        fail(f"7 parity {name}: card vs CPU beyond {P7_TOL}: {rec}")
    detail[detail_key] = rec
    del m_gpu, m_cpu, out
    _release(torch)


def drive_vit_train(torch, seed, card, rec):
    """7 (c): ``train --model vit_b16 --precision mxu --engine blockwise``
    on the GoogLeNet/CUB solver cut to 6 iterations (batch 120 = 60 x 2,
    224², pre-made batches).  Returns the launches of its steps."""
    batches = _TrainBatches(P7_ITERS)
    # The reference's mining (the CUB net's needs no selection sweep).
    r = _p7_run(torch, seed, "vit_blockwise",
                ["--net", blockwise_net(TRUNK_WORK), "--model",
                 "vit_b16", "--precision", "mxu", "--engine", "blockwise"],
                False, batches, source=os.path.join(
                    "examples", "googlenet_cub_solver.prototxt"),
                snapshot=0)
    model = r["solver"].model
    if model.__class__.__name__ != "ViTEmbedding" or \
            tuple(model.pos_embed.shape) != (1, 197, 768) or \
            len(model.blocks) != 12:
        fail("7c: the solver's trunk is not ViT-B/16 at 224²")
    short = [k for k in P7_KERNELS if r["launches"].get(k, 0) < 1]
    if short:
        fail(f"7c: the ViT blockwise steps did not launch {short}")
    med = statistics.median(r["step_ms"])
    log(f"[7c] ViT-B/16 batch 120 224² mxu blockwise: median step ms over "
        f"steps 2-6 {med:.3f} ({120 / med * 1e3:.1f} images/s); peak "
        f"{r['peak_bytes'] / 2**30:.2f} GiB; launches "
        f"{json.dumps(r['launches'])} ({card})")
    rec["vit_train"] = {"step_ms": r["step_ms"], "median_ms": med,
                           "peak_bytes": r["peak_bytes"],
                           "launches": r["launches"]}
    launches = r["launches"]
    del r, model
    _release(torch)
    return launches


def check_trunk_widths(torch, seed, card):
    """7 (c): the blockwise kernels in the bf16 mode (the ``mxu`` path's)
    at the new trunks' embedding widths and pools — N = 128, D = 2048
    (ResNet-50), N = 120 and 4096, D = 768 (ViT-B/16) — against their
    plain sweeps (``bf16_engine_bits``, ``bf16_kernel_checks``)."""
    from npairloss_tpu_torch.ops import blockwise_npair as bw
    from npairloss_tpu_torch.ops import npair_loss as nl
    from npairloss_tpu_torch.ops.rank_select import sortable_key

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for n, d in P7_WIDTHS:
        what = f"N={n} D={d}"
        f, lab = unit_batch(torch, seed + 13 + d, n, d)
        out[what] = {
            "engine": bf16_engine_bits(torch, bw, nl, f, lab, what),
            "kernels": bf16_kernel_checks(
                torch, bw, nl, sortable_key, f, lab, what, 512,
                bw.pool_splits(n, n, sms))[0]}
        del f, lab
    log(f"[7 widths] the bf16 five at {[w for w in out]}: kernel = plain "
        f"({card})")
    _release(torch)
    return out


def check_trunk_prof(torch, name, batch, card):
    """7 (c): ``prof --step train`` for ``name``: at batch 8 under
    ``fp32_parity`` the card's step FLOPs equal the CPU's count of the
    same configuration; at ``batch`` under ``mxu`` the report, its MFU
    and its top regions."""
    from npairloss_tpu_torch.obs.perf.report import validate_report

    counts = {}
    for dev in ("cuda", "cpu"):
        out_dir = os.path.join(TRUNK_WORK, f"prof_{name}_{dev}8")
        rc, lines = _cli(["prof", "--step", "train", "--model", name,
                          "--precision", "fp32_parity", "--batch", "8",
                          "--steps", "1" if dev == "cpu" else "2",
                          "--device", dev, "--out", out_dir])
        if rc != 0:
            fail(f"7 prof {name} {dev}: rc {rc}: {lines[-3:]}")
        counts[dev] = json.load(open(os.path.join(
            out_dir, "perf_report.json")))["totals"]["flops_counted"]
    if counts["cuda"] != counts["cpu"]:
        fail(f"7 prof {name}: step FLOPs card {counts['cuda']} != CPU "
             f"{counts['cpu']}")
    out_dir = os.path.join(TRUNK_WORK, f"prof_{name}")
    rc, lines = _cli(["prof", "--step", "train", "--model", name,
                      "--precision", "mxu", "--batch", str(batch),
                      "--steps", "4", "--out", out_dir])
    if rc != 0:
        fail(f"7 prof {name}: rc {rc}: {lines[-3:]}")
    report = json.load(open(os.path.join(out_dir, "perf_report.json")))
    err = validate_report(report)
    if err:
        fail(f"7 prof {name}: {err}")
    mfu = report["timing"].get("mfu")
    if not report["peaks"]["known"] or mfu is None or not 0.0 < mfu < 1.0:
        fail(f"7 prof {name}: no MFU in {report['timing']}")
    top = [(r["region"], f"{r['flops']:.3e}", f"{r['bytes']:.3e}",
            r["bound"]) for r in report["regions"][:6]]
    log(f"[7 prof {name}] batch 8 fp32_parity step FLOPs card = CPU = "
        f"{counts['cpu']:.6e}; batch {batch} mxu {report['timing']}; "
        f"totals flops {report['totals']['flops_counted']:.6e} bytes "
        f"{report['totals']['bytes_counted']:.6e}; top regions {top} "
        f"({card})")
    return {"flops_batch8": counts["cpu"], "timing": report["timing"],
            "totals": {k: report["totals"][k] for k in
                       ("flops_counted", "bytes_counted")},
            "regions": report["regions"][:12]}


def check_vit_stretch(torch, seed, card):
    """7 (d): the stretch's ViT path, ``tools.vit_stretch --batch 4096
    --image 64 --steps 3 --mining flagship`` (a 4096-row pool through the
    bf16 blockwise engine, ViT-B/16 at full width, trunk backward)."""
    from npairloss_tpu_torch.tools import vit_stretch

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = vit_stretch.main(["--batch", "4096", "--image", "64", "--steps",
                               "3", "--mining", "flagship", "--seed",
                               str(seed)])
    if rc != 0:
        fail(f"7d: vit_stretch returned {rc}")
    rec = json.loads(out.getvalue().strip().splitlines()[-1])
    if not math.isfinite(rec["loss"]) or rec["batch"] != 4096 or \
            rec["tokens"] != 17:
        fail(f"7d: {rec}")
    short = [k for k in P7_KERNELS if rec["launches"].get(k, 0) < 1]
    if short:
        fail(f"7d: the stretch steps did not launch {short}")
    log(f"[7d] ViT-B/16 stretch 4096 x 64² ({rec['tokens']} tokens), "
        f"flagship mining, bf16 blockwise: {rec['ms_per_step']:.3f} ms/step, "
        f"{rec['emb_per_sec']:.1f} embeddings/s, peak "
        f"{rec['peak_bytes'] / 2**30:.2f} GiB, loss {rec['loss']}; launches "
        f"{json.dumps(rec['launches'])} ({card})")
    _release(torch)
    return rec


def _trees_equal(a, b, what):
    from npairloss_tpu_torch.models.convert import flatten_params

    fa, fb = flatten_params(a), flatten_params(b)
    if fa.keys() != fb.keys():
        fail(f"{what}: trees differ in names: "
             f"{sorted(set(fa) ^ set(fb))[:5]}")
    bad = [k for k in fa if not (fa[k].shape == fb[k].shape
                                 and (fa[k] == fb[k]).all())]
    if bad:
        fail(f"{what}: leaves differ bit for bit: {bad[:5]}")
    return len(fa)


def check_caffe_interchange(torch, seed, card):
    """7 (e): a random ``resnet50`` and a plain ``googlenet`` written as
    ``.caffemodel`` files by the port's codec, then ``import-caffemodel``
    -> ``train --weights`` (2 steps) -> ``export-caffemodel --snapshot``
    -> ``import-caffemodel``; GoogLeNet also through ``test
    --caffe-pad`` and ``train --caffe-solverstate``."""
    import shutil

    import numpy as np

    from npairloss_tpu_torch import cli
    from npairloss_tpu_torch.config.caffemodel import (
        parse_solverstate,
        write_caffemodel,
        write_solverstate,
    )
    from npairloss_tpu_torch.models import caffe_import, convert, get_model

    work = os.path.join(TRUNK_WORK, "caffe")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    rng = np.random.default_rng(seed + 71)
    rec = {}

    def cli_ok(argv, what):
        rc, lines = _cli(argv)
        if rc != 0:
            fail(f"7e {what}: rc {rc}: {lines[-3:]}")
        return lines

    def path(name):
        return os.path.join(work, name)

    for family in ("resnet50", "googlenet"):
        t0 = time.perf_counter()
        model = get_model(family, device="cpu", seed=seed + 3)
        params, stats = convert.to_jax_params(model, with_batch_stats=True)
        if stats:
            # Running statistics off their init, so the BN map shows.
            stats = convert.unflatten_params({
                k: rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
                for k, v in convert.flatten_params(stats).items()})
            layers = caffe_import.caffemodel_layers_from_resnet50_params(
                params, stats)
        else:
            layers = caffe_import.caffemodel_layers_from_googlenet_params(
                params)
        with open(path(f"{family}.caffemodel"), "wb") as f:
            f.write(write_caffemodel(layers))
        del model
        cli_ok(["import-caffemodel", "--weights", path(f"{family}.caffemodel"),
                "--model", family, "--out", path(f"{family}.npz")],
               f"{family} import")
        imported = convert.read_weights_npz(path(f"{family}.npz"))
        _trees_equal(imported, {"params": params, "batch_stats": stats}
                     if stats else params, f"7e {family} import")
        if family == "resnet50":
            solver = cut_solver(work, "r50_solver.prototxt",
                                source=RESNET_SOLVER, max_iter=2,
                                snapshot=2, test_initialization="false")
            extra = ["--precision", "mxu"]
        else:
            solver = cut_solver(work, "g_solver.prototxt", max_iter=5,
                                snapshot=5, test_initialization="false")
            extra = ["--model", "googlenet", "--precision", "fp32_parity"]
            # test --caffe-pad on the imported weights.
            lines = cli_ok(["test", "--solver", solver, "--weights",
                            path(f"{family}.npz"), "--caffe-pad",
                            "--synthetic", "--iterations", "1", *extra],
                           "googlenet test --caffe-pad")
            res = json.loads(lines[-1])
            if not all(math.isfinite(v) for v in res.values()):
                fail(f"7e test --caffe-pad: {res}")
            rec["googlenet_test_caffe_pad"] = res
            # A Caffe solverstate at iteration 3: momentum and iteration
            # resume, then steps 4-5.
            mom = convert.unflatten_params({
                k: rng.standard_normal(v.shape).astype(np.float32) * 1e-3
                for k, v in convert.flatten_params(params).items()})
            with open(path("g.solverstate"), "wb") as f:
                f.write(write_solverstate(
                    3, caffe_import.googlenet_history_from_momentum(mom)))
            extra += ["--caffe-solverstate", path("g.solverstate")]
        events = path(f"{family}_events.jsonl")
        cli_ok(["train", "--solver", solver, "--weights",
                path(f"{family}.npz"), "--synthetic", "--snapshot_prefix",
                path(f"{family}_snap_"), "--log-json", events, *extra],
               f"{family} train --weights")
        evs = [json.loads(ln) for ln in open(events)]
        _finite_events(evs, f"7e {family}")
        disp = [e["iteration"] for e in evs if e["event"] == "display"]
        want = [1, 2] if family == "resnet50" else [4, 5]
        if disp != want:
            fail(f"7e {family}: display iterations {disp}, wanted {want}")
        last = 2 if family == "resnet50" else 5
        snap = path(f"{family}_snap_iter_{last}.ckpt")
        export = ["export-caffemodel", "--snapshot", snap, "--model",
                  family, "--out", path(f"{family}_out.caffemodel")]
        if family == "googlenet":
            export += ["--solverstate-out", path("g_out.solverstate")]
        cli_ok(export, f"{family} export")
        cli_ok(["import-caffemodel", "--weights",
                path(f"{family}_out.caffemodel"), "--model", family,
                "--out", path(f"{family}_back.npz")], f"{family} re-import")
        s_params, s_stats, s_mom, step = cli._read_snapshot_trees(snap)
        back = convert.read_weights_npz(path(f"{family}_back.npz"))
        n = _trees_equal(back, {"params": s_params, "batch_stats": s_stats}
                         if s_stats else s_params, f"7e {family} round trip")
        before = convert.flatten_params(params)
        moved = any(not np.array_equal(v, before[k]) for k, v in
                    convert.flatten_params(s_params).items())
        if not moved:
            fail(f"7e {family}: training did not move the weights")
        if family == "googlenet":
            ss = parse_solverstate(open(path("g_out.solverstate"),
                                        "rb").read())
            got, _ = caffe_import.googlenet_momentum_from_history(
                ss["history"], s_mom, strict=True)
            _trees_equal(got, s_mom, "7e googlenet solverstate")
            if ss["iter"] != 5 or step != 5:
                fail(f"7e googlenet: solverstate iteration {ss['iter']}, "
                     f"snapshot {step}")
        rec[family] = {"leaves": n, "wall_s": time.perf_counter() - t0,
                       "caffemodel_bytes": os.path.getsize(
                           path(f"{family}_out.caffemodel"))}
        log(f"[7e {family}] .caffemodel -> import -> train {disp} -> "
            f"export -> import: {n} leaves bit for bit"
            + (", the solverstate's momentum and iteration 5 too"
               if family == "googlenet" else "")
            + f" in {rec[family]['wall_s']:.1f} s ({card})")
    _release(torch)
    return rec


def check_trunk_serving(torch, seed, name, card):
    """7 (f): ``serve --model name`` (``cli.build_server``, buckets of 1,
    the fused probe) over an IVF gallery of the trunk's own embeddings of
    2,048 images, answering 38 raw-image queries (gallery images) over
    JSONL; each answer equal to a direct trunk forward of the query at
    batch 1 plus the scan engine (the probe's plain version)."""
    import numpy as np

    from npairloss_tpu_torch import cli
    from npairloss_tpu_torch.models import get_model
    from npairloss_tpu_torch.ops import _build
    from npairloss_tpu_torch.ops.normalize import l2_normalize
    from npairloss_tpu_torch.serve.engine import EngineConfig, QueryEngine
    from npairloss_tpu_torch.serve.ivf import IVFIndex

    t0 = time.perf_counter()
    model = get_model(name, device="cuda", seed=seed,
                      input_shape=(224, 224, 3))
    gen = torch.Generator(device="cuda").manual_seed(seed + 72)
    embs, queries = [], None
    with torch.inference_mode():
        for i in range(16):
            x = torch.randint(-128, 128, (128, 224, 224, 3), generator=gen,
                              device="cuda").float()
            if i == 0:
                queries = x[:38].cpu().numpy()
            embs.append(model(x).float().cpu().numpy())
    emb = np.concatenate(embs)
    labels = np.arange(emb.shape[0]) // 2
    index = IVFIndex.build_ivf(emb, labels, normalize=True, iters=10,
                               seed=seed, device="cuda")
    index_path = os.path.join(TRUNK_WORK, f"serve_{name}.gidx")
    index.save(index_path)
    args = cli.build_parser().parse_args(
        ["serve", "--index", index_path, "--model", name, "--index-kind",
         "ivf", "--probe-impl", "fused", "--probes", "8", "--top-k", "10",
         "--buckets", "1", "--seed", str(seed)])
    built = cli.build_server(args)
    if isinstance(built, int):
        fail(f"7f {name}: serve refused ({built})")
    server, _ = built
    # The direct forward at the served batch (1), before serving.
    with torch.inference_mode():
        direct = np.concatenate([
            l2_normalize(model(torch.as_tensor(q[None], device="cuda")))
            .cpu().numpy() for q in queries])
    lines = [json.dumps({"id": f"q{i}", "input": q.tolist()})
             for i, q in enumerate(queries)]
    out = io.StringIO()
    _build.reset_launch_counts()
    t1 = time.perf_counter()
    rc = server.run_jsonl(io.StringIO("\n".join(lines) + "\n"), out)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = _build.launch_counts()
    answers = {a.get("id"): a for a in map(json.loads,
                                           out.getvalue().splitlines())}
    summary = answers.pop(None, None) or answers.pop("serve_drain", None)
    if rc != 0 or launches.get("probe_topk", 0) < len(queries):
        fail(f"7f {name}: rc {rc}, probe launches "
             f"{launches.get('probe_topk')} for {len(queries)} queries")
    # The plain probe on the direct forward's embeddings.
    plain = QueryEngine(server.engine.index, EngineConfig(
        top_k=10, buckets=(1,), probes=8, probe_impl="scan"))
    want = plain.query(direct)
    self_top1, err = 0, 0.0
    for i in range(len(queries)):
        a = answers.get(f"q{i}")
        if a is None or "error" in a:
            fail(f"7f {name}: query {i} not answered: {a}")
        rows = np.array([nb["row"] for nb in a["neighbors"]])
        scores = np.array([nb["score"] for nb in a["neighbors"]],
                          np.float32)
        err = max(err, float(np.abs(scores - want["scores"][i]).max()))
        if not err <= TOL["serve_trunk"]:
            fail(f"7f {name}: query {i} scores {scores} != direct + plain "
                 f"{want['scores'][i]}")
        _rows_agree_outside_ties(
            np, torch.as_tensor(want["scores"][i][None]),
            torch.as_tensor(rows[None]), torch.as_tensor(
                want["rows"][i][None]),
            torch.ones((1, rows.size), dtype=torch.bool), f"7f {name} q{i}",
            TOL["serve_trunk"])
        self_top1 += int(rows[0] == i)
    rec = {"queries": len(queries), "wall_s": wall, "score_err": err,
           "probe_launches": launches["probe_topk"],
           "self_top1": self_top1, "gallery": int(emb.shape[0]),
           "clusters": index.n_clusters, "summary": summary,
           "total_s": time.perf_counter() - t0}
    log(f"[7f {name}] serve over {emb.shape[0]} own embeddings "
        f"({index.n_clusters} clusters): {len(queries)} raw 224² queries "
        f"answered in {wall:.2f} s, equal to a direct forward + the plain "
        f"probe (scores within {err:.3g}); probe launches {launches['probe_topk']}; self top-1 "
        f"{self_top1}/{len(queries)} ({card})")
    del server, model, plain
    _release(torch)
    return rec


def drive_trunks(torch, seed, detail):
    """Phase 7 (see the module docstring); returns the launches of its
    blockwise and probe kernels."""
    card = detail["card"]
    t_start = time.perf_counter()
    os.makedirs(TRUNK_WORK, exist_ok=True)
    cudnn = torch.backends.cudnn
    det, bench = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    rec = {}
    try:
        rec["resnet_train"], r50_launches = drive_resnet_train(torch, seed,
                                                               detail)
        check_trunk_parity(torch, seed, "resnet50", 4, True,
                           "resnet_parity", rec)
        vit_launches = drive_vit_train(torch, seed, card, rec)
        check_trunk_parity(torch, seed, "vit_b16", 2, False, "vit_parity",
                           rec)
        rec["widths"] = check_trunk_widths(torch, seed, card)
        rec["prof"] = {name: check_trunk_prof(torch, name, batch, card)
                       for name, batch in (("vit_b16", 120),
                                           ("resnet50", 128))}
        rec["stretch"] = check_vit_stretch(torch, seed, card)
        rec["caffe"] = check_caffe_interchange(torch, seed, card)
        rec["serve"] = {name: check_trunk_serving(torch, seed, name, card)
                        for name in ("resnet50", "vit_b16")}
    finally:
        cudnn.deterministic, cudnn.benchmark = det, bench
    launches = {k: r50_launches.get(k, 0) + vit_launches.get(k, 0)
                + rec["stretch"]["launches"].get(k, 0) for k in P7_KERNELS}
    launches["probe_topk"] = sum(v["probe_launches"]
                                 for v in rec["serve"].values())
    wall = time.perf_counter() - t_start
    log(f"[7] {wall:.1f} s; launches in phase 7 {json.dumps(launches)}")
    rec["launches"], rec["wall_s"] = launches, wall
    detail["trunks"] = rec
    return launches


# -- phase 8: observability of serving and the fleet ---------------------------

OBS_WORK = os.path.join("build", "obs_smoke")
OBS_WINDOW = 16
OBS_TURNS = 3
SERVE_SPANS = ("serve/admit", "serve/batch", "serve/dispatch",
               "serve/encode", "serve/topk", "serve/warmup")
SERVE_KERNELS = ("probe_topk", "lrn_fwd", "fused_bias_relu",
                 "fused_bias_relu_pool")


def _obs_records(seed, emb):
    """Phase 4's 38 queries: 30 gallery rows, 8 raw 224² images."""
    import numpy as np

    rng = np.random.default_rng(seed + 1)
    images = rng.standard_normal((8, 224, 224, 3), dtype=np.float32)
    gal_rows = rng.choice(emb.shape[0], size=30, replace=False)
    records = []
    for i, r in enumerate(gal_rows):
        records.append({"id": f"g{i}", "embedding": emb[r].tolist()})
        if i % 4 == 0 and i // 4 < len(images):
            records.append({"id": f"x{i // 4}",
                            "input": images[i // 4].tolist()})
    return records, gal_rows


def _http_server(server):
    """``server.run_http(0)`` on a thread; (thread, port, result)."""
    import threading

    res: dict = {}
    th = threading.Thread(target=lambda: res.update(rc=server.run_http(0)),
                          daemon=True)
    th.start()
    deadline = time.monotonic() + 60.0
    while server.http_port is None:
        if time.monotonic() > deadline or not th.is_alive():
            fail("8a: run_http did not start listening")
        time.sleep(0.01)
    return th, server.http_port, res


def _strip_ages(answer):
    return json.dumps({k: v for k, v in answer.items()
                       if k not in ("index_age_s", "model_age_s")})


def check_serve_telemetry(torch, seed, detail, emb, labels):
    """8 (a): ``serve --telemetry-dir`` at phase 4's configuration through
    ``cli.build_server`` (IVF 246 clusters, probes 8, the fused probe,
    top-k 10, buckets 1/8/32, ``googlenet_pallas`` bf16 at 224², 2
    replicas, metrics window 16) over HTTP, beside the same index and
    trunk served without telemetry; the 38 queries in one body, in turns
    off/on."""
    import shutil

    import numpy as np

    from npairloss_tpu_torch import cli
    from npairloss_tpu_torch.obs import REQUIRED_KEYS, validate_chrome_trace
    from npairloss_tpu_torch.ops import _build
    from npairloss_tpu_torch.serve.batcher import BatcherConfig
    from npairloss_tpu_torch.serve.engine import QueryEngine
    from npairloss_tpu_torch.serve.server import RetrievalServer, ServerConfig

    card = detail["card"]
    work = os.path.abspath(os.path.join(OBS_WORK, "serve"))
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    np.save(os.path.join(work, "emb.npy"), emb)
    np.save(os.path.join(work, "labels.npy"), labels)
    gidx = os.path.join(work, "g.gidx")
    with contextlib.redirect_stdout(io.StringIO()):
        if cli.main(["index", "--emb", os.path.join(work, "emb.npy"),
                     "--labels", os.path.join(work, "labels.npy"), "--out",
                     gidx, "--no-normalize"]) != 0:
            fail("8a: index failed")
    tel_dir = os.path.join(work, "tel")
    args = cli.build_parser().parse_args([
        "serve", "--index", gidx, "--index-kind", "ivf", "--ivf-clusters",
        "246", "--probes", "8", "--probe-impl", "fused", "--top-k", "10",
        "--buckets", "1,8,32", "--replicas", "2", "--model",
        "googlenet_pallas", "--input-size", "224", "--metrics-window",
        str(OBS_WINDOW), "--poll-s", "0.01", "--explicit-drops", "--seed",
        str(seed), "--telemetry-dir", tel_dir])
    t0 = time.perf_counter()
    on, _ = cli.build_server(args)
    build_s = time.perf_counter() - t0
    tel = on.telemetry
    # The same index, trunk and kernels without telemetry.
    primary = QueryEngine(on.engine.index, on.engine.cfg,
                          model=on.engine.model)
    primary.warmup((224, 224, 3))
    off = RetrievalServer(
        [primary, QueryEngine(on.engine.index, on.engine.cfg,
                              share_compiled_with=primary)],
        BatcherConfig(max_batch=32, max_delay_ms=args.deadline_ms,
                      max_queue=args.max_queue),
        ServerConfig(metrics_window=OBS_WINDOW, poll_s=0.01,
                     explicit_drops=True),
        preempt=type(on.preempt)(), freshness=on.freshness)
    records, gal_rows = _obs_records(seed, emb)
    body = "\n".join(json.dumps(r) for r in records)
    runs = {"off": off, "on": on}
    http = {k: _http_server(s) for k, s in runs.items()}
    answers, lat = {}, {"off": [], "on": []}
    turns = {"off": [], "on": []}
    launches = None
    try:
        for turn in range(OBS_TURNS):
            for key in ("off", "on"):
                server = runs[key]
                n0 = len(server._lat)
                b0 = [r.batcher.batches for r in server.replicaset.replicas]
                t_turn = time.perf_counter()
                if key == "on" and turn == 0:
                    torch.cuda.synchronize()
                    _build.reset_launch_counts()
                code, out, _ = _http_call(http[key][1], "POST", "/query",
                                          body)
                if code != 200 or len(out) != len(records):
                    fail(f"8a: {key} turn {turn} answered {code}: "
                         f"{str(out)[:300]}")
                if key == "on" and turn == 0:
                    torch.cuda.synchronize()
                    launches = _build.launch_counts()
                    rows = [r for r in tel.ring.records()
                            if r.get("phase") == "serve"]
                    if len(rows) != len(records) // OBS_WINDOW:
                        fail(f"8a: {len(rows)} window rows after "
                             f"{len(records)} answers, want "
                             f"{len(records) // OBS_WINDOW}")
                if turn == 0:
                    answers[key] = [_strip_ages(a) for a in out]
                lat[key].extend(list(server._lat)[n0:])
                turns[key].append({
                    "wall_ms": (time.perf_counter() - t_turn) * 1e3,
                    "batches": [r.batcher.batches - b for r, b in zip(
                        server.replicaset.replicas, b0)]})
    finally:
        for key, server in runs.items():
            server.preempt.request()
            http[key][0].join(timeout=120)
        tel.close()
    for key in runs:
        if http[key][0].is_alive() or http[key][2].get("rc") != 75:
            fail(f"8a: the {key} server did not drain: {http[key][2]}")
    if answers["on"] != answers["off"]:
        bad = [i for i, (a, b) in enumerate(zip(answers["on"],
                                                answers["off"])) if a != b]
        fail(f"8a: answers with telemetry differ at {bad[:5]}")
    for i, r in enumerate(gal_rows):
        top = json.loads(answers["on"][[x["id"] for x in records]
                                       .index(f"g{i}")])["neighbors"][0]
        if top["row"] != int(r):
            fail(f"8a: gallery row {r}: top-1 is {top}")
    for name in SERVE_KERNELS:
        if launches.get(name, 0) < 1:
            fail(f"8a: kernel {name} was not launched")
    # The run directory: manifest, envelopes, trace, spans, lanes, split.
    man = json.load(open(os.path.join(tel_dir, "manifest.json")))
    if not (man.get("run_id") and man.get("created")
            and man["config"].get("serve") and man["config"]["replicas"]
            == 2):
        fail(f"8a: manifest {man}")
    rows = _tel_rows(tel_dir)
    bad = [r for r in rows if any(k not in r for k in REQUIRED_KEYS)]
    n_ans = len(records) * OBS_TURNS
    windows = [r for r in rows if r.get("event") != "serve_drain"]
    if bad or len(windows) != n_ans // OBS_WINDOW \
            or rows[-1].get("event") != "serve_drain":
        fail(f"8a: rows: {len(windows)} windows for {n_ans} answers, "
             f"{len(bad)} without the envelope, last {rows[-1]}")
    trace = json.load(open(os.path.join(tel_dir, "trace.json")))
    err = validate_chrome_trace(trace)
    if err:
        fail(f"8a: trace.json: {err}")
    evs = trace["traceEvents"]
    names = {e["name"] for e in evs}
    missing = [s for s in SERVE_SPANS if s not in names]
    lanes = {e["tid"] for e in evs if e["name"] == "serve/dispatch"}
    busy = [r.name for r in on.replicaset.replicas if r.batcher.batches]
    if missing or len(lanes) != len(busy) or len(busy) != 2:
        fail(f"8a: spans missing {missing}; dispatch lanes {len(lanes)} for "
             f"replicas that dispatched {busy}")
    drain = rows[-1]
    split = {k: drain[k] for k in drain
             if k.endswith(("_p50_ms", "_p99_ms")) and k.split("_")[0] in
             ("admit", "batch", "dispatch", "encode", "topk")}
    if set(k.split("_")[0] for k in split) != {
            "admit", "batch", "dispatch", "encode", "topk"}:
        fail(f"8a: the drain split lacks a stage: {split}")
    # The drain's split is the one of every span after the server's
    # construction, and no warm-up span is among them.
    start = on._events_start_idx
    if RetrievalServer._latency_split(evs[start:]) != split or any(
            e["name"] == "serve/warmup" for e in evs[start:]) or not any(
            e["name"] == "serve/warmup" for e in evs[:start]):
        fail(f"8a: the drain split does not reconcile with the spans after "
             f"construction (warm-up excluded): {split}")
    n_topk = sum(1 for e in evs if e["name"] == "serve/topk")
    n_warm_topk = sum(1 for e in evs if e["name"] == "serve/warmup"
                      and (e.get("args") or {}).get("kind") == "topk")
    recompiles = sum(1 for e in evs if e["name"] == "serve/recompile")
    pct = {k: _pcts(v) for k, v in lat.items()}
    out = {"build_s": build_s, "launches": {k: launches[k]
                                            for k in SERVE_KERNELS},
           "windows": len(windows), "drain_split": split,
           "latency": pct, "dispatch_lanes": len(lanes),
           "topk_spans": n_topk, "warmup_topk_spans": n_warm_topk,
           "recompile_instants": recompiles,
           "replica_batches": {r.name: r.batcher.batches
                               for r in on.replicaset.replicas},
           "turns": turns, "rows": rows}
    log(f"[8a] serve --telemetry-dir at phase 4's config over HTTP, 2 "
        f"replicas (built in {build_s:.1f} s): {len(records)} answers equal "
        f"to the server without telemetry (ages stripped); {len(windows)} "
        f"window rows for {n_ans} answers (window {OBS_WINDOW}); spans "
        f"{sorted(s for s in names if s.startswith('serve/'))}; dispatch "
        f"lanes {len(lanes)} (batches {out['replica_batches']}; per turn "
        f"{json.dumps(turns)}); "
        f"recompile instants {recompiles}; drain split {json.dumps(split)}; "
        f"launches of one 38-query turn {json.dumps(out['launches'])}; "
        f"per-query ms over {OBS_TURNS} turns each (off, on in turn): "
        f"off p50 {pct['off']['p50_ms']:.3f} p99 {pct['off']['p99_ms']:.3f}"
        f", on p50 {pct['on']['p50_ms']:.3f} p99 {pct['on']['p99_ms']:.3f} "
        f"({card})")
    del on, off, primary, runs
    _release(torch)
    return out


def check_prof_serve(torch, detail):
    """8 (b): ``prof --step serve --gallery 60502 --dim 1024 --buckets
    1,8,32``."""
    from npairloss_tpu_torch import cli
    from npairloss_tpu_torch.obs.perf.report import validate_report

    out_dir = os.path.join(OBS_WORK, "prof_serve")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["prof", "--step", "serve", "--gallery", "60502",
                       "--dim", "1024", "--buckets", "1,8,32", "--steps",
                       "12", "--out", out_dir])
    if rc != 0:
        fail(f"8b: prof --step serve rc {rc}: {buf.getvalue()[-500:]}")
    report = json.load(open(os.path.join(out_dir, "perf_report.json")))
    err = validate_report(report)
    if err or not report["peaks"]["known"]:
        fail(f"8b: report {err}; peaks {report['peaks']}")
    t = report["timing"]
    if not 0.0 < t.get("mfu", -1.0) < 1.0 or \
            set(report["serve_latency"]) != {"topk"}:
        fail(f"8b: timing {t}, split {report['serve_latency']}")
    top = [(r["region"], f"{r['flops']:.3e}", f"{r['bytes']:.3e}",
            r["bound"], r["est_ms_at_roofline"])
           for r in report["regions"][:4]]
    ms_q = t["ms_per_step"] / report["batch"]
    log(f"[8b] prof --step serve (flat 60,502 x 1024, buckets 1/8/32): "
        f"{t['ms_per_step']:.4f} ms per bucket-32 dispatch, {ms_q:.5f} ms "
        f"per query, mfu {t['mfu']}; regions (region, flops, bytes, bound, "
        f"roofline ms) {top}; split {json.dumps(report['serve_latency'])}; "
        f"decomposition {json.dumps(report['decomposition'])} "
        f"({detail['card']})")
    return {"timing": t, "ms_per_query": ms_q, "regions": report["regions"],
            "serve_latency": report["serve_latency"],
            "decomposition": report["decomposition"]}


def _fleet_rank_train(mesh, seed, solver_path, run_dir):
    """Rank task of 8 (c): ``DIST_STEPS`` dense steps of googlenet_bn mxu
    on this rank's 60 rows of each 120-row global batch through
    ``Solver.train``, under fleet telemetry in ``run_dir``; returns the
    parameter bytes."""
    import torch

    from npairloss_tpu_torch.obs import RunTelemetry
    from npairloss_tpu_torch.parallel import shard_batch

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    tel = RunTelemetry(run_dir, fleet=True)
    solver = _dist_solver(torch, seed, "mxu", "dense", mesh, solver_path)
    solver.telemetry = tel
    batches = [shard_batch(mesh, b) for b in _dist_batches(seed, DIST_STEPS)]
    try:
        solver.train(iter(batches), DIST_STEPS, log_fn=lambda line: None)
    finally:
        tel.close()
    return sum(p.numel() * p.element_size() for p in solver.params.values())


def fleet_ranks(pool, seed, solver_path):
    """8 (c)'s run on a pool of two ranks on cuda:0 over gloo (5i (b)'s):
    ``DIST_STEPS`` dense steps each under fleet telemetry; returns the
    run dir, the ranks' parameter bytes and the wall seconds."""
    import shutil

    run_dir = os.path.abspath(os.path.join(OBS_WORK, "fleet", "run"))
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    t0 = time.perf_counter()
    param_bytes = pool.run(_fleet_rank_train, seed, solver_path, run_dir)
    return {"run_dir": run_dir, "param_bytes": param_bytes,
            "ranks_s": time.perf_counter() - t0}


def check_fleet(detail):
    """8 (c): ``prof --fleet`` and ``timeline`` over the run directory of
    two ranks on cuda:0 over gloo under fleet telemetry (``fleet_ranks``,
    run in 5i (b)'s pool, where the card's memory is free of the later
    phases')."""
    from npairloss_tpu_torch import cli
    from npairloss_tpu_torch.obs import validate_chrome_trace
    from npairloss_tpu_torch.obs.fleet import (
        COMMS_FILENAME,
        grad_sync_claim_bytes,
        validate_fleet_report,
    )

    card = detail["card"]
    run = detail["fleet_run"]
    run_dir, param_bytes, ranks_s = (run["run_dir"], run["param_bytes"],
                                     run["ranks_s"])
    if param_bytes[0] != param_bytes[1]:
        fail(f"8c: the ranks' parameter bytes differ {param_bytes}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["prof", "--fleet", run_dir])
    if rc != 0:
        fail(f"8c: prof --fleet rc {rc}: {buf.getvalue()[-800:]}")
    report = json.load(open(os.path.join(run_dir, "fleet_report.json")))
    err = validate_fleet_report(report)
    if err or report["ranks_present"] != [0, 1]:
        fail(f"8c: fleet report {err}; ranks {report['ranks_present']}")
    payload = json.load(open(os.path.join(run_dir, COMMS_FILENAME)))
    claim = grad_sync_claim_bytes(float(param_bytes[0]), 2)
    priced = payload["per_kind"].get("allreduce", {}).get("bytes", 0)
    comms = report["comms"]
    kinds = {k["kind"]: k for k in comms.get("kinds", [])}
    if payload["extra_claims"] != claim or priced < param_bytes[0] \
            or not comms.get("available") or comms["unattributed_bytes"] \
            or "allreduce" not in kinds:
        fail(f"8c: comms {payload['extra_claims']} vs claim {claim}, "
             f"priced all-reduce {priced}, block {comms}")
    merged = json.load(open(os.path.join(run_dir, "fleet_trace.json")))
    err = validate_chrome_trace(merged)
    if err or merged["otherData"]["merged_ranks"] != [0, 1]:
        fail(f"8c: merged trace {err}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["timeline", run_dir])
    tl = json.load(open(json.loads(buf.getvalue().strip())["timeline"]))
    err = validate_chrome_trace(tl)
    if rc != 0 or err or tl["otherData"]["sources"]["trainer_ranks"] != [
            0, 1]:
        fail(f"8c: timeline rc {rc}: {err}")
    skew = report["skew"]
    ar = kinds["allreduce"]
    out = {"ranks_s": ranks_s, "param_bytes": param_bytes[0],
           "skew": skew, "ranks": report["ranks"],
           "comms": {"link": comms["link"],
                     "ms_per_step": comms["ms_per_step"],
                     "kinds": comms["kinds"]}}
    log(f"[8c] two ranks on cuda:0 over gloo, googlenet_bn mxu dense, "
        f"{DIST_STEPS} steps ({ranks_s:.1f} s, in 5i (b)'s pool): fleet report "
        f"valid, ranks {report['ranks_present']}; skew over "
        f"{skew['steps_analyzed']} steps [{skew['source']}]: dispatch "
        f"spread p50 {skew['dispatch_spread_ms_p50']} ms p99 "
        f"{skew['dispatch_spread_ms_p99']} ms, end spread p50 "
        f"{skew['end_spread_ms_p50']} ms; slowest {skew['slowest']}; "
        f"ms/step p50 by rank "
        f"{[r['ms_per_step_p50'] for r in report['ranks']]}, barrier wait "
        f"{[r['barrier_wait_share'] for r in report['ranks']]}; all-reduce "
        f"claim {claim['allreduce']:.0f} B (the parameter bytes), priced "
        f"{ar['bytes_per_step']:.0f} B/step, effective "
        f"{(ar['effective_bytes_per_s'] or 0) / 1e9:.3f} GB/s over "
        f"{comms['link']} (no published peak); all-gather "
        f"{kinds.get('all_gather', {}).get('bytes_per_step')} B/step; "
        f"merged trace and timeline valid ({card})")
    return out


def check_device_query(torch, detail):
    """8 (d): ``device-query`` on the card."""
    from npairloss_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["device-query"])
    rec = json.loads(buf.getvalue())
    dev = rec["devices"][0]
    if rc != 0 or rec["default_backend"] != "gpu" \
            or dev["platform"] != "gpu" \
            or dev["device_kind"] != torch.cuda.get_device_name(0) \
            or not dev["bytes_limit"] > 0:
        fail(f"8d: device-query {rec}")
    log(f"[8d] device-query: {json.dumps(rec)}")
    return rec


def check_debug_checks(torch, seed, detail):
    """8 (e): ``train --debug-checks`` on the phase-5h cut (googlenet_pallas
    fp32 dense, 6 iterations): records equal to the run without it;
    with ``step.nan_loss`` armed the run goes on as the JAX CLI's does
    (the check precedes the loop's host poison); a non-finite step (a
    parameter set to NaN before step 3) stops it with JAX's
    ``FloatingPointError``."""
    import math

    from npairloss_tpu_torch.resilience import failpoints
    from npairloss_tpu_torch.utils.debug import enable_debug_checks

    card = detail["card"]
    argv = ["--model", "googlenet_pallas"]
    batches = _TrainBatches(n=6)
    cut = {"max_iter": 6, "display": 2, "average_loss": 2, "snapshot": 0,
           **NO_TEST}
    cudnn = torch.backends.cudnn
    det, bench = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    runs = {}
    try:
        for tag, extra, arm in (("plain", [], False),
                                ("debug", ["--debug-checks"], False),
                                ("debug_nan_loss", ["--debug-checks"], True)):
            if arm:
                failpoints.arm("step.nan_loss", times=1, delay=2)
            try:
                runs[tag] = _pipe_train(torch, seed, f"dbg_{tag}",
                                        argv + extra, False,
                                        batches=batches.from_index(0), **cut)
            finally:
                failpoints.reset()
                enable_debug_checks(False)
            if runs[tag]["rc"] != 0:
                fail(f"8e: {tag} rc {runs[tag]['rc']}")
            _release(torch)

        def poison(solver, loop, n):
            if n == 3:
                with torch.no_grad():
                    next(iter(solver.params.values())).fill_(float("nan"))

        raised = None
        try:
            _pipe_train(torch, seed, "dbg_nonfinite", argv + [
                "--debug-checks"], False, batches=batches.from_index(0),
                hook=poison, **cut)
        except FloatingPointError as e:
            raised = str(e)
        finally:
            enable_debug_checks(False)
    finally:
        cudnn.deterministic, cudnn.benchmark = det, bench
    _release(torch)
    same = (_masked_events(runs["plain"]["events"], runs["plain"]["work"])
            == _masked_events(runs["debug"]["events"], runs["debug"]["work"])
            and _masked_lines(runs["plain"]) == _masked_lines(runs["debug"]))
    nan_rows = [e["iteration"] for e in runs["debug_nan_loss"]["events"]
                if e.get("event") == "display"
                and not math.isfinite(e.get("loss_avg", 0.0))]
    if not same:
        fail("8e: --debug-checks changed the records")
    if nan_rows != [4]:
        fail(f"8e: step.nan_loss under --debug-checks: NaN display rows "
             f"at {nan_rows}, want [4] (the run goes on, as JAX's)")
    if raised is None or not raised.startswith("non-finite step metrics["):
        fail(f"8e: a non-finite step under --debug-checks raised {raised!r}")
    log(f"[8e] train --debug-checks (googlenet_pallas fp32, 6 steps): "
        f"records and display lines byte for byte with the run without it; "
        f"step.nan_loss at step 3: the run ends rc 0 with the NaN in the "
        f"iteration-4 display row, as the JAX CLI's (its check runs before "
        f"the loop's poison); a NaN parameter before step 3: "
        f"FloatingPointError {raised!r} ({card})")
    return {"records_equal": same, "nan_loss_rows": nan_rows,
            "nonfinite_error": raised}


def drive_observability(torch, seed, detail):
    """Phase 8 (see the module docstring); returns 8 (a)'s launches."""
    t_start = time.perf_counter()
    log(f"[8] this process's card memory at the start: allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, reserved "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB, free "
        f"{torch.cuda.mem_get_info()[0] / 2**30:.2f} GiB")
    emb, labels = synthetic_gallery(seed)
    out = {"serve": check_serve_telemetry(torch, seed, detail, emb, labels)}
    del emb, labels
    out["prof_serve"] = check_prof_serve(torch, detail)
    _release(torch)
    out["fleet"] = check_fleet(detail)
    out["device_query"] = check_device_query(torch, detail)
    out["debug_checks"] = check_debug_checks(torch, seed, detail)
    out["wall_s"] = time.perf_counter() - t_start
    log(f"[8] {out['wall_s']:.1f} s")
    detail["observability"] = out
    return out["serve"]["launches"]


def _release(torch):
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


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
    check_probe_duplicates(torch, detail)
    probe_rows = check_probe(torch, timer, index, emb[pick], detail)
    check_probe_large_cap(torch, timer, detail)
    train_rows = check_lrn_train(torch, timer, detail)
    check_stem_scalar_paths(torch, detail)
    check_stem(torch, timer, detail, batch=120, key="stem_train")
    del timer
    launches, summary, qps = drive_path(torch, args.seed, index, emb, detail)
    del index
    train_launches, dense_step_ms = drive_train(torch, args.seed, detail)
    recompute_launches = check_train_step(torch, args.seed, detail)
    check_reference_mining(torch, args.seed, detail)
    _, _, list_net = drive_list_train(torch, args.seed, detail,
                                      dense_step_ms)
    drive_resilience(torch, args.seed, detail, list_net, emb, labels,
                     dense_step_ms)
    tier = drive_serving_tier(
        torch, args.seed, detail, emb, labels,
        os.path.abspath(os.path.join(SNAP_WORK, "bits", "m_iter_6.ckpt")))
    del emb, labels
    _release(torch)
    bn_launches = drive_bn_train(torch, args.seed, detail)
    drive_bn_learning(torch, args.seed, detail)
    drive_pipeline(torch, args.seed, detail, list_net)
    drive_distribution(torch, args.seed, detail)
    drive_telemetry(torch, args.seed, detail)
    bw_rows = check_blockwise_kernels(torch, Timer(torch), detail, args.seed)
    bw_launches, bw_radix_launches, _ = drive_blockwise_train(
        torch, args.seed, detail, dense_step_ms)
    check_stretch(torch, Timer(torch), detail, args.seed)
    check_stretch_bf16(torch, Timer(torch), detail, args.seed)
    detail["pipeline"]["refusals"] = check_pipeline_refusals(
        torch, detail["card"])
    _release(torch)
    p7_launches = drive_trunks(torch, args.seed, detail)
    _release(torch)
    p8_launches = drive_observability(torch, args.seed, detail)

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
    path_120 = lambda rows, variant, mode="fp32": [  # noqa: E731
        r for r in rows if r["n"] == 120 and r["variant"] == variant
        and r["mode"] == mode]
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
    # The same five in their bf16 mode (matmul precision DEFAULT), with
    # their bf16-mode launches in phase 5f's blockwise mxu run.
    for name, line, variant in (
            ("npair_stats", 287, "hist_same+topk8+emit"),
            ("npair_hist", 355, "cached"), ("npair_loss", 388, "cached"),
            ("npair_gq", 458, "cached"), ("npair_gdb", 483, "cached")):
        kernels.append(entry(
            f"{name}:bf16", src, f"npairloss_tpu/ops/pallas_npair.py:{line}",
            path_120(bw_rows[name], variant, "bf16"), f"{name}:bf16",
            bn_launches))
        # The bf16 mode's kernels on the tensor cores (the cached hist
        # and loss, the path's at N = 120, read the cache alone).
        kernels[-1]["kernel"] = {
            "npair_stats": "npair_stats_kernel<true> (wgmma sim tile)",
            "npair_hist": "npair_hist_kernel<true, L> (cached); "
                          "npair_hist_kernel<false, L, true> (recompute, "
                          "wgmma sim tile)",
            "npair_loss": "npair_loss_kernel<true, L> (cached); "
                          "npair_loss_kernel<false, L, true> (recompute, "
                          "wgmma sim tile)",
            "npair_gq": "npair_grad_tc_kernel (wgmma)",
            "npair_gdb": "npair_grad_tc_kernel (wgmma)"}[name]
    # The bf16 mode's operand rounding, once per loss: the cast inside the
    # Pallas kernels' DEFAULT-precision sim tile.
    kernels.append(entry(
        "round_bf16", src, "npairloss_tpu/ops/pallas_npair.py:180",
        path_120(bw_rows["round_bf16"], "N x D", "bf16"), "round_bf16",
        bn_launches))
    # Phase 7's launches: the bf16 five and the rounding in the ResNet-50,
    # ViT-B/16 and stretch runs; the probe under serve --model
    # resnet50|vit_b16.
    for k in kernels:
        counter = ("probe_topk" if k["name"] == "ivf_probe" else k["name"])
        if counter in p7_launches:
            k["launches_phase7"] = p7_launches[counter]
    # Phase 4b's launches of the four kernels the serving tier runs.
    for k in kernels:
        counter = {"lrn_fwd": "lrn_fwd", "bias_relu": "fused_bias_relu",
                   "bias_relu_pool": "fused_bias_relu_pool",
                   "ivf_probe": "probe_topk"}.get(k["name"])
        if counter is not None:
            k["launches_serving_tier"] = tier["launches"][counter]
            # Phase 8 (a): one turn of 38 queries under serve
            # --telemetry-dir, 2 replicas.
            k["launches_phase8"] = p8_launches[counter]
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
