"""The synchronous solver loop — port of ``npairloss_tpu/train/solver.py``'s
``Solver``, on one device with the dense or the blockwise loss engine, or
over a mesh (``parallel.mesh.Mesh``, one process per device) with the
dense or the ring engine.

The Caffe Solver contract of usage/solver.prototxt: Caffe SGD (lr folded
in before momentum, ``train/optim.py``), the ``display`` /
``average_loss`` sliding window, a TEST phase every ``test_interval``
iterations over ``test_iter`` batches (the same loss + metrics forward on
eval batches) and, at iteration 0, when ``test_initialization`` is set;
a snapshot every ``snapshot`` iterations, committed atomically with a
checksum manifest (``resilience/snapshot.py``) and pruned to the newest
``snapshot_max_keep``.

A BN trunk trains on batch statistics and updates its running ones
(``model.train()`` in a step); the TEST phase and ``evaluate`` run it in
eval mode, on the running statistics, as the JAX ``apply_model`` does.
The running statistics are buffers, so snapshots carry them.

A step keeps its metrics as device tensors; the host reads them only at
display, test and snapshot boundaries and at the end.  ``iteration`` is
the optimizer's step count, and the lr a step reports is the one it
applied (read at the pre-update step, as the JAX step does).  A snapshot
carries ``iteration``, so a restored solver resumes the lr schedule and
every cadence where they stood; the data stream restarts, as in JAX.

A ``PreemptionSignal`` attached as ``solver.preempt`` stops the loop
after the in-flight step: an emergency snapshot, then
``TrainingPreempted``.

``solver.divergence`` (a ``DivergenceConfig``; None = off) arms the
divergence guard: N consecutive non-finite losses roll the solver back
to the newest valid snapshot before the streak (quarantining the later
ones) or halt with ``DivergenceError``; armed, the synchronous loop
reads each step's loss on the host (one sync a step).
``request_rollback`` (any thread) asks the loop to restore a snapshot
committed before an incident at its next safe point.

``SolverConfig.pipeline`` routes ``train`` through the sync-free loop
(``_train_pipelined``): a staging thread places batches on the card on
its own stream (``pipeline.DevicePrefetcher``), the step writes its
metrics into a device-side ring (``pipeline.MetricWindow``) that the
host reads only at display/test/snapshot boundaries, and at most
``pipeline_depth`` steps are in flight (``pipeline.DispatchController``).
On a card the step — forward, loss through either engine, backward,
Caffe SGD, the ring write and the non-finite counter — is captured once
as one CUDA graph after ``PIPELINE_WARMUP_STEPS`` eager steps on a side
stream, and replayed for every later step; a step that cannot be
captured raises, it never runs eagerly in the graph's place.  On the
CPU the same step body runs eagerly.  Both loops emit the same record
stream, byte for byte, and end on the same parameters bit for bit.

Over a mesh of G shards every rank runs this loop on its rows of each
global batch (``data.loader.shard_batches``).  The JAX Solver
differentiates the mean of the G per-rank losses; here each rank
back-propagates its own loss (the engines exchange the pool and its
database-role gradient, BatchNorm its batch statistics), and the
parameter gradients are all-reduced as a mean, so the update is the
JAX one and every rank holds the same parameters bit for bit.  The
reported loss and metrics are the mean over the ranks.  Rank 0 commits
the snapshots; a stop request (preemption) is agreed by every rank at
the step boundary.  On a card the pipelined loop refuses a mesh.

Run telemetry (``obs``), plain attributes as in JAX: ``health`` (a
``HealthConfig``) folds training-health signals into the step's metric
dict as device reductions (no host read, so the pipelined step stays
sync-free and captured); ``telemetry`` (a ``RunTelemetry``) gets one
``train`` row per step (the synchronous loop then reads every step's
metrics — the cost the JAX package documents; the pipelined loop writes
its rows from the ring at each window read), ``eval`` and ``event``
rows, and host spans on every loop boundary (``data/next_batch``,
``step/compile`` for the first step of a key — in the pipelined loop its
warm-up steps and its capture — ``step/dispatch``, ``step/window_sync``,
``eval``, ``snapshot``; the ``step/recompile`` and ``resilience/<kind>``
instants).  ``perf_metrics`` adds one ``perf`` row per display window
(ms_per_step, emb_per_sec, the step's counted FLOPs and MFU): the first
eager step of a key is counted (``obs.perf.count``) inside a
``step/cost_analysis`` span, never inside a capture.  A sink failure
latches: metric rows stop, training goes on.  Under fleet telemetry on
a mesh the dispatch spans carry the step number, the first eager step
of a key is counted to price its collectives per kind (a ``comm/price``
span; rank 0 writes ``fleet_comms.json``; a new batch signature or a
new captured graph prices anew), and every step leaves ``comm/<kind>``
instants with the priced bytes.  With ``utils.debug``'s switch on
(``train --debug-checks``), :meth:`Solver.step` checks every step's
metric scalars on the host, as the JAX step does; the pipelined loop
does not call it, as JAX's does not.

:meth:`Solver.request_rollback` is the actuator of ``train --remediate``
(``resilience/remediate.py``): the live observatory's evaluator thread
asks, and the loop restores at its next safe point.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from npairloss_tpu_torch import device as _device
from npairloss_tpu_torch.obs.health import (
    HealthConfig,
    embedding_health,
    pair_hardness_health,
    tree_l2_norm,
    update_health,
)
from npairloss_tpu_torch.obs.perf import count
from npairloss_tpu_torch.ops.blockwise_npair import (
    blockwise_npair_loss_with_aux,
    blockwise_retrieval_metrics,
)
from npairloss_tpu_torch.ops.metrics import retrieval_metrics
from npairloss_tpu_torch.ops.npair_loss import (
    NPairLossConfig,
    npair_loss_with_aux,
    resolve_matmul_precision,
)
from npairloss_tpu_torch.ops import _build
from npairloss_tpu_torch.resilience import failpoints
from npairloss_tpu_torch.resilience.guard import (
    DivergenceConfig,
    DivergenceError,
    DivergenceGuard,
    RollbackRequest,
)
from npairloss_tpu_torch.resilience.preempt import TrainingPreempted
from npairloss_tpu_torch.resilience.retrying import (
    RetryPolicy,
    call_with_retry,
)
from npairloss_tpu_torch.resilience.snapshot import (
    SnapshotValidationError,
    commit_snapshot,
    commit_snapshot_multi,
    gc_snapshots,
    list_snapshots,
    quarantine_snapshots,
    read_manifest,
    read_state,
    snapshot_info,
    validate_snapshot,
    validate_snapshot_wait,
    verify_restored,
)
from npairloss_tpu_torch.utils.debug import (
    assert_all_finite,
    debug_checks_enabled,
)
from npairloss_tpu_torch.train.optim import (
    Mults,
    caffe_sgd,
    lr_schedule,
    param_mults as mult_table,
)

log = logging.getLogger("npairloss_tpu_torch.solver")

Batches = Iterator[Tuple[np.ndarray, np.ndarray]]

# Eager steps on a side stream before the pipelined step is captured:
# cuBLAS and cuDNN set up their workspaces and plans there, never inside
# the capture.  They are real steps of the run.
PIPELINE_WARMUP_STEPS = 2


class PipelineCaptureError(RuntimeError):
    """The pipelined step could not be captured as one CUDA graph."""


@dataclasses.dataclass
class SolverConfig:
    """The SolverParameter subset the reference uses
    (usage/solver.prototxt:1-17); defaults are the shipped values."""

    base_lr: float = 0.001
    lr_policy: str = "step"
    gamma: float = 0.5
    stepsize: int = 10000
    power: float = 1.0
    stepvalues: Sequence[int] = ()
    momentum: float = 0.9
    weight_decay: float = 0.00002
    max_iter: int = 2000000
    display: int = 100
    average_loss: int = 100
    test_iter: int = 2000
    test_interval: int = 2000
    test_initialization: bool = True
    snapshot: int = 5000
    snapshot_prefix: str = "./snap/model_"
    random_seed: int = 0
    # Retention GC: committed snapshots beyond the newest N are deleted
    # after each commit; 0 keeps all (Caffe's behavior — the JAX
    # package's own extension, not a SolverParameter field).
    snapshot_max_keep: int = 0
    # Sync-free stepping — extensions, not SolverParameter fields.
    # ``pipeline`` routes ``train`` through the pipelined loop (staged
    # batches, a device-side metric ring read at display/test/snapshot
    # boundaries, at most ``pipeline_depth`` steps in flight; on a card
    # the step replays one captured CUDA graph).  ``pipeline_window``
    # caps the steps between host reads (0 = auto: the smallest active
    # cadence, else 64) — it bounds the divergence guard's staleness.
    pipeline: bool = False
    pipeline_depth: int = 2
    pipeline_window: int = 0
    # A shared build directory for the kernel library and the native
    # runtime ("" = the checkout's build/; pipeline.enable_compile_cache).
    compile_cache: str = ""


def _new_pipeline_stats() -> Dict[str, Any]:
    """A pipelined run's counters: its eager and replayed steps, its
    captures with their ms and the bytes their graph pools reserved;
    at the run's end also the controller's waits and the prefetcher's
    staged/consumed batches."""
    return {"eager_steps": 0, "replays": 0, "captures": 0,
            "capture_ms": [], "pool_bytes": []}


def _first_failure(exc: BaseException) -> str:
    """The first error of a failed capture — the op that broke it, with
    the last call site outside torch — not the invalidated capture's
    later errors that it chains to."""
    import traceback

    first = exc
    while first.__context__ is not None:
        first = first.__context__
    msg = f"{type(first).__name__}: {str(first).strip().splitlines()[0]}"
    frames = [f for f in traceback.extract_tb(first.__traceback__)
              if f"{os.sep}torch{os.sep}" not in f.filename]
    if frames:
        f = frames[-1]
        msg += f" at {os.path.basename(f.filename)}:{f.lineno} ({f.line})"
    return msg


def _abandon_capture(device: torch.device, pool) -> None:
    """Close the caching allocator's side of a capture that failed.  When
    a capture is invalidated (a host read inside it), PyTorch's
    ``capture_end`` raises at ``cudaStreamEndCapture`` before it ends the
    allocator's allocation to the graph's pool: the allocator then counts
    a capture under way for good, so ``empty_cache`` never again returns
    a cached block, and every stream's cache only grows (on an H100 the
    process held 74-76 GiB of wholly free blocks on three streams).
    Ending it here and releasing the pool, which no graph then owns, lets
    both go.  When the end raises, ``capture_end`` got past it (the body
    raised inside a capture that stayed valid): the graph owns the pool
    and releases it itself when it is freed, so it is left alone."""
    idx = (device.index if device.index is not None
           else torch.cuda.current_device())
    try:
        torch._C._cuda_endAllocateToPool(idx, pool)
    except RuntimeError:
        return
    torch._C._cuda_releasePool(idx, pool)


def _host_floats(row: Dict[str, Any]) -> Dict[str, float]:
    """A step's metrics as host floats, its 0-d fp32 device tensors read
    in one copy (the synchronous loop's per-step telemetry read); the
    values are ``float(v)``'s, in the row's key order."""
    dev = [k for k, v in row.items() if isinstance(v, torch.Tensor)
           and v.dtype == torch.float32 and v.dim() == 0]
    got = dict(zip(dev, torch.stack([row[k] for k in dev]).tolist())) \
        if dev else {}
    return {k: got[k] if k in got else float(v) for k, v in row.items()}


def _fmt(metrics: Dict[str, float]) -> str:
    return " ".join(f"{k}={float(v):.4g}" for k, v in sorted(metrics.items()))


class Solver:
    """Train an embedding model with the N-pair loss on one device.

    Args:
      model: an ``nn.Module`` mapping NHWC images to [N, D] embeddings,
        with a ``reset_parameters(seed)``; it stays on its device.
      loss_cfg: mining/margin configuration.
      cfg: solver hyperparameters.
      top_ks: the Recall@k list every step reports.
      param_mults: Caffe's ``((w_lr, w_decay), (b_lr, b_decay))`` recipe.
      loss_weight: the loss top's weight; scales the objective and so
        the gradient.
      engine: ``"dense"`` materializes the N x N pair matrix (over a
        mesh: N x N*G, after an all-gather of the pool);
        ``"blockwise"`` streams it in tiles through the kernels of
        ``ops.blockwise_npair``, for pools too large for the matrix, on
        one device; ``"ring"`` streams the pool around a mesh
        (``parallel.ring``).
      sim_cache: the blockwise engine's fp32 similarity cache (None =
        auto by size).
      pos_topk: the blockwise engine's sparse-positive buffer slots
        (None = 8; 0 forces radix selection).
      snapshot_retry: the backoff around snapshot save and restore I/O
        (None = ``RetryPolicy()``).
      matmul_precision: both engines' gemm precision: None/"highest"
        (full fp32) or "default" (single-pass bf16, a throughput mode).
      precision: a precision policy name ("mxu", "bf16", "fp32_parity")
        or ``PrecisionPolicy``, kept as ``precision_policy``; it supplies
        ``matmul_precision`` (its ``loss_matmul_precision``) when that is
        not given.  The model's dtypes are the model's own
        (``get_model(policy=...)``).
      mesh: a ``parallel.mesh.Mesh``: this process is one of its G
        ranks and trains on its rows of each global batch; None = one
        device.
      health: a ``HealthConfig``: training-health signals in every
        step's metrics (None = none, no op added).  Over a mesh the
        embedding and pair-hardness signals are each rank's, averaged
        with the other metrics (``emb_mag_max`` too: the mean of the
        ranks' maxima); the update signals are of the all-reduced
        gradients.
      telemetry: a ``RunTelemetry`` (rows and host spans; None = off).
      perf_metrics: with ``telemetry``, one ``perf`` row per display
        window with the step's counted FLOPs and MFU.
    """

    def __init__(self, model: torch.nn.Module,
                 loss_cfg: NPairLossConfig = NPairLossConfig(),
                 cfg: Optional[SolverConfig] = None,
                 top_ks: Sequence[int] = (1, 5, 10),
                 param_mults: Optional[Mults] = None,
                 loss_weight: float = 1.0,
                 engine: str = "dense",
                 sim_cache: Optional[bool] = None,
                 pos_topk: Optional[int] = None,
                 snapshot_retry: Optional[RetryPolicy] = None,
                 matmul_precision: Optional[str] = None,
                 precision=None, mesh=None,
                 health: Optional[HealthConfig] = None,
                 telemetry=None, perf_metrics: bool = False):
        if engine not in ("dense", "ring", "blockwise"):
            raise ValueError(f"unknown engine {engine!r}")
        if engine == "ring" and mesh is None:
            raise ValueError('engine="ring" requires a mesh')
        if engine == "blockwise" and mesh is not None:
            raise ValueError(
                'engine="blockwise" is the single-device streaming path; '
                'use engine="ring" to stream across a mesh')
        self.engine = engine
        self.mesh = mesh
        # The EnginePlan the CLI resolved for this run, if any.
        self.engine_plan = None
        if precision is not None:
            from npairloss_tpu_torch.models.precision import get_policy

            self.precision_policy = get_policy(precision)
            if matmul_precision is None:
                matmul_precision = \
                    self.precision_policy.loss_matmul_precision
        else:
            self.precision_policy = None
        resolve_matmul_precision(matmul_precision)
        self.matmul_precision = matmul_precision
        self.sim_cache = sim_cache
        self.pos_topk = pos_topk
        self.model = model
        self.loss_cfg = loss_cfg
        self.top_ks = tuple(top_ks)
        self.loss_weight = float(loss_weight)
        self.device = next(model.parameters()).device
        self.params = dict(model.named_parameters())
        if self._multi():
            from npairloss_tpu_torch.models.layers import sync_batch_norm

            sync_batch_norm(model, mesh)
        self.mults = mult_table(list(self.params), param_mults)
        self.cfg = cfg if cfg is not None else SolverConfig()
        self.snapshot_retry = snapshot_retry
        # A resilience.PreemptionSignal; the loop polls it once a step.
        self.preempt = None
        # A resilience.DivergenceConfig arms the divergence guard.
        self.divergence: Optional[DivergenceConfig] = None
        # A pipeline.HostSyncMonitor for the pipelined loop (None: the
        # NPAIRLOSS_PIPELINE_SYNC_GUARD environment variable decides).
        self.sync_monitor = None
        # An externally requested rollback: any thread sets it through
        # request_rollback, the loop takes it at its next safe point
        # (synchronous: each step; pipelined: the window boundary).
        self._rollback_request: Optional[RollbackRequest] = None
        self._rollback_lock = threading.Lock()
        # The pipelined loop's device state: the captured step
        # (_PipelinedStep), the lr it reads, the metric ring; and the
        # last pipelined run's counters (pipeline_stats).
        self._pipe: Optional[_PipelinedStep] = None
        self._lr_dev: Optional[torch.Tensor] = None
        self._window = None
        self._ring: Optional[Dict[str, torch.Tensor]] = None
        self._side_stream = None
        self.pipeline_stats: Dict[str, Any] = _new_pipeline_stats()
        # Run telemetry (obs): plain attributes, assignable after
        # construction.  A new signature of a step or eval batch is a
        # new key: its first step is spanned step/compile (eval/compile).
        self.health = health
        self.telemetry = telemetry
        self.perf_metrics = bool(perf_metrics)
        self._telemetry_failed = False
        self._seen_step_shapes: set = set()
        self._seen_eval_shapes: set = set()
        # The last counted step (obs.perf.count.StepCounter) and its
        # FLOPs; the previous perf row's (time, step).
        self.step_count = None
        self._step_flops: Optional[float] = None
        self._perf_last: Optional[Tuple[float, int]] = None
        self._last_batch_size: Optional[int] = None
        # Fleet observatory: under fleet-stamped telemetry on a mesh the
        # first step of a key is counted and its collectives priced per
        # kind (rank 0 writes fleet_comms.json for `prof --fleet`);
        # every step then leaves comm/<kind> marks with those bytes.
        # None: to be priced at the next eager step.
        self._comm_kinds: Optional[list] = None
        self._reset_optimizer()

    # -- config (the schedule and the loss window derive from it) ----------

    @property
    def cfg(self) -> SolverConfig:
        return self._cfg

    @cfg.setter
    def cfg(self, cfg: SolverConfig) -> None:
        """A new config rebuilds the lr schedule and the loss window.
        The captured pipelined step reads its lr from a device scalar
        written before each replay, so an lr change needs no re-capture;
        a change to what the graph holds as a constant (momentum, weight
        decay) changes its key, and the next step captures anew."""
        self._cfg = cfg
        self.rate_fn = lr_schedule(
            cfg.lr_policy, cfg.base_lr, cfg.gamma, cfg.stepsize, cfg.power,
            cfg.max_iter, cfg.stepvalues)
        self._loss_window: collections.deque = collections.deque(
            maxlen=max(cfg.average_loss, 1))

    # -- state ------------------------------------------------------------

    def _reset_optimizer(self) -> None:
        """Fresh momentum buffers (new tensors: a captured step that
        held the old ones is dropped) and iteration 0."""
        self.momentum = {n: torch.zeros_like(p, dtype=torch.float32)
                         for n, p in self.params.items()}
        self.iteration = 0
        self._pipe = None

    def init(self, seed: Optional[int] = None) -> None:
        """Fresh weights from a ``torch.Generator`` seeded with ``seed``
        (default ``cfg.random_seed``), zero momentum, iteration 0."""
        self.model.reset_parameters(
            self.cfg.random_seed if seed is None else seed)
        self._reset_optimizer()

    def load_params(self, params: Dict[str, Any],
                    batch_stats: Optional[Dict[str, Any]] = None) -> None:
        """Start from a flax param tree (numpy leaves, bare or wrapped
        with its ``batch_stats``; the finetune workflow, or the JAX
        package's own init in the parity tests).  ``batch_stats`` (BN
        trunks' running mean/var) replace the current ones when given.
        The optimizer re-initializes, as the JAX ``load_params`` does."""
        from npairloss_tpu_torch.models.convert import load_jax_params

        load_jax_params(self.model, params, batch_stats)
        self._reset_optimizer()

    def load_caffe_solverstate(self, path: str,
                               model_name: str = "googlenet") -> int:
        """Resume the optimizer from a Caffe ``.solverstate`` — momentum
        history and iteration, the ``caffe train --snapshot`` semantics
        (``npairloss_tpu/train/solver.py:1770``).  The weights come
        separately (the paired ``.caffemodel`` through ``load_params``),
        so call this after them.  Plain ``googlenet`` only: history blobs
        are unnamed and positional, in the plain trunk's layer order;
        another trunk raises ``NotImplementedError``, as in JAX.  Returns
        the iteration."""
        if model_name.lower() != "googlenet":
            raise NotImplementedError(
                "solverstate migration is defined for the plain "
                f"GoogLeNet trunk only (got model {model_name!r}): "
                "Caffe history blobs are unnamed and positional; resume "
                "with --model googlenet")
        from npairloss_tpu_torch.config.caffemodel import parse_solverstate
        from npairloss_tpu_torch.models.caffe_import import (
            googlenet_momentum_from_history,
        )
        from npairloss_tpu_torch.models.convert import (
            from_jax_params,
            tree_from_state,
        )

        with open(path, "rb") as f:
            st = parse_solverstate(f.read())
        template, _ = tree_from_state(self.momentum, ())
        mom, skipped = googlenet_momentum_from_history(st["history"],
                                                       template)
        if skipped:
            log.info("solverstate: skipped %d non-trunk history blobs "
                     "(aux-classifier params of the full training net)",
                     skipped)
        with torch.no_grad():
            for name, t in from_jax_params(mom).items():
                self.momentum[name].copy_(t)
        self.iteration = int(st["iter"])
        return self.iteration

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The solver's state as one flat name -> tensor dict: the
        model's parameters and buffers (``model/<name>``), the momentum
        buffers (``momentum/<name>``) and ``iteration`` (int64)."""
        out = {f"model/{k}": v for k, v in self.model.state_dict().items()}
        out.update({f"momentum/{n}": m for n, m in self.momentum.items()})
        out["iteration"] = torch.tensor(self.iteration, dtype=torch.int64)
        return out

    def load_state(self, state: Dict[str, torch.Tensor]) -> None:
        """Take over a :meth:`state_dict` (a restored snapshot): the same
        names and shapes, or a ``SnapshotValidationError`` before any
        tensor is touched.  Every tensor is copied in place
        (``load_state_dict``, ``copy_``), so a captured pipelined step
        stays valid across a restore (a rollback)."""
        cur = self.state_dict()
        if set(state) != set(cur):
            missing = sorted(set(cur) - set(state))[:3]
            extra = sorted(set(state) - set(cur))[:3]
            raise SnapshotValidationError(
                f"snapshot does not fit this solver (missing={missing}, "
                f"unexpected={extra})")
        bad = [k for k in cur if tuple(state[k].shape) != tuple(cur[k].shape)]
        if bad:
            raise SnapshotValidationError(
                f"snapshot shapes do not fit this solver: {bad[:3]}")
        self.model.load_state_dict(
            {k[len("model/"):]: v for k, v in state.items()
             if k.startswith("model/")}, strict=True)
        with torch.no_grad():
            for n, buf in self.momentum.items():
                buf.copy_(state[f"momentum/{n}"])
        self.iteration = int(state["iteration"])

    # -- snapshots (the Caffe snapshot contract) -----------------------------

    def snapshot_path(self, step: int) -> str:
        prefix = self.cfg.snapshot_prefix
        os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
        return os.path.abspath(f"{prefix}iter_{step}.ckpt")

    def save_snapshot(self, step: int) -> str:
        """Commit the snapshot for ``step`` atomically (tmp dir +
        checksum manifest + rename), retrying transient I/O under
        ``snapshot_retry``, then apply retention GC
        (``cfg.snapshot_max_keep``)."""
        path = self.snapshot_path(step)

        def on_retry(attempt, delay, exc):
            self._tel_event("retry", step, op="snapshot.save",
                            attempt=attempt, delay_s=round(delay, 3),
                            error=str(exc))

        if self._multi():
            # Every rank holds the same state: rank 0 commits, every
            # rank learns whether it landed (npairloss_tpu solver.py:
            # 1715-1724).
            with self._span("snapshot", step=step):
                commit_snapshot_multi(path, self.state_dict(), step,
                                      primary=self.mesh.is_primary,
                                      agree=self.mesh.agree,
                                      policy=self.snapshot_retry,
                                      on_retry=on_retry)
                if self.mesh.is_primary:
                    gc_snapshots(self.cfg.snapshot_prefix,
                                 self.cfg.snapshot_max_keep)
                self.mesh.barrier()
            log.info("snapshot -> %s", path)
            return path
        with self._span("snapshot", step=step):
            commit_snapshot(path, self.state_dict(), step,
                            policy=self.snapshot_retry, on_retry=on_retry)
        log.info("snapshot -> %s", path)
        gc_snapshots(self.cfg.snapshot_prefix, self.cfg.snapshot_max_keep)
        return path

    def _multi(self) -> bool:
        """A mesh of several processes."""
        return self.mesh is not None and self.mesh.size > 1

    def _load_snapshot(self, path: str) -> Dict[str, torch.Tensor]:
        def do_restore():
            failpoints.fire("snapshot.restore.io")
            return read_state(path, self.device)

        def on_retry(attempt, delay, exc):
            self._tel_event("retry", 0, op="snapshot.restore",
                            attempt=attempt, delay_s=round(delay, 3),
                            error=str(exc))

        return call_with_retry(do_restore, self.snapshot_retry,
                               describe=f"snapshot restore ({path})",
                               on_retry=on_retry)

    def restore_snapshot(self, path: str) -> str:
        """Restore an explicit snapshot path onto the solver's device
        (retrying transient I/O).  A snapshot with a commit manifest is
        checksum-verified against it and raises
        ``SnapshotValidationError`` when corrupt; a manifest-less dir
        restores unverified; a manifest that exists but cannot be read
        is corruption and raises.  Over a mesh a non-zero rank first
        waits for rank 0's manifest."""
        if self._multi() and not self.mesh.is_primary:
            try:
                validate_snapshot_wait(path, self.snapshot_retry)
            except Exception:  # noqa: BLE001 — verdict below, per contract
                pass
        state = self._load_snapshot(path)
        try:
            manifest = read_manifest(path)
        except FileNotFoundError:
            log.info("restored %s without checksum verification "
                     "(no commit manifest)", path)
        except (OSError, ValueError) as e:
            raise SnapshotValidationError(
                f"unreadable manifest in {path}: {e}") from e
        else:
            verify_restored(state, manifest)
        self.load_state(state)
        return path

    def restore_auto(self, max_step: Optional[int] = None) -> Optional[str]:
        """Restore the newest valid snapshot under ``cfg.snapshot_prefix``:
        manifests validated newest first, the restored tensors
        checksum-verified, torn or corrupt candidates skipped with a
        logged reason.  ``max_step`` bounds the candidates.  Returns the
        restored path, or None (a fresh start) when none is valid.  Over
        a mesh a non-zero rank waits for rank 0's manifest instead of
        skipping a snapshot as torn, and every rank must restore the
        same iteration."""
        path = self._restore_auto(max_step)
        if self._multi():
            its = self.mesh.all_gather(torch.tensor(
                [self.iteration], dtype=torch.int64, device=self.device))
            if bool((its != its[0]).any()):
                raise SnapshotValidationError(
                    f"ranks resumed from different iterations: "
                    f"{its.tolist()}")
        return path

    def _restore_auto(self, max_step: Optional[int]) -> Optional[str]:
        prefix = self.cfg.snapshot_prefix
        wait = self._multi() and not self.mesh.is_primary
        for step, path in reversed(list_snapshots(prefix)):
            if max_step is not None and step > max_step:
                continue
            try:
                manifest = (validate_snapshot_wait(path, self.snapshot_retry)
                            if wait else validate_snapshot(path))
                state = self._load_snapshot(path)
                verify_restored(state, manifest)
                self.load_state(state)
            except Exception as e:  # noqa: BLE001 — skip, try the next
                log.warning("resume: skipping snapshot %s: %s", path, e)
                self._tel_event("resume_skip", step, snapshot=path,
                                reason=str(e))
                continue
            log.info("resume: restored %s (iteration %d)", path, step)
            return path
        log.info("resume: no valid snapshot under prefix %r — starting "
                 "fresh", prefix)
        return None


    # -- telemetry ----------------------------------------------------------

    def _span(self, name: str, **args):
        """A telemetry span, or a no-op context when none is attached."""
        if self.telemetry is None:
            return contextlib.nullcontext()
        return self.telemetry.span(name, **args)

    def _tel_log(self, phase: str, step: int, metrics, **extra) -> None:
        """A metric row that can never abort training: a sink failure
        (disk full) is logged once, then rows latch off for the run."""
        tel = self.telemetry
        if tel is None or not tel.metrics_enabled or self._telemetry_failed:
            return
        try:
            tel.log(phase, step, metrics, **extra)
        except Exception as e:  # noqa: BLE001 — telemetry is not the run
            self._telemetry_failed = True
            log.error("telemetry metric emission failed (disabling for the "
                      "rest of the run): %s", e)

    def _tel_event(self, kind: str, step: int, **extra) -> None:
        """A resilience event: one ``event`` row and a
        ``resilience/<kind>`` instant (no-ops without telemetry)."""
        tel = self.telemetry
        if tel is None:
            return
        args = {k: v for k, v in extra.items() if v is not None}
        tel.instant(f"resilience/{kind}", **args)
        self._tel_log("event", step, {"event": kind, **args})

    def _want_perf(self) -> bool:
        tel = self.telemetry
        return (self.perf_metrics and tel is not None
                and tel.metrics_enabled and not self._telemetry_failed)

    def _device_kind(self) -> str:
        if self.device.type == "cuda":
            return torch.cuda.get_device_name(self.device)
        return self.device.type

    def _fleet_stamp(self):
        """The attached telemetry's FleetStamp, or None — every fleet
        hook gates on this, so runs without a fleet keep their trace and
        stream byte for byte."""
        tel = self.telemetry
        return getattr(tel, "fleet", None) if tel is not None else None

    def _step_span_args(self, batch: int, **extra) -> Dict[str, Any]:
        """step/dispatch|compile span args: under a fleet the step
        number too, so the aggregator joins one step's spans across
        ranks."""
        args: Dict[str, Any] = {"batch": batch, **extra}
        if self._fleet_stamp() is not None:
            args["step"] = self.iteration + 1
        return args

    def _comms_due(self) -> bool:
        """True when this step must be counted to price the fleet's
        collectives: fleet telemetry on a mesh, and no pricing of the
        current key yet (also when telemetry was attached after the key
        was first run)."""
        return (self._comm_kinds is None and self.mesh is not None
                and self._fleet_stamp() is not None)

    def _price_comms(self, c) -> None:
        """Fold the counted step's collectives into per-kind rows
        (``obs.fleet.comms``), claim the gradient all-reduce at the
        parameter tree's bytes, and (rank 0) write ``fleet_comms.json``
        for ``prof --fleet``: the JAX package's HLO pricing, from the
        count of a real step instead of a second compile."""
        from npairloss_tpu_torch.obs.fleet import comms as comms_mod
        from npairloss_tpu_torch.obs.fleet.aggregate import COMMS_FILENAME

        stamp = self._fleet_stamp()
        mesh = self.mesh
        with self._span("comm/price"):
            per_kind = comms_mod.per_kind_from_counts(c.collectives)
            param_bytes = float(sum(p.numel() * p.element_size()
                                    for p in self.params.values()))
            extra = (comms_mod.grad_sync_claim_bytes(
                param_bytes, stamp.process_count) if mesh.size > 1 else {})
            link = mesh.backend or ("nccl" if self.device.type == "cuda"
                                    else "gloo")
            payload = {
                "per_kind": per_kind,
                "extra_claims": extra,
                "device_kind": self._device_kind(),
                "link": link,
                "hosts": len(set(mesh.hosts)),
                "batch": self._last_batch_size,
                "engine": self.engine,
                "mesh_devices": int(mesh.size),
            }
            rows = comms_mod.comm_rows_from_counts(per_kind, extra)
            self._comm_kinds = [(k["kind"], k["bytes_per_step"], k["claimed"])
                                for k in rows["kinds"]]
            if stamp.process_index == 0 and self.telemetry is not None:
                path = os.path.join(self.telemetry.run_dir, COMMS_FILENAME)
                tmp = path + f".tmp-{os.getpid()}"
                with open(tmp, "w") as f:
                    json.dump(payload, f)
                os.replace(tmp, path)

    def _emit_comm_marks(self, step_num: int) -> None:
        """Per-step ``comm/<kind>`` instants carrying the priced bytes:
        accounting marks on the timeline, not durations (the host does
        not time a collective; the bandwidth math is offline)."""
        tel = self.telemetry
        if tel is None or not self._comm_kinds:
            return
        for kind, nbytes, claimed in self._comm_kinds:
            tel.instant(f"comm/{kind}", bytes=nbytes, claimed=claimed,
                        step=step_num)

    def _new_step_key(self, x, lab) -> bool:
        """Record the batch signature; True for one not seen before.  A
        new key after the first is marked ``step/recompile``."""
        sig = (tuple(x.shape), tuple(lab.shape))
        new = sig not in self._seen_step_shapes
        self._seen_step_shapes.add(sig)
        self._last_batch_size = int(x.shape[0])
        if new and len(self._seen_step_shapes) > 1 \
                and self.telemetry is not None:
            self.telemetry.instant("step/recompile", batch=int(x.shape[0]))
        return new

    def _counted(self, body: Callable, *args):
        """``body(*args)`` counted (``obs.perf.count``) inside a
        ``step/cost_analysis`` span: the step's FLOPs for the perf rows
        and, when due, the fleet's collective pricing.  The counted step
        is a real step of the run, bit for bit."""
        with self._span("step/cost_analysis"):
            with count.StepCounter() as c:
                out = body(*args)
        self.step_count = c
        self._step_flops = float(c.flops)
        if self._comms_due():
            self._price_comms(c)
        return out

    def _emit_perf_row(self, step_num: int) -> None:
        """One ``perf`` row per display window: wall clock between
        boundary emissions over the steps they cover (in both loops:
        the pipelined window's deferred emission still spans the
        window's dispatched steps)."""
        from npairloss_tpu_torch.obs.perf.costs import mfu_from_timing

        now = time.perf_counter()
        prev = self._perf_last
        self._perf_last = (now, step_num)
        if prev is None:
            return
        t0, s0 = prev
        steps_n = step_num - s0
        if steps_n <= 0 or now <= t0:
            return
        sec = (now - t0) / steps_n
        row: Dict[str, Any] = {"ms_per_step": round(sec * 1e3, 3)}
        if self._last_batch_size:
            row["emb_per_sec"] = round(self._last_batch_size / sec, 1)
        est = mfu_from_timing(flops=self._step_flops, seconds=sec, steps=1,
                              device_kind=self._device_kind())
        if est["mfu"] is not None:
            row["mfu"] = round(est["mfu"], 4)
        if self._step_flops is not None:
            row["step_flops"] = self._step_flops
        self._tel_log("perf", step_num, row)

    def _flush_telemetry(self) -> None:
        """Land metrics.jsonl and trace.json at every exit of a loop
        (the owner may keep logging; flush is idempotent)."""
        if self.telemetry is not None:
            try:
                self.telemetry.flush()
            except Exception as e:  # noqa: BLE001
                log.error("telemetry flush failed: %s", e)

    # -- one step -----------------------------------------------------------

    def _put(self, inputs, labels):
        """The batch on the solver's device (``device.upload``): host
        arrays go up from pinned memory asynchronously; a loader's
        tensors already on the device stay as they are."""
        return (_device.upload(inputs, self.device),
                _device.upload(labels, self.device))

    def compute_loss(self, emb: torch.Tensor, labels: torch.Tensor):
        """(objective, metrics): the N-pair loss through the configured
        engine, scaled by ``loss_weight``, and the metric tops — from the
        dense engine's detached aux, or streamed over the detached
        embedding for the blockwise engine.  Over a mesh: this rank's
        loss over the mesh's pool and its metrics (the ring's without
        its pair counts, as in JAX); :meth:`_reported` averages them
        over the ranks.  With ``health.pair_hardness`` the dense engine
        adds its mined-pair summaries (the streaming engines have no
        pair matrix to read them from, as in JAX).  The loss, forward
        and backward, counts in region ``npair`` (``obs.perf.count``)."""
        if self.mesh is not None:
            loss, metrics = self._sharded_loss(emb, labels)
        elif self.engine == "blockwise":
            with count.scope("npair", (emb,)) as region:
                loss, _ = blockwise_npair_loss_with_aux(
                    emb, labels, self.loss_cfg, sim_cache=self.sim_cache,
                    pos_topk=self.pos_topk,
                    matmul_precision=self.matmul_precision)
                region.outputs(loss)
            metrics = blockwise_retrieval_metrics(emb.detach(), labels,
                                                  self.top_ks)
        else:
            with count.scope("npair", (emb,)) as region:
                loss, aux = npair_loss_with_aux(
                    emb, labels, self.loss_cfg,
                    matmul_precision=self.matmul_precision)
                region.outputs(loss)
            metrics = self._dense_metrics(aux, labels, emb)
        if self.loss_weight != 1.0:
            loss = loss * float(np.float32(self.loss_weight))
        return loss, metrics

    def _dense_metrics(self, aux, labels, emb) -> Dict[str, Any]:
        """The dense engine's metric tops, with the pair-hardness health
        summaries of its aux when ``health.pair_hardness`` is on."""
        metrics = retrieval_metrics(aux, labels, emb.detach(), self.top_ks)
        if self.health is not None and self.health.pair_hardness:
            with count.scope("health"):
                metrics.update(pair_hardness_health(
                    aux, mining=self.health.mining_health))
        return metrics

    def _sharded_loss(self, emb: torch.Tensor, labels: torch.Tensor):
        from npairloss_tpu_torch.parallel.mesh import sharded_npair_loss_fn

        if self.engine == "ring":
            from npairloss_tpu_torch.parallel.ring import (
                ring_npair_loss_and_metrics,
            )

            with count.scope("npair", (emb,)) as region:
                loss, metrics = ring_npair_loss_and_metrics(
                    emb, labels, self.loss_cfg, self.mesh, self.top_ks,
                    sim_cache=self.sim_cache, pos_topk=self.pos_topk,
                    matmul_precision=self.matmul_precision)
                region.outputs(loss)
            return loss, {k: v for k, v in metrics.items()
                          if k not in ("ident_num", "diff_num")}
        with count.scope("npair", (emb,)) as region:
            loss, aux = sharded_npair_loss_fn(
                self.mesh, self.loss_cfg,
                matmul_precision=self.matmul_precision)(emb, labels)
            region.outputs(loss)
        return loss, self._dense_metrics(aux, labels, emb)

    def _reported(self, loss: torch.Tensor,
                  metrics: Dict[str, Any]) -> Dict[str, Any]:
        """The step's metrics with ``loss``; over a mesh of G > 1 the
        mean over the ranks (JAX ``stacked.mean()``), the same on every
        rank."""
        out = dict(metrics)
        out["loss"] = loss.detach()
        if not self._multi():
            return out
        keys = sorted(out)
        per_rank = self.mesh.all_gather(torch.stack(
            [out[k].detach().float().reshape(()) for k in keys])[None])
        mean = per_rank.mean(dim=0)
        return {k: mean[i] for i, k in enumerate(keys)}

    def _sync_grads(self) -> None:
        """Over a mesh of G > 1: every parameter's gradient becomes the
        mean over the ranks (one all-reduce of the flattened gradients,
        the same bits on every rank, then 1/G).  Each
        rank back-propagated its own loss; JAX differentiates the mean
        of the G losses, so the sum over ranks is G times its gradient."""
        if not self._multi():
            return
        mesh = self.mesh
        ps = list(self.params.values())
        flat = torch.cat([
            (p.grad if p.grad is not None else torch.zeros_like(p))
            .reshape(-1).float() for p in ps])
        total = mesh.all_reduce_sum(flat) / float(mesh.size)
        off = 0
        for p in ps:
            n = p.numel()
            p.grad = total[off:off + n].view_as(p).to(p.dtype)
            off += n

    def _train_body(self, x, lab, lr) -> Dict[str, Any]:
        """Forward, loss, backward and the Caffe SGD update at ``lr`` (a
        host float, or the pipelined step's device scalar); the step's
        metrics, sorted as a jitted JAX step returns its dict.  Both
        loops run this body, so they compute the same bits.  With
        ``health``: the embedding magnitude, the pre-update parameter
        norm, and after the update the gradient norm and the update's
        (the new Caffe history: the parameter change) — device
        reductions, no host read."""
        hcfg = self.health
        self.model.train()
        for p in self.params.values():
            p.grad = None
        emb = self.model(x)
        loss, metrics = self.compute_loss(emb, lab)
        if hcfg is not None and hcfg.embedding_magnitude:
            with count.scope("health"):
                metrics.update(embedding_health(emb))
        loss.backward()
        self._sync_grads()
        metrics = self._reported(loss, metrics)
        metrics["lr"] = lr
        pnorm = None
        if hcfg is not None and (hcfg.param_norm or hcfg.update_ratio):
            with count.scope("health"):
                pnorm = tree_l2_norm(self.params.values())
        grads = {n: p.grad for n, p in self.params.items()}
        caffe_sgd(self.params, grads, self.momentum, lr, self.cfg.momentum,
                  self.cfg.weight_decay, self.mults)
        if hcfg is not None:
            with count.scope("health"):
                metrics.update(update_health(
                    [g if g is not None else torch.zeros_like(p)
                     for g, p in zip(grads.values(), self.params.values())],
                    None, self.momentum.values(), hcfg, param_norm=pnorm))
        return dict(sorted(metrics.items()))

    def step(self, inputs, labels) -> Dict[str, Any]:
        """One training iteration; returns the step's metrics (device
        tensors, and the applied lr as a float).  Spanned
        ``step/compile`` (a new batch signature) or ``step/dispatch``;
        a new signature's step is counted when perf rows are on."""
        x, lab = self._put(inputs, labels)
        new = self._new_step_key(x, lab)
        if new:
            # A new batch signature has new collective payloads.
            self._comm_kinds = None
        lr = self.rate_fn(self.iteration)
        with self._span("step/compile" if new else "step/dispatch",
                        **self._step_span_args(int(x.shape[0]))):
            if (new and self._want_perf()) or self._comms_due():
                metrics = self._counted(self._train_body, x, lab, lr)
            else:
                metrics = self._train_body(x, lab, lr)
        self.iteration += 1
        self._emit_comm_marks(self.iteration)
        if debug_checks_enabled():
            # utils.debug: every step's scalars checked on the host, where
            # the JAX step checks them (before the loop's step.nan_loss
            # poison, which only the observed row sees).
            assert_all_finite(metrics, "step metrics")
        return metrics

    @torch.no_grad()
    def evaluate(self, batches: Batches, num_iters: int) -> Dict[str, float]:
        """TEST phase: loss and metrics averaged over ``num_iters``
        batches (a forward without a graph in eval mode: the stem runs
        its uncached kernels, a BN trunk its running statistics)."""
        self.model.eval()
        acc: Dict[str, float] = collections.defaultdict(float)
        n = 0
        with self._span("eval", num_iters=num_iters):
            for _ in range(num_iters):
                x, lab = self._put(*next(batches))
                sig = (tuple(x.shape), tuple(lab.shape))
                new = sig not in self._seen_eval_shapes
                self._seen_eval_shapes.add(sig)
                with (self._span("eval/compile", batch=int(x.shape[0]))
                      if new else contextlib.nullcontext()):
                    loss, metrics = self.compute_loss(self.model(x), lab)
                    metrics = self._reported(loss, metrics)
                for k, v in sorted(metrics.items()):
                    acc[k] += float(v)
                n += 1
        out = {k: v / max(n, 1) for k, v in acc.items()}
        if n:
            self._tel_log("eval", self.iteration, out, eval_batches=n)
        return out

    # -- the loop -------------------------------------------------------------

    def train(self, train_batches: Batches, num_iters: Optional[int] = None,
              test_batches: Optional[Batches] = None,
              log_fn: Callable[[str], None] = log.info,
              record_fn: Optional[Callable[[Dict[str, Any]], None]] = None,
              ) -> Dict[str, float]:
        """The Caffe Solver::Solve loop.  ``num_iters`` is the TOTAL
        iteration target (``max_iter``): a solver restored at iteration k
        runs ``num_iters - k`` more steps, every cadence aligned.
        ``record_fn`` gets one dict per display/test/snapshot/rollback/
        preempt event — the ``--log-json`` stream."""
        cfg = self.cfg
        num_iters = num_iters if num_iters is not None else cfg.max_iter
        if cfg.compile_cache:
            from npairloss_tpu_torch.pipeline import enable_compile_cache

            enable_compile_cache(cfg.compile_cache)
        if cfg.pipeline:
            try:
                return self._train_pipelined(train_batches, num_iters,
                                             test_batches, log_fn, record_fn)
            finally:
                self._flush_telemetry()
        try:
            return self._train_sync(train_batches, num_iters, test_batches,
                                    log_fn, record_fn)
        finally:
            self._flush_telemetry()

    def _train_sync(self, train_batches, num_iters, test_batches, log_fn,
                    record_fn) -> Dict[str, float]:
        it = self._train_prologue(num_iters, test_batches, log_fn,
                                  record_fn)
        guard = (DivergenceGuard(self.divergence)
                 if self.divergence is not None else None)
        last: Dict[str, Any] = {}
        while it < num_iters:
            with self._span("data/next_batch"):
                batch = next(train_batches)
            # With telemetry rows each step's metrics are read on the
            # host below (_emit_step_row): one sync a step, the cost
            # the JAX package documents; spans alone read nothing.
            metrics = self.step(*batch)
            step_num = it + 1
            if failpoints.should_fire("step.nan_loss"):
                # The observed loss only; the state is untouched.
                metrics = dict(metrics)
                metrics["loss"] = torch.full((), float("nan"),
                                             device=self.device)
            self._loss_window.append(metrics["loss"])
            last = metrics
            # The guard reads each step's loss on the host: the one
            # sync a step it costs when armed.
            if guard is not None and guard.observe(float(metrics["loss"])):
                it = self._handle_divergence(guard, step_num, log_fn,
                                             record_fn)
                continue
            req = self._take_rollback_request()
            if req is not None:
                rolled = self._handle_requested_rollback(
                    req, step_num, log_fn, record_fn)
                if rolled is not None:
                    it = rolled
                    continue
            self._emit_step_row(step_num, metrics, log_fn, record_fn)
            self._boundary_actions(step_num, test_batches, log_fn, record_fn)
            it = step_num
        return {k: float(v) for k, v in last.items()}

    def _train_prologue(self, num_iters, test_batches, log_fn,
                        record_fn) -> int:
        """Shared entry of both loops: the resume lines and the
        iteration-0 TEST pass.  Returns the start iteration."""
        cfg = self.cfg
        it = self.iteration
        if it:
            log_fn(f"resuming from iteration {it}")
            if it >= num_iters:
                log_fn(f"nothing to do: restored iteration {it} >= target "
                       f"{num_iters} (num_iters is the TOTAL max_iter "
                       "target, not an increment)")
        if (it == 0 and cfg.test_initialization and test_batches is not None
                and cfg.test_iter > 0):
            self._test(0, test_batches, log_fn, record_fn)
        return it

    def _emit_step_row(self, step_num: int, row, log_fn=None,
                       record_fn=None) -> None:
        """Per-step emission after the guard — the display line and
        record — shared by the synchronous loop, the pipelined window
        replay and the pending-window flush, so the two loops' streams
        agree by construction.  ``log_fn=None`` (the flush) skips the
        display; a pending tail never holds a display step (boundary
        steps flush in the loop)."""
        if failpoints.should_fire("train.collapse"):
            # A degenerate embedding-collapse signal in THIS row only:
            # the telemetry and the display see a collapsing space, the
            # state is untouched.
            row = {**row, "an_threshold_mean": 1.0}
        cfg = self.cfg
        display = bool(cfg.display) and step_num % cfg.display == 0
        tel = self.telemetry
        if tel is not None and tel.metrics_enabled \
                and not self._telemetry_failed:
            extra: Dict[str, Any] = {}
            if display and tel.tracer is not None and tel.tracer.dropped:
                # The tracer's cap is eating spans: say so in the
                # display row (absent otherwise, so streams stay equal).
                extra["spans_dropped"] = tel.tracer.dropped
            self._tel_log("train", step_num, _host_floats(row), **extra)
        if display and self._want_perf():
            # A pending-window flush never holds a display step, so the
            # log_fn=None path never reaches here.
            self._emit_perf_row(step_num)
        if log_fn is not None and display:
            self._display(step_num, row, log_fn, record_fn)

    def _boundary_actions(self, step_num, test_batches, log_fn,
                          record_fn) -> None:
        """The test/snapshot/preempt cadence after a step (the pipelined
        loop runs it at window boundaries, which those cadences force).
        On a requested preemption: an emergency snapshot (unless the
        cadence just took one), then ``TrainingPreempted``, which the
        CLI maps to ``EXIT_PREEMPTED`` for the supervisor."""
        cfg = self.cfg
        if (test_batches is not None and cfg.test_interval
                and step_num % cfg.test_interval == 0):
            self._test(step_num, test_batches, log_fn, record_fn)
        snapped = None
        if cfg.snapshot and step_num % cfg.snapshot == 0:
            snapped = self.save_snapshot(step_num)
            if record_fn is not None:
                record_fn({"event": "snapshot", "iteration": step_num})
        if self._stop_requested():
            path = snapped or self.save_snapshot(step_num)
            log_fn(f"preempted at iter {step_num}: emergency snapshot "
                   f"{path}; relaunch with --resume auto")
            self._tel_event("preempt", step_num, snapshot=path,
                            signum=self.preempt.signum)
            if record_fn is not None:
                record_fn({"event": "preempt", "iteration": step_num,
                           "snapshot": path})
            raise TrainingPreempted(step_num, snapshot_path=path,
                                    signum=self.preempt.signum)

    def _stop_requested(self) -> bool:
        """Whether a preemption was requested; over a mesh, on any rank
        (every rank then stops at the same step)."""
        if self.preempt is None:
            return False
        if self._multi():
            return self.mesh.any(self.preempt.requested)
        return self.preempt.requested

    def _loss_avg(self) -> float:
        """The loss window's mean, taken on the host in fp32 whichever
        loop filled it (device losses come over in one copy), so both
        loops print the same bits."""
        vals = list(self._loss_window)
        if len({v.device for v in vals}) == 1:
            host = torch.stack(vals).to("cpu", torch.float32)
        else:
            host = torch.stack([v.to("cpu", torch.float32) for v in vals])
        return float(host.mean())

    def _display(self, step_num, metrics, log_fn, record_fn) -> None:
        host = {k: float(v) for k, v in metrics.items()}
        avg = self._loss_avg()
        log_fn(f"iter {step_num} lr={host.get('lr', 0):.6g} "
               f"loss={avg:.6g} (avg over {len(self._loss_window)}) "
               + _fmt({k: v for k, v in host.items()
                       if k not in ("loss", "lr")}))
        if record_fn is not None:
            record_fn({"event": "display", "iteration": step_num,
                       "loss_avg": avg, **host})

    def _test(self, step_num, test_batches, log_fn, record_fn) -> None:
        m = self.evaluate(test_batches, self.cfg.test_iter)
        log_fn(f"iter {step_num} TEST {_fmt(m)}")
        if record_fn is not None:
            record_fn({"event": "test", "iteration": step_num, **m})

    # -- the pipelined loop ---------------------------------------------------

    def _pipeline_window_capacity(self, test_active: bool) -> int:
        """Steps between host reads: the smallest active cadence (a
        window read happens AT every display/test/snapshot step, so the
        ring never spans more than the smallest gap), capped by
        ``cfg.pipeline_window``; 64 when no cadence is active."""
        cfg = self.cfg
        cads = [c for c in (
            cfg.display,
            cfg.test_interval if test_active else 0,
            cfg.snapshot,
        ) if c]
        cap = min(cads) if cads else 0
        user = int(cfg.pipeline_window or 0)
        if user:
            cap = min(cap, user) if cap else user
        return max(int(cap) if cap else 64, 1)

    def _stage_batch(self, inputs, labels):
        """Device placement on the prefetcher's STAGING THREAD (on its
        own stream): ``device.upload`` of both halves, as ``_put``
        places a synchronous step's batch."""
        return (_device.upload(inputs, self.device),
                _device.upload(labels, self.device))

    def _pipe_key(self, x, lab, capacity: int) -> tuple:
        """What a captured step holds fixed: the batch's shapes and
        dtypes, the engine and its options, the ring's capacity, and the
        update's constants.  A step whose key differs captures anew."""
        cfg = self.cfg
        return (tuple(x.shape), x.dtype, tuple(lab.shape), lab.dtype,
                self.engine, self.sim_cache, self.pos_topk,
                self.matmul_precision, self.loss_cfg, self.top_ks,
                self.loss_weight, capacity, cfg.momentum, cfg.weight_decay)

    def _pipelined_body(self, x, lab, capacity: int) -> None:
        """One pipelined step on the static batch: the synchronous
        body at the device lr, then the metrics into the ring.  The
        first step of a key builds the window from the step's sorted
        metric names (an eager step: warm-up runs before any capture)."""
        metrics = self._train_body(x, lab, self._lr_dev)
        if self._window is None or self._window.keys != tuple(metrics):
            from npairloss_tpu_torch.pipeline import MetricWindow

            self._window = MetricWindow(tuple(metrics), capacity)
            self._ring = self._window.init_ring(self.device)
        self._window.update(self._ring, metrics)

    def _pipelined_step(self, x, lab, capacity: int,
                        guard: Callable = contextlib.nullcontext) -> None:
        """Dispatch one pipelined step on the staged batch ``(x, lab)``:
        copy it into the step's static input, write the lr, then run the
        step — eagerly on the CPU; on a card eagerly on a side stream
        for the first ``PIPELINE_WARMUP_STEPS`` steps of a key, then
        captured once and replayed.  ``guard`` wraps the steady-state
        dispatch (the sync monitor's strict region); warm-up and capture
        are set-up and stay outside it.  A key's set-up steps (on the
        CPU its first step) are spanned ``step/compile``, the rest
        ``step/dispatch``; with perf rows on, the key's first eager step
        is counted (never a capture)."""
        stats = self.pipeline_stats
        key = self._pipe_key(x, lab, capacity)
        p = self._pipe
        if p is None or p.key != key:
            p = self._pipe = _PipelinedStep(key, x, lab)
            # A new captured graph has new collective payloads.
            self._comm_kinds = None
        self._new_step_key(x, lab)
        if self._lr_dev is None or self._lr_dev.device != self.device:
            self._lr_dev = torch.zeros((), dtype=torch.float32,
                                       device=self.device)
        cuda = self.device.type == "cuda"
        steady = p.graph is not None or not cuda
        setup = p.graph is None if cuda else p.eager_steps == 0
        eager = not cuda or (p.graph is None
                             and p.eager_steps < PIPELINE_WARMUP_STEPS)
        count_it = eager and ((p.eager_steps == 0 and self._want_perf())
                              or self._comms_due())
        span = self._step_span_args(int(x.shape[0]), pipeline=True)
        if setup and cuda:
            span["capture"] = True
        with self._span("step/compile" if setup else "step/dispatch",
                        **span), \
                (guard() if steady else contextlib.nullcontext()):
            with torch.no_grad():
                p.x.copy_(x)
                p.lab.copy_(lab)
                self._lr_dev.fill_(self.rate_fn(self.iteration))
            if not cuda:
                if count_it:
                    self._counted(self._pipelined_body, p.x, p.lab,
                                  capacity)
                else:
                    self._pipelined_body(p.x, p.lab, capacity)
                p.eager_steps += 1
                stats["eager_steps"] += 1
            elif p.graph is None and p.eager_steps < PIPELINE_WARMUP_STEPS:
                self._warmup_step(p, capacity, count_it)
                stats["eager_steps"] += 1
            else:
                if p.graph is None:
                    self._capture(p, capacity)
                p.graph.replay()
                _build.add_counters(p.delta)
                stats["replays"] += 1
        self.iteration += 1
        self._emit_comm_marks(self.iteration)

    def _warmup_step(self, p, capacity: int, counted: bool = False) -> None:
        """An eager step on a side stream (the CUDA-graph warm-up);
        ``counted``: under the step counter."""
        cur = torch.cuda.current_stream(self.device)
        if self._side_stream is None:
            self._side_stream = torch.cuda.Stream(self.device)
        side = self._side_stream
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            if counted:
                self._counted(self._pipelined_body, p.x, p.lab, capacity)
            else:
                self._pipelined_body(p.x, p.lab, capacity)
        cur.wait_stream(side)
        p.eager_steps += 1

    def _capture(self, p, capacity: int) -> None:
        """Capture the pipelined step as one CUDA graph.  The capture
        executes nothing, so the caller replays it for this step.  Each
        kernel wrapper's counters moved once during the capture: that
        change is taken back out and kept as the graph's launches per
        replay (``_build.add_counters``)."""
        dev = self.device
        for q in self.params.values():
            q.grad = None
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved(dev)
        before = _build.counter_state()
        graph = torch.cuda.CUDAGraph()
        # The graph's own pool, named here so that a failed capture can
        # give it back (_abandon_capture).
        pool = torch.cuda.graph_pool_handle()
        t0 = time.perf_counter()
        try:
            # thread_local: the staging thread's copies and allocations
            # on its own stream stay legal while this thread captures.
            with torch.cuda.graph(graph, pool=pool,
                                  capture_error_mode="thread_local"):
                self._pipelined_body(p.x, p.lab, capacity)
        except Exception as e:
            _abandon_capture(dev, pool)
            raise PipelineCaptureError(
                f"the pipelined step ({self.engine} engine, batch "
                f"{tuple(p.x.shape)}) cannot be captured as one CUDA "
                f"graph: {_first_failure(e)}") from e
        after = _build.counter_state()
        p.delta = {k: n - before.get(k, 0) for k, n in after.items()
                   if n != before.get(k, 0)}
        _build.add_counters(p.delta, times=-1)
        p.graph = graph
        stats = self.pipeline_stats
        stats["captures"] += 1
        stats["capture_ms"].append((time.perf_counter() - t0) * 1e3)
        stats["pool_bytes"].append(torch.cuda.memory_reserved(dev)
                                   - reserved0)
        stats["launches_per_replay"] = {
            f"{fn.__name__}:{a}": n for (fn, a), n in p.delta.items()}

    def _clear_ring(self) -> None:
        """A fresh ring in place (a rollback, a new run), streak too."""
        if self._ring is not None:
            self._window.reset(self._ring)
            self._ring["streak"].zero_()
            self._ring["max_streak"].zero_()

    def _train_pipelined(self, train_batches, num_iters, test_batches,
                         log_fn, record_fn) -> Dict[str, float]:
        """The sync-free counterpart of the loop in :meth:`train`.

        Steady state makes no host transfer on the training thread:
        batches arrive staged from the prefetcher's thread, the step
        writes its scalars into the device-side ring, and the host reads
        the whole window back in one copy only at display/test/snapshot
        boundaries.  Per-step records (the loss window, display lines,
        the divergence guard's observations) are rebuilt from the ring
        at the boundary with the synchronous loop's keys and values —
        only their emission is deferred, by at most
        ``_pipeline_window_capacity()`` steps.  At most
        ``cfg.pipeline_depth`` dispatched steps are in flight.
        """
        from npairloss_tpu_torch.pipeline import (
            DevicePrefetcher,
            DispatchController,
            monitor_from_env,
        )
        from npairloss_tpu_torch.pipeline.controller import step_token

        cfg = self.cfg
        if self.mesh is not None and self.device.type == "cuda":
            raise ValueError(
                "--pipeline over a mesh on a card is not ported (ROADMAP "
                "Queue 1, entry '--pipeline over a mesh on a card'): a "
                "graph that captures collectives cannot be checked on a "
                "one-card machine, and gloo's cannot be captured")
        start = self._train_prologue(num_iters, test_batches, log_fn,
                                     record_fn)
        guard = (DivergenceGuard(self.divergence)
                 if self.divergence is not None else None)
        mon = (self.sync_monitor if self.sync_monitor is not None
               else monitor_from_env())

        def allowed():
            return (mon.allowed() if mon is not None
                    else contextlib.nullcontext())

        def dispatch_guard():
            return (mon.dispatch_guard(self.device) if mon is not None
                    else contextlib.nullcontext())

        depth = max(int(cfg.pipeline_depth), 1)
        window_cap = self._pipeline_window_capacity(test_batches is not None)
        if self._window is not None and self._window.capacity != window_cap:
            # A new ring: a step captured with the old one is dropped.
            self._window = self._ring = self._pipe = None
        self._clear_ring()
        self.pipeline_stats = _new_pipeline_stats()
        controller = DispatchController(depth)
        prefetcher = DevicePrefetcher(train_batches, self._stage_batch,
                                      depth=depth, device=self.device,
                                      span=(self._span if self.telemetry
                                            is not None else None))
        last: Dict[str, Any] = {}
        it = start
        window_start = it + 1
        poisoned: list = []  # step.nan_loss fires, host-side
        try:
            with (mon if mon is not None else contextlib.nullcontext()):
                while it < num_iters:
                    with self._span("data/next_batch", staged=True):
                        x, lab = prefetcher.get()
                    controller.reserve()
                    self._pipelined_step(x, lab, window_cap, dispatch_guard)
                    controller.admit(step_token(self.device))
                    del x, lab
                    step_num = it + 1
                    if failpoints.should_fire("step.nan_loss"):
                        # The synchronous loop poisons the OBSERVED loss
                        # (state untouched); here the observation lives
                        # in the ring, so remember the step and poison
                        # its row when the window is read.
                        poisoned.append(step_num)
                    it = step_num
                    preempt_now = self._stop_requested()
                    boundary = (
                        (cfg.display and step_num % cfg.display == 0)
                        or (test_batches is not None and cfg.test_interval
                            and step_num % cfg.test_interval == 0)
                        or (cfg.snapshot and step_num % cfg.snapshot == 0)
                        or (step_num - window_start + 1 >= window_cap)
                        or step_num >= num_iters
                        or preempt_now
                    )
                    if not boundary:
                        continue
                    # ---- window boundary: the ONE host read ----------
                    with allowed():
                        with self._span("step/window_sync",
                                        steps=step_num - window_start + 1):
                            host_ring = self._window.fetch(self._ring)
                            self._window.reset(self._ring)
                        rows = self._window.read(host_ring)
                        for s in poisoned:
                            rows[s - window_start]["loss"] = \
                                np.float32("nan")
                        # The device counter is the window-edge trip
                        # check: max_streak == 0 proves every loss in
                        # (or carried into) this window was finite, so
                        # the guard's replay can be skipped.  Host-side
                        # poison is invisible to it, hence ``poisoned``;
                        # and guard.streak, so an all-finite window
                        # still replays to RESET a streak in flight.
                        nonfinite_seen = bool(poisoned) or \
                            host_ring["max_streak"] > 0 or \
                            (guard is not None and guard.streak > 0)
                        tripped = None
                        for off, row in enumerate(rows):
                            s = window_start + off
                            self._loss_window.append(
                                torch.tensor(row["loss"]))
                            last = row
                            if guard is not None and nonfinite_seen and \
                                    guard.observe(float(row["loss"])):
                                tripped = s
                                break
                            self._emit_step_row(s, row, log_fn, record_fn)
                        if tripped is not None:
                            # The steps dispatched past the trip are
                            # discarded (the bounded-staleness cost).
                            controller.drain()
                            it = self._handle_divergence(
                                guard, tripped, log_fn, record_fn)
                            self._clear_ring()
                            window_start = it + 1
                            poisoned = []
                            continue
                        req = self._take_rollback_request()
                        if req is not None:
                            controller.drain()
                            rolled = self._handle_requested_rollback(
                                req, step_num, log_fn, record_fn)
                            if rolled is not None:
                                it = rolled
                                self._clear_ring()
                                window_start = it + 1
                                poisoned = []
                                continue
                        self._boundary_actions(step_num, test_batches,
                                               log_fn, record_fn)
                    window_start = step_num + 1
                    poisoned = []
        finally:
            prefetcher.close()
            last = self._flush_pending_window(window_start, poisoned, last)
            self.pipeline_stats.update(blocked=controller.blocked,
                                       staged=prefetcher.staged,
                                       consumed=prefetcher.consumed)
        return {k: float(v) for k, v in last.items()}

    def _flush_pending_window(self, window_start: int, poisoned, last):
        """Salvage the unread tail of a window on an abnormal exit (data
        exhaustion, a staging error, a raised step error): the
        synchronous loop would already have taken these rows.  Boundary
        steps always flush in the loop, so a pending tail never holds a
        display/test/snapshot step: the loss window is the whole debt.
        Best-effort — teardown must not mask the in-flight exception."""
        if self._ring is None or self._window is None:
            return last
        try:
            rows = self._window.read(self._window.fetch(self._ring))
            self._window.reset(self._ring)
            for s in poisoned:
                if 0 <= s - window_start < len(rows):
                    rows[s - window_start]["loss"] = np.float32("nan")
            for off, row in enumerate(rows):
                self._loss_window.append(torch.tensor(row["loss"]))
                last = row
                self._emit_step_row(window_start + off, row)
        except Exception as e:  # noqa: BLE001
            log.error("pending-window flush failed: %s", e)
        return last

    # -- the divergence guard and requested rollbacks -------------------------

    def _handle_divergence(self, guard: DivergenceGuard, step_num: int,
                           log_fn, record_fn) -> int:
        """The guard tripped at ``step_num``: roll back to the newest
        valid snapshot (optionally lr-scaled) or halt.  Returns the
        iteration to continue from."""
        dcfg = self.divergence
        reason = (f"{guard.streak} consecutive non-finite losses "
                  f"at iteration {step_num}")
        if dcfg.action != "rollback" or guard.rollbacks >= dcfg.max_rollbacks:
            why = (reason if dcfg.action != "rollback"
                   else f"{reason} (rollback budget "
                        f"{dcfg.max_rollbacks} exhausted)")
            self._tel_event("divergence_halt", step_num, reason=why)
            raise DivergenceError(f"training diverged: {why}")
        guard.rollbacks += 1
        # A snapshot taken during the non-finite streak holds poisoned
        # params — and so may the one right before it: the first NaN
        # loss at step f implicates the update of step f-1.  Only
        # snapshots strictly older than f-1 are rollback targets.
        max_step = step_num - guard.streak - 1
        guard.streak = 0
        restored = self.restore_auto(max_step=max_step)
        if restored is None:
            raise DivergenceError(
                f"training diverged ({reason}) and no valid snapshot "
                f"at iteration <= {max_step} under "
                f"{self.cfg.snapshot_prefix!r} to roll back to")
        # The excluded snapshots are checksum-valid but NaN-poisoned: a
        # later --resume auto must not restore them.
        if not self._multi() or self.mesh.is_primary:
            quarantine_snapshots(self.cfg.snapshot_prefix, max_step)
        if self._multi():
            self.mesh.barrier()
        resumed = self._post_restore(dcfg.lr_scale)
        msg = (f"divergence: {reason}; rolled back to iteration {resumed} "
               f"({restored}), lr={self.cfg.base_lr:.6g} "
               f"[rollback {guard.rollbacks}/{dcfg.max_rollbacks}]")
        log.warning(msg)
        log_fn(msg)
        self._tel_event("rollback", step_num, to_iteration=resumed,
                        snapshot=restored, base_lr=float(self.cfg.base_lr),
                        rollback=guard.rollbacks)
        if record_fn is not None:
            record_fn({"event": "rollback", "iteration": step_num,
                       "to_iteration": resumed, "snapshot": restored})
        return resumed

    def _post_restore(self, lr_scale: float) -> int:
        """Shared tail of both rollback paths: an lr damp rebuilds the
        schedule (and the loss window, through the cfg setter); with the
        cfg unchanged, the poisoned loss window is cleared by hand.
        Returns the restored iteration."""
        if lr_scale != 1.0:
            self.cfg = dataclasses.replace(
                self.cfg, base_lr=self.cfg.base_lr * lr_scale)
        else:
            self._loss_window.clear()
        return self.iteration

    def request_rollback(self, request: RollbackRequest) -> None:
        """Ask the train loop to roll back at its next safe point.
        Thread-safe; a second request before the first is taken
        replaces it (the newer context wins).  Not over a mesh of several
        processes, where one rank's request would split the ranks."""
        if self._multi():
            raise NotImplementedError(
                "requested rollbacks over a mesh of several processes are "
                "not ported (ROADMAP Queue 1, entry 'requested rollbacks "
                "over a mesh')")
        with self._rollback_lock:
            self._rollback_request = request

    def _take_rollback_request(self) -> Optional[RollbackRequest]:
        if self._rollback_request is None:  # cheap pre-check, hot path
            return None
        with self._rollback_lock:
            req, self._rollback_request = self._rollback_request, None
            return req

    def _handle_requested_rollback(self, req: RollbackRequest,
                                   step_num: int, log_fn,
                                   record_fn) -> Optional[int]:
        """Restore the newest valid snapshot COMMITTED before
        ``req.before_wall_time`` (a snapshot captured mid-incident is no
        recovery target).  Unlike the divergence path this never
        quarantines, and SKIPS when no snapshot qualifies: training
        continues.  Returns the resumed iteration, or None on a skip."""
        max_step = step_num - 1
        if req.before_wall_time is not None:
            qualifying = []
            for step, path in list_snapshots(self.cfg.snapshot_prefix):
                if step > max_step:
                    continue
                created = snapshot_info(path)["created"]
                if created is not None and created < req.before_wall_time:
                    qualifying.append(step)
            if not qualifying:
                msg = (f"rollback request ({req.reason}) skipped: no "
                       f"snapshot under {self.cfg.snapshot_prefix!r} "
                       f"predates the incident")
                log.warning(msg)
                log_fn(msg)
                self._tel_event("rollback_skip", step_num,
                                reason=req.reason)
                return None
            max_step = max(qualifying)
        restored = self.restore_auto(max_step=max_step)
        if restored is None:
            msg = (f"rollback request ({req.reason}) skipped: no valid "
                   f"snapshot at iteration <= {max_step}")
            log.warning(msg)
            log_fn(msg)
            self._tel_event("rollback_skip", step_num, reason=req.reason)
            return None
        resumed = self._post_restore(req.lr_scale)
        msg = (f"remediation rollback ({req.reason}): rolled back to "
               f"iteration {resumed} ({restored}), "
               f"lr={self.cfg.base_lr:.6g}")
        log.warning(msg)
        log_fn(msg)
        self._tel_event("rollback", step_num, to_iteration=resumed,
                        snapshot=restored, base_lr=float(self.cfg.base_lr),
                        requested=True, reason=req.reason)
        if record_fn is not None:
            record_fn({"event": "rollback", "iteration": step_num,
                       "to_iteration": resumed, "snapshot": restored,
                       "requested": True})
        return resumed


class _PipelinedStep:
    """The captured pipelined step of one key (``Solver._pipe_key``):
    its static batch, read at fixed addresses by every replay; the CUDA
    graph once captured (None on the CPU and during warm-up); and the
    kernel launches one replay makes (``delta``)."""

    def __init__(self, key: tuple, x: torch.Tensor, lab: torch.Tensor):
        self.key = key
        self.x = torch.empty_like(x)
        self.lab = torch.empty_like(lab)
        self.graph = None
        self.delta: Dict[tuple, int] = {}
        self.eager_steps = 0


# The running-statistics buffers of the port's BatchNorm
# (models/layers.py), flax's ``batch_stats`` leaves.
_BATCH_STAT_LEAVES = ("mean", "var")


def restore_for_inference(path: str, device: Optional[_device.DeviceLike]
                          = None, retry: Optional[RetryPolicy] = None
                          ) -> Dict[str, Dict[str, torch.Tensor]]:
    """A port training snapshot -> ``{"params", "batch_stats"}`` for the
    serving path, without a Solver (``npairloss_tpu/train/solver.py:
    1935-2021``).  Each maps the model's ``state_dict`` names to tensors
    on ``device`` (default: the card); ``batch_stats`` holds the
    BatchNorms' running ``mean``/``var`` (empty for a BN-free trunk).

    The read retries as restores do; only the model subset of the
    commit manifest is checked (the momentum buffers and the iteration
    are neither read by inference nor verified), and a mismatch raises
    ``SnapshotValidationError``.  A manifest-less directory restores
    unverified; a manifest that cannot be read is corruption."""
    path = os.path.abspath(path)
    dev = _device.resolve_device(device)

    def do_restore():
        failpoints.fire("snapshot.restore.io")
        return read_state(path, dev)

    state = call_with_retry(do_restore,
                            retry if retry is not None else RetryPolicy(),
                            describe=f"inference restore ({path})")
    model = ({k: v for k, v in state.items() if k.startswith("model/")}
             if isinstance(state, dict) else {})
    if not model:
        raise SnapshotValidationError(
            f"{path} does not look like a training snapshot (no "
            "'model/' tensors)")
    try:
        manifest = read_manifest(path)
    except FileNotFoundError:
        log.info("restored %s for inference without checksum "
                 "verification (no commit manifest)", path)
    except (OSError, ValueError) as e:
        raise SnapshotValidationError(
            f"unreadable manifest in {path}: {e}") from e
    else:
        subset = {k: v for k, v in manifest.get("arrays", {}).items()
                  if k.startswith("model/")}
        verify_restored(model, {"arrays": subset})
    out: Dict[str, Dict[str, torch.Tensor]] = {"params": {},
                                               "batch_stats": {}}
    for key, t in model.items():
        name = key[len("model/"):]
        group = ("batch_stats" if name.rsplit(".", 1)[-1]
                 in _BATCH_STAT_LEAVES else "params")
        out[group][name] = t
    return out


def load_inference_state(model: torch.nn.Module,
                         state: Dict[str, Dict[str, torch.Tensor]]
                         ) -> torch.nn.Module:
    """Copy :func:`restore_for_inference`'s tensors into ``model`` (every
    name must match; dtypes follow the model's)."""
    model.load_state_dict({**state["params"], **state["batch_stats"]},
                          strict=True)
    return model.eval()
