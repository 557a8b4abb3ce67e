"""The synchronous solver loop — port of ``npairloss_tpu/train/solver.py``'s
``Solver`` for one device, with the dense or the blockwise loss engine.

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

Not yet ported (later slices, ROADMAP Queue 1): the pipelined loop
(item 8), meshes (item 7), telemetry, the divergence guard and
requested rollbacks (item 9's remainder).
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import os
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from npairloss_tpu_torch.device import upload
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
from npairloss_tpu_torch.resilience import failpoints
from npairloss_tpu_torch.resilience.preempt import TrainingPreempted
from npairloss_tpu_torch.resilience.retrying import (
    RetryPolicy,
    call_with_retry,
)
from npairloss_tpu_torch.resilience.snapshot import (
    SnapshotValidationError,
    commit_snapshot,
    gc_snapshots,
    list_snapshots,
    read_manifest,
    read_state,
    validate_snapshot,
    verify_restored,
)
from npairloss_tpu_torch.train.optim import (
    Mults,
    caffe_sgd,
    lr_schedule,
    param_mults as mult_table,
)

log = logging.getLogger("npairloss_tpu_torch.solver")

Batches = Iterator[Tuple[np.ndarray, np.ndarray]]


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
      engine: ``"dense"`` materializes the N x N pair matrix;
        ``"blockwise"`` streams it in tiles through the kernels of
        ``ops.blockwise_npair``, for pools too large for the matrix.
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
                 precision=None):
        if engine == "ring":
            raise ValueError('engine="ring" streams the pool over a mesh, '
                             "and distribution is not ported yet (ROADMAP "
                             "Queue 1 item 7)")
        if engine not in ("dense", "blockwise"):
            raise ValueError(f"unknown engine {engine!r}")
        self.engine = engine
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
        self.cfg = cfg if cfg is not None else SolverConfig()
        self.top_ks = tuple(top_ks)
        self.loss_weight = float(loss_weight)
        self.device = next(model.parameters()).device
        self.params = dict(model.named_parameters())
        self.mults = mult_table(list(self.params), param_mults)
        self.rate_fn = lr_schedule(
            self.cfg.lr_policy, self.cfg.base_lr, self.cfg.gamma,
            self.cfg.stepsize, self.cfg.power, self.cfg.max_iter,
            self.cfg.stepvalues)
        self._loss_window: collections.deque = collections.deque(
            maxlen=max(self.cfg.average_loss, 1))
        self.snapshot_retry = snapshot_retry
        # A resilience.PreemptionSignal; the loop polls it once a step.
        self.preempt = None
        self._reset_optimizer()

    # -- state ------------------------------------------------------------

    def _reset_optimizer(self) -> None:
        self.momentum = {n: torch.zeros_like(p, dtype=torch.float32)
                         for n, p in self.params.items()}
        self.iteration = 0

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
        tensor is touched."""
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
        commit_snapshot(path, self.state_dict(), step,
                        policy=self.snapshot_retry)
        log.info("snapshot -> %s", path)
        gc_snapshots(self.cfg.snapshot_prefix, self.cfg.snapshot_max_keep)
        return path

    def _load_snapshot(self, path: str) -> Dict[str, torch.Tensor]:
        def do_restore():
            failpoints.fire("snapshot.restore.io")
            return read_state(path, self.device)

        return call_with_retry(do_restore, self.snapshot_retry,
                               describe=f"snapshot restore ({path})")

    def restore_snapshot(self, path: str) -> str:
        """Restore an explicit snapshot path onto the solver's device
        (retrying transient I/O).  A snapshot with a commit manifest is
        checksum-verified against it and raises
        ``SnapshotValidationError`` when corrupt; a manifest-less dir
        restores unverified; a manifest that exists but cannot be read
        is corruption and raises."""
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
        restored path, or None (a fresh start) when none is valid."""
        prefix = self.cfg.snapshot_prefix
        for step, path in reversed(list_snapshots(prefix)):
            if max_step is not None and step > max_step:
                continue
            try:
                manifest = validate_snapshot(path)
                state = self._load_snapshot(path)
                verify_restored(state, manifest)
                self.load_state(state)
            except Exception as e:  # noqa: BLE001 — skip, try the next
                log.warning("resume: skipping snapshot %s: %s", path, e)
                continue
            log.info("resume: restored %s (iteration %d)", path, step)
            return path
        log.info("resume: no valid snapshot under prefix %r — starting "
                 "fresh", prefix)
        return None

    # -- one step -----------------------------------------------------------

    def _put(self, inputs, labels):
        """The batch on the solver's device (``device.upload``): host
        arrays go up from pinned memory asynchronously; a loader's
        tensors already on the device stay as they are."""
        return upload(inputs, self.device), upload(labels, self.device)

    def compute_loss(self, emb: torch.Tensor, labels: torch.Tensor):
        """(objective, metrics): the N-pair loss through the configured
        engine, scaled by ``loss_weight``, and the metric tops — from the
        dense engine's detached aux, or streamed over the detached
        embedding for the blockwise engine."""
        if self.engine == "blockwise":
            loss, _ = blockwise_npair_loss_with_aux(
                emb, labels, self.loss_cfg, sim_cache=self.sim_cache,
                pos_topk=self.pos_topk,
                matmul_precision=self.matmul_precision)
            metrics = blockwise_retrieval_metrics(emb.detach(), labels,
                                                  self.top_ks)
        else:
            loss, aux = npair_loss_with_aux(
                emb, labels, self.loss_cfg,
                matmul_precision=self.matmul_precision)
            metrics = retrieval_metrics(aux, labels, emb.detach(),
                                        self.top_ks)
        if self.loss_weight != 1.0:
            loss = loss * float(np.float32(self.loss_weight))
        return loss, metrics

    def step(self, inputs, labels) -> Dict[str, Any]:
        """One training iteration; returns the step's metrics (device
        tensors, and the applied lr as a float)."""
        x, lab = self._put(inputs, labels)
        self.model.train()
        for p in self.params.values():
            p.grad = None
        emb = self.model(x)
        loss, metrics = self.compute_loss(emb, lab)
        loss.backward()
        lr = self.rate_fn(self.iteration)
        metrics["lr"] = lr
        caffe_sgd(self.params, {n: p.grad for n, p in self.params.items()},
                  self.momentum, lr, self.cfg.momentum,
                  self.cfg.weight_decay, self.mults)
        self.iteration += 1
        metrics["loss"] = loss.detach()
        # Sorted, as a jitted JAX step returns its metric dict.
        return dict(sorted(metrics.items()))

    @torch.no_grad()
    def evaluate(self, batches: Batches, num_iters: int) -> Dict[str, float]:
        """TEST phase: loss and metrics averaged over ``num_iters``
        batches (a forward without a graph in eval mode: the stem runs
        its uncached kernels, a BN trunk its running statistics)."""
        self.model.eval()
        acc: Dict[str, float] = collections.defaultdict(float)
        n = 0
        for _ in range(num_iters):
            x, lab = self._put(*next(batches))
            loss, metrics = self.compute_loss(self.model(x), lab)
            metrics["loss"] = loss
            for k, v in sorted(metrics.items()):
                acc[k] += float(v)
            n += 1
        return {k: v / max(n, 1) for k, v in acc.items()}

    # -- the loop -------------------------------------------------------------

    def train(self, train_batches: Batches, num_iters: Optional[int] = None,
              test_batches: Optional[Batches] = None,
              log_fn: Callable[[str], None] = log.info,
              record_fn: Optional[Callable[[Dict[str, Any]], None]] = None,
              ) -> Dict[str, float]:
        """The Caffe Solver::Solve loop.  ``num_iters`` is the TOTAL
        iteration target (``max_iter``): a solver restored at iteration k
        runs ``num_iters - k`` more steps, every cadence aligned.
        ``record_fn`` gets one dict per display/test/snapshot/preempt
        event — the ``--log-json`` stream."""
        cfg = self.cfg
        num_iters = num_iters if num_iters is not None else cfg.max_iter
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
        last: Dict[str, Any] = {}
        while it < num_iters:
            metrics = self.step(*next(train_batches))
            step_num = it + 1
            self._loss_window.append(metrics["loss"])
            last = metrics
            if cfg.display and step_num % cfg.display == 0:
                self._display(step_num, metrics, log_fn, record_fn)
            self._boundary_actions(step_num, test_batches, log_fn, record_fn)
            it = step_num
        return {k: float(v) for k, v in last.items()}

    def _boundary_actions(self, step_num, test_batches, log_fn,
                          record_fn) -> None:
        """The test/snapshot/preempt cadence after a step.  On a
        requested preemption: an emergency snapshot (unless the cadence
        just took one), then ``TrainingPreempted``, which the CLI maps
        to ``EXIT_PREEMPTED`` for the supervisor."""
        cfg = self.cfg
        if (test_batches is not None and cfg.test_interval
                and step_num % cfg.test_interval == 0):
            self._test(step_num, test_batches, log_fn, record_fn)
        snapped = None
        if cfg.snapshot and step_num % cfg.snapshot == 0:
            snapped = self.save_snapshot(step_num)
            if record_fn is not None:
                record_fn({"event": "snapshot", "iteration": step_num})
        if self.preempt is not None and self.preempt.requested:
            path = snapped or self.save_snapshot(step_num)
            log_fn(f"preempted at iter {step_num}: emergency snapshot "
                   f"{path}; relaunch with --resume auto")
            if record_fn is not None:
                record_fn({"event": "preempt", "iteration": step_num,
                           "snapshot": path})
            raise TrainingPreempted(step_num, snapshot_path=path,
                                    signum=self.preempt.signum)

    def _display(self, step_num, metrics, log_fn, record_fn) -> None:
        host = {k: float(v) for k, v in metrics.items()}
        avg = float(torch.stack(list(self._loss_window)).mean())
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
