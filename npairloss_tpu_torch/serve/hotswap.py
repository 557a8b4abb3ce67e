"""SnapshotSwapper — model and index hot-swap under live traffic.

Port of ``npairloss_tpu/serve/hotswap.py``, the staleness remediation's
actuator.  The serving tier watches the training ``snapshot_prefix``
and/or the gallery ``index_prefix``; when a staleness alert fires (or
:meth:`SnapshotSwapper.swap` is called directly), it

  1. scans for a STRICTLY newer committed artifact: snapshots newest
     first through ``list_snapshots`` + ``validate_snapshot`` with the
     restore inside the scan (a torn or corrupt candidate is skipped
     with a logged reason, as the resume scan does), indexes through
     ``load_newest`` (the newest commit by name that loads);
  2. builds a FRESH engine tier on the new artifacts and warms every
     padding bucket off the serving path: the swap runs on the caller's
     thread (the live observatory's evaluator), so the old tier keeps
     answering while the new one warms;
  3. publishes it through :meth:`RetrievalServer.swap_engines`: each
     replica's next batch runs on the new tier, a batch in flight
     finishes where it started, and the answers' ``model_age_s`` /
     ``index_age_s`` drop at the flip.

The port's trunk is an ``nn.Module`` that holds its weights, so a model
swap builds a copy of the served module (``copy.deepcopy``) and loads
the restored state into it; the served module is never written.  The
new primary warms on the thread that calls :meth:`swap`, on that
thread's current CUDA stream (the primary replica serves on the same
one, so the warm-up's launches interleave with its batches); replicas
get streams of their own and share the primary's index, model and
dispatch signatures, so the tier's post-warmup compile count starts at
0.

Raises :class:`NothingNewerError` when no newer valid artifact exists:
for the remediation engine an honest FAILED attempt (a stalled trainer
is an incident the actuator cannot fix), never a silent no-op.
"""

from __future__ import annotations

import copy
import logging
import os
from typing import Any, Callable, Dict, Optional, Sequence

from npairloss_tpu_torch.resilience.snapshot import (
    list_snapshots,
    validate_snapshot,
)
from npairloss_tpu_torch.serve.engine import QueryEngine
from npairloss_tpu_torch.serve.index import load_newest
from npairloss_tpu_torch.serve.server import Freshness, RetrievalServer

log = logging.getLogger("npairloss_tpu_torch.serve")


class NothingNewerError(RuntimeError):
    """No committed snapshot/index newer than what is being served."""


class SnapshotSwapper:
    """Watch ``snapshot_prefix``/``index_prefix`` and hot-swap the
    server's engine tier to the newest committed artifacts.

    ``model`` is the served trunk (None = embedding-only serving, which
    can only watch ``index_prefix``) and ``input_shape`` its NHWC input,
    as ``serve`` built them; the CURRENT identities are read from
    ``server.freshness`` at each swap, so repeated swaps chain.
    ``index_transform`` is ``serve``'s ``--index-kind`` reconciliation,
    applied to every swapped-in index (without it a flat commit would
    demote an IVF tier to the exact scan at the first swap).  Under
    ``serve --wal-dir`` the WAL records above a swapped-in commit's
    watermark stay pending for the next checkpoint, as in JAX: a swap
    never adds rows to the index it publishes.  ``swap(alert=None)`` is the
    remediation-action signature (the alert is named in the error, not
    consumed).
    """

    def __init__(
        self,
        server: RetrievalServer,
        index_prefix: Optional[str] = None,
        snapshot_prefix: Optional[str] = None,
        model=None,
        input_shape: Optional[Sequence[int]] = None,
        telemetry=None,
        index_transform: Optional[Callable[[Any], Any]] = None,
    ):
        if not index_prefix and not snapshot_prefix:
            raise ValueError(
                "SnapshotSwapper needs an index_prefix and/or a "
                "snapshot_prefix to watch")
        if snapshot_prefix and model is None:
            raise ValueError(
                "watching snapshot_prefix needs the model (the swap "
                "restores new params INTO it); embedding-only serving "
                "can only watch index_prefix")
        self.server = server
        self.index_prefix = index_prefix
        self.snapshot_prefix = snapshot_prefix
        self.model = model
        self.input_shape = (tuple(input_shape)
                            if input_shape is not None else None)
        self.telemetry = telemetry
        self.index_transform = index_transform

    # -- discovery ---------------------------------------------------------

    def _restore_newer(self, fresh: Freshness):
        """(path, restored state) of the newest snapshot strictly newer
        (by step) than the served one that validates AND restores, or
        None.  A candidate whose manifest is fine but whose tensors are
        torn is skipped for the next older still-newer one: the restore
        runs inside the scan, or one corrupt newest snapshot would wedge
        every swap while a good newer one waits."""
        if not self.snapshot_prefix:
            return None
        from npairloss_tpu_torch.train.solver import restore_for_inference

        current = fresh.snapshot_step
        for step, path in reversed(list_snapshots(self.snapshot_prefix)):
            if current is not None and step <= current:
                return None  # newest first: nothing newer remains
            try:
                validate_snapshot(path)
                return path, restore_for_inference(
                    path, device=self.server.engine.device)
            except Exception as e:  # noqa: BLE001 — skip, try the next
                log.warning("hot-swap: skipping snapshot %s: %s", path, e)
        return None

    @staticmethod
    def _index_is_newer(candidate: str, current: Optional[str]) -> bool:
        # Index commits are named sortably (load_newest's contract): a
        # different name that sorts LATER is newer, anything else is not
        # a swap target.
        if current is None:
            return True
        return os.path.basename(candidate) > os.path.basename(current)

    # -- the action --------------------------------------------------------

    def swap(self, alert: Optional[Dict[str, Any]] = None
             ) -> Dict[str, Any]:
        """Build + warm a new tier off the serving path, then publish.
        Returns the detail dict the remediation audit records; raises
        :class:`NothingNewerError` when there is nothing to swap to."""
        from npairloss_tpu_torch.train.solver import load_inference_state

        fresh = self.server.freshness or Freshness()
        new_index = None
        index_path = fresh.index_path
        if self.index_prefix:
            found = load_newest(self.index_prefix,
                                device=self.server.engine.device)
            if found is not None and self._index_is_newer(
                    found[0], fresh.index_path):
                index_path, new_index = found
                if self.index_transform is not None:
                    # The startup reconciliation: the serving posture
                    # survives the swap.
                    new_index = self.index_transform(new_index)
        snapshot_path = fresh.snapshot_path
        new_state = None
        restored = self._restore_newer(fresh)
        if restored is not None:
            snapshot_path, new_state = restored
        if new_index is None and new_state is None:
            raise NothingNewerError(
                "no committed snapshot/index newer than the served one"
                + (f" (alert {alert.get('alert_id')})" if alert else ""))

        old = self.server.engine
        index = new_index if new_index is not None else old.index
        model = old.model
        if new_state is not None:
            # A new module for the new weights: the served one keeps
            # answering, unchanged, until the flip.
            model = copy.deepcopy(model if model is not None else self.model)
            load_inference_state(model, new_state)
        primary = QueryEngine(index, old.cfg, model=model,
                              telemetry=self.telemetry)
        warmup_s = primary.warmup(
            self.input_shape if model is not None else None)
        engines = [primary] + [
            QueryEngine(index, old.cfg, share_compiled_with=primary)
            for _ in range(len(self.server.engines) - 1)]
        freshness = Freshness.collect(
            index=index, index_path=index_path,
            snapshot_path=snapshot_path if model is not None else None)
        old_wm = int(getattr(old.index, "ingest_watermark", 0))
        new_wm = int(getattr(index, "ingest_watermark", 0))

        def _prepare() -> None:
            # Under the server's ingest lock, at the flip itself: the
            # watermark the tier answers from changes here, and the WAL
            # records above it stay pending (they reach a served index
            # through the next checkpoint).  Logged, so a watermark
            # regression at swap time is visible evidence.
            if old_wm or new_wm:
                log.info(
                    "hot-swap: ingest watermark %d -> %d (WAL records "
                    "above %d remain pending for the next checkpoint)",
                    old_wm, new_wm, new_wm)

        self.server.swap_engines(engines, freshness, prepare=_prepare)
        detail: Dict[str, Any] = {
            "swapped": ((["model"] if restored is not None else [])
                        + (["index"] if new_index is not None else [])),
            "warmup_s": round(warmup_s, 3),
            **freshness.identity(),
        }
        if self.telemetry is not None:
            self.telemetry.instant("serve/hot_swap", **{
                k: v for k, v in detail.items() if k != "swapped"})
        return detail
