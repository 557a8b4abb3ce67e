"""RetrievalServer — snapshot-to-answers front ends over the engine.

Port of ``npairloss_tpu/serve/server.py`` for one device.  Two front ends
share one serving core (admit -> route to a replica -> micro-batch ->
encode raw inputs, then one top-k dispatch -> answer):

  * **stdin/JSONL** (:meth:`RetrievalServer.run_jsonl`): one request
    object per line in, one answer object per line out, in request
    order;
  * **localhost HTTP** (:meth:`RetrievalServer.run_http`): ``POST
    /query`` with one JSON record (answered as one object) or a body of
    newline-separated records (answered as a list), ``GET /healthz``;
    a 400 for bad JSON or an empty body, a 404 for other paths, and
    ``GET /metrics`` answers 404 until the live observatory is ported
    (ROADMAP Queue 1 entry 4.3), as JAX's does without ``--live-obs``.
    Request threads never touch the card: queries run on the replicas'
    dispatcher threads, ingest on the ingest worker.

Request: ``{"id": ..., "embedding": [...]}`` or ``{"id": ..., "input":
[...]}`` (a raw NHWC image; needs a model).  Answer: ``{"id",
"neighbors": [{"rank", "row", "gallery_id", "label", "score"}, ...]}``
plus the freshness ages; a failed or rejected query answers ``{"id",
"error"}``.

Replicas: ``engine`` may be a list of engines (``QueryEngine(...,
share_compiled_with=primary)``), one :class:`ReplicaSet` replica each;
the ``serve.replica_crash`` failpoint kills the replica that draws it
and its work reroutes to a survivor, invisible to clients.

Durable ingest: ``{"id", "ingest": {"ids", "labels", "embeddings"}}``
goes encode -> WAL append -> ``wait_durable`` (the fsync) -> apply ->
``{"id", "ingested", "seq"}`` ack, never through the query pipeline, so
ingest records never enter the query counts.  Records are applied in
their WAL order whatever order concurrent HTTP requests reach the fsync
in, so the applied watermark only grows and a checkpoint at watermark
``w`` holds every acked record up to ``w``.  The port applies a
durable record to the served index in place (``index.add`` republishes
the layout; there is no compile to avoid on this path), and every
``checkpoint_every`` records publishes an index checkpoint at the
applied watermark, after which the WAL segments it covers are GC'd.
The HTTP front end takes ingest records in a ``POST /query`` body as the
JSONL front end takes them on stdin.

Shutdown: SIGTERM/SIGINT set the ``PreemptionSignal``; the front end
stops admitting (HTTP answers 503 ``{"error": "draining"}``), every
admitted query is answered, a final ingest checkpoint is written, the
``serve_drain`` summary is the last record, and the exit code is
:data:`EXIT_PREEMPTED` (75).  The summary's counters satisfy ``queries
== answered + (errors - errors_refused) + rejected``: ``errors_refused``
counts records refused before admission (bad JSON), which are errors
but never queries; ``queries_dropped`` is the residual, present when
nonzero or with ``explicit_drops``.

Telemetry (``telemetry``: a ``RunTelemetry``, ``serve --telemetry-dir``
or ``--trace-dir``), as in JAX: ``serve/admit`` around each admission on
the submitting thread, ``serve/batch`` (the coalescing wait) and
``serve/dispatch`` (``size``) on each replica's dispatcher thread (one
lane a replica), ``serve/encode``/``serve/topk``/``serve/warmup`` and the
``serve/recompile`` instant from the engine.  Every ``metrics_window``
answers one ``serve`` row goes to the metrics stream (the window's own
qps, p50/p99, queue depth, batches, rejected, the last batch's stats,
and the window's per-stage p50/p99 split from the spans that finished
since the previous window), and the drain summary adds the whole run's
split.  Both splits start at the server's construction, so warm-up
spans never count.  Without telemetry every stream is what it was.
"""

from __future__ import annotations

import base64
import collections
import concurrent.futures
import contextlib
import dataclasses
import json
import logging
import os
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from npairloss_tpu_torch.resilience import failpoints
from npairloss_tpu_torch.resilience.preempt import (
    EXIT_PREEMPTED,
    PreemptionSignal,
)
from npairloss_tpu_torch.serve.batcher import BatcherConfig, QueueFullError
from npairloss_tpu_torch.serve.engine import NoModelError, QueryEngine
from npairloss_tpu_torch.serve.replicas import ReplicaCrashError, ReplicaSet

log = logging.getLogger("npairloss_tpu_torch.serve")


def encode_ingest_body(ingest: Dict[str, Any]) -> Dict[str, Any]:
    """A client ingest block -> the ``npairloss-wal-v1`` ``kind: "add"``
    record body.  ``ids`` are required (a replay must give the same
    ids); the matrix rides as base64 float32."""
    if not isinstance(ingest, dict):
        raise ValueError("ingest must be an object")
    emb = np.asarray(ingest.get("embeddings"), np.float32)
    if emb.ndim != 2 or emb.shape[0] == 0 or emb.shape[1] == 0:
        raise ValueError(
            f"ingest embeddings must be a non-empty 2-D matrix, got "
            f"shape {emb.shape}")
    labels = ingest.get("labels")
    ids = ingest.get("ids")
    if not isinstance(labels, list) or len(labels) != emb.shape[0]:
        raise ValueError("ingest labels must list one label per row")
    if not isinstance(ids, list) or len(ids) != emb.shape[0]:
        raise ValueError(
            "ingest ids must list one id per row (replay determinism "
            "forbids auto-assignment)")
    return {
        "kind": "add",
        "ids": [int(i) for i in ids],
        "labels": [int(x) for x in labels],
        "dim": int(emb.shape[1]),
        "emb": base64.b64encode(emb.tobytes()).decode("ascii"),
    }


def decode_ingest_payload(payload: Dict[str, Any]
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The inverse of :func:`encode_ingest_body`: a replayed WAL record
    body -> ``(embeddings, labels, ids)`` ready for ``index.add``."""
    ids = np.asarray(payload["ids"], np.int64)
    raw = base64.b64decode(payload["emb"])
    emb = np.frombuffer(raw, np.float32)
    dim = int(payload["dim"])
    if dim < 1 or emb.size != ids.shape[0] * dim:
        raise ValueError(
            f"ingest record seq {payload.get('seq')}: embedding bytes "
            f"({emb.size} float32) do not match {ids.shape[0]} row(s) "
            f"of dim {dim}")
    return (emb.reshape(ids.shape[0], dim).copy(),
            np.asarray(payload["labels"], np.int32), ids)


@dataclasses.dataclass(frozen=True)
class Freshness:
    """What the tier answers from and how old it is: the index's commit
    time, and the model's snapshot (its manifest's step and commit time)
    or weights file (its modification time)."""

    index_path: Optional[str] = None
    index_created: Optional[float] = None
    weights_path: Optional[str] = None
    weights_created: Optional[float] = None
    snapshot_path: Optional[str] = None
    snapshot_step: Optional[int] = None
    snapshot_created: Optional[float] = None

    @classmethod
    def collect(cls, index=None, index_path: Optional[str] = None,
                weights_path: Optional[str] = None,
                snapshot_path: Optional[str] = None) -> "Freshness":
        snap_step = snap_created = None
        if snapshot_path is not None:
            from npairloss_tpu_torch.resilience.snapshot import snapshot_info

            info = snapshot_info(snapshot_path)
            snapshot_path = info["path"]
            snap_step, snap_created = info["step"], info["created"]
        return cls(
            index_path=index_path,
            index_created=getattr(index, "created", None),
            weights_path=(os.path.abspath(weights_path)
                          if weights_path else None),
            weights_created=(os.path.getmtime(weights_path)
                             if weights_path else None),
            snapshot_path=snapshot_path,
            snapshot_step=snap_step,
            snapshot_created=snap_created)

    def ages(self, now: Optional[float] = None) -> Dict[str, float]:
        """``index_age_s``/``model_age_s``; a key is absent when its
        identity is unknown, never reported as fresh."""
        now = time.time() if now is None else now
        out: Dict[str, float] = {}
        if self.index_created is not None:
            out["index_age_s"] = round(max(now - self.index_created, 0.0), 3)
        model_created = (self.snapshot_created
                         if self.snapshot_created is not None
                         else self.weights_created)
        if model_created is not None:
            out["model_age_s"] = round(max(now - model_created, 0.0), 3)
        return out

    def identity(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if self.index_path is not None:
            out["index_path"] = self.index_path
        if self.weights_path is not None:
            out["weights_path"] = self.weights_path
        if self.snapshot_path is not None:
            out["snapshot_path"] = self.snapshot_path
        if self.snapshot_step is not None:
            out["snapshot_step"] = self.snapshot_step
        return out


# Latency samples kept for the p50/p99 estimate.
LATENCY_WINDOW = 1024


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """``metrics_window``: answered queries per logged latency/throughput
    row (0 = none); ``poll_s``: how long a ready answer may wait for the idle
    flush, and how soon an idle front end notices a drain request;
    ``explicit_drops``: carry ``queries_dropped`` in the summary even at
    zero."""

    metrics_window: int = 100
    poll_s: float = 0.1
    explicit_drops: bool = False


class RetrievalServer:
    """N replica engines + per-replica batchers + the request/answer
    protocol (one engine is the one-replica tier)."""

    def __init__(self, engine, batcher_cfg: BatcherConfig = BatcherConfig(),
                 cfg: ServerConfig = ServerConfig(),
                 preempt: Optional[PreemptionSignal] = None,
                 freshness: Optional[Freshness] = None,
                 telemetry=None):
        engines = (list(engine) if isinstance(engine, (list, tuple))
                   else [engine])
        self.engines: List[QueryEngine] = engines
        self.engine = engines[0]
        self.cfg = cfg
        self.preempt = preempt
        self.freshness = freshness
        self.telemetry = telemetry
        self.replicaset = ReplicaSet(engines, batcher_cfg,
                                     self._replica_dispatch,
                                     span_fn=self._span,
                                     on_batch=self._record_batch)
        self._last_batch: Dict[str, Any] = {}
        # Tracer event-index cursors for the latency splits: a window
        # reads only the spans appended (= finished) since the previous
        # window, so a span straddling two windows lands in exactly one.
        # Windows close on whichever request thread crosses the
        # threshold, outside _lock: the cursor's read-advance holds its
        # own lock, or two threads closing windows at once would count
        # one window's spans twice.  Both cursors start here, after the
        # engines' warmup, whose spans never enter a split.
        tracer = self._tracer()
        baseline = tracer.num_events if tracer is not None else 0
        self._events_start_idx = baseline
        self._window_events_idx = baseline  # guarded-by: _window_events_lock
        self._window_events_lock = threading.Lock()
        self._lock = threading.Lock()
        self._lat = collections.deque(maxlen=LATENCY_WINDOW)
        self._window_lat: List[float] = []  # guarded-by: _lock
        self._window_t0 = time.perf_counter()
        self._window_n = 0  # guarded-by: _lock
        self.queries = 0  # guarded-by: _lock
        self.answered = 0  # guarded-by: _lock
        self.errors = 0  # guarded-by: _lock
        self.errors_refused = 0  # guarded-by: _lock
        # Durable ingest: all None/zero until attach_wal.  The ingest
        # lock serializes apply and checkpoint; _lock nests inside it.
        # The append lock makes the WAL's order the ingest worker's.
        self.wal = None
        self._ingest_lock = threading.Lock()
        self._append_lock = threading.Lock()
        self._ingest_apply: Optional[Callable[[Dict[str, Any]], None]] = None
        self._checkpoint_fn: Optional[Callable[[int], Optional[str]]] = None
        self._checkpoint_every = 0
        self._ingest_worker: Optional[
            concurrent.futures.ThreadPoolExecutor] = None
        self.ingest_batches = 0  # guarded-by: _lock
        self.ingest_vectors = 0  # guarded-by: _lock
        self.ingest_errors = 0  # guarded-by: _lock
        self.checkpoints = 0  # guarded-by: _lock
        self._ingest_watermark = 0  # guarded-by: _ingest_lock
        self._ckpt_watermark = 0  # guarded-by: _ingest_lock
        self._ingest_since_ckpt = 0  # guarded-by: _ingest_lock
        self._recovery: Optional[Dict[str, Any]] = None
        self.http_port: Optional[int] = None
        # HTTP requests between their handler's start and its reply.
        self._inflight = 0  # guarded-by: _inflight_cv
        self._inflight_cv = threading.Condition()

    @property
    def batcher(self):
        """The primary replica's batcher (aggregate counters live on
        ``self.replicaset``)."""
        return self.replicaset.replicas[0].batcher

    # -- replicas ----------------------------------------------------------

    def _replica_dispatch(self, replica):
        """Crash containment around the shared answer logic: the
        ``serve.replica_crash`` failpoint kills THIS replica, its batch
        (and every batch still queued on it) reroutes to a survivor."""

        def dispatch(items: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
            if not replica.alive:
                return self._reroute(replica, items)
            if failpoints.should_fire("serve.replica_crash"):
                replica.alive = False
                log.error("replica %s crashed (injected); %d live "
                          "replica(s) remain — rerouting its work",
                          replica.name, self.replicaset.alive_count)
                return self._reroute(replica, items)
            return self._dispatch_core(items, engine=replica.engine)

        return dispatch

    def _reroute(self, dead, items: List[Dict[str, Any]]
                 ) -> List[Dict[str, Any]]:
        """A dead replica's batch on a survivor's engine, from the dead
        replica's own dispatcher thread, as JAX's server does: the
        engines share the index and kernels, so the reroute waits on no
        other queue, and the survivor's engine then takes dispatches
        from two threads (its CUDA stream orders each thread's work; its
        counter takes a lock).  Not ``replicaset.pick()``: a whole-tier
        miss here fails the batch to errors, and must not also count in
        ``rejected``."""
        live = [r for r in self.replicaset.replicas if r.alive]
        if not live:
            raise ReplicaCrashError(
                f"replica {dead.name} is down and no live replica remains")
        target = min(live, key=lambda r: r.batcher.queue_depth)
        log.warning("rerouting %d quer%s from dead replica %s to %s",
                    len(items), "y" if len(items) == 1 else "ies",
                    dead.name, target.name)
        return self._dispatch_core(items, engine=target.engine)

    # -- telemetry ---------------------------------------------------------

    def _span(self, name: str, **args):
        if self.telemetry is None:
            return contextlib.nullcontext()
        return self.telemetry.span(name, **args)

    def _record_batch(self, stats: Dict[str, Any]) -> None:
        self._last_batch = stats

    def _tracer(self):
        tel = self.telemetry
        return getattr(tel, "tracer", None) if tel is not None else None

    @staticmethod
    def _latency_split(events) -> Dict[str, float]:
        """Per-stage p50/p99 (admit/batch/dispatch/encode/topk) from
        ``serve/*`` span events, flattened to ``<stage>_p50_ms`` /
        ``<stage>_p99_ms`` row keys (``obs.perf.decompose``)."""
        from npairloss_tpu_torch.obs.perf.decompose import (
            serve_latency_decomposition,
        )

        split = serve_latency_decomposition(events)
        return {f"{stage}_{q}": v for stage, row in split.items()
                for q, v in row.items() if q != "count"}

    def _window_latency_split(self) -> Dict[str, float]:
        """The current window's split: the spans that finished since the
        last window read.  ``spans_dropped`` shows the tracer's cap in
        the row itself (the split is partial then)."""
        tracer = self._tracer()
        if tracer is None:
            return {}
        with self._window_events_lock:
            events, self._window_events_idx, dropped = tracer.events_since(
                self._window_events_idx)
        out = self._latency_split(events)
        if dropped:
            out["spans_dropped"] = dropped
        return out

    # -- serving core ------------------------------------------------------

    def _dispatch_core(self, items: List[Dict[str, Any]],
                       engine: Optional[QueryEngine] = None
                       ) -> List[Dict[str, Any]]:
        """Coalesced records -> per-record answers.  A malformed record
        answers ``{"id", "error"}`` without failing its co-riders; raw
        inputs encode as one stacked batch, then join the embedding rows
        for one top-k dispatch."""
        engine = self.engine if engine is None else engine
        if failpoints.should_fire("serve.latency"):
            # A deterministic latency fault for the whole batch, sited
            # here (not in the engine) so warmup stays fast.
            time.sleep(failpoints.SERVE_LATENCY_FAULT_S)
        dim = engine.index.dim
        answers: List[Optional[Dict[str, Any]]] = [None] * len(items)
        emb_rows: List[tuple] = []
        enc_rows: List[tuple] = []
        for i, rec in enumerate(items):
            try:
                if "embedding" in rec:
                    e = np.asarray(rec["embedding"], np.float32)
                    if e.shape != (dim,):
                        raise ValueError(
                            f"embedding shape {e.shape} does not match "
                            f"gallery dim ({dim},)")
                    emb_rows.append((i, e))
                elif "input" in rec:
                    enc_rows.append((i, np.asarray(rec["input"], np.float32)))
                else:
                    raise ValueError(
                        "query record needs an 'embedding' or 'input' field")
            except (ValueError, TypeError) as e:
                answers[i] = {"id": rec.get("id"), "error": str(e)}
        if enc_rows:
            try:
                enc = engine.encode(np.stack([x for _, x in enc_rows]))
                if enc.shape[1] != dim:
                    raise ValueError(f"model embeds to {enc.shape[1]} dims, "
                                     f"the gallery holds {dim}")
                emb_rows.extend((i, row) for (i, _), row in zip(enc_rows, enc))
            except (ValueError, NoModelError) as e:
                # A ragged stack or a model-less engine fails these
                # records only; a device fault fails the whole batch.
                for i, _ in enc_rows:
                    answers[i] = {"id": items[i].get("id"), "error": str(e)}
        if emb_rows:
            out = engine.query(np.stack([x for _, x in emb_rows]))
            ages = self.freshness.ages() if self.freshness else {}
            for j, (i, _) in enumerate(emb_rows):
                answers[i] = {
                    "id": items[i].get("id"),
                    **ages,
                    "neighbors": [
                        {"rank": r,
                         "row": int(out["rows"][j, r]),
                         "gallery_id": int(out["ids"][j, r]),
                         "label": int(out["labels"][j, r]),
                         "score": round(float(out["scores"][j, r]), 6)}
                        for r in range(out["scores"].shape[1])
                    ],
                }
        return answers

    # -- admission and accounting ------------------------------------------

    def submit(self, record: Dict[str, Any]):
        """Admit one record; returns (future, t_submit).  Raises
        :class:`QueueFullError` on backpressure or a whole-tier loss
        (counted in rejected)."""
        with self._span("serve/admit"):
            with self._lock:
                self.queries += 1
            fut = self.replicaset.submit(record)
            return fut, time.perf_counter()

    def _record_latency(self, seconds: float) -> None:
        row = None
        with self._lock:
            self._lat.append(seconds * 1e3)
            self.answered += 1
            if self.cfg.metrics_window:
                self._window_lat.append(seconds * 1e3)
                self._window_n += 1
                if self._window_n >= self.cfg.metrics_window:
                    now = time.perf_counter()
                    qps = self._window_n / max(now - self._window_t0, 1e-9)
                    row = (qps, self._window_lat)
                    self._window_lat = []
                    self._window_t0 = now
                    self._window_n = 0
        if row is not None:
            self._emit_window(*row)

    def _emit_window(self, qps: float, lat: List[float]) -> None:
        """One latency/throughput/queue-depth row per window: logged, and
        a ``serve`` metrics row with telemetry.  The counters were read
        under the lock; the math and the I/O here run outside it."""
        row = {"qps": round(qps, 1),
               **{k: round(v, 3) for k, v in self._percentiles(lat).items()},
               "queue_depth": self.replicaset.queue_depth,
               "batches": self.replicaset.batches,
               "rejected": self.replicaset.rejected,
               **self._window_latency_split(),
               **{f"batch_{k}": round(v, 3) if isinstance(v, float) else v
                  for k, v in self._last_batch.items()}}
        if len(self.engines) > 1:
            row["replicas_alive"] = self.replicaset.alive_count
        if self.telemetry is not None and self.telemetry.metrics_enabled:
            try:
                self.telemetry.log("serve", self.answered, row)
            except Exception as e:  # noqa: BLE001 — telemetry is not the run
                log.error("serve metrics emission failed: %s", e)
        log.info("serve window: %s", row)

    def _account(self, answer: Dict[str, Any], t0: float) -> Dict[str, Any]:
        if "error" in answer:
            with self._lock:
                self.errors += 1
        else:
            self._record_latency(time.perf_counter() - t0)
        return answer

    def _refuse(self, rec_id, message: str) -> Dict[str, Any]:
        """A record refused before admission: an error, never a query."""
        with self._lock:
            self.errors += 1
            self.errors_refused += 1
        return {"id": rec_id, "error": message}

    def handle_many(self, records: List[Any],
                    timeout: Optional[float] = 60.0) -> List[Dict[str, Any]]:
        """Blocking multi-record path: admit EVERY query before waiting
        on any, so co-riders of one request share micro-batches.  Ingest
        records take the durable path in their place in the list."""
        staged: List[tuple] = []
        for rec in records:
            if not isinstance(rec, dict):
                staged.append((None, self._refuse(
                    None, "a request must be a JSON object"), None))
                continue
            if "ingest" in rec:
                staged.append((rec, self._handle_ingest(rec), None))
                self._maybe_checkpoint()
                continue
            try:
                fut, t0 = self.submit(rec)
                staged.append((rec, fut, t0))
            except QueueFullError as e:
                # Counted in rejected, never also in errors.
                staged.append((rec, {"id": rec.get("id"),
                                     "error": str(e)}, None))
        answers = []
        for rec, fut, t0 in staged:
            if t0 is None:
                answers.append(fut)
                continue
            try:
                answer = fut.result(timeout=timeout)
            except Exception as e:  # noqa: BLE001 — answer the failure
                with self._lock:
                    self.errors += 1
                answers.append({"id": rec.get("id"), "error": str(e)})
                continue
            answers.append(self._account(answer, t0))
        return answers

    # -- durable ingest ----------------------------------------------------

    def attach_wal(self, wal, apply_fn: Callable[[Dict[str, Any]], None], *,
                   checkpoint_fn: Optional[Callable[[int],
                                                    Optional[str]]] = None,
                   checkpoint_every: int = 0, watermark: int = 0,
                   checkpoint_watermark: int = 0,
                   recovery: Optional[Dict[str, Any]] = None) -> None:
        """Arm the durable-ingest path: ``wal`` takes every record BEFORE
        the ack, ``apply_fn(payload)`` applies a durable record, and
        ``checkpoint_fn(watermark)`` publishes an index checkpoint
        covering everything up to ``watermark`` (its path, or None when
        nothing was new), after which the covered WAL segments are GC'd.
        ``watermark`` seeds the applied mark (the startup replay has run),
        ``checkpoint_watermark`` the last published one; ``recovery``
        (what the startup replay did) is reported in :meth:`ingest_stats`.  Both functions
        run on one ingest worker thread: they may touch the card, and
        request threads never do.  Call before the front end starts."""
        self.wal = wal
        self._ingest_apply = apply_fn
        self._checkpoint_fn = checkpoint_fn
        self._checkpoint_every = int(checkpoint_every)
        self._ingest_watermark = int(watermark)
        self._ckpt_watermark = int(checkpoint_watermark)
        self._recovery = recovery
        self._ingest_worker = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="serve-ingest")

    def _on_ingest_worker(self, fn: Callable[[], Any]) -> Any:
        return self._ingest_worker.submit(fn).result()

    @property
    def ingest_watermark(self) -> int:
        """The last WAL sequence number applied (records apply in seq
        order, and each is acked after its apply)."""
        with self._ingest_lock:
            return self._ingest_watermark

    def _ingest_error(self, rid, message: str) -> Dict[str, Any]:
        with self._lock:
            self.ingest_errors += 1
        return {"id": rid, "error": message}

    def _handle_ingest(self, rec: Dict[str, Any]) -> Dict[str, Any]:
        """One ingest record, start to ack: encode -> WAL append ->
        durability barrier -> apply -> ack.  The ack never precedes the
        fsync covering the record."""
        rid = rec.get("id")
        if self.wal is None or self._ingest_apply is None:
            return self._ingest_error(
                rid, "ingest requires a WAL (serve --wal-dir)")
        try:
            body = encode_ingest_body(rec.get("ingest"))
            if body["dim"] != self.engine.index.dim:
                # Refused before the append: a logged record that can
                # never apply would fail every later replay.
                raise ValueError(f"ingest dim {body['dim']} does not match "
                                 f"gallery dim {self.engine.index.dim}")
        except (ValueError, TypeError) as e:
            return self._ingest_error(rid, f"bad ingest record: {e}")
        # HTTP request threads ingest at once.  Handing the record to the
        # one ingest worker under the append lock queues the records there
        # in seq order, so they are applied in seq order however their
        # fsync waits end, and a checkpoint never passes an acked record
        # that is not applied yet.
        with self._append_lock:
            try:
                seq = self.wal.append(body)
            except Exception as e:  # noqa: BLE001 — the client must hear "not durable"
                return self._not_durable(rid, e)
            body["seq"] = seq
            applied = self._ingest_worker.submit(self._apply_durable, body)
        failure = applied.result()
        if failure is not None:
            return self._not_durable(rid, failure)
        n = len(body["ids"])
        with self._lock:
            self.ingest_batches += 1
            self.ingest_vectors += n
        return {"id": rid, "ingested": n, "seq": seq}

    def _not_durable(self, rid, e: Exception) -> Dict[str, Any]:
        log.error("ingest %r failed before durability: %s", rid, e)
        return self._ingest_error(rid, f"ingest not durable: {e}")

    def _apply_durable(self, body: Dict[str, Any]) -> Optional[Exception]:
        """On the ingest worker, in seq order: wait for the fsync that
        covers the record, then apply it.  Returns the durability
        failure (nothing applied), or None once applied."""
        try:
            self.wal.wait_durable(body["seq"])
        except Exception as e:  # noqa: BLE001 — answered as "not durable"
            return e
        with self._ingest_lock:
            self._ingest_apply(body)
            self._ingest_watermark = body["seq"]
            self._ingest_since_ckpt += 1
        return None

    def _maybe_checkpoint(self) -> None:
        if self._checkpoint_fn is None or self._checkpoint_every <= 0:
            return
        with self._ingest_lock:
            due = self._ingest_since_ckpt >= self._checkpoint_every
        if due:
            self.checkpoint_now()

    def checkpoint_now(self) -> Optional[str]:
        """Publish an index checkpoint at the applied watermark, then GC
        the WAL segments it covers.  Returns the published path (None
        when nothing new was applied or no sink is attached)."""
        if self._checkpoint_fn is None or self.wal is None:
            return None

        def publish():
            with self._ingest_lock:
                wm = self._ingest_watermark
                if wm <= self._ckpt_watermark:
                    return None, wm
                try:
                    path = self._checkpoint_fn(wm)
                except Exception as e:  # noqa: BLE001 — a failed publish loses nothing
                    log.error("ingest checkpoint at watermark %d failed: "
                              "%s — the WAL keeps the records", wm, e)
                    return None, wm
                self._ckpt_watermark = wm
                self._ingest_since_ckpt = 0
                return path, wm

        path, wm = self._on_ingest_worker(publish)
        if path is not None:
            with self._lock:
                self.checkpoints += 1
            try:
                self.wal.gc(wm)
            except Exception as e:  # noqa: BLE001 — GC is space, not safety
                log.error("wal GC at watermark %d failed: %s", wm, e)
        return path

    def ingest_stats(self) -> Dict[str, Any]:
        """The /healthz and drain ``ingest`` block (present only with a
        WAL): counters, the two watermarks, and the WAL's own stats."""
        with self._ingest_lock:
            wm, ckpt = self._ingest_watermark, self._ckpt_watermark
        with self._lock:
            out: Dict[str, Any] = {"batches": self.ingest_batches,
                                   "vectors": self.ingest_vectors,
                                   "errors": self.ingest_errors,
                                   "checkpoints": self.checkpoints}
        out["watermark"] = wm
        out["checkpoint_watermark"] = ckpt
        if self._recovery is not None:
            out["recovery"] = dict(self._recovery)
        try:
            out["wal"] = self.wal.stats() if self.wal is not None else {}
        except Exception as e:  # noqa: BLE001 — stats must not fail health
            out["wal"] = {"error": str(e)}
        return out

    # -- summary -----------------------------------------------------------

    def _percentiles(self, lat: Optional[List[float]] = None
                     ) -> Dict[str, float]:
        lat = list(self._lat) if lat is None else lat
        if not lat:
            return {"p50_ms": 0.0, "p99_ms": 0.0}
        return {"p50_ms": float(np.percentile(lat, 50)),
                "p99_ms": float(np.percentile(lat, 99))}

    def _queries_dropped(self) -> int:
        """Admitted queries no term of ``answered + errors + rejected``
        accounts for (refusals before admission excluded)."""
        return (self.queries - self.answered
                - (self.errors - self.errors_refused)
                - self.replicaset.rejected)

    def summary(self) -> Dict[str, Any]:
        dropped = self._queries_dropped()
        stats = [e.stats() for e in self.engines]
        return {
            "event": "serve_drain",
            "queries": self.queries,
            "answered": self.answered,
            "errors": self.errors,
            "errors_refused": self.errors_refused,
            "rejected": self.replicaset.rejected,
            **({"queries_dropped": dropped}
               if (dropped or self.cfg.explicit_drops) else {}),
            "batches": self.replicaset.batches,
            **({"replicas": len(self.engines),
                "replicas_alive": self.replicaset.alive_count}
               if len(self.engines) > 1 else {}),
            "device": str(self.engine.device),
            **(self.freshness.identity() if self.freshness else {}),
            **(self.freshness.ages() if self.freshness else {}),
            **({"ingest": self.ingest_stats()}
               if self.wal is not None else {}),
            **{k: round(v, 3) for k, v in self._percentiles().items()},
            # The whole run's split (from the construction-time cursor:
            # warm-up spans never count as serving latency).
            **(self._latency_split(
                self._tracer().events_since(self._events_start_idx)[0])
               if self._tracer() is not None else {}),
            **stats[0],
            "dispatches": sum(s["dispatches"] for s in stats),
        }

    def healthz(self) -> Dict[str, Any]:
        """The /healthz payload: liveness and the summary so far."""
        return {"ok": True, "draining": self._preempted(), **self.summary()}

    def _preempted(self) -> bool:
        return self.preempt is not None and self.preempt.requested

    def _drain(self) -> Dict[str, Any]:
        """Answer every admitted query, write the final ingest
        checkpoint, stop the ingest worker; returns the summary."""
        self.replicaset.close(drain=True)
        if self.wal is not None:
            try:
                self.checkpoint_now()
            except Exception as e:  # noqa: BLE001 — drain must finish
                log.error("drain-time ingest checkpoint failed: %s", e)
        if self._ingest_worker is not None:
            self._ingest_worker.shutdown(wait=True)
        s = self.summary()
        if self.telemetry is not None:
            with contextlib.suppress(Exception):
                if self.telemetry.metrics_enabled:
                    self.telemetry.log("serve", self.answered, s)
                self.telemetry.flush()
        log.info("serve drain: %s", s)
        return s

    # -- stdin/JSONL front end ---------------------------------------------

    def run_jsonl(self, in_stream, out_stream) -> int:
        """Serve line-delimited JSON until EOF or a drain request;
        answers go out in request order, then the drain summary.
        Returns 0 at EOF, :data:`EXIT_PREEMPTED` after a drain."""
        self.replicaset.start()
        pending: collections.deque = collections.deque()

        def emit(obj) -> None:
            out_stream.write(json.dumps(obj) + "\n")
            out_stream.flush()

        def flush_ready(block: bool) -> None:
            while pending:
                rec_id, fut, t0 = pending[0]
                if not block and not fut.done():
                    return
                try:
                    answer = self._account(fut.result(timeout=120.0), t0)
                except Exception as e:  # noqa: BLE001 — answer the failure
                    with self._lock:
                        self.errors += 1
                    answer = {"id": rec_id, "error": str(e)}
                pending.popleft()
                emit(answer)

        # A reader thread blocks in readline and feeds a queue, so answers
        # flush within poll_s while the input is idle, and a drain request
        # is noticed while the reader is blocked.
        lines_q: queue.Queue = queue.Queue()
        eof_mark = object()

        def _read() -> None:
            try:
                for line in iter(in_stream.readline, ""):
                    lines_q.put(line)
            except (OSError, ValueError) as e:
                log.warning("jsonl reader: %s", e)
            finally:
                lines_q.put(eof_mark)

        threading.Thread(target=_read, daemon=True,
                         name="serve-jsonl-reader").start()
        preempted = False
        try:
            while True:
                if self._preempted():
                    preempted = True
                    break
                try:
                    line = lines_q.get(timeout=self.cfg.poll_s)
                except queue.Empty:
                    flush_ready(block=False)
                    continue
                if line is eof_mark:
                    break
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                    if not isinstance(rec, dict):
                        raise ValueError("a request must be a JSON object")
                except ValueError as e:
                    emit(self._refuse(None, f"bad request JSON: {e}"))
                    continue
                if "ingest" in rec:
                    # Earlier answers first: the output stays in request
                    # order.
                    flush_ready(block=True)
                    emit(self._handle_ingest(rec))
                    self._maybe_checkpoint()
                    continue
                try:
                    fut, t0 = self.submit(rec)
                    pending.append((rec.get("id"), fut, t0))
                except QueueFullError as e:
                    flush_ready(block=True)
                    emit({"id": rec.get("id"), "error": str(e)})
                flush_ready(block=False)
        finally:
            self.replicaset.close(drain=True)
            flush_ready(block=True)
            emit(self._drain())
        return EXIT_PREEMPTED if (preempted or self._preempted()) else 0

    # -- localhost HTTP front end ------------------------------------------

    def run_http(self, port: int, host: str = "127.0.0.1",
                 out_stream=None) -> int:
        """Serve HTTP until a drain request (the only way out besides an
        error), then drain: requests that arrive meanwhile get 503, every
        request in flight gets its reply, and the drain answers every
        admitted query before this returns :data:`EXIT_PREEMPTED`.
        ``port`` 0 takes an ephemeral port (``self.http_port`` holds the
        bound one); ``out_stream`` gets a ``serve_listening`` record
        with it first and the ``serve_drain`` summary last."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        server_ref = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # route through logging
                log.debug("http: " + fmt, *args)

            def _send(self, code: int, obj) -> None:
                body = (json.dumps(obj) + "\n").encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, server_ref.healthz())
                elif self.path == "/metrics":
                    self._send(404, {
                        "error": "live observatory not enabled "
                                 "(serve --live-obs)"})
                else:
                    self._send(404, {"error": "unknown path"})

            def do_POST(self):
                if self.path != "/query":
                    self._send(404, {"error": "unknown path"})
                    return
                with server_ref._inflight_cv:
                    if server_ref._preempted():
                        draining = True
                    else:
                        draining = False
                        server_ref._inflight += 1
                if draining:
                    self._send(503, {"error": "draining"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    raw = self.rfile.read(length).decode("utf-8", "replace")
                    try:
                        lines = [ln for ln in raw.splitlines() if ln.strip()]
                        recs = [json.loads(ln) for ln in lines]
                    except ValueError as e:
                        self._send(400, {"error": f"bad request JSON: {e}"})
                        return
                    if not recs:
                        self._send(400, {"error": "empty request"})
                        return
                    answers = server_ref.handle_many(recs)
                    self._send(200, answers[0] if len(answers) == 1
                               else answers)
                finally:
                    with server_ref._inflight_cv:
                        server_ref._inflight -= 1
                        server_ref._inflight_cv.notify_all()

        def emit(obj) -> None:
            if out_stream is not None:
                out_stream.write(json.dumps(obj) + "\n")
                out_stream.flush()

        self.replicaset.start()
        httpd = ThreadingHTTPServer((host, port), Handler)
        self.http_port = int(httpd.server_address[1])
        log.info("serving on http://%s:%d (POST /query, GET /healthz)",
                 host, self.http_port)
        emit({"event": "serve_listening", "host": host,
              "port": self.http_port})
        accept = threading.Thread(
            target=httpd.serve_forever, kwargs={"poll_interval": 0.05},
            name="serve-http-accept", daemon=True)
        accept.start()
        try:
            while not self._preempted():
                time.sleep(self.cfg.poll_s)
        finally:
            # Admission has stopped (new POSTs get 503): let every
            # request in flight finish on the running tier, then drain.
            with self._inflight_cv:
                self._inflight_cv.wait_for(lambda: self._inflight == 0,
                                           timeout=120.0)
            summary = self._drain()
            httpd.shutdown()
            httpd.server_close()
            accept.join(timeout=10.0)
        emit(summary)
        return EXIT_PREEMPTED
