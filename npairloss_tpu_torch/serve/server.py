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
    ``GET /metrics``: the live observatory's registry in Prometheus
    text when the server has one (``live=``, ``serve --live-obs``),
    else a 404, as JAX's.  With ``live`` set, ``/healthz`` also carries
    the per-SLO status and the active alerts.
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
``w`` holds every acked record up to ``w``.  As in JAX, applying a
record only adds it to the pending rows of the next checkpoint (``serve
--wal-dir``'s ``_IngestCheckpoints``): the served index never changes in
place, and acked rows reach answers through a published checkpoint and
then a hot-swap or a restart.  Every ``checkpoint_every`` records an
index checkpoint is published at the applied watermark, after which the
WAL segments it covers are GC'd.  The HTTP front end takes ingest
records in a ``POST /query`` body as the JSONL front end takes them on
stdin.

Shutdown: SIGTERM/SIGINT set the ``PreemptionSignal``; the front end
stops admitting (HTTP answers 503 ``{"error": "draining"}``), every
admitted query is answered, a final ingest checkpoint is written, the
``serve_drain`` summary is the last record, and the exit code is
:data:`EXIT_PREEMPTED` (75).  The summary's counters satisfy ``queries
== answered + (errors - errors_refused) + rejected``: ``errors_refused``
counts records refused before admission (bad JSON), which are errors
but never queries; ``queries_dropped`` is the residual, present when
nonzero or with ``explicit_drops``.

Admission control (``admission``: a ``serve.admission.
AdmissionController``, ``serve --admission slo`` or the forced-only one
that ``--remediate``'s ``load_shed`` engages): a shed query is refused
with :class:`QueueFullError` before the batcher and counted in
``rejected``; window rows gain ``shed`` and the summary ``shed`` and
``shedding``.  :meth:`RetrievalServer.rewarm` is the re-warm action; the
summary and ``/healthz`` carry the attached remediation engine's last
action per policy (``remediation``).

Hot-swap (:meth:`RetrievalServer.swap_engines`, driven by
``serve/hotswap.py`` and ``obs/quality/escalate.py``): a fresh tier,
built and warmed off the serving path, is published by flipping each
replica's engine pointer under the ingest lock and then the server lock;
each replica's next batch runs on the new tier, a batch in flight
finishes on the engine it started with, and the freshness identity flips
with the tier.  ``hot_swaps`` joins the summary and ``/healthz`` once a
swap happened, and qtrace marks each flip (``hotswap_flip``).  The old
tier's memory outlives every batch that started on it: a dispatch holds
its engine, and through it the old index and model, until its results
are on the host, the engine's one sync point, which also completes the
replica stream's reads; only then can the caching allocator hand those
blocks to the new tier.

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

Tenant mode (:meth:`RetrievalServer.enable_tenants`, ``serve
--tenant-config``; ``serve/tenants.py``), as JAX's: one front end and one
replica tier serve many galleries.  Every query and ingest record names
a registered ``tenant``; an unknown or missing one is refused as a
malformed request (an error, never a query).  A micro-batch is split by
tenant and each group runs on its tenant's engine for that replica; the
answers carry ``tenant``, the tenant's freshness ages and go to the
tenant's shadow scorer.  Each tenant has its own counters, latency
rings, quota (a token bucket: "quota exceeded for tenant ..."),
admission controller, WAL and hot-swap (:meth:`swap_tenant_engines`);
one tenant-stamped ``serve`` row per tenant that answered closes each
window, and the summary gains a ``tenants`` block and
``errors_unattributed`` (the refusals no tenant owns).

Query tracing (``qtrace``: an ``obs.qtrace.QueryTracer``, ``serve
--qtrace``): a trace id is assigned at ingestion on both front ends and
rides the record (``rec["_qt"]``) through admission (``admit_wait``),
the replica's queue (``queue_wait``, ended by the batcher's
``on_pick``), coalescing (``batch_assemble``) and the dispatch
(``dispatch``, with the engine's ``score`` and ``topk_merge`` split back
out of it, wrapped in ``probe_fused`` on the fused probe path); a
replica crash leaves a ``crash_reroute`` marker; window rows gain
``qtrace_dominant``/``qtrace_dominant_ms`` and the summary a ``qtrace``
block; the drain writes the tracer's artifact.  Shadow scoring
(``shadow``: an ``obs.quality.shadow.ShadowScorer``, ``serve
--shadow-rate``): each answered query is offered to the scorer after
the answers exist (a hash and a bounded put; a failed offer never fails
an answer), and the summary gains a ``quality`` block.  With neither
attached every stream is what it was.
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


class UnknownTenantError(ValueError):
    """A record named a tenant the registry does not know.  Raised from
    ``submit`` BEFORE the query is counted: an unregistered id is a
    malformed request (the bad-JSON accounting: errors, never
    queries/rejected), not admitted-then-shed traffic."""


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
                 telemetry=None, qtrace=None, live=None, admission=None,
                 input_shape=None):
        engines = (list(engine) if isinstance(engine, (list, tuple))
                   else [engine])
        self.engines: List[QueryEngine] = engines
        self.engine = engines[0]
        self.cfg = cfg
        self.preempt = preempt
        self.freshness = freshness
        self.telemetry = telemetry
        # The optional LiveObservatory (obs.live): /metrics exposition
        # and SLO status on /healthz.  None keeps the server as it was.
        self.live = live
        # The query tracer and the shadow scorer (set after construction,
        # as JAX's): None keeps every stream what it was without them.
        self.qtrace = qtrace
        self.shadow = None
        # SLO-burn-driven admission control (serve/admission.py): when
        # set, submits consult it BEFORE routing; a shed is a fast-reject
        # counted in ``rejected``.
        self.admission = admission
        # The raw-input shape encode-path re-warms need (None: embedding
        # queries only), and the optional RemediationEngine whose last
        # action per policy the summary and /healthz carry.
        self.input_shape = (tuple(input_shape)
                            if input_shape is not None else None)
        self.remediation = None
        # serve --tenant-config's per-tenant hot-swap sweep (a
        # ``serve.tenants.TenantSwapper``), stopped by the CLI's
        # close_observers.
        self.tenant_swapper = None
        # Engine-tier republishes (swap_engines): absent from the summary
        # until the first.
        self.swaps = 0  # guarded-by: _lock
        # Set by a re-warm: from then on the window rows carry
        # compiles_after_warmup even at zero, so the watchdog sees the
        # recovery (a clean run keeps the key absent at zero).
        self._explicit_compile_key = False
        self.replicaset = ReplicaSet(
            engines, batcher_cfg, self._replica_dispatch,
            span_fn=self._span, on_batch=self._record_batch,
            on_pick=self._qtrace_pick if qtrace is not None else None)
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
        # Tenant mode: empty until ``enable_tenants`` installs the map,
        # so a single-tenant server keeps every stream as it was.  One
        # commit lock a tenant: a tenant's ingests commit one at a time,
        # so they apply in seq order.
        self.tenants: Dict[str, Any] = {}
        self._replica_idx: Dict[str, int] = {}
        self._tenant_commit_locks: Dict[str, threading.Lock] = {}
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
            return self._dispatch(items, engine=replica.engine,
                                  replica=replica.name)

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
        if self.qtrace is not None:
            # The reroute instant explains the detour in any exemplar
            # that rode it.
            self.qtrace.marker("crash_reroute", dead=dead.name,
                               target=target.name, queries=len(items))
        return self._dispatch(items, engine=target.engine,
                              replica=target.name)

    # -- telemetry ---------------------------------------------------------

    def _span(self, name: str, **args):
        if self.telemetry is None:
            return contextlib.nullcontext()
        return self.telemetry.span(name, **args)

    def _record_batch(self, stats: Dict[str, Any]) -> None:
        self._last_batch = stats

    # -- qtrace glue (no-ops unless a QueryTracer is attached) -------------

    def _qtrace_begin(self, rec):
        """Assign a trace id at ingestion; the context rides the record
        itself, so the batcher and replica threads need no side
        channel."""
        if self.qtrace is None or not isinstance(rec, dict):
            return None
        qt = self.qtrace.begin(rec.get("id"))
        rec["_qt"] = qt
        return qt

    def _qtrace_pick(self, item) -> None:
        """The batcher's ``on_pick``: the dispatcher pulled this record
        off its replica's queue — ``queue_wait`` ends."""
        qt = item.get("_qt") if isinstance(item, dict) else None
        if qt is not None:
            self.qtrace.picked(qt)

    def _qtrace_drop(self, qt, error: bool = False) -> None:
        """A query that will never be answered: counted by the tracer,
        kept out of both aggregation populations (as out of the latency
        rings)."""
        if qt is not None and self.qtrace is not None:
            self.qtrace.drop(qt, error=error)

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

    def _dispatch(self, items: List[Dict[str, Any]],
                  engine: Optional[QueryEngine] = None,
                  replica: Optional[str] = None) -> List[Dict[str, Any]]:
        """The replicas' dispatch.  Single-tenant: straight to the core.
        Tenant mode: a micro-batch may hold queries for several tenants
        (the batchers are shared), so it splits by tenant and each group
        runs on its tenant's engine for THIS replica; the answers keep
        the items' order."""
        if not self.tenants:
            return self._dispatch_core(items, engine=engine, replica=replica)
        ridx = self._replica_idx.get(replica, 0)
        groups: Dict[Any, List[int]] = {}
        for i, rec in enumerate(items):
            tid = rec.get("tenant") if isinstance(rec, dict) else None
            groups.setdefault(tid, []).append(i)
        answers: List[Optional[Dict[str, Any]]] = [None] * len(items)
        for tid, idxs in groups.items():
            entry = self.tenants.get(tid)
            if entry is None:
                # submit() refuses unknown tenants; a record that lost its
                # id since still answers instead of failing its co-riders.
                for i in idxs:
                    answers[i] = {"id": items[i].get("id"), "tenant": tid,
                                  "error": f"unknown tenant {tid!r}"}
                continue
            eng = entry.engines[ridx if ridx < len(entry.engines) else 0]
            group = self._dispatch_core([items[i] for i in idxs], engine=eng,
                                        replica=replica, entry=entry)
            for i, ans in zip(idxs, group):
                answers[i] = ans
        return answers

    def _dispatch_core(self, items: List[Dict[str, Any]],
                       engine: Optional[QueryEngine] = None,
                       replica: Optional[str] = None,
                       entry=None) -> List[Dict[str, Any]]:
        """Coalesced records -> per-record answers.  A malformed record
        answers ``{"id", "error"}`` without failing its co-riders; raw
        inputs encode as one stacked batch, then join the embedding rows
        for one top-k dispatch.  ``entry`` (tenant mode) scopes the
        answers' ``tenant`` key, the freshness stamps and the shadow
        offer to one tenant."""
        engine = self.engine if engine is None else engine
        tstamp = {"tenant": entry.tenant_id} if entry is not None else {}
        qts = ([qt for it in items
                if isinstance(it, dict) and (qt := it.get("_qt")) is not None]
               if self.qtrace is not None else [])
        if qts:
            # batch_assemble ends here; everything from here to the
            # answers is the dispatch stage (score and topk_merge are
            # split back out of it below).
            self.qtrace.dispatch_begin(qts, replica=replica)
        stages: Optional[Dict[str, float]] = {} if qts else None
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
                answers[i] = {"id": rec.get("id"), **tstamp, "error": str(e)}
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
                    answers[i] = {"id": items[i].get("id"), **tstamp,
                                  "error": str(e)}
        t_merge = 0.0
        if emb_rows:
            out = engine.query(np.stack([x for _, x in emb_rows]),
                               stages=stages)
            t_asm0 = time.perf_counter()
            # The tenant's freshness in tenant mode.
            fresh = entry.freshness if entry is not None else self.freshness
            ages = fresh.ages() if fresh is not None else {}
            for j, (i, _) in enumerate(emb_rows):
                answers[i] = {
                    "id": items[i].get("id"),
                    **tstamp,
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
            # Answer assembly joins the device top-k with labels, ids
            # and freshness: merge work, so topk_merge, not dispatch.
            t_merge = time.perf_counter() - t_asm0
            # The tenant's own scorer in tenant mode: its oracle is that
            # tenant's gallery.
            shadow = entry.shadow if entry is not None else self.shadow
            if shadow is not None:
                # After the answers exist: a hash and a bounded put per
                # sampled query, never a wait; the raw query row (the
                # oracle normalizes it as the engine did).
                try:
                    for j, (i, row) in enumerate(emb_rows):
                        shadow.offer(items[i].get("id"), row,
                                     out["rows"][j], out["scores"][j])
                except Exception as e:  # noqa: BLE001 — shadow must not fail answers
                    log.error("shadow offer failed: %s", e)
        if qts:
            self.qtrace.dispatch_end(
                qts, score_us=(stages or {}).get("score_us", 0.0),
                merge_us=(stages or {}).get("merge_us", 0.0) + t_merge * 1e6,
                # The fused probe: score and merge came out of one
                # kernel, wrapped in a probe_fused span.
                fused=getattr(engine, "probe_impl", None) == "fused")
        return answers

    # -- admission and accounting ------------------------------------------

    def submit(self, record: Dict[str, Any]):
        """Admit one record; returns (future, t_submit).  Raises
        :class:`QueueFullError` on backpressure, a whole-tier loss or an
        admission shed (all counted in rejected)."""
        qt = (record.get("_qt")
              if self.qtrace is not None and isinstance(record, dict)
              else None)
        # The tenant is resolved before any counting: an unknown one is a
        # malformed request (UnknownTenantError -> errors, as bad JSON),
        # never an admitted-then-shed query.
        entry = self._tenant_entry(record) if self.tenants else None
        if entry is not None and qt is not None:
            qt.tenant = entry.tenant_id
        with self._span("serve/admit"):
            with self._lock:
                self.queries += 1
                if entry is not None:
                    entry.queries += 1
            if entry is not None and entry.quota is not None and \
                    not entry.quota.admit():
                # This tenant's token bucket ran dry: its neighbors'
                # queues and counters never see the query.
                with self._lock:
                    entry.rejected += 1
                raise QueueFullError(
                    f"quota exceeded for tenant {entry.tenant_id!r}; retry "
                    "after backoff")
            if entry is not None and entry.admission is not None and \
                    not entry.admission.admit(trace=qt):
                with self._lock:
                    entry.rejected += 1
                raise QueueFullError(
                    f"load shed: tenant {entry.tenant_id!r} SLO burning "
                    "(admission control); retry after backoff")
            if self.admission is not None and \
                    not self.admission.admit(trace=qt):
                if entry is not None:
                    # A tier-wide shed, attributed to the tenant whose
                    # query it refused.
                    with self._lock:
                        entry.rejected += 1
                raise QueueFullError(
                    "load shed: SLO burning (admission control); retry "
                    "after backoff")
            if qt is not None:
                # admit_wait closes BEFORE the enqueue: the queue put is
                # the only ordering edge between this thread and picked.
                self.qtrace.admitted(qt)
            try:
                fut = self.replicaset.submit(record)
            except QueueFullError:
                if entry is not None:
                    # Backpressure lands on the submitting tenant too.
                    with self._lock:
                        entry.rejected += 1
                raise
            return fut, time.perf_counter()

    def _record_latency(self, seconds: float, qt=None, entry=None) -> None:
        if qt is not None and self.qtrace is not None:
            # Before the window check, so the query that closes a window
            # lands in that window's stage decomposition too.
            self.qtrace.finish(qt)
        row = None
        with self._lock:
            self._lat.append(seconds * 1e3)
            self.answered += 1
            if entry is not None:
                # The tenant's own rings: its p99 SLO burns on its tail.
                entry.answered += 1
                entry.lat.append(seconds * 1e3)
                if self.cfg.metrics_window:
                    entry.window_lat.append(seconds * 1e3)
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
               "rejected": self._rejected_total(),
               **self._window_latency_split(),
               # This window's dominant stage among its worst queries
               # (absent with qtrace off).
               **(self.qtrace.window_row()
                  if self.qtrace is not None else {}),
               **{f"batch_{k}": round(v, 3) if isinstance(v, float) else v
                  for k, v in self._last_batch.items()}}
        if len(self.engines) > 1:
            row["replicas_alive"] = self.replicaset.alive_count
        compiles = self._compiles_after_warmup()
        if compiles or self._explicit_compile_key:
            # Present only when > 0 (clean streams stay what they were),
            # or at 0 too after a re-warm: the live-obs post-warmup-
            # compile watchdog reads exactly this key, and absent at 0
            # would starve it of the good samples a resolve needs.
            row["compiles_after_warmup"] = compiles
        if self.admission is not None and self.admission.sheds:
            # Last: the registry sink maps it to gauge ``serve_shed``,
            # the name the controller's shed counter already holds, and
            # stops the row there (JAX's row puts it before the compile
            # key, which the watchdog then never sees once a shed ran).
            row["shed"] = self.admission.sheds
        if self.telemetry is not None and self.telemetry.metrics_enabled:
            try:
                self.telemetry.log("serve", self.answered, row)
            except Exception as e:  # noqa: BLE001 — telemetry is not the run
                log.error("serve metrics emission failed: %s", e)
        log.info("serve window: %s", row)
        if self.tenants:
            self._emit_tenant_windows()

    def _emit_tenant_windows(self) -> None:
        """One tenant-stamped row per tenant that answered this window:
        the ``tenant`` key makes the registry sink land its metrics on
        labeled series (``serve_p99_ms{tenant="a"}``), the streams the
        tenant's SLOs burn on; a quiet tenant emits nothing."""
        snaps: List[tuple] = []
        with self._lock:
            for tid in sorted(self.tenants):
                entry = self.tenants[tid]
                lat = entry.take_window()
                if lat:
                    snaps.append((tid, entry, lat))
        for tid, entry, lat in snaps:
            trow = {"tenant": tid, "queries": len(lat),
                    **{k: round(v, 3)
                       for k, v in self._percentiles(lat).items()}}
            if entry.quota is not None and entry.quota.sheds:
                trow["quota_sheds"] = entry.quota.sheds
            if entry.rejected:
                trow["rejected"] = entry.rejected
            if entry.admission is not None and entry.admission.sheds:
                # Last, as in the tier's row: the sink stops a row at
                # ``shed`` (the controller's ``serve_shed`` counter holds
                # that name), so a key after it would never land.
                trow["shed"] = entry.admission.sheds
            if self.telemetry is not None and self.telemetry.metrics_enabled:
                try:
                    self.telemetry.log("serve", self.answered, trow)
                except Exception as e:  # noqa: BLE001 — telemetry is not the run
                    log.error("tenant %r metrics emission failed: %s", tid,
                              e)
            log.info("serve tenant window: %s", trow)

    def _account(self, answer: Dict[str, Any], t0: float,
                 qt=None) -> Dict[str, Any]:
        """An ``{"id", "error"}`` answer counts as an error, any other as
        an answered query with its latency, attributed in tenant mode to
        the answer's ``tenant``."""
        entry = (self.tenants.get(answer.get("tenant"))
                 if self.tenants and isinstance(answer, dict) else None)
        if "error" in answer:
            with self._lock:
                self.errors += 1
                if entry is not None:
                    entry.errors += 1
            self._qtrace_drop(qt, error=True)
        else:
            self._record_latency(time.perf_counter() - t0, qt, entry=entry)
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
                    None, "a request must be a JSON object"), None, None))
                continue
            if "ingest" in rec:
                staged.append((rec, self._handle_ingest(rec), None, None))
                self._maybe_checkpoint()
                continue
            qt = self._qtrace_begin(rec)
            try:
                fut, t0 = self.submit(rec)
                staged.append((rec, fut, t0, qt))
            except UnknownTenantError as e:
                # Never admitted: an error, never a query.
                self._qtrace_drop(qt, error=True)
                staged.append((rec, self._refuse(rec.get("id"), str(e)),
                               None, None))
            except QueueFullError as e:
                # Counted in rejected, never also in errors.
                self._qtrace_drop(qt)
                staged.append((rec, {"id": rec.get("id"),
                                     "error": str(e)}, None, None))
        answers = []
        for rec, fut, t0, qt in staged:
            if t0 is None:
                answers.append(fut)
                continue
            try:
                answer = fut.result(timeout=timeout)
            except Exception as e:  # noqa: BLE001 — answer the failure
                with self._lock:
                    self.errors += 1
                self._qtrace_drop(qt, error=True)
                answers.append({"id": rec.get("id"), "error": str(e)})
                continue
            answers.append(self._account(answer, t0, qt))
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
        # Before the front end starts: no ingest thread exists yet, so
        # the watermarks are set without their lock.
        self._ingest_watermark = int(watermark)  # unguarded-ok: startup
        self._ckpt_watermark = int(  # unguarded-ok: startup
            checkpoint_watermark)
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

    def _ingest_error(self, rid, message: str,
                      tenant: Optional[str] = None) -> Dict[str, Any]:
        with self._lock:
            self.ingest_errors += 1
        return {"id": rid, **({"tenant": tenant} if tenant else {}),
                "error": message}

    def _handle_ingest(self, rec: Dict[str, Any]) -> Dict[str, Any]:
        """One ingest record, start to ack: encode -> WAL append ->
        durability barrier -> apply -> ack.  The ack never precedes the
        fsync covering the record."""
        rid = rec.get("id")
        if self.tenants:
            # Tenant mode: the record goes to its tenant's own WAL and
            # watermark.
            try:
                entry = self._tenant_entry(rec)
            except UnknownTenantError as e:
                return self._ingest_error(rid, str(e))
            return self._tenant_ingest(entry, rec)
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

    def _tenant_ingest(self, entry, rec: Dict[str, Any]) -> Dict[str, Any]:
        """One tenant's ingest record through its own durability domain
        (``serve/tenants.py`` ``TenantIngest``): encode -> WAL append ->
        fsync -> apply -> ack, as the single-tenant path, against the
        tenant's WAL and watermark; the tier's ingest counters tick too.
        The tenant's commits run one at a time, so its records apply in
        seq order (concurrent commits would let seq 2's apply overtake
        seq 1's, and a checkpoint between them pass an acked row)."""
        rid = rec.get("id")
        tid = entry.tenant_id
        ing = entry.ingest
        if ing is None:
            return self._ingest_error(
                rid, f"tenant {tid!r} ingest requires a WAL (serve "
                "--wal-dir)", tid)
        try:
            body = encode_ingest_body(rec.get("ingest"))
            dim = entry.engines[0].index.dim
            if body["dim"] != dim:
                # Refused before the append: a logged record that can
                # never apply would fail every later checkpoint.
                raise ValueError(f"ingest dim {body['dim']} does not match "
                                 f"gallery dim {dim}")
        except (ValueError, TypeError) as e:
            ing.note_error()
            return self._ingest_error(rid, f"bad ingest record: {e}", tid)
        try:
            with self._tenant_commit_locks[tid]:
                seq = ing.commit(body)
        except Exception as e:  # noqa: BLE001 — the client must hear "not durable"
            ing.note_error()
            log.error("tenant %r ingest %r failed before durability: %s",
                      tid, rid, e)
            return self._ingest_error(rid, f"ingest not durable: {e}", tid)
        n = len(body["ids"])
        with self._lock:
            self.ingest_batches += 1
            self.ingest_vectors += n
        ing.maybe_checkpoint()
        return {"id": rid, "tenant": tid, "ingested": n, "seq": seq}

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
                - self._rejected_total())

    def _rejected_total(self) -> int:
        """Every rejection source, once each: batcher backpressure, a
        whole-tier loss and admission sheds — the ``rejected`` term of
        the drain invariant."""
        total = self.replicaset.rejected
        if self.admission is not None:
            total += self.admission.sheds
        for entry in self.tenants.values():
            # A tenant's quota and admission sheds reach neither the
            # replica set nor the tier's controller, so adding them counts
            # nothing twice; backpressure and tier-wide sheds were counted
            # above and only attributed to entry.rejected.
            if entry.quota is not None:
                total += entry.quota.sheds
            if entry.admission is not None:
                total += entry.admission.sheds
        return total

    def _compiles_after_warmup(self) -> int:
        # Replicas, and tenants of one geometry, share one signature set,
        # so the sum never counts a signature twice.
        return sum(e.compiles_after_warmup for e in self._all_engines())

    # -- tenant mode (serve/tenants.py) -------------------------------------

    def enable_tenants(self, entries: Dict[str, Any]) -> None:
        """Install the tenant map (at startup, before the front end): one
        ``TenantEntry`` per tenant id, each with one engine per replica
        (replica r serves tenant t from ``entry.engines[r]``, so the
        tier's batchers stay shared while every tenant answers from its
        own gallery)."""
        if self.tenants:
            raise ValueError("tenant map already installed")
        entries = dict(entries)
        if not entries:
            raise ValueError("enable_tenants needs >= 1 tenant entry")
        for tid, entry in entries.items():
            if len(entry.engines) != len(self.engines):
                raise ValueError(
                    f"tenant {tid!r} has {len(entry.engines)} engine(s); "
                    f"the replica tier has {len(self.engines)}")
        self.tenants = entries
        self._tenant_commit_locks = {tid: threading.Lock()
                                     for tid in entries}
        self._replica_idx = {rep.name: i for i, rep
                             in enumerate(self.replicaset.replicas)}

    def _tenant_entry(self, record) -> Any:
        """The entry a record routes to (tenant mode only); raises
        :class:`UnknownTenantError` for a missing or unregistered id."""
        tid = record.get("tenant") if isinstance(record, dict) else None
        entry = self.tenants.get(tid)
        if entry is None:
            raise UnknownTenantError(
                f"unknown tenant {tid!r} (registered: "
                f"{sorted(self.tenants)})")
        return entry

    def swap_tenant_engines(self, tenant_id: str, engines,
                            freshness: Optional[Freshness] = None) -> None:
        """Atomically republish ONE tenant's engine set: ``swap_engines``
        scoped to an entry.  Every other tenant's engines are untouched;
        a batch in flight finishes on the engines it started with (the
        dispatch reads ``entry.engines`` once a batch).  The flip holds
        the tenant's ingest lock, then the server lock, as the tier's."""
        entry = self.tenants.get(tenant_id)
        if entry is None:
            raise UnknownTenantError(
                f"unknown tenant {tenant_id!r} (registered: "
                f"{sorted(self.tenants)})")
        engines = list(engines)
        if len(engines) != len(entry.engines):
            raise ValueError(
                f"tenant {tenant_id!r} swap must preserve the replica "
                f"count: got {len(engines)}, entry has "
                f"{len(entry.engines)}")
        ingest_lock = (entry.ingest.lock if entry.ingest is not None
                       else contextlib.nullcontext())
        with ingest_lock:
            with self._lock:
                entry.engines = engines
                if freshness is not None:
                    entry.freshness = freshness
                entry.swaps += 1
                self.swaps += 1
                generation = self.swaps
        if self.qtrace is not None:
            self.qtrace.marker("hotswap_flip", generation=generation,
                               tenant=tenant_id)
        log.warning("hot-swap %d: tenant %r republished (%s)", generation,
                    tenant_id,
                    freshness.identity() if freshness else "same identity")

    def _all_engines(self) -> List[QueryEngine]:
        """Every distinct engine behind the tier: the replica anchors and
        each tenant's set, deduplicated (the first tenant's engines are
        ``self.engines`` until it swaps); compile counts sum over it."""
        seen: Dict[int, QueryEngine] = {id(e): e for e in self.engines}
        for entry in self.tenants.values():
            for e in entry.engines:
                seen.setdefault(id(e), e)
        return list(seen.values())

    # -- remediation actuators ---------------------------------------------

    def rewarm(self) -> Dict[str, Any]:
        """Re-warm every padding bucket and reset the tier's post-warmup
        compile counters — the compile-storm remediation action, as
        JAX's.  The primary re-dispatches (its stream, the layout read
        once a dispatch); replicas share its signatures and only reset
        their counters.  From here on the window rows carry an EXPLICIT
        ``compiles_after_warmup`` (including 0) so the watchdog sees
        recovery."""
        dt = self.engine.rewarm(self.input_shape)
        for e in self.engines[1:]:
            with e._count_lock:
                e.compiles_after_warmup = 0
        for entry in self.tenants.values():
            # Each tenant's primary re-dispatches its buckets (a shared
            # signature set makes repeats free); replicas reset counters.
            if entry.engines[0] is not self.engine:
                dt += entry.engines[0].rewarm(self.input_shape)
            for e in entry.engines[1:]:
                if e is not self.engine:
                    with e._count_lock:
                        e.compiles_after_warmup = 0
        self._explicit_compile_key = True
        return {"warmup_s": round(dt, 3)}

    def swap_engines(self, engines, freshness: Optional[Freshness] = None,
                     prepare: Optional[Callable[[], None]] = None) -> None:
        """Atomically publish a fresh engine tier, as JAX's: the hot-swap
        commit point.  The caller built AND warmed the new primary off
        the serving path (``serve/hotswap.py`` and
        ``obs/quality/escalate.py`` do); here each replica's engine
        pointer flips, so its next batch dispatches on the new engine
        while a batch in flight finishes on the one it started with.
        ``freshness`` flips with the tier (None keeps the served
        identity: a probe escalation is no freshness event);
        ``prepare`` runs under the ingest lock, at the flip."""
        engines = list(engines)
        if len(engines) != len(self.engines):
            raise ValueError(
                f"swap must preserve the replica count: got "
                f"{len(engines)}, tier has {len(self.engines)}")
        # Under the ingest lock, so a durable-ingest apply or checkpoint
        # never races the republish; _lock nests inside it, as always.
        with self._ingest_lock:
            if prepare is not None:
                prepare()
            with self._lock:
                self.engines = engines
                self.engine = engines[0]
                if freshness is not None:
                    self.freshness = freshness
                self.swaps += 1
                generation = self.swaps
            for rep, eng in zip(self.replicaset.replicas, engines):
                rep.engine = eng
        if self.qtrace is not None:
            # Answers after this marker come from the new tier: a tail
            # spike beside it is swap cost, not load.
            self.qtrace.marker("hotswap_flip", generation=generation)
        log.warning("hot-swap %d: serving tier republished (%s)",
                    generation,
                    freshness.identity() if freshness else "same identity")

    def summary(self) -> Dict[str, Any]:
        dropped = self._queries_dropped()
        stats = [e.stats() for e in self._all_engines()]
        return {
            "event": "serve_drain",
            "queries": self.queries,
            "answered": self.answered,
            "errors": self.errors,
            "errors_refused": self.errors_refused,
            "rejected": self._rejected_total(),
            **({"queries_dropped": dropped}
               if (dropped or self.cfg.explicit_drops) else {}),
            "batches": self.replicaset.batches,
            **({"replicas": len(self.engines),
                "replicas_alive": self.replicaset.alive_count}
               if len(self.engines) > 1 else {}),
            **({"shed": self.admission.sheds,
                "shedding": (self.admission.shedding
                             or self.admission.forced)}
               if self.admission is not None else {}),
            "device": str(self.engine.device),
            **(self.freshness.identity() if self.freshness else {}),
            **(self.freshness.ages() if self.freshness else {}),
            # The hot-swap count (absent until the tier swapped).
            **({"hot_swaps": self.swaps} if self.swaps else {}),
            # The last remediation per policy (key absent = the policy
            # never fired; block absent = no engine attached).
            **({"remediation": self.remediation.last_by_policy()}
               if self.remediation is not None else {}),
            **({"ingest": self.ingest_stats()}
               if self.wal is not None else {}),
            # The online recall estimate and the per-stage p99 budget:
            # each block absent when its observatory is off.
            **({"quality": self.shadow.stats()}
               if self.shadow is not None else {}),
            **({"qtrace": self.qtrace.summary_block()}
               if self.qtrace is not None else {}),
            # Tenant mode: one block per tenant (counters, freshness,
            # quota, shed, ingest, quality), and the errors no tenant owns
            # (unknown-tenant refusals, bad JSON), so the per-tenant
            # counters cross-sum exactly into the aggregates.
            **({"tenants": {tid: self.tenants[tid].stats_block()
                            for tid in sorted(self.tenants)}}
               if self.tenants else {}),
            **({"errors_unattributed": self.errors - sum(
                e.errors for e in self.tenants.values())}
               if self.tenants else {}),
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
        """The /healthz payload: liveness and the summary so far, with
        the per-SLO status and the active alerts when a LiveObservatory
        is attached."""
        out = {"ok": True, "draining": self._preempted(), **self.summary()}
        if self.admission is not None:
            out["admission"] = self.admission.stats()
        if self.live is not None:
            out.update(self.live.health())
        return out

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
        for tid in sorted(self.tenants):
            # Each tenant's durability domain, one failure contained.
            ing = self.tenants[tid].ingest
            if ing is None:
                continue
            try:
                ing.checkpoint_now()
            except Exception as e:  # noqa: BLE001 — drain must finish
                log.error("drain-time tenant %r checkpoint failed: %s", tid,
                          e)
        if self._ingest_worker is not None:
            self._ingest_worker.shutdown(wait=True)
        s = self.summary()
        if self.qtrace is not None and self.qtrace.out_path:
            try:
                self.qtrace.write()
            except Exception as e:  # noqa: BLE001 — the artifact is not the run
                log.error("qtrace artifact write failed: %s", e)
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
                rec_id, fut, t0, qt = pending[0]
                if not block and not fut.done():
                    return
                try:
                    answer = self._account(fut.result(timeout=120.0), t0, qt)
                except Exception as e:  # noqa: BLE001 — answer the failure
                    with self._lock:
                        self.errors += 1
                    self._qtrace_drop(qt, error=True)
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
                qt = self._qtrace_begin(rec)
                try:
                    fut, t0 = self.submit(rec)
                    pending.append((rec.get("id"), fut, t0, qt))
                except UnknownTenantError as e:
                    # Never admitted: an error, never a query.
                    self._qtrace_drop(qt, error=True)
                    flush_ready(block=True)
                    emit(self._refuse(rec.get("id"), str(e)))
                except QueueFullError as e:
                    self._qtrace_drop(qt)
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
                    if server_ref.live is None:
                        self._send(404, {
                            "error": "live observatory not enabled "
                                     "(serve --live-obs)"})
                        return
                    from npairloss_tpu_torch.obs.live import prometheus_text

                    body = prometheus_text(server_ref.live.registry).encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
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
