"""ShadowScorer — online recall estimation by shadow-scoring live queries.
Port of ``npairloss_tpu/obs/quality/shadow.py``.

The IVF index trades recall for latency, and ``index --parity-sample``
measures that trade once, at build time.  The scorer measures it
against live traffic while the tier serves:

  * the serving dispatch **offers** every answered query; a
    deterministic hash of ``(seed, query id)`` keeps a configurable
    fraction (``--shadow-rate``) — same seed ⇒ same shadow set, so a
    replayed query stream shadows identically, in either package;
  * sampled queries land in a bounded queue (full queue = counted drop,
    NEVER a block — the serving path's latency is untouched) and a
    background thread re-scores them against a **flat exact oracle**:
    a ``GalleryIndex`` of the served rows on the served index's device
    and a ``QueryEngine`` with ``scoring="fp32"`` — the plain torch
    product with the flat engine's lowest-index top-k, the scan the
    parity stamp trusts;
  * per window of samples it emits ONE ``serve`` telemetry row
    (``recall_at_{1,5,10}``, ``shadow_score_gap``) through the run's
    ``RunTelemetry`` and one ``window`` record into the versioned
    ``npairloss-quality-v1`` log (``quality.jsonl``).

The oracle follows the SERVED index: ``index_fn`` is read per scoring
batch, and an ``add()`` (in place: same object, more rows, a new
``created`` stamp) rebuilds the oracle before the next batch scores —
shadow recall is always measured against the gallery the answers came
from.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import queue
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from npairloss_tpu_torch.obs.quality.report import QUALITY_SCHEMA

log = logging.getLogger("npairloss_tpu_torch.obs.quality")

QUALITY_FILENAME = "quality.jsonl"

_HASH_SPACE = float(2 ** 32)


def shadow_sampled(query_id: Any, rate: float, seed: int = 0) -> bool:
    """Deterministic membership of one query id in the shadow set.

    A stable CRC-32 of ``(seed, repr(id))`` against ``rate`` — NOT
    Python's salted ``hash()``, so the same seed selects the same ids
    across processes and replays (the determinism pin)."""
    if rate <= 0.0:
        return False
    if rate >= 1.0:
        return True
    h = zlib.crc32(f"{seed}:{query_id!r}".encode("utf-8"))
    return (h / _HASH_SPACE) < rate


def recall_against(served_rows: Sequence[int], exact_rows: Sequence[int],
                   k: int) -> float:
    """Per-query recall@K: |served top-K ∩ exact top-K| / K — the
    ``serve/ivf.topk_recall`` math for ONE query (host-only, so the
    window aggregation is testable against hand fixtures)."""
    s = set(int(r) for r in served_rows[:k])
    e = set(int(r) for r in exact_rows[:k])
    return len(s & e) / float(k)


@dataclasses.dataclass(frozen=True)
class ShadowConfig:
    """``rate`` is the sampled fraction of answered queries (0 disables
    — the scorer is then never constructed); ``ks`` the recall depths
    (clamped to the served ``top_k``); ``window`` the samples per
    emitted quality row; ``max_queue`` the bound on queued-but-unscored
    samples (beyond it, drops are counted, dispatches never wait);
    ``oracle_batch`` the padding bucket the oracle scores shadows in."""

    rate: float = 0.1
    ks: Tuple[int, ...] = (1, 5, 10)
    window: int = 32
    seed: int = 0
    max_queue: int = 512
    oracle_batch: int = 8
    stale_after_s: float = 60.0

    def __post_init__(self):
        if not (0.0 < self.rate <= 1.0):
            raise ValueError(
                f"shadow rate must be in (0, 1], got {self.rate} "
                "(0 means: do not build a scorer)")
        if not self.ks or list(self.ks) != sorted(set(self.ks)) \
                or min(self.ks) < 1:
            raise ValueError(
                f"ks must be ascending unique ints >= 1, got {self.ks}")
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")


class _Sample:
    __slots__ = ("qid", "embedding", "served_rows", "served_best")

    def __init__(self, qid, embedding, served_rows, served_best):
        self.qid = qid
        self.embedding = embedding
        self.served_rows = served_rows
        self.served_best = served_best


class ShadowScorer:
    """Sample, queue, oracle-score, emit — see the module docstring.

    ``index_fn`` returns the CURRENTLY served index (the server's
    ``lambda: server.engine.index``); ``telemetry`` routes the
    per-window row through the run's sink chain (and so into a live
    observatory's registry when one rides it); with no telemetry,
    ``registry`` gets the window's gauges set directly (the
    freshness-probe pattern); ``out_path`` lands ``quality.jsonl``
    (None = in-memory history only).  ``baseline`` is the served IVF
    commit's ``parity`` manifest block; ``recall_floor``/``floor_metric``
    the armed SLO's declared floor — both are stamped into the config
    record so ``prof --quality`` judges the stream without the serving
    process."""

    def __init__(
        self,
        index_fn: Callable[[], Any],
        cfg: ShadowConfig = ShadowConfig(),
        telemetry=None,
        registry=None,
        out_path: Optional[str] = None,
        baseline: Optional[Dict[str, Any]] = None,
        recall_floor: Optional[float] = None,
        floor_metric: Optional[str] = None,
    ):
        self.index_fn = index_fn
        self.cfg = cfg
        self.telemetry = telemetry
        self.registry = registry
        self.baseline = baseline
        self.recall_floor = recall_floor
        self.floor_metric = floor_metric
        self._q: queue.Queue = queue.Queue(maxsize=cfg.max_queue)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self.sampled_total = 0
        self.dropped = 0
        self.windows = 0
        # Offer-side evidence: how many queries the dispatch SAMPLED
        # (accepted or dropped) and when the last one arrived — what
        # lets the stale-shadow gate tell "scorer stalled" apart from
        # "traffic stopped" (a drain minutes after the last query is
        # healthy; offers outrunning samples is not).
        self.offered_total = 0
        self.last_offer_wall_time: Optional[float] = None
        self.last_sample_wall_time: Optional[float] = None
        self._last_window: Dict[str, Any] = {}
        self._acc: List[Dict[str, float]] = []
        self._oracle = None  # (index object, (size, created), engine)
        self.oracle_builds = 0
        self.oracle_build_s = 0.0  # wall seconds of the last rebuild
        self.history: List[Dict[str, Any]] = []
        self.out_path = os.path.abspath(out_path) if out_path else None
        self._f = None
        if self.out_path:
            parent = os.path.dirname(self.out_path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            self._f = open(self.out_path, "a", buffering=1)
        self._emit({
            "schema": QUALITY_SCHEMA,
            "kind": "config",
            "shadow_rate": cfg.rate,
            "seed": cfg.seed,
            "ks": list(cfg.ks),
            "window": cfg.window,
            "wall_time": time.time(),
            "stale_after_s": cfg.stale_after_s,
            **({"baseline": baseline} if baseline else {}),
            **({"recall_floor": recall_floor,
                "floor_metric": floor_metric}
               if recall_floor is not None else {}),
        })

    # -- the hot-path side (dispatch thread) -------------------------------

    def sampled(self, query_id: Any) -> bool:
        return shadow_sampled(query_id, self.cfg.rate, self.cfg.seed)

    def offer(self, query_id: Any, embedding: np.ndarray,
              served_rows: np.ndarray, served_scores: np.ndarray) -> bool:
        """Called by the serving dispatch per answered query: hash, and
        (when sampled) enqueue a COPY of the answer evidence.  Hash +
        ``put_nowait`` only — a full queue is a counted drop, never a
        wait; the serving path's latency is invariant to the scorer
        (the tests/test_quality.py pin)."""
        if not self.sampled(query_id):
            return False
        with self._lock:
            self.offered_total += 1
            self.last_offer_wall_time = time.time()
        sample = _Sample(
            query_id,
            np.array(embedding, np.float32, copy=True),
            np.array(served_rows, np.int32, copy=True),
            float(served_scores[0]) if len(served_scores) else 0.0,
        )
        try:
            self._q.put_nowait(sample)
        except queue.Full:
            with self._lock:
                self.dropped += 1
            return False
        return True

    # -- the shadow side (background thread) -------------------------------

    def _oracle_engine(self):
        """The flat exact-scan oracle for the CURRENTLY served index,
        rebuilt when the served gallery changes — recall is always
        measured against the gallery the answers came from.  ``add()``
        grows the index IN PLACE (same object, new rows), so the
        staleness token is (identity, size, created): ``add()`` bumps
        both size and the ``created`` freshness stamp, forcing the
        rebuild.  The oracle lives on the served index's device and is
        never warmed: it is not part of the serving tier."""
        from npairloss_tpu_torch.serve.engine import EngineConfig, QueryEngine
        from npairloss_tpu_torch.serve.index import GalleryIndex

        index = self.index_fn()
        token = (index.size, index.created)
        if self._oracle is not None and self._oracle[0] is index \
                and self._oracle[1] == token:
            return self._oracle[2]
        t0 = time.perf_counter()
        kmax = min(max(self.cfg.ks), index.size)
        flat = GalleryIndex.build(
            index.host_emb, index.host_labels, ids=index.ids,
            normalize=False, device=index.device)
        engine = QueryEngine(
            flat,
            EngineConfig(top_k=kmax,
                         buckets=(min(self.cfg.oracle_batch, flat.size),),
                         scoring="fp32"),
        )
        self._oracle = (index, token, engine)
        self.oracle_builds += 1
        self.oracle_build_s = time.perf_counter() - t0
        log.info("shadow oracle rebuilt for index of %d rows in %.3f s",
                 flat.size, self.oracle_build_s)
        return engine

    def _score_batch(self, batch: List[_Sample]) -> None:
        engine = self._oracle_engine()
        out = engine.query(np.stack([s.embedding for s in batch]))
        now = time.time()
        for j, s in enumerate(batch):
            exact_rows = out["rows"][j]
            exact_best = float(out["scores"][j, 0])
            rec = {
                f"recall_at_{k}": recall_against(s.served_rows,
                                                 exact_rows, k)
                for k in self.cfg.ks
                if k <= len(s.served_rows) and k <= len(exact_rows)
            }
            # The exact top-1 can only trail a served score through
            # scoring-dtype noise (bf16/int8 overestimates); clamp so
            # the gap reads "similarity left on the table", never < 0.
            rec["gap"] = max(exact_best - s.served_best, 0.0)
            self._acc.append(rec)
            with self._lock:
                self.sampled_total += 1
                self.last_sample_wall_time = now
        while len(self._acc) >= self.cfg.window:
            window, self._acc = (self._acc[:self.cfg.window],
                                 self._acc[self.cfg.window:])
            self._emit_window(window, now)

    def _emit_window(self, window: List[Dict[str, float]],
                     now: float) -> None:
        n = len(window)
        gaps = [w["gap"] for w in window]
        row: Dict[str, Any] = {}
        for k in self.cfg.ks:
            vals = [w[f"recall_at_{k}"] for w in window
                    if f"recall_at_{k}" in w]
            if vals:
                row[f"recall_at_{k}"] = round(sum(vals) / len(vals), 4)
        row["shadow_score_gap"] = round(sum(gaps) / n, 6)
        row["shadow_score_gap_max"] = round(max(gaps), 6)
        row["shadow_samples"] = n
        with self._lock:
            total = self.sampled_total
            dropped = self.dropped
            self.windows += 1
            self._last_window = dict(row)
        if dropped:
            # The spans_dropped contract: present only when > 0, so
            # drop-free streams stay byte-identical.
            row["shadow_dropped"] = dropped
        if self.telemetry is not None and self.telemetry.metrics_enabled:
            try:
                # THE emission: one serve row in the run's metrics
                # stream — a live observatory's RegistrySink turns
                # recall_at_10 into the serve_recall_at_10 gauge, and
                # the row replays through `watch`.
                self.telemetry.log("serve", total, row)
            except Exception as e:  # noqa: BLE001 — observing must not kill serving
                log.error("shadow window emission failed: %s", e)
        if self.registry is not None and self.telemetry is None:
            # Registry-only mode (no telemetry stream to ride): set the
            # gauges directly, the freshness-probe pattern.
            for key, v in row.items():
                if isinstance(v, (int, float)):
                    self.registry.set(f"serve_{key}", float(v), now)
        self._emit({
            "schema": QUALITY_SCHEMA,
            "kind": "window",
            "wall_time": now,
            "samples": n,
            "sampled_total": total,
            **{k: v for k, v in row.items()
               if k.startswith("recall_at_")},
            "score_gap_mean": row["shadow_score_gap"],
            "score_gap_max": row["shadow_score_gap_max"],
        })

    def _loop(self) -> None:
        batch: List[_Sample] = []
        while True:
            try:
                item = self._q.get(timeout=0.05)
                batch.append(item)
            except queue.Empty:
                item = None
            if self._stop.is_set() and item is None and self._q.empty():
                break
            full = len(batch) >= self.cfg.oracle_batch
            drained = item is None and batch
            if full or drained:
                try:
                    self._score_batch(batch)
                except Exception as e:  # noqa: BLE001 — shadow must not die silently
                    log.error("shadow scoring failed (%d sample(s) "
                              "lost): %s", len(batch), e)
                    with self._lock:
                        self.dropped += len(batch)
                batch = []
        if batch:
            try:
                self._score_batch(batch)
            except Exception as e:  # noqa: BLE001
                log.error("shadow drain scoring failed: %s", e)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ShadowScorer":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="shadow-scorer", daemon=True)
            self._thread.start()
        return self

    def close(self, timeout: float = 30.0) -> None:
        """Drain the queue (every accepted sample is scored), flush a
        final partial window, append the summary record, close the
        log."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
        if self._acc:
            self._emit_window(self._acc, time.time())
            self._acc = []
        with self._lock:
            summary = {
                "schema": QUALITY_SCHEMA,
                "kind": "summary",
                "wall_time": time.time(),
                "sampled_total": self.sampled_total,
                "windows": self.windows,
                "dropped": self.dropped,
                "offered_total": self.offered_total,
                **({"last_offer_wall_time": self.last_offer_wall_time}
                   if self.last_offer_wall_time is not None else {}),
                **({"last_sample_wall_time": self.last_sample_wall_time}
                   if self.last_sample_wall_time is not None else {}),
            }
        self._emit(summary)
        if self._f is not None and not self._f.closed:
            self._f.close()

    def _emit(self, rec: Dict[str, Any]) -> None:
        if self._f is None:
            # In-memory mode only (tests, no out_path): with a log on
            # disk the stream lives there — an unbounded in-process
            # copy would be a slow leak on a multi-day serve.
            self.history.append(rec)
        elif not self._f.closed:
            self._f.write(json.dumps(rec) + "\n")

    # -- reads -------------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """The /healthz + drain-summary ``quality`` block: what the
        shadow estimate currently says.  ``last`` absent until the
        first window lands; ``baseline`` only when the served commit
        carried its parity birth certificate."""
        with self._lock:
            out: Dict[str, Any] = {
                "shadow_rate": self.cfg.rate,
                "sampled": self.sampled_total,
                "windows": self.windows,
                "dropped": self.dropped,
            }
            if self._last_window:
                out["last"] = dict(self._last_window)
        if self.baseline:
            out["baseline"] = self.baseline
        return out
