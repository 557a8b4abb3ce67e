"""QueryTracer — per-query, per-stage tail-latency attribution.  Port of
``npairloss_tpu/obs/qtrace/core.py`` (stdlib only, as there).

One trace id is assigned per query at INGESTION (the stdin JSONL loop
and the HTTP front end alike) and rides the record through admission,
the replica router, the micro-batcher, and the engine; each pipeline
stage records a span (``admit_wait``, ``queue_wait``,
``batch_assemble``, ``dispatch``, ``score``, ``topk_merge``) in the
``SpanTracer`` event shape, so exemplar trees drop straight into
Perfetto next to the host spans and fleet lanes (``timeline``).

Two consumers sit on top of the raw spans:

* **always-on aggregation** — every answered query lands its stage
  durations in a rolling ring (and, when a live registry is attached,
  in per-stage ``qtrace_<stage>_ms`` histograms on ``/metrics``); the
  ring yields the p99 budget decomposition (which stage dominates the
  worst-window queries) for ``/healthz``, window rows, and the drain
  summary;
* **exemplar sampling** — the FULL span tree is retained only for
  SLO-violating queries and the slowest tail (rolling
  ``tail_quantile``), in a bounded store that evicts the fastest
  exemplar first — never a per-query flight recorder at full qps.

The drain writes the ``npairloss-qtrace-v1`` artifact; its contract
lives in :mod:`npairloss_tpu_torch.obs.qtrace.report`.  ``serve``
also checkpoints it every 2 s while it runs; :meth:`QueryTracer.write`
takes a lock, so a checkpoint and the drain's write never race on the
temporary file.

Population contract (shared with the server's latency rings): only
ANSWERED queries aggregate — rejected, shed, and errored queries are
counted (``totals.dropped`` / ``totals.errors``) but contribute to
neither the budget decomposition nor the exemplar ring, exactly as they
contribute to neither of the server's p99 populations.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from npairloss_tpu_torch.obs.qtrace.report import (
    MARKER_NAMES,
    PROBE_FUSED_SPAN,
    QTRACE_SCHEMA,
    ROOT_SPAN,
    STAGES,
)

_MAX_MARKERS = 4096


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile of an ascending list (the convention of
    ``obs/perf/decompose.py``)."""
    if not sorted_vals:
        return 0.0
    idx = min(int(round(q / 100.0 * (len(sorted_vals) - 1))),
              len(sorted_vals) - 1)
    return sorted_vals[idx]


@dataclasses.dataclass(frozen=True)
class QTraceConfig:
    """``exemplars``: bound on retained span trees (fastest evicted
    first); ``slo_ms``: retain any query slower than this (<=0 disables
    the SLO rule); ``window``: rolling aggregation ring length — the
    budget decomposition's population; ``tail_quantile``: retain
    queries at or above this rolling percentile (the slowest-tail
    rule); ``ring_tolerance``: slack the artifact grants consumers
    cross-checking its p99 against the worst exemplar."""

    exemplars: int = 64
    slo_ms: float = 250.0
    window: int = 1024
    tail_quantile: float = 99.9
    ring_tolerance: float = 0.25

    def __post_init__(self):
        if self.exemplars < 1:
            raise ValueError(
                f"exemplars must be >= 1, got {self.exemplars}")
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        if not (0.0 < self.tail_quantile <= 100.0):
            raise ValueError(
                f"tail_quantile must be in (0, 100], got "
                f"{self.tail_quantile}")
        if self.ring_tolerance < 0:
            raise ValueError("ring_tolerance must be >= 0")


class QueryTrace:
    """One query's trace context — created at ingestion, carried with
    the record across the admission/batcher/replica threads.  Each
    field is written by exactly one stage and the handoffs happen
    through the admission queue and the result future, so no lock is
    needed on the context itself."""

    __slots__ = ("trace_id", "qid", "wall_time", "t_ingest",
                 "t_admitted", "t_picked", "t_dispatch", "stage_us",
                 "events", "replica", "probe", "tenant", "done")

    def __init__(self, trace_id: str, qid: Any, wall_time: float,
                 t_ingest: float):
        self.trace_id = trace_id
        self.qid = qid
        self.wall_time = wall_time
        self.t_ingest = t_ingest
        self.t_admitted = t_ingest
        self.t_picked = t_ingest
        self.t_dispatch = t_ingest
        self.stage_us: Dict[str, float] = {}
        self.events: List[Dict[str, Any]] = []
        self.replica: Optional[str] = None
        self.probe = False
        # Multi-tenant serving stamps the owning tenant id at ingestion;
        # it rides into the root span's args so an exemplar tree is
        # attributable to the tenant whose traffic produced it.
        self.tenant: Optional[str] = None
        self.done = False


class QueryTracer:
    """Assigns trace ids, records stage spans, aggregates, samples.

    ``clock``/``wall`` are injectable for deterministic tests (seeded
    monotonic time); defaults are the real clocks.  All shared state is
    mutated under ``_lock`` — per-stage record calls arrive from the
    front-end, batcher, and replica dispatcher threads concurrently.
    """

    def __init__(self, cfg: QTraceConfig = QTraceConfig(),
                 registry=None, out_path: Optional[str] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 wall: Callable[[], float] = time.time):
        self.cfg = cfg
        self.registry = registry
        self.out_path = out_path
        self._clock = clock
        self._wall = wall
        self._t0 = clock()
        self.wall_time_origin = wall()
        self._pid = os.getpid()
        self._lock = threading.Lock()
        self._seq = 0            # guarded-by: _lock
        self._queries = 0        # guarded-by: _lock
        self._errors = 0         # guarded-by: _lock
        self._dropped = 0        # guarded-by: _lock
        self._violations = 0     # guarded-by: _lock
        self._evicted = 0        # guarded-by: _lock
        self._reroutes = 0       # guarded-by: _lock
        self._flips = 0          # guarded-by: _lock
        # (total_ms, stage_ms) per answered query, newest last — the
        # budget decomposition's rolling population.
        self._recent: Deque[Tuple[float, Dict[str, float]]] = \
            collections.deque(maxlen=cfg.window)  # guarded-by: _lock
        # Same tuples, cleared on every window_row() read — mirrors the
        # server's per-window latency population.
        self._window_acc: List[Tuple[float, Dict[str, float]]] = \
            []                   # guarded-by: _lock
        self._exemplars: List[Dict[str, Any]] = []  # guarded-by: _lock
        self._markers: List[Dict[str, Any]] = []    # guarded-by: _lock
        # One writer at a time on the artifact's temporary file (the
        # periodic checkpoint and the drain's final write).
        self._write_lock = threading.Lock()

    # -- clock -------------------------------------------------------------

    def _now_us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    def _tid(self) -> int:
        return threading.get_ident() & 0xFFFFFFFF

    def _span_event(self, qt: QueryTrace, name: str, t0_us: float,
                    t1_us: float, **args) -> None:
        qt.events.append({
            "name": name,
            "ph": "X",
            "ts": t0_us,
            "dur": max(t1_us - t0_us, 0.0),
            "pid": self._pid,
            "tid": self._tid(),
            "args": {"trace_id": qt.trace_id, **args},
        })

    # -- per-stage recording ----------------------------------------------

    def begin(self, qid: Any) -> QueryTrace:
        """Assign a trace id at ingestion and start the clock."""
        with self._lock:
            self._seq += 1
            seq = self._seq
        return QueryTrace(f"q-{seq:08d}", qid, self._wall(),
                          self._now_us())

    def admitted(self, qt: QueryTrace, probe: bool = False) -> None:
        """The admission gate let the query through; ``admit_wait`` is
        the shed-check plus router time up to the replica queue."""
        now = self._now_us()
        qt.probe = qt.probe or probe
        qt.t_admitted = now
        self._span_event(qt, f"qtrace/{STAGES[0]}", qt.t_ingest, now)

    def picked(self, qt: QueryTrace) -> None:
        """The replica's dispatcher pulled the query off its admission
        queue; ``queue_wait`` ends here."""
        now = self._now_us()
        qt.t_picked = now
        self._span_event(qt, f"qtrace/{STAGES[1]}", qt.t_admitted, now)

    def dispatch_begin(self, qts: List[QueryTrace],
                       replica: Optional[str] = None) -> None:
        """The coalesced batch entered the dispatch path;
        ``batch_assemble`` is the co-rider wait since pick."""
        now = self._now_us()
        for qt in qts:
            qt.replica = replica
            qt.t_dispatch = now
            self._span_event(qt, f"qtrace/{STAGES[2]}", qt.t_picked,
                             now, **({"replica": replica} if replica
                                     else {}))

    def dispatch_end(self, qts: List[QueryTrace], score_us: float = 0.0,
                     merge_us: float = 0.0,
                     fused: bool = False) -> None:
        """The batch's answers exist.  ``score``/``topk_merge`` spans
        are placed back-to-back at the tail of the dispatch span from
        the engine's measured durations; ``dispatch`` keeps the
        remainder (parse, encode, failpoint stalls) as self time.

        ``fused`` marks a dispatch through the fused IVF probe (the CUDA
        kernel): the score/merge clocks then came out of ONE kernel, so a
        wrapping ``probe_fused`` span is emitted around them — the stage
        VOCABULARY (and every per-query ``stage_us`` row) is unchanged,
        so ``npairloss-qtrace-v1`` artifacts stay valid either way."""
        now = self._now_us()
        score_us = max(float(score_us), 0.0)
        merge_us = max(float(merge_us), 0.0)
        for qt in qts:
            total = max(now - qt.t_dispatch, 0.0)
            inner = min(score_us + merge_us, total)
            scale = inner / (score_us + merge_us) \
                if score_us + merge_us > 0 else 0.0
            s_us, m_us = score_us * scale, merge_us * scale
            self._span_event(qt, f"qtrace/{STAGES[3]}", qt.t_dispatch,
                             now)
            if fused and s_us + m_us > 0:
                self._span_event(qt, PROBE_FUSED_SPAN,
                                 now - m_us - s_us, now)
            if s_us > 0:
                self._span_event(qt, f"qtrace/{STAGES[4]}",
                                 now - m_us - s_us, now - m_us)
            if m_us > 0:
                self._span_event(qt, f"qtrace/{STAGES[5]}", now - m_us,
                                 now)
            qt.stage_us[STAGES[3]] = total - s_us - m_us
            qt.stage_us[STAGES[4]] = s_us
            qt.stage_us[STAGES[5]] = m_us

    # -- markers -----------------------------------------------------------

    def marker(self, name: str, **args) -> None:
        """Tier-level instant (hot-swap flip, crash reroute) — lands in
        the artifact and on the merged timeline's serve lane."""
        if name not in MARKER_NAMES:
            raise ValueError(f"unknown qtrace marker {name!r}")
        ev = {
            "name": name,
            "ph": "i",
            "s": "t",
            "ts": self._now_us(),
            "pid": self._pid,
            "tid": self._tid(),
            "args": dict(args),
        }
        with self._lock:
            if name == "crash_reroute":
                self._reroutes += 1
            elif name == "hotswap_flip":
                self._flips += 1
            if len(self._markers) < _MAX_MARKERS:
                self._markers.append(ev)

    # -- completion --------------------------------------------------------

    def drop(self, qt: Optional[QueryTrace], error: bool = False) -> None:
        """A query that will never be answered (shed, rejected, or
        errored): counted, excluded from every aggregation population
        (the shared population contract above)."""
        if qt is None or qt.done:
            return
        qt.done = True
        with self._lock:
            self._queries += 1
            if error:
                self._errors += 1
            else:
                self._dropped += 1

    def finish(self, qt: Optional[QueryTrace]) -> None:
        """An answered query: close the root span, aggregate its stage
        durations, and decide exemplar retention."""
        if qt is None or qt.done:
            return
        qt.done = True
        now = self._now_us()
        # Waits derived from the stage handoff timestamps; the engine
        # stages were filled by dispatch_end (zero when the query
        # errored before dispatch).
        stage_ms = {
            STAGES[0]: max(qt.t_admitted - qt.t_ingest, 0.0) / 1e3,
            STAGES[1]: max(qt.t_picked - qt.t_admitted, 0.0) / 1e3,
            STAGES[2]: max(qt.t_dispatch - qt.t_picked, 0.0) / 1e3,
            STAGES[3]: qt.stage_us.get(STAGES[3], 0.0) / 1e3,
            STAGES[4]: qt.stage_us.get(STAGES[4], 0.0) / 1e3,
            STAGES[5]: qt.stage_us.get(STAGES[5], 0.0) / 1e3,
        }
        total_ms = max(now - qt.t_ingest, 0.0) / 1e3
        self._span_event(qt, ROOT_SPAN, qt.t_ingest, now,
                         **({"qid": qt.qid} if qt.qid is not None
                            else {}),
                         **({"probe": True} if qt.probe else {}),
                         **({"tenant": qt.tenant} if qt.tenant
                            else {}))
        if self.registry is not None:
            for stage, ms in stage_ms.items():
                self.registry.observe(f"qtrace_{stage}_ms", ms)
            self.registry.observe("qtrace_total_ms", total_ms)
        with self._lock:
            self._queries += 1
            violating = self.cfg.slo_ms > 0 and total_ms > self.cfg.slo_ms
            if violating:
                self._violations += 1
            # Tail rule against the ring BEFORE this sample joins it:
            # any new ring maximum clears the threshold, so the worst
            # query is always retained (the consistency invariant
            # qtrace_p99_consistency cross-checks).
            totals = sorted(t for t, _ in self._recent)
            tail = (not totals
                    or total_ms >= _percentile(totals,
                                               self.cfg.tail_quantile))
            self._recent.append((total_ms, stage_ms))
            self._window_acc.append((total_ms, stage_ms))
            if violating or tail:
                self._retain_locked(qt, total_ms,
                                    "slo" if violating else "tail")

    def _retain_locked(self, qt, total_ms, reason):  # holds-lock: _lock
        ex = {
            "trace_id": qt.trace_id,
            "qid": qt.qid,
            "reason": reason,
            "total_ms": total_ms,
            "wall_time": qt.wall_time,
            "replica": qt.replica,
            "events": sorted(qt.events, key=lambda e: e["ts"]),
        }
        if len(self._exemplars) >= self.cfg.exemplars:
            # Bounded store: the FASTEST exemplar goes first, so the
            # retained set stays the tail-heavy one and the worst span
            # tree is never evicted.
            fastest = min(range(len(self._exemplars)),
                          key=lambda i: self._exemplars[i]["total_ms"])
            if self._exemplars[fastest]["total_ms"] >= total_ms:
                self._evicted += 1
                return
            del self._exemplars[fastest]
            self._evicted += 1
        self._exemplars.append(ex)

    # -- aggregation views -------------------------------------------------

    def _budget_locked(self) -> Dict[str, Any]:  # holds-lock: _lock
        totals = sorted(t for t, _ in self._recent)
        stage_p99 = {}
        for stage in STAGES:
            vals = sorted(s[stage] for _, s in self._recent)
            stage_p99[stage] = round(_percentile(vals, 99.0), 3)
        worst_mean, dominant, dominant_ms = {}, "", 0.0
        if self._recent:
            k = max(1, len(self._recent) // 100)
            worst = sorted(self._recent, key=lambda r: r[0],
                           reverse=True)[:k]
            for stage in STAGES:
                worst_mean[stage] = round(
                    sum(s[stage] for _, s in worst) / len(worst), 3)
            dominant = max(STAGES, key=lambda s: worst_mean[s])
            dominant_ms = worst_mean[dominant]
        return {
            "p99_ms": round(_percentile(totals, 99.0), 3),
            "dominant": dominant,
            "dominant_ms": dominant_ms,
            "stage_p99_ms": stage_p99,
            "worst_mean_ms": worst_mean,
        }

    def budget(self) -> Dict[str, Any]:
        """Rolling p99 budget decomposition: which stage dominates the
        worst-window queries (``/healthz`` and the drain summary)."""
        with self._lock:
            return self._budget_locked()

    def window_row(self) -> Dict[str, Any]:
        """Drain the per-window accumulator into the window-row keys:
        the dominant stage among that window's worst queries."""
        with self._lock:
            acc = self._window_acc
            self._window_acc = []
        if not acc:
            return {"qtrace_dominant": "", "qtrace_dominant_ms": 0.0}
        k = max(1, len(acc) // 100)
        worst = sorted(acc, key=lambda r: r[0], reverse=True)[:k]
        means = {stage: sum(s[stage] for _, s in worst) / len(worst)
                 for stage in STAGES}
        dominant = max(STAGES, key=lambda s: means[s])
        return {"qtrace_dominant": dominant,
                "qtrace_dominant_ms": round(means[dominant], 3)}

    def summary_block(self) -> Dict[str, Any]:
        """The drain summary's ``qtrace`` block."""
        with self._lock:
            return {**self._totals_locked(),
                    "budget": self._budget_locked()}

    def _totals_locked(self) -> Dict[str, int]:  # holds-lock: _lock
        return {
            "queries": self._queries,
            "errors": self._errors,
            "dropped": self._dropped,
            "violations": self._violations,
            "exemplars": len(self._exemplars),
            "evicted": self._evicted,
            "reroutes": self._reroutes,
            "hotswap_flips": self._flips,
        }

    # -- the artifact ------------------------------------------------------

    def report(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "schema": QTRACE_SCHEMA,
                "wall_time_origin": self.wall_time_origin,
                "slo_ms": self.cfg.slo_ms,
                "ring_tolerance": self.cfg.ring_tolerance,
                "stages": list(STAGES),
                "totals": self._totals_locked(),
                "budget": self._budget_locked(),
                "markers": list(self._markers),
                "exemplars": [dict(ex) for ex in self._exemplars],
            }

    def write(self, path: Optional[str] = None) -> str:
        """Atomic write (tmp + rename), the snapshot-commit idiom."""
        path = path or self.out_path
        if not path:
            raise ValueError("QueryTracer.write needs a path")
        tmp = f"{path}.tmp-{os.getpid()}"
        with self._write_lock:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(self.report(), f, indent=1)
                f.write("\n")
            os.replace(tmp, path)
        return path
