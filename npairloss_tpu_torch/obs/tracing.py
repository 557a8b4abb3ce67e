"""Host-side span tracing — Chrome-trace-event JSON, viewable in Perfetto;
port of ``npairloss_tpu/obs/tracing.py`` (a copy).

``torch.profiler`` traces the card; this traces the HOST timeline: where
the wall clock goes between dispatches (data loading, eval, snapshot
writes, the warm-up and capture of a new step key).

``SpanTracer`` records hierarchical host spans as Chrome trace events
("X" complete events keyed by pid/tid; nesting is derived from
timestamp containment, the Chrome/Perfetto convention), plus "i"
instant events for point-in-time markers.  ``write()`` emits the
``{"traceEvents": [...]}`` JSON Perfetto accepts.

Stdlib only.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional


class SpanTracer:
    """Collects host spans; thread-safe; bounded by ``max_events``.

    Timestamps are microseconds since the tracer's creation (Chrome
    trace ``ts`` is relative anyway); absolute wall time at creation is
    stamped in the trace metadata so events can be correlated with
    metric records' ``wall_time``.
    """

    def __init__(self, max_events: int = 200_000):
        self._t0 = time.perf_counter()
        self.wall_time_origin = time.time()
        self._events: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._max_events = max_events
        self._dropped = 0
        self._pid = os.getpid()
        # Fleet identity (obs.fleet.stamp): stamped into the trace
        # metadata so every span in a per-rank trace file is
        # attributable to its rank; None = no fleet block in the
        # output (byte-identical to the pre-fleet trace).
        self.stamp: Optional[Dict[str, Any]] = None

    @property
    def dropped(self) -> int:
        """Events the ``max_events`` cap has eaten so far — consumers
        (solver window rows, serve window rows, the fleet aggregator)
        surface this instead of silently averaging a truncated
        stream."""
        with self._lock:
            return self._dropped

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def now_us(self) -> float:
        """Current tracer-relative timestamp — a cursor consumers can
        compare span timestamps against (e.g. the ``prof`` CLI keeps
        only the spans of its measured loop)."""
        return self._now_us()

    def _append(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._events) >= self._max_events:
                # No silent caps: the drop count is published in the
                # trace metadata (and a truncated trace stays valid).
                self._dropped += 1
                return
            self._events.append(ev)

    @contextlib.contextmanager
    def span(self, name: str, **args: Any) -> Iterator[None]:
        """``with tracer.span("data/next_batch"): ...`` — one complete
        ("X") event covering the block.  Nest freely; Perfetto stacks
        spans on the same thread by timestamp containment."""
        t0 = self._now_us()
        try:
            yield
        finally:
            t1 = self._now_us()
            ev: Dict[str, Any] = {
                "name": name,
                "ph": "X",
                "ts": t0,
                "dur": max(t1 - t0, 0.0),
                "pid": self._pid,
                "tid": threading.get_ident() & 0xFFFFFFFF,
            }
            if args:
                ev["args"] = args
            self._append(ev)

    def instant(self, name: str, **args: Any) -> None:
        """Point-in-time marker ("i" event) — e.g. "recompile"."""
        ev: Dict[str, Any] = {
            "name": name,
            "ph": "i",
            "s": "t",  # thread-scoped instant
            "ts": self._now_us(),
            "pid": self._pid,
            "tid": threading.get_ident() & 0xFFFFFFFF,
        }
        if args:
            ev["args"] = args
        self._append(ev)

    @property
    def num_events(self) -> int:
        with self._lock:
            return len(self._events)

    def to_chrome_trace(self) -> Dict[str, Any]:
        """The Chrome trace-event JSON object (Perfetto's legacy-JSON
        loader accepts exactly this shape)."""
        with self._lock:
            events = list(self._events)
            dropped = self._dropped
        meta: Dict[str, Any] = {
            "wall_time_origin": self.wall_time_origin,
        }
        if dropped:
            meta["dropped_events"] = dropped
        if self.stamp:
            # Rank identity for every span in this stream: the trace
            # file is per-rank under the fleet path scheme, so a
            # file-level stamp makes each event unambiguous without
            # paying ~30 bytes of args on all 200k of them.
            meta["fleet"] = dict(self.stamp)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": meta,
        }

    def write(self, path: str) -> str:
        """Serialize to ``path`` (atomic: tmp + rename); returns path."""
        path = os.path.abspath(path)
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        os.replace(tmp, path)
        return path


def validate_chrome_trace(obj: Any) -> Optional[str]:
    """Schema check for the trace JSON this module writes — returns an
    error string or None.  The contract Perfetto's JSON importer needs:
    a ``traceEvents`` list whose entries carry ``name``/``ph``/``ts``
    (+ ``dur`` for "X" events), with numeric timestamps."""
    if not isinstance(obj, dict):
        return "trace must be a JSON object"
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        return "missing traceEvents list"
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            return f"event {i} is not an object"
        for key in ("name", "ph", "ts"):
            if key not in ev:
                return f"event {i} missing {key!r}"
        if not isinstance(ev["ts"], (int, float)):
            return f"event {i} ts is not numeric"
        if ev["ph"] == "X" and not isinstance(ev.get("dur"), (int, float)):
            return f"event {i} is 'X' but has no numeric dur"
    return None
