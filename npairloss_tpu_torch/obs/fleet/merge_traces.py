"""Merge per-rank Chrome traces into one fleet timeline.  Port of
``npairloss_tpu/obs/fleet/merge_traces.py`` (a copy).

Each rank's ``trace.r<k>.json`` is a self-consistent host timeline with
timestamps relative to ITS tracer's creation.  This module folds them
into ONE Perfetto-loadable file:

  * every rank becomes its own numbered process lane (``pid = rank``,
    with ``process_name``/``process_sort_index`` metadata events);
  * timestamps are re-based onto a common origin using the
    **clock-offset estimate** from each trace's absolute
    ``wall_time_origin`` (falling back to the rank manifest's
    ``created`` stamp): ``offset_k = origin_k - min(origins)``.  On one
    host this is exact (one clock); across hosts it is as good as the
    hosts' wall-clock sync — the offsets are recorded in the merged
    trace's metadata.

Torn/unreadable per-rank traces are skipped with a note, and malformed
events are dropped, never fatal.  Stdlib only.

:func:`merge_timeline` widens the merge to the whole system: trainer
rank lanes, the serve tier's host spans (one lane per thread inside it:
each replica's dispatcher, the request threads), and — read when
present, noted when absent — the query-trace exemplars, alert and
remediation logs and a gameday chaos schedule, sources the port does
not produce yet.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

from npairloss_tpu_torch.obs.fleet.stamp import (
    discover_ranks,
    load_json as _load_json,
    rank_manifest_name,
    rank_trace_name,
)

MERGED_TRACE_FILENAME = "fleet_trace.json"


def collect_rank_traces(
    run_dir: str,
) -> Tuple[Dict[int, Dict[str, Any]], Dict[int, Optional[float]], List[str]]:
    """(traces by rank, wall-time origin by rank, notes).  The origin
    prefers the trace's own ``wall_time_origin`` (stamped at tracer
    creation) and falls back to the rank manifest's ``created``."""
    run_dir = os.path.abspath(run_dir)
    traces: Dict[int, Dict[str, Any]] = {}
    origins: Dict[int, Optional[float]] = {}
    notes: List[str] = []
    ranks = discover_ranks(run_dir)
    layouts = (
        [(r, rank_trace_name(r), rank_manifest_name(r)) for r in ranks]
        if ranks else [(0, "trace.json", "manifest.json")]
    )
    for rank, trace_name, manifest_name in layouts:
        path = os.path.join(run_dir, trace_name)
        trace = _load_json(path)
        if trace is None or not isinstance(trace.get("traceEvents"), list):
            if os.path.exists(path):
                notes.append(f"rank {rank}: unreadable trace {trace_name}")
            else:
                notes.append(f"rank {rank}: no trace file")
            continue
        traces[rank] = trace
        origin = (trace.get("otherData", {}) or {}).get("wall_time_origin")
        if not isinstance(origin, (int, float)):
            man = _load_json(os.path.join(run_dir, manifest_name)) or {}
            origin = man.get("created")
            if isinstance(origin, (int, float)):
                notes.append(
                    f"rank {rank}: clock offset estimated from manifest "
                    "created time (trace carried no wall_time_origin)")
            else:
                origin = None
                notes.append(
                    f"rank {rank}: no clock reference — events kept on "
                    "the rank's own relative timeline")
        origins[rank] = origin
    return traces, origins, notes


def merge_chrome_traces(
    traces: Dict[int, Dict[str, Any]],
    origins: Optional[Dict[int, Optional[float]]] = None,
    notes: Optional[List[str]] = None,
) -> Dict[str, Any]:
    """Per-rank trace objects -> one merged Chrome-trace object with
    rank-numbered process lanes and clock-offset-aligned timestamps."""
    origins = origins or {}
    known = [o for o in origins.values() if isinstance(o, (int, float))]
    base = min(known) if known else None
    events: List[Dict[str, Any]] = []
    offsets_us: Dict[str, float] = {}
    dropped: Dict[str, int] = {}
    for rank in sorted(traces):
        trace = traces[rank]
        origin = origins.get(rank)
        offset_us = ((origin - base) * 1e6
                     if base is not None
                     and isinstance(origin, (int, float)) else 0.0)
        offsets_us[str(rank)] = round(offset_us, 1)
        # Perfetto lane naming: ts=0 keeps the metadata events valid
        # under validate_chrome_trace (which requires numeric ts).
        events.append({"name": "process_name", "ph": "M", "ts": 0,
                       "pid": rank, "tid": 0,
                       "args": {"name": f"rank {rank}"}})
        events.append({"name": "process_sort_index", "ph": "M", "ts": 0,
                       "pid": rank, "tid": 0,
                       "args": {"sort_index": rank}})
        meta = trace.get("otherData", {}) or {}
        if meta.get("dropped_events"):
            dropped[str(rank)] = int(meta["dropped_events"])
        for ev in trace.get("traceEvents", []):
            # Malformed events (no name/ph, non-numeric ts, an "X"
            # without a numeric dur) are dropped here, per the
            # never-fatal contract: one rank's damaged trace must not
            # invalidate the merged timeline of the whole fleet.
            if not isinstance(ev, dict) \
                    or not isinstance(ev.get("ts"), (int, float)) \
                    or "name" not in ev or "ph" not in ev:
                continue
            if ev["ph"] == "X" and not isinstance(
                    ev.get("dur"), (int, float)):
                continue
            out = dict(ev)
            out["ts"] = ev["ts"] + offset_us
            out["pid"] = rank
            events.append(out)
    merged_meta: Dict[str, Any] = {
        "merged_ranks": sorted(traces),
        "clock_offsets_us": offsets_us,
        "clock_note": (
            "offsets estimated from per-rank wall-clock origins; exact "
            "on one host, host-clock-sync-accurate across hosts"),
    }
    if base is not None:
        merged_meta["wall_time_origin"] = base
    if dropped:
        merged_meta["dropped_events_by_rank"] = dropped
    if notes:
        merged_meta["notes"] = list(notes)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": merged_meta,
    }


def merge_run_traces(
    run_dir: str, out_path: Optional[str] = None
) -> Tuple[Optional[str], Dict[str, Any]]:
    """Merge every per-rank trace under ``run_dir`` and write the
    result (atomic tmp+rename); returns ``(path, merged_trace)`` —
    path None when no rank left a readable trace."""
    traces, origins, notes = collect_rank_traces(run_dir)
    merged = merge_chrome_traces(traces, origins, notes)
    if not traces:
        return None, merged
    if out_path is None:
        out_path = os.path.join(os.path.abspath(run_dir),
                                MERGED_TRACE_FILENAME)
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(merged, f)
    os.replace(tmp, out_path)
    return out_path, merged


# -- the composed-system timeline --------------------------------------------

TIMELINE_FILENAME = "timeline.json"

# Lane (pid) allocation for the non-trainer sources.  Trainer ranks
# keep pid = rank (0..G-1, matching fleet_trace.json); everything else
# sits far above any plausible rank count so the groups never collide.
SERVE_HOST_PID = 900
QTRACE_PID_BASE = 1000
SERVE_EVENTS_PID = 1998
OPS_PID = 1999


def _read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Records from a JSONL file; torn lines skipped (never fatal)."""
    out: List[Dict[str, Any]] = []
    try:
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict):
                    out.append(rec)
    except OSError:
        pass
    return out


def _lane_meta(events: List[Dict[str, Any]], pid: int, name: str,
               sort_index: int) -> None:
    events.append({"name": "process_name", "ph": "M", "ts": 0,
                   "pid": pid, "tid": 0, "args": {"name": name}})
    events.append({"name": "process_sort_index", "ph": "M", "ts": 0,
                   "pid": pid, "tid": 0,
                   "args": {"sort_index": sort_index}})


def _first_existing(run_dir: str, names: Tuple[str, ...]
                    ) -> Optional[str]:
    for name in names:
        path = os.path.join(run_dir, name)
        if os.path.exists(path):
            return path
    return None


def merge_timeline(
    run_dir: str, out_path: Optional[str] = None
) -> Tuple[Optional[str], Dict[str, Any]]:
    """Merge every timeline source under ``run_dir`` into one
    Perfetto-loadable ``timeline.json``.

    Sources (each optional, searched in the gameday layout's subdirs
    too): trainer rank traces (``trace.r<k>.json`` in ``run_dir`` or
    ``train_tel/``), the serve host trace (``serve_tel/trace.json``),
    the qtrace exemplar artifact (``qtrace.json`` in ``run_dir`` or
    ``serve_tel/``), alert + remediation logs (``alerts.jsonl`` /
    ``remediation.jsonl`` anywhere in those dirs), and the gameday
    report's chaos schedule (``gameday.json``).  Alignment uses each
    source's absolute wall clock (trace ``wall_time_origin``, alert /
    remediation ``ts``); gameday chaos offsets are anchored at the
    merged base origin — a run-start estimate, noted in the metadata.
    Returns ``(path, merged)``; path is None when NO source produced
    events (nothing worth writing)."""
    run_dir = os.path.abspath(run_dir)
    serve_tel = os.path.join(run_dir, "serve_tel")
    train_tel = os.path.join(run_dir, "train_tel")
    notes: List[str] = []
    events: List[Dict[str, Any]] = []

    # Trainer rank lanes: first layout that yields traces wins (a rank
    # set split across both dirs would double-allocate pids).
    traces: Dict[int, Dict[str, Any]] = {}
    origins: Dict[int, Optional[float]] = {}
    for cand in (run_dir, train_tel):
        if not os.path.isdir(cand):
            continue
        traces, origins, rank_notes = collect_rank_traces(cand)
        if traces:
            notes.extend(rank_notes)
            break

    # Serve host trace (span stream from the serving process).
    serve_origin: Optional[float] = None
    path = os.path.join(serve_tel, "trace.json")
    serve_trace = _load_json(path) if os.path.exists(path) else None
    if serve_trace is not None:
        if not isinstance(serve_trace.get("traceEvents"), list):
            notes.append("serve host trace unreadable")
            serve_trace = None
        else:
            origin = (serve_trace.get("otherData", {}) or {}).get(
                "wall_time_origin")
            serve_origin = (origin
                            if isinstance(origin, (int, float))
                            else None)

    # Qtrace exemplar artifact.
    qtrace_path = _first_existing(
        run_dir, ("qtrace.json", os.path.join("serve_tel",
                                              "qtrace.json")))
    qtrace = _load_json(qtrace_path) if qtrace_path else None
    qtrace_origin: Optional[float] = None
    if qtrace is not None:
        origin = qtrace.get("wall_time_origin")
        if isinstance(origin, (int, float)) and \
                isinstance(qtrace.get("exemplars"), list):
            qtrace_origin = float(origin)
        else:
            notes.append("qtrace artifact unreadable — exemplar lanes "
                         "skipped")
            qtrace = None

    # Operational instants: alert + remediation logs, wall-clock ``ts``.
    alert_recs: List[Dict[str, Any]] = []
    rem_recs: List[Dict[str, Any]] = []
    for cand in (run_dir, serve_tel, train_tel):
        if not os.path.isdir(cand):
            continue
        alert_recs.extend(_read_jsonl(os.path.join(cand,
                                                   "alerts.jsonl")))
        rem_recs.extend(_read_jsonl(os.path.join(cand,
                                                 "remediation.jsonl")))
    op_times = [float(r["ts"]) for r in alert_recs + rem_recs
                if isinstance(r.get("ts"), (int, float))]

    # One common origin: the earliest absolute wall clock any source
    # carries (exact on one host — the fleet-merge contract).
    known = [o for o in origins.values()
             if isinstance(o, (int, float))]
    if serve_origin is not None:
        known.append(serve_origin)
    if qtrace_origin is not None:
        known.append(qtrace_origin)
    known.extend(op_times)
    base = min(known) if known else None

    def _us(wall: float) -> float:
        return (wall - base) * 1e6 if base is not None else 0.0

    # Trainer lanes re-use the fleet merge (pid = rank), re-based onto
    # the composed-system origin via each rank's own offset.
    if traces:
        fleet = merge_chrome_traces(traces, origins)
        fleet_origin = fleet["otherData"].get("wall_time_origin")
        shift = (_us(fleet_origin)
                 if isinstance(fleet_origin, (int, float)) else 0.0)
        for ev in fleet["traceEvents"]:
            if ev.get("ph") != "M":
                ev = dict(ev)
                ev["ts"] = ev["ts"] + shift
            events.append(ev)

    if serve_trace is not None:
        _lane_meta(events, SERVE_HOST_PID, "serve host", SERVE_HOST_PID)
        shift = _us(serve_origin) if serve_origin is not None else 0.0
        if serve_origin is None:
            notes.append("serve host trace has no wall_time_origin — "
                         "kept on its own relative timeline")
        for ev in serve_trace["traceEvents"]:
            if not isinstance(ev, dict) \
                    or not isinstance(ev.get("ts"), (int, float)):
                continue
            out = dict(ev)
            out["ts"] = ev["ts"] + shift
            out["pid"] = SERVE_HOST_PID
            events.append(out)

    # Per-replica exemplar lanes: one pid per replica, one tid (row)
    # per exemplar, so each worst-query span tree reads as its own
    # nested track next to the host spans.
    if qtrace is not None:
        shift = _us(qtrace_origin)
        replicas = sorted({str(ex.get("replica") or "?")
                           for ex in qtrace["exemplars"]})
        rep_pid = {rep: QTRACE_PID_BASE + i
                   for i, rep in enumerate(replicas)}
        for rep in replicas:
            _lane_meta(events, rep_pid[rep],
                       f"serve queries {rep}", rep_pid[rep])
        for i, ex in enumerate(qtrace["exemplars"]):
            if not isinstance(ex.get("events"), list):
                continue
            pid = rep_pid[str(ex.get("replica") or "?")]
            events.append({
                "name": "thread_name", "ph": "M", "ts": 0,
                "pid": pid, "tid": i,
                "args": {"name": f"{ex.get('trace_id', f'ex{i}')} "
                                 f"({ex.get('reason', '?')})"}})
            for ev in ex["events"]:
                if not isinstance(ev, dict) \
                        or not isinstance(ev.get("ts"), (int, float)):
                    continue
                out = dict(ev)
                out["ts"] = ev["ts"] + shift
                out["pid"] = pid
                out["tid"] = i
                events.append(out)
        markers = qtrace.get("markers")
        if isinstance(markers, list) and markers:
            _lane_meta(events, SERVE_EVENTS_PID, "serve events",
                       SERVE_EVENTS_PID)
            for ev in markers:
                if not isinstance(ev, dict) \
                        or not isinstance(ev.get("ts"), (int, float)):
                    continue
                out = dict(ev)
                out["ts"] = ev["ts"] + shift
                out["pid"] = SERVE_EVENTS_PID
                out["tid"] = 0
                events.append(out)

    if op_times:
        _lane_meta(events, OPS_PID, "alerts & remediation", OPS_PID)
        for rec in alert_recs:
            if not isinstance(rec.get("ts"), (int, float)):
                continue
            events.append({
                "name": f"alert:{rec.get('slo', '?')} "
                        f"{rec.get('state', '?')}",
                "ph": "i", "s": "t", "ts": _us(float(rec["ts"])),
                "pid": OPS_PID, "tid": 0,
                "args": {key: rec.get(key) for key in
                         ("slo", "state", "severity", "alert_id")},
            })
        for rec in rem_recs:
            if not isinstance(rec.get("ts"), (int, float)):
                continue
            events.append({
                "name": f"remediation:{rec.get('policy', '?')} "
                        f"{rec.get('state', '?')}",
                "ph": "i", "s": "t", "ts": _us(float(rec["ts"])),
                "pid": OPS_PID, "tid": 1,
                "args": {key: rec.get(key) for key in
                         ("policy", "action", "state", "attempt")},
            })

    # Gameday chaos schedule: at_s offsets anchored at the merged base
    # (the run-start estimate — documented, not asserted).
    gameday = _load_json(os.path.join(run_dir, "gameday.json"))
    if isinstance(gameday, dict) and \
            isinstance(gameday.get("faults"), list):
        if not op_times:
            _lane_meta(events, OPS_PID, "alerts & remediation",
                       OPS_PID)
        notes.append("chaos instants anchored at the merged base "
                     "origin (run-start estimate)")
        for fault in gameday["faults"]:
            if not isinstance(fault, dict) \
                    or not isinstance(fault.get("at_s"),
                                      (int, float)):
                continue
            events.append({
                "name": f"chaos:{fault.get('name', '?')}",
                "ph": "i", "s": "t",
                "ts": float(fault["at_s"]) * 1e6,
                "pid": OPS_PID, "tid": 2,
                "args": {key: fault.get(key) for key in
                         ("name", "target", "kind", "at_s")},
            })

    merged: Dict[str, Any] = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "timeline": True,
            "sources": {
                "trainer_ranks": sorted(traces),
                "serve_host": serve_trace is not None,
                "qtrace": qtrace is not None,
                "alerts": len(alert_recs),
                "remediation": len(rem_recs),
                "gameday": isinstance(gameday, dict),
            },
            **({"wall_time_origin": base} if base is not None else {}),
            **({"notes": notes} if notes else {}),
        },
    }
    if not any(ev.get("ph") != "M" for ev in events):
        return None, merged
    if out_path is None:
        out_path = os.path.join(run_dir, TIMELINE_FILENAME)
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(merged, f)
    os.replace(tmp, out_path)
    return out_path, merged
