"""Offline fleet aggregation: per-rank streams -> one straggler/skew
report.  Port of ``npairloss_tpu/obs/fleet/aggregate.py`` (a copy: the
same ``npairloss-fleet-report-v1`` schema, key for key, so the JAX
package's ``validate_fleet_report`` accepts the port's).

Reads every rank's telemetry out of one run directory (the rank-aware
path scheme of ``obs.fleet.stamp``; a plain single-process layout loads
as rank 0 of 1) and computes what no single stream can show:

  * **per-step rank skew** — the spread of dispatch-start times across
    ranks for the same step (a straggler dispatches late; in a
    collective-coupled step everyone else then waits for it), plus the
    end-time spread from the metric rows;
  * **slowest-rank identity with persistence** — the same rank arriving
    last step after step is a sick host, not noise;
  * **barrier-wait share** — per rank, the mean fraction of a step it
    spends ahead of the straggler (= waiting at the collective);
  * **dropped-span flagging** — a rank whose tracer hit its event cap
    has a PARTIAL timeline; it is flagged instead of averaged in;
  * **comms join** — when the training run left its collective pricing
    (``fleet_comms.json``, written by rank 0's Solver under fleet
    telemetry), the per-kind bytes are joined with the measured step
    cadence into effective-bandwidth rows against the link's peak
    (``obs.fleet.comms``).

Torn tail lines (a rank killed mid-write) are counted per rank, never
fatal.  :func:`validate_fleet_report` IS the contract.  Stdlib only at
import time; ``prof --fleet`` touches no device.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

from npairloss_tpu_torch.obs.fleet.stamp import (
    discover_ranks,
    load_json as _load_json,
    rank_manifest_name,
    rank_metrics_name,
    rank_trace_name,
)

FLEET_REPORT_SCHEMA = "npairloss-fleet-report-v1"

# The file the Solver leaves behind (rank 0, fleet telemetry on) with
# the counted step's collective bytes per kind + its claims.
COMMS_FILENAME = "fleet_comms.json"

# Keys every per-rank row of the report carries (pinned by tests; the
# validator enforces them).
RANK_KEYS = (
    "rank", "rows", "torn_lines", "steps", "first_step", "last_step",
    "spans_dropped", "flagged", "ms_per_step_p50", "barrier_wait_share",
)

SKEW_KEYS = (
    "steps_analyzed", "dispatch_spread_ms_p50", "dispatch_spread_ms_p99",
    "end_spread_ms_p50", "end_spread_ms_p99", "slowest",
)

_STEP_SPAN_NAMES = ("step/dispatch", "step/compile")


def read_jsonl(path: str) -> Tuple[List[Dict[str, Any]], int]:
    """(rows, torn_lines): every parseable JSON object line; lines that
    fail to parse (the torn tail of a killed writer) are counted, not
    fatal."""
    rows: List[Dict[str, Any]] = []
    torn = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except ValueError:
                torn += 1
                continue
            if isinstance(obj, dict):
                rows.append(obj)
            else:
                torn += 1
    return rows, torn


def load_rank_streams(run_dir: str) -> Dict[int, Dict[str, Any]]:
    """rank -> {"rows", "torn_lines", "trace", "manifest"} for every
    rank that left any per-rank file; a plain single-process layout
    (``metrics.jsonl``/``trace.json``/``manifest.json``) loads as rank
    0 when no rank files exist."""
    run_dir = os.path.abspath(run_dir)
    out: Dict[int, Dict[str, Any]] = {}
    ranks = discover_ranks(run_dir)
    if ranks:
        layouts = [
            (r, rank_metrics_name(r), rank_trace_name(r),
             rank_manifest_name(r))
            for r in ranks
        ]
    else:
        layouts = [(0, "metrics.jsonl", "trace.json", "manifest.json")]
    for rank, metrics_name, trace_name, manifest_name in layouts:
        entry: Dict[str, Any] = {
            "rows": [], "torn_lines": 0, "trace": None, "manifest": None,
        }
        mpath = os.path.join(run_dir, metrics_name)
        if os.path.exists(mpath):
            entry["rows"], entry["torn_lines"] = read_jsonl(mpath)
        entry["trace"] = _load_json(os.path.join(run_dir, trace_name))
        entry["manifest"] = _load_json(os.path.join(run_dir, manifest_name))
        if entry["rows"] or entry["trace"] is not None \
                or entry["manifest"] is not None:
            out[rank] = entry
    return out


def expected_process_count(streams: Dict[int, Dict[str, Any]]) -> int:
    """The fleet size the streams themselves declare: the max
    process_count any manifest or row carries, floored by the ranks
    actually present (a stream claiming rank 5 proves count >= 6)."""
    count = 0
    for rank, entry in streams.items():
        man = entry.get("manifest") or {}
        fleet = man.get("fleet") or {}
        if isinstance(fleet.get("process_count"), int):
            count = max(count, fleet["process_count"])
        for row in entry.get("rows", [])[:1]:
            if isinstance(row.get("process_count"), int):
                count = max(count, row["process_count"])
        count = max(count, rank + 1)
    return max(count, len(streams))


# -- per-rank timelines -------------------------------------------------------


def _percentile(vals: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile, None on empty — wraps the ONE
    implementation (``obs.perf.decompose``, imported lazily)."""
    if not vals:
        return None
    from npairloss_tpu_torch.obs.perf.decompose import (
        _percentile as nearest,
    )

    return nearest(sorted(vals), q)


def _rank_timeline(entry: Dict[str, Any]) -> Dict[str, Any]:
    """One rank's per-step event times, in ABSOLUTE wall seconds.

    ``end_wall[step]`` comes from the train metric rows' ``wall_time``
    (the sync loop stamps it at step materialization; the pipelined
    loop at window emission — which is why dispatch spans are the
    primary skew source).  ``dispatch_wall[step]`` comes from the
    ``step/dispatch``/``step/compile`` spans: ``wall_time_origin +
    ts/1e6``, with the span's own ``step`` arg when present (fleet runs
    stamp it) and row-order assignment as the fallback."""
    rows = entry.get("rows", [])
    train_rows = [r for r in rows if r.get("phase") == "train"
                  and isinstance(r.get("step"), int)]
    end_wall = {r["step"]: float(r["wall_time"]) for r in train_rows
                if isinstance(r.get("wall_time"), (int, float))}
    steps_in_order = [r["step"] for r in train_rows]

    dispatch_wall: Dict[int, float] = {}
    spans_dropped = 0
    trace = entry.get("trace")
    if trace is not None:
        meta = trace.get("otherData", {}) or {}
        origin = meta.get("wall_time_origin")
        spans_dropped = int(meta.get("dropped_events", 0) or 0)
        if isinstance(origin, (int, float)):
            spans = sorted(
                (e for e in trace.get("traceEvents", [])
                 if e.get("ph") == "X"
                 and str(e.get("name", "")) in _STEP_SPAN_NAMES
                 and isinstance(e.get("ts"), (int, float))),
                key=lambda e: e["ts"],
            )
            unnumbered = []
            for ev in spans:
                args = ev.get("args") or {}
                if isinstance(args.get("step"), int):
                    dispatch_wall[args["step"]] = origin + ev["ts"] / 1e6
                else:
                    unnumbered.append(ev)
            if unnumbered and not dispatch_wall:
                # Ordinal fallback: the i-th step span belongs to the
                # i-th train row's step.
                for ev, step in zip(unnumbered, steps_in_order):
                    dispatch_wall[step] = origin + ev["ts"] / 1e6
    for r in rows:
        if isinstance(r.get("spans_dropped"), (int, float)):
            spans_dropped = max(spans_dropped, int(r["spans_dropped"]))
    return {
        "steps": sorted(end_wall),
        "end_wall": end_wall,
        "dispatch_wall": dispatch_wall,
        "spans_dropped": spans_dropped,
        "rows": len(rows),
    }


def _spread_series(
    timelines: Dict[int, Dict[str, Any]], key: str
) -> Tuple[List[int], Dict[int, float], Dict[int, int]]:
    """Steps every rank has a ``key`` time for -> (steps, spread_ms per
    step, slowest-rank per step)."""
    per_rank = {r: t[key] for r, t in timelines.items()}
    if not per_rank:
        return [], {}, {}
    common = set.intersection(*(set(m) for m in per_rank.values())) \
        if per_rank else set()
    steps = sorted(common)
    spread: Dict[int, float] = {}
    slowest: Dict[int, int] = {}
    for s in steps:
        times = {r: per_rank[r][s] for r in per_rank}
        lo, hi = min(times.values()), max(times.values())
        spread[s] = (hi - lo) * 1e3
        slowest[s] = max(times, key=times.get)
    return steps, spread, slowest


def _persistence(slowest: Dict[int, int]) -> Dict[str, Any]:
    """Who is slowest, how often, and for how long in a row."""
    if not slowest:
        return {"rank": None, "share": None, "persistence": 0}
    order = [slowest[s] for s in sorted(slowest)]
    counts: Dict[int, int] = {}
    for r in order:
        counts[r] = counts.get(r, 0) + 1
    top = max(counts, key=counts.get)
    best_run = run = 0
    run_rank = None
    for r in order:
        run = run + 1 if r == run_rank else 1
        run_rank = r
        if r == top:
            best_run = max(best_run, run)
    return {
        "rank": top,
        "share": round(counts[top] / len(order), 4),
        "persistence": best_run,
    }


# -- the report ---------------------------------------------------------------


def build_fleet_report(run_dir: str) -> Dict[str, Any]:
    """Aggregate one run directory into the versioned fleet report."""
    run_dir = os.path.abspath(run_dir)
    streams = load_rank_streams(run_dir)
    report: Dict[str, Any] = {
        "schema": FLEET_REPORT_SCHEMA,
        "run_dir": run_dir,
        "process_count": expected_process_count(streams),
        "ranks_present": sorted(streams),
        "ranks": [],
        "skew": {},
        "comms": {"available": False},
        "notes": [],
    }
    if not streams:
        report["notes"].append("no telemetry streams found")
        return report

    timelines = {r: _rank_timeline(e) for r, e in streams.items()}
    d_steps, d_spread, d_slowest = _spread_series(timelines,
                                                 "dispatch_wall")
    e_steps, e_spread, e_slowest = _spread_series(timelines, "end_wall")
    # Dispatch spans are the primary straggler evidence (the pipelined
    # loop's row wall_times stamp window emission, not the step); fall
    # back to row end times when no rank left numbered spans.
    steps, slowest = (d_steps, d_slowest) if d_steps else (e_steps,
                                                           e_slowest)
    spread_src = d_spread if d_steps else e_spread

    # Per-rank step cadence + barrier-wait share.
    wall_key = "dispatch_wall" if d_steps else "end_wall"
    step_ms: Dict[int, List[float]] = {r: [] for r in streams}
    wait_share: Dict[int, List[float]] = {r: [] for r in streams}
    for i in range(1, len(steps)):
        s0, s1 = steps[i - 1], steps[i]
        durs = {r: (timelines[r][wall_key][s1]
                    - timelines[r][wall_key][s0]) * 1e3
                for r in streams}
        slow_t = max(timelines[r][wall_key][s1] for r in streams)
        for r in streams:
            step_ms[r].append(durs[r])
            if durs[r] > 0:
                wait = (slow_t - timelines[r][wall_key][s1]) * 1e3
                # A SHARE of the step by definition: uncoupled streams
                # (no collectives actually linking the ranks) can show
                # a boundary gap larger than one step; clamp so the
                # column stays readable as "fraction of the step spent
                # waiting".
                wait_share[r].append(min(max(wait, 0.0) / durs[r], 1.0))

    for rank in sorted(streams):
        t = timelines[rank]
        dropped = t["spans_dropped"]
        flags: List[str] = []
        if dropped:
            flags.append(
                f"{dropped} spans dropped at the tracer cap — span-"
                "derived numbers for this rank are partial")
        if streams[rank]["torn_lines"]:
            flags.append(
                f"{streams[rank]['torn_lines']} torn metric line(s)")
        p50 = _percentile(step_ms[rank], 50)
        report["ranks"].append({
            "rank": rank,
            "rows": t["rows"],
            "torn_lines": streams[rank]["torn_lines"],
            "steps": len(t["steps"]),
            "first_step": t["steps"][0] if t["steps"] else None,
            "last_step": t["steps"][-1] if t["steps"] else None,
            "spans_dropped": dropped,
            "flagged": bool(flags),
            "flags": flags,
            "ms_per_step_p50": round(p50, 3) if p50 is not None else None,
            "barrier_wait_share": (
                round(sum(wait_share[rank]) / len(wait_share[rank]), 4)
                if wait_share[rank] else None
            ),
        })

    spread_vals = [spread_src[s] for s in steps]
    d_vals = [d_spread[s] for s in d_steps]
    e_vals = [e_spread[s] for s in e_steps]
    report["skew"] = {
        "steps_analyzed": len(steps),
        "source": "dispatch_spans" if d_steps else "row_wall_times",
        "dispatch_spread_ms_p50": _round(_percentile(d_vals, 50)),
        "dispatch_spread_ms_p99": _round(_percentile(d_vals, 99)),
        "end_spread_ms_p50": _round(_percentile(e_vals, 50)),
        "end_spread_ms_p99": _round(_percentile(e_vals, 99)),
        "slowest": _persistence(slowest),
    }

    # Missing ranks / step-count disagreement are REPORTED here and
    # ENFORCED by the validator / bench_check respectively.
    missing = [r for r in range(report["process_count"])
               if r not in streams]
    if missing:
        report["notes"].append(f"missing rank(s): {missing}")
    counts = {r["rank"]: r["steps"] for r in report["ranks"]}
    if len(set(counts.values())) > 1:
        report["notes"].append(
            f"per-rank step counts disagree: {counts} — ranks did not "
            "train in lockstep (or a stream was truncated)")
    dropped_ranks = [r["rank"] for r in report["ranks"]
                     if r["spans_dropped"]]
    if dropped_ranks:
        report["notes"].append(
            f"rank(s) {dropped_ranks} dropped spans at the tracer cap; "
            "their skew contribution is partial")

    report["comms"] = _comms_block(run_dir, streams, step_ms)
    return report


def _round(v: Optional[float], nd: int = 3) -> Optional[float]:
    return round(v, nd) if isinstance(v, (int, float)) else None


def _comms_block(
    run_dir: str,
    streams: Dict[int, Dict[str, Any]],
    step_ms: Dict[int, List[float]],
) -> Dict[str, Any]:
    """Join the Solver's collective pricing with the measured step
    cadence (``obs.fleet.comms``)."""
    from npairloss_tpu_torch.obs.fleet import comms as comms_mod

    payload = _load_json(os.path.join(run_dir, COMMS_FILENAME))
    if payload is None:
        return {
            "available": False,
            "reason": f"{COMMS_FILENAME} not found (training ran "
            "without fleet telemetry, or on a meshless solver)",
        }
    rows = comms_mod.comm_rows_from_counts(
        payload.get("per_kind", {}),
        extra_claims=payload.get("extra_claims", {}),
    )
    all_ms = [m for r in step_ms.values() for m in r]
    joined = comms_mod.effective_bandwidth(
        rows,
        _percentile(all_ms, 50),
        payload.get("device_kind", ""),
        payload.get("link", "nccl"),
        int(payload.get("hosts", 1) or 1),
    )
    joined["available"] = True
    joined["unattributed_bytes"] = rows["unattributed_bytes"]
    return joined


# -- contract -----------------------------------------------------------------


def validate_fleet_report(obj: Any) -> Optional[str]:
    """Schema check; returns an error string or None.  This IS the
    fleet-report contract (the JAX package's, copied): ``prof --fleet``
    and the tests call exactly this."""
    if not isinstance(obj, dict):
        return "report must be a JSON object"
    if obj.get("schema") != FLEET_REPORT_SCHEMA:
        return (f"schema must be {FLEET_REPORT_SCHEMA!r}, "
                f"got {obj.get('schema')!r}")
    pc = obj.get("process_count")
    if not isinstance(pc, int) or pc < 1:
        return f"process_count must be a positive int, got {pc!r}"
    ranks = obj.get("ranks")
    if not isinstance(ranks, list) or not ranks:
        return "missing ranks list"
    seen = []
    for i, row in enumerate(ranks):
        if not isinstance(row, dict):
            return f"rank row {i} is not an object"
        for key in RANK_KEYS:
            if key not in row:
                return f"rank row {i} missing {key!r}"
        if row["spans_dropped"] and not row["flagged"]:
            return (f"rank {row['rank']} dropped {row['spans_dropped']} "
                    "spans but is not flagged — a capped rank must be "
                    "flagged, not averaged")
        seen.append(row["rank"])
    missing = [r for r in range(pc) if r not in seen]
    if missing:
        return (f"rank(s) {missing} missing: report covers {sorted(seen)} "
                f"of process_count {pc}")
    skew = obj.get("skew")
    if not isinstance(skew, dict):
        return "missing skew block"
    for key in SKEW_KEYS:
        if key not in skew:
            return f"skew block missing {key!r}"
    slowest = skew["slowest"]
    if not isinstance(slowest, dict) or "rank" not in slowest \
            or "persistence" not in slowest:
        return "skew.slowest must carry rank + persistence"
    comms = obj.get("comms")
    if not isinstance(comms, dict) or "available" not in comms:
        return "missing comms block"
    if comms.get("available"):
        if not isinstance(comms.get("kinds"), list):
            return "comms block missing kinds list"
        for i, k in enumerate(comms["kinds"]):
            for key in ("kind", "bytes_per_step", "claimed",
                        "effective_bytes_per_s", "link_utilization"):
                if key not in k:
                    return f"comms kind {i} missing {key!r}"
        ub = comms.get("unattributed_bytes")
        if not isinstance(ub, (int, float)) or ub < 0:
            return f"comms.unattributed_bytes invalid: {ub!r}"
    return None


# -- renderer -----------------------------------------------------------------


def render_fleet_table(report: Dict[str, Any]) -> str:
    """Human-readable counterpart of the JSON."""
    lines = [
        f"fleet report: {report.get('process_count')} process(es), "
        f"ranks present {report.get('ranks_present')}",
        "",
        f"{'rank':>4s} {'steps':>6s} {'ms/step':>9s} {'wait%':>7s} "
        f"{'dropped':>8s} {'torn':>5s}  flags",
    ]
    for r in report.get("ranks", []):
        ms = (f"{r['ms_per_step_p50']:.2f}"
              if r["ms_per_step_p50"] is not None else "-")
        ws = (f"{100 * r['barrier_wait_share']:.1f}"
              if r["barrier_wait_share"] is not None else "-")
        lines.append(
            f"{r['rank']:4d} {r['steps']:6d} {ms:>9s} {ws:>7s} "
            f"{r['spans_dropped']:8d} {r['torn_lines']:5d}  "
            + ("; ".join(r.get("flags", [])) or "-"))
    skew = report.get("skew", {})
    if skew:
        sl = skew.get("slowest", {})
        lines += [
            "",
            f"skew over {skew.get('steps_analyzed')} step(s) "
            f"[{skew.get('source')}]: dispatch spread p50 "
            f"{skew.get('dispatch_spread_ms_p50')} ms / p99 "
            f"{skew.get('dispatch_spread_ms_p99')} ms; end spread p50 "
            f"{skew.get('end_spread_ms_p50')} ms",
            f"slowest rank: {sl.get('rank')} "
            f"(share {sl.get('share')}, persistence "
            f"{sl.get('persistence')} consecutive step(s))",
        ]
    comms = report.get("comms", {})
    if comms.get("available"):
        peak = comms.get("peak_bytes_per_s")
        peak_s = (f"peak {peak / 1e9:.0f} GB/s"
                  + ("" if comms.get("peak_known") else ", fallback spec")
                  if peak else "no published peak")
        lines += ["", f"comms (link {comms.get('link')}, {peak_s}):"]
        for k in comms.get("kinds", []):
            eff = k.get("effective_bytes_per_s")
            eff_s = f"{eff / 1e9:.3f} GB/s" if eff else "-"
            util = k.get("link_utilization")
            util_s = f"{100 * util:.2f}%" if util is not None else "-"
            cov = k.get("scope_coverage")
            cov_s = f"{100 * cov:.0f}%" if cov is not None else "-"
            lines.append(
                f"  {k['kind']:14s} {k['bytes_per_step']:12.3e} B/step  "
                f"eff {eff_s:>12s}  util {util_s:>8s}  "
                f"scope {cov_s:>5s}  "
                + ("claimed" if k.get("claimed") else "UNCLAIMED"))
        lines.append(
            f"  unattributed collective bytes: "
            f"{comms.get('unattributed_bytes', 0):.0f}")
    elif comms:
        lines += ["", f"comms: unavailable ({comms.get('reason')})"]
    for note in report.get("notes", []):
        lines.append(f"note: {note}")
    return "\n".join(lines) + "\n"


def write_fleet_report(report: Dict[str, Any], out_dir: str,
                       name: str = "fleet_report") -> Dict[str, str]:
    """Write ``<out_dir>/<name>.json`` + ``.txt`` (atomic tmp+rename);
    returns the paths — the ``obs.perf.report`` writer."""
    from npairloss_tpu_torch.obs.perf.report import write_json_txt

    return write_json_txt(report, out_dir, name, render_fleet_table)
