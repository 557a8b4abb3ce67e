"""The versioned ``npairloss-quality-v1`` contract: the quality log.
Port of ``npairloss_tpu/obs/quality/report.py`` (a copy: the same schema,
key for key, so the JAX package's ``validate_quality_report`` accepts the
port's logs and this one accepts JAX's).

The shadow scorer (:mod:`npairloss_tpu_torch.obs.quality.shadow`)
appends one JSONL stream per serving run — ``quality.jsonl`` in the
telemetry dir — recording what the online recall estimate actually
observed:

  * one ``config`` record FIRST (shadow rate, seed, recall Ks, the
    declared recall floor when an SLO armed one, and the committed
    ``parity`` baseline from the served IVF index's commit manifest —
    the birth certificate the live estimate is compared against);
  * one ``window`` record per emitted shadow window (per-K recall,
    score-gap stats, the running sampled total);
  * at most one ``summary`` record LAST (drain time, last-sample wall
    time) — the evidence the stale-shadow check reads.

``validate_quality_report`` IS the contract: consumers (``prof
--quality``) rely on every key it checks.  Stdlib only and
self-contained (no intra-package imports), so a process without torch
can load it by file path.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

QUALITY_SCHEMA = "npairloss-quality-v1"
QUALITY_KINDS = ("config", "window", "summary")

# Keys every record of each kind carries (pinned by
# tests/test_torch_quality.py against the JAX package's).
CONFIG_KEYS = ("schema", "kind", "shadow_rate", "seed", "ks", "window",
               "wall_time")
WINDOW_KEYS = ("schema", "kind", "wall_time", "samples", "sampled_total",
               "score_gap_mean", "score_gap_max")
SUMMARY_KEYS = ("schema", "kind", "wall_time", "sampled_total", "windows",
                "dropped")

# A shadow scorer that went silent for this long before the drain
# "silently stopped sampling" — overridable per run via the config
# record's ``stale_after_s`` (the scorer stamps it from its own window
# cadence).
DEFAULT_STALE_AFTER_S = 60.0


def load_quality_report(path: str) -> List[Dict[str, Any]]:
    """Read one quality JSONL file; a torn final line (killed writer)
    is tolerated, any other unparseable line surfaces through the
    validator via a sentinel record (the alert-log loader's contract)."""
    records: List[Dict[str, Any]] = []
    with open(path) as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            records.append(json.loads(line))
        except ValueError:
            if i == len(lines) - 1:
                continue  # torn tail: the crash-durability contract
            records.append({"_bad_line": i + 1})
    return records


def _num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def validate_quality_report(records: Sequence[Any]) -> Optional[str]:
    """Schema + stream-shape check; returns an error string or None.

    The contract: every record carries the schema tag and a known
    ``kind``; the FIRST record is the one ``config`` (shadow_rate in
    (0, 1], ascending unique integer ``ks``, window >= 1; the optional
    ``recall_floor`` is in [0, 1] and names its ``floor_metric``);
    every ``window`` carries ``recall_at_<k>`` in [0, 1] for each
    declared k, a positive integer sample count, non-negative score
    gaps with ``max >= mean``, and ``sampled_total``/``wall_time``
    non-decreasing across the stream; at most one ``summary``, last.
    """
    if not records:
        return "empty quality report (not even a config record)"
    ks: List[int] = []
    prev_total = 0
    prev_t = None
    saw_summary = False
    for i, rec in enumerate(records):
        if not isinstance(rec, dict):
            return f"record {i} is not an object"
        if "_bad_line" in rec:
            return f"unparseable JSON on line {rec['_bad_line']}"
        if rec.get("schema") != QUALITY_SCHEMA:
            return (f"record {i}: schema must be {QUALITY_SCHEMA!r}, "
                    f"got {rec.get('schema')!r}")
        kind = rec.get("kind")
        if kind not in QUALITY_KINDS:
            return f"record {i}: kind {kind!r} not in {QUALITY_KINDS}"
        if saw_summary:
            return (f"record {i}: {kind} record after the summary "
                    "(the summary is the stream's last word)")
        if i == 0:
            if kind != "config":
                return ("record 0 must be the config record, got "
                        f"kind {kind!r}")
        elif kind == "config":
            return f"record {i}: duplicate config record"
        if kind == "config":
            for key in CONFIG_KEYS:
                if key not in rec:
                    return f"record {i} (config) missing {key!r}"
            rate = rec["shadow_rate"]
            if not _num(rate) or not (0.0 < rate <= 1.0):
                return (f"record {i}: shadow_rate {rate!r} outside "
                        "(0, 1] — a zero-rate run writes no report")
            raw_ks = rec["ks"]
            if (not isinstance(raw_ks, list) or not raw_ks
                    or any(not isinstance(k, int) or isinstance(k, bool)
                           or k < 1 for k in raw_ks)
                    or raw_ks != sorted(set(raw_ks))):
                return (f"record {i}: ks must be ascending unique "
                        f"integers >= 1, got {raw_ks!r}")
            ks = list(raw_ks)
            if not isinstance(rec["window"], int) or rec["window"] < 1:
                return f"record {i}: window must be an integer >= 1"
            if not _num(rec["wall_time"]):
                return f"record {i}: wall_time is not numeric"
            floor = rec.get("recall_floor")
            if floor is not None:
                if not _num(floor) or not (0.0 <= floor <= 1.0):
                    return (f"record {i}: recall_floor {floor!r} "
                            "outside [0, 1]")
                metric = rec.get("floor_metric")
                if not isinstance(metric, str) or not metric:
                    return (f"record {i}: recall_floor declared without "
                            "its floor_metric (the alert cross-check "
                            "needs the metric name)")
            stale = rec.get("stale_after_s")
            if stale is not None and (not _num(stale) or stale <= 0):
                return f"record {i}: stale_after_s must be > 0"
            baseline = rec.get("baseline")
            if baseline is not None and not isinstance(baseline, dict):
                return f"record {i}: baseline is not an object"
            prev_t = float(rec["wall_time"])
        elif kind == "window":
            for key in WINDOW_KEYS:
                if key not in rec:
                    return f"record {i} (window) missing {key!r}"
            if not isinstance(rec["samples"], int) or rec["samples"] < 1:
                return f"record {i}: samples must be an integer >= 1"
            for k in ks:
                r = rec.get(f"recall_at_{k}")
                if not _num(r) or not (0.0 <= r <= 1.0):
                    return (f"record {i}: recall_at_{k} {r!r} missing "
                            "or outside [0, 1]")
            gm, gx = rec["score_gap_mean"], rec["score_gap_max"]
            if not _num(gm) or gm < 0 or not _num(gx) or gx < 0:
                return (f"record {i}: score gaps must be numeric >= 0 "
                        "(the exact score can never trail the served "
                        "one after clamping)")
            if gx < gm - 1e-9:
                return (f"record {i}: score_gap_max {gx} < "
                        f"score_gap_mean {gm}")
            total = rec["sampled_total"]
            if not isinstance(total, int) or total < prev_total:
                return (f"record {i}: sampled_total {total!r} regressed "
                        f"(previous {prev_total}) — the counter is "
                        "monotone")
            prev_total = total
            if not _num(rec["wall_time"]):
                return f"record {i}: wall_time is not numeric"
            t = float(rec["wall_time"])
            if prev_t is not None and t < prev_t - 1e-6:
                return (f"record {i}: wall_time {t} precedes the "
                        f"previous record's {prev_t}")
            prev_t = t
        else:  # summary
            for key in SUMMARY_KEYS:
                if key not in rec:
                    return f"record {i} (summary) missing {key!r}"
            if not _num(rec["wall_time"]):
                return f"record {i}: wall_time is not numeric"
            if not isinstance(rec["windows"], int) or rec["windows"] < 0:
                return f"record {i}: windows must be an integer >= 0"
            n_windows = sum(1 for r in records[:i]
                            if isinstance(r, dict)
                            and r.get("kind") == "window")
            if rec["windows"] != n_windows:
                return (f"record {i}: summary claims {rec['windows']} "
                        f"window(s), the stream holds {n_windows}")
            if rec["sampled_total"] != prev_total and n_windows:
                return (f"record {i}: summary sampled_total "
                        f"{rec['sampled_total']} != last window's "
                        f"{prev_total}")
            last = rec.get("last_sample_wall_time")
            if rec["sampled_total"] > 0 and not _num(last):
                return (f"record {i}: summary with samples but no "
                        "numeric last_sample_wall_time (the stale-"
                        "shadow gate needs it)")
            offered = rec.get("offered_total")
            if offered is not None and (
                    not isinstance(offered, int) or offered < 0):
                return (f"record {i}: offered_total must be an "
                        "integer >= 0")
            lo = rec.get("last_offer_wall_time")
            if lo is not None and not _num(lo):
                return f"record {i}: last_offer_wall_time not numeric"
            saw_summary = True
    return None


# -- read helpers (prof --quality) --------------------------------------------


def quality_breaches(records: Sequence[Dict[str, Any]]
                     ) -> List[Tuple[int, str, float, float]]:
    """(record index, metric, recall, floor) for every window whose
    floor-K recall fell below the config's declared ``recall_floor``.
    Empty when no floor was declared (no SLO armed one) or nothing
    breached.  Call only on a validated report."""
    cfg = records[0]
    floor = cfg.get("recall_floor")
    if floor is None:
        return []
    metric = str(cfg.get("floor_metric"))
    # floor_metric is "serve_recall_at_<k>"; the window key drops the
    # phase prefix (the row->gauge mapping adds it back).
    key = metric[len("serve_"):] if metric.startswith("serve_") else metric
    out: List[Tuple[int, str, float, float]] = []
    for i, rec in enumerate(records):
        if rec.get("kind") != "window":
            continue
        r = rec.get(key)
        if isinstance(r, (int, float)) and r < floor:
            out.append((i, metric, float(r), float(floor)))
    return out


def stale_shadow(records: Sequence[Dict[str, Any]]) -> Optional[str]:
    """An error string when the shadow scorer silently stopped SCORING
    while traffic kept arriving.  The summary's offer-side evidence
    (``offered_total``/``last_offer_wall_time`` — stamped by the
    dispatch, not the scorer thread) is what separates a stalled
    scorer from stopped traffic: offers outrunning the last scored
    sample by more than ``stale_after_s`` is a wedge; a drain minutes
    after the last QUERY is a healthy idle server.  Older logs without
    the offer keys fall back to the drain-time heuristic.  None when
    the stream looks live, or when no summary exists (a killed run is
    the alert gate's problem).  Call only on a validated report."""
    cfg = records[0]
    summary = next((r for r in records if r.get("kind") == "summary"),
                   None)
    if summary is None:
        return None
    stale_after = float(cfg.get("stale_after_s", DEFAULT_STALE_AFTER_S))
    offered = summary.get("offered_total")
    last_offer = summary.get("last_offer_wall_time")
    if summary["sampled_total"] == 0:
        if offered == 0:
            return None  # no traffic was ever sampled — not a wedge
        age = float(summary["wall_time"]) - float(cfg["wall_time"])
        if age > stale_after:
            return (f"shadow scorer sampled NOTHING in {age:.1f}s of "
                    "run"
                    + (f" ({offered} offer(s) arrived)"
                       if offered else
                       " (rate > 0 but zero samples reached the "
                       "oracle)"))
        return None
    last_sample = float(summary["last_sample_wall_time"])
    if last_offer is not None:
        age = float(last_offer) - last_sample
        if age > stale_after:
            return (f"shadow scorer went silent: offers kept arriving "
                    f"{age:.1f}s past the last scored sample "
                    f"(stale_after_s={stale_after:g}) — scoring "
                    "stalled mid-run")
        return None
    age = float(summary["wall_time"]) - last_sample
    if age > stale_after:
        return (f"shadow scorer went silent: last sample {age:.1f}s "
                f"before the drain (stale_after_s={stale_after:g}) — "
                "sampling stopped mid-run")
    return None


def quality_summary(records: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Aggregate view for ``prof --quality``: per-K min/mean
    recall over every window, worst score gap, breach count vs the
    declared floor, and the committed baseline (when the config carried
    one) for side-by-side reading.  Call only on a validated report."""
    cfg = records[0]
    windows = [r for r in records if r.get("kind") == "window"]
    ks = list(cfg.get("ks", []))
    recall: Dict[str, Dict[str, float]] = {}
    for k in ks:
        vals = [float(w[f"recall_at_{k}"]) for w in windows]
        if vals:
            recall[f"at_{k}"] = {
                "min": round(min(vals), 4),
                "mean": round(sum(vals) / len(vals), 4),
                "last": round(vals[-1], 4),
            }
    out: Dict[str, Any] = {
        "windows": len(windows),
        "sampled_total": (windows[-1]["sampled_total"] if windows else 0),
        "shadow_rate": cfg.get("shadow_rate"),
        "recall": recall,
        "breaches": len(quality_breaches(records)),
    }
    gaps = [float(w["score_gap_max"]) for w in windows]
    if gaps:
        out["score_gap_max"] = round(max(gaps), 6)
    if cfg.get("recall_floor") is not None:
        out["recall_floor"] = cfg["recall_floor"]
        out["floor_metric"] = cfg.get("floor_metric")
    if isinstance(cfg.get("baseline"), dict):
        out["baseline"] = cfg["baseline"]
    return out
