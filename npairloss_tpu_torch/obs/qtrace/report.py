"""The versioned ``npairloss-qtrace-v1`` contract: exemplar query traces.
Port of ``npairloss_tpu/obs/qtrace/report.py`` (a copy: the same schema,
key for key, so the JAX package's ``validate_qtrace_report`` accepts the
port's artifacts).

One JSON object per serve run (written at drain by
:class:`npairloss_tpu_torch.obs.qtrace.core.QueryTracer`): the per-stage
p99 budget decomposition plus the retained exemplar span trees — full
per-query traces kept ONLY for SLO-violating and slowest-tail queries,
never a full-qps flight recorder.  ``validate_qtrace_report`` IS the
contract; consumers (the timeline merger, ``chip_smoke.py``) rely on
exactly the keys it checks.

Stdlib only and self-contained (no intra-package imports), so a process
without torch can load it by file path.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

QTRACE_SCHEMA = "npairloss-qtrace-v1"

# The serving-tier stage vocabulary, in pipeline order (socket ->
# admission gate -> replica queue -> co-rider coalescing -> dispatcher ->
# device top-K -> host merge/answer assembly).
STAGES: Tuple[str, ...] = (
    "admit_wait",
    "queue_wait",
    "batch_assemble",
    "dispatch",
    "score",
    "topk_merge",
)

# Point markers (Chrome "i" instants) the serve tier may record outside
# any single query's tree: a hot-swap generation flip and a crash
# reroute are tier-level events that explain tail spikes.
MARKER_NAMES: Tuple[str, ...] = ("hotswap_flip", "crash_reroute")

# Span-name vocabulary inside an exemplar tree: one root covering
# ingest -> answer plus one span per stage.
ROOT_SPAN = "qtrace/query"
STAGE_SPANS: Tuple[str, ...] = tuple(f"qtrace/{s}" for s in STAGES)

# The fused IVF probe (the hand-written CUDA kernel) collapses score +
# topk_merge into ONE device dispatch; its trace wraps those two stage
# spans in this extra (non-stage) span.  It is allowed vocabulary inside
# an exemplar tree but NOT a stage: ``stages``/``stage_us`` keep the v1
# six-stage contract, so fused and scan artifacts validate identically.
PROBE_FUSED_SPAN = "qtrace/probe_fused"

REPORT_KEYS: Tuple[str, ...] = (
    "schema", "wall_time_origin", "slo_ms", "ring_tolerance", "stages",
    "totals", "budget", "markers", "exemplars",
)
TOTAL_KEYS: Tuple[str, ...] = (
    "queries", "errors", "dropped", "violations", "exemplars",
    "evicted", "reroutes", "hotswap_flips",
)
BUDGET_KEYS: Tuple[str, ...] = (
    "p99_ms", "dominant", "dominant_ms", "stage_p99_ms", "worst_mean_ms",
)
EXEMPLAR_KEYS: Tuple[str, ...] = (
    "trace_id", "qid", "reason", "total_ms", "wall_time", "replica",
    "events",
)
EXEMPLAR_REASONS: Tuple[str, ...] = ("slo", "tail")

# Span-containment slack in microseconds: stage timestamps are stamped
# by different threads off one monotonic clock, so exact float equality
# at span edges is not guaranteed.
NEST_SLACK_US = 2.0


def _num(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _check_event(ev: Any, where: str) -> Optional[str]:
    """Chrome-trace shape for one qtrace event; error string or None."""
    if not isinstance(ev, dict):
        return f"{where}: event is not an object"
    name = ev.get("name")
    if not isinstance(name, str) or not name:
        return f"{where}: event missing name"
    ph = ev.get("ph")
    if ph not in ("X", "i"):
        return f"{where}: event {name!r} has ph {ph!r} (want X or i)"
    if not _num(ev.get("ts")):
        return f"{where}: event {name!r} has non-numeric ts"
    if ph == "X" and not (_num(ev.get("dur")) and ev["dur"] >= 0):
        return f"{where}: X event {name!r} needs a non-negative dur"
    return None


def _check_exemplar(ex: Any, i: int) -> Optional[str]:
    where = f"exemplars[{i}]"
    if not isinstance(ex, dict):
        return f"{where}: not an object"
    for key in EXEMPLAR_KEYS:
        if key not in ex:
            return f"{where}: missing key {key!r}"
    tid = ex.get("trace_id")
    if not isinstance(tid, str) or not tid:
        return f"{where}: trace_id must be a non-empty string"
    if ex.get("reason") not in EXEMPLAR_REASONS:
        return (f"{where}: reason {ex.get('reason')!r} not in "
                f"{EXEMPLAR_REASONS}")
    if not (_num(ex.get("total_ms")) and ex["total_ms"] > 0):
        return f"{where}: total_ms must be a positive number"
    events = ex.get("events")
    if not isinstance(events, list) or not events:
        return f"{where}: events must be a non-empty list"
    roots: List[Dict[str, Any]] = []
    last_ts = None
    for j, ev in enumerate(events):
        err = _check_event(ev, f"{where}.events[{j}]")
        if err:
            return err
        name = ev["name"]
        if name == ROOT_SPAN:
            roots.append(ev)
        elif name not in STAGE_SPANS and name != PROBE_FUSED_SPAN:
            return (f"{where}.events[{j}]: span name {name!r} outside "
                    f"the qtrace vocabulary")
        args = ev.get("args")
        if not (isinstance(args, dict) and args.get("trace_id") == tid):
            return (f"{where}.events[{j}]: args.trace_id must equal the "
                    f"exemplar's trace_id {tid!r}")
        # Ordering: the tree is emitted sorted by start timestamp.
        if last_ts is not None and ev["ts"] < last_ts:
            return (f"{where}.events[{j}]: events out of ts order "
                    f"({ev['ts']} after {last_ts})")
        last_ts = ev["ts"]
    if len(roots) != 1:
        return (f"{where}: expected exactly one {ROOT_SPAN!r} root span, "
                f"got {len(roots)}")
    root = roots[0]
    r0, r1 = root["ts"], root["ts"] + root["dur"]
    dispatch = None
    for ev in events:
        if ev.get("ph") != "X" or ev is root:
            continue
        e0, e1 = ev["ts"], ev["ts"] + ev["dur"]
        if e0 < r0 - NEST_SLACK_US or e1 > r1 + NEST_SLACK_US:
            return (f"{where}: span {ev['name']!r} [{e0}, {e1}] escapes "
                    f"the root span [{r0}, {r1}] — broken nesting")
        if ev["name"] == f"qtrace/{STAGES[3]}":
            dispatch = ev
    if dispatch is not None:
        d0 = dispatch["ts"] - NEST_SLACK_US
        d1 = dispatch["ts"] + dispatch["dur"] + NEST_SLACK_US
        for ev in events:
            if ev.get("name") in ("qtrace/score", "qtrace/topk_merge",
                                  PROBE_FUSED_SPAN):
                if ev["ts"] < d0 or ev["ts"] + ev["dur"] > d1:
                    return (f"{where}: {ev['name']!r} escapes its parent "
                            "dispatch span — broken nesting")
    return None


def validate_qtrace_report(obj: Any) -> Optional[str]:
    """Error string when ``obj`` violates the qtrace-v1 contract, else
    None.  Schema tag, key presence, stage vocabulary, per-exemplar
    span shape/ordering/nesting, and trace-id uniqueness."""
    if not isinstance(obj, dict):
        return "qtrace report is not a JSON object"
    for key in REPORT_KEYS:
        if key not in obj:
            return f"missing key {key!r}"
    if obj["schema"] != QTRACE_SCHEMA:
        return (f"schema {obj['schema']!r} != {QTRACE_SCHEMA!r} — "
                "refusing to interpret a foreign artifact")
    if tuple(obj["stages"]) != STAGES:
        return (f"stages {obj['stages']!r} do not match the contract "
                f"vocabulary {STAGES}")
    if not (_num(obj["ring_tolerance"]) and obj["ring_tolerance"] >= 0):
        return "ring_tolerance must be a non-negative number"
    if not _num(obj["slo_ms"]):
        return "slo_ms must be numeric"
    totals = obj["totals"]
    if not isinstance(totals, dict):
        return "totals must be an object"
    for key in TOTAL_KEYS:
        v = totals.get(key)
        if not (isinstance(v, int) and not isinstance(v, bool)
                and v >= 0):
            return f"totals[{key!r}] must be a non-negative integer"
    budget = obj["budget"]
    if not isinstance(budget, dict):
        return "budget must be an object"
    for key in BUDGET_KEYS:
        if key not in budget:
            return f"budget missing key {key!r}"
    if not (_num(budget["p99_ms"]) and budget["p99_ms"] >= 0):
        return "budget.p99_ms must be a non-negative number"
    if budget["dominant"] not in STAGES + ("",):
        return (f"budget.dominant {budget['dominant']!r} is not a "
                "known stage")
    for key in ("stage_p99_ms", "worst_mean_ms"):
        block = budget[key]
        if not isinstance(block, dict):
            return f"budget.{key} must be an object"
        for stage in block:
            if stage not in STAGES:
                return f"budget.{key} names unknown stage {stage!r}"
    markers = obj["markers"]
    if not isinstance(markers, list):
        return "markers must be a list"
    for j, ev in enumerate(markers):
        err = _check_event(ev, f"markers[{j}]")
        if err:
            return err
        if ev.get("ph") != "i" or ev.get("name") not in MARKER_NAMES:
            return (f"markers[{j}]: must be an 'i' instant named one of "
                    f"{MARKER_NAMES}")
    exemplars = obj["exemplars"]
    if not isinstance(exemplars, list):
        return "exemplars must be a list"
    if totals["exemplars"] != len(exemplars):
        return (f"totals.exemplars {totals['exemplars']} != "
                f"{len(exemplars)} retained exemplars")
    seen: set = set()
    for i, ex in enumerate(exemplars):
        err = _check_exemplar(ex, i)
        if err:
            return err
        tid = ex["trace_id"]
        if tid in seen:
            return (f"duplicate trace_id {tid!r} — exemplar identity "
                    "must be unique within one artifact")
        seen.add(tid)
    return None


def qtrace_p99_consistency(obj: Dict[str, Any]) -> Optional[str]:
    """The exemplar set must AGREE with the aggregation it rode along
    with: the worst retained span tree bounds the logged window p99
    from above (the tail rule retains every ring maximum), within the
    artifact's own ring tolerance.  Error string or None; call after
    :func:`validate_qtrace_report`."""
    exemplars = obj.get("exemplars") or []
    budget = obj.get("budget") or {}
    p99 = budget.get("p99_ms") or 0.0
    if not exemplars or not _num(p99) or p99 <= 0:
        return None  # nothing to cross-check
    worst = max(float(ex["total_ms"]) for ex in exemplars)
    tol = float(obj.get("ring_tolerance") or 0.0)
    if p99 > worst * (1.0 + tol):
        return (f"logged window p99 {p99:.3f} ms exceeds the worst "
                f"exemplar span tree ({worst:.3f} ms) by more than the "
                f"ring tolerance ({tol:.2f}) — the exemplar set "
                "disagrees with the aggregation it shipped with")
    return None


def load_qtrace_report(path: str) -> Dict[str, Any]:
    """Parse a qtrace artifact; raises ``ValueError`` on non-JSON."""
    with open(path, "r", encoding="utf-8") as f:
        try:
            obj = json.load(f)
        except json.JSONDecodeError as e:
            raise ValueError(f"{path}: not valid JSON ({e})") from None
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: qtrace artifact must be a JSON object")
    return obj
