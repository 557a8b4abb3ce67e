"""The gameday verdict — schema ``npairloss-gameday-v1``.

A copy of ``npairloss_tpu/gameday/verdict.py``: the same report, the
same checks and messages, so each package's validator accepts the
other's reports.

:func:`build_gameday_report` cross-reconciles every artifact a gameday
run produced — the alert logs, the remediation audits, the serve
metric rows, the shadow-recall quality windows, the drain summary, the
fleet comms block, the trainer's exit codes — into ONE versioned
report, and :func:`validate_gameday_report` IS the pass/fail contract:

  * every injected fault fired, its declared alert fired AND resolved,
    and its declared remediation succeeded (signal faults: exit 75 +
    a resumed segment);
  * every fault that declares a ``stage`` shows it in the qtrace
    evidence (the ``serve.p99_attribution`` check): the dominant stage
    of the worst decomposed window row inside the fault's own incident
    windows must match the declaration — or, for ``reroute``, the
    qtrace artifact must have counted crash-reroute markers — so the
    per-stage attribution is proven against scripted faults, not
    decorative;
  * p99 and shadow recall held on every metric row OUTSIDE the
    declared incident windows (injected faults are supposed to breach
    — each fired alert opens a window ``[fired_at - pad_before,
    resolved_at + pad_after]``; a breach outside every window is a
    real regression);
  * zero dropped queries across every hot-swap: ``queries_dropped`` is
    PRESENT and 0 (the tier ran with explicit drops on — zero is
    evidence, not a default), the ``queries == answered + errors +
    rejected`` invariant holds, and ``hot_swaps`` meets the declared
    minimum;
  * zero unattributed comms bytes whenever the fleet comms block is
    available.

Like every ``npairloss-*-v1`` contract, this module is **stdlib-only
and self-contained**: a gate loads it by file path without importing
the package, so it must not import torch, numpy, or any sibling module
— pinned by the staticcheck purity pass
(npairloss_tpu_torch/analysis/purity.py).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

GAMEDAY_SCHEMA = "npairloss-gameday-v1"

# Top-level keys every report carries, in order.  "tenants" is NOT in
# this tuple on purpose: reports written before multi-tenant serving
# existed must keep validating, so the tenant-isolation block is
# optional-but-judged (gated whenever present and available).
REPORT_KEYS = (
    "schema", "window_s", "seed", "traffic", "faults", "incidents",
    "slo", "drain", "zero_drop", "comms", "trainer", "qtrace",
    "host_crash", "verdict", "failures",
)
# The tenant-isolation evidence block (the tenant_skew scenario):
# per-tenant counters lifted from the drain summary, per-tenant worst
# recall outside incident windows, and whether a tenant-scoped alert
# (slo name ending "@<tenant_id>" — serve/tenants.py's tenant_of_slo
# naming contract, restated here because this module is loaded by file
# path without the package) ever fired for each tenant.
TENANT_GATE_KEYS = ("available", "hot", "p99_target_ms",
                    "recall_floor", "tenants")
TENANT_ROW_KEYS = ("queries", "answered", "errors", "rejected", "shed",
                   "p99_ms", "alerted", "recall_worst")
# Durable-ingest evidence the SIGKILL drill stores (host_crash block;
# ``{"available": false}`` on runs that scripted no serve kill).  The
# ingest_durable / ingest_no_duplicates fault checks are RECOMPUTED
# from these numbers by ``_gate_failures`` — a report whose fault rows
# claim the checks passed over evidence that says otherwise is refused.
HOST_CRASH_KEYS = ("available", "kills", "acked_batches",
                   "acked_vectors", "lost", "duplicates",
                   "torn_records", "self_recall")
TRAFFIC_KEYS = ("planned", "fed", "answered", "errors", "rejected",
                "sha256")
FAULT_KEYS = (
    "name", "target", "kind", "count", "delay", "at_s", "alert",
    "remediation", "expect", "stage", "observed_fires", "fired",
    "alert_fired", "alert_resolved", "remediation_state",
    "stage_observed", "checks", "ok",
)
P99_KEYS = ("target_ms", "rows", "in_incident", "breaches_outside",
            "worst_outside_ms")
RECALL_KEYS = ("floor", "rows", "in_incident", "breaches_outside",
               "worst_outside")
ZERO_DROP_KEYS = ("min_hot_swaps", "hot_swaps", "queries_dropped",
                  "invariant_holds")
TRAINER_KEYS = ("segments", "exit_codes", "resumed")
VERDICTS = ("pass", "fail")


# -- incident windows --------------------------------------------------------


def incident_windows(alerts: Sequence[Dict[str, Any]],
                     pad_before_s: float = 30.0,
                     pad_after_s: float = 10.0,
                     horizon: Optional[float] = None,
                     ) -> List[Dict[str, Any]]:
    """One window per fired alert: ``[fired_at - pad_before,
    resolved_at + pad_after]``.  The pads cover window-quantized metric
    rows: the breach that FED the alert landed in rows stamped before
    the alert's tick, and recovery is visible one window late.  An
    alert never resolved stays open to ``horizon`` (the run's last
    wall time) — the unresolved alert itself fails a different gate."""
    open_at: Dict[str, Dict[str, Any]] = {}
    out: List[Dict[str, Any]] = []
    for rec in alerts:
        if not isinstance(rec, dict) or "_bad_line" in rec:
            continue
        state, aid = rec.get("state"), rec.get("alert_id")
        if state == "firing" and aid not in open_at:
            open_at[aid] = {
                "slo": rec.get("slo"), "alert_id": aid,
                "start": float(rec["fired_at"]) - pad_before_s,
            }
        elif state == "resolved" and aid in open_at:
            win = open_at.pop(aid)
            win["end"] = float(rec["ts"]) + pad_after_s
            out.append(win)
    for win in open_at.values():  # never resolved: open to the horizon
        win["end"] = (float(horizon) + pad_after_s
                      if horizon is not None else win["start"])
        out.append(win)
    out.sort(key=lambda w: w["start"])
    return out


def _in_windows(t: float, windows: Sequence[Dict[str, Any]]) -> bool:
    return any(w["start"] <= t <= w["end"] for w in windows)


def _slo_gate(rows: Sequence[Dict[str, Any]], metric: str, bad,
              windows: Sequence[Dict[str, Any]]
              ) -> Tuple[int, int, int, float]:
    """(rows, in_incident, breaches_outside, worst_outside) for one
    metric over the run's window rows; ``bad(value)`` is the breach
    predicate."""
    n = inside = breaches = 0
    worst = 0.0
    for row in rows:
        if metric not in row or "wall_time" not in row:
            continue
        n += 1
        value = float(row[metric])
        if _in_windows(float(row["wall_time"]), windows):
            inside += 1
            continue
        if bad(value):
            breaches += 1
        worst = max(worst, value) if metric.endswith("_ms") else worst
    return n, inside, breaches, worst


# -- fault evaluation --------------------------------------------------------


def _host_crash_checks(block: Any) -> Dict[str, bool]:
    """The durable-ingest judgements, derived ONLY from the host_crash
    evidence block (docs/RESILIENCE.md §Durability): ``ingest_durable``
    needs at least one kill actually delivered, zero acknowledged
    vectors lost, and the replayed gallery still answering each acked
    vector with itself (recall parity); ``ingest_no_duplicates`` is the
    exactly-once half — a replay that applied a record twice shows up
    as duplicate ids in the final index."""
    ok = isinstance(block, dict) and block.get("available") is True
    if not ok:
        return {"ingest_durable": False, "ingest_no_duplicates": False}
    try:
        durable = (int(block.get("kills", 0)) >= 1
                   and int(block.get("acked_vectors", -1)) > 0
                   and int(block.get("lost", -1)) == 0
                   and float(block.get("self_recall", 0.0)) >= 0.99)
        nodup = int(block.get("duplicates", -1)) == 0
    except (TypeError, ValueError):
        return {"ingest_durable": False, "ingest_no_duplicates": False}
    return {"ingest_durable": durable, "ingest_no_duplicates": nodup}


def _alert_events(alerts: Sequence[Dict[str, Any]], slo: str
                  ) -> Tuple[bool, bool]:
    fired = resolved = False
    for rec in alerts:
        if not isinstance(rec, dict) or rec.get("slo") != slo:
            continue
        if rec.get("state") == "firing":
            fired = True
        elif rec.get("state") == "resolved":
            resolved = True
    return fired, resolved


def _remediation_state(records: Sequence[Dict[str, Any]], policy: str
                       ) -> str:
    """Best outcome the audit shows for ``policy``: succeeded beats
    failed beats attempted beats missing (a retried action that
    eventually lands is a success story, not a failure)."""
    states = {rec.get("state") for rec in records
              if isinstance(rec, dict) and rec.get("policy") == policy}
    for best in ("succeeded", "failed", "attempted"):
        if best in states:
            return best
    return "missing"


def _observed_stage(entry: Dict[str, Any], *, windows, serve_rows,
                    qtrace: Optional[Dict[str, Any]]) -> str:
    """The ``serve.p99_attribution`` evidence for one fault: the
    qtrace dominant stage of the WORST decomposed row inside the
    fault's own alert windows (the row where the fault bit hardest) —
    or ``"reroute"`` when the artifact counted crash-reroute markers
    (a reroute is a marker, not a stage, so it has no window).  ""
    means no evidence: qtrace off, no decomposed rows, no markers."""
    if entry.get("stage") == "reroute":
        reroutes = int(((qtrace or {}).get("totals") or {})
                       .get("reroutes", 0))
        return "reroute" if reroutes > 0 else ""
    mine = [w for w in windows if w.get("slo") == entry.get("alert")]
    best, best_ms = "", -1.0
    for row in serve_rows:
        if not isinstance(row, dict) or "wall_time" not in row:
            continue
        stage = row.get("qtrace_dominant")
        ms = row.get("qtrace_dominant_ms")
        if not stage or not isinstance(ms, (int, float)):
            continue
        if not _in_windows(float(row["wall_time"]), mine):
            continue
        if ms > best_ms:
            best, best_ms = str(stage), float(ms)
    return best


def _eval_fault(entry: Dict[str, Any], *, alerts, remediation,
                observed_fires: Dict[str, int], client_errors: int,
                trainer: Dict[str, Any], windows=(), serve_rows=(),
                qtrace: Optional[Dict[str, Any]] = None,
                host_crash: Optional[Dict[str, Any]] = None
                ) -> Dict[str, Any]:
    name = entry["name"]
    kind = entry.get("kind", "failpoint")
    observed = int(observed_fires.get(name, 0))
    fired = observed > 0
    alert = entry.get("alert")
    remedy = entry.get("remediation")
    stage = entry.get("stage")
    alert_fired = alert_resolved = False
    if alert:
        alert_fired, alert_resolved = _alert_events(alerts, alert)
    state = _remediation_state(remediation, remedy) if remedy else None
    stage_observed = (_observed_stage(entry, windows=windows,
                                      serve_rows=serve_rows,
                                      qtrace=qtrace)
                      if stage else "")
    checks: Dict[str, bool] = {}
    for check in entry.get("expect") or ():
        if check == "zero_client_errors":
            checks[check] = client_errors == 0
        elif check == "preempt_exit":
            checks[check] = 75 in (trainer.get("exit_codes") or [])
        elif check == "resume":
            checks[check] = bool(trainer.get("resumed"))
        elif check in ("ingest_durable", "ingest_no_duplicates"):
            checks[check] = _host_crash_checks(host_crash)[check]
        else:
            checks[check] = False  # unknown check never passes
    ok = all(checks.values())
    if kind == "failpoint":
        ok = ok and fired
    if kind in ("failpoint", "traffic"):
        # A "traffic" entry scripts no fault site (the chaos is the
        # traffic plan's own shape, e.g. a hot-tenant burst), so its
        # whole evidence is the declared alert pair + remediation.
        if alert:
            ok = ok and alert_fired and alert_resolved
        if remedy:
            ok = ok and state == "succeeded"
    if stage:
        ok = ok and stage_observed == stage
    return {
        "name": name, "target": entry.get("target", "serve"),
        "kind": kind, "count": int(entry.get("count", 1)),
        "delay": int(entry.get("delay", 0)),
        "at_s": float(entry.get("at_s", 0.0)),
        "alert": alert, "remediation": remedy,
        "expect": list(entry.get("expect") or ()),
        "stage": stage,
        "observed_fires": observed, "fired": fired,
        "alert_fired": alert_fired, "alert_resolved": alert_resolved,
        "remediation_state": state, "stage_observed": stage_observed,
        "checks": checks, "ok": ok,
    }


# -- report assembly ---------------------------------------------------------


def build_gameday_report(
    entries: Sequence[Dict[str, Any]],
    *,
    traffic: Dict[str, Any],
    serve_alerts: Sequence[Dict[str, Any]],
    train_alerts: Sequence[Dict[str, Any]],
    serve_remediation: Sequence[Dict[str, Any]],
    train_remediation: Sequence[Dict[str, Any]],
    serve_rows: Sequence[Dict[str, Any]],
    quality_windows: Sequence[Dict[str, Any]],
    drain: Dict[str, Any],
    comms: Dict[str, Any],
    trainer: Dict[str, Any],
    observed_fires: Dict[str, int],
    client_errors: int,
    window_s: float,
    seed: int,
    p99_target_ms: float = 250.0,
    recall_floor: float = 0.95,
    pad_before_s: float = 30.0,
    pad_after_s: float = 10.0,
    min_hot_swaps: int = 3,
    qtrace: Optional[Dict[str, Any]] = None,
    host_crash: Optional[Dict[str, Any]] = None,
    tenant_hot: Optional[str] = None,
    tenant_quality: Optional[Dict[str, Sequence[Dict[str, Any]]]] = None,
) -> Dict[str, Any]:
    """Assemble (and self-judge) the report.  Inputs are plain dicts/
    lists — the runner loads the artifacts; this function only
    reconciles, so it stays importable without the package."""
    wall_times = [float(r["wall_time"])
                  for r in list(serve_rows) + list(quality_windows)
                  if isinstance(r, dict) and "wall_time" in r]
    horizon = max(wall_times) if wall_times else None
    windows = incident_windows(
        list(serve_alerts) + list(train_alerts),
        pad_before_s=pad_before_s, pad_after_s=pad_after_s,
        horizon=horizon)

    faults = [_eval_fault(
        e, alerts=(serve_alerts if e.get("target", "serve") == "serve"
                   else train_alerts),
        remediation=(serve_remediation
                     if e.get("target", "serve") == "serve"
                     else train_remediation),
        observed_fires=observed_fires, client_errors=client_errors,
        trainer=trainer, windows=windows, serve_rows=serve_rows,
        qtrace=qtrace, host_crash=host_crash) for e in entries]

    n, inside, breaches, worst = _slo_gate(
        serve_rows, "p99_ms", lambda v: v > p99_target_ms, windows)
    p99 = {"target_ms": p99_target_ms, "rows": n, "in_incident": inside,
           "breaches_outside": breaches, "worst_outside_ms": worst}
    n, inside, breaches, _ = _slo_gate(
        quality_windows, "recall_at_10", lambda v: v < recall_floor,
        windows)
    outside = [float(r["recall_at_10"]) for r in quality_windows
               if isinstance(r, dict) and "recall_at_10" in r
               and "wall_time" in r
               and not _in_windows(float(r["wall_time"]), windows)]
    recall = {"floor": recall_floor, "rows": n, "in_incident": inside,
              "breaches_outside": breaches,
              "worst_outside": min(outside) if outside else 1.0}

    dropped = drain.get("queries_dropped")
    invariant = (drain.get("queries", -1)
                 == (drain.get("answered", 0) + drain.get("errors", 0)
                     + drain.get("rejected", 0)))
    zero_drop = {
        "min_hot_swaps": min_hot_swaps,
        "hot_swaps": int(drain.get("hot_swaps", 0)),
        "queries_dropped": dropped,
        "invariant_holds": bool(invariant),
    }

    # Tenant-isolation evidence (the tenant_skew scenario): every
    # number RE-derived from the drain's per-tenant blocks, the alert
    # log and the per-tenant quality windows — never trusted from a
    # caller's claim.
    tenants_block: Dict[str, Any] = {"available": False}
    tdrain = drain.get("tenants")
    if tenant_hot is not None and isinstance(tdrain, dict):
        per: Dict[str, Any] = {}
        for tid in sorted(tdrain):
            row = tdrain[tid] if isinstance(tdrain[tid], dict) else {}
            quota_sheds = 0
            quota = row.get("quota")
            if isinstance(quota, dict):
                quota_sheds = int(quota.get("sheds", 0))
            alerted = any(
                isinstance(rec, dict) and rec.get("state") == "firing"
                and isinstance(rec.get("slo"), str)
                and rec["slo"].endswith(f"@{tid}")
                for rec in serve_alerts)
            qrows = list((tenant_quality or {}).get(tid) or ())
            outside = [
                float(r["recall_at_10"]) for r in qrows
                if isinstance(r, dict) and "recall_at_10" in r
                and "wall_time" in r
                and not _in_windows(float(r["wall_time"]), windows)]
            per[tid] = {
                "queries": int(row.get("queries", 0)),
                "answered": int(row.get("answered", 0)),
                "errors": int(row.get("errors", 0)),
                "rejected": int(row.get("rejected", 0)),
                "shed": quota_sheds + int(row.get("shed", 0)),
                "p99_ms": float(row.get("p99_ms", 0.0)),
                "alerted": alerted,
                "recall_worst": (min(outside) if outside else None),
            }
        tenants_block = {
            "available": True,
            "hot": tenant_hot,
            "p99_target_ms": float(p99_target_ms),
            "recall_floor": float(recall_floor),
            "tenants": per,
        }

    report = {
        "schema": GAMEDAY_SCHEMA,
        "window_s": float(window_s),
        "seed": int(seed),
        "traffic": {key: traffic.get(key) for key in TRAFFIC_KEYS},
        "faults": faults,
        "incidents": windows,
        "slo": {"p99": p99, "recall": recall},
        "drain": dict(drain),
        "zero_drop": zero_drop,
        "comms": dict(comms),
        "trainer": {key: trainer.get(key) for key in TRAINER_KEYS},
        "qtrace": (dict(qtrace) if isinstance(qtrace, dict)
                   else {"available": False}),
        "host_crash": (dict(host_crash) if isinstance(host_crash, dict)
                       else {"available": False}),
        "tenants": tenants_block,
        "verdict": "fail",
        "failures": [],
    }
    report["failures"] = _gate_failures(report)
    report["verdict"] = "pass" if not report["failures"] else "fail"
    return report


def _gate_failures(report: Dict[str, Any]) -> List[str]:
    """Every violated gate, by name — the verdict and the validator
    both derive from this one judgement, so they can never disagree."""
    failures: List[str] = []
    for fault in report["faults"]:
        if fault.get("ok"):
            continue
        name = fault.get("name", "?")
        if fault.get("kind") == "failpoint" and not fault.get("fired"):
            failures.append(f"fault never fired: {name}")
        elif fault.get("alert") and not (fault.get("alert_fired")
                                         and fault.get("alert_resolved")):
            failures.append(
                f"unremediated injected fault: {name} (alert "
                f"{fault.get('alert')} fired={fault.get('alert_fired')} "
                f"resolved={fault.get('alert_resolved')})")
        elif (fault.get("remediation")
              and fault.get("remediation_state") != "succeeded"):
            failures.append(
                f"unremediated injected fault: {name} (remediation "
                f"{fault.get('remediation')} state="
                f"{fault.get('remediation_state')})")
        elif (fault.get("stage")
              and fault.get("stage_observed") != fault.get("stage")):
            failures.append(
                f"p99 attribution mismatch: {name} declared stage "
                f"{fault.get('stage')!r}, evidence showed "
                f"{fault.get('stage_observed') or 'nothing'!r}")
        else:
            bad = [c for c, ok in (fault.get("checks") or {}).items()
                   if not ok]
            failures.append(f"fault check failed: {name} ({bad})")
    # Durable-ingest checks are RECOMPUTED from the host_crash evidence
    # block, never trusted from the stored fault row — a report whose
    # SIGKILL fault claims ingest_durable over evidence showing acked
    # loss (or no evidence at all) is refused here, which is the same
    # gate validate_gameday_report re-derives.
    hc: Optional[Dict[str, bool]] = None
    for fault in report["faults"]:
        ingest_checks = [c for c in (fault.get("expect") or ())
                         if c in ("ingest_durable", "ingest_no_duplicates")]
        if not ingest_checks:
            continue
        if hc is None:
            hc = _host_crash_checks(report.get("host_crash"))
        for check in ingest_checks:
            if not hc[check]:
                failures.append(
                    f"host-crash evidence refutes {fault.get('name', '?')}"
                    f": {check} recomputed false from the host_crash "
                    f"block")
    p99 = report["slo"]["p99"]
    if p99["breaches_outside"]:
        failures.append(
            f"p99 breached outside incident windows: "
            f"{p99['breaches_outside']} row(s), worst "
            f"{p99['worst_outside_ms']:.1f}ms > {p99['target_ms']}ms")
    recall = report["slo"]["recall"]
    if recall["breaches_outside"]:
        failures.append(
            f"recall breached outside incident windows: "
            f"{recall['breaches_outside']} row(s), worst "
            f"{recall['worst_outside']:.3f} < {recall['floor']}")
    zero = report["zero_drop"]
    if zero["queries_dropped"] is None:
        failures.append(
            "queries_dropped missing from the drain summary (the tier "
            "must run with explicit drops on — zero is evidence)")
    elif zero["queries_dropped"] != 0:
        failures.append(
            f"dropped queries: {zero['queries_dropped']}")
    if not zero["invariant_holds"]:
        failures.append("drain invariant violated "
                        "(queries != answered + errors + rejected)")
    if zero["hot_swaps"] < zero["min_hot_swaps"]:
        failures.append(
            f"too few hot-swaps: {zero['hot_swaps']} < "
            f"{zero['min_hot_swaps']}")
    comms = report["comms"]
    if comms.get("available") and comms.get("unattributed_bytes", 0) != 0:
        failures.append(
            f"unattributed comms bytes: {comms.get('unattributed_bytes')}")
    # Tenant isolation (the tenant_skew scenario): the NOISY tenant
    # must have been shed AND paged with a tenant-scoped alert, while
    # every OTHER tenant kept zero errors, zero rejects, its p99 under
    # the target, and (when shadow-scored) its recall over the floor —
    # a hot neighbor that degrades the quiet tenants fails the gameday
    # even if every tier-wide gate above held.
    tb = report.get("tenants") or {}
    if isinstance(tb, dict) and tb.get("available"):
        hot = tb.get("hot")
        target = float(tb.get("p99_target_ms", 0.0) or 0.0)
        floor = tb.get("recall_floor")
        per = tb.get("tenants") if isinstance(tb.get("tenants"), dict) \
            else {}
        hot_row = per.get(hot)
        if not isinstance(hot_row, dict):
            failures.append(
                f"tenant skew: hot tenant {hot!r} missing from the "
                "drain's per-tenant evidence")
        else:
            if (int(hot_row.get("rejected", 0)) <= 0
                    and int(hot_row.get("shed", 0)) <= 0):
                failures.append(
                    f"tenant skew: noisy tenant {hot!r} was never "
                    "shed — isolation unproven")
            if not hot_row.get("alerted"):
                failures.append(
                    f"tenant skew: no tenant-scoped alert "
                    f"(...@{hot}) ever fired for the noisy tenant")
        for tid in sorted(per):
            row = per[tid]
            if tid == hot or not isinstance(row, dict):
                continue
            if int(row.get("errors", 0)) != 0:
                failures.append(
                    f"tenant isolation: {tid!r} saw "
                    f"{row.get('errors')} error(s) during the "
                    "hot-tenant burst")
            if int(row.get("rejected", 0)) != 0:
                failures.append(
                    f"tenant isolation: {tid!r} had "
                    f"{row.get('rejected')} rejected quer(ies) — the "
                    "noisy neighbor's shed leaked")
            if target and float(row.get("p99_ms", 0.0)) > target:
                failures.append(
                    f"tenant isolation: {tid!r} p99 "
                    f"{row.get('p99_ms')}ms > {target}ms")
            worst = row.get("recall_worst")
            if (floor is not None and worst is not None
                    and float(worst) < float(floor)):
                failures.append(
                    f"tenant isolation: {tid!r} recall {worst} < "
                    f"floor {floor}")
    return failures


# -- the contract ------------------------------------------------------------


def validate_gameday_report(obj: Any) -> Optional[str]:
    """None when ``obj`` is a passing ``npairloss-gameday-v1`` report;
    else the first violation.  The gate recomputes every judgement from
    the report's own evidence — a tampered ``verdict: "pass"`` over
    failing blocks is refused, and so is a failing verdict."""
    if not isinstance(obj, dict):
        return f"report must be an object, got {type(obj).__name__}"
    if obj.get("schema") != GAMEDAY_SCHEMA:
        return (f"schema must be {GAMEDAY_SCHEMA!r}, "
                f"got {obj.get('schema')!r}")
    for key in REPORT_KEYS:
        if key not in obj:
            return f"missing key: {key}"
    if obj.get("verdict") not in VERDICTS:
        return f"verdict must be one of {VERDICTS}, got {obj.get('verdict')!r}"
    for block, keys in (("traffic", TRAFFIC_KEYS),
                        ("zero_drop", ZERO_DROP_KEYS),
                        ("trainer", TRAINER_KEYS)):
        if not isinstance(obj[block], dict):
            return f"{block} must be an object"
        for key in keys:
            if key not in obj[block]:
                return f"{block} missing key: {key}"
    slo = obj["slo"]
    if not isinstance(slo, dict) or "p99" not in slo or "recall" not in slo:
        return "slo must carry p99 and recall blocks"
    for block, keys in (("p99", P99_KEYS), ("recall", RECALL_KEYS)):
        for key in keys:
            if key not in slo[block]:
                return f"slo.{block} missing key: {key}"
    if not isinstance(obj["faults"], list) or not obj["faults"]:
        return "faults must be a non-empty list (a gameday with no "\
               "injected faults proved nothing)"
    for i, fault in enumerate(obj["faults"]):
        if not isinstance(fault, dict):
            return f"faults[{i}] must be an object"
        for key in FAULT_KEYS:
            if key not in fault:
                return f"faults[{i}] missing key: {key}"
    if not isinstance(obj["incidents"], list):
        return "incidents must be a list"
    if not isinstance(obj["failures"], list):
        return "failures must be a list"
    if not isinstance(obj["qtrace"], dict):
        return "qtrace must be an object (the summarized qtrace "\
               "evidence, or {\"available\": false})"
    hc = obj["host_crash"]
    if not isinstance(hc, dict):
        return "host_crash must be an object (the durable-ingest "\
               "evidence, or {\"available\": false})"
    if hc.get("available"):
        for key in HOST_CRASH_KEYS:
            if key not in hc:
                return f"host_crash missing key: {key}"
    # "tenants" is optional (pre-multi-tenant reports lack it) but when
    # present and available its shape must be complete — the per-tenant
    # isolation gates below read it blind.
    tb = obj.get("tenants")
    if tb is not None:
        if not isinstance(tb, dict):
            return "tenants must be an object (the per-tenant "\
                   "isolation evidence, or {\"available\": false})"
        if tb.get("available"):
            for key in TENANT_GATE_KEYS:
                if key not in tb:
                    return f"tenants missing key: {key}"
            per = tb["tenants"]
            if not isinstance(per, dict) or not per:
                return "tenants.tenants must be a non-empty object "\
                       "keyed by tenant id"
            if tb["hot"] not in per:
                return (f"tenants.hot {tb['hot']!r} is not one of the "
                        "evidenced tenants")
            for tid, row in per.items():
                if not isinstance(row, dict):
                    return f"tenants.tenants[{tid!r}] must be an object"
                for key in TENANT_ROW_KEYS:
                    if key not in row:
                        return (f"tenants.tenants[{tid!r}] missing "
                                f"key: {key}")

    # Recompute the gates from the evidence; the stored verdict and
    # failures must agree with them.
    failures = _gate_failures(obj)
    if failures:
        return f"gameday gate failed: {failures[0]}" \
            + (f" (+{len(failures) - 1} more)" if len(failures) > 1
               else "")
    if obj["verdict"] != "pass":
        return ("every gate holds but verdict says "
                f"{obj['verdict']!r} — inconsistent report")
    if obj["failures"]:
        return ("verdict is pass but failures is non-empty: "
                f"{obj['failures'][0]}")
    return None


def load_gameday_report(path: str) -> Dict[str, Any]:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)
