"""``watch RUNDIR`` — the offline feed of the ONE SLO engine.  Port of
``npairloss_tpu/obs/live/watch.py``.

A live process evaluates SLOs over rows as they are emitted; ``watch``
evaluates the SAME specs over the rows a run directory already holds
(and, with ``follow=True``, keeps tailing as ranks append) — one
evaluator, two feeds.  Replay is deterministic: each record's own
``wall_time`` drives the evaluation clock, so re-running watch over the
same stream produces the same alert sequence the in-process engine
would have produced from those rows (pinned by
tests/test_torch_live.py).

Reads both telemetry layouts: the legacy ``metrics.jsonl`` and the
fleet observatory's rank-suffixed ``telemetry.r<k>.jsonl`` files —
per-rank streams merge by ``wall_time`` so the fleet straggler watchdog
sees the interleaved frontier.  Torn tail lines (a rank mid-write) are
skipped, never fatal — the fleet aggregator's contract.

Device-free: watch must run on the box where the artifacts are,
whether or not a card is there.
"""

from __future__ import annotations

import glob
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from npairloss_tpu_torch.obs.live.live import LiveObservatory
from npairloss_tpu_torch.obs.live.slo import SLOSpec

WATCH_ALERTS_FILENAME = "alerts.watch.jsonl"
REMEDIATION_FILENAME = "remediation.jsonl"
QUALITY_FILENAME = "quality.jsonl"


def reconcile_remediation(
    rem_records: Sequence[Dict[str, Any]],
    alert_events: Sequence[Dict[str, Any]],
) -> Dict[str, Any]:
    """Join one run's remediation audit against an alert-event stream
    (the watch replay's, or the live log's): every resolved alert of an
    SLO some policy ACTS ON should have an action, and every action's
    alert should eventually resolve.  Both mismatch directions are
    reported — ``alert_resolved_no_action`` (the alert healed on its
    own, or the actuator missed it) and ``action_no_resolution`` (the
    action ran but the incident never stood down) — as evidence for the
    operator, not a gate."""
    # Dry-run attempts are rehearsals, not actions: they still mark
    # their SLO as policy-covered (so resolved-with-no-action reporting
    # works in a dry run) but must never read as "the actuator resolved
    # this incident".
    acted = {str(r.get("alert_id")) for r in rem_records
             if isinstance(r, dict) and not r.get("dry_run")}
    policy_slos = {r.get("slo") for r in rem_records
                   if isinstance(r, dict)}
    fired = {e["alert_id"]: e["slo"] for e in alert_events
             if e.get("state") == "firing"}
    resolved = {e["alert_id"] for e in alert_events
                if e.get("state") == "resolved"}
    return {
        "records": len(rem_records),
        "matched": sorted(acted & resolved),
        "alert_resolved_no_action": sorted(
            aid for aid, slo in fired.items()
            if aid in resolved and slo in policy_slos
            and aid not in acted),
        "action_no_resolution": sorted(acted - resolved),
    }


def telemetry_paths(run_dir: str) -> List[str]:
    """The run dir's metric streams: legacy + rank-suffixed layouts."""
    paths = []
    legacy = os.path.join(run_dir, "metrics.jsonl")
    if os.path.exists(legacy):
        paths.append(legacy)
    paths.extend(sorted(glob.glob(
        os.path.join(run_dir, "telemetry.r*.jsonl"))))
    return paths


class _Tail:
    """Byte-offset tailer for one JSONL stream: each poll returns the
    newly-completed lines; a torn final line stays buffered until its
    newline arrives (counted, never parsed half-written)."""

    def __init__(self, path: str):
        self.path = path
        self.offset = 0
        self.torn = 0

    def poll(self) -> List[Dict[str, Any]]:
        try:
            with open(self.path, "rb") as f:
                f.seek(self.offset)
                chunk = f.read()
        except OSError:
            return []
        if not chunk:
            return []
        # Only consume up to the last newline: the tail beyond it is a
        # line still being written.
        cut = chunk.rfind(b"\n")
        if cut < 0:
            return []
        self.offset += cut + 1
        records = []
        for line in chunk[:cut + 1].splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line.decode("utf-8", "replace")))
            except ValueError:
                self.torn += 1
        return records


def replay_records(
    records: Sequence[Dict[str, Any]],
    specs: Sequence[SLOSpec],
    out_path: Optional[str] = None,
    min_ticks: int = 1,
) -> Tuple[LiveObservatory, List[Dict[str, Any]]]:
    """Deterministic offline evaluation: feed ``records`` (already
    merged, ``wall_time``-ascending) through a fresh observatory,
    ticking at every record's own wall_time.  Returns the observatory
    and the full alert-event list — the function BOTH ``watch`` and the
    in-process-agreement test call, so the two feeds cannot drift."""
    obs = LiveObservatory(specs, out_dir=None, min_ticks=min_ticks)
    if out_path:
        from npairloss_tpu_torch.obs.live.alerts import AlertEngine

        obs.alerts = AlertEngine(out_path, min_ticks=min_ticks)
    events: List[Dict[str, Any]] = []
    for rec in records:
        obs.sink.log(rec)
        t = rec.get("wall_time")
        if isinstance(t, (int, float)):
            events.extend(obs.tick(now=float(t)))
    return obs, events


def watch_run_dir(
    run_dir: str,
    specs: Sequence[SLOSpec],
    follow: bool = False,
    poll_s: float = 1.0,
    out_path: Optional[str] = None,
    emit=None,
    stop_after_s: Optional[float] = None,
) -> Dict[str, Any]:
    """Evaluate ``specs`` over a run directory's telemetry.

    One-shot (``follow=False``): replay everything on disk, return the
    summary.  Follow mode: keep tailing all streams, ticking each new
    record at its wall_time, until ``stop_after_s`` (None = until
    interrupted).  ``emit`` (callable) receives each alert event as it
    happens — the CLI prints them.  Alert events land in ``out_path``
    (default ``<run_dir>/alerts.watch.jsonl`` — NOT alerts.jsonl, so
    watching a live run never interleaves with the in-process engine's
    own log).
    """
    run_dir = os.path.abspath(run_dir)
    paths = telemetry_paths(run_dir)
    if not paths:
        raise FileNotFoundError(
            f"{run_dir}: no metrics.jsonl or telemetry.r*.jsonl stream")
    if out_path is None:
        out_path = os.path.join(run_dir, WATCH_ALERTS_FILENAME)
    obs = LiveObservatory(specs, out_dir=None)
    from npairloss_tpu_torch.obs.live.alerts import AlertEngine

    obs.alerts = AlertEngine(out_path)
    tails = [_Tail(p) for p in paths]
    rows = 0
    last_t: List[Optional[float]] = [None]
    events: List[Dict[str, Any]] = []

    def drain_once() -> int:
        nonlocal rows
        fresh: List[Dict[str, Any]] = []
        for tail in tails:
            fresh.extend(tail.poll())
        fresh.sort(key=lambda r: r.get("wall_time", 0))
        for rec in fresh:
            obs.sink.log(rec)
            t = rec.get("wall_time")
            if isinstance(t, (int, float)):
                last_t[0] = float(t)
                for ev in obs.tick(now=float(t)):
                    events.append(ev)
                    if emit is not None:
                        emit(ev)
        rows += len(fresh)
        return len(fresh)

    t0 = time.time()
    drain_once()
    while follow:
        if stop_after_s is not None and time.time() - t0 >= stop_after_s:
            break
        time.sleep(poll_s)
        drain_once()
    obs.alerts.close()
    active = obs.alerts.active()
    remediation: Optional[Dict[str, Any]] = None
    rem_path = os.path.join(run_dir, REMEDIATION_FILENAME)
    if os.path.exists(rem_path):
        # The run remediated: validate its audit log and reconcile it
        # against the alert lifecycle the replay just reproduced — a
        # resolved alert with no action and an action with no
        # resolution are both reported.
        from npairloss_tpu_torch.resilience import remediate as rem

        rem_records = rem.load_remediation_log(rem_path)
        err = rem.validate_remediation_log(rem_records)
        remediation = {
            "log": rem_path,
            "valid": err is None,
            **({"error": err} if err else {}),
            **reconcile_remediation(rem_records, events),
        }
    quality: Optional[Dict[str, Any]] = None
    q_path = os.path.join(run_dir, QUALITY_FILENAME)
    if os.path.exists(q_path):
        # The run shadow-scored: validate the npairloss-quality-v1 log
        # and surface the aggregate recall view next to the replayed
        # alert lifecycle — the recall-floor firing the replay just
        # reproduced and the windows that caused it read side by side.
        from npairloss_tpu_torch.obs.quality import report as qmod

        q_records = qmod.load_quality_report(q_path)
        qerr = qmod.validate_quality_report(q_records)
        quality = {
            "log": q_path,
            "valid": qerr is None,
            **({"error": qerr} if qerr
               else qmod.quality_summary(q_records)),
        }
    return {
        "run_dir": run_dir,
        "streams": paths,
        "rows": rows,
        "torn_lines": sum(t.torn for t in tails),
        "alerts_log": out_path,
        "events": len(events),
        "alerts_active": len(active),
        "active": active,
        # Status as of the LAST ingested record's wall time — a replay
        # of a long-finished run evaluated at real now would see an
        # empty window and print every SLO as ok right next to an
        # active alert in the same summary.
        "slo": obs.evaluator.status_dict(last_t[0]),
        # Remediation reconciliation only when the run remediated, and
        # the quality view only when it shadow-scored (the absent-key
        # contract: no log, no block).
        **({"remediation": remediation}
           if remediation is not None else {}),
        **({"quality": quality} if quality is not None else {}),
    }
