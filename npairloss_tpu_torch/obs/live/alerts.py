"""Alert engine + the versioned ``npairloss-alerts-v1`` JSONL contract.
Port of ``npairloss_tpu/obs/live/alerts.py`` (a copy: the same records,
key for key, so either package's ``validate_alert_log`` accepts the
other's logs).

The engine sits between the SLO evaluator and the on-disk alert log:
each evaluation tick hands it the current :class:`slo.SLOStatus` list;
it owns the firing→resolved lifecycle:

  * a spec that starts burning opens ONE alert (dedup: at most one
    active alert per SLO name — a spec burning for an hour is one
    incident, not 3600);
  * flap suppression is two-layered: the evaluator's
    burn/clear-threshold hysteresis (slo.py) plus this engine's
    ``min_ticks`` debounce — the burn state must hold for N consecutive
    ticks before the transition is believed;
  * every transition appends one JSONL record, so the log is an
    event-sourced history any process can audit.

``validate_alert_log`` IS the contract, like the perf, fleet and
quality validators: consumers rely on every key it checks.  Stdlib only
and self-contained (no intra-package imports), so a process without
torch can load it by file path.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

ALERTS_SCHEMA = "npairloss-alerts-v1"
ALERT_STATES = ("firing", "resolved")
# Twin of slo.SEVERITIES — spelled out here (not imported) because this
# module is loaded by file path; the twin is pinned equal by
# tests/test_torch_live.py.
ALERT_SEVERITIES = ("info", "warning", "critical")

# Record keys every alert event carries (pinned by
# tests/test_torch_live.py against the JAX package's).
EVENT_KEYS = (
    "schema", "alert_id", "slo", "metric", "severity", "state", "ts",
    "fired_at", "bad_fraction", "samples", "target", "op", "message",
)


class Alert:
    """One open (or closed) incident for one SLO."""

    def __init__(self, alert_id: str, status, fired_at: float):
        self.alert_id = alert_id
        self.spec = status.spec
        self.fired_at = fired_at
        self.resolved_at: Optional[float] = None
        self.last_status = status

    @property
    def active(self) -> bool:
        return self.resolved_at is None


class AlertEngine:
    """Consume SLO statuses, emit lifecycle events, persist JSONL.

    ``log_path=None`` keeps the history in memory only (tests, the
    /healthz payload); with a path every event is appended
    line-buffered, so a killed process loses at most the current line
    (the telemetry-sink durability contract).  ``min_ticks`` is the
    debounce: a state transition must be observed on N CONSECUTIVE
    ticks before it is believed (1 = trust the evaluator's hysteresis
    alone).  Thread-safe: the serve HTTP handler reads ``active()``
    while the evaluator thread ticks.
    """

    def __init__(self, log_path: Optional[str] = None, min_ticks: int = 1,
                 clock=time.time):
        if min_ticks < 1:
            raise ValueError(f"min_ticks must be >= 1, got {min_ticks}")
        self.log_path = os.path.abspath(log_path) if log_path else None
        self.min_ticks = int(min_ticks)
        self._clock = clock
        self._lock = threading.Lock()
        self._active: Dict[str, Alert] = {}
        self._streaks: Dict[str, int] = {}  # consecutive ticks in new state
        self._seq = 0
        # Alerts a PREVIOUS process segment left open in the log we are
        # appending to: {slo: (alert_id, fired_at, severity)}.  The
        # resumed engine adopts them — still-burning SLOs keep the old
        # incident's id (no duplicate firing event), recovered ones get
        # their resolve under the original id — so a preempt-and-resume
        # run (the supported resilience flow) still writes ONE
        # validator-clean lifecycle per incident.
        self._inherited: Dict[str, Tuple[str, float, str]] = {}
        self.history: List[Dict[str, Any]] = []
        self._f = None
        if self.log_path:
            parent = os.path.dirname(self.log_path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            self._resume_from_log(self.log_path)
            self._f = open(self.log_path, "a", buffering=1)

    def _resume_from_log(self, path: str) -> None:
        """Seed ``_seq`` past every id a previous segment used and
        collect its still-open alerts for adoption.  Best-effort: an
        unreadable or foreign log just starts fresh (the validator
        will say so downstream)."""
        try:
            records = load_alert_log(path)
        except OSError:
            return
        for rec in records:
            if not isinstance(rec, dict) or "alert_id" not in rec:
                continue
            _, _, tail = str(rec["alert_id"]).rpartition("-")
            if tail.isdigit():
                self._seq = max(self._seq, int(tail))
            if rec.get("state") == "firing":
                self._inherited[rec.get("slo")] = (
                    rec["alert_id"], float(rec.get("fired_at", 0.0)),
                    rec.get("severity", "warning"))
            elif rec.get("state") == "resolved":
                self._inherited.pop(rec.get("slo"), None)

    # -- lifecycle ---------------------------------------------------------

    def update(self, statuses: Sequence, now: Optional[float] = None
               ) -> List[Dict[str, Any]]:
        """One evaluation tick; returns the events it emitted."""
        now = self._clock() if now is None else float(now)
        events: List[Dict[str, Any]] = []
        with self._lock:
            for status in statuses:
                name = status.spec.name
                if name in self._inherited:
                    # First sight of an SLO a previous segment left
                    # firing: adopt the open incident (original id and
                    # fired_at) instead of opening a duplicate.
                    aid, fired_at, _sev = self._inherited.pop(name)
                    adopted = Alert(aid, status, fired_at)
                    self._active[name] = adopted
                    self._streaks[name] = 0
                    if not status.burning:
                        events.append(self._close(adopted, status, now))
                    continue
                alert = self._active.get(name)
                if status.burning and alert is None:
                    streak = self._streaks.get(name, 0) + 1
                    self._streaks[name] = streak
                    if streak >= self.min_ticks:
                        self._streaks[name] = 0
                        events.append(self._open(status, now))
                elif not status.burning and alert is not None:
                    streak = self._streaks.get(name, 0) + 1
                    self._streaks[name] = streak
                    if streak >= self.min_ticks:
                        self._streaks[name] = 0
                        events.append(self._close(alert, status, now))
                else:
                    # State agrees with the ledger: reset the debounce
                    # (the transition evidence was not consecutive).
                    self._streaks[name] = 0
                    if alert is not None:
                        alert.last_status = status
        return events

    def _open(self, status, now: float) -> Dict[str, Any]:
        self._seq += 1
        alert = Alert(f"{status.spec.name}-{self._seq}", status, now)
        self._active[status.spec.name] = alert
        return self._emit(alert, status, "firing", now)

    def _close(self, alert: Alert, status, now: float) -> Dict[str, Any]:
        alert.resolved_at = now
        del self._active[alert.spec.name]
        return self._emit(alert, status, "resolved", now)

    def _emit(self, alert: Alert, status, state: str, now: float
              ) -> Dict[str, Any]:
        spec = alert.spec
        verb = "burning" if state == "firing" else "recovered"
        event: Dict[str, Any] = {
            "schema": ALERTS_SCHEMA,
            "alert_id": alert.alert_id,
            "slo": spec.name,
            "metric": spec.metric,
            "severity": spec.severity,
            "state": state,
            "ts": now,
            "fired_at": alert.fired_at,
            "bad_fraction": round(status.bad_fraction, 4),
            "samples": status.samples,
            "target": spec.target,
            "op": spec.op,
            "message": (
                f"{spec.name}: {spec.metric} {verb} — "
                f"{status.bad_fraction:.0%} of {status.samples} sample(s) "
                f"in {spec.window_s:g}s violate {spec.op} {spec.target:g}"
                + (f" (worst {status.worst:g})"
                   if status.worst is not None else "")
            ),
        }
        if state == "resolved":
            event["resolved_at"] = alert.resolved_at
            event["duration_s"] = round(alert.resolved_at - alert.fired_at, 3)
        self.history.append(event)
        if self._f is not None and not self._f.closed:
            self._f.write(json.dumps(event) + "\n")
        return event

    # -- reads -------------------------------------------------------------

    def active(self) -> Dict[str, Dict[str, Any]]:
        """{slo name: summary} of currently-firing alerts (the /healthz
        payload)."""
        with self._lock:
            return {
                name: {
                    "alert_id": a.alert_id,
                    "severity": a.spec.severity,
                    "fired_at": a.fired_at,
                    "bad_fraction": round(
                        a.last_status.bad_fraction, 4),
                }
                for name, a in self._active.items()
            }

    def close(self) -> None:
        with self._lock:
            if self._f is not None and not self._f.closed:
                self._f.close()


# -- the npairloss-alerts-v1 contract ----------------------------------------


def load_alert_log(path: str) -> List[Dict[str, Any]]:
    """Read one alert JSONL file; a torn final line (killed writer) is
    tolerated, any OTHER unparseable line is a contract violation
    surfaced by :func:`validate_alert_log` via a sentinel record."""
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


def validate_alert_log(records: Sequence[Any]) -> Optional[str]:
    """Schema + lifecycle check; returns an error string or None.

    The contract: every record carries :data:`EVENT_KEYS` with the
    schema tag, a known state/severity, numeric timestamps; per
    alert_id the lifecycle is firing then (optionally) resolved —
    never a resolve without its firing, never two firings, and
    ``fired_at <= resolved_at``; at most one ACTIVE (unresolved) alert
    per SLO name at any point in the stream (the dedup promise).
    """
    open_by_slo: Dict[str, str] = {}
    seen_states: Dict[str, List[str]] = {}
    fired_at: Dict[str, float] = {}
    for i, rec in enumerate(records):
        if not isinstance(rec, dict):
            return f"record {i} is not an object"
        if "_bad_line" in rec:
            return f"unparseable JSON on line {rec['_bad_line']}"
        if rec.get("schema") != ALERTS_SCHEMA:
            return (f"record {i}: schema must be {ALERTS_SCHEMA!r}, "
                    f"got {rec.get('schema')!r}")
        for key in EVENT_KEYS:
            if key not in rec:
                return f"record {i} missing {key!r}"
        if rec["state"] not in ALERT_STATES:
            return (f"record {i}: state {rec['state']!r} not in "
                    f"{ALERT_STATES}")
        if rec["severity"] not in ALERT_SEVERITIES:
            return (f"record {i}: severity {rec['severity']!r} not in "
                    f"{ALERT_SEVERITIES}")
        for key in ("ts", "fired_at", "bad_fraction"):
            if not isinstance(rec[key], (int, float)):
                return f"record {i}: {key} is not numeric"
        aid, slo, state = rec["alert_id"], rec["slo"], rec["state"]
        states = seen_states.setdefault(aid, [])
        if state == "firing":
            if states:
                return f"record {i}: duplicate firing for alert {aid!r}"
            if slo in open_by_slo:
                return (f"record {i}: alert {aid!r} fired while "
                        f"{open_by_slo[slo]!r} is still active for SLO "
                        f"{slo!r} (dedup violated)")
            open_by_slo[slo] = aid
            fired_at[aid] = float(rec["fired_at"])
        else:
            if states != ["firing"]:
                # covers both a resolve with no firing and a SECOND
                # resolve for one incident — the lifecycle is exactly
                # firing then at most one resolved per alert_id
                return (f"record {i}: resolved alert {aid!r} has "
                        f"lifecycle {states + [state]}, expected "
                        "['firing', 'resolved']")
            if "resolved_at" not in rec or not isinstance(
                    rec["resolved_at"], (int, float)):
                return f"record {i}: resolved event missing resolved_at"
            if rec["resolved_at"] < fired_at.get(aid, float("inf")):
                return (f"record {i}: alert {aid!r} resolved_at "
                        f"{rec['resolved_at']} precedes fired_at")
            if open_by_slo.get(slo) == aid:
                del open_by_slo[slo]
        states.append(state)
    return None


def unresolved_alerts(records: Sequence[Dict[str, Any]]
                      ) -> List[Tuple[str, str, str]]:
    """(alert_id, slo, severity) of alerts still firing at end of log
    — what a gate refuses when any severity is ``critical``.  Call only on a log :func:`validate_alert_log`
    accepted."""
    open_alerts: Dict[str, Tuple[str, str, str]] = {}
    for rec in records:
        if rec["state"] == "firing":
            open_alerts[rec["alert_id"]] = (
                rec["alert_id"], rec["slo"], rec["severity"])
        else:
            open_alerts.pop(rec["alert_id"], None)
    return list(open_alerts.values())
