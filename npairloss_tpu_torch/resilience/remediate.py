"""Alert→actuation: declarative remediation policies over the live alerts.

Port of ``npairloss_tpu/resilience/remediate.py`` (a copy: the same
policies, records and validators, key for key, so either package's
``validate_remediation_log`` accepts the other's logs).

The observability stack measures (SLO burn, alerts); this module ACTS:
a :class:`RemediationPolicy` table binds SLO alert ids from the live
``AlertEngine`` to guarded actions — hot-swap the serving snapshot on a
staleness alert, engage load-shedding on queue saturation, request a
trainer rollback on embedding collapse, re-warm on a post-warmup
compile storm.  Each action is rate-limited by a per-policy
``cooldown_s``, bounded by ``max_attempts`` per incident, and supports
a global dry-run mode that logs what WOULD run without acting.

The lifecycle of one attempt, and the versioned audit contract
(``npairloss-remediation-v1``, ``remediation.jsonl``):

  * an alert for a policy's SLO is active and the budgets allow →
    an ``attempted`` record is appended BEFORE the action runs (a
    crash mid-action still leaves the attempt on disk);
  * the action raising fails the attempt immediately (``failed`` with
    the error);
  * otherwise the attempt stays OUTSTANDING until the triggering alert
    RESOLVES — alert resolution after the action is the one success
    signal (``succeeded``); an alert still firing a full cooldown after
    the action marks the attempt ``failed`` and (budget permitting)
    opens the next one;
  * budget exhausted with the alert still firing → the outstanding
    attempt is ``failed`` and the incident is left to the pager.

``validate_remediation_log`` IS the contract, exactly like
``validate_alert_log``: per id the lifecycle is ``attempted`` then at
most one of ``succeeded``/``failed`` (a dry-run attempt never gets an
outcome — it never acted, so it cannot have one), and with the paired
alert log every record must point at an alert that actually FIRED
before it — an action without a firing alert is refused.  Stdlib only
and self-contained (no intra-package imports), so a process without
torch can load it by file path.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from typing import (
    Any,
    Callable,
    Dict,
    List,
    Mapping,
    Optional,
    Sequence,
    Tuple,
)

log = logging.getLogger("npairloss_tpu_torch.resilience")

REMEDIATION_SCHEMA = "npairloss-remediation-v1"
REMEDIATION_STATES = ("attempted", "succeeded", "failed")
# Twin of alerts.ALERT_SEVERITIES — spelled out, not imported (the
# file-path-load contract); pinned equal by tests/test_torch_remediate.py.
REMEDIATION_SEVERITIES = ("info", "warning", "critical")

# Record keys every audit event carries (pinned by
# tests/test_torch_remediate.py against the JAX package's).
EVENT_KEYS = (
    "schema", "id", "policy", "action", "alert_id", "slo", "severity",
    "state", "ts", "attempt", "max_attempts", "dry_run", "message",
)


@dataclasses.dataclass(frozen=True)
class RemediationPolicy:
    """One binding: alerts of SLO ``slo`` trigger action ``action``.

    ``cooldown_s`` rate-limits the policy (minimum wall seconds between
    consecutive attempts, across incidents — an action that takes
    effect slowly must not be hammered); ``max_attempts`` bounds the
    attempts per INCIDENT (per alert_id — a new incident gets a fresh
    budget); past the budget the policy stands down and the alert is
    the pager's problem, not the actuator's.
    """

    name: str
    slo: str
    action: str
    cooldown_s: float = 30.0
    max_attempts: int = 3
    description: str = ""

    def __post_init__(self):
        for field in ("name", "slo", "action"):
            v = getattr(self, field)
            if not v or not isinstance(v, str):
                raise ValueError(
                    f"policy {self.name!r}: {field} must be a non-empty "
                    f"string, got {v!r}")
        if self.cooldown_s < 0:
            raise ValueError(
                f"policy {self.name!r}: cooldown_s must be >= 0, "
                f"got {self.cooldown_s}")
        if self.max_attempts < 1:
            raise ValueError(
                f"policy {self.name!r}: max_attempts must be >= 1, "
                f"got {self.max_attempts}")


class _Pending:
    """One outstanding (acted, not yet concluded) attempt."""

    __slots__ = ("rec_id", "policy", "alert", "attempt", "ts", "detail")

    def __init__(self, rec_id, policy, alert, attempt, ts, detail):
        self.rec_id = rec_id
        self.policy = policy
        self.alert = alert
        self.attempt = attempt
        self.ts = ts
        self.detail = detail


class RemediationEngine:
    """Consume the alert engine's active set, run guarded actions,
    append the audit log.

    ``actions`` maps action names to callables ``fn(alert_info) ->
    Optional[dict]`` (the detail lands on the success record), or
    ``(fn, undo_fn)`` pairs — ``undo_fn`` runs when the incident
    resolves (the load-shed release).  Every policy's action must be
    registered — a policy that can never act is a config error, not a
    silent no-op.  ``tick(active, now)`` is driven by the
    ``LiveObservatory`` AFTER its alert update, with the same ``now``,
    so actuation and the pager can never disagree about the alert
    state; actions run ON the tick thread (evaluation pauses while a
    hot-swap warms — bounded by the action, documented).

    ``dry_run`` logs every attempt (budgets included, so a rehearsal
    exercises the rate limits) but never calls an action.
    """

    def __init__(
        self,
        policies: Sequence[RemediationPolicy],
        actions: Mapping[str, Any],
        log_path: Optional[str] = None,
        dry_run: bool = False,
        clock=time.time,
    ):
        names = [p.name for p in policies]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate policy names: {names}")
        self.policies = list(policies)
        self._actions: Dict[str, Tuple[Callable, Optional[Callable]]] = {}
        for key, value in actions.items():
            if isinstance(value, tuple):
                fn, undo = value
            else:
                fn, undo = value, None
            self._actions[key] = (fn, undo)
        missing = sorted(
            {p.action for p in self.policies} - set(self._actions))
        if missing:
            raise ValueError(
                f"policies reference unregistered actions {missing} "
                f"(registered: {sorted(self._actions)})")
        self.dry_run = bool(dry_run)
        self._clock = clock
        # The tick runs on the evaluator thread while /healthz scrapes
        # read last_by_policy: every mutation of the state below holds
        # the lock.
        self._lock = threading.Lock()
        self._seq = 0  # guarded-by: _lock
        self._last_attempt_ts: Dict[str, float] = {}  # guarded-by: _lock
        self._attempts: Dict[Tuple[str, str], int] = {}  # guarded-by: _lock
        self._pending: Dict[str, _Pending] = {}  # guarded-by: _lock
        self._last: Dict[str, Dict[str, Any]] = {}  # guarded-by: _lock
        # Outstanding UNDOs, tracked separately from pendings: an undo
        # must run when its incident resolves even if the attempt that
        # engaged it was long marked failed (a forced load-shed whose
        # budget exhausted must still be RELEASED when the alert
        # clears — an actuator that can engage but not disengage is
        # worse than no actuator).
        self._undos: Dict[str, Tuple[Callable, Dict[str, Any]]] = {}  # guarded-by: _lock
        self.history: List[Dict[str, Any]] = []  # guarded-by: _lock
        self.log_path = os.path.abspath(log_path) if log_path else None
        self._f = None
        if self.log_path:
            parent = os.path.dirname(self.log_path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            self._resume_seq(self.log_path)
            self._f = open(self.log_path, "a", buffering=1)

    def _resume_seq(self, path: str) -> None:
        """Seed ``_seq`` past every id an appended-to log already used
        so a resumed run never collides ids.  (An attempt a previous
        segment left outstanding stays outcome-less in the log — the
        validator tolerates it and ``unresolved_remediations`` reports
        it; the new segment cannot know what became of an action it
        never ran.)"""
        try:
            records = load_remediation_log(path)
        except OSError:
            return
        for rec in records:
            if not isinstance(rec, dict):
                continue
            _, _, tail = str(rec.get("id", "")).rpartition("-")
            if tail.isdigit():
                # unguarded-ok: __init__-only, the engine is unshared
                self._seq = max(self._seq, int(tail))

    # -- the tick ----------------------------------------------------------

    def tick(self, active: Mapping[str, Mapping[str, Any]],
             now: Optional[float] = None) -> List[Dict[str, Any]]:
        """One actuation pass over the alert engine's active set
        (``{slo: {"alert_id", "severity", "fired_at", ...}}``).
        Returns the audit events this tick appended."""
        now = self._clock() if now is None else float(now)
        events: List[Dict[str, Any]] = []
        actions_to_run: List[Tuple[RemediationPolicy, Dict[str, Any]]] = []
        undos_to_run: List[Tuple[Callable, Dict[str, Any]]] = []
        with self._lock:
            active_ids = {info.get("alert_id")
                          for info in active.values()}
            # 1) outstanding attempts whose alert resolved: the success
            # signal — conclude them; outstanding undos whose incident
            # resolved run regardless of how their attempt concluded.
            for pname, pend in list(self._pending.items()):
                if pend.alert.get("alert_id") in active_ids:
                    continue
                events.append(self._emit_outcome(
                    pend, "succeeded", now, detail=pend.detail))
                del self._pending[pname]
            for pname, (undo, alert) in list(self._undos.items()):
                if alert.get("alert_id") in active_ids:
                    continue
                del self._undos[pname]
                undos_to_run.append((undo, alert))
            # 2) policies whose SLO is burning: retry/attempt under the
            # budgets.
            for pol in self.policies:
                info = active.get(pol.slo)
                if info is None:
                    continue
                alert = {"slo": pol.slo, **dict(info)}
                aid = str(alert.get("alert_id"))
                key = (pol.name, aid)
                last = self._last_attempt_ts.get(pol.name)
                cooled = last is None or now - last >= pol.cooldown_s
                pend = self._pending.get(pol.name)
                if pend is not None:
                    if not cooled:
                        continue  # give the action time to take effect
                    # A full cooldown after the action and the alert is
                    # STILL firing: this attempt failed.
                    events.append(self._emit_outcome(
                        pend, "failed", now,
                        error=(f"alert {pend.alert.get('alert_id')} still "
                               f"firing {pol.cooldown_s:g}s after the "
                               "action")))
                    del self._pending[pol.name]
                if self._attempts.get(key, 0) >= pol.max_attempts:
                    continue  # incident budget exhausted: stand down
                if not cooled:
                    continue
                self._attempts[key] = self._attempts.get(key, 0) + 1
                self._last_attempt_ts[pol.name] = now
                self._seq += 1
                attempt = self._attempts[key]
                rec_id = f"{pol.name}-{self._seq}"
                events.append(self._emit_attempted(
                    pol, alert, rec_id, attempt, now))
                if self.dry_run:
                    continue  # logs, never acts; no outcome ever
                actions_to_run.append((pol, {
                    "rec_id": rec_id, "alert": alert, "attempt": attempt,
                    "ts": now}))
        # Actions run OUTSIDE the lock (a slow hot-swap must not block
        # the /healthz read of last_by_policy); the attempted record is
        # already on disk, so a crash inside the action is auditable.
        for pol, ctx in actions_to_run:
            fn, undo = self._actions[pol.action]
            try:
                detail = fn(ctx["alert"])
            except Exception as e:  # noqa: BLE001 — a failed action is a record
                log.error("remediation %s (%s) failed: %s",
                          pol.name, pol.action, e)
                with self._lock:
                    # Stamped at the tick's own now (never earlier than
                    # the attempted record — the audit contract), so
                    # offline replay with an injected clock stays
                    # validator-clean.
                    events.append(self._emit_outcome(
                        _Pending(ctx["rec_id"], pol, ctx["alert"],
                                 ctx["attempt"], ctx["ts"], None),
                        "failed", max(self._clock(), ctx["ts"]),
                        error=str(e)))
            else:
                with self._lock:
                    self._pending[pol.name] = _Pending(
                        ctx["rec_id"], pol, ctx["alert"], ctx["attempt"],
                        ctx["ts"], detail if isinstance(detail, dict)
                        else None)
                    if undo is not None:
                        self._undos[pol.name] = (undo, ctx["alert"])
        for undo, alert in undos_to_run:
            try:
                undo(alert)
            except Exception as e:  # noqa: BLE001 — best-effort release
                log.error("remediation undo failed: %s", e)
        return events

    # -- records -----------------------------------------------------------

    def _emit_attempted(self, pol: RemediationPolicy, alert, rec_id: str,
                        attempt: int, now: float) -> Dict[str, Any]:
        return self._emit({
            "schema": REMEDIATION_SCHEMA,
            "id": rec_id,
            "policy": pol.name,
            "action": pol.action,
            "alert_id": alert.get("alert_id"),
            "slo": pol.slo,
            "severity": alert.get("severity", "warning"),
            "state": "attempted",
            "ts": now,
            "attempt": attempt,
            "max_attempts": pol.max_attempts,
            "dry_run": self.dry_run,
            "message": (
                f"{pol.name}: {'DRY-RUN ' if self.dry_run else ''}"
                f"{pol.action} for alert {alert.get('alert_id')} "
                f"(attempt {attempt}/{pol.max_attempts})"),
        })

    def _emit_outcome(self, pend: _Pending, state: str, now: float,
                      detail: Optional[dict] = None,
                      error: Optional[str] = None) -> Dict[str, Any]:
        pol = pend.policy
        rec: Dict[str, Any] = {
            "schema": REMEDIATION_SCHEMA,
            "id": pend.rec_id,
            "policy": pol.name,
            "action": pol.action,
            "alert_id": pend.alert.get("alert_id"),
            "slo": pol.slo,
            "severity": pend.alert.get("severity", "warning"),
            "state": state,
            "ts": now,
            "attempt": pend.attempt,
            "max_attempts": pol.max_attempts,
            "dry_run": False,
            "duration_s": round(now - pend.ts, 3),
            "message": (
                f"{pol.name}: {pol.action} {state} for alert "
                f"{pend.alert.get('alert_id')}"
                + (f" — {error}" if error else "")),
        }
        if error is not None:
            rec["error"] = error
        if detail:
            rec["detail"] = detail
        return self._emit(rec)

    def _emit(self, rec: Dict[str, Any]) -> Dict[str, Any]:  # holds-lock: _lock
        self.history.append(rec)
        self._last[rec["policy"]] = rec
        if self._f is not None and not self._f.closed:
            self._f.write(json.dumps(rec) + "\n")
        log.warning("REMEDIATION %s: %s", rec["state"], rec["message"])
        return rec

    # -- reads -------------------------------------------------------------

    def last_by_policy(self) -> Dict[str, Dict[str, Any]]:
        """{policy: the last audit state} — the /healthz + drain-summary
        surface.  A policy that never
        fired has NO key (the freshness-JSON contract: absent means
        never, not ok).  O(policies), not O(history) — /healthz scrapes
        this under the engine lock the tick path shares."""
        with self._lock:
            return {
                policy: {
                    "action": rec["action"],
                    "outcome": rec["state"],
                    "alert_id": rec["alert_id"],
                    "wall_time": rec["ts"],
                    **({"dry_run": True} if rec.get("dry_run") else {}),
                }
                for policy, rec in self._last.items()
            }

    def close(self) -> None:
        with self._lock:
            if self._f is not None and not self._f.closed:
                self._f.close()


# -- policy tables ------------------------------------------------------------

_POLICY_KEYS = {f.name for f in dataclasses.fields(RemediationPolicy)}


def default_policies(kind: str) -> List[RemediationPolicy]:
    """The shipped policy tables, bound to the default watchdog SLO
    names (obs/live/watchdogs.py) and the action names the CLI
    registers."""
    if kind == "serve":
        return [
            RemediationPolicy(
                name="hotswap_model", slo="model_staleness",
                action="snapshot_hotswap", cooldown_s=30.0,
                max_attempts=3,
                description="hot-swap to the newest committed snapshot "
                            "when the served model goes stale"),
            RemediationPolicy(
                name="hotswap_index", slo="index_staleness",
                action="snapshot_hotswap", cooldown_s=30.0,
                max_attempts=3,
                description="republish the newest committed gallery "
                            "index when the served one goes stale"),
            RemediationPolicy(
                name="load_shed", slo="serve_queue_saturation",
                action="load_shed", cooldown_s=10.0, max_attempts=5,
                description="engage admission shedding while the queue "
                            "saturates; released when the alert clears"),
            RemediationPolicy(
                name="rewarm", slo="serve_post_warmup_compile",
                action="rewarm", cooldown_s=120.0, max_attempts=2,
                description="re-warm every padding bucket after a "
                            "post-warmup compile storm"),
            RemediationPolicy(
                name="probe_escalation", slo="serve_recall_floor",
                action="escalate_probes", cooldown_s=30.0,
                max_attempts=4,
                description="widen the IVF probe set while the shadow "
                            "recall estimate burns; past the probe "
                            "budget, fall back to flat exact scoring"),
        ]
    if kind == "train":
        return [
            RemediationPolicy(
                name="trainer_rollback", slo="embedding_collapse",
                action="trainer_rollback", cooldown_s=120.0,
                max_attempts=2,
                description="roll the trainer back to a pre-incident "
                            "snapshot on embedding collapse"),
        ]
    raise ValueError(
        f"unknown policy kind {kind!r} (expected 'serve' or 'train')")


def load_policies(path: str) -> List[RemediationPolicy]:
    """Parse a remediation config file::

        {"policies": [
          {"name": "hotswap_model", "slo": "model_staleness",
           "action": "snapshot_hotswap", "cooldown_s": 30,
           "max_attempts": 3}
        ]}

    Validation is loud — a typo'd key or an empty table must fail at
    load, not silently never remediate."""
    with open(path) as f:
        raw = json.load(f)
    if not isinstance(raw, dict):
        raise ValueError(f"{path}: remediation config must be an object")
    unknown = set(raw) - {"policies"}
    if unknown:
        raise ValueError(
            f"{path}: unknown top-level keys {sorted(unknown)}")
    entries = raw.get("policies")
    if not isinstance(entries, list) or not entries:
        raise ValueError(f"{path}: config defines no policies")
    out: List[RemediationPolicy] = []
    for i, entry in enumerate(entries):
        if not isinstance(entry, dict):
            raise ValueError(f"{path}: policies[{i}] is not an object")
        bad = set(entry) - _POLICY_KEYS
        if bad:
            raise ValueError(
                f"{path}: policies[{i}] unknown keys {sorted(bad)} "
                f"(known: {sorted(_POLICY_KEYS)})")
        missing = {"name", "slo", "action"} - set(entry)
        if missing:
            raise ValueError(
                f"{path}: policies[{i}] missing {sorted(missing)}")
        out.append(RemediationPolicy(**entry))
    names = [p.name for p in out]
    if len(set(names)) != len(names):
        raise ValueError(f"{path}: duplicate policy names: {names}")
    return out


# -- the npairloss-remediation-v1 contract ------------------------------------


def load_remediation_log(path: str) -> List[Dict[str, Any]]:
    """Read one audit JSONL file; a torn final line (killed writer) is
    tolerated, any other unparseable line surfaces through the
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


def validate_remediation_log(
    records: Sequence[Any],
    alert_records: Optional[Sequence[Dict[str, Any]]] = None,
) -> Optional[str]:
    """Schema + lifecycle check; returns an error string or None.

    The contract: every record carries :data:`EVENT_KEYS` with the
    schema tag, a known state/severity, numeric ts, integer
    ``1 <= attempt <= max_attempts``; per id the lifecycle is
    ``attempted`` then at most ONE outcome (``succeeded``/``failed``),
    with ``outcome.ts >= attempted.ts``, a ``duration_s`` on every
    outcome and an ``error`` on every failure; a dry-run attempt never
    has an outcome (it never acted).  With ``alert_records`` (a
    validated ``npairloss-alerts-v1`` stream) every record must point
    at an alert that FIRED at or before the record's ts — an action
    without a firing alert is refused.
    """
    fired_at: Dict[str, float] = {}
    if alert_records is not None:
        for rec in alert_records:
            if isinstance(rec, dict) and rec.get("state") == "firing":
                fired_at[str(rec.get("alert_id"))] = float(
                    rec.get("ts", 0.0))
    lifecycles: Dict[str, List[Dict[str, Any]]] = {}
    for i, rec in enumerate(records):
        if not isinstance(rec, dict):
            return f"record {i} is not an object"
        if "_bad_line" in rec:
            return f"unparseable JSON on line {rec['_bad_line']}"
        if rec.get("schema") != REMEDIATION_SCHEMA:
            return (f"record {i}: schema must be {REMEDIATION_SCHEMA!r}, "
                    f"got {rec.get('schema')!r}")
        for key in EVENT_KEYS:
            if key not in rec:
                return f"record {i} missing {key!r}"
        if rec["state"] not in REMEDIATION_STATES:
            return (f"record {i}: state {rec['state']!r} not in "
                    f"{REMEDIATION_STATES}")
        if rec["severity"] not in REMEDIATION_SEVERITIES:
            return (f"record {i}: severity {rec['severity']!r} not in "
                    f"{REMEDIATION_SEVERITIES}")
        if not isinstance(rec["ts"], (int, float)):
            return f"record {i}: ts is not numeric"
        if not isinstance(rec["dry_run"], bool):
            return f"record {i}: dry_run is not a bool"
        for key in ("attempt", "max_attempts"):
            if not isinstance(rec[key], int) or isinstance(rec[key], bool):
                return f"record {i}: {key} is not an integer"
        if not (1 <= rec["attempt"] <= rec["max_attempts"]):
            return (f"record {i}: attempt {rec['attempt']} outside "
                    f"[1, max_attempts {rec['max_attempts']}]")
        rid, state = rec["id"], rec["state"]
        seen = lifecycles.setdefault(rid, [])
        if state == "attempted":
            if seen:
                return f"record {i}: duplicate attempted for id {rid!r}"
        else:
            if not seen:
                return (f"record {i}: {state} for id {rid!r} without an "
                        "attempted record")
            if any(r["state"] != "attempted" for r in seen):
                return (f"record {i}: second outcome for id {rid!r} "
                        "(lifecycle is attempted then at most one of "
                        "succeeded|failed)")
            att = seen[0]
            if att["dry_run"]:
                return (f"record {i}: outcome for DRY-RUN id {rid!r} — "
                        "a dry run never acts, so it cannot succeed or "
                        "fail")
            if rec["ts"] < att["ts"]:
                return (f"record {i}: outcome ts {rec['ts']} precedes "
                        f"its attempted ts {att['ts']}")
            if not isinstance(rec.get("duration_s"), (int, float)):
                return f"record {i}: outcome missing numeric duration_s"
            if state == "failed" and not isinstance(rec.get("error"), str):
                return f"record {i}: failed record missing error"
        if alert_records is not None:
            aid = str(rec.get("alert_id"))
            if aid not in fired_at:
                return (f"record {i}: action for alert {aid!r} which "
                        "never fired in the alert log (action-without-"
                        "alert refused)")
            if float(rec["ts"]) < fired_at[aid]:
                return (f"record {i}: action ts {rec['ts']} precedes the "
                        f"firing of alert {aid!r} at {fired_at[aid]}")
        seen.append(rec)
    return None


def unresolved_remediations(records: Sequence[Dict[str, Any]]
                            ) -> List[Tuple[str, str, str]]:
    """(id, policy, alert_id) of non-dry attempts with no outcome at end
    of log — a process killed mid-action, or drained before the success
    signal arrived.  Reported, not gated (the alert gate already owns
    the unresolved-incident verdict).  Call only on a validated log."""
    pending: Dict[str, Tuple[str, str, str]] = {}
    for rec in records:
        if rec["state"] == "attempted":
            if not rec["dry_run"]:
                pending[rec["id"]] = (
                    rec["id"], rec["policy"], str(rec["alert_id"]))
        else:
            pending.pop(rec["id"], None)
    return list(pending.values())


def abandoned_remediations(
    records: Sequence[Dict[str, Any]],
    resolved_alert_ids: Optional[Sequence[str]] = None,
) -> List[Tuple[str, str, str]]:
    """(id, policy, alert_id) of CRITICAL incidents whose LAST attempt
    failed with budget remaining and no later attempt — the engine (or
    its operator) gave up early.  This is what a gate
    refuses: a failed critical remediation with attempts remaining is
    an actuator walking away from a LIVE incident, not an exhausted
    budget.  ``resolved_alert_ids`` (from the paired alert log) excuses
    incidents that RESOLVED anyway — an alert that healed after a
    failed attempt needed no retry, and the audit log alone cannot
    record that (resolution after a concluded-failed attempt emits no
    event).  Call only on a validated log."""
    resolved = {str(a) for a in (resolved_alert_ids or ())}
    last: Dict[Tuple[str, str], Dict[str, Any]] = {}
    for rec in records:
        last[(rec["policy"], str(rec["alert_id"]))] = rec
    out: List[Tuple[str, str, str]] = []
    for (policy, aid), rec in last.items():
        if (rec["state"] == "failed"
                and rec["severity"] == "critical"
                and rec["attempt"] < rec["max_attempts"]
                and aid not in resolved):
            out.append((rec["id"], policy, aid))
    return out
