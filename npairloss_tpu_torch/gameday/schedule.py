"""Declarative chaos schedule — scripted faults with declared evidence.

A copy of ``npairloss_tpu/gameday/schedule.py`` (the same grammar, the
same default schedules).

Each :class:`ChaosEntry` arms ONE existing failpoint
(resilience/failpoints.py; the gameday invents no new fault sites) or
schedules ONE signal, in the same ``name:count@delay`` grammar the
``NPAIRLOSS_FAILPOINTS`` env var speaks — and declares, up front, the
evidence the run must produce: the alert that must fire, the
remediation that must resolve it, and any extra checks
(``zero_client_errors``, ``preempt_exit``, ``resume``,
``ingest_durable``, ``ingest_no_duplicates``).  The verdict
(gameday/verdict.py) holds the run to exactly these declarations: an
injected fault with no paging/actuation evidence fails the gameday.

Stdlib-only: schedules load in processes without torch too.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Sequence, Tuple

TARGETS = ("serve", "train")
# "traffic" entries script no fault site at all: the chaos IS the
# traffic plan's shape (e.g. the tenant-skew hot-tenant burst), and the
# declared alert pair is the only evidence they leave.
KINDS = ("failpoint", "signal", "traffic")
# Extra per-entry checks the verdict knows how to verify.
EXPECT_CHECKS = ("zero_client_errors", "preempt_exit", "resume",
                 "ingest_durable", "ingest_no_duplicates")
# Declarable p99-attribution evidence: the qtrace stage the fault's
# incident window must show as dominant (the obs.qtrace stage
# vocabulary — restated here because the gate path loads this module
# without the package), plus "reroute" for faults whose signature is
# the crash-reroute marker rather than a stage.
STAGE_CHECKS = ("admit_wait", "queue_wait", "batch_assemble",
                "dispatch", "score", "topk_merge", "reroute")


@dataclasses.dataclass(frozen=True)
class ChaosEntry:
    """One scripted fault and the evidence it must leave behind.

    ``failpoint`` entries arm ``name:count@delay`` in the target
    process's environment; ``delay`` counts CHECKS at the site (the
    grammar's contract), ``at_s`` is advisory wall-clock documentation
    of roughly when that lands in the window.  ``signal`` entries are
    delivered by the runner at ``at_s`` (name is the signal, e.g.
    ``SIGTERM``)."""

    name: str
    target: str = "serve"
    kind: str = "failpoint"
    count: int = 1
    delay: int = 0
    at_s: float = 0.0
    alert: Optional[str] = None        # SLO id that must fire+resolve
    remediation: Optional[str] = None  # policy that must succeed
    expect: Tuple[str, ...] = ()
    stage: Optional[str] = None        # dominant qtrace stage expected

    def __post_init__(self):
        if not self.name:
            raise ValueError("ChaosEntry needs a name")
        if self.target not in TARGETS:
            raise ValueError(
                f"target must be one of {TARGETS}, got {self.target!r}")
        if self.kind not in KINDS:
            raise ValueError(
                f"kind must be one of {KINDS}, got {self.kind!r}")
        if self.kind == "failpoint" and self.count < 1:
            raise ValueError(f"count must be >= 1, got {self.count}")
        if self.delay < 0 or self.at_s < 0:
            raise ValueError(
                f"delay/at_s must be >= 0, got {self.delay}/{self.at_s}")
        if self.remediation and not self.alert:
            raise ValueError(
                f"{self.name}: a remediation declaration needs the "
                "alert that triggers it")
        bad = [e for e in self.expect if e not in EXPECT_CHECKS]
        if bad:
            raise ValueError(
                f"{self.name}: unknown expect check(s) {bad}; "
                f"known: {EXPECT_CHECKS}")
        if self.kind == "signal" and (self.alert or self.remediation):
            raise ValueError(
                f"{self.name}: signal entries declare evidence via "
                "expect checks (preempt_exit/resume), not alerts")
        if self.kind == "traffic" and not self.alert:
            raise ValueError(
                f"{self.name}: a traffic entry's only evidence is its "
                "alert pair — declare the alert it must fire+resolve")
        if self.stage is not None:
            if self.stage not in STAGE_CHECKS:
                raise ValueError(
                    f"{self.name}: unknown stage {self.stage!r}; "
                    f"known: {STAGE_CHECKS}")
            if self.stage != "reroute" and not self.alert:
                raise ValueError(
                    f"{self.name}: a stage declaration needs the alert "
                    "whose incident window anchors the attribution "
                    "check (reroute is marker-counted, not windowed)")

    def spec(self) -> str:
        """This entry in the env grammar: ``name``, ``name:count`` or
        ``name:count@delay`` — canonical (no redundant suffixes)."""
        if self.kind != "failpoint":
            raise ValueError(f"{self.name} is a {self.kind}, not a "
                             "failpoint")
        if self.delay:
            return f"{self.name}:{self.count}@{self.delay}"
        if self.count != 1:
            return f"{self.name}:{self.count}"
        return self.name


def env_spec(entries: Sequence[ChaosEntry], target: str) -> str:
    """The comma-separated ``NPAIRLOSS_FAILPOINTS`` value arming every
    failpoint entry aimed at ``target`` ("" = nothing to arm)."""
    return ",".join(e.spec() for e in entries
                    if e.kind == "failpoint" and e.target == target)


def signals(entries: Sequence[ChaosEntry],
            target: str) -> List[ChaosEntry]:
    """Signal entries aimed at ``target``, soonest first."""
    out = [e for e in entries
           if e.kind == "signal" and e.target == target]
    return sorted(out, key=lambda e: e.at_s)


def default_schedule(duration_s: float = 75.0) -> List[ChaosEntry]:
    """The compressed-day schedule (docs/RESILIENCE.md §8): every
    serving/training fault family, timed so pre-fault health exists
    (snapshots committed, warmup done, traffic flowing)."""
    return [
        # Staleness poisoning: a handful of poisoned freshness probes
        # after the tier has warmed — drives model_staleness and the
        # snapshot hot-swap remediation.
        ChaosEntry(name="serve.stale_model", target="serve",
                   count=6, delay=10, at_s=0.15 * duration_s,
                   alert="model_staleness",
                   remediation="hotswap_model"),
        # A p99 burst well into the window (delay counts dispatches,
        # so it lands once real traffic has flowed) — drives serve_p99
        # and load shedding.  The declared stage is queue_wait, not
        # dispatch: on a saturated single-slot tier only the first
        # stalled query pays the stall as dispatch time — everyone
        # behind it pays it as queue wait (the ci.sh qtrace smoke
        # covers the throttled-traffic case where dispatch dominates).
        ChaosEntry(name="serve.latency", target="serve",
                   count=40, delay=200, at_s=0.5 * duration_s,
                   alert="serve_p99", remediation="load_shed",
                   stage="queue_wait"),
        # One replica dies mid-burst; the reroute contract says no
        # client ever notices — checked, not alerted.
        ChaosEntry(name="serve.replica_crash", target="serve",
                   count=1, delay=120, at_s=0.35 * duration_s,
                   expect=("zero_client_errors",), stage="reroute"),
        # Embedding collapse after snapshots exist — drives the
        # embedding-collapse watchdog and the trainer rollback.
        ChaosEntry(name="train.collapse", target="train",
                   count=160, delay=60, at_s=0.3 * duration_s,
                   alert="embedding_collapse",
                   remediation="trainer_rollback"),
        # Mid-stream preemption: the trainer must exit 75 with an
        # emergency snapshot and resume on relaunch.
        ChaosEntry(name="SIGTERM", target="train", kind="signal",
                   at_s=0.4 * duration_s,
                   expect=("preempt_exit", "resume")),
        # Host crash mid-ingest: SIGKILL the serving tier (no handler
        # runs, no drain, no final checkpoint), cold-restart it from
        # the published artifacts + WAL alone, and prove from the
        # host_crash evidence block that every ACKED ingest batch
        # survived exactly once (docs/RESILIENCE.md §Durability).
        ChaosEntry(name="SIGKILL", target="serve", kind="signal",
                   at_s=0.55 * duration_s,
                   expect=("ingest_durable", "ingest_no_duplicates")),
    ]


def tenant_skew_schedule(hot_tenant: str,
                         duration_s: float = 45.0) -> List[ChaosEntry]:
    """The multi-tenant noisy-neighbor scenario (docs/SERVING.md
    §Multi-tenant): the scripted chaos is the traffic plan itself — the
    hot tenant's arrival weight is multiplied inside the burst windows
    (traffic.TrafficConfig hot_burst_factor) until its quota sheds —
    and the declared evidence is the tenant-scoped quota alert pair.
    The ``tenant_quota@<id>`` spelling is serve/tenants.py's
    ``tenant_of_slo`` naming contract, restated here because schedules
    load in a process without torch or the package."""
    if not hot_tenant:
        raise ValueError("tenant_skew_schedule needs the hot tenant id")
    return [ChaosEntry(
        name="hot_tenant_burst", target="serve", kind="traffic",
        at_s=0.4 * duration_s,
        alert=f"tenant_quota@{hot_tenant}")]


def entry_dicts(entries: Sequence[ChaosEntry]) -> List[dict]:
    return [dataclasses.asdict(e) for e in entries]


def load_schedule(path: str) -> List[ChaosEntry]:
    """Load ``{"entries": [...]}`` — validation is ChaosEntry's
    (loud), so a typo'd target or an impossible declaration fails at
    load, not at verdict time."""
    with open(path, "r", encoding="utf-8") as f:
        obj = json.load(f)
    if not isinstance(obj, dict) or "entries" not in obj:
        raise ValueError(f"{path}: expected an object with 'entries'")
    entries = []
    for i, raw in enumerate(obj["entries"]):
        if not isinstance(raw, dict):
            raise ValueError(f"{path}: entry {i} is not an object")
        kwargs = dict(raw)
        if "expect" in kwargs:
            kwargs["expect"] = tuple(kwargs["expect"])
        try:
            entries.append(ChaosEntry(**kwargs))
        except TypeError as e:
            raise ValueError(f"{path}: entry {i}: {e}") from None
    return entries
