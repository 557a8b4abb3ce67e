"""SLO-burn-driven admission control — the observatory acting on load.

Port of ``npairloss_tpu/serve/admission.py`` (a copy: stdlib only, the
same decisions and gauges on the same status streams).

An :class:`AdmissionController` registered as a ``LiveObservatory``
tick listener watches the committed burn state of the configured SLOs
(serve p99, queue saturation by default).  While any of them burns, the
front end SHEDS new queries — fast-reject with backpressure (the
``QueueFullError`` answer path, counted in the ``rejected`` invariant),
so an overload ramp degrades into cheap rejections instead of
collapsing into unbounded queueing — and admits again when the burn
clears.

Hysteresis is the SLO engine's own burn/clear band
(:mod:`npairloss_tpu_torch.obs.live.slo`): the controller adds no
second threshold, so shedding starts exactly when the alert would and
stops exactly when it resolves — one definition of "overloaded".

The one extra mechanism is the **probe trickle**: while shedding, every
``probe_every``-th query is still admitted.  Recovery is only
observable through served latencies — if shedding rejected everything,
the latency stream would go silent, and a silent window HOLDS a burning
SLO (silence is not recovery, by design); the tier would never
readmit.  The trickle keeps a measured pulse flowing so clearing is
reachable.

Metrics (when built with a registry): gauge ``serve_shedding`` (0/1),
counters ``serve_shed_total`` / ``serve_probe_admitted_total``.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Optional, Sequence, Tuple

log = logging.getLogger("npairloss_tpu_torch.serve")

DEFAULT_ADMISSION_SLOS = ("serve_p99", "serve_queue_saturation")


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """``slo_names``: which SLOs' burn state gates admission (names
    from the active spec set — the serve watchdog presets by default);
    ``probe_every``: admit one query per this many sheds while
    shedding, so recovery stays observable (0 disables the trickle —
    only safe when another admitted traffic source feeds the SLO's
    metric)."""

    slo_names: Tuple[str, ...] = DEFAULT_ADMISSION_SLOS
    probe_every: int = 8

    def __post_init__(self):
        if not self.slo_names:
            raise ValueError("admission control needs >= 1 SLO name")
        if self.probe_every < 0:
            raise ValueError(
                f"probe_every must be >= 0, got {self.probe_every}")


class AdmissionController:
    """Tick-fed shed/admit gate; thread-safe (submits race ticks).

    Wire with ``live.add_listener(controller.on_statuses)`` and consult
    :meth:`admit` per submitted query.  The burn state only changes on
    COMMITTED evaluator ticks (the same stream that drives alerts), so
    shedding and the pager can never disagree about whether the tier is
    overloaded.
    """

    def __init__(self, cfg: AdmissionConfig = AdmissionConfig(),
                 registry=None):
        self.cfg = cfg
        self.registry = registry
        self.shedding = False
        # Remediation override (resilience/remediate.py): while
        # ``forced`` is set by engage(), the gate sheds regardless of
        # the listener-fed burn state — the audited load-shed action,
        # released by the remediation engine when its alert resolves.
        self.forced = False
        self.sheds = 0
        self.probes_admitted = 0
        self._since_probe = 0
        self._lock = threading.Lock()
        if registry is not None:
            registry.set("serve_shedding", 0.0)

    # -- tick listener -----------------------------------------------------

    def on_statuses(self, statuses: Sequence) -> None:
        """LiveObservatory tick listener: recompute the shed state from
        the committed burn flags of the watched SLOs."""
        watched = set(self.cfg.slo_names)
        burning = sorted(
            s.spec.name for s in statuses
            if s.burning and s.spec.name in watched)
        shed = bool(burning)
        with self._lock:
            changed = shed != self.shedding
            self.shedding = shed
            if changed:
                self._since_probe = 0
            gauge = 1.0 if (shed or self.forced) else 0.0
        if self.registry is not None:
            self.registry.set("serve_shedding", gauge)
        if changed and shed:
            log.warning(
                "admission control: SHEDDING load (burning SLOs: %s)",
                ", ".join(burning))
        elif changed:
            log.warning("admission control: burn cleared, admitting")

    # -- the remediation override ------------------------------------------

    def engage(self, _alert=None) -> dict:
        """Force shedding on (idempotent) — the audited ``load_shed``
        remediation action.  The probe trickle still applies, so
        recovery stays observable exactly as under listener-driven
        shedding."""
        with self._lock:
            changed = not self.forced
            self.forced = True
            if changed:
                self._since_probe = 0
        if self.registry is not None:
            self.registry.set("serve_shedding", 1.0)
        if changed:
            log.warning("admission control: load shed ENGAGED "
                        "(remediation)")
        return {"engaged": True}

    def release(self, _alert=None) -> None:
        """Stand the forced shed down — the remediation engine's undo,
        run when the triggering alert resolves.  Listener-driven burn
        shedding (if wired) keeps its own verdict."""
        with self._lock:
            changed = self.forced
            self.forced = False
            still = self.shedding
        if changed and not still and self.registry is not None:
            self.registry.set("serve_shedding", 0.0)
        if changed:
            log.warning("admission control: forced shed released "
                        "(remediation)")

    # -- the gate ----------------------------------------------------------

    def admit(self, trace=None) -> bool:
        """True = admit this query; False = shed it (the caller rejects
        with backpressure and counts it in ``rejected``).  ``trace``
        (optional) is the query's qtrace context: a probe-trickle
        admission stamps it, so an exemplar that was admitted WHILE
        shedding is readable as the deliberate measured pulse it is —
        its tail latency indicts the overload, not the gate."""
        with self._lock:
            if not (self.shedding or self.forced):
                return True
            self._since_probe += 1
            if self.cfg.probe_every and \
                    self._since_probe >= self.cfg.probe_every:
                self._since_probe = 0
                self.probes_admitted += 1
                if trace is not None:
                    trace.probe = True
                if self.registry is not None:
                    self.registry.inc("serve_probe_admitted")
                return True
            self.sheds += 1
        if self.registry is not None:
            self.registry.inc("serve_shed")
        return False

    def stats(self) -> dict:
        with self._lock:
            return {
                "shedding": self.shedding or self.forced,
                "shed": self.sheds,
                "probes_admitted": self.probes_admitted,
                "slos": list(self.cfg.slo_names),
                **({"forced": True} if self.forced else {}),
            }


def controller_from_args(
    slo_csv: Optional[str],
    registry=None,
    probe_every: int = 8,
) -> AdmissionController:
    """CLI glue: ``--admission-slos "a,b"`` -> a wired controller."""
    names = tuple(
        n.strip() for n in (slo_csv or "").split(",") if n.strip()
    ) or DEFAULT_ADMISSION_SLOS
    return AdmissionController(
        AdmissionConfig(slo_names=names, probe_every=probe_every),
        registry=registry)
