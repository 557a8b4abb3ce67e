"""LiveObservatory — the one object the CLI wires in.  Port of
``npairloss_tpu/obs/live/live.py``.

Bundles the four moving parts (registry + sink adapter, SLO evaluator,
alert engine, probes) behind two entry points:

  * ``sink`` goes into ``RunTelemetry(extra_sinks=...)`` — the existing
    Solver / RetrievalServer rows then feed the registry with zero new
    call sites;
  * ``tick()`` evaluates every SLO and advances the alert lifecycle —
    called by the background thread (``start()``/``stop()``) in live
    processes, or directly with an injected ``now`` by the offline
    ``watch`` feed and by tests (deterministic by construction).

``probes`` cover the few signals that are not metric rows (freshness
ages, snapshot age): each probe is a callable run at the top of every
tick that sets gauges directly — polling state the process already
holds, not new instrumentation.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from npairloss_tpu_torch.obs.live.alerts import AlertEngine
from npairloss_tpu_torch.obs.live.registry import MetricRegistry, RegistrySink
from npairloss_tpu_torch.obs.live.slo import SLOEvaluator, SLOSpec

log = logging.getLogger("npairloss_tpu_torch.obs.live")

ALERTS_FILENAME = "alerts.jsonl"


class LiveObservatory:
    """Registry + sink + SLO evaluator + alert engine + probe loop.

    ``out_dir`` lands ``alerts.jsonl`` there (None = in-memory only);
    ``min_ticks`` is the alert engine's debounce.  Start the background
    evaluator with ``start(period_s)``; ``stop()`` runs one final tick
    first so an alert state that changed right before shutdown still
    reaches the log (the drain contract), then closes the log file.
    """

    def __init__(
        self,
        specs: Sequence[SLOSpec],
        out_dir: Optional[str] = None,
        min_ticks: int = 1,
        clock=time.time,
    ):
        self.registry = MetricRegistry()
        self.sink = RegistrySink(self.registry)
        self.evaluator = SLOEvaluator(specs, self.registry)
        self.alerts_path = (
            os.path.join(os.path.abspath(out_dir), ALERTS_FILENAME)
            if out_dir else None)
        self.alerts = AlertEngine(self.alerts_path, min_ticks=min_ticks,
                                  clock=clock)
        self.probes: List[Callable[[], None]] = []
        self.listeners: List[Callable[[List[Any]], None]] = []
        # Optional RemediationEngine (resilience/remediate.py): ticked
        # AFTER the alert update with the SAME now, so actuation and
        # the pager can never disagree about the alert state.  Duck-
        # typed on purpose — this package stays stdlib-only/jax-free.
        self.remediation = None
        self._clock = clock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def add_probe(self, fn: Callable[[], None]) -> None:
        """Register a per-tick gauge setter (freshness ages etc.); a
        probe raising is logged once per tick, never fatal."""
        self.probes.append(fn)

    def add_listener(self, fn: Callable[[List[Any]], None]) -> None:
        """Register a per-tick consumer of the COMMITTED SLO statuses —
        the actuation hook (serve admission control sheds load on burn
        through exactly this stream, so actuators and the pager can
        never disagree about the burn state).  A listener raising is
        logged, never fatal."""
        self.listeners.append(fn)

    def set_remediation(self, engine) -> None:
        """Attach the alert→actuation engine: its ``tick(active, now)``
        runs after every alert update (actions run on the evaluator
        thread — a slow action pauses evaluation, bounded by the action
        itself), and ``stop()`` closes its audit log."""
        self.remediation = engine

    # -- evaluation --------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """Probes -> SLO evaluation -> alert lifecycle; returns the
        alert events this tick emitted."""
        for probe in self.probes:
            try:
                probe()
            except Exception as e:  # noqa: BLE001 — probes are best-effort
                log.warning("live-obs probe failed: %s", e)
        now = self._clock() if now is None else float(now)
        statuses = self.evaluator.evaluate(now)
        events = self.alerts.update(statuses, now)
        for ev in events:
            log.warning("ALERT %s: %s", ev["state"], ev["message"])
        for fn in self.listeners:
            try:
                fn(statuses)
            except Exception as e:  # noqa: BLE001 — actuation best-effort
                log.error("live-obs listener failed: %s", e)
        if self.remediation is not None:
            try:
                self.remediation.tick(self.alerts.active(), now)
            except Exception as e:  # noqa: BLE001 — must not kill the tick
                log.error("remediation tick failed: %s", e)
        return events

    def health(self) -> Dict[str, Any]:
        """The /healthz enrichment: per-SLO status + active alerts."""
        active = self.alerts.active()
        return {
            "slo": self.evaluator.status_dict(self._clock()),
            "alerts_active": len(active),
            "alerts": active,
        }

    # -- background loop ---------------------------------------------------

    def start(self, period_s: float = 1.0) -> "LiveObservatory":
        if self._thread is None:
            self._stop.clear()

            def loop():
                while not self._stop.wait(period_s):
                    try:
                        self.tick()
                    except Exception as e:  # noqa: BLE001 — keep ticking
                        log.error("live-obs tick failed: %s", e)

            self._thread = threading.Thread(
                target=loop, name="live-obs-evaluator", daemon=True)
            self._thread.start()
        return self

    def stop(self, final_tick: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        if final_tick:
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001
                log.error("live-obs final tick failed: %s", e)
        self.alerts.close()
        if self.remediation is not None:
            try:
                self.remediation.close()
            except Exception as e:  # noqa: BLE001
                log.error("remediation close failed: %s", e)
