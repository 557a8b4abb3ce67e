"""Declarative SLOs: spec, config loader, incremental burn-rate evaluator.

Port of ``npairloss_tpu/obs/live/slo.py`` (a copy).

An SLO here is an operating
target on a live metric — "serve p99 <= 150 ms", "queue depth <= 80% of
the bound" — evaluated over a ROLLING window with a burn-rate
threshold: the SLO is burning when more than ``burn_threshold`` of the
window's samples violate the target.  Burn fraction (not a single
sample) is what separates an incident from boundary noise; the
hysteresis pair ``burn_threshold``/``clear_threshold`` is what keeps an
alert from flapping when the burn fraction dances on the line
(:mod:`npairloss_tpu_torch.obs.live.alerts` owns the firing→resolved
lifecycle).

Config is a JSON file (TOML accepted when the interpreter ships
``tomllib``); every entry maps 1:1 onto :class:`SLOSpec`, and the named
:mod:`watchdogs` can be pulled in by reference so a config composes
"the standard serve watchdogs plus my custom p99 bar" without
restating them.

Stdlib only (the package contract — see ``obs/live/__init__``).
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Dict, List, Optional, Sequence

SEVERITIES = ("info", "warning", "critical")
OPS = ("<=", ">=")


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One declarative objective.

    ``metric`` names a registry gauge/histogram sample stream; a sample
    ``v`` is GOOD when ``v <op> target`` holds.  Over the trailing
    ``window_s`` seconds: bad_fraction >= ``burn_threshold`` starts the
    SLO burning; it stops only when bad_fraction <= ``clear_threshold``
    (default: half the burn threshold) — the hysteresis band.  Windows
    with fewer than ``min_samples`` samples keep the PREVIOUS state: a
    healthy SLO stays ok (no evidence is not an incident) and a
    burning one stays burning (silence is not recovery — a wedged
    server emitting nothing must not stand the pager down; resolution
    requires good samples).
    """

    name: str
    metric: str
    op: str
    target: float
    window_s: float = 60.0
    burn_threshold: float = 0.5
    clear_threshold: Optional[float] = None
    min_samples: int = 1
    severity: str = "warning"
    description: str = ""

    def __post_init__(self):
        if self.op not in OPS:
            raise ValueError(
                f"slo {self.name!r}: op must be one of {OPS}, "
                f"got {self.op!r}")
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"slo {self.name!r}: severity must be one of "
                f"{SEVERITIES}, got {self.severity!r}")
        if not (0.0 < self.burn_threshold <= 1.0):
            raise ValueError(
                f"slo {self.name!r}: burn_threshold must be in (0, 1], "
                f"got {self.burn_threshold}")
        if self.window_s <= 0:
            raise ValueError(
                f"slo {self.name!r}: window_s must be > 0, "
                f"got {self.window_s}")
        if self.min_samples < 1:
            raise ValueError(
                f"slo {self.name!r}: min_samples must be >= 1, "
                f"got {self.min_samples}")
        clear = self.resolved_clear_threshold()
        if not (0.0 <= clear <= self.burn_threshold):
            raise ValueError(
                f"slo {self.name!r}: clear_threshold {clear} must sit in "
                f"[0, burn_threshold {self.burn_threshold}] — hysteresis "
                "clears BELOW where it fires")

    def resolved_clear_threshold(self) -> float:
        if self.clear_threshold is not None:
            return self.clear_threshold
        return self.burn_threshold / 2.0

    def good(self, value: float) -> bool:
        return value <= self.target if self.op == "<=" \
            else value >= self.target


@dataclasses.dataclass
class SLOStatus:
    """One spec's evaluation at one instant."""

    spec: SLOSpec
    burning: bool
    bad_fraction: float
    samples: int
    worst: Optional[float] = None  # most-violating sample in the window

    def to_dict(self) -> Dict[str, Any]:
        return {
            "slo": self.spec.name,
            "metric": self.spec.metric,
            "burning": self.burning,
            "bad_fraction": round(self.bad_fraction, 4),
            "samples": self.samples,
            "worst": self.worst,
            "severity": self.spec.severity,
        }


class SLOEvaluator:
    """Evaluate specs over a registry's rolling sample windows.

    Stateful only for hysteresis: each spec's previous burning state
    decides which threshold applies (burn to START, clear to STOP), so
    a bad_fraction wobbling between the two cannot flap.  The evaluator
    itself holds no samples — the registry's windows are the one store,
    which is exactly what lets the in-process feed and the offline
    ``watch`` feed share this class unchanged.
    """

    def __init__(self, specs: Sequence[SLOSpec], registry):
        import threading

        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {names}")
        self.specs = list(specs)
        self.registry = registry
        self._burning: Dict[str, bool] = \
            {s.name: False for s in self.specs}  # guarded-by: _lock
        # Hysteresis state is written only by committed evaluations;
        # the lock serializes the tick thread against /healthz scrapes
        # (which evaluate read-only — a monitoring poll must never
        # advance alerting state, see ``commit``).
        self._lock = threading.Lock()

    def evaluate(self, now: Optional[float] = None,
                 commit: bool = True) -> List[SLOStatus]:
        """One evaluation.  ``commit=False`` is the scrape mode
        (/healthz, watch summaries): the hysteresis decision is made
        against the CURRENT state but never written back, so an
        off-tick poll landing on a transient burn cannot open or close
        an alert the tick-driven engine alone would not have."""
        now = time.time() if now is None else float(now)
        out: List[SLOStatus] = []
        with self._lock:
            for spec in self.specs:
                samples = self.registry.samples_since(
                    spec.metric, now - spec.window_s)
                # Clamp to the window's leading edge too: offline
                # replay hands ``now`` mid-stream and must not see the
                # future.
                vals = [v for t, v in samples if t <= now]
                n = len(vals)
                was = self._burning[spec.name]
                if n < spec.min_samples:
                    # No evidence is not an incident — but it is not
                    # RECOVERY either: a burning SLO holds through an
                    # empty window (a wedged server emitting nothing is
                    # the worst version of the incident; standing the
                    # pager down on silence would be exactly wrong).
                    # Resolution requires good samples.
                    out.append(SLOStatus(spec, was, 0.0, n))
                    continue
                bad = [v for v in vals if not spec.good(v)]
                frac = len(bad) / n
                if was:
                    burning = frac > spec.resolved_clear_threshold()
                else:
                    burning = frac >= spec.burn_threshold
                if commit:
                    self._burning[spec.name] = burning
                worst = None
                if bad:
                    worst = max(bad) if spec.op == "<=" else min(bad)
                out.append(SLOStatus(spec, burning, frac, n, worst))
        return out

    def status_dict(self, now: Optional[float] = None) -> Dict[str, Any]:
        """{slo name: status} — the /healthz enrichment payload.
        Read-only: scraping health never advances hysteresis."""
        return {s.spec.name: s.to_dict()
                for s in self.evaluate(now, commit=False)}


# -- config loading -----------------------------------------------------------

_SPEC_KEYS = {f.name for f in dataclasses.fields(SLOSpec)}


def _spec_from_dict(d: Dict[str, Any], source: str) -> SLOSpec:
    unknown = set(d) - _SPEC_KEYS
    if unknown:
        raise ValueError(
            f"{source}: unknown SLO keys {sorted(unknown)} "
            f"(known: {sorted(_SPEC_KEYS)})")
    missing = {"name", "metric", "op", "target"} - set(d)
    if missing:
        raise ValueError(f"{source}: SLO entry missing {sorted(missing)}")
    return SLOSpec(**d)


def load_slo_config(path: str) -> List[SLOSpec]:
    """Parse an SLO config file into specs.

    JSON shape (TOML is isomorphic when ``tomllib`` is available)::

        {
          "watchdogs": ["serve"],            # named presets (optional)
          "slos": [
            {"name": "p99", "metric": "serve_p99_ms", "op": "<=",
             "target": 150.0, "window_s": 30, "burn_threshold": 0.5,
             "severity": "critical"}
          ]
        }

    ``watchdogs`` pulls in :func:`watchdogs.default_watchdogs` presets
    by kind; explicit ``slos`` entries with the same ``name`` override
    the preset of that name.  Validation is loud — a typo'd threshold
    must fail at load, not silently never fire.
    """
    raw = None
    if path.endswith(".toml"):
        try:
            import tomllib  # Python >= 3.11
        except ImportError as e:
            raise ValueError(
                f"{path}: TOML config needs a tomllib-equipped "
                "interpreter; use the JSON form"
            ) from e
        with open(path, "rb") as f:
            raw = tomllib.load(f)
    else:
        with open(path) as f:
            raw = json.load(f)
    if not isinstance(raw, dict):
        raise ValueError(f"{path}: SLO config must be an object")
    unknown = set(raw) - {"watchdogs", "slos"}
    if unknown:
        raise ValueError(
            f"{path}: unknown top-level keys {sorted(unknown)}")
    specs: Dict[str, SLOSpec] = {}
    kinds = raw.get("watchdogs", [])
    if kinds:
        from npairloss_tpu_torch.obs.live.watchdogs import default_watchdogs

        if not isinstance(kinds, list):
            raise ValueError(f"{path}: 'watchdogs' must be a list of kinds")
        for kind in kinds:
            for spec in default_watchdogs(kind):
                specs[spec.name] = spec
    entries = raw.get("slos", [])
    if not isinstance(entries, list):
        raise ValueError(f"{path}: 'slos' must be a list")
    for i, entry in enumerate(entries):
        if not isinstance(entry, dict):
            raise ValueError(f"{path}: slos[{i}] is not an object")
        spec = _spec_from_dict(entry, f"{path}: slos[{i}]")
        specs[spec.name] = spec
    if not specs:
        raise ValueError(f"{path}: config defines no SLOs")
    return list(specs.values())
