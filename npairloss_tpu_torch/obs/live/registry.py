"""In-process metric registry + the telemetry sink adapter that feeds it.
Port of ``npairloss_tpu/obs/live/registry.py`` (a copy).

The registry is the live observatory's state: named counters, gauges,
and fixed-bound histograms behind ONE lock, cheap enough to update on
every telemetry row and safe to read from any thread (the SLO evaluator
tick, the ``/metrics`` HTTP handler, a probe).  Gauges and histograms
additionally keep a bounded rolling sample window ``(wall_time, value)``
— that window is what the SLO engine's burn-rate math reads
(:mod:`npairloss_tpu_torch.obs.live.slo`).

``RegistrySink`` is the zero-new-call-sites bridge: it implements the
``MetricLogger`` protocol (obs.sinks), so attaching it as an
``extra_sinks`` entry on ``RunTelemetry`` routes every EXISTING Solver
and RetrievalServer metric row into the registry.  It never mutates the
record and never raises out of ``log`` (a live-obs bug must not abort
training or serving; MultiSink would re-raise) — and with no sink
attached, the telemetry streams on disk are byte-identical to a
run without live obs (pinned by tests/test_torch_live.py).

Stdlib only: no torch, no numpy — the watch feed runs on any box.
"""

from __future__ import annotations

import collections
import math
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

# Default fixed histogram bounds: latency-shaped (ms).  Fixed at
# construction — a histogram never grows buckets, so exposition stays
# O(bounds) and two processes observing the same metric agree on shape.
DEFAULT_BOUNDS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
                  250.0, 500.0, 1000.0, 2500.0, 5000.0)

# Rolling samples kept per gauge/histogram for SLO window evaluation.
SAMPLE_WINDOW = 4096

_NUMERIC = (int, float)


class Counter:
    """Monotone counter (``inc``); exported as ``<name>_total``."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative inc {amount}")
        self.value += amount


class Gauge:
    """Last-value metric with a rolling ``(t, v)`` sample window."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 window: int = SAMPLE_WINDOW):
        self.name = name
        self.help = help
        self.value: Optional[float] = None
        self.samples: collections.deque = collections.deque(maxlen=window)

    def set(self, value: float, t: Optional[float] = None) -> None:
        self.value = float(value)
        self.samples.append((time.time() if t is None else float(t),
                             self.value))


class Histogram:
    """Fixed-bound histogram: cumulative-style bucket counts + sum +
    count, plus the same rolling sample window gauges keep (so an SLO
    can target raw observations, not just pre-aggregated gauges)."""

    kind = "histogram"

    def __init__(self, name: str, bounds: Sequence[float] = DEFAULT_BOUNDS,
                 help: str = "", window: int = SAMPLE_WINDOW):
        bs = [float(b) for b in bounds]
        if not bs or bs != sorted(bs) or len(set(bs)) != len(bs):
            raise ValueError(
                f"histogram {name}: bounds must be ascending and unique, "
                f"got {bounds}")
        self.name = name
        self.help = help
        self.bounds: Tuple[float, ...] = tuple(bs)
        # counts[i] = observations <= bounds[i] is derived at exposition;
        # internally we keep per-bucket (non-cumulative) counts, last
        # slot = the +Inf overflow bucket.
        self.bucket_counts = [0] * (len(bs) + 1)
        self.sum = 0.0
        self.count = 0
        self.samples: collections.deque = collections.deque(maxlen=window)

    def observe(self, value: float, t: Optional[float] = None) -> None:
        v = float(value)
        i = 0
        while i < len(self.bounds) and v > self.bounds[i]:
            i += 1
        self.bucket_counts[i] += 1
        self.sum += v
        self.count += 1
        self.samples.append((time.time() if t is None else float(t), v))

    def cumulative_counts(self) -> List[int]:
        out, acc = [], 0
        for c in self.bucket_counts:
            acc += c
            out.append(acc)
        return out


class MetricRegistry:
    """Name -> metric, one lock for registration AND updates.

    Registration is get-or-create (``counter``/``gauge``/``histogram``);
    asking for an existing name with a different kind (or different
    histogram bounds) is a programming error and raises.  ``snapshot``
    and ``samples_since`` are the read APIs the exporter and the SLO
    evaluator consume — both return copies, so readers never hold the
    lock while rendering or doing math.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[str, Any] = {}  # guarded-by: _lock

    def _get(self, name: str, kind, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = kind(name, **kw)
                self._metrics[name] = m
                return m
            if not isinstance(m, kind):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {kind.kind}")
            if kind is Histogram and "bounds" in kw and \
                    tuple(float(b) for b in kw["bounds"]) != m.bounds:
                raise ValueError(
                    f"histogram {name!r} already registered with bounds "
                    f"{m.bounds}, requested {kw['bounds']}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, help=help)

    def histogram(self, name: str,
                  bounds: Sequence[float] = DEFAULT_BOUNDS,
                  help: str = "") -> Histogram:
        return self._get(name, Histogram, bounds=bounds, help=help)

    # -- thread-safe update shorthands ------------------------------------

    def inc(self, name: str, amount: float = 1.0) -> None:
        with self._lock:
            self.counter(name).inc(amount)

    def set(self, name: str, value: float, t: Optional[float] = None) -> None:
        with self._lock:
            self.gauge(name).set(value, t)

    def observe(self, name: str, value: float,
                t: Optional[float] = None,
                bounds: Sequence[float] = DEFAULT_BOUNDS) -> None:
        with self._lock:
            self.histogram(name, bounds=bounds).observe(value, t)

    # -- read APIs ---------------------------------------------------------

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Point-in-time copy of every metric's exported state."""
        out: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            for name, m in self._metrics.items():
                if isinstance(m, Counter):
                    out[name] = {"kind": "counter", "value": m.value}
                elif isinstance(m, Gauge):
                    out[name] = {"kind": "gauge", "value": m.value}
                else:
                    out[name] = {
                        "kind": "histogram",
                        "bounds": list(m.bounds),
                        "cumulative_counts": m.cumulative_counts(),
                        "sum": m.sum,
                        "count": m.count,
                    }
        return out

    def samples_since(self, name: str, since: float) -> List[Tuple[float, float]]:
        """Rolling-window samples of a gauge/histogram with
        ``t >= since`` (oldest first); [] for counters/unknown names —
        the SLO evaluator's one read primitive."""
        with self._lock:
            m = self._metrics.get(name)
            if m is None or not hasattr(m, "samples"):
                return []
            return [(t, v) for t, v in m.samples if t >= since]

    def view(self, **labels: str) -> "LabeledRegistry":
        """A label-scoped view of this registry (``view(tenant="a")``)
        — see :class:`LabeledRegistry`."""
        return LabeledRegistry(self, labels)


def _sanitize(key: str) -> str:
    """Telemetry keys to metric-name atoms ([a-zA-Z0-9_])."""
    return "".join(ch if ch.isalnum() or ch == "_" else "_" for ch in key)


# -- label dimension ----------------------------------------------------------
#
# A labeled metric lives in the registry under the canonical key
# ``name{k="v",...}`` (labels sorted by key).  The registry itself stays
# label-oblivious — every read/write API keys on the full string — which
# is exactly what lets label-scoped series flow through ``samples_since``
# and hence SLO specs unchanged: an SLO targeting
# ``serve_p99_ms{tenant="acme"}`` needs zero evaluator changes.  The
# exporter (obs/live/export.py) splits the key back apart to render
# Prometheus label syntax.

_LABEL_KEY_RE_CHARS = "label keys must match [a-zA-Z_][a-zA-Z0-9_]*"


def labeled_name(name: str, labels: Dict[str, str]) -> str:
    """Canonical registry key for ``name`` under a fixed label set.
    Loud on malformed labels — a typo'd label must fail at wiring, not
    render broken exposition."""
    if not labels:
        return name
    parts = []
    for k in sorted(labels):
        v = str(labels[k])
        if not k or not (k[0].isalpha() or k[0] == "_") or \
                not all(ch.isalnum() or ch == "_" for ch in k):
            raise ValueError(f"bad metric label key {k!r}: "
                             + _LABEL_KEY_RE_CHARS)
        if any(ch in v for ch in ('"', "\\", "\n")):
            raise ValueError(
                f"bad metric label value {v!r} for {k!r}: quotes, "
                "backslashes and newlines are not representable")
        parts.append(f'{k}="{v}"')
    return f"{name}{{{','.join(parts)}}}"


def split_labels(key: str) -> Tuple[str, str]:
    """Inverse of :func:`labeled_name` for the exporter: registry key ->
    ``(base name, rendered label body)`` — ``("serve_rows", 'tenant="a"')``
    for a labeled key, ``(key, "")`` for a flat one."""
    if key.endswith("}") and "{" in key:
        base, _, rest = key.partition("{")
        return base, rest[:-1]
    return key, ""


class LabeledRegistry:
    """A label-scoped view over a :class:`MetricRegistry`: every metric
    name is rewritten through :func:`labeled_name` with a fixed label
    set.  This is how per-tenant serving reuses tenant-agnostic
    components (AdmissionController, ShadowScorer, freshness probes)
    unchanged — hand them the view and their ``serve_shedding`` becomes
    ``serve_shedding{tenant="acme"}``."""

    def __init__(self, registry: "MetricRegistry", labels: Dict[str, str]):
        if not labels:
            raise ValueError("LabeledRegistry needs >= 1 label")
        self.base = registry
        self.labels = dict(labels)
        labeled_name("_probe", self.labels)  # validate loudly at wiring

    def _n(self, name: str) -> str:
        return labeled_name(name, self.labels)

    def counter(self, name: str, help: str = ""):
        return self.base.counter(self._n(name), help=help)

    def gauge(self, name: str, help: str = ""):
        return self.base.gauge(self._n(name), help=help)

    def histogram(self, name: str,
                  bounds: Sequence[float] = DEFAULT_BOUNDS,
                  help: str = ""):
        return self.base.histogram(self._n(name), bounds=bounds, help=help)

    def inc(self, name: str, amount: float = 1.0) -> None:
        self.base.inc(self._n(name), amount)

    def set(self, name: str, value: float,
            t: Optional[float] = None) -> None:
        self.base.set(self._n(name), value, t)

    def observe(self, name: str, value: float,
                t: Optional[float] = None,
                bounds: Sequence[float] = DEFAULT_BOUNDS) -> None:
        self.base.observe(self._n(name), value, t, bounds=bounds)

    def get(self, name: str):
        return self.base.get(self._n(name))

    def samples_since(self, name: str, since: float
                      ) -> List[Tuple[float, float]]:
        return self.base.samples_since(self._n(name), since)


class RegistrySink:
    """``MetricLogger`` adapter: telemetry records in, registry updates out.

    Mapping:

      * every record increments counter ``<phase>_rows`` (exported
      with Prometheus's ``_total`` suffix);
      * every numeric top-level key becomes gauge ``<phase>_<key>``
        sampled at the record's ``wall_time`` (so offline replay through
        ``watch`` sees the same timeline the live process saw);
      * ``phase="train"``: finite ``loss`` feeds the ``train_loss``
        histogram; a non-finite loss bumps counter ``train_nonfinite_loss``
        and the consecutive-streak gauge ``train_nonfinite_streak``
        (the divergence guard's pre-rollback early warning);
        ``emb_mag_mean``/``emb_mag_max`` additionally derive
        ``train_emb_mag_spread`` (max/mean — the norm-spread collapse
        signal); rank-stamped rows (obs.fleet) track per-rank max step
        and publish ``fleet_step_lag`` = max-over-ranks minus
        min-over-ranks (live straggler persistence);
      * ``phase="serve"``: ``p99_ms``/``p50_ms`` feed the
        ``serve_latency_ms`` histogram too.

    Non-finite values never reach a gauge (an SLO comparison against
    NaN would silently never fire).  The record dict is NEVER mutated,
    and ``log`` never raises — live obs must not alter or abort the
    stream it observes.
    """

    def __init__(self, registry: Optional[MetricRegistry] = None):
        self.registry = registry if registry is not None else MetricRegistry()
        self._nonfinite_streak = 0
        self._rank_steps: Dict[int, int] = {}

    # The envelope + identity keys that are not metric material.
    _SKIP = frozenset(
        ("step", "wall_time", "process_index", "process_count"))

    def log(self, record: Dict[str, Any]) -> None:
        try:
            self._ingest(record)
        except Exception:  # noqa: BLE001 — observing must not abort the run
            pass

    def _ingest(self, record: Dict[str, Any]) -> None:
        reg = self.registry
        phase = str(record.get("phase", "unknown"))
        t = record.get("wall_time")
        t = float(t) if isinstance(t, _NUMERIC) else None
        p = _sanitize(phase)
        # Tenant-stamped rows (multi-tenant serving) land on labeled
        # series — ``serve_p99_ms{tenant="a"}`` — so one tenant's signal
        # cannot hide in the aggregate.  Rows without the stamp map to
        # the same flat names as always.
        tenant = record.get("tenant")
        lab = {"tenant": tenant} if isinstance(tenant, str) and tenant \
            else {}
        reg.inc(labeled_name(f"{p}_rows", lab))
        event = record.get("event")
        if isinstance(event, str):
            # Lifecycle/event rows (resilience retry/rollback/preempt,
            # the serve_drain summary) are markers, not samples: the
            # drain summary carries WHOLE-RUN percentiles whose keys
            # collide with the window rows' — ingesting them as gauge
            # samples would re-fire a long-resolved p99 alert at the
            # final tick.  Count them; never gauge them.
            reg.inc(labeled_name(f"{p}_event_{_sanitize(event)}", lab))
            return
        step = record.get("step")
        if isinstance(step, _NUMERIC):
            reg.set(labeled_name(f"{p}_step", lab), float(step), t)
        for key, value in record.items():
            if key in self._SKIP or key in ("phase", "tenant") or \
                    not isinstance(value, _NUMERIC) or \
                    isinstance(value, bool):
                continue
            if not math.isfinite(value):
                continue
            reg.set(labeled_name(f"{p}_{_sanitize(key)}", lab),
                    float(value), t)
        if phase == "train":
            self._train_extras(record, t)
        elif phase == "serve":
            self._serve_extras(record, t, lab)

    def _train_extras(self, record: Dict[str, Any], t) -> None:
        reg = self.registry
        loss = record.get("loss")
        if isinstance(loss, _NUMERIC) and not isinstance(loss, bool):
            if math.isfinite(loss):
                self._nonfinite_streak = 0
                # _hist suffix: the generic mapping above already owns
                # the ``train_loss`` GAUGE name for this key.
                reg.observe("train_loss_hist", float(loss), t,
                            bounds=(0.1, 0.5, 1.0, 2.0, 5.0, 10.0, 50.0))
            else:
                self._nonfinite_streak += 1
                reg.inc("train_nonfinite_loss")
            reg.set("train_nonfinite_streak",
                    float(self._nonfinite_streak), t)
        mean = record.get("emb_mag_mean")
        mx = record.get("emb_mag_max")
        if isinstance(mean, _NUMERIC) and isinstance(mx, _NUMERIC) \
                and mean and math.isfinite(mean) and math.isfinite(mx):
            reg.set("train_emb_mag_spread", float(mx) / float(mean), t)
        rank = record.get("process_index")
        step = record.get("step")
        if isinstance(rank, int) and isinstance(step, _NUMERIC):
            self._rank_steps[rank] = max(
                self._rank_steps.get(rank, 0), int(step))
            if len(self._rank_steps) > 1:
                vals = self._rank_steps.values()
                reg.set("fleet_step_lag", float(max(vals) - min(vals)), t)

    def _serve_extras(self, record: Dict[str, Any], t,
                      lab: Optional[Dict[str, str]] = None) -> None:
        name = labeled_name("serve_latency_ms", lab or {})
        for key in ("p50_ms", "p99_ms"):
            v = record.get(key)
            if isinstance(v, _NUMERIC) and math.isfinite(v):
                self.registry.observe(name, float(v), t)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass
