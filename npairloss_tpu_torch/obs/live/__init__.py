"""Live observatory — the online half of the run telemetry.  Port of
``npairloss_tpu/obs/live`` (copies: the same registry mapping, SLO
evaluation, ``npairloss-alerts-v1`` records and Prometheus text as the
JAX package's, byte for byte on the same rows):

  * :mod:`registry`  — lock-guarded in-process metric registry
    (counters / gauges / fixed-bound histograms) fed by a
    ``MetricLogger``-protocol sink adapter, so the existing telemetry
    streams flow in with no new call sites;
  * :mod:`slo`       — declarative SLO specs (metric, target, rolling
    window, burn-rate threshold) loaded from JSON/TOML, evaluated
    incrementally over the registry's sample windows;
  * :mod:`alerts`    — severities, hysteresis/dedup, a firing→resolved
    lifecycle persisted as the versioned ``npairloss-alerts-v1`` JSONL
    contract (``validate_alert_log`` IS the contract);
  * :mod:`watchdogs` — domain SLOs wired to signals the port already
    computes (serve p99 / queue saturation, post-warmup compiles,
    non-finite-loss streaks, fleet straggler lag, snapshot/index
    staleness, embedding collapse, shadow recall);
  * :mod:`export`    — Prometheus text exposition (``/metrics``) and
    the localhost HTTP exporter the train side mounts;
  * :mod:`watch`     — the offline feed: tail a run directory's
    telemetry JSONL (per-rank files included) through the same
    evaluator — one engine, two feeds.

Every module here imports the stdlib only and touches no device, so
``watch`` runs on any box that holds the run directory.
"""

from npairloss_tpu_torch.obs.live.alerts import (
    ALERTS_SCHEMA,
    Alert,
    AlertEngine,
    load_alert_log,
    unresolved_alerts,
    validate_alert_log,
)
from npairloss_tpu_torch.obs.live.live import LiveObservatory
from npairloss_tpu_torch.obs.live.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricRegistry,
    RegistrySink,
)
from npairloss_tpu_torch.obs.live.slo import (
    SLOSpec,
    SLOStatus,
    SLOEvaluator,
    load_slo_config,
)
from npairloss_tpu_torch.obs.live.watchdogs import bench_floor_emb_per_sec, default_watchdogs
from npairloss_tpu_torch.obs.live.export import prometheus_text, start_http_exporter
from npairloss_tpu_torch.obs.live.watch import (
    reconcile_remediation,
    replay_records,
    watch_run_dir,
)

__all__ = [
    "ALERTS_SCHEMA",
    "Alert",
    "AlertEngine",
    "Counter",
    "Gauge",
    "Histogram",
    "LiveObservatory",
    "MetricRegistry",
    "RegistrySink",
    "SLOEvaluator",
    "SLOSpec",
    "SLOStatus",
    "bench_floor_emb_per_sec",
    "default_watchdogs",
    "load_alert_log",
    "load_slo_config",
    "prometheus_text",
    "reconcile_remediation",
    "replay_records",
    "start_http_exporter",
    "unresolved_alerts",
    "validate_alert_log",
    "watch_run_dir",
]
