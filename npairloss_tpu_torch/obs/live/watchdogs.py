"""Domain watchdogs — named SLO presets wired to signals the port
already computes.  Port of ``npairloss_tpu/obs/live/watchdogs.py`` (a
copy: the same specs, field for field, with one change — see
:func:`bench_floor_emb_per_sec`).

Each function returns an :class:`slo.SLOSpec` targeting a metric the
:class:`registry.RegistrySink` (or a freshness probe) already
publishes from the EXISTING telemetry streams — no new instrumentation
call sites.  ``default_watchdogs(kind)`` bundles the standard set per
run kind; an SLO config pulls them in by name (``"watchdogs":
["serve"]``) and can override any of them by restating the name
(each function's docstring says what its watchdog means).

Stdlib only, like the whole package.
"""

from __future__ import annotations

import json
from typing import List, Optional

from npairloss_tpu_torch.obs.live.slo import SLOSpec


# -- serve watchdogs ----------------------------------------------------------


def serve_p99(target_ms: float = 250.0, window_s: float = 30.0,
              severity: str = "critical") -> SLOSpec:
    """Tail latency: the serve window rows' p99 (the serving tier's
    operating target).  Fires when half the recent windows blow the
    bar — one slow window is noise, a burning half-minute is an
    incident."""
    return SLOSpec(
        name="serve_p99", metric="serve_p99_ms", op="<=",
        target=target_ms, window_s=window_s, burn_threshold=0.5,
        min_samples=2, severity=severity,
        description="serve p99 latency over the rolling window",
    )


def serve_queue_saturation(max_queue: int = 256,
                           fraction: float = 0.8,
                           window_s: float = 30.0) -> SLOSpec:
    """Admission-queue depth approaching the backpressure bound: the
    engine is falling behind offered load.  Past the bound, submits
    reject — this fires BEFORE clients start seeing QueueFullError."""
    return SLOSpec(
        name="serve_queue_saturation", metric="serve_queue_depth",
        op="<=", target=float(max_queue) * fraction, window_s=window_s,
        burn_threshold=0.5, min_samples=2, severity="warning",
        description="admission queue depth vs the backpressure bound",
    )


def post_warmup_compile(window_s: float = 3600.0) -> SLOSpec:
    """ANY post-warmup compile in the serving hot path is an SLO burn
    (the window row carries ``compiles_after_warmup`` only when > 0, and
    at 0 too after a re-warm).  The port's "compile" is a dispatch
    signature first met after warmup (``serve/engine.py``); the spec
    matches the JAX package's so one SLO config serves both."""
    return SLOSpec(
        name="serve_post_warmup_compile",
        metric="serve_compiles_after_warmup", op="<=", target=0.0,
        window_s=window_s, burn_threshold=0.01, min_samples=1,
        severity="warning",
        # The JAX package's words, kept so the two spec sets are equal.
        description="post-warmup XLA compiles in the serving hot path",
    )


def serve_recall_floor(k: int = 10, floor: float = 0.95,
                       window_s: float = 120.0,
                       severity: str = "critical") -> SLOSpec:
    """Online answer quality: the shadow scorer's live recall@K estimate vs the
    flat brute-force oracle.  An approximate index silently trading
    recall for speed is the regression the offline parity gate catches
    a build too late — this fires while it happens.  No shadow rows
    (``--shadow-rate 0``) = no samples = stays ok."""
    return SLOSpec(
        name="serve_recall_floor", metric=f"serve_recall_at_{k}",
        op=">=", target=floor, window_s=window_s, burn_threshold=0.5,
        min_samples=1, severity=severity,
        description=f"shadow-estimated recall@{k} vs the exact oracle",
    )


def serve_score_gap(max_gap: float = 0.05,
                    window_s: float = 120.0) -> SLOSpec:
    """The shadow scorer's companion signal: how much top-1 similarity
    the served answer leaves on the table vs the exact scan.  Recall
    can hold while scores quietly degrade (quantization drift) — the
    gap catches that earlier, at warning severity."""
    return SLOSpec(
        name="serve_score_gap", metric="serve_shadow_score_gap",
        op="<=", target=max_gap, window_s=window_s, burn_threshold=0.5,
        min_samples=1, severity="warning",
        description="shadow top-1 score gap vs the exact oracle",
    )


def index_staleness(max_age_s: float = 3600.0,
                    severity: str = "warning") -> SLOSpec:
    """Gallery freshness: the served index's commit age.  A retrieval
    tier answering from an hour-old gallery serves stale answers."""
    return SLOSpec(
        name="index_staleness", metric="serve_index_age_s", op="<=",
        target=max_age_s, window_s=max(max_age_s / 4, 60.0),
        burn_threshold=0.5, min_samples=1, severity=severity,
        description="age of the served gallery index commit",
    )


def model_staleness(max_age_s: float = 4 * 3600.0,
                    severity: str = "warning") -> SLOSpec:
    """Model freshness: wall age of the restored snapshot behind the
    encode path (absent-metric = ok for embedding-only serving)."""
    return SLOSpec(
        name="model_staleness", metric="serve_model_age_s", op="<=",
        target=max_age_s, window_s=max(max_age_s / 4, 60.0),
        burn_threshold=0.5, min_samples=1, severity=severity,
        description="wall age of the restored model snapshot",
    )


# -- train watchdogs ----------------------------------------------------------


def nonfinite_loss_streak(window_s: float = 120.0) -> SLOSpec:
    """Consecutive non-finite losses — the divergence guard's
    pre-rollback early warning: the guard acts at ``patience``; this
    pages at the FIRST streak so a human sees the run destabilizing
    before params are rolled back."""
    return SLOSpec(
        name="train_nonfinite_streak", metric="train_nonfinite_streak",
        op="<=", target=0.0, window_s=window_s, burn_threshold=0.25,
        min_samples=1, severity="critical",
        description="consecutive non-finite training losses",
    )


def train_throughput_floor(floor_emb_per_sec: float,
                           window_s: float = 600.0) -> SLOSpec:
    """Throughput vs a measured floor (needs ``--perf-metrics`` rows):
    a multi-day run silently degrading to half its measured emb/s.
    Pass :func:`bench_floor_emb_per_sec` (with margin) as the floor —
    on hardware that never measured one, don't arm this."""
    return SLOSpec(
        name="train_throughput_floor", metric="perf_emb_per_sec",
        op=">=", target=floor_emb_per_sec, window_s=window_s,
        burn_threshold=0.5, min_samples=2, severity="warning",
        description="training emb/s vs the committed bench floor",
    )


def snapshot_staleness(max_age_s: float = 1800.0) -> SLOSpec:
    """Time since the newest committed snapshot (fed by the snapshot
    probe): a stalled snapshot cadence silently converts the next
    preemption from a resume into lost hours."""
    return SLOSpec(
        name="snapshot_staleness", metric="train_snapshot_age_s",
        op="<=", target=max_age_s, window_s=max(max_age_s / 4, 60.0),
        burn_threshold=0.5, min_samples=1, severity="warning",
        description="age of the newest committed training snapshot",
    )


def embedding_collapse(threshold: float = 0.98,
                       window_s: float = 600.0) -> SLOSpec:
    """Embedding-space collapse from the health signals (needs
    ``--health-metrics`` rows): the mean negative-mining threshold
    (mean pairwise cosine of the mined frontier) trending to ~1 means
    every pair looks alike — the space is degenerating.  The
    companion norm-spread signal is ``train_emb_mag_spread`` (max/mean
    row norm, derived by the sink)."""
    return SLOSpec(
        name="embedding_collapse", metric="train_an_threshold_mean",
        op="<=", target=threshold, window_s=window_s,
        burn_threshold=0.5, min_samples=3, severity="warning",
        description="mean pairwise cosine of mined negatives "
                    "trending degenerate",
    )


def mining_margin_floor(floor: float = 0.05,
                        window_s: float = 600.0) -> SLOSpec:
    """Mining-health early warning (needs ``--health-metrics
    --mining-health`` rows): the mean AP−AN threshold margin — how far
    the mined positive frontier sits above the mined negative frontier.
    A margin collapsing to ~0 means every pair looks alike: the
    embedding-space collapse signature, visible as a quality TREND
    before ``an_threshold_mean`` crosses the collapse guard's bar."""
    return SLOSpec(
        name="mining_margin_floor", metric="train_ap_an_margin_mean",
        op=">=", target=floor, window_s=window_s, burn_threshold=0.5,
        min_samples=3, severity="warning",
        description="mean AP-AN mining-threshold margin (collapse trend)",
    )


def fleet_straggler(max_step_lag: float = 2.0,
                    window_s: float = 300.0) -> SLOSpec:
    """Persistent straggler lag across rank-stamped streams (the fleet
    observatory's offline skew report, live): max-minus-min of the
    per-rank step frontier.  Transient jitter self-heals; a rank
    persistently N steps behind is a sick host."""
    return SLOSpec(
        name="fleet_straggler", metric="fleet_step_lag", op="<=",
        target=max_step_lag, window_s=window_s, burn_threshold=0.5,
        min_samples=3, severity="warning",
        description="per-rank step-frontier lag (straggler persistence)",
    )


# -- presets ------------------------------------------------------------------


def bench_floor_emb_per_sec(margin: float = 0.5,
                            last_good_path: Optional[str] = None
                            ) -> Optional[float]:
    """A bench headline file's value (``{"payload": {"value": emb/s}}``)
    scaled by ``margin`` — a train-throughput floor.  Unlike the JAX
    package's, this has NO default file: the repo's committed headline
    was measured on a TPU, not on the card, so nothing is read unless
    ``last_good_path`` names a measurement taken on this hardware.
    None without a path, or when the file holds no positive value:
    DON'T arm the throughput watchdog on a floor you never measured."""
    if last_good_path is None:
        return None
    try:
        with open(last_good_path) as f:
            payload = json.load(f).get("payload") or {}
    except (OSError, ValueError):
        return None
    value = payload.get("value")
    if isinstance(value, (int, float)) and value > 0:
        return float(value) * float(margin)
    return None


def default_watchdogs(kind: str, max_queue: int = 256,
                      bench_floor: Optional[float] = None
                      ) -> List[SLOSpec]:
    """The standard watchdog set for a run kind.

    ``serve``: p99, queue saturation, post-warmup compiles, index +
    model staleness, shadow recall floor + score gap (quality SLOs —
    without shadow rows they simply never see a sample and stay ok).
    ``train``: non-finite streak, snapshot staleness, embedding
    collapse, mining-margin floor, fleet straggler lag, plus the
    throughput floor when ``bench_floor`` is given (see
    :func:`bench_floor_emb_per_sec` — never armed implicitly, a box
    must not page against another machine's bar).
    """
    if kind == "serve":
        return [
            serve_p99(),
            serve_queue_saturation(max_queue=max_queue),
            post_warmup_compile(),
            index_staleness(),
            model_staleness(),
            serve_recall_floor(),
            serve_score_gap(),
        ]
    if kind == "train":
        specs = [
            nonfinite_loss_streak(),
            snapshot_staleness(),
            embedding_collapse(),
            mining_margin_floor(),
            fleet_straggler(),
        ]
        if bench_floor is not None:
            specs.append(train_throughput_floor(bench_floor))
        return specs
    raise ValueError(
        f"unknown watchdog kind {kind!r} (expected 'train' or 'serve')")
