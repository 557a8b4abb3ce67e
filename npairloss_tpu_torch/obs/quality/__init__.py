"""Quality observatory — online ANSWER-QUALITY observation for serving.
Port of ``npairloss_tpu/obs/quality``:

  * :mod:`report` — the versioned ``npairloss-quality-v1`` JSONL
    contract (``validate_quality_report`` IS the contract) and the
    read helpers ``prof --quality`` uses — stdlib only, self-contained;
  * :mod:`shadow` — the ShadowScorer: deterministic sampling of live
    queries, off-hot-path re-scoring against the flat exact oracle on
    the served index's device, per-window recall@{1,5,10} and score-gap
    rows through the run's telemetry and into ``quality.jsonl``;
  * :mod:`escalate` — the ProbeEscalator, the recall-burn remediation
    actuator: wider IVF probes per attempt, then the flat exact scan,
    each a fresh tier warmed off the serving path and hot-swapped in.

``shadow`` and ``escalate`` need torch (it builds a serve engine) and is imported by
its consumers; this ``__init__`` re-exports only the stdlib contract,
as JAX's does.
"""

from npairloss_tpu_torch.obs.quality.report import (
    QUALITY_SCHEMA,
    load_quality_report,
    quality_breaches,
    quality_summary,
    stale_shadow,
    validate_quality_report,
)

__all__ = [
    "QUALITY_SCHEMA",
    "load_quality_report",
    "quality_breaches",
    "quality_summary",
    "stale_shadow",
    "validate_quality_report",
]
