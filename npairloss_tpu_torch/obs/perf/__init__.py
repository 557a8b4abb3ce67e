"""Perf observatory, training side — port of ``npairloss_tpu/obs/perf``:

  * ``perf.costs`` — the one MFU helper;
  * ``perf.count`` — one step's FLOPs / bytes / collective bytes, total
    and per region (the counterpart of the JAX package's HLO cost
    model, ``perf.hlo``);
  * ``perf.roofline`` — the card's peaks + compute/memory/collective
    bound classification;
  * ``perf.decompose`` — step-time decomposition from the span streams,
    wall-reconciled;
  * ``perf.report`` — the versioned ``prof`` report artifact.

Entry point: ``python -m npairloss_tpu_torch prof --step train``.
"""

from npairloss_tpu_torch.obs.perf.costs import (
    PEAK_FLOPS,
    mfu_from_timing,
    peak_flops,
)
from npairloss_tpu_torch.obs.perf.count import (
    UNSCOPED,
    StepCounter,
    region_of,
)
from npairloss_tpu_torch.obs.perf.decompose import (
    SERVE_CATEGORIES,
    STEP_CATEGORIES,
    decompose_step_time,
    serve_latency_decomposition,
)
from npairloss_tpu_torch.obs.perf.report import (
    REPORT_SCHEMA,
    build_report,
    render_table,
    validate_report,
    write_report,
)
from npairloss_tpu_torch.obs.perf.roofline import (
    BOUND_CLASSES,
    ChipSpec,
    chip_peaks,
    classify,
)

__all__ = [
    "PEAK_FLOPS",
    "mfu_from_timing",
    "peak_flops",
    "UNSCOPED",
    "StepCounter",
    "region_of",
    "STEP_CATEGORIES",
    "SERVE_CATEGORIES",
    "decompose_step_time",
    "serve_latency_decomposition",
    "REPORT_SCHEMA",
    "build_report",
    "render_table",
    "validate_report",
    "write_report",
    "BOUND_CLASSES",
    "ChipSpec",
    "chip_peaks",
    "classify",
]
