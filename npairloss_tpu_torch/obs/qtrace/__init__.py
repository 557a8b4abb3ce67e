"""Query-level tracing: per-stage tail-latency attribution from socket
to answer.  Port of ``npairloss_tpu/obs/qtrace`` (stdlib only).

``QueryTracer`` assigns a trace id at ingestion and records one span
per serving-tier stage; exemplar span trees for SLO-violating and
slowest-tail queries land in the versioned ``npairloss-qtrace-v1``
artifact (contract: :mod:`npairloss_tpu_torch.obs.qtrace.report`), and
the rolling p99 budget decomposition surfaces in ``/healthz``, window
rows, and the drain summary.  ``timeline`` folds the exemplars and
markers into one Perfetto timeline next to the other lanes.
"""

from npairloss_tpu_torch.obs.qtrace.core import (
    QTraceConfig,
    QueryTrace,
    QueryTracer,
)
from npairloss_tpu_torch.obs.qtrace.report import (
    MARKER_NAMES,
    QTRACE_SCHEMA,
    STAGES,
    load_qtrace_report,
    qtrace_p99_consistency,
    validate_qtrace_report,
)

__all__ = [
    "MARKER_NAMES",
    "QTRACE_SCHEMA",
    "QTraceConfig",
    "QueryTrace",
    "QueryTracer",
    "STAGES",
    "load_qtrace_report",
    "qtrace_p99_consistency",
    "validate_qtrace_report",
]
