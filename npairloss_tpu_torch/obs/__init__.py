"""Run telemetry — port of ``npairloss_tpu/obs`` (its core and the
training and serving sides of its perf observatory and its fleet
observatory):

  * ``obs.sinks`` — structured metric sinks (JSONL / CSV / ring buffer /
    multiplex) behind the ``MetricLogger`` protocol;
  * ``obs.tracing`` — host-side span tracing to Chrome-trace JSON
    (Perfetto);
  * ``obs.health`` — training-health signals inside the step (grad /
    param / update norms, embedding magnitude, mined-pair hardness),
    gated by ``HealthConfig``;
  * ``obs.fleet`` — the rank stamp, per-rank file streams, the comms
    pricing, the fleet report and the merged timelines;
  * ``obs.perf`` — the step's FLOPs and bytes per region, the roofline,
    MFU, the step-time decomposition and the ``prof`` report;

tied together per run by ``obs.run.RunTelemetry`` (run dir with
``manifest.json`` + ``metrics.jsonl`` + ``trace.json``).  The live,
quality and query-trace observatories are not ported yet.
"""

from npairloss_tpu_torch.obs.fleet.stamp import FleetStamp, fleet_stamp
from npairloss_tpu_torch.obs.health import HealthConfig
from npairloss_tpu_torch.obs.manifest import RunManifest
from npairloss_tpu_torch.obs.run import RunTelemetry
from npairloss_tpu_torch.obs.sinks import (
    FLEET_KEYS,
    REQUIRED_KEYS,
    CsvSink,
    JsonlSink,
    MetricLogger,
    MultiSink,
    RingBufferSink,
)
from npairloss_tpu_torch.obs.tracing import SpanTracer, validate_chrome_trace

__all__ = [
    "HealthConfig",
    "RunManifest",
    "RunTelemetry",
    "FleetStamp",
    "fleet_stamp",
    "MetricLogger",
    "JsonlSink",
    "CsvSink",
    "RingBufferSink",
    "MultiSink",
    "SpanTracer",
    "validate_chrome_trace",
    "REQUIRED_KEYS",
    "FLEET_KEYS",
]
