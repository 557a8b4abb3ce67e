"""Fleet telemetry (port of ``npairloss_tpu/obs/fleet``): the rank stamp
and the per-rank path scheme.  The aggregator (``prof --fleet``), the
comms pricing and the trace merge are not ported yet (ROADMAP Queue 1,
item 10)."""

from npairloss_tpu_torch.obs.fleet.stamp import (
    FLEET_PROCESS_ENV,
    STAMP_KEYS,
    FleetStamp,
    discover_ranks,
    fleet_stamp,
    rank_manifest_name,
    rank_metrics_name,
    rank_trace_name,
    resolve_fleet,
)

__all__ = [
    "FLEET_PROCESS_ENV",
    "STAMP_KEYS",
    "FleetStamp",
    "discover_ranks",
    "fleet_stamp",
    "rank_manifest_name",
    "rank_metrics_name",
    "rank_trace_name",
    "resolve_fleet",
]
