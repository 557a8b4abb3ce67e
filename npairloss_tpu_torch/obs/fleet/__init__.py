"""Fleet observatory (port of ``npairloss_tpu/obs/fleet``):

  * ``fleet.stamp`` — rank identity (``FleetStamp``) stamped on every
    metric row, trace and manifest, and the rank-aware path scheme
    (``telemetry.r<k>.jsonl``);
  * ``fleet.comms`` — collective attribution: the counted step's
    per-kind collective bytes (``obs.perf.count``) against the claims,
    and effective-bandwidth rows against the link's peak;
  * ``fleet.aggregate`` — offline straggler/skew analysis over all
    ranks' streams, the ``npairloss-fleet-report-v1`` artifact
    (``validate_fleet_report`` IS the contract);
  * ``fleet.merge_traces`` — per-rank Chrome traces folded into one
    Perfetto file with rank lanes and clock offsets, and the
    whole-system ``timeline.json``.

Stdlib only at import time.  Entry points: ``python -m
npairloss_tpu_torch prof --fleet RUNDIR`` and ``timeline RUNDIR``.
"""

from npairloss_tpu_torch.obs.fleet.aggregate import (
    COMMS_FILENAME,
    FLEET_REPORT_SCHEMA,
    build_fleet_report,
    load_rank_streams,
    render_fleet_table,
    validate_fleet_report,
    write_fleet_report,
)
from npairloss_tpu_torch.obs.fleet.comms import (
    KIND_OF_OP,
    comm_rows_from_counts,
    effective_bandwidth,
    grad_sync_claim_bytes,
    per_kind_from_counts,
)
from npairloss_tpu_torch.obs.fleet.merge_traces import (
    MERGED_TRACE_FILENAME,
    TIMELINE_FILENAME,
    merge_chrome_traces,
    merge_run_traces,
    merge_timeline,
)
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
    "COMMS_FILENAME",
    "FLEET_REPORT_SCHEMA",
    "build_fleet_report",
    "load_rank_streams",
    "render_fleet_table",
    "validate_fleet_report",
    "write_fleet_report",
    "KIND_OF_OP",
    "comm_rows_from_counts",
    "effective_bandwidth",
    "grad_sync_claim_bytes",
    "per_kind_from_counts",
    "MERGED_TRACE_FILENAME",
    "TIMELINE_FILENAME",
    "merge_chrome_traces",
    "merge_run_traces",
    "merge_timeline",
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
