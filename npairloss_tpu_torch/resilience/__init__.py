"""Fault tolerance of the port (the first part of
``npairloss_tpu/resilience``):

  * ``resilience.snapshot`` — atomic snapshot commit (tmp dir + per-
    tensor CRC-32 manifest + fsync + rename) written with ``torch.save``,
    torn-snapshot validation, newest-valid discovery, retention GC;
  * ``resilience.retrying`` — jittered exponential backoff around
    snapshot I/O;
  * ``resilience.preempt`` — SIGTERM/SIGINT -> finish the step,
    emergency snapshot, exit :data:`EXIT_PREEMPTED` so a supervisor
    relaunches with ``--resume auto``;
  * ``resilience.failpoints`` — named fault-injection points
    (``NPAIRLOSS_FAILPOINTS`` or programmatic);
  * ``resilience.guard`` — the divergence guard (N consecutive
    non-finite losses -> rollback to a valid snapshot, or halt) and the
    externally requested rollback;
  * ``resilience.wal`` — the ``npairloss-wal-v1`` write-ahead log behind
    durable ingest (the JAX package's files byte for byte);
  * ``resilience.remediate`` — alert→actuation policies and the
    ``npairloss-remediation-v1`` audit log (a copy of the JAX module).
    Its actuators live beside what they act on: the re-warm and the
    hot-swap (``serve/hotswap.py``) in ``serve/``, probe escalation in
    ``obs/quality/escalate.py``, the trainer rollback in the solver.
"""

from npairloss_tpu_torch.resilience import failpoints
from npairloss_tpu_torch.resilience.failpoints import InjectedFault
from npairloss_tpu_torch.resilience.guard import (
    ACTIONS,
    DivergenceConfig,
    DivergenceError,
    DivergenceGuard,
    RollbackRequest,
)
from npairloss_tpu_torch.resilience.preempt import (
    EXIT_PREEMPTED,
    PreemptionSignal,
    TrainingPreempted,
)
from npairloss_tpu_torch.resilience.remediate import (
    RemediationEngine,
    RemediationPolicy,
    load_remediation_log,
    validate_remediation_log,
)
from npairloss_tpu_torch.resilience.retrying import (
    RetryPolicy,
    call_with_retry,
)
from npairloss_tpu_torch.resilience.snapshot import (
    SnapshotError,
    SnapshotValidationError,
    commit_snapshot,
    gc_snapshots,
    list_snapshots,
    quarantine_snapshots,
    read_manifest,
    snapshot_info,
    state_checksums,
    validate_snapshot,
    verify_restored,
)

__all__ = [
    "ACTIONS",
    "DivergenceConfig",
    "DivergenceError",
    "DivergenceGuard",
    "EXIT_PREEMPTED",
    "InjectedFault",
    "PreemptionSignal",
    "RemediationEngine",
    "RemediationPolicy",
    "RetryPolicy",
    "RollbackRequest",
    "SnapshotError",
    "SnapshotValidationError",
    "TrainingPreempted",
    "call_with_retry",
    "commit_snapshot",
    "failpoints",
    "gc_snapshots",
    "list_snapshots",
    "load_remediation_log",
    "quarantine_snapshots",
    "read_manifest",
    "snapshot_info",
    "state_checksums",
    "validate_remediation_log",
    "validate_snapshot",
    "verify_restored",
]
