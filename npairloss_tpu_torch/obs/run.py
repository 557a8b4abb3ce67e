"""RunTelemetry — one object tying a run directory to the telemetry parts;
port of ``npairloss_tpu/obs/run.py``.

A run directory is the on-disk unit of diagnosability:

    <run_dir>/manifest.json   provenance (obs.manifest.RunManifest)
    <run_dir>/metrics.jsonl   structured metric records (obs.sinks)
    <run_dir>/trace.json      host span timeline (obs.tracing, Perfetto)

``RunTelemetry`` owns the run_id, stamps every record with the required
``{run_id, step, wall_time, phase}`` envelope, multiplexes records to a
JSONL file + in-memory ring buffer (plus any extra sinks), and holds the
span tracer.  The Solver and the CLI emit through this one pipeline
instead of bespoke callbacks and hand-rolled JSON.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, Optional, Sequence

from npairloss_tpu_torch.obs.manifest import RunManifest
from npairloss_tpu_torch.obs.sinks import (
    JsonlSink,
    MetricLogger,
    MultiSink,
    RingBufferSink,
)
from npairloss_tpu_torch.obs.tracing import SpanTracer

METRICS_FILENAME = "metrics.jsonl"
MANIFEST_FILENAME = "manifest.json"
TRACE_FILENAME = "trace.json"


def _default_run_id() -> str:
    """Sortable, collision-resistant without coordination: UTC timestamp
    + pid + 2 random bytes (concurrent processes on one host share the
    second)."""
    rand = os.urandom(2).hex()
    return time.strftime("%Y%m%d-%H%M%S", time.gmtime()) + \
        f"-{os.getpid()}-{rand}"


class RunTelemetry:
    """Lifecycle: construct (creates the run dir and opens sinks) ->
    ``write_manifest`` -> ``log``/``span`` during the run -> ``close``
    (flushes sinks, writes trace.json).  Usable as a context manager.

    ``metrics=False`` gives a trace-only instance (the CLI's
    ``--trace-dir``); ``trace=False`` a metrics-only one.  ``ring``
    records (the last ``ring_capacity``) stay readable via
    ``.ring.records()`` for live introspection either way.
    ``extra_sinks`` get every row after the file and the ring: the live
    observatory's ``RegistrySink`` rides here, and never changes a byte
    of the file.

    ``fleet`` opts into rank-stamped multi-process telemetry: ``True``
    resolves the ambient rank identity (the process group's, or the
    harness override), an
    explicit :class:`obs.fleet.FleetStamp` passes through.  With a
    stamp, every metric row gains ``{process_index, process_count,
    local_device_ids}`` and the on-disk files switch to the rank-aware
    scheme (``telemetry.r<k>.jsonl`` / ``trace.r<k>.json`` /
    ``manifest.r<k>.json``) so N concurrent ranks sharing one run dir
    never interleave a stream.  With ``fleet=None`` (default) behavior
    — file names AND stream bytes — is identical to a run without
    fleet stamping; the parity is pinned by test.
    """

    def __init__(
        self,
        run_dir: str,
        run_id: Optional[str] = None,
        metrics: bool = True,
        trace: bool = True,
        ring_capacity: int = 1024,
        extra_sinks: Sequence[MetricLogger] = (),
        fleet=None,
    ):
        from npairloss_tpu_torch.obs.fleet.stamp import resolve_fleet

        self.run_dir = os.path.abspath(run_dir)
        os.makedirs(self.run_dir, exist_ok=True)
        self.run_id = run_id or _default_run_id()
        self.fleet = resolve_fleet(fleet)
        self._stamp = self.fleet.to_dict() if self.fleet else None
        # Consumers (Solver.train) gate their per-step emission on this:
        # a trace-only instance must not pay the per-step host sync that
        # materializing metric scalars costs — it would distort the very
        # host timeline the tracer exists to capture.
        self.metrics_enabled = bool(metrics)
        self.ring = RingBufferSink(ring_capacity)
        children: list = [self.ring]
        if metrics:
            children.insert(
                0, JsonlSink(os.path.join(self.run_dir,
                                          self._metrics_filename()))
            )
        children.extend(extra_sinks)
        self.sink: MetricLogger = MultiSink(children)
        self.tracer: Optional[SpanTracer] = SpanTracer() if trace else None
        if self.tracer is not None and self._stamp is not None:
            self.tracer.stamp = dict(self._stamp)
        self.manifest: Optional[RunManifest] = None
        self._closed = False

    # -- rank-aware path scheme -------------------------------------------

    def _metrics_filename(self) -> str:
        if self.fleet is None:
            return METRICS_FILENAME
        from npairloss_tpu_torch.obs.fleet.stamp import rank_metrics_name

        return rank_metrics_name(self.fleet.process_index)

    def _trace_filename(self) -> str:
        if self.fleet is None:
            return TRACE_FILENAME
        from npairloss_tpu_torch.obs.fleet.stamp import rank_trace_name

        return rank_trace_name(self.fleet.process_index)

    def _manifest_filename(self) -> str:
        if self.fleet is None:
            return MANIFEST_FILENAME
        from npairloss_tpu_torch.obs.fleet.stamp import rank_manifest_name

        return rank_manifest_name(self.fleet.process_index)

    # -- manifest ---------------------------------------------------------

    def write_manifest(
        self,
        config: Optional[Dict[str, Any]] = None,
        mesh: Optional[Dict[str, Any]] = None,
        extra: Optional[Dict[str, Any]] = None,
    ) -> str:
        """Collect + write ``manifest.json`` (``manifest.r<k>.json``
        under a fleet stamp); call once at run start."""
        self.manifest = RunManifest.collect(
            self.run_id, config=config, mesh=mesh, fleet=self._stamp,
            extra=extra,
        )
        return self.manifest.write(
            os.path.join(self.run_dir, self._manifest_filename())
        )

    # -- metric records ---------------------------------------------------

    def log(
        self,
        phase: str,
        step: int,
        metrics: Optional[Dict[str, Any]] = None,
        **extra: Any,
    ) -> Dict[str, Any]:
        """Emit one record with the required envelope stamped.  The
        caller's metric keys must not collide with the envelope (the
        envelope wins — a metric named "step" would corrupt every
        downstream consumer)."""
        record: Dict[str, Any] = {}
        if metrics:
            record.update(metrics)
        record.update(extra)
        record.update(
            run_id=self.run_id,
            step=int(step),
            wall_time=time.time(),
            phase=phase,
        )
        if self._stamp is not None:
            # Fleet identity on EVERY row: offline aggregation must be
            # able to attribute a row found anywhere (a copied stream, a
            # fan-out sink) without trusting its file name.
            record.update(self._stamp)
        self.sink.log(record)
        return record

    # -- spans ------------------------------------------------------------

    def span(self, name: str, **args: Any):
        """Tracer span, or a no-op context when tracing is disabled —
        call sites never need to branch."""
        if self.tracer is None:
            return contextlib.nullcontext()
        return self.tracer.span(name, **args)

    def instant(self, name: str, **args: Any) -> None:
        if self.tracer is not None:
            self.tracer.instant(name, **args)

    # -- lifecycle --------------------------------------------------------

    def flush(self) -> None:
        self.sink.flush()
        if self.tracer is not None:
            self.tracer.write(
                os.path.join(self.run_dir, self._trace_filename()))

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self.flush()
        finally:
            # Even when a flush/trace write fails (disk full), every
            # sink still gets its close call (MultiSink isolates
            # per-child) before the error propagates.
            self.sink.close()

    def __enter__(self) -> "RunTelemetry":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
