"""Structured metric sinks — the one emission pipeline for run telemetry;
port of ``npairloss_tpu/obs/sinks.py`` (a copy: the port imports nothing
of the JAX package).

A ``MetricLogger`` protocol with file (JSONL/CSV), in-memory (ring
buffer) and fan-out (multiplex) implementations.  Every record is a
flat dict; stamping the required ``{run_id, step, wall_time, phase}``
envelope is ``obs.run.RunTelemetry``'s job, so sinks stay dumb and
composable.

Stdlib only: a process without torch can load it by file path.
"""

from __future__ import annotations

import collections
import csv
import json
import os
import threading
from typing import Any, Dict, List, Optional, Protocol, Sequence, runtime_checkable

# The envelope every emitted record carries (stamped by RunTelemetry;
# validated by tests and by downstream consumers of metrics.jsonl).
REQUIRED_KEYS = ("run_id", "step", "wall_time", "phase")

# The ADDITIONAL envelope of fleet-stamped records: rank identity on
# every row of a multi-process run.  Spelled out here (not imported from
# obs.fleet.stamp, which pins the same tuple by test) so that loading
# this module by file path drags nothing else in.
FLEET_KEYS = ("process_index", "process_count", "local_device_ids")


@runtime_checkable
class MetricLogger(Protocol):
    """Anything that accepts structured metric records.

    ``log`` takes one flat dict per event; values should be JSON-able
    scalars (floats/ints/strings).  ``flush``/``close`` are lifecycle
    hooks — file sinks flush buffers, in-memory sinks no-op.
    """

    def log(self, record: Dict[str, Any]) -> None: ...

    def flush(self) -> None: ...

    def close(self) -> None: ...


class JsonlSink:
    """Append-only JSON-lines file sink — one record per line.

    Line-buffered so a killed process loses at most the current line
    (partial telemetry beats no telemetry).
    Parent directories are created on demand.
    """

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._f = open(self.path, "a", buffering=1)
        self._lock = threading.Lock()

    def log(self, record: Dict[str, Any]) -> None:
        line = json.dumps(record, default=str)
        with self._lock:
            self._f.write(line + "\n")

    def flush(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


class CsvSink:
    """CSV file sink for spreadsheet-shaped consumers.

    Columns are fixed by the FIRST record (plus any ``fieldnames`` given
    up front); later records with extra keys have them dropped and
    missing keys filled with "" — CSV cannot grow columns after the
    header, so put the stable keys first or pass ``fieldnames``.
    """

    def __init__(self, path: str, fieldnames: Optional[Sequence[str]] = None):
        self.path = os.path.abspath(path)
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        # Appending to an existing file must reuse ITS header, not the
        # first record's key order — otherwise a second process/instance
        # silently writes values under the wrong columns.
        if fieldnames is None and os.path.exists(self.path) \
                and os.path.getsize(self.path) > 0:
            with open(self.path, newline="") as f:
                header = next(csv.reader(f), None)
            if header:
                fieldnames = header
        self._f = open(self.path, "a", buffering=1, newline="")
        self._fieldnames = list(fieldnames) if fieldnames else None
        self._writer: Optional[csv.DictWriter] = None
        self._lock = threading.Lock()

    def log(self, record: Dict[str, Any]) -> None:
        with self._lock:
            if self._writer is None:
                if self._fieldnames is None:
                    self._fieldnames = list(record.keys())
                self._writer = csv.DictWriter(
                    self._f, self._fieldnames, restval="",
                    extrasaction="ignore",
                )
                if self._f.tell() == 0:
                    self._writer.writeheader()
            self._writer.writerow(record)

    def flush(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


class RingBufferSink:
    """Bounded in-memory sink: keeps the most recent ``capacity`` records.

    The live-introspection sink — a training loop (or an embedding
    process) can read the recent trajectory without touching disk; old
    records evict FIFO so memory stays bounded over million-step runs.
    """

    def __init__(self, capacity: int = 1024):
        if capacity < 1:
            raise ValueError(f"ring buffer needs capacity >= 1, got {capacity}")
        self.capacity = capacity
        self._buf: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._total = 0

    def log(self, record: Dict[str, Any]) -> None:
        with self._lock:
            self._buf.append(dict(record))
            self._total += 1

    def records(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._buf)

    def latest(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return dict(self._buf[-1]) if self._buf else None

    @property
    def total_logged(self) -> int:
        return self._total

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class MultiSink:
    """Fan one record out to several sinks (file + ring buffer is the
    RunTelemetry default).  A child failing must not starve its
    siblings — on log, flush, AND close: every child sees the call, then
    the first child error is re-raised."""

    def __init__(self, children: Sequence[MetricLogger]):
        self.children = list(children)

    def _fan(self, method: str, *args) -> None:
        first_err = None
        for c in self.children:
            try:
                getattr(c, method)(*args)
            except Exception as e:  # noqa: BLE001 — fan-out isolation
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise first_err

    def log(self, record: Dict[str, Any]) -> None:
        self._fan("log", record)

    def flush(self) -> None:
        self._fan("flush")

    def close(self) -> None:
        self._fan("close")
