"""Counting shim over the port's transfer entry points — the
no-mid-window proof (port of ``npairloss_tpu/pipeline/syncguard.py``).

:class:`HostSyncMonitor` patches the two transfer entry points every
host<->device copy of the training loops goes through —
``device.upload`` ("put": the staging thread's batch placement, the
synchronous loop's ``_put``) and ``device.fetch`` ("get": the pipelined
loop's window read) — and records each call with its thread and whether
it happened inside an ``allowed()`` region (a window boundary).

Strict mode turns the record into an enforcement: a transfer on the
guarded (train-loop) thread outside an allowed region raises
:class:`SyncGuardViolation`.  The staging thread is exempt by design —
moving the copy OFF the step loop's thread is the whole point.  A
``float(tensor)``/``.item()`` bypasses the shim, so on a card strict
mode also runs each step's dispatch under
``torch.cuda.set_sync_debug_mode("error")`` (:meth:`dispatch_guard`),
where any synchronizing CUDA call raises.  The dispatch controller's
wait on a step's completion event stays outside that region, as JAX
keeps its ``block_until_ready`` on a token outside the transfer guard.

Activation: tests attach a monitor via ``Solver.sync_monitor``; a smoke
run sets ``NPAIRLOSS_PIPELINE_SYNC_GUARD=strict`` (or ``count``) and
the Solver picks it up via :func:`monitor_from_env`.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Any, Dict, List, Optional

from npairloss_tpu_torch import device as _device

ENV_VAR = "NPAIRLOSS_PIPELINE_SYNC_GUARD"


class SyncGuardViolation(RuntimeError):
    """A host transfer happened mid-window on the guarded thread."""


class HostSyncMonitor:
    """Context manager; patch scope = its ``with`` block.

    The thread that ENTERS the monitor is the guarded one.  Interceptions
    aggregate into integer counters (:meth:`counts`) so a long run under
    ``count`` mode holds O(1) memory; only forbidden calls keep a
    per-event ``{"op", "thread", "guarded_thread", "allowed"}`` record
    (:meth:`violations`).
    """

    def __init__(self, strict: bool = False):
        self.strict = strict
        self._counts: Dict[str, int] = {
            "put": 0, "get": 0, "put_guarded": 0, "get_guarded": 0,
        }
        self._violations: List[Dict[str, Any]] = []
        self._local = threading.local()
        self._guard_thread: Optional[int] = None
        self._orig_put = None
        self._orig_get = None
        self._lock = threading.Lock()

    # -- region control (the Solver marks window boundaries) ---------------

    @contextlib.contextmanager
    def allowed(self):
        """Mark a region (window boundary / setup) where host syncs on
        the guarded thread are legitimate."""
        prev = getattr(self._local, "allowed", False)
        self._local.allowed = True
        try:
            yield
        finally:
            self._local.allowed = prev

    @contextlib.contextmanager
    def dispatch_guard(self, device):
        """Strict mode on a card: the body runs under
        ``torch.cuda.set_sync_debug_mode("error")``, so any host sync
        there raises.  Otherwise a no-op."""
        if not (self.strict and getattr(device, "type", None) == "cuda"):
            yield
            return
        import torch

        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(prev)

    # -- interception ------------------------------------------------------

    def _record(self, op: str) -> None:
        thread = threading.get_ident()
        on_guard = thread == self._guard_thread
        allowed = (not on_guard) or getattr(self._local, "allowed", False)
        with self._lock:
            self._counts[op] += 1
            if on_guard:
                self._counts[op + "_guarded"] += 1
            if not allowed:
                self._violations.append({
                    "op": op,
                    "thread": thread,
                    "guarded_thread": on_guard,
                    "allowed": allowed,
                })
        if self.strict and not allowed:
            name = "upload" if op == "put" else "fetch"
            raise SyncGuardViolation(
                f"mid-window host sync: device.{name} on the step-loop "
                "thread outside a window boundary (the sync-free "
                "contract of the pipelined loop)")

    def violations(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._violations)

    def counts(self) -> Dict[str, int]:
        """{"put": n, "get": m, "put_guarded": ..., "get_guarded": ...}"""
        with self._lock:
            return dict(self._counts)

    def __enter__(self) -> "HostSyncMonitor":
        self._guard_thread = threading.get_ident()
        orig_put = self._orig_put = _device.upload
        orig_get = self._orig_get = _device.fetch
        monitor = self

        # Bind the originals into the closures (not monitor._orig_put at
        # call time): __exit__ on the loop thread nulls the attributes
        # while the staging thread may still be inside a wrapper.
        def upload(*args, **kwargs):
            monitor._record("put")
            return orig_put(*args, **kwargs)

        def fetch(*args, **kwargs):
            monitor._record("get")
            return orig_get(*args, **kwargs)

        _device.upload = upload
        _device.fetch = fetch
        return self

    def __exit__(self, *exc) -> None:
        if self._orig_put is not None:
            _device.upload = self._orig_put
        if self._orig_get is not None:
            _device.fetch = self._orig_get
        self._orig_put = self._orig_get = None


def monitor_from_env() -> Optional[HostSyncMonitor]:
    """Monitor per ``NPAIRLOSS_PIPELINE_SYNC_GUARD``: ``strict`` raises
    on violations, ``count``/``1`` records only, unset/``0`` -> None."""
    mode = os.environ.get(ENV_VAR, "").strip().lower()
    if mode in ("", "0", "off"):
        return None
    return HostSyncMonitor(strict=(mode == "strict"))
