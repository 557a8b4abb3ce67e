"""Graceful preemption: SIGTERM/SIGINT -> finish the step, snapshot, exit
(a copy of ``npairloss_tpu/resilience/preempt.py``; stdlib only).

At pod scale preemptions and maintenance events are routine, not
exceptional: the difference between losing ``snapshot`` iterations and
losing none is catching the signal, finishing the in-flight step,
committing an emergency snapshot, and exiting with a code the
supervisor understands (:data:`EXIT_PREEMPTED`, BSD ``EX_TEMPFAIL`` —
"transient, relaunch me") so it relaunches with ``--resume auto``.

:class:`PreemptionSignal` is the sticky flag between the async signal
world and the synchronous train loop: handlers only set an event; the
Solver polls ``requested`` once per step and does the actual work on
its own thread.  A second Ctrl-C escalates to the normal
``KeyboardInterrupt`` so an operator can still hard-kill a wedged run.
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Iterable, Optional

log = logging.getLogger("npairloss_tpu_torch.resilience")

# BSD sysexits EX_TEMPFAIL: transient failure, safe to relaunch.  The
# supervisor contract (docs/RESILIENCE.md): rc == EXIT_PREEMPTED means
# "relaunch with --resume auto"; rc == 0 means done; anything else is a
# real error.
EXIT_PREEMPTED = 75


class TrainingPreempted(RuntimeError):
    """Raised by ``Solver.train`` after the emergency snapshot landed."""

    def __init__(self, step: int, snapshot_path: Optional[str] = None,
                 signum: Optional[int] = None):
        name = signal.Signals(signum).name if signum is not None else "request"
        super().__init__(
            f"training preempted by {name} at iteration {step}"
            + (f" (snapshot: {snapshot_path})" if snapshot_path else "")
        )
        self.step = step
        self.snapshot_path = snapshot_path
        self.signum = signum


class PreemptionSignal:
    """Sticky stop-after-this-step flag, settable from a signal handler
    or programmatically (``request()``).

    Use as a context manager around training to install/restore the
    handlers; ``install`` is a no-op off the main thread (CPython only
    allows signal handlers there), so embedded/threaded callers can
    still drive ``request()`` by hand.
    """

    def __init__(self,
                 signals: Iterable[int] = (signal.SIGTERM, signal.SIGINT)):
        self._signals = tuple(signals)
        self._event = threading.Event()
        self._prev: dict = {}
        self.signum: Optional[int] = None

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def request(self, signum: Optional[int] = None) -> None:
        self.signum = signum
        self._event.set()

    def _handler(self, signum, frame):
        if self._event.is_set() and signum == signal.SIGINT:
            # Second Ctrl-C: the operator wants out NOW.
            raise KeyboardInterrupt
        log.warning(
            "received %s — will snapshot and exit after the in-flight step",
            signal.Signals(signum).name,
        )
        self.request(signum)

    def install(self) -> "PreemptionSignal":
        if threading.current_thread() is not threading.main_thread():
            log.warning(
                "PreemptionSignal.install skipped: signal handlers are "
                "main-thread-only (use .request() to stop programmatically)"
            )
            return self
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def uninstall(self) -> None:
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev)
            except (ValueError, OSError):  # interpreter teardown
                pass
        self._prev.clear()

    def __enter__(self) -> "PreemptionSignal":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()
