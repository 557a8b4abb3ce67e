"""Named failpoints — deterministic fault injection for resilience tests
(a copy of ``npairloss_tpu/resilience/failpoints.py``; stdlib only).

A failpoint is a named site in the codebase where a fault *may* be
injected: the call site asks ``should_fire(name)`` (or ``fire(name)``,
which raises) and the registry answers based on what tests or the
environment armed.  Production runs pay one dict lookup per site; an
unarmed registry never fires.

Arming, two ways:

  * programmatic (tests): ``arm(name, times=N)`` / ``disarm(name)``, or
    the ``armed(name, times=N)`` context manager;
  * environment (CLI smoke runs): ``NPAIRLOSS_FAILPOINTS`` holds a
    comma-separated ``name[:count[@delay]]`` list, e.g.
    ``NPAIRLOSS_FAILPOINTS="snapshot.save.io:2,data.worker"`` — parsed
    once at first use.  ``@delay`` skips the site's first ``delay``
    checks before the ``count`` fires begin
    (``train.collapse:160@60`` = 60 healthy steps, then 160 collapsed
    ones) — faults that must start MID-run, after snapshots/warmup
    exist, are armed this way instead of with wall-clock sleeps.

The vocabulary is the JAX package's (docs/RESILIENCE.md), so one
``NPAIRLOSS_FAILPOINTS`` value arms both packages alike.  The port wires
the five ``snapshot.*`` seams (``resilience/snapshot.py``,
``train/solver.py``), ``data.worker`` (``data/loader.py``),
``pipeline.stage`` (``pipeline/prefetcher.py``), ``step.nan_loss`` and
``train.collapse`` (``train/solver.py``), ``index.commit.crash``
(``serve/index.py``), the three ``wal.*`` seams (``resilience/wal.py``),
``serve.latency``, ``serve.queue_stall`` and ``serve.replica_crash``
(``serve/server.py``, ``serve/batcher.py``) and ``serve.recall_drop``
(``serve/engine.py``), ``serve.compile_storm`` (``serve/engine.py``'s
compile accounting) and ``serve.stale_model`` (``cli.py``'s serve probe,
which publishes the ages the staleness watchdogs and the hot-swap read).

  ==========================  =============================================
  ``snapshot.save.io``        transient OSError inside the snapshot write
                              (exercises the retry/backoff path)
  ``snapshot.restore.io``     transient OSError inside snapshot restore
  ``snapshot.commit.torn``    commit a snapshot whose manifest checksums
                              are wrong — a "torn"/corrupt snapshot the
                              resume validator must detect and skip
  ``snapshot.commit.crash``   die after the array write but before the
                              atomic rename (leaves only a tmp dir that
                              resume must never see)
  ``data.worker``             crash the data prefetch worker (exercises
                              bounded respawn)
  ``index.commit.crash``      die inside GalleryIndex.save's atomic
                              commit, after the previous index is
                              renamed aside but before the new one
                              lands (loaders must see old-or-new,
                              never a torn mix)
  ``pipeline.stage``          crash the pipelined loop's device staging
                              thread (exercises clean prefetcher drain +
                              resume, docs/PIPELINE.md)
  ``step.nan_loss``           replace the step's loss with NaN (exercises
                              the divergence guard; in the pipelined loop
                              the poison lands in the metric window at
                              the next boundary read)
  ``serve.latency``           sleep ``SERVE_LATENCY_FAULT_S`` inside the
                              serving dispatch (after warmup's path, so
                              warmed compiles stay fast) — deterministic
                              p99 spikes for driving the live-obs alert
                              lifecycle (docs/OBSERVABILITY.md §Live)
  ``serve.queue_stall``       stall the micro-batcher's dispatcher thread
                              before it drains the queue, so admissions
                              pile up — drives the queue-saturation
                              watchdog and the backpressure path
  ``serve.replica_crash``     kill one serving replica mid-dispatch
                              (serve/replicas.py): its in-flight batch
                              and queued batches REROUTE to a surviving
                              replica (zero client-visible errors), the
                              router stops selecting it, and the
                              remaining replicas absorb the load — the
                              front end's answered+errors+rejected
                              invariant must hold through the crash;
                              supports ``@delay`` arming so the crash
                              lands mid-window (docs/RESILIENCE.md
                              §Gameday)
  ``serve.stale_model``       add ``STALE_AGE_FAULT_S`` to the model age
                              the serving freshness probe publishes —
                              the model-staleness alert fires without
                              waiting real hours, driving the snapshot
                              hot-swap remediation (docs/RESILIENCE.md
                              §Remediation)
  ``serve.compile_storm``     count one PHANTOM post-warmup compile in
                              the query engine's compile accounting
                              (no real XLA compile happens) — drives
                              the post-warmup-compile watchdog and the
                              re-warm remediation; under the strict
                              compile guard it raises like a real one
  ``train.collapse``          force ``an_threshold_mean`` to 1.0 in the
                              emitted train row (telemetry/display see
                              a collapsing embedding space, the actual
                              state is untouched) — drives the
                              embedding-collapse watchdog and the
                              trainer-rollback remediation
  ``serve.recall_drop``       deterministically mis-probe the IVF top-C
                              selection for one warmed dispatch (the
                              centroid scan runs against the negated
                              query — worst clusters probed, recall
                              collapses, shapes/compile signatures
                              unchanged); supports ``name:count@delay``
                              arming like every failpoint — drives the
                              recall-floor watchdog and the
                              probe-escalation remediation
                              (docs/OBSERVABILITY.md §Quality)
  ``snapshot.commit.dirsync``  die after the atomic rename but before
                              the parent-directory fsync — the commit
                              landed in the page cache only, the
                              durability hole the dir-fsync exists to
                              close (docs/RESILIENCE.md §Durability)
  ``wal.append.torn``         truncate the WAL record mid-write (half
                              the framed bytes land) — recovery must
                              truncate the torn tail loudly and count
                              it, never replay garbage
  ``wal.rotate.crash``        die during segment rotation, after the
                              old segment's seal is written but before
                              the new segment file exists — recovery
                              must start a fresh segment
  ``wal.gc.crash``            die mid-GC, after some covered segments
                              are unlinked but not all — recovery must
                              tolerate the gap and replay is unaffected
                              (GC only ever removes sealed segments at
                              or below the checkpoint watermark)
  ==========================  =============================================

``times`` counts fires: an armed point fires its next ``times`` checks
then disarms itself (``times=None`` fires forever until ``disarm``).
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
from typing import Callable, Dict, Iterator, Optional

log = logging.getLogger("npairloss_tpu_torch.resilience")

ENV_VAR = "NPAIRLOSS_FAILPOINTS"

# Injected stall durations for the serving failpoints (seconds).  Module
# constants rather than per-arm parameters: the env-arming syntax only
# carries a count, and the alert-lifecycle tests need ONE deterministic
# magnitude comfortably above any real dispatch (0.25 s >> a warmed
# CPU top-k) yet short enough that a counted burst clears in seconds.
SERVE_LATENCY_FAULT_S = 0.25
SERVE_QUEUE_STALL_S = 0.25
# Age bump the serve.stale_model failpoint injects into the published
# model age (seconds) — far beyond any sane staleness target, so the
# watchdog fires on the first poisoned probe tick.
STALE_AGE_FAULT_S = 1e6


class InjectedFault(OSError):
    """The default fault an armed failpoint raises.

    An ``OSError`` so the transient-I/O retry paths treat an injection
    exactly like the real thing (a full disk, a flaky NFS mount)."""

    def __init__(self, name: str):
        super().__init__(f"injected fault at failpoint {name!r}")
        self.failpoint = name


class _Failpoint:
    __slots__ = ("name", "remaining", "exc_factory", "delay")

    def __init__(self, name: str, remaining: Optional[int],
                 exc_factory: Optional[Callable[[], BaseException]],
                 delay: int = 0):
        self.name = name
        self.remaining = remaining  # None = unlimited
        self.exc_factory = exc_factory
        self.delay = int(delay)  # checks to pass through before firing


_LOCK = threading.Lock()
_ARMED: Dict[str, _Failpoint] = {}
_ENV_LOADED = False


def _load_env_locked() -> None:
    global _ENV_LOADED
    if _ENV_LOADED:
        return
    _ENV_LOADED = True
    spec = os.environ.get(ENV_VAR, "")
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, count = part.partition(":")
        if not count and "@" in name:
            # "name@delay" shorthand: default count, delayed start.
            name, _, delay = name.partition("@")
        else:
            count, _, delay = count.partition("@")
        try:
            times = int(count) if count else 1
            skip = int(delay) if delay else 0
        except ValueError:
            log.warning("%s: bad count in %r — ignored", ENV_VAR, part)
            continue
        _ARMED[name] = _Failpoint(name, times, None, delay=skip)
        log.info("failpoint armed from env: %s (times=%d, delay=%d)",
                 name, times, skip)


def arm(name: str, times: Optional[int] = 1,
        exc: Optional[Callable[[], BaseException]] = None,
        delay: int = 0) -> None:
    """Arm ``name`` to fire its next ``times`` checks (None = forever).
    ``exc`` overrides the raised exception for ``fire`` sites;
    ``delay`` lets the first ``delay`` checks pass before the fires
    begin (a mid-run fault)."""
    with _LOCK:
        _load_env_locked()
        _ARMED[name] = _Failpoint(name, times, exc, delay=delay)


def disarm(name: str) -> None:
    with _LOCK:
        _ARMED.pop(name, None)


def reset() -> None:
    """Disarm everything and forget the env parse (test isolation)."""
    global _ENV_LOADED
    with _LOCK:
        _ARMED.clear()
        _ENV_LOADED = False


def _take(name: str) -> Optional[_Failpoint]:
    with _LOCK:
        _load_env_locked()
        fp = _ARMED.get(name)
        if fp is None:
            return None
        if fp.delay > 0:
            fp.delay -= 1
            return None
        if fp.remaining is not None:
            if fp.remaining <= 0:  # armed with times=0: never fires
                del _ARMED[name]
                return None
            fp.remaining -= 1
            if fp.remaining == 0:
                del _ARMED[name]
        return fp


def should_fire(name: str) -> bool:
    """True when ``name`` is armed (consumes one fire).  For call sites
    that inject by *doing* something (poisoning a value) rather than
    raising."""
    fired = _take(name) is not None
    if fired:
        log.warning("failpoint fired: %s", name)
    return fired


def fire(name: str) -> None:
    """Raise the armed fault at ``name``; no-op when unarmed."""
    fp = _take(name)
    if fp is None:
        return
    log.warning("failpoint fired: %s", name)
    raise (fp.exc_factory() if fp.exc_factory is not None
           else InjectedFault(name))


@contextlib.contextmanager
def armed(name: str, times: Optional[int] = 1,
          exc: Optional[Callable[[], BaseException]] = None) -> Iterator[None]:
    """Scoped arming — disarms on exit even when the body raises."""
    arm(name, times=times, exc=exc)
    try:
        yield
    finally:
        disarm(name)
