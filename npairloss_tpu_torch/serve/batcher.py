"""MicroBatcher — deadline-bounded query coalescing with backpressure.

The port's own copy of ``npairloss_tpu/serve/batcher.py`` (the port
imports nothing of the JAX package), with its ``serve.queue_stall``
failpoint and its hooks ``span_fn`` (``serve/batch`` around the
coalescing wait, ``serve/dispatch`` with its ``size`` around the
dispatch), ``on_batch`` (per-batch stats) and ``on_pick`` (the query
tracer's queue-wait/assemble boundary).

Serving traffic arrives one query at a time; the accelerator wants
fixed-shape micro-batches.  The batcher sits between them: callers
``submit()`` individual queries and get a ``Future``; a single
dispatcher thread coalesces queued queries until either the largest
padding bucket is full or the OLDEST queued query's latency deadline
expires, then hands the batch to ``dispatch_fn`` and distributes the
per-query results.

Admission is a BOUNDED queue, modeled on the training pipeline's
``DispatchController`` (pipeline/controller.py): when the engine falls
behind, ``submit`` raises :class:`QueueFullError` immediately —
reject-with-backpressure, never unbounded growth.  The caller (the
server front end) turns that into a rejected-request answer the client
can retry against another replica.

The deadline is measured from the first query's SUBMIT time, so queue
wait counts against it: a query never waits more than ``max_delay_ms``
for co-riders before its batch dispatches (dispatch+compute time is on
top — bound it by warming the engine, docs/SERVING.md).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import logging
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from npairloss_tpu_torch.resilience import failpoints

log = logging.getLogger("npairloss_tpu_torch.serve")

_STOP = object()


class QueueFullError(RuntimeError):
    """Admission queue at capacity — backpressure, client should retry."""


@dataclasses.dataclass(frozen=True)
class BatcherConfig:
    """``max_batch`` is the largest co-ridership (the engine's largest
    padding bucket); ``max_delay_ms`` the added-latency budget a query
    may spend waiting for co-riders; ``max_queue`` the admission bound
    beyond which submits are rejected."""

    max_batch: int = 32
    max_delay_ms: float = 5.0
    max_queue: int = 256

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")


class MicroBatcher:
    """``start()`` -> ``submit(item) -> Future`` -> ``close(drain=...)``.

    ``dispatch_fn(items)`` receives the coalesced list and must return
    one result per item, in order; an exception fails every future in
    the batch (the server answers each with an error record).

    ``on_batch`` (optional) receives a stats dict per dispatched batch;
    ``span_fn`` (optional) is a telemetry ``span(name, **args)`` factory
    for the ``serve/batch``/``serve/dispatch`` spans; ``on_pick``
    (optional) receives each item the instant the dispatcher pulls it
    off the queue into the forming batch — the queue-wait/assemble
    boundary per-query tracing needs (``obs.qtrace``).
    """

    def __init__(
        self,
        dispatch_fn: Callable[[List[Any]], Sequence[Any]],
        cfg: BatcherConfig = BatcherConfig(),
        span_fn=None,
        on_batch: Optional[Callable[[Dict[str, Any]], None]] = None,
        on_pick: Optional[Callable[[Any], None]] = None,
    ):
        self.cfg = cfg
        self._dispatch_fn = dispatch_fn
        self._span_fn = span_fn
        self._on_batch = on_batch
        self._on_pick = on_pick
        self._q: queue.Queue = queue.Queue(maxsize=cfg.max_queue)
        self._thread: Optional[threading.Thread] = None
        self._closed = threading.Event()
        # Serializes the closed-check + enqueue in submit() against
        # close() setting the flag: without it a racing submit can land
        # its item BEHIND the _STOP sentinel, where the dispatcher never
        # sees it and the future hangs until the caller's timeout.
        self._admit_lock = threading.Lock()
        self.batches = 0
        self.dispatched = 0
        self.rejected = 0

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "MicroBatcher":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="serve-batcher", daemon=True
            )
            self._thread.start()
        return self

    def close(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop accepting and shut the dispatcher down.

        ``drain=True`` (the SIGTERM contract): every already-admitted
        query is dispatched and answered before the thread exits — zero
        dropped in-flight queries.  ``drain=False`` fails pending
        futures with :class:`QueueFullError` instead.
        """
        with self._admit_lock:
            # Under the lock no submit is between its closed-check and
            # its enqueue, so every admitted item is already in the
            # queue and the sentinel below is guaranteed to land last.
            self._closed.set()
        if self._thread is None:
            return
        if not drain:
            # Fail whatever is still queued; the sentinel below stops
            # the loop before it can pick more work up.
            pending = []
            with contextlib.suppress(queue.Empty):
                while True:
                    pending.append(self._q.get_nowait())
            for item in pending:
                if item is not _STOP:
                    item[1].set_exception(
                        QueueFullError("batcher closed without drain")
                    )
        # The sentinel lands BEHIND any admitted work, so a draining
        # close processes the whole queue first.
        self._q.put(_STOP)
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            log.error("batcher close: dispatcher did not drain in %.1fs",
                      timeout)
        self._thread = None

    # -- admission ---------------------------------------------------------

    @property
    def queue_depth(self) -> int:
        return self._q.qsize()

    def submit(self, item: Any) -> concurrent.futures.Future:
        """Admit one query; returns its Future.  Raises
        :class:`QueueFullError` when the admission queue is at capacity
        or the batcher is closing."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with self._admit_lock:
            if self._closed.is_set():
                # A refusal like a full queue: the front end counted the
                # query, so it must land in ``rejected``.
                self.rejected += 1
                raise QueueFullError("batcher is closed")
            try:
                self._q.put_nowait((item, fut, time.perf_counter()))
            except queue.Full:
                self.rejected += 1
                raise QueueFullError(
                    f"admission queue full ({self.cfg.max_queue}); retry"
                ) from None
        return fut

    # -- dispatcher --------------------------------------------------------

    def _span(self, name: str, **args):
        if self._span_fn is None:
            return contextlib.nullcontext()
        return self._span_fn(name, **args)

    def _loop(self) -> None:
        delay = max(self.cfg.max_delay_ms, 0.0) / 1e3
        while True:
            try:
                head = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            if head is _STOP:
                return
            if failpoints.should_fire("serve.queue_stall"):
                # Deterministic dispatcher stall: admissions pile up
                # behind the held queue (past max_queue, the
                # QueueFullError backpressure path) without touching the
                # dispatch math.
                time.sleep(failpoints.SERVE_QUEUE_STALL_S)
            if self._on_pick is not None:
                # After the stall, before coalescing: a stalled
                # dispatcher is queue wait, not assemble time.
                self._on_pick(head[0])
            batch = [head]
            deadline = head[2] + delay
            stop_after = False
            with self._span("serve/batch"):
                while len(batch) < self.cfg.max_batch:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    try:
                        item = self._q.get(timeout=remaining)
                    except queue.Empty:
                        break
                    if item is _STOP:
                        stop_after = True
                        break
                    if self._on_pick is not None:
                        self._on_pick(item[0])
                    batch.append(item)
            self._run_batch(batch)
            if stop_after:
                return

    def _run_batch(self, batch) -> None:
        items = [b[0] for b in batch]
        t0 = time.perf_counter()
        try:
            with self._span("serve/dispatch", size=len(items)):
                results = self._dispatch_fn(items)
            if len(results) != len(items):
                raise RuntimeError(
                    f"dispatch_fn returned {len(results)} results for "
                    f"{len(items)} items"
                )
        except Exception as e:  # noqa: BLE001 — fail the batch, not the loop
            for _, fut, _ in batch:
                if not fut.done():
                    fut.set_exception(e)
            log.error("batch dispatch failed (%d queries): %s",
                      len(items), e)
            return
        now = time.perf_counter()
        for (_, fut, _), res in zip(batch, results):
            fut.set_result(res)
        self.batches += 1
        self.dispatched += len(items)
        if self._on_batch is not None:
            self._on_batch({
                "size": len(items),
                "dispatch_ms": (now - t0) * 1e3,
                "oldest_wait_ms": (t0 - batch[0][2]) * 1e3,
                "queue_depth": self._q.qsize(),
            })
