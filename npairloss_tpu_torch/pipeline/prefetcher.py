"""Device-resident batch prefetch: host batches -> staged device batches
(port of ``npairloss_tpu/pipeline/prefetcher.py``).

:class:`DevicePrefetcher` runs a staging thread that pulls the loader's
batches and places them on the card *ahead of need* (depth-k
buffering, default 2), so the train loop's ``get()`` returns batches
that are already resident.  The loaders of ``data/loader.py`` upload
from pinned memory and augment on the card inside ``__next__``; pulling
``__next__`` on the staging thread moves that dispatch off the training
thread too.  There is ONE staging thread, so a loader's device
``Generator`` is drawn in batch order, as in the synchronous loop.

Stream order: on a card the staging thread issues its copies and
kernels on its own CUDA stream and records an event after each batch;
``get()`` makes the consumer's current stream wait on that event before
the batch is read, and marks every staged tensor as used on the
consumer's stream (``record_stream``), so the caching allocator cannot
hand its memory to the staging stream while the consumer still reads
it.

Failure contract (the loader's): an exception in the staging thread —
the ``pipeline.stage`` failpoint included — is queued and re-raised from
``get()`` as :class:`PrefetchStageError` carrying the batch index; the
thread exits and ``close()`` joins it.  ``staged``/``consumed`` count
batches through the stage, so a resume can reason about exactly which
batch index the pipeline died on.
"""

from __future__ import annotations

import contextlib
import logging
import queue
import threading
from typing import Callable, Iterator, Optional

from npairloss_tpu_torch.resilience import failpoints

log = logging.getLogger("npairloss_tpu_torch.pipeline")


class PrefetchStageError(RuntimeError):
    """The staging thread died; carries the batch index it died on."""

    def __init__(self, batch_index: int, cause: BaseException):
        super().__init__(
            f"pipeline staging failed at batch {batch_index}: "
            f"{type(cause).__name__}: {cause}")
        self.batch_index = batch_index


class _StageFailure:
    __slots__ = ("exc", "batch_index")

    def __init__(self, exc: BaseException, batch_index: int):
        self.exc = exc
        self.batch_index = batch_index


class _EndOfData:
    __slots__ = ()


def _tensors(obj):
    import torch

    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _tensors(o)


class DevicePrefetcher:
    """Iterator of device-resident batches, staged ``depth`` ahead.

    Args:
      batches: iterator of (inputs, labels) batches — host arrays, or a
        loader's device tensors.  Only the staging thread touches it.
      place: batch -> device batch; typically ``Solver._stage_batch``
        (``device.upload`` of both halves).
      depth: staged batches held ready (>= 1).  Device memory cost is
        ``depth`` extra batches — the price of never waiting on a copy.
      device: the batches' device; a CUDA device gives the staging
        thread its own stream (None or a CPU device: no streams).
      span: optional ``(name, **args) -> context`` (``Solver._span``,
        thread-safe): each staging put is recorded as a
        ``pipeline/stage`` span on the staging thread.
    """

    def __init__(self, batches: Iterator, place: Callable, depth: int = 2,
                 device=None, span: Optional[Callable] = None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._it = batches
        self._place = place
        self._device = device
        self._span = span
        self._stream = None
        if getattr(device, "type", None) == "cuda":
            import torch

            self._stream = torch.cuda.Stream(device)
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.staged = 0  # written by the staging thread only
        self.consumed = 0
        self._thread = threading.Thread(
            target=self._run, name="npairloss-pipeline-stage", daemon=True)
        self._thread.start()

    # -- staging thread ----------------------------------------------------

    def _stream_context(self):
        if self._stream is None:
            return contextlib.nullcontext()
        import torch

        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self._device))
        stack.enter_context(torch.cuda.stream(self._stream))
        return stack

    def _run(self):
        def put(item) -> bool:
            while not self._stop.is_set():
                try:
                    self._queue.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        with self._stream_context():
            while not self._stop.is_set():
                try:
                    try:
                        host = next(self._it)
                    except StopIteration:
                        put(_EndOfData())
                        return
                    failpoints.fire("pipeline.stage")
                    ctx = (self._span("pipeline/stage",
                                      batch_index=self.staged)
                           if self._span is not None
                           else contextlib.nullcontext())
                    with ctx:
                        dev = self._place(*host)
                        event = None
                        if self._stream is not None:
                            import torch

                            event = torch.cuda.Event()
                            event.record(self._stream)
                    self.staged += 1
                except BaseException as exc:  # surfaced in get()
                    put(_StageFailure(exc, self.staged))
                    return
                if not put((dev, event)):
                    return

    # -- consumer side -----------------------------------------------------

    def get(self):
        """Next device-resident batch; blocks only if staging is behind.

        Raises :class:`PrefetchStageError` when the staging thread died
        (the thread has already exited — ``close()`` just joins), and
        ``StopIteration`` when the batch iterator ended.
        """
        if self._stop.is_set():
            raise RuntimeError("prefetcher is closed")
        item = self._queue.get()
        if isinstance(item, _EndOfData):
            self._stop.set()
            raise StopIteration
        if isinstance(item, _StageFailure):
            self._stop.set()
            raise PrefetchStageError(item.batch_index, item.exc) from item.exc
        dev, event = item
        if event is not None:
            import torch

            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(event)
            for t in _tensors(dev):
                if t.is_cuda:
                    t.record_stream(consumer)
        self.consumed += 1
        return dev

    def __iter__(self):
        return self

    def __next__(self):
        return self.get()

    def close(self):
        """Stop staging and join the thread (drains the queue so a put
        blocked on a full queue can observe the stop event)."""
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
        if self._thread.is_alive():  # pragma: no cover - diagnostic only
            log.warning("pipeline staging thread did not join within 5s")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self._stop.set()
        except AttributeError:
            pass
