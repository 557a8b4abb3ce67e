"""ReplicaSet — N QueryEngine replicas behind one front end.

The port's copy of ``npairloss_tpu/serve/replicas.py``.  Each replica is
one :class:`~npairloss_tpu_torch.serve.engine.QueryEngine` with its OWN
:class:`~npairloss_tpu_torch.serve.batcher.MicroBatcher` (own admission
queue, own dispatcher thread), and the front end routes each submitted
query to the least-loaded live replica.  Replicas of one index share the
primary engine's device tensors, model and built kernels
(``QueryEngine(share_compiled_with=...)``), so one warmup warms the tier
and no replica copies the gallery; on the card each replica dispatches
on its own CUDA stream, so two replicas' batches overlap on the card.

Crash containment: the ``serve.replica_crash`` failpoint kills a replica
mid-dispatch — its in-flight batch, and every batch still queued on it,
REROUTES to a surviving replica (the server's ``_reroute``), and the
router stops sending it traffic: the crash is invisible to clients while
any replica survives.  Only a whole-tier loss fails the work to error
answers.  The front end's accounting invariant (``queries == answered +
errors + rejected``) holds through the crash.

Drain is per-replica: ``close(drain=True)`` drains every live replica's
queue to answers (the SIGTERM contract); a dead replica's queue drains
by rerouting, and fails loudly — never hangs — when no live replica
remains.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Any, Callable, List, Optional

from npairloss_tpu_torch.serve.batcher import (
    BatcherConfig,
    MicroBatcher,
    QueueFullError,
)

log = logging.getLogger("npairloss_tpu_torch.serve")


class ReplicaCrashError(RuntimeError):
    """A replica died (injected or real) and no live replica remains to
    absorb its work — with survivors the work reroutes instead, and
    this error never reaches a client."""


@dataclasses.dataclass
class Replica:
    """One engine + its batcher + liveness."""

    name: str
    engine: Any
    batcher: Optional[MicroBatcher] = None
    alive: bool = True


class ReplicaSet:
    """Route/submit/drain across N replicas.

    ``dispatch_factory(replica)`` returns the batcher dispatch callable
    for that replica (the server wires per-replica crash containment
    and the shared answer logic there); ``span_fn`` and ``on_batch`` go
    to every replica's batcher, whose dispatcher thread is that
    replica's lane in the trace.
    """

    def __init__(
        self,
        engines: List[Any],
        batcher_cfg: BatcherConfig,
        dispatch_factory: Callable[[Replica], Callable],
        span_fn=None,
        on_batch=None,
    ):
        if not engines:
            raise ValueError("ReplicaSet needs at least one engine")
        self.replicas: List[Replica] = []
        for i, engine in enumerate(engines):
            rep = Replica(name=f"r{i}", engine=engine)
            rep.batcher = MicroBatcher(dispatch_factory(rep), batcher_cfg,
                                       span_fn=span_fn, on_batch=on_batch)
            self.replicas.append(rep)
        # Rejections that never reached a batcher (no live replica) —
        # part of the aggregate ``rejected`` so the front-end invariant
        # holds even with the whole tier down.  Lock-guarded like every
        # other invariant term: concurrent HTTP submits against a down
        # tier must not lose counts.
        self.down_rejected = 0
        self._down_lock = threading.Lock()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ReplicaSet":
        for rep in self.replicas:
            rep.batcher.start()
        return self

    def close(self, drain: bool = True, timeout: float = 30.0) -> None:
        for rep in self.replicas:
            # A dead replica drains by rerouting its queued batches to
            # the survivors; with the whole tier down its dispatch
            # fails every batch fast, which IS its drain.
            rep.batcher.close(drain=drain, timeout=timeout)

    # -- routing -----------------------------------------------------------

    def pick(self) -> Replica:
        """Least-loaded live replica; raises
        :class:`~npairloss_tpu_torch.serve.batcher.QueueFullError` when the
        whole tier is down (counted in ``down_rejected``)."""
        live = [r for r in self.replicas if r.alive]
        if not live:
            with self._down_lock:
                self.down_rejected += 1
            raise QueueFullError("no live replicas")
        return min(live, key=lambda r: r.batcher.queue_depth)

    def submit(self, record):
        return self.pick().batcher.submit(record)

    # -- aggregates --------------------------------------------------------

    @property
    def alive_count(self) -> int:
        return sum(1 for r in self.replicas if r.alive)

    @property
    def queue_depth(self) -> int:
        return sum(r.batcher.queue_depth for r in self.replicas)

    @property
    def batches(self) -> int:
        return sum(r.batcher.batches for r in self.replicas)

    @property
    def dispatched(self) -> int:
        return sum(r.batcher.dispatched for r in self.replicas)

    @property
    def rejected(self) -> int:
        return (sum(r.batcher.rejected for r in self.replicas)
                + self.down_rejected)
