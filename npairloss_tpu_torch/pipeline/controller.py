"""Bounded dispatch depth — a semaphore on in-flight steps (port of
``npairloss_tpu/pipeline/controller.py``).

Kernel launches are asynchronous: without a bound, a sync-free loop can
queue step after step against a card that has fallen behind, holding a
staged batch and its host work per queued step.  The controller admits
at most ``max_in_flight`` dispatched steps: before dispatching a new
one, the loop calls :meth:`reserve`, which waits on the OLDEST pending
step's completion token until the bound is respected.  A token is a
CUDA event recorded on the stream after a step (:func:`step_token`);
waiting on it synchronizes the host with device progress WITHOUT
transferring anything.  On the CPU a step has finished when its call
returns, so its token is a completed no-op.
"""

from __future__ import annotations

import collections


class _DoneToken:
    """The token of a step that ran to its end on the CPU."""

    __slots__ = ()

    def block_until_ready(self) -> None:
        return None


class _EventToken:
    """A CUDA event recorded on the current stream after a step."""

    __slots__ = ("event",)

    def __init__(self, device):
        import torch

        self.event = torch.cuda.Event()
        self.event.record(torch.cuda.current_stream(device))

    def block_until_ready(self) -> None:
        self.event.synchronize()


def step_token(device):
    """The completion token of the step just dispatched on ``device``."""
    if getattr(device, "type", str(device)) == "cuda":
        return _EventToken(device)
    return _DoneToken()


class DispatchController:
    """``reserve()`` before dispatch, ``admit(token)`` after.

    ``token`` is any object with ``block_until_ready()`` — in the Solver
    the :func:`step_token` of the step just dispatched.  ``blocked``
    counts how often ``reserve`` actually had to wait — a saturated
    pipeline shows ``blocked ~= steps``, an underfed one ~0.
    """

    def __init__(self, max_in_flight: int = 2):
        if max_in_flight < 1:
            raise ValueError(
                f"max_in_flight must be >= 1, got {max_in_flight}")
        self.max_in_flight = max_in_flight
        self._pending: collections.deque = collections.deque()
        self.blocked = 0

    @property
    def in_flight(self) -> int:
        return len(self._pending)

    def reserve(self) -> None:
        """Wait until another dispatch is within the bound."""
        while len(self._pending) >= self.max_in_flight:
            oldest = self._pending.popleft()
            oldest.block_until_ready()
            self.blocked += 1

    def admit(self, token) -> None:
        self._pending.append(token)

    def drain(self) -> None:
        """Wait until every admitted step has completed."""
        while self._pending:
            self._pending.popleft().block_until_ready()
