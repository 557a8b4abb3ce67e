"""A pool of rank processes on one machine: G spawned processes that join
one process group once and then run task after task — for tests on the
CPU (gloo) and for runs of several ranks that share one card.

    with RankPool(2, "file:///tmp/pg", device="cpu") as pool:
        out = pool.run(fn, arg)   # [fn(mesh, arg) on rank 0, on rank 1]

``fn`` is a module-level function (it is pickled by name) called as
``fn(mesh, *args)`` on every rank with that rank's ``parallel.mesh.Mesh``;
it returns something picklable (NumPy arrays, not tensors).  A task
that raises on one rank fails the call; the pool is then spent (a rank
may be waiting in a collective) and is closed.
"""

from __future__ import annotations

import queue
import traceback
from typing import Any, Callable, List, Optional

import torch


def _serve(rank: int, world: int, init: str, device, backend, threads: int,
           timeout_s: float, tasks, results) -> None:
    if threads:
        torch.set_num_threads(threads)
    from npairloss_tpu_torch.parallel.distributed import (
        initialize_distributed,
        shutdown_distributed,
    )
    from npairloss_tpu_torch.parallel.mesh import data_parallel_mesh

    try:
        initialize_distributed(init, world, rank, backend=backend,
                               device=device, timeout_s=timeout_s)
        mesh = data_parallel_mesh()
    except BaseException:  # noqa: BLE001 — reported to the parent
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, "ready"))
    try:
        while True:
            item = tasks.get()
            if item is None:
                break
            fn, args = item
            try:
                results.put((rank, True, fn(mesh, *args)))
            except BaseException:  # noqa: BLE001 — reported to the parent
                results.put((rank, False, traceback.format_exc()))
    finally:
        shutdown_distributed()


class RankPool:
    """``world`` spawned rank processes in one process group (``init``:
    a ``file://`` or ``tcp://`` URL), each on ``device`` over
    ``backend`` (None: the device's own, NCCL on a card, gloo on the
    CPU); ``threads`` caps each rank's torch threads (0: torch's
    default)."""

    def __init__(self, world: int, init: str, device="cpu",
                 backend: Optional[str] = None, threads: int = 1,
                 timeout_s: float = 300.0):
        ctx = torch.multiprocessing.get_context("spawn")
        self.world = int(world)
        self.timeout_s = float(timeout_s)
        self._tasks = [ctx.Queue() for _ in range(self.world)]
        self._results = ctx.Queue()
        self._procs = [
            ctx.Process(target=_serve, daemon=True,
                        args=(r, self.world, init, device, backend, threads,
                              self.timeout_s, self._tasks[r], self._results))
            for r in range(self.world)]
        for p in self._procs:
            p.start()
        try:
            self._collect()
        except BaseException:
            self.close()
            raise

    def _collect(self) -> List[Any]:
        out: List[Any] = [None] * self.world
        errors = []
        for _ in range(self.world):
            try:
                rank, ok, val = self._results.get(timeout=self.timeout_s)
            except queue.Empty:
                raise TimeoutError(
                    f"rank pool: no answer within {self.timeout_s:.0f} s "
                    f"(errors so far: {errors})") from None
            if not ok:
                errors.append(f"rank {rank}:\n{val}")
                # The other ranks may wait in a collective: do not wait
                # for them.
                break
            out[rank] = val
        if errors:
            self.close()
            raise RuntimeError("\n".join(errors))
        return out

    def run(self, fn: Callable, *args) -> List[Any]:
        """``fn(mesh, *args)`` on every rank; the results in rank order."""
        if not self._procs:
            raise RuntimeError("the rank pool is closed")
        for q in self._tasks:
            q.put((fn, args))
        return self._collect()

    def close(self) -> None:
        for q, p in zip(self._tasks, self._procs):
            if p.is_alive():
                q.put(None)
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        self._procs = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
