"""The process-group mesh and the dense engine's collectives — port of
``npairloss_tpu/parallel/mesh.py``.

The reference's distribution model is one MPI rank per GPU with
MPI_Allgather'd embeddings (npair_multi_class_loss.cu:17-43) and an
MPI_Allreduce of the database-role gradient (cu:462-489).  The JAX
package runs both as in-graph collectives under ``shard_map``; the port
keeps the reference's model: one process per device, and a
:class:`Mesh` that is a 1-D process group in ring order (host-major,
``parallel.plan.ring_device_order``).  Shard ``r`` of every global
batch is the ``r``-th position of that ring.

The collectives (:meth:`Mesh.all_gather`, :meth:`Mesh.all_reduce_sum`,
:meth:`Mesh.all_reduce_max`, :meth:`Mesh.shift`) order their results by
ring position.  A sum is the backend's all-reduce (about 2P bytes a
rank for P bytes of input): NCCL and gloo reduce each element once and
hand every rank the result, so every rank holds the same bits; no
float atomics.  Over gloo, tensors on a card go through host memory
(gloo takes CPU tensors).  A mesh of one shard without a process group
runs every collective as the identity.
"""

from __future__ import annotations

import dataclasses
import socket
import warnings
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from npairloss_tpu_torch.device import DeviceLike, resolve_device
from npairloss_tpu_torch.obs.perf import count
from npairloss_tpu_torch.ops.npair_loss import (
    NPairLossConfig,
    npair_loss_with_aux,
)

DEFAULT_AXIS = "dp"


@dataclasses.dataclass(frozen=True)
class _Rank:
    """One rank as ``plan.ring_device_order`` sees a device."""

    id: int
    process_index: int  # host index


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D data-parallel mesh over processes, one device each.

    ``rank`` is this process's shard index (its ring position), ``ring``
    the global ranks in ring order, ``hosts`` the host index of each
    ring position, ``device_ids`` each position's device index.
    ``backend`` is None for a mesh without a process group (one shard).
    """

    rank: int
    size: int
    device: torch.device
    ring: Tuple[int, ...] = (0,)
    hosts: Tuple[int, ...] = (0,)
    device_ids: Tuple[int, ...] = (0,)
    device_kind: str = ""
    backend: Optional[str] = None
    axis: str = DEFAULT_AXIS
    group: Any = dataclasses.field(default=None, compare=False, repr=False)

    # -- identity ----------------------------------------------------------

    @property
    def process_index(self) -> int:
        """This process's global rank (rank 0 writes the records and
        snapshots)."""
        return self.ring[self.rank]

    @property
    def is_primary(self) -> bool:
        return self.process_index == 0

    def devices(self) -> List[_Rank]:
        return [_Rank(r, h) for r, h in zip(self.ring, self.hosts)]

    @property
    def _stage(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"

    def _comm(self) -> bool:
        return self.backend is not None

    # -- collectives ---------------------------------------------------------

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The shards' ``t`` concatenated along dim 0 in ring order —
        MPI_Allgather's receive-buffer order (cu:31-38)."""
        if not self._comm():
            return t
        with count.collective(lambda: _nbytes(t) * self.size,
                              op="all_gather"):
            src = t.detach().contiguous()
            if self._stage:
                src = src.cpu()
            out = torch.empty(
                (self.size * src.shape[0],) + tuple(src.shape[1:]),
                dtype=src.dtype, device=src.device)
            with warnings.catch_warnings():
                # Newer torch renames it; the card's torch has this name.
                warnings.simplefilter("ignore", FutureWarning)
                dist.all_gather_into_tensor(out, src, group=self.group)
            if list(self.ring) != sorted(self.ring):
                n = src.shape[0]
                order = sorted(range(self.size), key=lambda p: self.ring[p])
                pos = {g: i for i, g in enumerate(order)}
                out = torch.cat([out[pos[p] * n:(pos[p] + 1) * n]
                                 for p in range(self.size)])
            return out.to(t.device)

    def _all_reduce(self, t: torch.Tensor, op, name: str) -> torch.Tensor:
        if not self._comm():
            return t
        with count.collective(lambda: _nbytes(t), op=name):
            buf = t.detach().clone(memory_format=torch.contiguous_format)
            if self._stage:
                buf = buf.cpu()
            dist.all_reduce(buf, op=op, group=self.group)
            return buf.to(t.device)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every shard's ``t`` (MPI_Allreduce, cu:462-489):
        the same bits on every rank."""
        return self._all_reduce(t, dist.ReduceOp.SUM, "all_reduce_sum")

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max over the shards (exact in any order)."""
        return self._all_reduce(t, dist.ReduceOp.MAX, "all_reduce_max")

    def agree(self, flag: bool) -> bool:
        """True iff ``flag`` holds on every rank."""
        if not self._comm():
            return bool(flag)
        dev = self.device if not self._stage else torch.device("cpu")
        t = torch.tensor([0 if flag else 1], dtype=torch.int32, device=dev)
        return not bool(self.all_reduce_max(t).item())

    def any(self, flag: bool) -> bool:
        """True iff ``flag`` holds on some rank."""
        return not self.agree(not flag)

    def shift(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """One ring hop: each tensor goes to the next ring position and
        the previous position's arrives — ring position r then holds
        what position r - 1 sent (the JAX ring's ``ppermute`` with
        perm ``i -> i + 1``, ``ring.py:150-175``)."""
        if self.size == 1:
            return list(tensors)
        nxt = self.ring[(self.rank + 1) % self.size]
        prv = self.ring[(self.rank - 1) % self.size]
        with count.collective(lambda: sum(_nbytes(t) for t in tensors),
                              op="shift"):
            sends = [t.detach().contiguous() for t in tensors]
            if self._stage:
                sends = [t.cpu() for t in sends]
            recvs = [torch.empty_like(t) for t in sends]
            ops = []
            for s, r in zip(sends, recvs):
                ops.append(dist.P2POp(dist.isend, s, nxt, self.group))
                ops.append(dist.P2POp(dist.irecv, r, prv, self.group))
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            return [r.to(t.device) for r, t in zip(recvs, tensors)]

    def barrier(self) -> None:
        if not self._comm():
            return
        if self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _device_kind(dev: torch.device) -> str:
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def data_parallel_mesh(device: DeviceLike = None,
                       axis: str = DEFAULT_AXIS) -> Mesh:
    """The mesh over every process of the process group, in ring order
    (host-major, then rank); without a process group, a one-shard mesh
    on ``device``.  ``device`` defaults to the one this process bound
    when it joined the group (``initialize_distributed``), else the
    card."""
    from npairloss_tpu_torch.parallel.distributed import bound_device
    from npairloss_tpu_torch.parallel.plan import ring_device_order

    if device is None:
        device = bound_device()
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        # The card this rank bound (initialize_distributed's set_device).
        dev = torch.device("cuda", torch.cuda.current_device())
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(rank=0, size=1, device=dev,
                    device_ids=(dev.index or 0,),
                    device_kind=_device_kind(dev), axis=axis)
    world, me = dist.get_world_size(), dist.get_rank()
    names: List[Any] = [None] * world
    dist.all_gather_object(names, (socket.gethostname(), dev.index or 0))
    host_of: dict = {}
    for host, _ in names:
        host_of.setdefault(host, len(host_of))
    ranks = [_Rank(r, host_of[names[r][0]]) for r in range(world)]
    ring = [d.id for d in ring_device_order(ranks)]
    return Mesh(rank=ring.index(me), size=world, device=dev,
                ring=tuple(ring),
                hosts=tuple(host_of[names[r][0]] for r in ring),
                device_ids=tuple(names[r][1] for r in ring),
                device_kind=_device_kind(dev), backend=dist.get_backend(),
                axis=axis)


def build_mesh(mp: int = 1, device: DeviceLike = None,
               axis: str = DEFAULT_AXIS) -> Mesh:
    """The 1-D data-parallel mesh.  ``mp > 1`` (the JAX package's dp x
    mp parameter sharding, ``parallel/partition.py``) is not ported."""
    if int(mp or 1) > 1:
        raise NotImplementedError(
            f"--mp {mp}: the dp x mp parameter sharding "
            "(parallel/partition.py, --mp, --partition-rules) is not "
            "ported yet (ROADMAP Queue 1, entry 'partition.py and --mp')")
    return data_parallel_mesh(device, axis)


def mesh_topology(mesh: Mesh, axis: str = DEFAULT_AXIS) -> dict:
    """JSON-able description of a mesh (the JAX package's keys): axes
    and sizes, each ring position's device index and owning process."""
    return {
        "axis": axis,
        "axes": {mesh.axis: int(mesh.size)},
        "devices": int(mesh.size),
        "device_ids": list(mesh.device_ids),
        "device_process": list(mesh.ring),
        "process_count": int(mesh.size),
        "process_index": int(mesh.process_index),
    }


def shard_batch(mesh: Mesh, batch, axis: str = DEFAULT_AXIS):
    """This rank's rows ``[r*n, (r+1)*n)`` of each global array of
    ``batch``, on its device (``n = rows // G``; loud on a remainder)."""
    from npairloss_tpu_torch.device import upload

    out = []
    for x in batch:
        rows = len(x)
        if rows % mesh.size:
            raise ValueError(f"a batch of {rows} rows does not divide over "
                             f"{mesh.size} shards")
        n = rows // mesh.size
        out.append(upload(x[mesh.rank * n:(mesh.rank + 1) * n], mesh.device))
    return tuple(out)


class _MeshSum(torch.autograd.Function):
    """The sum of every shard's tensor; its gradient is the sum of every
    shard's output gradient (each rank's loss reads the same sum)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce_sum(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce_sum(g.contiguous()), None


def mesh_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """:meth:`Mesh.all_reduce_sum` that autograd differentiates (each
    rank's gradient of the sum is the sum of the ranks' gradients)."""
    return _MeshSum.apply(x, mesh)


class _GatherRows(torch.autograd.Function):
    """All-gather whose gradient returns each shard's rows of the summed
    pool gradient (``grad_mode="true"``, JAX's autodiff through
    ``all_gather``)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.n = mesh, x.shape[0]
        return mesh.all_gather(x)

    @staticmethod
    def backward(ctx, g):
        mesh, n = ctx.mesh, ctx.n
        total = mesh.all_reduce_sum(g.contiguous())
        return total[mesh.rank * n:(mesh.rank + 1) * n], None


def gather_pool(mesh: Mesh, features: torch.Tensor, labels: torch.Tensor,
                differentiable: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gathered pool (features, labels), rank-major as MPI_Allgather
    orders it (JAX ``npair_loss.py:548-562``)."""
    f = features.float()
    total_f = (_GatherRows.apply(f, mesh) if differentiable
               else mesh.all_gather(f))
    return total_f, mesh.all_gather(labels)


def sharded_npair_loss_fn(mesh: Mesh,
                          cfg: NPairLossConfig = NPairLossConfig(),
                          axis: str = DEFAULT_AXIS,
                          matmul_precision: Optional[str] = None
                          ) -> Callable:
    """``f(features, labels) -> (loss, aux)`` of this rank: the
    reference's per-rank loss over the gathered pool, the database-role
    gradient all-reduced inside the hand-derived backward (cu:462-489)
    and merged 0.5/0.5 with the query-role one.  ``features``/``labels``
    are this rank's rows.  ``grad_mode="true"`` differentiates through
    the gather instead."""

    def fn(features, labels):
        true_grad = cfg.grad_mode != "reference"
        total_f, total_l = gather_pool(mesh, features, labels,
                                       differentiable=true_grad)
        return npair_loss_with_aux(
            features, labels, cfg, total_features=total_f,
            total_labels=total_l, rank=mesh.rank, num_shards=mesh.size,
            all_reduce=None if true_grad else mesh.all_reduce_sum,
            matmul_precision=matmul_precision)

    return fn
