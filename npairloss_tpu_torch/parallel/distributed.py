"""Multi-process runtime — the MPI_COMM_WORLD replacement; port of
``npairloss_tpu/parallel/distributed.py``.

The reference runs one MPI process per GPU; every collective spans
``MPI_COMM_WORLD`` (npair_multi_class_loss.cu:32, cu:467), launched as
``mpirun -np G caffe train ...``.  The port keeps that model: one process
per device over ``torch.distributed`` (NCCL on cards, gloo on the CPU),
and the mesh is a 1-D process group in ring order (``parallel.mesh``).

Launch recipes (the mpirun counterpart):

    torchrun --nproc-per-node N -m npairloss_tpu_torch train --mesh N ...

    # or one process per device, each with its own --process-id:
    python -m npairloss_tpu_torch train --mesh N \\
        --coordinator HOST:PORT --num-processes N --process-id I ...

``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``, ``LOCAL_RANK``) takes the place of the JAX package's
TPU-pod autodetect.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from npairloss_tpu_torch.device import DeviceLike, resolve_device

log = logging.getLogger("npairloss_tpu_torch.distributed")

_ENV_KEYS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")

# The device this process bound when it joined the process group.
_BOUND: dict = {}


def _rank_device(device: DeviceLike, local_rank: int) -> torch.device:
    """``device`` as given, a card without an index taking this
    process's local rank; ``None`` is ``cuda:{local_rank}``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    return resolve_device(dev)


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           device: DeviceLike = None,
                           timeout_s: float = 1800.0) -> bool:
    """Join the process group; returns True when this call created it.

    Must run before the first use of the device, as ``MPI_Init`` must
    precede any communicator use.  ``coordinator`` is ``HOST:PORT`` (or
    a full ``tcp://`` / ``file://`` init URL); the three arguments go
    together.  Without them, ``torchrun``'s environment is used when it
    is set; with neither the call is a no-op (a single-process run).

    Each rank binds ``cuda:{LOCAL_RANK}`` (``LOCAL_RANK`` from the
    environment, else ``process_id`` modulo the local card count) unless
    it is given ``device``.  The backend follows the device: ``nccl`` on
    a card, ``gloo`` on the CPU; an explicit ``backend`` is taken as
    given (two ranks sharing one card run gloo by declaration)."""
    env = os.environ
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if num_processes is not None and int(num_processes) != world:
            raise RuntimeError(
                f"a process group of {world} ranks is already up; "
                f"--num-processes {num_processes} does not match it")
        return False
    given = [a is not None for a in (coordinator, num_processes, process_id)]
    if any(given):
        if not all(given):
            raise ValueError("--coordinator, --num-processes and "
                             "--process-id go together")
        init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        world, rank = int(num_processes), int(process_id)
    elif all(k in env for k in _ENV_KEYS):
        init = "env://"
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
    else:
        return False
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} outside [0, {world})")
    if "LOCAL_RANK" in env:
        local = int(env["LOCAL_RANK"])
    else:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        local = rank % cards if cards else 0
    dev = _rank_device(device, local)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _BOUND["device"] = dev
    log.info("process group up: rank %d/%d over %s on %s", rank, world,
             backend, dev)
    return True


def shutdown_distributed() -> None:
    """Leave the process group (every rank calls it); a no-op without
    one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _BOUND.clear()


def bound_device() -> Optional[torch.device]:
    """The device this process bound in :func:`initialize_distributed`."""
    return _BOUND.get("device")


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_topology() -> dict:
    """This process's identity: ``{process_index, process_count,
    local_device_ids}`` — the JAX package's keys; one device per
    process."""
    dev = bound_device()
    return {
        "process_index": process_index(),
        "process_count": process_count(),
        "local_device_ids": [dev.index or 0] if dev is not None else [0],
    }


def process_local_batch(mesh, batch, axis: str = "dp"):
    """This rank's rows of the global batch, on its device.  With one
    device per process there is nothing to assemble: the rows a rank
    loaded are its shard (the reference's per-rank MultibatchData,
    cu:17-43)."""
    from npairloss_tpu_torch.device import upload

    return tuple(upload(x, mesh.device) for x in batch)
