"""Device resolution and the fp32 parity switches — one place.

Every entry point of the port takes a ``device=`` argument and resolves
it here.  ``None`` means the card: the port serves on CUDA, and when no
card is present it raises instead of quietly running on the CPU.  Tests
and CPU smoke runs ask for ``"cpu"`` explicitly.

cuDNN convolutions default to TF32 on Ampere and later, which keeps
about three decimal digits and would break fp32 parity with the JAX
reference without a word; :func:`set_parity_precision` turns TF32 off
for both convolutions and matrix products.

:func:`upload` and :func:`fetch` are the port's own host<->device
transfer entry points; callers reach them as attributes of this module
(``device.upload``), so ``pipeline.syncguard.HostSyncMonitor`` can count
every transfer a loop makes.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def set_parity_precision() -> None:
    """Full-fp32 convolutions and matmuls (no TF32) — the JAX
    reference's HIGHEST precision."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); an explicit device
    is returned as a ``torch.device`` (a CUDA one still needs a card)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(CLI: --device cpu) to run on the CPU")
        set_parity_precision()
    return dev


def upload(data, device: torch.device) -> torch.Tensor:
    """A host array or tensor on ``device``.  To a card it goes from
    pinned memory by an asynchronous copy: a copy from pageable memory
    would make the host wait for the stream.  A tensor already there is
    returned as it is."""
    t = data if isinstance(data, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(data))
    if device.type == "cuda" and t.device.type == "cpu" \
            and not t.is_pinned():
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def fetch(t: torch.Tensor) -> np.ndarray:
    """A tensor's values on the host as a NumPy array: from a card, a
    synchronous device-to-host copy (the host waits for the stream).
    The pipelined loop's window read goes through here, so a sync
    monitor (``pipeline.syncguard``) sees it."""
    return t.detach().to("cpu").numpy()
