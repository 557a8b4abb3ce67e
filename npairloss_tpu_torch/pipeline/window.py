"""Device-side metric ring for the sync-free step loop (port of
``npairloss_tpu/pipeline/window.py``).

In the synchronous loop every consumer of a step scalar (the loss
window, the divergence guard) materializes it on the host.
:class:`MetricWindow` moves the accumulation onto the card: each step's
metric scalars are written into a ``[capacity, len(keys)]`` fp32 ring
beside a position and a consecutive-non-finite-loss counter, all device
tensors written in place (so a captured CUDA graph writes them on every
replay), and the host reads the whole window back in ONE copy at
display/test/snapshot boundaries.

The keys are the sorted metric names, the order of the synchronous
step's dict, so the per-step rows :meth:`read` rebuilds carry the same
key stream as the synchronous loop.  Every metric of a step is an fp32
value (the learning rate too: the schedule rounds it to fp32), so a row
read back holds the synchronous loop's values bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence

import numpy as np
import torch

from npairloss_tpu_torch import device as _device


class MetricWindow:
    """``keys`` must be the sorted metric names of the step's dict;
    ``capacity`` is the most steps between host reads — memory cost is
    ``capacity * len(keys)`` fp32, trivial at any real cadence."""

    def __init__(self, keys: Sequence[str], capacity: int):
        if capacity < 1:
            raise ValueError(f"window capacity must be >= 1, got {capacity}")
        if "loss" not in keys:
            raise ValueError("metric keys must include 'loss' (the "
                             "non-finite counter watches it)")
        self.keys = tuple(keys)
        self.capacity = int(capacity)
        self._loss_idx = self.keys.index("loss")

    # -- device side (inside the captured step) ---------------------------

    def init_ring(self, device) -> Dict[str, torch.Tensor]:
        """Fresh ring state on ``device``."""
        zero = lambda: torch.zeros((), dtype=torch.int64,  # noqa: E731
                                   device=device)
        return {
            "buf": torch.zeros((self.capacity, len(self.keys)),
                               dtype=torch.float32, device=device),
            "pos": zero(),
            # Consecutive-non-finite-loss streak, carried ACROSS windows
            # (a streak spanning a boundary must not reset), plus the
            # window's max — the guard's cheap trip signal.
            "streak": zero(),
            "max_streak": zero(),
        }

    @torch.no_grad()
    def update(self, ring: Dict[str, torch.Tensor],
               metrics: Mapping[str, Any]) -> None:
        """One step's scalars into the ring, in place, with no host
        read.  The write index is clamped to the last row, as JAX's
        ``dynamic_update_index_in_dim`` clamps: an overflow (a missed
        boundary) never writes out of bounds, and :meth:`read` reports
        it from ``pos``."""
        buf = ring["buf"]
        vals = torch.stack([
            torch.as_tensor(metrics[k], device=buf.device)
            .to(torch.float32).reshape(()) for k in self.keys])
        row = torch.clamp(ring["pos"], max=self.capacity - 1)
        buf.index_copy_(0, row.reshape(1), vals.reshape(1, -1))
        ring["pos"].add_(1)
        finite = torch.isfinite(vals[self._loss_idx])
        streak = ring["streak"]
        streak.copy_(torch.where(finite, torch.zeros_like(streak),
                                 streak + 1))
        torch.maximum(ring["max_streak"], streak, out=ring["max_streak"])

    @torch.no_grad()
    def reset(self, ring: Dict[str, torch.Tensor]) -> None:
        """Rewind the write position for the next window, in place (the
        captured step keeps its addresses).  The streak survives;
        ``max_streak`` restarts as the streak in flight."""
        ring["buf"].zero_()
        ring["pos"].zero_()
        ring["max_streak"].copy_(ring["streak"])

    # -- host side ------------------------------------------------------------

    def fetch(self, ring: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
        """The ring on the host in ONE device-to-host copy
        (``device.fetch``, the transfer the sync monitor counts): the
        buffer and the three counters packed into one fp32 vector
        (counts below 2**24 are exact in fp32)."""
        packed = torch.cat([
            ring["buf"].reshape(-1),
            torch.stack([ring["pos"], ring["streak"],
                         ring["max_streak"]]).to(torch.float32)])
        host = _device.fetch(packed)
        nbuf = self.capacity * len(self.keys)
        pos, streak, max_streak = (int(v) for v in host[nbuf:])
        return {"buf": host[:nbuf].reshape(self.capacity, len(self.keys)),
                "pos": pos, "streak": streak, "max_streak": max_streak}

    def read(self, ring_host: Mapping[str, Any]) -> List[Dict[str, Any]]:
        """Per-step metric dicts from a host copy of the ring, in step
        order, values as ``np.float32`` scalars — key order is exactly
        ``self.keys`` (the synchronous loop's key stream)."""
        n = int(ring_host["pos"])
        if n > self.capacity:
            raise ValueError(
                f"ring overflowed: {n} writes into capacity "
                f"{self.capacity} — a window boundary was missed")
        buf = np.asarray(ring_host["buf"])[:n]
        return [dict(zip(self.keys, row)) for row in buf]
