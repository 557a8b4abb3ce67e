"""Divergence guard: N consecutive non-finite losses -> rollback or halt
(a copy of ``npairloss_tpu/resilience/guard.py``; stdlib only).

The guard watches the per-step loss on the host (the one extra sync it
costs in the synchronous loop is the reason it is opt-in) and, once
``patience`` consecutive steps are non-finite, either halts with a
diagnosis or rolls the Solver back to the newest *valid* snapshot —
optionally scaling the base lr down so the trajectory does not march
straight back into the same cliff.  Rollbacks are bounded
(``max_rollbacks``); past the bound the guard halts, because an
endlessly rolling-back run is an outage that looks like progress.

The pipelined loop (``SolverConfig.pipeline``) removes the per-step
sync: the captured step carries a device-side consecutive-non-finite
counter, and the host replays the window's losses through ``observe``
only at window-boundary reads — same trip step, same rollback,
detected up to one window late (bounded staleness).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

ACTIONS = ("rollback", "halt")


class DivergenceError(RuntimeError):
    """Training diverged and could not (or was configured not to) recover."""


@dataclasses.dataclass(frozen=True)
class DivergenceConfig:
    """``patience`` consecutive non-finite losses trip the guard.

    ``action="rollback"`` restores the newest valid snapshot (fresh
    optimizer trajectory from iteration k) and multiplies ``base_lr``
    by ``lr_scale``; ``action="halt"`` raises :class:`DivergenceError`
    immediately — the diagnostic stop for runs where silent recovery
    would mask a real bug.
    """

    patience: int = 3
    action: str = "rollback"
    lr_scale: float = 1.0
    max_rollbacks: int = 2

    def __post_init__(self):
        if self.patience < 1:
            raise ValueError(f"patience must be >= 1, got {self.patience}")
        if self.action not in ACTIONS:
            raise ValueError(
                f"action must be one of {ACTIONS}, got {self.action!r}"
            )
        if not (0.0 < self.lr_scale <= 1.0):
            raise ValueError(
                f"lr_scale must be in (0, 1], got {self.lr_scale}"
            )


@dataclasses.dataclass(frozen=True)
class RollbackRequest:
    """An externally REQUESTED rollback — the divergence guard's
    recovery generalized to health-signal triggers (the alert→actuation
    control plane).

    The non-finite guard trips in-loop on its own streak; a health
    alert (embedding collapse) trips OUT of loop, on the live-obs tick
    thread, so the actuator sets a request the train loop executes at
    its next safe point.  ``before_wall_time`` (the alert's
    ``fired_at``) restricts the restore to snapshots COMMITTED before
    the incident started — a snapshot captured mid-collapse is not a
    recovery target; ``lr_scale`` optionally damps the relaunch the way
    the divergence rollback does.
    """

    reason: str
    before_wall_time: Optional[float] = None
    lr_scale: float = 1.0

    def __post_init__(self):
        if not (0.0 < self.lr_scale <= 1.0):
            raise ValueError(
                f"lr_scale must be in (0, 1], got {self.lr_scale}"
            )


class DivergenceGuard:
    """Host-side streak tracker; the Solver owns the recovery action."""

    def __init__(self, cfg: DivergenceConfig):
        self.cfg = cfg
        self.streak = 0
        self.rollbacks = 0

    def observe(self, loss: float) -> bool:
        """Feed one step's loss; True when the guard trips."""
        if math.isfinite(loss):
            self.streak = 0
            return False
        self.streak += 1
        return self.streak >= self.cfg.patience
