"""Retry with jittered exponential backoff — the one retry primitive (a
copy of ``npairloss_tpu/resilience/retrying.py``; stdlib only).

Snapshot save and restore I/O retry through ``call_with_retry`` so the
schedule (exponential growth, cap, full decorrelated jitter) and the
logging are defined exactly once.  The
clock and the randomness are injectable, so tests pin the schedule with
a fake ``sleep`` and a seeded ``rng`` instead of real waiting.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import time
from typing import Any, Callable, Optional, Tuple, Type

log = logging.getLogger("npairloss_tpu_torch.resilience")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Jittered exponential backoff: attempt ``k`` (1-based) failing
    sleeps ``min(base_delay * multiplier**(k-1), max_delay)`` scaled by
    ``1 ± jitter`` before attempt ``k+1``; after ``max_attempts`` the
    last error propagates.

    ``retry_on`` bounds what counts as transient — everything else
    (a shape mismatch, a KeyboardInterrupt) propagates immediately.
    """

    max_attempts: int = 3
    base_delay: float = 0.5
    max_delay: float = 30.0
    multiplier: float = 2.0
    jitter: float = 0.25
    jitter_cap_s: Optional[float] = None
    retry_on: Tuple[Type[BaseException], ...] = (OSError,)

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.jitter < 0 or self.jitter > 1:
            raise ValueError(f"jitter must be in [0, 1], got {self.jitter}")
        if self.jitter_cap_s is not None and self.jitter_cap_s < 0:
            raise ValueError(
                f"jitter_cap_s must be >= 0, got {self.jitter_cap_s}")

    def delay(self, attempt: int,
              rng: Optional[random.Random] = None) -> float:
        """Backoff before the retry that follows failed attempt
        ``attempt`` (1-based).  ``jitter_cap_s`` bounds the ABSOLUTE
        jitter contribution: once the exponential base delay grows
        large, relative jitter stops scaling with it, so a fleet of
        late-attempt retriers still decorrelates without one unlucky
        draw doubling a 30s wait."""
        d = min(self.base_delay * self.multiplier ** (attempt - 1),
                self.max_delay)
        if self.jitter:
            u = (rng.random() if rng is not None else random.random())
            spread = self.jitter * d
            if self.jitter_cap_s is not None:
                spread = min(spread, self.jitter_cap_s)
            d += spread * (2.0 * u - 1.0)
        return max(d, 0.0)


# Named policies: call sites that retry for a *reason* declare it here
# once, so the schedule is reviewable in one place instead of scattered
# inline literals.  WAL replay re-reads whole segment files (cheap,
# must converge fast after a cold restart); segment open contends with
# the GC unlink window (short, capped jitter keeps the tail bounded).
_NAMED_POLICIES = {
    "wal_replay": RetryPolicy(max_attempts=4, base_delay=0.05,
                              max_delay=1.0, jitter=0.5,
                              jitter_cap_s=0.2),
    "wal_segment_open": RetryPolicy(max_attempts=3, base_delay=0.02,
                                    max_delay=0.5, jitter=0.5,
                                    jitter_cap_s=0.1),
}


def named_policy(name: str) -> RetryPolicy:
    """The registered :class:`RetryPolicy` for ``name``; KeyError with
    the known names when the name is not registered (a typo'd policy
    name must fail loudly, not fall back to defaults)."""
    try:
        return _NAMED_POLICIES[name]
    except KeyError:
        raise KeyError(
            f"unknown retry policy {name!r} — known: "
            f"{sorted(_NAMED_POLICIES)}") from None


def call_with_retry(
    fn: Callable[[], Any],
    policy: Optional[RetryPolicy] = None,
    *,
    describe: str = "operation",
    sleep: Callable[[float], None] = time.sleep,
    rng: Optional[random.Random] = None,
    on_retry: Optional[Callable[[int, float, BaseException], None]] = None,
) -> Any:
    """Run ``fn`` under ``policy``; returns its result or re-raises the
    final error.  ``on_retry(attempt, delay_s, exc)`` fires before each
    backoff sleep (telemetry hook)."""
    policy = policy if policy is not None else RetryPolicy()
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn()
        except policy.retry_on as e:
            if attempt >= policy.max_attempts:
                raise
            d = policy.delay(attempt, rng)
            log.warning(
                "%s failed (attempt %d/%d): %s — retrying in %.2fs",
                describe, attempt, policy.max_attempts, e, d,
            )
            if on_retry is not None:
                on_retry(attempt, d, e)
            sleep(d)
