"""Deterministic traffic generator — a compressed production "day".

A copy of ``npairloss_tpu/gameday/traffic.py``: the same plan, line for
line and digest for digest, from the same seed (tests/test_torch_gameday.py).

The gameday (docs/RESILIENCE.md §8) drives the composed serving system
with load that looks like production, compressed into a CI-sized
window, and — because every chaos run must be replayable — the whole
plan is a pure function of the seed: ``generate(cfg)`` with the same
:class:`TrafficConfig` yields the same events byte-for-byte
(``plan_digest`` pins it; tests/test_gameday.py asserts identity).

Shape of the day:

  * **diurnal ramp** — Poisson arrivals whose instantaneous rate
    follows ``base_qps + (peak_qps - base_qps) * sin^2(pi * t / D)``:
    quiet at the window's edges, peak mid-window;
  * **bursts** — ``bursts`` short windows at ``burst_qps``, sized past
    the admission tier's capacity so load shedding MUST engage (the
    sheds land in ``rejected``, never in drops);
  * **Zipf hot-query skew** — query keys drawn from a Zipf law
    (weight ``1/k**zipf_s``) over the catalog: a few keys dominate,
    the tail is long — the realistic cache/batching shape;
  * **gallery-growth ingest** — a scripted stream of ``add()``
    batches, one every ``ingest_every_s`` seconds, each meant to be
    committed as a new index snapshot for ``--watch-snapshots`` to
    hot-swap in.

Stdlib-only on purpose: the generator must import (and the determinism
tests must run) without torch or numpy, and the verdict contract
records the plan digest, so this module is part of the stdlib-only
audit surface.
"""

from __future__ import annotations

import bisect
import dataclasses
import hashlib
import json
import math
import random
from typing import Any, Dict, List, Tuple


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """Knobs for one compressed day.  Validation is loud: a silently
    clamped rate would change the plan a seed reproduces."""

    seed: int = 0
    duration_s: float = 60.0
    base_qps: float = 4.0
    peak_qps: float = 16.0
    burst_qps: float = 60.0
    bursts: int = 2
    burst_s: float = 2.0
    catalog: int = 256
    zipf_s: float = 1.1
    ingest_every_s: float = 0.0  # 0 = no ingest stream
    ingest_rows: int = 16
    # Multi-tenant skew (docs/SERVING.md §Multi-tenant): () = the
    # single-tenant day, unchanged byte for byte.  With a weight table,
    # every query also draws a tenant id — from a SEPARATE rng stream,
    # so the arrival times and keys of a tenantless plan at the same
    # seed are untouched.  Inside burst windows the hot tenant's weight
    # is multiplied by ``hot_burst_factor``: the noisy-neighbor shape
    # (one tenant surges, the others keep their baseline rates).
    tenants: Tuple[Tuple[str, float], ...] = ()
    hot_tenant: str = ""
    hot_burst_factor: float = 1.0

    def __post_init__(self):
        if self.duration_s <= 0:
            raise ValueError(
                f"duration_s must be > 0, got {self.duration_s}")
        if not (0 < self.base_qps <= self.peak_qps):
            raise ValueError(
                "need 0 < base_qps <= peak_qps, got "
                f"{self.base_qps}/{self.peak_qps}")
        if self.bursts and self.burst_qps < self.peak_qps:
            raise ValueError(
                "burst_qps must exceed peak_qps (a burst below the "
                f"diurnal peak is not a burst), got {self.burst_qps} "
                f"< {self.peak_qps}")
        if self.bursts < 0 or self.burst_s <= 0:
            raise ValueError(
                f"bad burst spec: bursts={self.bursts} "
                f"burst_s={self.burst_s}")
        if self.bursts * self.burst_s >= self.duration_s:
            raise ValueError(
                "bursts cover the whole window "
                f"({self.bursts} x {self.burst_s}s >= "
                f"{self.duration_s}s) — nothing left to be the day")
        if self.catalog < 2:
            raise ValueError(f"catalog must be >= 2, got {self.catalog}")
        if self.zipf_s <= 0:
            raise ValueError(f"zipf_s must be > 0, got {self.zipf_s}")
        if self.ingest_every_s < 0 or self.ingest_rows <= 0:
            raise ValueError(
                f"bad ingest spec: every={self.ingest_every_s} "
                f"rows={self.ingest_rows}")
        if self.hot_tenant and not self.tenants:
            raise ValueError(
                f"hot_tenant {self.hot_tenant!r} needs a tenants "
                "weight table")
        if self.tenants:
            names = [t for t, _ in self.tenants]
            if len(set(names)) != len(names) or not all(names):
                raise ValueError(
                    f"tenant ids must be distinct and non-empty, "
                    f"got {names}")
            if any(w <= 0 for _, w in self.tenants):
                raise ValueError(
                    f"tenant weights must be > 0, got {self.tenants}")
            if self.hot_tenant and self.hot_tenant not in names:
                raise ValueError(
                    f"hot_tenant {self.hot_tenant!r} not in the "
                    f"weight table {names}")
        if self.hot_burst_factor < 1.0:
            raise ValueError(
                f"hot_burst_factor must be >= 1 (a burst that SHRINKS "
                f"the hot tenant is not a burst), got "
                f"{self.hot_burst_factor}")
        if self.hot_burst_factor > 1.0 and not self.hot_tenant:
            raise ValueError("hot_burst_factor needs hot_tenant")


@dataclasses.dataclass(frozen=True)
class QueryEvent:
    """One query arrival: ``t`` seconds into the window, a stable qid,
    the Zipf-drawn catalog key it asks about, and (multi-tenant plans
    only) the tenant the query belongs to."""

    t: float
    qid: int
    key: int
    tenant: Any = None  # Optional[str]; None on single-tenant plans


@dataclasses.dataclass(frozen=True)
class IngestEvent:
    """One gallery-growth batch: ``rows`` new vectors to ``add()`` and
    commit as index snapshot ``commit_id``."""

    t: float
    rows: int
    commit_id: int


@dataclasses.dataclass(frozen=True)
class TrafficPlan:
    cfg: TrafficConfig
    queries: Tuple[QueryEvent, ...]
    ingest: Tuple[IngestEvent, ...]
    burst_windows: Tuple[Tuple[float, float], ...]

    def in_burst(self, t: float) -> bool:
        return any(a <= t < b for a, b in self.burst_windows)


def _burst_windows(cfg: TrafficConfig) -> Tuple[Tuple[float, float], ...]:
    """Evenly spaced burst centers, clear of the window edges."""
    out = []
    for i in range(cfg.bursts):
        center = cfg.duration_s * (i + 1) / (cfg.bursts + 1)
        out.append((center - cfg.burst_s / 2.0,
                    center + cfg.burst_s / 2.0))
    return tuple(out)


def _rate(cfg: TrafficConfig, windows, t: float) -> float:
    for a, b in windows:
        if a <= t < b:
            return cfg.burst_qps
    x = math.sin(math.pi * t / cfg.duration_s)
    return cfg.base_qps + (cfg.peak_qps - cfg.base_qps) * x * x


class _ZipfSampler:
    """Zipf draw via bisect on the cumulative harmonic weights —
    O(log catalog) per draw, exact, and deterministic under the plan's
    ``random.Random``."""

    def __init__(self, catalog: int, s: float):
        acc, cum = 0.0, []
        for k in range(1, catalog + 1):
            acc += 1.0 / (k ** s)
            cum.append(acc)
        self._cum = cum
        self._total = acc

    def draw(self, rng: random.Random) -> int:
        return bisect.bisect_left(self._cum, rng.random() * self._total)


def generate(cfg: TrafficConfig) -> TrafficPlan:
    """The whole day, as a pure function of ``cfg`` (seed included)."""
    rng = random.Random(cfg.seed)
    windows = _burst_windows(cfg)
    zipf = _ZipfSampler(cfg.catalog, cfg.zipf_s)
    queries: List[QueryEvent] = []
    t, qid = 0.0, 0
    while True:
        # Inhomogeneous Poisson by stepping at the current local rate;
        # the rate changes slowly relative to the inter-arrival gaps
        # (bursts are whole windows, the diurnal curve is smooth), so
        # the local-rate approximation keeps the window statistics the
        # tests pin.
        t += rng.expovariate(_rate(cfg, windows, t))
        if t >= cfg.duration_s:
            break
        queries.append(QueryEvent(t=t, qid=qid, key=zipf.draw(rng)))
        qid += 1
    if cfg.tenants:
        # Tenant draws ride their OWN rng stream (seed + 2): adding or
        # removing the weight table never perturbs the arrival times
        # and keys above, and a tenantless plan at the same seed stays
        # byte-identical.
        trng = random.Random(cfg.seed + 2)
        names = [t for t, _ in cfg.tenants]
        base_w = [w for _, w in cfg.tenants]
        burst_w = [w * (cfg.hot_burst_factor if name == cfg.hot_tenant
                        else 1.0)
                   for name, w in cfg.tenants]
        queries = [
            dataclasses.replace(
                q, tenant=trng.choices(
                    names,
                    weights=(burst_w
                             if any(a <= q.t < b for a, b in windows)
                             else base_w))[0])
            for q in queries]
    ingest: List[IngestEvent] = []
    if cfg.ingest_every_s > 0:
        commit_id, t = 0, cfg.ingest_every_s
        while t < cfg.duration_s:
            ingest.append(IngestEvent(t=t, rows=cfg.ingest_rows,
                                      commit_id=commit_id))
            commit_id += 1
            t += cfg.ingest_every_s
    return TrafficPlan(cfg=cfg, queries=tuple(queries),
                       ingest=tuple(ingest), burst_windows=windows)


# -- canonical serialization (the determinism contract) ----------------------


def plan_lines(plan: TrafficPlan) -> List[str]:
    """Canonical JSON lines for the plan — sorted keys, fixed float
    formatting via json's repr, one event per line.  Two runs of the
    same seed produce the same list, byte for byte."""
    cfg_d = dataclasses.asdict(plan.cfg)
    if not cfg_d.get("tenants"):
        # A tenantless plan serializes (and so digests) exactly as it
        # did before the tenant fields existed — replayability of the
        # recorded single-tenant days is part of the contract.
        for key in ("tenants", "hot_tenant", "hot_burst_factor"):
            cfg_d.pop(key, None)
    else:
        cfg_d["tenants"] = [list(t) for t in cfg_d["tenants"]]
    lines = [json.dumps(
        {"cfg": cfg_d,
         "bursts": [list(w) for w in plan.burst_windows]},
        sort_keys=True)]
    lines += [json.dumps(
        {k: v for k, v in dataclasses.asdict(q).items()
         if not (k == "tenant" and v is None)}, sort_keys=True)
        for q in plan.queries]
    lines += [json.dumps(dataclasses.asdict(i), sort_keys=True)
              for i in plan.ingest]
    return lines


def plan_digest(plan: TrafficPlan) -> str:
    """sha256 over the canonical lines — the identity the verdict
    records, so a replay can prove it drove the same day."""
    h = hashlib.sha256()
    for line in plan_lines(plan):
        h.update(line.encode("utf-8"))
        h.update(b"\n")
    return h.hexdigest()


def plan_stats(plan: TrafficPlan) -> Dict[str, Any]:
    """Summary statistics (for the verdict's traffic block and the
    statistical pins): totals, burst-window rate, hot-key share."""
    cfg = plan.cfg
    n_burst = sum(1 for q in plan.queries if plan.in_burst(q.t))
    burst_span = sum(b - a for a, b in plan.burst_windows)
    counts: Dict[int, int] = {}
    for q in plan.queries:
        counts[q.key] = counts.get(q.key, 0) + 1
    top_key, top_n = (max(counts.items(), key=lambda kv: kv[1])
                      if counts else (0, 0))
    by_tenant: Dict[str, Dict[str, int]] = {}
    for q in plan.queries:
        if q.tenant is None:
            continue
        row = by_tenant.setdefault(q.tenant, {"queries": 0, "burst": 0})
        row["queries"] += 1
        if plan.in_burst(q.t):
            row["burst"] += 1
    return {
        **({"tenants": by_tenant} if by_tenant else {}),
        "queries": len(plan.queries),
        "ingest_commits": len(plan.ingest),
        "burst_queries": n_burst,
        "burst_rate_qps": (n_burst / burst_span) if burst_span else 0.0,
        "top_key": top_key,
        "top_key_share": (top_n / len(plan.queries)
                          if plan.queries else 0.0),
        "distinct_keys": len(counts),
        "sha256": plan_digest(plan),
        "seed": cfg.seed,
        "duration_s": cfg.duration_s,
    }
