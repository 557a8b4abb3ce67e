"""Multi-tenant serving: one tier, many galleries.

Port of ``npairloss_tpu/serve/tenants.py``.  It turns the single-gallery
serving tier into a tenant-keyed service: a per-tenant ``GalleryIndex``
or IVF index, freshness, WAL-backed ingest watermark, quota, admission
and shadow scoring behind ONE HTTP front end, ONE replica tier and ONE
dispatch-signature set per geometry.

The pieces:

  * :data:`TENANTS_SCHEMA` + :func:`validate_tenants_manifest`: the
    versioned ``npairloss-tenants-v1`` manifest contract (tenant id ->
    index prefix, index kind, probe impl, quota, recall floor, admission
    params), validated with the standard library alone;
  * :class:`TenantSpec` / :class:`TenantRegistry`: the parsed,
    loudly validated registry;
  * :class:`TenantEntry`: one tenant's runtime slot inside
    :class:`~npairloss_tpu_torch.serve.server.RetrievalServer` (engines,
    freshness, quota, admission, shadow, ingest, counters);
  * :class:`QuotaGate`: a token-bucket qps quota; a shed is a
    fast-reject counted per tenant, and the
    ``serve_quota_exhausted{tenant=...}`` gauge feeds the tenant's quota
    SLO, so the shed is also a tenant-scoped alert;
  * :class:`TenantIngest`: the durable-ingest discipline (WAL append ->
    fsync -> apply -> ack; checkpoint publication + WAL GC) per tenant;
  * :class:`ProgramCache`: the signature-sharing contract: engines of
    one (``EngineConfig``, index kind, device, model) share one
    signature set through ``QueryEngine(share_programs_with=)``, so the
    tenant count does not multiply post-warmup compiles;
  * :class:`TenantSwapper`: the hot-swap discipline per entry: build
    and warm the new engines OFF the serving path, publish through
    ``swap_tenant_engines``; the other tenants' answers never stop;
  * :func:`tenant_slo_specs`: per-tenant SLOs over the LABELED metric
    streams (``serve_p99_ms{tenant="a"}``), named ``tenant_*@<id>`` so
    one AlertEngine fires tenant-scoped alerts.

The module level is the standard library alone (a copy of the JAX
package's, whose file a checker loads without the package); everything
that touches an engine, an index or torch is imported lazily.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import logging
import re
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

log = logging.getLogger("npairloss_tpu_torch.serve")

TENANTS_SCHEMA = "npairloss-tenants-v1"

# Serving postures a tenant can request — the dict is the registry the
# stdlib choices tuple below is pinned to (tests/test_torch_tenants.py),
# as cli.py's _PRECISION_CHOICES is.
INDEX_KINDS = {
    "flat": "exact scan over the full gallery (the recall oracle)",
    "ivf": "clustered probe-top-C scan (serve/ivf.py)",
}
_INDEX_KIND_CHOICES = ("flat", "ivf")
# The stdlib restatement of ops.ivf_probe.PROBE_IMPLS' keys, pinned by
# the same test.
_PROBE_IMPL_CHOICES = ("scan", "fused", "auto")

# Tenant ids ride Prometheus label values, SLO names, WAL subdirs, and
# checkpoint prefixes — keep them filesystem- and label-safe.
_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_-]*$")

# Per-tenant SLO names are ``tenant_<what>@<tenant_id>`` — the suffix
# is how one shared AlertEngine scopes an alert to its tenant.
TENANT_SLO_SEP = "@"

_SPEC_KEYS = frozenset((
    "tenant_id", "index_prefix", "index_kind", "probe_impl",
    "quota_qps", "quota_burst_s", "recall_floor", "recall_k",
    "p99_ms", "admission", "probe_every",
))


def tenant_of_slo(slo_name: str) -> Optional[str]:
    """The tenant id a ``tenant_*@<id>`` SLO/alert is scoped to, or
    None for a tier-wide name — the verdict/bench side of the naming
    contract."""
    if TENANT_SLO_SEP not in slo_name:
        return None
    return slo_name.split(TENANT_SLO_SEP, 1)[1]


def validate_tenants_manifest(manifest: Any) -> List[str]:
    """Problems with a ``npairloss-tenants-v1`` manifest (empty list =
    valid).  Jax-free and total: every problem is reported, not just
    the first, so a tampered manifest is refused with evidence."""
    if not isinstance(manifest, dict):
        return [f"manifest must be an object, got "
                f"{type(manifest).__name__}"]
    problems: List[str] = []
    schema = manifest.get("schema")
    if schema != TENANTS_SCHEMA:
        problems.append(
            f"schema is {schema!r}, expected {TENANTS_SCHEMA!r}")
    tenants = manifest.get("tenants")
    if not isinstance(tenants, list) or not tenants:
        problems.append("manifest needs a non-empty 'tenants' list")
        return problems
    seen: set = set()
    for i, t in enumerate(tenants):
        where = f"tenants[{i}]"
        if not isinstance(t, dict):
            problems.append(f"{where}: must be an object")
            continue
        tid = t.get("tenant_id")
        if not isinstance(tid, str) or not _ID_RE.match(tid):
            problems.append(
                f"{where}: tenant_id must match {_ID_RE.pattern}, "
                f"got {tid!r}")
        elif tid in seen:
            problems.append(f"{where}: duplicate tenant_id {tid!r}")
        else:
            seen.add(tid)
        prefix = t.get("index_prefix")
        if not isinstance(prefix, str) or not prefix:
            problems.append(
                f"{where}: index_prefix must be a non-empty string")
        kind = t.get("index_kind", "flat")
        if kind not in _INDEX_KIND_CHOICES:
            problems.append(
                f"{where}: index_kind {kind!r} not in "
                f"{list(_INDEX_KIND_CHOICES)}")
        impl = t.get("probe_impl")
        if impl is not None and impl not in _PROBE_IMPL_CHOICES:
            problems.append(
                f"{where}: probe_impl {impl!r} not in "
                f"{list(_PROBE_IMPL_CHOICES)}")
        qps = t.get("quota_qps", 0.0)
        if not isinstance(qps, (int, float)) or qps < 0:
            problems.append(
                f"{where}: quota_qps must be a number >= 0, got {qps!r}")
        burst = t.get("quota_burst_s", 2.0)
        if not isinstance(burst, (int, float)) or burst <= 0:
            problems.append(
                f"{where}: quota_burst_s must be > 0, got {burst!r}")
        floor = t.get("recall_floor")
        if floor is not None and not (
                isinstance(floor, (int, float)) and 0.0 <= floor <= 1.0):
            problems.append(
                f"{where}: recall_floor must be in [0, 1], got {floor!r}")
        rk = t.get("recall_k", 10)
        if not isinstance(rk, int) or rk < 1:
            problems.append(
                f"{where}: recall_k must be an int >= 1, got {rk!r}")
        p99 = t.get("p99_ms")
        if p99 is not None and not (
                isinstance(p99, (int, float)) and p99 > 0):
            problems.append(
                f"{where}: p99_ms must be > 0, got {p99!r}")
        if not isinstance(t.get("admission", True), bool):
            problems.append(f"{where}: admission must be a boolean")
        pe = t.get("probe_every", 8)
        if not isinstance(pe, int) or pe < 1:
            problems.append(
                f"{where}: probe_every must be an int >= 1, got {pe!r}")
        extra = sorted(set(t) - _SPEC_KEYS)
        if extra:
            problems.append(
                f"{where}: unknown key(s) {extra} — the "
                f"{TENANTS_SCHEMA} contract has no such fields")
    return problems


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's declared serving contract (one manifest entry).

    ``quota_qps`` 0 = unlimited; ``probe_impl`` None defers to the
    tier's engine config; ``recall_floor``/``p99_ms`` None = no SLO of
    that kind for this tenant; ``admission`` arms a per-tenant
    burn-driven controller over the tenant's own SLOs."""

    tenant_id: str
    index_prefix: str
    index_kind: str = "flat"
    probe_impl: Optional[str] = None
    quota_qps: float = 0.0
    quota_burst_s: float = 2.0
    recall_floor: Optional[float] = None
    recall_k: int = 10
    p99_ms: Optional[float] = None
    admission: bool = True
    probe_every: int = 8

    def __post_init__(self):
        problems = validate_tenants_manifest({
            "schema": TENANTS_SCHEMA,
            "tenants": [dataclasses.asdict(self)],
        })
        if problems:
            raise ValueError(
                f"invalid TenantSpec: {'; '.join(problems)}")

    @classmethod
    def from_dict(cls, entry: Dict[str, Any]) -> "TenantSpec":
        return cls(**{k: v for k, v in entry.items() if k in _SPEC_KEYS})


class TenantRegistry:
    """The parsed ``npairloss-tenants-v1`` manifest: an ordered,
    loudly-validated map of tenant id -> :class:`TenantSpec`."""

    def __init__(self, specs):
        specs = list(specs)
        if not specs:
            raise ValueError("TenantRegistry needs >= 1 tenant")
        self.specs: Dict[str, TenantSpec] = {}
        for spec in specs:
            if spec.tenant_id in self.specs:
                raise ValueError(
                    f"duplicate tenant_id {spec.tenant_id!r}")
            self.specs[spec.tenant_id] = spec

    @classmethod
    def from_manifest(cls, manifest: Any) -> "TenantRegistry":
        problems = validate_tenants_manifest(manifest)
        if problems:
            raise ValueError(
                "invalid tenants manifest: " + "; ".join(problems))
        return cls(TenantSpec.from_dict(t) for t in manifest["tenants"])

    @classmethod
    def load(cls, path: str) -> "TenantRegistry":
        try:
            with open(path, encoding="utf-8") as f:
                manifest = json.load(f)
        except ValueError as e:
            raise ValueError(f"tenants manifest {path}: bad JSON: {e}")
        return cls.from_manifest(manifest)

    def ids(self) -> List[str]:
        return list(self.specs)

    def get(self, tenant_id: str) -> TenantSpec:
        if tenant_id not in self.specs:
            raise KeyError(
                f"unknown tenant {tenant_id!r} (registered: "
                f"{self.ids()})")
        return self.specs[tenant_id]

    def __iter__(self) -> Iterator[TenantSpec]:
        return iter(self.specs.values())

    def __contains__(self, tenant_id) -> bool:
        return tenant_id in self.specs

    def __len__(self) -> int:
        return len(self.specs)


class QuotaGate:
    """A token-bucket qps quota (capacity ``qps * burst_s``, refill
    ``qps``/s).  ``admit()`` is a submit-path fast path: one lock, no
    I/O.  With a (tenant-scoped) registry attached, the
    ``serve_quota_exhausted`` gauge flips 1/0 around sheds — the
    sample stream the tenant's quota SLO burns on — and every shed
    increments the ``serve_quota_shed`` counter.  ``qps`` 0 disarms
    the gate (always admits, publishes nothing)."""

    def __init__(self, qps: float, burst_s: float = 2.0,
                 registry=None, clock=time.monotonic):
        if qps < 0:
            raise ValueError(f"quota qps must be >= 0, got {qps}")
        if burst_s <= 0:
            raise ValueError(f"quota burst_s must be > 0, got {burst_s}")
        self.qps = float(qps)
        self.burst_s = float(burst_s)
        self.capacity = max(self.qps * self.burst_s, 1.0)
        self.registry = registry
        self._clock = clock
        self._lock = threading.Lock()
        self._tokens = self.capacity  # guarded-by: _lock
        self._last = clock()  # guarded-by: _lock
        self.sheds = 0  # guarded-by: _lock

    def admit(self) -> bool:
        if self.qps <= 0:
            return True
        with self._lock:
            now = self._clock()
            self._tokens = min(
                self.capacity,
                self._tokens + (now - self._last) * self.qps)
            self._last = now
            ok = self._tokens >= 1.0
            if ok:
                self._tokens -= 1.0
            else:
                self.sheds += 1
        if self.registry is not None:
            self.registry.set("serve_quota_exhausted",
                              0.0 if ok else 1.0)
            if not ok:
                self.registry.inc("serve_quota_shed")
        return ok

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "qps": self.qps,
                "burst_s": self.burst_s,
                "sheds": self.sheds,
                "tokens": round(self._tokens, 2),
            }


class TenantIngest:
    """The durable-ingest discipline, one instance per tenant:
    WAL append + group-commit fsync barrier BEFORE the ack, apply under
    ``lock``, checkpoint publication + WAL GC at the same watermark
    read.  ``lock`` also serializes this tenant's hot-swap flip against
    its ingest applies (the server's ingest-lock-outside-serve-lock
    order, per tenant)."""

    def __init__(self, wal, apply_fn, *, checkpoint_fn=None,
                 checkpoint_every: int = 0, watermark: int = 0,
                 checkpoint_watermark: int = 0):
        self.wal = wal
        self.apply_fn = apply_fn
        self.checkpoint_fn = checkpoint_fn
        self.checkpoint_every = int(checkpoint_every)
        self.lock = threading.Lock()
        self.watermark = int(watermark)  # guarded-by: lock
        self.ckpt_watermark = int(checkpoint_watermark)  # guarded-by: lock
        self.since_ckpt = 0  # guarded-by: lock
        self.batches = 0  # guarded-by: lock
        self.vectors = 0  # guarded-by: lock
        self.errors = 0  # guarded-by: lock

    def note_error(self) -> None:
        with self.lock:
            self.errors += 1

    def commit(self, body: Dict[str, Any]) -> int:
        """Durably append one encoded ingest body, apply it, advance
        the watermark; returns the WAL seq the ack must carry.  The
        ack never precedes the fsync covering the record — the
        durability contract, unchanged from the single-tenant path."""
        seq = self.wal.append(body)
        self.wal.wait_durable(seq)
        body["seq"] = seq
        with self.lock:
            self.apply_fn(body)
            self.watermark = seq
            self.since_ckpt += 1
            self.batches += 1
            self.vectors += len(body["ids"])
        return seq

    def maybe_checkpoint(self) -> None:
        if self.checkpoint_fn is None or self.checkpoint_every <= 0:
            return
        with self.lock:
            due = self.since_ckpt >= self.checkpoint_every
        if due:
            self.checkpoint_now()

    def checkpoint_now(self) -> Optional[str]:
        if self.checkpoint_fn is None:
            return None
        with self.lock:
            wm = self.watermark
            if wm <= self.ckpt_watermark:
                return None
            try:
                path = self.checkpoint_fn(wm)
            except Exception as e:  # noqa: BLE001 — a failed publish is not data loss
                log.error("tenant ingest checkpoint at watermark %d "
                          "failed: %s — WAL retains the records", wm, e)
                return None
            self.ckpt_watermark = wm
            self.since_ckpt = 0
        if path is not None:
            try:
                self.wal.gc(wm)
            except Exception as e:  # noqa: BLE001 — GC is space, not safety
                log.error("tenant wal GC at watermark %d failed: %s",
                          wm, e)
        return path

    def stats(self) -> Dict[str, Any]:
        with self.lock:
            out: Dict[str, Any] = {
                "batches": self.batches,
                "vectors": self.vectors,
                "errors": self.errors,
                "watermark": self.watermark,
                "checkpoint_watermark": self.ckpt_watermark,
            }
        try:
            out["wal"] = self.wal.stats() if self.wal is not None else {}
        except Exception as e:  # noqa: BLE001 — stats must not fail health
            out["wal"] = {"error": str(e)}
        return out


def _pct(values: List[float], q: float) -> float:
    """Nearest-rank percentile over an unsorted list (stdlib-only —
    this module must not import numpy)."""
    if not values:
        return 0.0
    vals = sorted(values)
    rank = max(int(round(q / 100.0 * len(vals) + 0.5)) - 1, 0)
    return float(vals[min(rank, len(vals) - 1)])


class TenantEntry:
    """One tenant's runtime slot inside the server's tenant map.  A
    plain container: the server is the only mutator, and the query/
    answer counters plus the ``engines``/``freshness`` pointers are
    guarded by the server's ``_lock`` (swap flips additionally hold
    ``ingest.lock`` — the per-tenant ingest-outside-serve order)."""

    def __init__(self, spec: TenantSpec, engines, freshness=None,
                 quota: Optional[QuotaGate] = None, admission=None,
                 shadow=None, ingest: Optional[TenantIngest] = None,
                 latency_window: int = 1024):
        self.spec = spec
        self.tenant_id = spec.tenant_id
        self.engines = list(engines)  # under the owning server's _lock
        if not self.engines:
            raise ValueError(
                f"tenant {spec.tenant_id!r} needs >= 1 engine")
        self.freshness = freshness  # under the owning server's _lock
        self.quota = quota
        self.admission = admission
        self.shadow = shadow
        self.ingest = ingest
        self.queries = 0  # under the owning server's _lock
        self.answered = 0  # under the owning server's _lock
        self.errors = 0  # under the owning server's _lock
        self.rejected = 0  # under the owning server's _lock
        self.swaps = 0  # under the owning server's _lock
        self.lat: collections.deque = collections.deque(
            maxlen=max(latency_window, 1))  # under the owning server's _lock
        self.window_lat: List[float] = []  # under the owning server's _lock

    def take_window(self) -> List[float]:
        """Swap out this window's latency samples (caller holds the
        server lock) — the per-tenant twin of ``_emit_window``'s
        snapshot."""
        lat, self.window_lat = self.window_lat, []
        return lat

    def percentiles(self) -> Dict[str, float]:
        lat = list(self.lat)
        return {"p50_ms": round(_pct(lat, 50), 3),
                "p99_ms": round(_pct(lat, 99), 3)}

    def stats_block(self) -> Dict[str, Any]:
        """This tenant's summary/healthz block: counters + freshness +
        every armed feature's evidence, each sub-block absent when the
        feature is off (the freshness-JSON contract, per tenant)."""
        pi = getattr(self.engines[0], "probe_impl", None)
        return {
            "queries": self.queries,
            "answered": self.answered,
            "errors": self.errors,
            "rejected": self.rejected,
            "index_kind": self.spec.index_kind,
            **({"probe_impl": pi} if pi is not None else {}),
            **self.percentiles(),
            **(self.freshness.identity()
               if self.freshness is not None else {}),
            **(self.freshness.ages()
               if self.freshness is not None else {}),
            **({"quota": self.quota.stats()}
               if self.quota is not None else {}),
            **({"shed": self.admission.sheds,
                "shedding": (self.admission.shedding
                             or self.admission.forced)}
               if self.admission is not None else {}),
            **({"hot_swaps": self.swaps} if self.swaps else {}),
            **({"ingest": self.ingest.stats()}
               if self.ingest is not None else {}),
            **({"quality": self.shadow.stats()}
               if self.shadow is not None else {}),
        }


class TenantTelemetry:
    """A telemetry facade that stamps ``tenant`` into every metrics
    row it logs (spans/instants and everything else pass through) —
    how a per-tenant ShadowScorer's quality rows reach the shared
    RegistrySink already labeled, so its recall gauges land as
    ``serve_recall_at_K{tenant=...}``."""

    def __init__(self, base, tenant_id: str):
        self._base = base
        self.tenant = tenant_id

    def log(self, phase: str, step: int, row: Dict[str, Any]) -> None:
        self._base.log(phase, step, {**row, "tenant": self.tenant})

    def __getattr__(self, name):
        return getattr(self._base, name)


def tenant_slo_specs(spec: TenantSpec) -> list:
    """This tenant's SLOs, targeting its LABELED metric streams.  The
    ``tenant_*@<id>`` names make every alert the shared AlertEngine
    fires tenant-scoped; the metrics are the labeled registry keys the
    per-tenant window rows / quota gate / shadow scorer publish, read
    by the unchanged evaluator (labels are just registry key
    spelling)."""
    from npairloss_tpu_torch.obs.live.registry import labeled_name
    from npairloss_tpu_torch.obs.live.slo import SLOSpec

    lab = {"tenant": spec.tenant_id}
    tid = spec.tenant_id
    out = []
    if spec.p99_ms is not None:
        out.append(SLOSpec(
            name=f"tenant_p99{TENANT_SLO_SEP}{tid}",
            metric=labeled_name("serve_p99_ms", lab), op="<=",
            target=float(spec.p99_ms), window_s=30.0,
            burn_threshold=0.5, min_samples=2, severity="critical",
            description=f"tenant {tid}: p99 latency over its own "
                        "serve windows",
        ))
    if spec.quota_qps > 0:
        out.append(SLOSpec(
            name=f"tenant_quota{TENANT_SLO_SEP}{tid}",
            metric=labeled_name("serve_quota_exhausted", lab), op="<=",
            target=0.0, window_s=30.0, burn_threshold=0.5,
            min_samples=1, severity="warning",
            description=f"tenant {tid}: quota token bucket exhausted "
                        "(submits are being quota-shed)",
        ))
    if spec.recall_floor is not None:
        out.append(SLOSpec(
            name=f"tenant_recall{TENANT_SLO_SEP}{tid}",
            metric=labeled_name(f"serve_recall_at_{spec.recall_k}", lab),
            op=">=", target=float(spec.recall_floor), window_s=120.0,
            burn_threshold=0.5, min_samples=1, severity="critical",
            description=f"tenant {tid}: shadow-estimated "
                        f"recall@{spec.recall_k} vs the exact oracle",
        ))
    return out


class ProgramCache:
    """The cross-tenant signature-sharing contract: an engine's dispatch
    depends on its ``EngineConfig``, its index kind, its device and its
    model, never on the gallery's rows, so engines with the same (cfg,
    index kind, device, model) share one signature set through
    ``QueryEngine(share_programs_with=)``: a tenant whose geometry an
    earlier one warmed adds no compile.  The NEWEST engine per key
    becomes the share source, so a hot-swapped-out gallery is never
    pinned by the cache."""

    def __init__(self):
        self._lock = threading.Lock()
        self._primaries: Dict[Any, Any] = {}  # guarded-by: _lock

    @staticmethod
    def _key(index, cfg, model):
        return (cfg, getattr(index, "KIND", type(index).__name__),
                str(getattr(index, "device", None)),
                id(model) if model is not None else None)

    def engine_for(self, index, cfg, model=None, telemetry=None):
        """An engine for ``index`` that shares signatures with every
        earlier engine of the same key (a fresh set for a new key)."""
        from npairloss_tpu_torch.serve.engine import QueryEngine

        key = self._key(index, cfg, model)
        with self._lock:
            primary = self._primaries.get(key)
        eng = QueryEngine(index, cfg, model=model, telemetry=telemetry,
                          share_programs_with=primary)
        with self._lock:
            self._primaries[key] = eng
        return eng

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"families": len(self._primaries)}


def reconcile_index_kind(index, kind: str, clusters=None, seed: int = 0):
    """``serve``'s ``--index-kind`` reconciliation, per tenant: the
    committed artifact never dictates the serving posture: a flat commit
    is clustered at load (``seed``: ``serve --seed``, the k-means seed),
    an IVF commit serves through the flat exact scan with its
    watermark.  Applied to every swapped-in index too, so a flat commit
    never demotes an IVF-serving tenant at its first swap."""
    from npairloss_tpu_torch.serve.index import GalleryIndex
    from npairloss_tpu_torch.serve.ivf import IVFIndex

    if kind == "ivf" and not isinstance(index, IVFIndex):
        return IVFIndex.from_gallery(index, clusters=clusters, seed=seed)
    if kind == "flat" and isinstance(index, IVFIndex):
        flat = GalleryIndex.build(index.host_emb, index.host_labels,
                                  ids=index.ids, normalize=False,
                                  device=index.device)
        flat.ingest_watermark = index.ingest_watermark
        return flat
    return index


class TenantSwapper:
    """Per-tenant index watch: the hot-swap discipline applied per
    entry.  ``swap_one(tid)`` scans the tenant's index prefix for a
    STRICTLY newer commit, reconciles its kind, builds and warms a fresh
    engine set OFF the serving path (through the shared
    :class:`ProgramCache`, so an unchanged geometry adds no compile),
    then publishes it through ``RetrievalServer.swap_tenant_engines``:
    every other tenant's engines are untouched and no query in flight
    drops.  ``sweep()`` visits every tenant; ``start()`` runs sweeps on a
    daemon thread."""

    def __init__(self, server, programs: Optional[ProgramCache] = None,
                 telemetry=None, ivf_clusters=None, seed: int = 0):
        if not getattr(server, "tenants", None):
            raise ValueError(
                "TenantSwapper needs a server with an installed "
                "tenant map (RetrievalServer.enable_tenants)")
        self.server = server
        self.programs = programs if programs is not None else ProgramCache()
        self.telemetry = telemetry
        self.ivf_clusters = ivf_clusters
        self.seed = seed
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def swap_one(self, tenant_id: str) -> Dict[str, Any]:
        """Swap ONE tenant to its newest committed index; raises
        ``hotswap.NothingNewerError`` when nothing newer exists (an
        honest no-op for the sweep, an honest FAILED attempt for a
        remediation caller)."""
        from npairloss_tpu_torch.serve.engine import QueryEngine
        from npairloss_tpu_torch.serve.hotswap import (
            NothingNewerError,
            SnapshotSwapper,
        )
        from npairloss_tpu_torch.serve.index import list_indexes, load_newest
        from npairloss_tpu_torch.serve.server import Freshness

        entry = self.server.tenants[tenant_id]
        spec = entry.spec
        fresh = entry.freshness
        # A directory listing before any load: the sweep visits every
        # tenant every few seconds, and "nothing new" must cost a
        # listdir, not an index load.
        cands = list_indexes(spec.index_prefix)
        current = fresh.index_path if fresh else None
        if not cands or not SnapshotSwapper._index_is_newer(
                cands[-1][1], current):
            raise NothingNewerError(
                f"tenant {tenant_id!r}: no index commit newer than "
                "the served one")
        old = entry.engines[0]
        found = load_newest(spec.index_prefix, device=old.device)
        if found is None or not SnapshotSwapper._index_is_newer(
                found[0], fresh.index_path if fresh else None):
            raise NothingNewerError(
                f"tenant {tenant_id!r}: no index commit newer than "
                "the served one")
        path, index = found
        index = reconcile_index_kind(
            index, spec.index_kind, clusters=self.ivf_clusters,
            seed=self.seed)
        primary = self.programs.engine_for(
            index, old.cfg, model=old.model, telemetry=self.telemetry)
        warmup_s = primary.warmup(
            self.server.input_shape if old.model is not None else None)
        engines = [primary] + [
            QueryEngine(index, old.cfg, model=old.model,
                        telemetry=self.telemetry,
                        share_compiled_with=primary)
            for _ in range(len(entry.engines) - 1)
        ]
        freshness = Freshness.collect(index=index, index_path=path)
        self.server.swap_tenant_engines(tenant_id, engines, freshness)
        detail: Dict[str, Any] = {
            "tenant": tenant_id,
            "swapped": ["index"],
            "warmup_s": round(warmup_s, 3),
            **freshness.identity(),
        }
        if self.telemetry is not None:
            self.telemetry.instant("serve/hot_swap", **{
                k: v for k, v in detail.items() if k != "swapped"})
        return detail

    def sweep(self) -> Dict[str, Dict[str, Any]]:
        """One pass over every tenant; returns {tenant_id: swap detail}
        for the tenants that swapped.  A tenant with nothing newer is
        skipped silently; any OTHER failure is logged and contained to
        its tenant: one broken prefix must not stall the sweep."""
        from npairloss_tpu_torch.serve.hotswap import NothingNewerError

        out: Dict[str, Dict[str, Any]] = {}
        for tid in list(self.server.tenants):
            try:
                out[tid] = self.swap_one(tid)
            except NothingNewerError:
                continue
            except Exception as e:  # noqa: BLE001 — contain per tenant
                log.error("tenant %r hot-swap failed: %s", tid, e)
        return out

    def start(self, period_s: float = 2.0) -> "TenantSwapper":
        if self._thread is not None:
            raise RuntimeError("TenantSwapper already started")
        self._stop.clear()

        def _loop() -> None:
            while not self._stop.wait(period_s):
                self.sweep()

        self._thread = threading.Thread(
            target=_loop, name="tenant-swapper", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
