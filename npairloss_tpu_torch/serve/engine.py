"""QueryEngine — the online query path: encode -> top-k answers.

Port of ``npairloss_tpu/serve/engine.py`` for one device.  Three top-k
paths, chosen by the index kind and ``EngineConfig.probe_impl``:

  * flat: :func:`stream_topk`, gallery blocks scored by ``torch.matmul``
    with a running top-k merge (the B x N matrix is never built whole);
  * IVF ``scan``: :func:`ivf_scan_topk`, per-probe gather + score +
    merge in plain torch;
  * IVF ``fused``: ``ops.ivf_probe.fused_probe_topk``, whose stage 2 is
    the hand-written probe kernel on the card.

Every top-k keeps ``lax.top_k``'s rule that the lowest index wins a tie
(``torch.topk`` promises no order, so merges use a stable descending
sort), so answers match the JAX engine row for row.

Compile accounting, as JAX's (``compiles_total``,
``compiles_after_warmup``, ``warmed``, :meth:`compile_stats`).  PyTorch
runs eagerly and has no executables to count, so the port's "compile" is
a dispatch signature first met by the tier: a new IVF layout after an
ingest, an unwarmed input shape (new kernels' first launches, cuDNN's
algorithm search).  Replicas share the primary's signature set, so a
replica's first dispatch of a warmed bucket is no compile.  A compile
after warmup also counts in ``compiles_after_warmup`` (the window rows'
key the post-warmup-compile watchdog reads) and, with telemetry, marks a
``serve/recompile`` instant.  The ``serve.compile_storm`` failpoint
counts a phantom one on a warmed engine.  :meth:`rewarm` re-dispatches
every bucket and resets ``compiles_after_warmup`` when it succeeds.

With ``telemetry`` (a ``RunTelemetry``; replicas share the primary's)
every dispatch is spanned as in JAX: ``serve/topk`` and ``serve/encode``
(``batch``, ``bucket``) around the device work AND the copy of its
results to the host — the engine already makes that copy, so a span
closes when the work is done and adds no sync — and ``serve/warmup``
(``bucket``, ``kind``) around each warm-up dispatch.  Without telemetry
the engine records no spans.

``query(..., stages={})`` fills a per-call accumulator for the query
tracer (``obs/qtrace``): ``score_us`` from the dispatch's launch
through the host copy of its scores and rows (the copy is the one sync
point the engine already has), ``merge_us`` the host gather of labels
and ids.  The ``serve.recall_drop`` failpoint, on a warmed IVF engine
only, runs a dispatch against the negated query (the worst clusters are
probed and recall collapses; shapes stay the same); a flat engine, the
shadow scorer's oracle among them, never consumes it.

A replica engine (``share_compiled_with=primary``) shares the primary's
index object, model and built kernels: one warmup warms the tier and no
replica copies the gallery.  An engine over ANOTHER index
(``share_programs_with=other``, multi-tenant serving through
``serve/tenants.py``'s ``ProgramCache``) shares only ``other``'s
signature set and its lock, so tenants at one geometry count a signature
once: two flat galleries of the same N x D share every signature, two
IVF galleries only when their packed layouts have the same shape.  It
refuses, with JAX's messages, whatever its dispatch depends on: another
``EngineConfig``, index kind, device or model object.  On the card every replica dispatches on its
own CUDA stream (the primary on the current one), so replicas' batches
overlap; a dispatch reads the
index's published layout once and holds it until its results are on the
host, so an ingest that republishes the layout never frees memory a
dispatch still reads.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from npairloss_tpu_torch.obs.perf import count
from npairloss_tpu_torch.ops.ivf_probe import (
    NEG_FILL,
    PROBE_IMPLS,
    fused_probe_topk,
    probe_select,
    resolve_probe_impl,
    score_query,
)
from npairloss_tpu_torch.ops.normalize import l2_normalize
from npairloss_tpu_torch.resilience import failpoints
from npairloss_tpu_torch.serve.index import GalleryIndex, l2_normalize_rows
from npairloss_tpu_torch.serve.ivf import SCORINGS, IVFIndex

log = logging.getLogger("npairloss_tpu_torch.serve")


class NoModelError(RuntimeError):
    """A raw-input query reached an engine built without a model."""


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """``buckets``: ascending query padding sizes; ``top_k``: answer
    length; ``gallery_block``: flat gallery rows scored per block;
    ``probes``: IVF clusters scored per query; ``scoring``: fp32, bf16
    or int8 (IVF only); ``probe_impl``: scan, fused or auto (fused on
    CUDA, scan on the CPU)."""

    top_k: int = 10
    buckets: Tuple[int, ...] = (1, 8, 32)
    gallery_block: int = 4096
    probes: int = 8
    scoring: str = "fp32"
    probe_impl: str = "scan"

    def __post_init__(self):
        if not self.buckets or list(self.buckets) != sorted(
                set(int(b) for b in self.buckets)):
            raise ValueError(
                f"buckets must be ascending and unique, got {self.buckets}")
        if self.top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {self.top_k}")
        if self.probes < 1:
            raise ValueError(f"probes must be >= 1, got {self.probes}")
        if self.scoring not in SCORINGS:
            raise ValueError(
                f"scoring must be one of {SCORINGS}, got {self.scoring!r}")
        if self.probe_impl not in PROBE_IMPLS:
            raise ValueError(
                f"probe_impl must be one of {sorted(PROBE_IMPLS)}, "
                f"got {self.probe_impl!r}")


def _topk_stable(s: torch.Tensor, k: int):
    """Top-k along dim 1 with the lowest index winning ties."""
    sel = torch.sort(s, dim=1, descending=True, stable=True).indices[:, :k]
    return torch.gather(s, 1, sel), sel


def _scored_matmul(q: torch.Tensor, g: torch.Tensor,
                   scoring: str) -> torch.Tensor:
    """(B, n) similarities accumulated in fp32; bf16 rounds both sides
    to bf16 first (their products are exact in fp32)."""
    if scoring == "fp32":
        return q @ g.T
    return q.to(torch.bfloat16).float() @ g.to(torch.bfloat16).float().T


def stream_topk(q: torch.Tensor, emb: torch.Tensor, valid: torch.Tensor,
                k: int, block: int, scoring: str = "fp32"):
    """Running top-k of ``q @ emb.T`` over gallery blocks; (B, k) scores
    and rows.  The last block is clamped to end at N and masks the rows
    an earlier block scored, so every row is a candidate once."""
    n = int(emb.shape[0])
    b = int(min(block, n))
    kb = min(k, b)
    bq = q.shape[0]
    best_s = torch.full((bq, k), NEG_FILL, device=q.device)
    best_r = torch.zeros((bq, k), dtype=torch.int32, device=q.device)
    for j in range(-(-n // b)):
        start = min(j * b, n - b)
        sims = _scored_matmul(q, emb[start:start + b], scoring)
        rows = start + torch.arange(b, dtype=torch.int32, device=q.device)
        ok = valid[start:start + b] & (rows >= j * b)
        sims = torch.where(ok[None, :], sims, torch.full_like(sims, NEG_FILL))
        blk_s, blk_i = _topk_stable(sims, kb)
        blk_r = rows[blk_i]
        best_s, sel = _topk_stable(torch.cat([best_s, blk_s], 1), k)
        best_r = torch.gather(torch.cat([best_r, blk_r], 1), 1, sel)
    return best_s, best_r


def ivf_scan_topk(q, packed, rows, centroids, cvalid, scale, *, k: int,
                  probes: int, scoring: str, g0: int = 0):
    """The scan baseline: centroid pick, then per probe gather the
    (B, cap, D) slab, score, take its top-kb and merge; (B, kl) scores
    and global rows, kl = min(k, C * cap)."""
    kc_local, cap, _ = packed.shape
    c = min(int(probes), int(centroids.shape[0]))
    kl = min(int(k), c * int(cap))
    _, lids, owned = probe_select(q, centroids, cvalid, probes, g0,
                                  int(kc_local))
    qs = score_query(scoring, q)
    bq = q.shape[0]
    best_s = torch.full((bq, kl), NEG_FILL, device=q.device)
    best_r = torch.zeros((bq, kl), dtype=torch.int32, device=q.device)
    kb = min(kl, int(cap))
    for j in range(c):
        lid = lids[:, j].long()
        g = packed[lid].float()
        r = rows[lid]
        sims = torch.bmm(g, qs[:, :, None])[:, :, 0]
        if scale is not None:
            sims = sims * scale[lid][:, None]
        ok = (r >= 0) & owned[:, j:j + 1]
        sims = torch.where(ok, sims, torch.full_like(sims, NEG_FILL))
        blk_s, blk_i = _topk_stable(sims, kb)
        blk_r = torch.gather(r, 1, blk_i)
        best_s, sel = _topk_stable(torch.cat([best_s, blk_s], 1), kl)
        best_r = torch.gather(torch.cat([best_r, blk_r], 1), 1, sel)
    return best_s, best_r


def finalize_topk(s: torch.Tensor, r: torch.Tensor, k: int):
    """Clamp an IVF candidate list to (B, k): pad with -FLT_MAX columns
    when the probes cannot yield k candidates, and pin every unfilled
    slot's row to 0 (a valid gallery row for the host-side lookups)."""
    kl = s.shape[1]
    if kl < k:
        pad = k - kl
        s = torch.cat([s, torch.full((s.shape[0], pad), NEG_FILL,
                                     device=s.device)], 1)
        r = torch.cat([r, torch.zeros((r.shape[0], pad), dtype=r.dtype,
                                      device=r.device)], 1)
    else:
        s, sel = _topk_stable(s, k)
        r = torch.gather(r, 1, sel)
    r = torch.where(s > NEG_FILL * 0.5, r, torch.zeros_like(r))
    return s, r


class QueryEngine:
    """Answers ``(B, D)`` query embeddings with the gallery's top-k on
    the index's device.  ``model`` (an ``nn.Module`` on the same device)
    enables :meth:`encode` for raw-input queries.  Dispatches come from
    the replica's batcher thread, and also from a dead replica's while
    the server reroutes its batches here; a dispatch keeps no state on
    the engine but its counter, which takes a lock."""

    def __init__(self, index: GalleryIndex,
                 cfg: EngineConfig = EngineConfig(), model=None,
                 share_compiled_with: Optional["QueryEngine"] = None,
                 telemetry=None,
                 share_programs_with: Optional["QueryEngine"] = None):
        if cfg.top_k > index.size:
            raise ValueError(
                f"top_k={cfg.top_k} exceeds gallery size {index.size}")
        if share_compiled_with is not None and \
                share_programs_with is not None:
            raise ValueError("share_compiled_with and share_programs_with "
                             "are mutually exclusive")
        if share_programs_with is not None:
            other = share_programs_with
            if other.cfg != cfg:
                raise ValueError(
                    "share_programs_with requires an identical "
                    f"EngineConfig (got {cfg} vs {other.cfg})")
            if other._ivf != isinstance(index, IVFIndex):
                raise ValueError(
                    "share_programs_with requires the same index kind "
                    "(flat vs IVF programs differ)")
            if other.device != index.device:
                raise ValueError(
                    "share_programs_with requires the same device (the "
                    "dispatch runs where the index lives)")
            if other.model is not model:
                raise ValueError(
                    "share_programs_with requires the same model object "
                    "(the encode program captures it; state is an "
                    "argument)")
        if share_compiled_with is not None:
            other = share_compiled_with
            if other.index is not index or other.cfg != cfg:
                raise ValueError(
                    "share_compiled_with requires the same index object "
                    "and an identical EngineConfig")
            if model is None:
                model = other.model
            elif model is not other.model:
                raise ValueError(
                    "share_compiled_with requires the primary's model")
        self.index = index
        self.cfg = cfg
        self.model = model
        self.device = index.device
        self._ivf = isinstance(index, IVFIndex)
        self.probe_impl = (resolve_probe_impl(cfg.probe_impl, self.device)
                           if self._ivf else None)
        if cfg.scoring == "int8" and not self._ivf:
            raise ValueError("scoring='int8' needs an IVF index (the "
                             "per-cluster scale has no flat equivalent)")
        if model is not None:
            mdev = next(model.parameters()).device
            if mdev.type != self.device.type:
                raise ValueError(f"model on {mdev}, index on {self.device}")
        self.warmed = (share_compiled_with.warmed
                       if share_compiled_with is not None else False)
        self.dispatches = 0  # guarded-by: _count_lock
        self.compiles_total = 0  # guarded-by: _count_lock
        self.compiles_after_warmup = 0  # guarded-by: _count_lock
        self._count_lock = threading.Lock()
        # Spans (telemetry only) and the signatures dispatched so far,
        # shared with the primary (with the lock that guards them), so a
        # replica's first dispatch of a warmed bucket is not a new one.
        if telemetry is None and share_compiled_with is not None:
            telemetry = share_compiled_with.telemetry
        self.telemetry = telemetry
        shared = share_compiled_with or share_programs_with
        if shared is not None:
            self._seen_sigs = shared._seen_sigs
            self._sig_lock = shared._sig_lock
        else:
            self._seen_sigs: set = set()  # guarded-by: _sig_lock
            self._sig_lock = threading.Lock()
        # A replica dispatches on a stream of its own, so replicas'
        # batches overlap on the card; a primary keeps the current one
        # (in turns with it, one engine on its own stream ran 0-14 %
        # slower on an H100: PERF.md §6).  An engine that shares programs
        # is a primary too.
        self.stream = None
        if self.device.type == "cuda" and share_compiled_with is not None:
            self.stream = torch.cuda.Stream(self.device)
            # Whatever the current stream has queued (the model's and
            # the index's uploads) comes before this engine's work.
            self.stream.wait_stream(torch.cuda.current_stream(self.device))

    def _span(self, name: str, **args):
        if self.telemetry is None:
            return contextlib.nullcontext()
        return self.telemetry.span(name, **args)

    def _count_compiles(self, sig: tuple) -> None:
        """JAX's ``_count_compiles`` for the port: a signature first met
        by the tier counts in ``compiles_total``, and after warmup in
        ``compiles_after_warmup`` with a ``serve/recompile`` instant.
        ``serve.compile_storm`` counts a PHANTOM post-warmup compile so
        the re-warm remediation is drivable; the order matters, as in
        JAX: an unwarmed (re-warming) engine never consumes an armed
        fire."""
        with self._sig_lock:
            fresh = sig not in self._seen_sigs
            self._seen_sigs.add(sig)
        storm = self.warmed and failpoints.should_fire("serve.compile_storm")
        if not (fresh or storm):
            return
        with self._count_lock:
            self.compiles_total += 1
            if not self.warmed:
                return
            self.compiles_after_warmup += 1
        if self.telemetry is not None:
            self.telemetry.instant("serve/recompile", sig=str(sig))
        log.warning("serve: post-warmup dispatch of a new signature "
                    "(sig=%s)", sig)

    def _on_stream(self):
        """This engine's CUDA stream as the current one (no-op on the
        CPU)."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def bucket_for(self, n: int) -> int:
        for b in self.cfg.buckets:
            if n <= b:
                return b
        raise ValueError(f"batch of {n} exceeds the largest bucket "
                         f"{self.cfg.buckets[-1]} (the batcher must chunk)")

    # -- encode ------------------------------------------------------------

    def encode(self, inputs: np.ndarray) -> np.ndarray:
        """Raw NHWC inputs -> unit-norm query embeddings through the trunk
        (eval mode), padded to a bucket like :meth:`query`."""
        if self.model is None:
            raise NoModelError("engine built without a model: embedding "
                               "queries only")
        x = np.asarray(inputs, np.float32)
        n = x.shape[0]
        bucket = self.bucket_for(n)
        if bucket > n:
            x = np.concatenate(
                [x, np.zeros((bucket - n, *x.shape[1:]), np.float32)])
        with self._span("serve/encode", batch=n, bucket=bucket), \
                torch.inference_mode(), self._on_stream():
            emb = l2_normalize(self.model(torch.as_tensor(
                x, device=self.device)))
            out = emb[:n].cpu().numpy()
        self._count_compiles(("encode", tuple(x.shape)))
        return out

    # -- query -------------------------------------------------------------

    def query(self, embeddings: np.ndarray, normalize: bool = True,
              stages: Optional[Dict[str, float]] = None
              ) -> Dict[str, np.ndarray]:
        """Top-k for (B, D) query embeddings: ``{"scores", "rows",
        "labels", "ids"}``, each (B, top_k).  Batches above the largest
        bucket are chunked.  ``stages`` (optional, per call: a crash
        reroute dispatches two batches on one engine at once) sums the
        chunks' ``score_us`` and ``merge_us``."""
        q = np.asarray(embeddings, np.float32)
        if q.ndim != 2 or q.shape[1] != self.index.dim:
            raise ValueError(f"queries {q.shape} do not match gallery dim "
                             f"{self.index.dim}")
        if q.shape[0] == 0:
            k = self.cfg.top_k
            return {"scores": np.zeros((0, k), np.float32),
                    "rows": np.zeros((0, k), np.int32),
                    "labels": np.zeros((0, k), np.int32),
                    "ids": np.zeros((0, k), np.int64)}
        if normalize:
            q = l2_normalize_rows(q)
        max_b = self.cfg.buckets[-1]
        outs = [self._query_bucketed(q[i:i + max_b], stages=stages)
                for i in range(0, q.shape[0], max_b)]
        return {key: np.concatenate([o[key] for o in outs])
                for key in outs[0]}

    def _topk(self, q: torch.Tensor):
        """(scores, rows, held): ``held`` keeps the generation's device
        arrays alive until the caller has the results on the host."""
        cfg = self.cfg
        idx = self.index
        if not self._ivf:
            placed = idx.placed  # read once: one generation per dispatch
            s, r = stream_topk(q, placed.emb, placed.valid, cfg.top_k,
                               cfg.gallery_block, cfg.scoring)
            return s, r, placed
        layout = idx.layout  # read once: one generation per dispatch
        slab, scale = idx.scored_arrays(cfg.scoring, layout=layout)
        probe_fn = (fused_probe_topk if self.probe_impl == "fused"
                    else ivf_scan_topk)
        s, r = probe_fn(q, slab, layout.rows, layout.centroids,
                        layout.cluster_valid, scale, k=cfg.top_k,
                        probes=cfg.probes, scoring=cfg.scoring, g0=0)
        s, r = finalize_topk(s, r, cfg.top_k)
        return s, r, (layout, slab, scale)

    def _topk_sig(self, bucket: int, held) -> tuple:
        """The shapes a top-k dispatch ran at: the bucket and the
        generation it read."""
        if not self._ivf:
            return ("topk", bucket, tuple(held.emb.shape))
        layout = held[0]
        return ("ivf", bucket, tuple(layout.packed.shape), self.cfg.scoring,
                self.probe_impl)

    def _query_bucketed(self, q: np.ndarray,
                        stages: Optional[Dict[str, float]] = None
                        ) -> Dict[str, np.ndarray]:
        n = q.shape[0]
        bucket = self.bucket_for(n)
        if bucket > n:
            q = np.concatenate(
                [q, np.zeros((bucket - n, q.shape[1]), np.float32)])
        # serve.recall_drop: this dispatch probes for the NEGATED query,
        # so the worst clusters are scored and recall collapses while
        # every shape stays the same.  Warmed engines only (warm-up
        # never consumes an armed fire), IVF only (a flat engine, the
        # shadow oracle among them, leaves the arming untouched).
        if self._ivf and self.warmed and \
                failpoints.should_fire("serve.recall_drop"):
            q = -q
        t_score = time.perf_counter()
        with self._span("serve/topk", batch=n, bucket=bucket), \
                torch.inference_mode(), self._on_stream():
            q_dev = torch.as_tensor(q, device=self.device)
            with count.scope("serve/topk"):  # obs.perf.count's region
                scores, rows, held = self._topk(q_dev)
            scores = scores[:n].cpu().numpy()
            rows = rows[:n].cpu().numpy()
        self._count_compiles(self._topk_sig(bucket, held))
        del held  # the results are on the host: the generation may go
        with self._count_lock:
            self.dispatches += 1
        t_merge = time.perf_counter()
        # Host arrays are replaced before a layout is published and only
        # grow, so they cover every row of the generation just read.
        out = {"scores": scores, "rows": rows,
               "labels": self.index.host_labels[rows],
               "ids": self.index.ids[rows]}
        if stages is not None:
            # The qtrace score/topk_merge split: device top-k through
            # its host copy, then the host gather.
            stages["score_us"] = stages.get("score_us", 0.0) \
                + (t_merge - t_score) * 1e6
            stages["merge_us"] = stages.get("merge_us", 0.0) \
                + (time.perf_counter() - t_merge) * 1e6
        return out

    # -- warmup ------------------------------------------------------------

    def warmup(self, input_shape: Optional[Sequence[int]] = None) -> float:
        """One dummy dispatch per bucket (and per encode bucket when a
        model is attached): loads the kernel library, picks cuDNN
        algorithms and fills the allocator before traffic.  Returns the
        wall seconds spent."""
        t0 = time.perf_counter()
        for bucket in self.cfg.buckets:
            with self._span("serve/warmup", bucket=bucket, kind="topk"):
                self._query_bucketed(np.zeros((bucket, self.index.dim),
                                              np.float32))
            if self.model is not None:
                if input_shape is None:
                    raise ValueError("warmup needs input_shape to warm the "
                                     "encode path")
                with self._span("serve/warmup", bucket=bucket,
                                kind="encode"):
                    self.encode(np.zeros((bucket, *tuple(input_shape)),
                                         np.float32))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.warmed = True
        dt = time.perf_counter() - t0
        log.info("serve warmup: %d bucket(s) in %.2fs",
                 len(self.cfg.buckets), dt)
        return dt

    def rewarm(self, input_shape: Optional[Sequence[int]] = None) -> float:
        """Re-prime every padding bucket and RESET the post-warmup
        compile counter — the compile-storm remediation action, as JAX's.
        The re-warm dispatches run with ``warmed`` cleared, so whatever
        they meet counts as warmup, and ``compiles_after_warmup``
        restarts at zero so the post-warmup-compile watchdog can observe
        recovery.  They take this engine's stream, as its serving
        dispatches do, and each reads the published index layout once.
        Returns wall seconds.

        A re-warm that RAISES resets nothing: ``warmed`` is restored so
        accounting stays armed, and the storm evidence in
        ``compiles_after_warmup`` survives for the alert that triggered
        the failed remediation."""
        self.warmed = False
        try:
            dt = self.warmup(input_shape)  # sets warmed=True on success
        except BaseException:
            self.warmed = True
            raise
        with self._count_lock:
            self.compiles_after_warmup = 0
        return dt

    def compile_stats(self) -> Dict[str, object]:
        """JAX's counters (there is no executable cache to size)."""
        with self._count_lock:
            return {"warmed": self.warmed,
                    "compiles_total": self.compiles_total,
                    "compiles_after_warmup": self.compiles_after_warmup}

    def stats(self) -> Dict[str, object]:
        return {"warmed": self.warmed, "dispatches": self.dispatches,
                **({"probe_impl": self.probe_impl} if self._ivf else {})}
