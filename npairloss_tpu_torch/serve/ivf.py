"""IVFIndex — the clustered (inverted-file) gallery index.

Port of ``npairloss_tpu/serve/ivf.py`` for one device: k-means
centroids (``ops/kmeans.py``), every row assigned to its nearest
centroid, rows packed per cluster into a dense ``(KC, cap, D)`` slab
(``cap`` = the largest cluster; short clusters pad with row id -1) plus
a ``(KC, cap)`` table of original gallery row ids, so answers keep the
flat index's row numbering.  The slab is scored in fp32, bf16, or int8
with a per-cluster max-abs scale.

Unlike the JAX package, ``cap`` is not rounded up to a multiple of 32:
that alignment was a TPU tiling rule, and the CUDA probe kernel takes
any ``cap``.  A ``.gidx`` stores centroids and assignments, not the
slab, so indexes committed by either package load in the other.

``add`` puts each new row in its nearest EXISTING cluster (no
re-clustering) and republishes the packed layout as one
:class:`IVFLayout` reference; ``cap`` grows with the largest cluster.
``from_gallery`` clusters a flat gallery (a flat commit served through
IVF).  ``measure_parity`` is the build-time recall birth certificate
that ``index --parity-sample`` stamps into the manifest.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from npairloss_tpu_torch.device import DeviceLike, resolve_device
from npairloss_tpu_torch.ops.kmeans import assign_to_centroids, kmeans_fit
from npairloss_tpu_torch.serve.index import (
    KIND_REGISTRY,
    GalleryIndex,
    SnapshotValidationError,
    _publish_ready,
)

log = logging.getLogger("npairloss_tpu_torch.serve")

IVF_KIND = "ivf-index"
SCORINGS = ("fp32", "bf16", "int8")


class IVFLayout(NamedTuple):
    """One published generation of the device-resident index."""

    packed: torch.Tensor         # (KC, cap, D) float32
    rows: torch.Tensor           # (KC, cap) int32 global row ids, -1 = pad
    centroids: torch.Tensor      # (KC, D) float32
    cluster_valid: torch.Tensor  # (KC,) bool: non-empty clusters
    n_clusters: int
    cap: int


def quantize_int8(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-cluster max-abs quantization, round half to even:
    (KC, cap, D) fp32 -> ((KC, cap, D) int8, (KC,) fp32 scale)."""
    scale = packed.abs().amax(dim=(1, 2)) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(packed / scale[:, None, None]), -127, 127)
    return q.to(torch.int8), scale.float()


class IVFIndex(GalleryIndex):
    """Clustered gallery index.  Build via :meth:`build_ivf` or
    :meth:`load`.  The flat device arrays stay
    unplaced: the packed layout is the device residency."""

    KIND = IVF_KIND
    ARRAY_NAMES = ("emb", "labels", "ids", "centroids", "assign")

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.centroids_host: Optional[np.ndarray] = None
        self.assign_host: Optional[np.ndarray] = None
        self.layout: Optional[IVFLayout] = None
        self._scored: Dict[str, tuple] = {}
        # measure_parity's result, stamped into the manifest at build
        # time and kept through load and re-commit.
        self.parity: Optional[dict] = None

    @classmethod
    def build_ivf(cls, embeddings: np.ndarray, labels: np.ndarray,
                  ids: Optional[np.ndarray] = None, normalize: bool = True,
                  clusters: int = 0, iters: int = 10, seed: int = 0,
                  train_size: Optional[int] = 131072,
                  first: Optional[int] = None,
                  device: DeviceLike = None) -> "IVFIndex":
        """Cluster + pack a gallery.  ``clusters=0`` picks ~sqrt(N);
        ``first`` pins the k-means first seed point (see ops/kmeans.py)."""
        dev = resolve_device(device)
        emb, lab, ids = cls._validate(embeddings, labels, ids, normalize)
        n = emb.shape[0]
        kc = int(clusters) or max(1, int(round(math.sqrt(n))))
        centroids = kmeans_fit(emb, kc, iters=iters, seed=seed,
                               train_size=train_size, first=first,
                               device=dev)
        idx = cls(emb, lab, ids, dev, created=time.time())
        idx.centroids_host = centroids
        idx.assign_host = assign_to_centroids(emb, centroids, device=dev)
        idx._place()
        log.info("ivf index built: %d rows -> %d clusters (cap %d, dim %d)",
                 n, idx.layout.n_clusters, idx.layout.cap, idx.dim)
        return idx

    @classmethod
    def from_gallery(cls, gallery: GalleryIndex, **build_kw) -> "IVFIndex":
        """Cluster a built or loaded flat gallery (its rows are unit-norm
        already); the ingest watermark rides along, since the rows are
        the same."""
        build_kw.setdefault("device", gallery.device)
        out = cls.build_ivf(gallery.host_emb, gallery.host_labels,
                            ids=gallery.ids, normalize=False, **build_kw)
        out.ingest_watermark = gallery.ingest_watermark
        return out

    def add(self, embeddings: np.ndarray, labels: np.ndarray,
            ids: Optional[np.ndarray] = None,
            normalize: bool = True) -> int:
        """Append rows, each to its nearest existing centroid, and
        republish the packed layout (``cap`` may grow); returns the new
        ``size``."""
        emb, lab, ids = self._validate_added_rows(
            embeddings, labels, ids, normalize)
        new_assign = assign_to_centroids(emb, self.centroids_host,
                                         device=self.device)
        self._append_host(emb, lab, ids)
        self.assign_host = np.concatenate([self.assign_host, new_assign])
        self._place()
        self.created = time.time()
        return self.size

    def _place(self) -> None:
        """Pack rows per cluster and publish a fresh layout (one reference
        swap, so a dispatch reads one generation)."""
        emb = self.host_emb
        assign = self.assign_host
        n, d = emb.shape
        kc = int(self.centroids_host.shape[0])
        sizes = np.bincount(assign, minlength=kc)
        cap = max(int(sizes.max()), 1)
        order = np.argsort(assign, kind="stable")
        offsets = np.zeros(kc + 1, np.int64)
        offsets[1:] = np.cumsum(sizes)
        packed = np.zeros((kc, cap, d), np.float32)
        rows = np.full((kc, cap), -1, np.int32)
        sa = assign[order]
        pos = np.arange(n) - offsets[sa]
        packed[sa, pos] = emb[order]
        rows[sa, pos] = order.astype(np.int32)
        dev = self.device
        layout = IVFLayout(
            packed=torch.as_tensor(packed, device=dev),
            rows=torch.as_tensor(rows, device=dev),
            centroids=torch.as_tensor(
                np.asarray(self.centroids_host, np.float32), device=dev),
            cluster_valid=torch.as_tensor(sizes > 0, device=dev),
            n_clusters=kc, cap=cap)
        _publish_ready(dev)
        self.size = n
        self.layout = layout  # the atomic republish

    def scored_arrays(self, scoring: str,
                      layout: Optional[IVFLayout] = None) -> tuple:
        """(slab, scale-or-None) for ``scoring`` against ``layout``,
        derived once per layout generation and cached."""
        if scoring not in SCORINGS:
            raise ValueError(
                f"scoring must be one of {SCORINGS}, got {scoring!r}")
        layout = self.layout if layout is None else layout
        if scoring == "fp32":
            return layout.packed, None
        cached = self._scored.get(scoring)
        if cached is not None and cached[0] is layout:
            return cached[1]
        if scoring == "bf16":
            out = (layout.packed.to(torch.bfloat16), None)
        else:
            out = quantize_int8(layout.packed)
        # Replicas read the cached slab from their own streams.
        _publish_ready(layout.packed.device)
        self._scored[scoring] = (layout, out)
        return out

    @property
    def n_clusters(self) -> int:
        return int(self.layout.n_clusters)

    # -- persistence -------------------------------------------------------

    def _tree(self):
        return {**super()._tree(), "centroids": self.centroids_host,
                "assign": self.assign_host}

    def _manifest_extra(self) -> dict:
        return {**super()._manifest_extra(),
                "n_clusters": int(self.centroids_host.shape[0]),
                **({"parity": self.parity} if self.parity else {})}

    def _restore_extra(self, tree, manifest) -> None:
        parity = manifest.get("parity")
        if isinstance(parity, dict):
            self.parity = parity
        self.centroids_host = np.asarray(tree["centroids"], np.float32)
        self.assign_host = np.asarray(tree["assign"], np.int32)
        if self.assign_host.shape[0] != self.size:
            raise SnapshotValidationError(
                f"ivf assignment length {self.assign_host.shape[0]} != "
                f"gallery size {self.size}")


KIND_REGISTRY[IVF_KIND] = IVFIndex


def topk_recall(approx_rows: np.ndarray, exact_rows: np.ndarray,
                k: Optional[int] = None) -> float:
    """Recall@K of approximate answers against the exact oracle: mean
    over queries of |approx top-K ∩ exact top-K| / K."""
    a = np.asarray(approx_rows)
    e = np.asarray(exact_rows)
    if a.shape[0] != e.shape[0]:
        raise ValueError(f"query counts differ: {a.shape[0]} vs {e.shape[0]}")
    if a.shape[0] == 0:
        return 1.0
    k = int(k) if k is not None else int(e.shape[1])
    hits = sum(len(set(a[i, :k].tolist()) & set(e[i, :k].tolist()))
               for i in range(a.shape[0]))
    return hits / float(a.shape[0] * k)


def measure_parity(index: IVFIndex, probes: int = 8,
                   ks: Tuple[int, ...] = (1, 5, 10), sample: int = 256,
                   scorings: Tuple[str, ...] = SCORINGS,
                   seed: int = 0) -> dict:
    """The build-time recall birth certificate: recall@K of the probe
    path against the flat exact scan, per scoring mode, on ``sample``
    gallery rows (numpy's generator from ``seed``) used as queries —
    the JAX package's measurement, on the index's device."""
    from npairloss_tpu_torch.serve.engine import EngineConfig, QueryEngine

    n = index.size
    ks = tuple(k for k in ks if k <= n)
    if not ks:
        raise ValueError(f"gallery of {n} rows supports none of ks")
    kmax = max(ks)
    m = min(int(sample), n)
    rng = np.random.default_rng(seed)
    rows = rng.choice(n, size=m, replace=False)
    queries = index.host_emb[rows]
    bucket = min(64, m)
    flat = GalleryIndex.build(index.host_emb, index.host_labels,
                              ids=index.ids, normalize=False,
                              device=index.device)
    oracle = QueryEngine(flat, EngineConfig(top_k=kmax, buckets=(bucket,),
                                            scoring="fp32"))
    exact = oracle.query(queries, normalize=False)["rows"]
    probes = max(1, min(int(probes), index.n_clusters))
    recall: Dict[str, Dict[str, float]] = {}
    for scoring in scorings:
        engine = QueryEngine(index, EngineConfig(
            top_k=kmax, buckets=(bucket,), probes=probes, scoring=scoring))
        approx = engine.query(queries, normalize=False)["rows"]
        recall[scoring] = {f"at_{k}": round(topk_recall(approx, exact, k), 4)
                           for k in ks}
    return {"probes": probes, "sample": m, "ks": list(ks), "recall": recall,
            "measured_at": time.time()}
