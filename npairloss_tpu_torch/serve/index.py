"""GalleryIndex — the device-resident gallery a query runs against.

Port of ``npairloss_tpu/serve/index.py`` for one device: (N, D)
L2-normalized embeddings with labels and a validity mask on the device,
item ids on the host.  The ``.gidx`` on-disk layout is the JAX
package's: ``.npy`` arrays plus ``manifest.json`` with per-array CRC-32
(``serve/manifest.py``), committed by an atomic directory rename — an
index saved by either package loads in the other.

``add`` appends rows (the ingest path and ``index --add-to``) and
republishes the device arrays as ONE :class:`FlatLayout` reference, so
a dispatch that reads ``placed`` once sees one generation.  The host
arrays are replaced before the device layout, and rows are only ever
appended: a dispatch holding an older layout still maps its rows
through the newer host arrays correctly.  ``ingest_watermark`` (the
last write-ahead-log sequence number the rows contain) rides in the
manifest under the JAX package's key, omitted at 0.  ``load_newest``
scans ``<prefix>*.gidx`` newest first and skips torn or tmp commits.
"""

from __future__ import annotations

import logging
import os
import shutil
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from npairloss_tpu_torch.device import DeviceLike, resolve_device
from npairloss_tpu_torch.resilience import failpoints
from npairloss_tpu_torch.serve.manifest import (
    TMP_MARKER,
    SnapshotValidationError,
    fsync_dir,
    read_manifest,
    state_checksums,
    validate_snapshot,
    verify_restored,
    write_manifest,
)

log = logging.getLogger("npairloss_tpu_torch.serve")

INDEX_KIND = "gallery-index"
INDEX_SUFFIX = ".gidx"
# Committed-index kind -> class; serve/ivf.py registers ``ivf-index``.
KIND_REGISTRY: Dict[str, type] = {}


def l2_normalize_rows(x: np.ndarray) -> np.ndarray:
    """Host-side row L2-normalize (an all-zero row stays zero) — shared
    by build and query so both normalize identically."""
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)


class FlatLayout(NamedTuple):
    """One published generation of the flat gallery on the device."""

    emb: torch.Tensor     # (N, D) float32
    labels: torch.Tensor  # (N,) int32
    valid: torch.Tensor   # (N,) bool


class GalleryIndex:
    """Flat gallery.  Build via :meth:`build` or :meth:`load`.

    ``placed`` holds ``emb`` (N, D) fp32, ``labels`` (N,) int32 and
    ``valid`` (N,) bool on ``device``; ``ids`` (N,) int64 and the
    master copies ``host_emb``/``host_labels`` live on the host."""

    KIND = INDEX_KIND
    ARRAY_NAMES = ("emb", "labels", "ids")

    def __init__(self, host_emb: np.ndarray, host_labels: np.ndarray,
                 ids: np.ndarray, device: torch.device,
                 created: Optional[float] = None):
        self.host_emb = np.asarray(host_emb, np.float32)
        self.host_labels = np.asarray(host_labels, np.int32)
        self.ids = np.asarray(ids, np.int64)
        self.device = device
        self.created = created
        self.size = int(self.host_emb.shape[0])
        self.placed: Optional[FlatLayout] = None
        # The last WAL sequence number these rows contain (0 = none).
        self.ingest_watermark = 0

    @staticmethod
    def _validate(embeddings, labels, ids, normalize: bool):
        emb = np.asarray(embeddings, np.float32)
        lab = np.asarray(labels, np.int32).reshape(-1)
        if emb.ndim != 2 or emb.shape[0] != lab.shape[0]:
            raise ValueError(
                f"embeddings {emb.shape} / labels {lab.shape} mismatch")
        if emb.shape[0] == 0:
            raise ValueError("cannot build an empty gallery")
        if normalize:
            emb = l2_normalize_rows(emb)
        if ids is None:
            ids = np.arange(emb.shape[0], dtype=np.int64)
        else:
            ids = np.asarray(ids, np.int64).reshape(-1)
            if ids.shape[0] != emb.shape[0]:
                raise ValueError(
                    f"ids {ids.shape} / embeddings {emb.shape} mismatch")
        return emb, lab, ids

    @classmethod
    def build(cls, embeddings: np.ndarray, labels: np.ndarray,
              ids: Optional[np.ndarray] = None, normalize: bool = True,
              device: DeviceLike = None) -> "GalleryIndex":
        """Index extracted embeddings; ``normalize=False`` trusts the rows
        are unit-norm already."""
        dev = resolve_device(device)
        emb, lab, ids = cls._validate(embeddings, labels, ids, normalize)
        idx = cls(emb, lab, ids, dev, created=time.time())
        idx._place()
        return idx

    def _place(self) -> None:
        layout = FlatLayout(
            emb=torch.as_tensor(self.host_emb, device=self.device),
            labels=torch.as_tensor(self.host_labels, device=self.device),
            valid=torch.ones(self.host_emb.shape[0], dtype=torch.bool,
                             device=self.device))
        _publish_ready(self.device)
        self.size = int(self.host_emb.shape[0])
        self.placed = layout  # the atomic republish

    @property
    def dim(self) -> int:
        return int(self.host_emb.shape[1])

    @property
    def padded_size(self) -> int:
        """Rows the device holds: one device needs no padding, so the
        true row count (JAX pads to the mesh width)."""
        return int(self.size)

    # -- incremental add ---------------------------------------------------

    def _validate_added_rows(self, embeddings, labels, ids,
                             normalize: bool):
        """Coerce and check an :meth:`add` payload against this gallery;
        ``ids`` default to the next ids after the largest one."""
        emb = np.asarray(embeddings, np.float32)
        lab = np.asarray(labels, np.int32).reshape(-1)
        if emb.ndim != 2 or emb.shape[1] != self.host_emb.shape[1]:
            raise ValueError(
                f"added embeddings {emb.shape} do not match gallery dim "
                f"{self.host_emb.shape[1]}")
        if emb.shape[0] != lab.shape[0]:
            raise ValueError(
                f"embeddings {emb.shape} / labels {lab.shape} mismatch")
        if normalize:
            emb = l2_normalize_rows(emb)
        if ids is None:
            start = int(self.ids.max()) + 1 if self.ids.size else 0
            ids = np.arange(start, start + emb.shape[0], dtype=np.int64)
        else:
            ids = np.asarray(ids, np.int64).reshape(-1)
            if ids.shape[0] != emb.shape[0]:
                raise ValueError(
                    f"ids {ids.shape} / embeddings {emb.shape} mismatch")
        return emb, lab, ids

    def add(self, embeddings: np.ndarray, labels: np.ndarray,
            ids: Optional[np.ndarray] = None,
            normalize: bool = True) -> int:
        """Append rows and republish the device layout; returns the new
        ``size``.  O(N) host work and one fresh upload, so adds are for
        refresh cadence, not the per-query path.  Called from one thread
        at a time (the server's ingest worker, or the CLI)."""
        emb, lab, ids = self._validate_added_rows(
            embeddings, labels, ids, normalize)
        self._append_host(emb, lab, ids)
        self._place()
        # A content refresh is a freshness event.
        self.created = time.time()
        return self.size

    def _append_host(self, emb, lab, ids) -> None:
        self.host_emb = np.concatenate([self.host_emb, emb])
        self.host_labels = np.concatenate([self.host_labels, lab])
        self.ids = np.concatenate([self.ids, ids])

    # -- persistence -------------------------------------------------------

    def _tree(self) -> Dict[str, np.ndarray]:
        return {"emb": self.host_emb, "labels": self.host_labels,
                "ids": self.ids}

    def _manifest_extra(self) -> dict:
        """Extra manifest keys; subclasses merge ``super()``'s so the
        ingest watermark survives every kind.  Omitted at 0, so a
        WAL-less commit keeps the older manifest's keys."""
        out: dict = {}
        if self.ingest_watermark:
            out["ingest_watermark"] = int(self.ingest_watermark)
        return out

    def save(self, path: str) -> str:
        """Commit atomically: arrays + CRC manifest into a ``.tmp-`` dir,
        then ``os.replace`` onto ``path`` (an existing index is moved
        aside first and removed only after the new commit)."""
        final = os.path.abspath(path)
        parent = os.path.dirname(final)
        os.makedirs(parent, exist_ok=True)
        nonce = f"{os.getpid()}-{os.urandom(2).hex()}"
        tmp = f"{final}{TMP_MARKER}{nonce}"
        os.makedirs(tmp)
        tree = self._tree()
        for name in self.ARRAY_NAMES:
            np.save(os.path.join(tmp, name + ".npy"), tree[name])
        write_manifest(tmp, 0, state_checksums(tree),
                       extra={"kind": self.KIND, "size": self.size,
                              "dim": self.dim, **self._manifest_extra()})
        old = None
        if os.path.isdir(final):
            old = f"{final}{TMP_MARKER}{nonce}-prev"
            os.replace(final, old)
        failpoints.fire("index.commit.crash")
        os.replace(tmp, final)
        fsync_dir(parent)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
        # Debris of earlier crashed saves of this path (another nonce).
        stale_mark = os.path.basename(final) + TMP_MARKER
        for name in os.listdir(parent):
            if name.startswith(stale_mark):
                shutil.rmtree(os.path.join(parent, name), ignore_errors=True)
        log.info("gallery index -> %s (%d rows, dim %d)", final, self.size,
                 self.dim)
        return final

    @classmethod
    def load(cls, path: str, device: DeviceLike = None) -> "GalleryIndex":
        """Restore a committed index, checksum-verified against its
        manifest; raises :class:`SnapshotValidationError` on a torn or
        corrupt one."""
        dev = resolve_device(device)
        manifest = validate_snapshot(os.path.abspath(path))
        if manifest.get("kind") != cls.KIND:
            raise SnapshotValidationError(
                f"{path} is not a {cls.KIND} (kind={manifest.get('kind')!r})")
        tree = {}
        for name in cls.ARRAY_NAMES:
            p = os.path.join(path, name + ".npy")
            try:
                tree[name] = np.load(p)
            except (OSError, ValueError) as e:
                raise SnapshotValidationError(
                    f"unreadable index array {p}: {e}") from e
        verify_restored(tree, manifest)
        created = manifest.get("created")
        idx = cls(tree["emb"], tree["labels"], tree["ids"], dev,
                  created=(float(created)
                           if isinstance(created, (int, float)) else None))
        idx._restore_extra(tree, manifest)
        wm = manifest.get("ingest_watermark")
        idx.ingest_watermark = int(wm) if isinstance(wm, int) else 0
        idx._place()
        return idx

    def _restore_extra(self, tree, manifest) -> None:
        """Subclass hook: take extra arrays from a verified tree."""


def _publish_ready(device: torch.device) -> None:
    """Wait for the uploads of a new layout before it is published:
    replicas read it from their own CUDA streams, which do not order
    after the stream that copied it."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def list_indexes(prefix: str) -> List[Tuple[str, str]]:
    """Committed candidates ``<prefix>*.gidx`` as (name, path), sorted
    by name; tmp dirs never match."""
    prefix = os.path.abspath(prefix)
    parent, base = os.path.dirname(prefix), os.path.basename(prefix)
    out: List[Tuple[str, str]] = []
    try:
        entries = os.listdir(parent)
    except OSError:
        return out
    for name in entries:
        if (name.startswith(base) and name.endswith(INDEX_SUFFIX)
                and TMP_MARKER not in name):
            path = os.path.join(parent, name)
            if os.path.isdir(path):
                out.append((name, path))
    out.sort()
    return out


def load_newest(prefix: str, device: DeviceLike = None
                ) -> Optional[Tuple[str, GalleryIndex]]:
    """The newest ``<prefix>*.gidx`` (by name) that loads, of any kind;
    torn or corrupt candidates are skipped with a logged reason.
    Returns (path, index) or None."""
    for _, path in reversed(list_indexes(prefix)):
        try:
            return path, load_index(path, device=device)
        except Exception as e:  # noqa: BLE001 — skip, try the next
            log.warning("index load: skipping %s: %s", path, e)
    return None


def index_info(path: str) -> dict:
    """Manifest summary for tooling (no array loads)."""
    m = read_manifest(path)
    return {
        "path": os.path.abspath(path),
        "kind": m.get("kind"),
        "size": m.get("size"),
        "dim": m.get("dim"),
        "created": m.get("created"),
        "ingest_watermark": int(m.get("ingest_watermark", 0) or 0),
    }


def load_index(path: str, device: DeviceLike = None) -> GalleryIndex:
    """Load a committed index of any registered kind (the manifest's
    ``kind`` picks the class)."""
    kind = read_manifest(path).get("kind")
    if kind == INDEX_KIND:
        return GalleryIndex.load(path, device=device)
    if kind not in KIND_REGISTRY:
        import npairloss_tpu_torch.serve.ivf  # noqa: F401  (registers)
    cls = KIND_REGISTRY.get(kind)
    if cls is None:
        raise SnapshotValidationError(f"{path}: unknown index kind {kind!r}")
    return cls.load(path, device=device)
