"""GalleryIndex — the device-resident gallery a query runs against.

Port of ``npairloss_tpu/serve/index.py`` for one device: (N, D)
L2-normalized embeddings with labels and a validity mask on the device,
item ids on the host.  The ``.gidx`` on-disk layout is the JAX
package's: ``.npy`` arrays plus ``manifest.json`` with per-array CRC-32
(``serve/manifest.py``), committed by an atomic directory rename — an
index saved by either package loads in the other.
"""

from __future__ import annotations

import logging
import os
import shutil
import time
from typing import Dict, Optional

import numpy as np
import torch

from npairloss_tpu_torch.device import DeviceLike, resolve_device
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
# Committed-index kind -> class; serve/ivf.py registers ``ivf-index``.
KIND_REGISTRY: Dict[str, type] = {}


def l2_normalize_rows(x: np.ndarray) -> np.ndarray:
    """Host-side row L2-normalize (an all-zero row stays zero) — shared
    by build and query so both normalize identically."""
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)


class GalleryIndex:
    """Flat gallery.  Build via :meth:`build` or :meth:`load`.

    ``emb`` (N, D) fp32, ``labels`` (N,) int32 and ``valid`` (N,) bool
    live on ``device``; ``ids`` (N,) int64 and the unpadded master copies
    ``host_emb``/``host_labels`` live on the host."""

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
        self.emb: Optional[torch.Tensor] = None
        self.labels: Optional[torch.Tensor] = None
        self.valid: Optional[torch.Tensor] = None

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
        self.emb = torch.as_tensor(self.host_emb, device=self.device)
        self.labels = torch.as_tensor(self.host_labels, device=self.device)
        self.valid = torch.ones(self.size, dtype=torch.bool,
                                device=self.device)

    @property
    def dim(self) -> int:
        return int(self.host_emb.shape[1])

    # -- persistence -------------------------------------------------------

    def _tree(self) -> Dict[str, np.ndarray]:
        return {"emb": self.host_emb, "labels": self.host_labels,
                "ids": self.ids}

    def _manifest_extra(self) -> dict:
        """Subclass hook: extra manifest keys."""
        return {}

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
        os.replace(tmp, final)
        fsync_dir(parent)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
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
        idx._place()
        return idx

    def _restore_extra(self, tree, manifest) -> None:
        """Subclass hook: take extra arrays from a verified tree."""


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
