"""The commit manifest of a saved index — the port's own copy of
``npairloss_tpu/resilience/snapshot.py``'s checksum and manifest helpers
(``state_checksums``, ``write_manifest``, ``read_manifest``,
``validate_snapshot``, ``verify_restored``).

The format is byte-compatible with the JAX package's: ``manifest.json``
with format ``npairloss-snapshot-v1``, an integer ``step`` and one
CRC-32 + shape + dtype record per array, keyed like JAX's
``keystr`` of a flat dict path (``"['emb']"``).  So an index committed
by either package validates and loads in the other.
"""

from __future__ import annotations

import json
import os
import time
import zlib
from typing import Any, Dict, Mapping, Optional

import numpy as np

MANIFEST_NAME = "manifest.json"
SNAPSHOT_FORMAT = "npairloss-snapshot-v1"
TMP_MARKER = ".tmp-"


class SnapshotValidationError(RuntimeError):
    """A committed directory is torn or corrupt."""


def _key(name: str) -> str:
    return f"[{name!r}]"


def state_checksums(tree: Mapping[str, Any]) -> Dict[str, Dict[str, Any]]:
    """Per-array CRC-32 + shape/dtype over the host bytes of a flat
    ``{name: array}`` dict, in sorted key order."""
    out: Dict[str, Dict[str, Any]] = {}
    for name in sorted(tree):
        a = np.ascontiguousarray(np.asarray(tree[name]))
        out[_key(name)] = {
            "crc32": zlib.crc32(a.tobytes()) & 0xFFFFFFFF,
            "shape": list(a.shape),
            "dtype": str(a.dtype),
        }
    return out


def verify_restored(tree: Mapping[str, Any],
                    manifest: Dict[str, Any]) -> None:
    want = manifest.get("arrays", {})
    got = state_checksums(tree)
    if set(want) != set(got):
        missing = sorted(set(want) - set(got))[:3]
        extra = sorted(set(got) - set(want))[:3]
        raise SnapshotValidationError(
            f"array set mismatch (missing={missing}, unexpected={extra})")
    bad = [k for k in want if want[k]["crc32"] != got[k]["crc32"]]
    if bad:
        raise SnapshotValidationError(
            f"checksum mismatch on {len(bad)} array(s), e.g. {sorted(bad)[:3]}")


def fsync_dir(path: str) -> None:
    """Best-effort directory fsync (makes a rename durable)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def write_manifest(directory: str, step: int,
                   checksums: Dict[str, Dict[str, Any]],
                   extra: Optional[Dict[str, Any]] = None) -> str:
    """Write ``manifest.json`` atomically (tmp + fsync + rename)."""
    manifest = {
        "format": SNAPSHOT_FORMAT,
        "step": int(step),
        "created": time.time(),
        "arrays": checksums,
    }
    if extra:
        manifest.update(extra)
    path = os.path.join(directory, MANIFEST_NAME)
    tmp = path + ".part"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(directory)
    return path


def read_manifest(directory: str) -> Dict[str, Any]:
    with open(os.path.join(directory, MANIFEST_NAME), encoding="utf-8") as f:
        return json.load(f)


def validate_snapshot(path: str) -> Dict[str, Any]:
    """Structural check: a committed dir with a parseable manifest of the
    right format.  Returns the manifest."""
    if not os.path.isdir(path):
        raise SnapshotValidationError(f"not a snapshot directory: {path}")
    if TMP_MARKER in os.path.basename(path):
        raise SnapshotValidationError(f"uncommitted tmp snapshot: {path}")
    if not os.path.exists(os.path.join(path, MANIFEST_NAME)):
        raise SnapshotValidationError("no manifest.json (torn commit)")
    try:
        manifest = read_manifest(path)
    except (OSError, ValueError) as e:
        raise SnapshotValidationError(f"unreadable manifest: {e}") from e
    if manifest.get("format") != SNAPSHOT_FORMAT:
        raise SnapshotValidationError(
            f"unknown manifest format {manifest.get('format')!r}")
    if not isinstance(manifest.get("step"), int):
        raise SnapshotValidationError("manifest carries no integer step")
    if not isinstance(manifest.get("arrays"), dict):
        raise SnapshotValidationError("manifest carries no array records")
    return manifest
