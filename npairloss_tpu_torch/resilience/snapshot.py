"""Atomic snapshot commit, validation and retention GC — the commit
protocol of ``npairloss_tpu/resilience/snapshot.py`` with ``torch.save``
in place of Orbax.

A snapshot's state is a flat name -> tensor dict (the solver's
``state_dict``: the model's parameters and buffers, the momentum
buffers, ``iteration`` as an int64 scalar).  The commit:

  1. copy the state to the host once (:func:`to_host`) and write those
     tensors with ``torch.save`` into ``<final>.tmp-<pid>-<nonce>/``
     (retried under the caller's :class:`~.retrying.RetryPolicy`);
  2. write ``manifest.json`` inside the tmp dir: format tag, the solver
     step, and a per-tensor CRC-32 + shape/dtype record computed over
     the same host bytes (write, fsync, rename, directory fsync);
  3. ``os.replace`` the tmp dir onto the final name, then fsync the
     parent.

The rename is the commit point: a snapshot exists at its final name
complete with its manifest, or not at all.  A crash earlier leaves only
a ``.tmp-`` dir, which the resume scan never matches; a committed
snapshot whose bytes no longer match its manifest (bit rot, an injected
``snapshot.commit.torn``) fails :func:`verify_restored` and is skipped.

The names, the manifest format (``npairloss-snapshot-v1``) and the
``<prefix>iter_<step>.ckpt`` naming are the JAX package's, so the JAX
package's ``validate_snapshot`` accepts a port snapshot.  The tensors
themselves are a ``torch.save`` file, which only the port reads.

Over a mesh of several processes (``commit_snapshot_multi``) every
rank holds the same state, so rank 0 alone runs the commit above and
every rank then learns whether it landed; a non-zero rank resuming
waits for rank 0's manifest (``validate_snapshot_wait``) instead of
skipping the snapshot as torn.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import time
import zlib
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from npairloss_tpu_torch.resilience import failpoints
from npairloss_tpu_torch.resilience.retrying import (
    RetryPolicy,
    call_with_retry,
)

log = logging.getLogger("npairloss_tpu_torch.resilience")

MANIFEST_NAME = "manifest.json"
SNAPSHOT_FORMAT = "npairloss-snapshot-v1"
TMP_MARKER = ".tmp-"
QUARANTINE_SUFFIX = ".quarantined"
# The tensors of a snapshot: one torch.save file beside the manifest.
STATE_NAME = "state.pt"
# Solver.snapshot_path naming: <prefix>iter_<step>.ckpt
_STEP_RE = r"iter_(\d+)\.ckpt"

State = Mapping[str, torch.Tensor]


class SnapshotError(RuntimeError):
    """A snapshot could not be committed or restored."""


class SnapshotValidationError(SnapshotError):
    """A snapshot on disk is torn/corrupt (failed manifest validation)."""


# -- checksums ------------------------------------------------------------


def to_host(state: State) -> Dict[str, torch.Tensor]:
    """One detached, contiguous host copy of every tensor of ``state``."""
    return {k: v.detach().to("cpu", copy=True).contiguous()
            for k, v in state.items()}


def _host_bytes(t: Any) -> Tuple[np.ndarray, str]:
    """(numpy view of a tensor's host bytes, its dtype name).  bf16 has
    no numpy dtype: its bytes go through a 16-bit integer view, named
    ``bfloat16`` as JAX's ml_dtypes names it.  ``np.ascontiguousarray``
    makes a scalar 1-d, as it does in JAX's ``state_checksums``, so a
    scalar's record has shape [1] in both."""
    if not isinstance(t, torch.Tensor):
        a = np.ascontiguousarray(np.asarray(t))
        return a, str(a.dtype)
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return np.ascontiguousarray(t.view(torch.int16).numpy()), "bfloat16"
    a = np.ascontiguousarray(t.numpy())
    return a, str(a.dtype)


def state_checksums(state: Mapping[str, Any]) -> Dict[str, Dict[str, Any]]:
    """Per-tensor CRC-32 + shape/dtype over the host bytes of ``state``
    (tensors or numpy arrays).

    CRC-32 (not a cryptographic hash): the threat model is torn writes
    and bit rot, not tampering, and crc32 streams at memory bandwidth.
    """
    out: Dict[str, Dict[str, Any]] = {}
    for key, val in state.items():
        a, dtype = _host_bytes(val)
        out[key] = {
            "crc32": zlib.crc32(a.tobytes()) & 0xFFFFFFFF,
            "shape": list(a.shape),
            "dtype": dtype,
        }
    return out


def verify_restored(state: Mapping[str, Any],
                    manifest: Dict[str, Any]) -> None:
    """Compare a restored state against its manifest; raises
    :class:`SnapshotValidationError` naming the first mismatches."""
    want = manifest.get("arrays", {})
    got = state_checksums(state)
    if set(want) != set(got):
        missing = sorted(set(want) - set(got))[:3]
        extra = sorted(set(got) - set(want))[:3]
        raise SnapshotValidationError(
            f"array set mismatch (missing={missing}, unexpected={extra})"
        )
    bad = [k for k in want if want[k]["crc32"] != got[k]["crc32"]]
    if bad:
        raise SnapshotValidationError(
            f"checksum mismatch on {len(bad)} array(s), "
            f"e.g. {sorted(bad)[:3]}"
        )


# -- manifest -------------------------------------------------------------


def _fsync_dir(path: str) -> None:
    # Directory fsync makes the rename durable; best-effort because not
    # every filesystem supports it (and a lost-on-power-cut snapshot is
    # exactly what the validator + older snapshots exist to absorb).
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


def write_manifest(snapshot_dir: str, step: int,
                   checksums: Dict[str, Dict[str, Any]],
                   extra: Optional[Dict[str, Any]] = None) -> str:
    """Write ``manifest.json`` into ``snapshot_dir`` atomically
    (tmp file + fsync + rename + dir fsync)."""
    manifest = {
        "format": SNAPSHOT_FORMAT,
        "step": int(step),
        "created": time.time(),
        "arrays": checksums,
    }
    if extra:
        manifest.update(extra)
    path = os.path.join(snapshot_dir, MANIFEST_NAME)
    tmp = path + ".part"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    # The rename made the manifest's content durable but not its name:
    # until the directory is fsynced a power cut can bring the dir back
    # without manifest.json.  The same fsync covers the state file the
    # commit wrote before us.
    failpoints.fire("snapshot.commit.dirsync")
    _fsync_dir(snapshot_dir)
    return path


def read_manifest(snapshot_dir: str) -> Dict[str, Any]:
    with open(os.path.join(snapshot_dir, MANIFEST_NAME),
              encoding="utf-8") as f:
        return json.load(f)


def validate_snapshot(path: str) -> Dict[str, Any]:
    """Structural validation: committed dir with a parseable manifest of
    the right format.  Returns the manifest; raises
    :class:`SnapshotValidationError` with the reason otherwise."""
    if not os.path.isdir(path):
        raise SnapshotValidationError(f"not a snapshot directory: {path}")
    if TMP_MARKER in os.path.basename(path):
        raise SnapshotValidationError(f"uncommitted tmp snapshot: {path}")
    mpath = os.path.join(path, MANIFEST_NAME)
    if not os.path.exists(mpath):
        raise SnapshotValidationError(
            "no manifest.json (torn commit, or a pre-resilience snapshot)"
        )
    try:
        manifest = read_manifest(path)
    except (OSError, ValueError) as e:
        raise SnapshotValidationError(f"unreadable manifest: {e}") from e
    if manifest.get("format") != SNAPSHOT_FORMAT:
        raise SnapshotValidationError(
            f"unknown manifest format {manifest.get('format')!r}"
        )
    if not isinstance(manifest.get("step"), int):
        raise SnapshotValidationError("manifest carries no integer step")
    if not isinstance(manifest.get("arrays"), dict):
        raise SnapshotValidationError("manifest carries no array records")
    return manifest


def validate_snapshot_wait(path: str,
                           policy: Optional[RetryPolicy] = None
                           ) -> Dict[str, Any]:
    """:func:`validate_snapshot` under the shared retry/backoff — the
    non-zero ranks' side of a multi-process resume
    (``npairloss_tpu/resilience/snapshot.py:192-223``): a rank that scans
    the directory before rank 0's manifest lands waits for it instead of
    reading a valid snapshot as torn.  Rank 0 never calls this: for it a
    missing manifest is a torn commit."""
    import dataclasses

    policy = policy if policy is not None else RetryPolicy()
    # The transient here is the manifest race (a SnapshotValidationError),
    # not an OSError: widen retry_on for this call only.
    policy = dataclasses.replace(
        policy,
        retry_on=tuple(set(policy.retry_on) | {SnapshotValidationError}))
    return call_with_retry(lambda: validate_snapshot(path), policy,
                           describe=f"manifest wait ({path})")


def snapshot_info(path: str) -> Dict[str, Any]:
    """Freshness identity of a committed snapshot: ``{"path", "step",
    "created"}`` from its manifest, without loading a tensor.  ``step``
    and ``created`` are None for a manifest-less dir."""
    out: Dict[str, Any] = {
        "path": os.path.abspath(path), "step": None, "created": None,
    }
    try:
        manifest = read_manifest(path)
    except (OSError, ValueError):
        return out
    step = manifest.get("step")
    created = manifest.get("created")
    if isinstance(step, int):
        out["step"] = step
    if isinstance(created, (int, float)):
        out["created"] = float(created)
    return out


# -- commit and load ------------------------------------------------------


def _write_state(snapshot_dir: str, host: State) -> None:
    os.makedirs(snapshot_dir, exist_ok=True)
    with open(os.path.join(snapshot_dir, STATE_NAME), "wb") as f:
        torch.save(dict(host), f)
        f.flush()
        os.fsync(f.fileno())


def read_state(path: str, device: torch.device) -> Dict[str, torch.Tensor]:
    """The tensors of the snapshot at ``path``, mapped onto ``device``."""
    return torch.load(os.path.join(path, STATE_NAME), map_location=device,
                      weights_only=True)


def commit_snapshot(
    final_path: str,
    state: State,
    step: int,
    *,
    policy: Optional[RetryPolicy] = None,
    on_retry=None,
    extra: Optional[Dict[str, Any]] = None,
) -> str:
    """Write ``state`` as a committed snapshot at ``final_path``.

    Returns ``final_path``; on failure nothing exists at ``final_path``
    (a ``.tmp-`` dir may be left for post-mortem and is ignored by the
    resume scan; the next commit attempt takes a fresh nonce).
    """
    final_path = os.path.abspath(final_path)
    parent = os.path.dirname(final_path)
    os.makedirs(parent, exist_ok=True)
    tmp = (f"{final_path}{TMP_MARKER}{os.getpid()}-"
           f"{os.urandom(2).hex()}")
    host = to_host(state)

    def do_save():
        failpoints.fire("snapshot.save.io")
        _write_state(tmp, host)

    call_with_retry(
        do_save, policy, describe=f"snapshot save ({final_path})",
        on_retry=on_retry,
    )
    checks = state_checksums(host)
    if failpoints.should_fire("snapshot.commit.torn"):
        # Deterministic "torn snapshot": commit with poisoned
        # checksums so the resume validator must catch and skip it.
        for rec in checks.values():
            rec["crc32"] = (rec["crc32"] + 1) & 0xFFFFFFFF
    write_manifest(tmp, step, checks, extra=extra)
    # On any failure up to here the tmp dir never reached its final
    # name: the run sees the error, the resume scan never sees the dir.
    failpoints.fire("snapshot.commit.crash")
    if os.path.isdir(final_path):
        # Re-committing the same step (emergency snapshot on a cadence
        # boundary): the rename target must not exist.
        shutil.rmtree(final_path)
    os.replace(tmp, final_path)
    _fsync_dir(parent)
    return final_path


def commit_snapshot_multi(final_path: str, state: State, step: int, *,
                          primary: bool, agree, policy=None, on_retry=None,
                          extra: Optional[Dict[str, Any]] = None) -> str:
    """The multi-process commit: the ``primary`` rank (rank 0) commits
    ``state`` — every rank's state is the same — and writes the
    manifest; then every rank reaches ``agree(ok) -> bool`` (true iff
    ``ok`` on every rank), so all of them raise or none does."""
    err: Optional[BaseException] = None
    if primary:
        try:
            commit_snapshot(final_path, state, step, policy=policy,
                            on_retry=on_retry, extra=extra)
        except Exception as e:  # noqa: BLE001 — raised after the vote
            err = e
    ok = agree(err is None)
    if err is not None:
        raise err
    if not ok:
        raise SnapshotError(
            f"rank 0 failed to commit the snapshot at {final_path}")
    return os.path.abspath(final_path)


# -- discovery + GC -------------------------------------------------------


def list_snapshots(snapshot_prefix: str) -> List[Tuple[int, str]]:
    """Committed snapshot candidates for a ``snapshot_prefix``, as
    ``(step, path)`` sorted by step ascending.  Tmp dirs never match."""
    prefix = os.path.abspath(snapshot_prefix)
    parent, base = os.path.dirname(prefix), os.path.basename(prefix)
    pat = re.compile(re.escape(base) + _STEP_RE + r"$")
    out: List[Tuple[int, str]] = []
    try:
        entries = os.listdir(parent)
    except OSError:
        return out
    for name in entries:
        m = pat.match(name)
        path = os.path.join(parent, name)
        if m and os.path.isdir(path):
            out.append((int(m.group(1)), path))
    out.sort()
    return out


def gc_snapshots(snapshot_prefix: str, max_keep: int) -> List[str]:
    """Retention GC: delete committed snapshots beyond the newest
    ``max_keep`` (``max_keep <= 0`` keeps every committed snapshot),
    then always sweep stale ``.tmp-`` debris from failed commits and
    ``.quarantined`` dirs.  Best-effort: a dir that refuses to delete is
    logged and left.  Single writer: GC runs right after a successful
    commit in the saving process."""
    deleted: List[str] = []
    if max_keep > 0:
        snaps = list_snapshots(snapshot_prefix)
        for step, path in snaps[:-max_keep] if len(snaps) > max_keep else []:
            try:
                shutil.rmtree(path)
                deleted.append(path)
                log.info("snapshot GC: removed iter-%d (%s)", step, path)
            except OSError as e:
                log.warning("snapshot GC: could not remove %s: %s", path, e)
    prefix = os.path.abspath(snapshot_prefix)
    parent, base = os.path.dirname(prefix), os.path.basename(prefix)
    try:
        entries = os.listdir(parent)
    except OSError:
        return deleted
    for name in entries:
        if name.startswith(base) and (
            TMP_MARKER in name or name.endswith(QUARANTINE_SUFFIX)
        ):
            path = os.path.join(parent, name)
            try:
                shutil.rmtree(path)
                deleted.append(path)
                log.info("snapshot GC: removed stale %s", path)
            except OSError as e:
                log.warning("snapshot GC: could not remove %s: %s", path, e)
    return deleted


def quarantine_snapshots(snapshot_prefix: str, min_step: int) -> List[str]:
    """Rename committed snapshots with step > ``min_step`` out of the
    resume scan's namespace (``<dir>.quarantined``): their bytes are
    checksum-valid, so without the rename a later ``--resume auto``
    would restore them.  GC reclaims them."""
    out: List[str] = []
    for step, path in list_snapshots(snapshot_prefix):
        if step <= min_step:
            continue
        target = path + QUARANTINE_SUFFIX
        try:
            if os.path.isdir(target):
                shutil.rmtree(target)
            os.rename(path, target)
            out.append(target)
            log.warning("quarantined suspect snapshot iter-%d -> %s",
                        step, target)
        except OSError as e:
            log.warning("could not quarantine %s: %s", path, e)
    return out
