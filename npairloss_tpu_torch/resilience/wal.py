"""Segment-based write-ahead log — artifact ``npairloss-wal-v1``.

The port's own copy of ``npairloss_tpu/resilience/wal.py`` (stdlib
only; the port imports nothing of the JAX package).  The files it
writes are the JAX package's byte for byte, so either package recovers,
validates and replays the other's directory.

The serving tier acknowledges an ingest only after the record is
*durable* here: length-prefixed, CRC-32-checksummed records appended to
an active segment file, group-commit fsynced (a background flusher
amortizes the fsync across a configurable interval; ``wait_durable``
blocks the ack until the fsync covering its sequence number lands).
Segment create/rotate fsyncs the parent directory entry, so a crash
immediately after rotation cannot lose the new segment's name.

Artifact layout (``npairloss-wal-v1``)::

    wal_dir/
      wal_manifest.json        # {"format", "segment_max_bytes", "sealed"}
      wal-0000000000000001.seg # records for seq 1..N (name = first seq)
      wal-0000000000000NNN.seg # active segment (unsealed)

Record framing: ``<II`` little-endian header = (payload length, CRC-32
of payload), then the JSON payload bytes (``sort_keys``, compact
separators).  Every payload is an object carrying its ``seq`` (assigned
monotonically by ``append``); ingest records use ``kind: "add"`` with
``ids``/``labels``/``dim``/``emb`` (base64 float32 — the encoding is the
caller's, this module stays numpy-free).  On rotation the finished
segment is *sealed* into the manifest (first/last seq + whole-file CRC,
manifest rewritten atomically): a sealed segment that later fails its
CRC or loses its tail is tampering, not a crash, and is refused.

Recovery semantics (``WriteAheadLog`` open):

  * a torn tail — a partial header, short payload, or CRC mismatch at
    the very end of the FINAL (unsealed) segment — is a crash artifact:
    it is truncated LOUDLY (logged, counted in ``torn_records`` /
    ``torn_bytes``), never silently absorbed;
  * the same damage anywhere else (mid-stream, or in a sealed segment)
    is corruption and raises :class:`WalCorruptionError`;
  * sequence numbers must be contiguous within and across segments; a
    missing *prefix* of segments is a GC artifact and fine, a missing
    middle segment is a gap and refused.

Exactly-once replay is the watermark contract: index checkpoints publish
the last sequence number they contain (``ingest_watermark`` in the
index manifest), recovery replays only records ABOVE the checkpoint's
watermark, and :meth:`WriteAheadLog.gc` deletes sealed segments once a
published watermark covers their last record.

Failpoints (``resilience/failpoints.py``): ``wal.append.torn``,
``wal.rotate.crash``, ``wal.gc.crash``.
"""

from __future__ import annotations

import json
import logging
import os
import re
import struct
import threading
import time
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

from npairloss_tpu_torch.resilience import failpoints
from npairloss_tpu_torch.resilience.retrying import (
    call_with_retry,
    named_policy,
)

log = logging.getLogger("npairloss_tpu_torch.resilience")

WAL_FORMAT = "npairloss-wal-v1"
MANIFEST_NAME = "wal_manifest.json"
MANIFEST_KEYS = ("format", "segment_max_bytes", "sealed")
SEAL_KEYS = ("first_seq", "last_seq", "crc32")

_HEADER = struct.Struct("<II")  # (payload length, CRC-32 of payload)
_SEG_RE = re.compile(r"^wal-(\d{16})\.seg$")


class WalError(RuntimeError):
    """Operational WAL failure (timeouts, closed log, bad arguments)."""


class WalCorruptionError(WalError):
    """The on-disk artifact violates the ``npairloss-wal-v1`` contract
    in a way a crash cannot explain — refused, never repaired."""


def _segment_name(first_seq: int) -> str:
    return f"wal-{first_seq:016d}.seg"


def _fsync_dir(path: str) -> None:
    """fsync a directory entry table; best-effort on filesystems that
    refuse directory handles (the same posture as snapshot.py)."""
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


def _encode_record(payload: Dict[str, Any]) -> bytes:
    data = json.dumps(payload, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")
    return _HEADER.pack(len(data), zlib.crc32(data) & 0xFFFFFFFF) + data


def _list_segments(path: str) -> List[Tuple[int, str]]:
    """Sorted ``(first_seq, filename)`` for every well-formed segment
    name; a ``wal-*.seg`` name that does not parse is corruption."""
    out: List[Tuple[int, str]] = []
    for name in os.listdir(path):
        m = _SEG_RE.match(name)
        if m:
            out.append((int(m.group(1)), name))
        elif name.startswith("wal-") and name.endswith(".seg"):
            raise WalCorruptionError(f"malformed segment name: {name}")
    out.sort()
    return out


def _read_segment(path: str) -> Tuple[List[Tuple[int, Dict[str, Any]]],
                                      int, Optional[str], int]:
    """Scan one segment file: ``(records, good_end_offset, damage,
    file_crc32)``.  ``records`` is ``[(seq, payload), ...]`` up to the
    last intact record; ``damage`` describes the first torn/corrupt
    byte range (None when the file is clean).  The caller decides
    whether damage is a truncatable tail or refusable corruption —
    this scanner only reports."""
    records: List[Tuple[int, Dict[str, Any]]] = []
    good_end = 0
    crc = 0
    with open(path, "rb") as f:
        blob = f.read()
    size = len(blob)
    off = 0
    while off < size:
        if off + _HEADER.size > size:
            return records, good_end, (
                f"partial header at offset {off} "
                f"({size - off} byte(s))"), crc
        length, want = _HEADER.unpack_from(blob, off)
        body_at = off + _HEADER.size
        if body_at + length > size:
            return records, good_end, (
                f"partial payload at offset {off} "
                f"({size - off} of {_HEADER.size + length} byte(s))"), crc
        body = blob[body_at:body_at + length]
        if zlib.crc32(body) & 0xFFFFFFFF != want:
            return records, good_end, (
                f"CRC mismatch at offset {off}"), crc
        try:
            payload = json.loads(body.decode("utf-8"))
        except (UnicodeDecodeError, ValueError):
            return records, good_end, (
                f"unparseable payload at offset {off}"), crc
        if not isinstance(payload, dict) or \
                not isinstance(payload.get("seq"), int):
            return records, good_end, (
                f"payload without an integer seq at offset {off}"), crc
        rec = blob[off:body_at + length]
        crc = zlib.crc32(rec, crc) & 0xFFFFFFFF
        records.append((payload["seq"], payload))
        off = body_at + length
        good_end = off
    return records, good_end, None, crc


def validate_record_payload(payload: Any) -> Optional[str]:
    """None when ``payload`` is a well-formed record body; else the
    violation.  ``kind: "add"`` records additionally pin the ingest
    schema (ids/labels the same length, a positive dim, base64 emb)."""
    if not isinstance(payload, dict):
        return f"record payload must be an object, got {type(payload).__name__}"
    if not isinstance(payload.get("seq"), int) or payload["seq"] < 1:
        return f"record seq must be a positive int, got {payload.get('seq')!r}"
    if payload.get("kind") == "add":
        ids, labels = payload.get("ids"), payload.get("labels")
        if not isinstance(ids, list) or not isinstance(labels, list) \
                or len(ids) != len(labels) or not ids:
            return (f"add record seq {payload['seq']}: ids/labels must be "
                    "non-empty lists of equal length")
        dim = payload.get("dim")
        if not isinstance(dim, int) or dim < 1:
            return (f"add record seq {payload['seq']}: dim must be a "
                    f"positive int, got {dim!r}")
        if not isinstance(payload.get("emb"), str):
            return (f"add record seq {payload['seq']}: emb must be a "
                    "base64 string")
    return None


def validate_wal_manifest(obj: Any) -> Optional[str]:
    """None when ``obj`` is a well-formed ``npairloss-wal-v1`` manifest;
    else the first violation."""
    if not isinstance(obj, dict):
        return f"manifest must be an object, got {type(obj).__name__}"
    if obj.get("format") != WAL_FORMAT:
        return (f"manifest format must be {WAL_FORMAT!r}, "
                f"got {obj.get('format')!r}")
    for key in MANIFEST_KEYS:
        if key not in obj:
            return f"manifest missing key: {key}"
    if not isinstance(obj["segment_max_bytes"], int) or \
            obj["segment_max_bytes"] < _HEADER.size + 2:
        return ("manifest segment_max_bytes must be an int larger than "
                f"one record header, got {obj['segment_max_bytes']!r}")
    sealed = obj["sealed"]
    if not isinstance(sealed, dict):
        return "manifest sealed must be an object"
    for name, seal in sealed.items():
        m = _SEG_RE.match(name)
        if not m:
            return f"sealed entry for malformed segment name: {name}"
        if not isinstance(seal, dict):
            return f"sealed[{name}] must be an object"
        for key in SEAL_KEYS:
            if not isinstance(seal.get(key), int):
                return f"sealed[{name}] missing int key: {key}"
        if seal["first_seq"] != int(m.group(1)):
            return (f"sealed[{name}] first_seq {seal['first_seq']} "
                    "disagrees with the segment name")
        if seal["last_seq"] < seal["first_seq"]:
            return (f"sealed[{name}] last_seq {seal['last_seq']} < "
                    f"first_seq {seal['first_seq']}")
    return None


def load_wal_manifest(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, MANIFEST_NAME), "r",
              encoding="utf-8") as f:
        return json.load(f)


def wal_info(path: str) -> Dict[str, Any]:
    """Scan a WAL directory without mutating it: record/segment counts,
    the last replayable seq, and any torn tail on the final segment.
    Raises :class:`WalCorruptionError` on contract violations (a torn
    tail on the FINAL segment is a crash artifact and reported, not
    raised)."""
    manifest = load_wal_manifest(path)
    err = validate_wal_manifest(manifest)
    if err is not None:
        raise WalCorruptionError(err)
    sealed = manifest["sealed"]
    segments = _list_segments(path)
    present = {name for _, name in segments}
    records = 0
    first_seq: Optional[int] = None
    last_seq = 0
    torn_bytes = 0
    torn_segment: Optional[str] = None
    torn_detail: Optional[str] = None
    expect: Optional[int] = None
    for i, (name_seq, name) in enumerate(segments):
        seal = sealed.get(name)
        is_last = i == len(segments) - 1
        if expect is not None and name_seq != expect:
            raise WalCorruptionError(
                f"segment {name} starts at seq {name_seq}, expected "
                f"{expect} — sequence gap across segments")
        recs, good_end, damage, crc = _read_segment(
            os.path.join(path, name))
        if damage is not None:
            if not is_last or seal is not None:
                raise WalCorruptionError(
                    f"segment {name}: {damage} — damage outside the "
                    "final unsealed segment is corruption, not a torn "
                    "tail")
            torn_segment, torn_detail = name, damage
            torn_bytes = os.path.getsize(os.path.join(path, name)) \
                - good_end
        seq = name_seq
        for rec_seq, payload in recs:
            if rec_seq != seq:
                raise WalCorruptionError(
                    f"segment {name}: record seq {rec_seq}, expected "
                    f"{seq} — sequence gap or regression")
            perr = validate_record_payload(payload)
            if perr is not None:
                raise WalCorruptionError(f"segment {name}: {perr}")
            seq += 1
        if recs:
            if first_seq is None:
                first_seq = recs[0][0]
            last_seq = recs[-1][0]
            records += len(recs)
        if seal is not None:
            if damage is not None or seal["last_seq"] != (
                    recs[-1][0] if recs else seal["first_seq"] - 1):
                raise WalCorruptionError(
                    f"sealed segment {name} does not end at its sealed "
                    f"last_seq {seal['last_seq']} — truncated or "
                    "extended after sealing")
            if seal["crc32"] != crc:
                raise WalCorruptionError(
                    f"sealed segment {name}: file CRC {crc} != sealed "
                    f"CRC {seal['crc32']} — content changed after "
                    "sealing")
        expect = seq
    stale = [name for name in sealed if name not in present]
    for name in stale:
        # GC unlinks segments before the manifest rewrite lands; a
        # sealed entry whose file is gone is only explainable as that
        # crash when every surviving record sits ABOVE the sealed range.
        seal = sealed[name]
        if first_seq is not None and seal["last_seq"] >= first_seq:
            raise WalCorruptionError(
                f"sealed segment {name} is missing but overlaps the "
                f"surviving records (sealed last_seq {seal['last_seq']} "
                f">= first surviving seq {first_seq}) — a hole, not GC")
    return {
        "format": WAL_FORMAT,
        "segments": len(segments),
        "records": records,
        "first_seq": first_seq if first_seq is not None else 0,
        "last_seq": last_seq,
        "torn_tail": torn_segment is not None,
        "torn_segment": torn_segment,
        "torn_detail": torn_detail,
        "torn_bytes": torn_bytes,
        "stale_seals": len(stale),
    }


def validate_wal_dir(path: str,
                     min_last_seq: Optional[int] = None) -> Optional[str]:
    """None when ``path`` holds a valid ``npairloss-wal-v1`` artifact;
    else the first violation.  A torn tail on the final segment is a
    crash artifact and passes; ``min_last_seq`` additionally refuses a
    log whose last replayable record falls short of an externally
    acknowledged sequence number (a truncated-then-patched copy)."""
    if not os.path.isdir(path):
        return f"not a directory: {path}"
    if not os.path.exists(os.path.join(path, MANIFEST_NAME)):
        return f"missing {MANIFEST_NAME} in {path}"
    try:
        info = wal_info(path)
    except WalCorruptionError as e:
        return str(e)
    except (OSError, ValueError) as e:
        return f"unreadable WAL artifact: {e}"
    if min_last_seq is not None and info["last_seq"] < min_last_seq:
        return (f"last replayable seq {info['last_seq']} < acknowledged "
                f"watermark {min_last_seq} — acknowledged records are "
                "missing from the log")
    return None


class WriteAheadLog:
    """Append-only segmented WAL with group-commit fsync.

    ``flush_interval_s > 0`` starts a background flusher that fsyncs
    the active segment every interval; ``append`` returns immediately
    and :meth:`wait_durable` blocks the ack until the covering fsync
    lands.  ``flush_interval_s <= 0`` fsyncs inline on every append
    (the strict mode the crash-matrix tests pin)."""

    def __init__(self, path: str, *, flush_interval_s: float = 0.0,
                 segment_max_bytes: int = 1 << 20):
        self.path = os.path.abspath(path)
        self.flush_interval_s = float(flush_interval_s)
        self.torn_records = 0
        self.torn_bytes = 0
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._file: Optional[Any] = None
        self._closed = False
        self._seq = 0           # last assigned
        self._written_seq = 0   # last fully written to the OS
        self._durable_seq = 0   # last covered by an fsync
        self._active_first = 1
        self._active_size = 0
        self._active_crc = 0
        if not os.path.isdir(self.path):
            os.makedirs(self.path, exist_ok=True)
            _fsync_dir(os.path.dirname(self.path) or ".")
        manifest_path = os.path.join(self.path, MANIFEST_NAME)
        if os.path.exists(manifest_path):
            manifest = load_wal_manifest(self.path)
            err = validate_wal_manifest(manifest)
            if err is not None:
                raise WalCorruptionError(err)
            self.segment_max_bytes = int(manifest["segment_max_bytes"])
            self._sealed: Dict[str, Dict[str, int]] = dict(
                manifest["sealed"])
        else:
            self.segment_max_bytes = int(segment_max_bytes)
            self._sealed = {}
            self._write_manifest_locked()
        self._recover()
        self._flusher: Optional[threading.Thread] = None
        if self.flush_interval_s > 0:
            self._flusher = threading.Thread(
                target=self._flush_loop, name="wal-flusher", daemon=True)
            self._flusher.start()

    # -- open/recovery -------------------------------------------------------

    def _recover(self) -> None:
        segments = _list_segments(self.path)
        present = {name for _, name in segments}
        stale = [n for n in self._sealed if n not in present]
        expect: Optional[int] = None
        last_good_end = 0
        for i, (name_seq, name) in enumerate(segments):
            full = os.path.join(self.path, name)
            seal = self._sealed.get(name)
            is_last = i == len(segments) - 1
            if expect is not None and name_seq != expect:
                raise WalCorruptionError(
                    f"segment {name} starts at seq {name_seq}, expected "
                    f"{expect} — sequence gap across segments")
            recs, good_end, damage, crc = _read_segment(full)
            if damage is not None and (not is_last or seal is not None):
                raise WalCorruptionError(
                    f"segment {name}: {damage} — damage outside the "
                    "final unsealed segment is corruption, not a torn "
                    "tail")
            seq = name_seq
            for rec_seq, _ in recs:
                if rec_seq != seq:
                    raise WalCorruptionError(
                        f"segment {name}: record seq {rec_seq}, "
                        f"expected {seq} — sequence gap or regression")
                seq += 1
            if seal is not None:
                ends_at = recs[-1][0] if recs else seal["first_seq"] - 1
                if seal["last_seq"] != ends_at or seal["crc32"] != crc:
                    raise WalCorruptionError(
                        f"sealed segment {name} disagrees with its seal "
                        f"(last_seq {ends_at} vs {seal['last_seq']}, "
                        f"CRC {crc} vs {seal['crc32']}) — content "
                        "changed after sealing")
            if recs:
                if self._seq and recs[0][0] > self._seq + 1:
                    raise WalCorruptionError(
                        f"segment {name} jumps from seq {self._seq} to "
                        f"{recs[0][0]}")
                self._seq = recs[-1][0]
            if damage is not None:
                size = os.path.getsize(full)
                lost = size - good_end
                self.torn_records += 1
                self.torn_bytes += lost
                log.warning(
                    "wal: torn tail in %s truncated at offset %d "
                    "(%d byte(s) dropped: %s)", name, good_end, lost,
                    damage)
                with open(full, "r+b") as f:
                    f.truncate(good_end)
                    f.flush()
                    os.fsync(f.fileno())
            if is_last:
                self._active_first = name_seq
                self._active_size = good_end
                self._active_crc = crc
                last_good_end = good_end
            expect = seq
        for name in stale:
            seal = self._sealed[name]
            floor = segments[0][0] if segments else self._seq + 1
            if seal["last_seq"] >= floor:
                raise WalCorruptionError(
                    f"sealed segment {name} is missing but overlaps the "
                    "surviving records — a hole, not GC")
            log.warning("wal: dropping stale seal for GC'd segment %s",
                        name)
            del self._sealed[name]
        if stale:
            self._write_manifest_locked()
        if segments and segments[-1][1] not in self._sealed:
            last = os.path.join(self.path, segments[-1][1])
            self._file = open(last, "ab")
            if self._file.tell() != last_good_end:  # pragma: no cover
                raise WalError(
                    f"append position {self._file.tell()} != recovered "
                    f"end {last_good_end} for {last}")
        else:
            # Fresh log, or a rotation that crashed after sealing the
            # old segment but before creating its successor: appending
            # to a sealed segment would break its seal, so start a new
            # one at the next sequence number.
            self._create_segment_locked(self._seq + 1)
        self._written_seq = self._seq
        self._durable_seq = self._seq

    # -- manifest / segments -------------------------------------------------

    def _write_manifest_locked(self) -> None:
        manifest = {"format": WAL_FORMAT,
                    "segment_max_bytes": self.segment_max_bytes,
                    "sealed": dict(sorted(self._sealed.items()))}
        final = os.path.join(self.path, MANIFEST_NAME)
        tmp = final + ".part"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(manifest, f, sort_keys=True, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        _fsync_dir(self.path)

    def _create_segment_locked(self, first_seq: int) -> None:
        path = os.path.join(self.path, _segment_name(first_seq))
        self._file = open(path, "xb")
        _fsync_dir(self.path)
        self._active_first = first_seq
        self._active_size = 0
        self._active_crc = 0

    def _rotate_locked(self, next_first_seq: int) -> None:
        assert self._file is not None
        self._file.flush()
        os.fsync(self._file.fileno())
        self._durable_seq = self._written_seq
        self._cond.notify_all()
        name = _segment_name(self._active_first)
        self._file.close()
        self._file = None
        # Crash point: the finished segment is fsynced but its seal has
        # not reached the manifest — recovery treats it as the (clean)
        # unsealed tail and re-rotates on the next append.
        failpoints.fire("wal.rotate.crash")
        self._sealed[name] = {"first_seq": self._active_first,
                              "last_seq": self._written_seq,
                              "crc32": self._active_crc}
        self._write_manifest_locked()
        self._create_segment_locked(next_first_seq)

    # -- append / durability -------------------------------------------------

    def append(self, payload: Dict[str, Any]) -> int:
        """Assign the next sequence number, frame and write the record.
        Durability is NOT implied unless the log runs in inline-fsync
        mode — acknowledge only after :meth:`wait_durable`."""
        with self._lock:
            if self._closed or self._file is None:
                raise WalError("append on a closed WAL")
            seq = self._seq + 1
            body = dict(payload)
            body["seq"] = seq
            err = validate_record_payload(body)
            if err is not None:
                raise WalError(err)
            rec = _encode_record(body)
            if self._active_size > 0 and \
                    self._active_size + len(rec) > self.segment_max_bytes:
                self._rotate_locked(seq)
            if failpoints.should_fire("wal.append.torn"):
                # Crash point: die mid-record-write — the classic torn
                # tail recovery must truncate loudly.
                self._file.write(rec[:max(1, len(rec) // 2)])
                self._file.flush()
                os.fsync(self._file.fileno())
                raise failpoints.InjectedFault("wal.append.torn")
            self._file.write(rec)
            self._seq = seq
            self._written_seq = seq
            self._active_size += len(rec)
            self._active_crc = zlib.crc32(rec, self._active_crc) \
                & 0xFFFFFFFF
            if self.flush_interval_s <= 0:
                self._fsync_locked()
            return seq

    def _fsync_locked(self) -> None:
        if self._file is None:
            return
        self._file.flush()
        os.fsync(self._file.fileno())
        self._durable_seq = self._written_seq
        self._cond.notify_all()

    def flush(self) -> int:
        """Group-commit fsync: everything appended so far becomes
        durable.  Returns the new durable sequence number."""
        with self._lock:
            self._fsync_locked()
            return self._durable_seq

    def _flush_loop(self) -> None:
        while True:
            with self._cond:
                self._cond.wait(timeout=self.flush_interval_s)
                if self._closed:
                    return
                if self._durable_seq < self._written_seq:
                    self._fsync_locked()

    def wait_durable(self, seq: int, timeout: float = 30.0) -> None:
        """Block until the fsync covering ``seq`` lands (the ack
        barrier).  Raises :class:`WalError` on timeout or close."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._durable_seq < seq:
                if self._closed:
                    raise WalError("WAL closed before seq became durable")
                remaining = None if deadline is None else \
                    deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise WalError(
                        f"timed out waiting for seq {seq} to become "
                        f"durable (durable_seq={self._durable_seq})")
                self._cond.wait(timeout=remaining
                                if remaining is not None else 0.1)

    # -- replay / GC ---------------------------------------------------------

    def replay(self, after_seq: int = 0) -> Iterator[Dict[str, Any]]:
        """Yield record payloads with ``seq > after_seq`` in order — the
        exactly-once half of the watermark contract (the caller supplies
        the snapshot's committed watermark).  Segment opens run under
        the named ``wal_replay`` retry policy."""
        with self._lock:
            segments = _list_segments(self.path)
            sealed = dict(self._sealed)
            self._fsync_locked()
        for _, name in segments:
            seal = sealed.get(name)
            if seal is not None and seal["last_seq"] <= after_seq:
                continue
            full = os.path.join(self.path, name)
            recs, _, damage, _ = call_with_retry(
                lambda p=full: _read_segment(p),
                named_policy("wal_replay"),
                describe=f"wal replay of {name}")
            if damage is not None:
                raise WalCorruptionError(
                    f"segment {name}: {damage} during replay — recovery "
                    "must run (and truncate) before replay")
            for seq, payload in recs:
                if seq > after_seq:
                    yield payload

    def gc(self, watermark: int) -> int:
        """Unlink sealed segments whose LAST record a published
        snapshot watermark covers; the active segment is never GC'd.
        Returns the number of segments removed."""
        removed = 0
        with self._lock:
            active = _segment_name(self._active_first)
            for _, name in _list_segments(self.path):
                seal = self._sealed.get(name)
                if name == active or seal is None:
                    continue
                if seal["last_seq"] > watermark:
                    continue
                os.unlink(os.path.join(self.path, name))
                removed += 1
                del self._sealed[name]
                # Crash point: segment gone, manifest rewrite not yet
                # landed — recovery drops the stale seal.
                failpoints.fire("wal.gc.crash")
            if removed:
                self._write_manifest_locked()
        if removed:
            log.info("wal: GC removed %d segment(s) at watermark %d",
                     removed, watermark)
        return removed

    # -- introspection / lifecycle -------------------------------------------

    @property
    def last_seq(self) -> int:
        return self._seq

    @property
    def durable_seq(self) -> int:
        return self._durable_seq

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "last_seq": self._seq,
                "durable_seq": self._durable_seq,
                "segments": len(_list_segments(self.path)),
                "sealed_segments": len(self._sealed),
                "torn_records": self.torn_records,
                "torn_bytes": self.torn_bytes,
            }

    def close(self) -> None:
        with self._cond:
            if self._closed:
                return
            if self._file is not None:
                self._fsync_locked()
            self._closed = True
            self._cond.notify_all()
        if self._flusher is not None:
            self._flusher.join(timeout=5.0)
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None

    def __enter__(self) -> "WriteAheadLog":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
