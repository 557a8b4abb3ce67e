"""The port's write-ahead log (npairloss_tpu_torch/resilience/wal.py)
against the JAX package's on the CPU.

  * (a) the same appends in both packages give byte-identical segments
    and manifests, and each package's ``validate_wal_dir``, ``wal_info``
    and recovery + ``replay`` read the other's directory, a torn tail
    included;
  * (b) the crash-point matrix and the validator's tamper suite of
    ``tests/test_wal.py``, on the port's failpoints: every record whose
    ``wait_durable`` returned replays exactly once above the watermark,
    a torn tail is truncated loudly, a sealed segment that changed is
    refused.
"""

import base64
import filecmp
import json
import os
import shutil
import struct

import numpy as np
import pytest

from npairloss_tpu.resilience import wal as jwal
from npairloss_tpu_torch.resilience import failpoints
from npairloss_tpu_torch.resilience import snapshot as snap
from npairloss_tpu_torch.resilience import wal as pwal
from npairloss_tpu_torch.resilience.retrying import RetryPolicy, named_policy
from npairloss_tpu_torch.resilience.wal import (
    MANIFEST_NAME,
    WAL_FORMAT,
    WalCorruptionError,
    WalError,
    WriteAheadLog,
    load_wal_manifest,
    validate_wal_dir,
    validate_wal_manifest,
    wal_info,
)

_HEADER = struct.Struct("<II")
PACKAGES = {"jax": jwal, "port": pwal}


@pytest.fixture(autouse=True)
def _disarm():
    failpoints.reset()
    yield
    failpoints.reset()


def _add(i, rows=2, dim=4):
    """A well-formed ``kind: "add"`` record body (``append`` assigns the
    seq); the emb bytes are deterministic per ``i``."""
    raw = np.full(rows * dim, float(i), np.float32).tobytes()
    return {"kind": "add", "ids": [1000 + 10 * i + j for j in range(rows)],
            "labels": [7] * rows, "dim": dim,
            "emb": base64.b64encode(raw).decode("ascii")}


def _replayed(path, after_seq=0):
    wal = WriteAheadLog(str(path))
    try:
        return [rec["seq"] for rec in wal.replay(after_seq=after_seq)]
    finally:
        wal.close()


def _write(mod, path, n, **kw):
    with mod.WriteAheadLog(str(path), **kw) as wal:
        for i in range(n):
            wal.wait_durable(wal.append(_add(i, rows=1 + i % 3)))


def _same_tree(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for name in names:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name),
                           shallow=False), name
    return names


# -- (a) compatibility with the JAX package -----------------------------------


@pytest.mark.parametrize("segment_max_bytes", [1 << 20, 200])
def test_same_appends_give_byte_identical_files(tmp_path, segment_max_bytes):
    _write(jwal, tmp_path / "jax", 9, segment_max_bytes=segment_max_bytes)
    _write(pwal, tmp_path / "port", 9, segment_max_bytes=segment_max_bytes)
    names = _same_tree(tmp_path / "jax", tmp_path / "port")
    assert (len([n for n in names if n.endswith(".seg")]) > 1) == (
        segment_max_bytes == 200)
    assert (load_wal_manifest(str(tmp_path / "port"))
            == jwal.load_wal_manifest(str(tmp_path / "jax")))


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("torn", [False, True], ids=["clean", "torn"])
def test_each_package_reads_the_others_directory(tmp_path, writer, torn):
    reader = PACKAGES["port" if writer == "jax" else "jax"]
    path = tmp_path / "wal"
    _write(PACKAGES[writer], path, 7, segment_max_bytes=200)
    if torn:
        segs = sorted(n for n in os.listdir(path) if n.endswith(".seg"))
        last = os.path.join(str(path), segs[-1])
        with open(last, "ab") as f:
            f.write(_HEADER.pack(40, 123) + b"{\"seq\"")  # a torn record
    assert reader.validate_wal_dir(str(path)) is None
    info_r = reader.wal_info(str(path))
    info_w = PACKAGES[writer].wal_info(str(path))
    assert info_r == info_w
    assert info_r["last_seq"] == 7 and info_r["torn_tail"] is torn
    copy = tmp_path / "copy"
    shutil.copytree(str(path), str(copy))
    # Recovery (which truncates a torn tail) and replay in each package.
    with reader.WriteAheadLog(str(path)) as wal:
        assert wal.torn_records == int(torn)
        got = list(wal.replay(after_seq=2))
    with PACKAGES[writer].WriteAheadLog(str(copy)) as wal:
        want = list(wal.replay(after_seq=2))
    assert got == want and [r["seq"] for r in got] == [3, 4, 5, 6, 7]
    _same_tree(path, copy)


@pytest.mark.parametrize("first", ["jax", "port"])
def test_a_log_continued_by_the_other_package_is_one_log(tmp_path, first):
    """Appends split between the packages give the bytes one package
    writes alone."""
    second = "port" if first == "jax" else "jax"
    mixed, alone = tmp_path / "mixed", tmp_path / "alone"
    with PACKAGES[first].WriteAheadLog(str(mixed),
                                       segment_max_bytes=200) as wal:
        for i in range(4):
            wal.append(_add(i))
    with PACKAGES[second].WriteAheadLog(str(mixed),
                                        segment_max_bytes=200) as wal:
        assert wal.last_seq == 4
        for i in range(4, 8):
            wal.append(_add(i))
        assert wal.gc(3) >= 1
    with WriteAheadLog(str(alone), segment_max_bytes=200) as wal:
        for i in range(8):
            wal.append(_add(i))
        wal.gc(3)
    _same_tree(mixed, alone)


def test_port_payload_validator_matches_jax():
    bad = [
        None, {"seq": 0}, {"seq": 1, "kind": "add", "ids": [1],
                           "labels": [], "dim": 4, "emb": "AA=="},
        {"seq": 2, "kind": "add", "ids": [1], "labels": [1], "dim": 0,
         "emb": "AA=="},
        {"seq": 3, "kind": "add", "ids": [1], "labels": [1], "dim": 4,
         "emb": 5},
        {"seq": 4, "kind": "note"},
    ]
    for payload in bad:
        assert (pwal.validate_record_payload(payload)
                == jwal.validate_record_payload(payload)), payload


# -- (b) unit: append / replay / rotation / GC --------------------------------


def test_append_assigns_contiguous_seqs_and_replays(tmp_path):
    with WriteAheadLog(str(tmp_path / "wal")) as wal:
        seqs = [wal.append(_add(i)) for i in range(5)]
        assert seqs == [1, 2, 3, 4, 5]
        wal.wait_durable(5)
        assert [r["seq"] for r in wal.replay()] == [1, 2, 3, 4, 5]
        # The watermark contract: records at or below are skipped.
        assert [r["seq"] for r in wal.replay(after_seq=3)] == [4, 5]
        stats = wal.stats()
        assert stats["last_seq"] == 5 and stats["durable_seq"] == 5
        assert stats["torn_records"] == 0
    assert validate_wal_dir(str(tmp_path / "wal")) is None


def test_reopen_resumes_sequence(tmp_path):
    path = tmp_path / "wal"
    with WriteAheadLog(str(path)) as wal:
        for i in range(3):
            wal.append(_add(i))
    with WriteAheadLog(str(path)) as wal:
        assert wal.last_seq == 3
        assert wal.append(_add(3)) == 4
        assert [r["seq"] for r in wal.replay()] == [1, 2, 3, 4]


def test_rotation_seals_segments_and_gc_respects_watermark(tmp_path):
    path = tmp_path / "wal"
    with WriteAheadLog(str(path), segment_max_bytes=200) as wal:
        for i in range(8):
            wal.append(_add(i))
        stats = wal.stats()
        assert stats["segments"] > 1
        assert stats["sealed_segments"] == stats["segments"] - 1
        sealed = load_wal_manifest(str(path))["sealed"]
        assert validate_wal_manifest(load_wal_manifest(str(path))) is None
        # A watermark below every sealed last_seq removes nothing, one
        # covering some sealed segments removes exactly those.
        assert wal.gc(0) == 0
        cover = min(s["last_seq"] for s in sealed.values())
        assert wal.gc(cover) >= 1
        assert [r["seq"] for r in wal.replay(after_seq=cover)] == \
            list(range(cover + 1, 9))
    assert validate_wal_dir(str(path)) is None
    info = wal_info(str(path))
    assert info["last_seq"] == 8 and info["first_seq"] > 1


@pytest.mark.parametrize("flush_interval_s", [0.0, 0.02],
                         ids=["inline", "group-commit"])
def test_wait_durable_covers_the_append(tmp_path, flush_interval_s):
    with WriteAheadLog(str(tmp_path / "wal"),
                       flush_interval_s=flush_interval_s) as wal:
        seq = wal.append(_add(0))
        wal.wait_durable(seq, timeout=10.0)
        assert wal.durable_seq >= seq


def test_bad_payload_and_closed_log_are_loud(tmp_path):
    wal = WriteAheadLog(str(tmp_path / "wal"))
    with pytest.raises(WalError, match="ids/labels"):
        wal.append({"kind": "add", "ids": [], "labels": [],
                    "dim": 4, "emb": "AA=="})
    wal.close()
    with pytest.raises(WalError, match="closed"):
        wal.append(_add(0))
    with pytest.raises(WalError, match="closed"):
        wal.wait_durable(5, timeout=1.0)


# -- (b) the crash-point matrix ----------------------------------------------


def test_crash_before_ack_loses_only_the_unacked_record(tmp_path):
    """``wal.append.torn``: the torn, never-acked record is truncated
    loudly; every acked record replays once and the sequence goes on
    with no gap."""
    path = tmp_path / "wal"
    wal = WriteAheadLog(str(path))
    for i in range(3):
        wal.wait_durable(wal.append(_add(i)))
    with failpoints.armed("wal.append.torn"):
        with pytest.raises(failpoints.InjectedFault):
            wal.append(_add(3))
    # No close: the process is gone.  A reopen recovers.
    wal2 = WriteAheadLog(str(path))
    try:
        assert wal2.torn_records == 1 and wal2.torn_bytes > 0
        assert [r["seq"] for r in wal2.replay()] == [1, 2, 3]
        assert wal2.append(_add(3)) == 4
    finally:
        wal2.close()


def test_crash_after_ack_pre_flush_keeps_the_acked_record(tmp_path):
    """With a long group-commit window the ack barrier forces the
    covering fsync: a crash right after the ack keeps the record."""
    path = tmp_path / "wal"
    wal = WriteAheadLog(str(path), flush_interval_s=60.0)
    seq = wal.append(_add(0))
    wal.flush()
    wal.wait_durable(seq)
    assert _replayed(path) == [1]


def test_crash_during_rotation_recovers_unsealed_tail(tmp_path):
    """``wal.rotate.crash`` dies after the finished segment's fsync but
    before its seal: recovery treats it as the clean unsealed tail and
    keeps appending."""
    path = tmp_path / "wal"
    wal = WriteAheadLog(str(path), segment_max_bytes=200)
    acked = []
    with failpoints.armed("wal.rotate.crash"):
        for i in range(12):
            try:
                seq = wal.append(_add(i))
            except failpoints.InjectedFault:
                break
            wal.wait_durable(seq)
            acked.append(seq)
        else:
            pytest.fail("segment never rotated — raise the record size")
    wal2 = WriteAheadLog(str(path), segment_max_bytes=200)
    try:
        assert [r["seq"] for r in wal2.replay()] == acked
        assert wal2.append(_add(99)) == acked[-1] + 1
        assert validate_wal_dir(str(path)) is None
    finally:
        wal2.close()


def test_crash_during_gc_drops_stale_seal_on_recovery(tmp_path):
    """``wal.gc.crash`` dies after a covered segment is unlinked but
    before the manifest rewrite: recovery drops the stale seal and
    replay above the watermark is unaffected."""
    path = tmp_path / "wal"
    wal = WriteAheadLog(str(path), segment_max_bytes=200)
    for i in range(8):
        wal.wait_durable(wal.append(_add(i)))
    sealed = load_wal_manifest(str(path))["sealed"]
    assert sealed, "need at least one sealed segment for GC"
    cover = min(s["last_seq"] for s in sealed.values())
    with failpoints.armed("wal.gc.crash"):
        with pytest.raises(failpoints.InjectedFault):
            wal.gc(cover)
    manifest = load_wal_manifest(str(path))
    present = set(os.listdir(str(path)))
    assert any(name not in present for name in manifest["sealed"])
    # The JAX package reads the crashed directory the same way.
    assert jwal.validate_wal_dir(str(path)) is None
    wal2 = WriteAheadLog(str(path), segment_max_bytes=200)
    try:
        assert [r["seq"] for r in wal2.replay(after_seq=cover)] == \
            list(range(cover + 1, 9))
        survivors = load_wal_manifest(str(path))["sealed"]
        assert all(name in os.listdir(str(path)) for name in survivors)
    finally:
        wal2.close()
    assert validate_wal_dir(str(path)) is None


def test_replay_is_exactly_once_across_repeated_recoveries(tmp_path):
    path = tmp_path / "wal"
    with WriteAheadLog(str(path)) as wal:
        for i in range(4):
            wal.wait_durable(wal.append(_add(i)))
    assert _replayed(path, after_seq=2) == [3, 4]
    assert _replayed(path, after_seq=2) == [3, 4]  # a second cold start
    assert _replayed(path, after_seq=4) == []      # the watermark caught up


# -- (b) validator / tamper ---------------------------------------------------


def test_validate_refuses_truncated_then_patched_copy(tmp_path):
    """A final segment cut at a record boundary is structurally valid;
    the acknowledged watermark is what refuses it."""
    path = tmp_path / "wal"
    with WriteAheadLog(str(path)) as wal:
        for i in range(3):
            wal.wait_durable(wal.append(_add(i)))
    copy = tmp_path / "tampered"
    shutil.copytree(str(path), str(copy))
    seg = [n for n in os.listdir(str(copy)) if n.endswith(".seg")]
    assert len(seg) == 1
    seg_path = os.path.join(str(copy), seg[0])
    blob = open(seg_path, "rb").read()
    off = 0
    for _ in range(2):  # keep 2 of 3 records
        length, _crc = _HEADER.unpack_from(blob, off)
        off += _HEADER.size + length
    with open(seg_path, "r+b") as f:
        f.truncate(off)
    assert validate_wal_dir(str(copy)) is None
    err = validate_wal_dir(str(copy), min_last_seq=3)
    assert err is not None and "acknowledged watermark" in err
    assert err == jwal.validate_wal_dir(str(copy), min_last_seq=3)
    assert validate_wal_dir(str(path), min_last_seq=3) is None


def _doctor_format(path, manifest, sealed_name):
    doctored = dict(manifest, format="npairloss-wal-v0")
    with open(os.path.join(str(path), MANIFEST_NAME), "w") as f:
        f.write(json.dumps(doctored))
    return "format"


def _doctor_seal_crc(path, manifest, sealed_name):
    doctored = json.loads(json.dumps(manifest))
    doctored["sealed"][sealed_name]["crc32"] ^= 1
    with open(os.path.join(str(path), MANIFEST_NAME), "w") as f:
        f.write(json.dumps(doctored))
    return "CRC"


def _doctor_sealed_byte(path, manifest, sealed_name):
    seg_path = os.path.join(str(path), sealed_name)
    blob = bytearray(open(seg_path, "rb").read())
    blob[_HEADER.size + 1] ^= 0xFF
    open(seg_path, "wb").write(bytes(blob))
    return sealed_name


@pytest.mark.parametrize("doctor", [_doctor_format, _doctor_seal_crc,
                                    _doctor_sealed_byte],
                         ids=["format", "seal-crc", "sealed-byte"])
def test_validate_and_recovery_refuse_a_doctored_log(tmp_path, doctor):
    path = tmp_path / "wal"
    with WriteAheadLog(str(path), segment_max_bytes=200) as wal:
        for i in range(8):
            wal.append(_add(i))
    manifest = load_wal_manifest(str(path))
    assert manifest["format"] == WAL_FORMAT
    assert validate_wal_dir(str(path)) is None
    needle = doctor(path, manifest, sorted(manifest["sealed"])[0])
    err = validate_wal_dir(str(path))
    assert err is not None and needle in err
    assert err == jwal.validate_wal_dir(str(path))
    with pytest.raises(WalCorruptionError):
        WriteAheadLog(str(path), segment_max_bytes=200)


def test_wal_info_reports_torn_tail_without_mutating(tmp_path):
    path = tmp_path / "wal"
    with WriteAheadLog(str(path)) as wal:
        for i in range(3):
            wal.append(_add(i))
    seg = [n for n in os.listdir(str(path)) if n.endswith(".seg")][0]
    seg_path = os.path.join(str(path), seg)
    size = os.path.getsize(seg_path)
    with open(seg_path, "r+b") as f:
        f.truncate(size - 3)  # torn mid-payload
    info = wal_info(str(path))
    assert info["torn_tail"] and info["torn_bytes"] > 0
    assert info["last_seq"] == 2
    assert validate_wal_dir(str(path)) is None
    assert "acknowledged watermark" in validate_wal_dir(
        str(path), min_last_seq=3)
    assert os.path.getsize(seg_path) == size - 3


# -- (b) the retry policies and the snapshot dir-fsync pin --------------------


def test_jitter_cap_bounds_absolute_jitter():
    policy = RetryPolicy(max_attempts=3, base_delay=10.0, max_delay=100.0,
                         multiplier=1.0, jitter=0.5, jitter_cap_s=0.1)

    class _Rng:
        def random(self):
            return 1.0  # the worst-case draw

    assert policy.delay(1, rng=_Rng()) == pytest.approx(10.1)
    uncapped = RetryPolicy(max_attempts=3, base_delay=10.0,
                           max_delay=100.0, multiplier=1.0, jitter=0.5)
    assert uncapped.delay(1, rng=_Rng()) == pytest.approx(15.0)
    with pytest.raises(ValueError, match="jitter_cap_s"):
        RetryPolicy(jitter_cap_s=-1.0)


@pytest.mark.parametrize("name", ["wal_replay", "wal_segment_open"])
def test_named_retry_policies_registered(name):
    policy = named_policy(name)
    assert isinstance(policy, RetryPolicy)
    assert policy.jitter_cap_s is not None
    with pytest.raises(KeyError, match="wal_replay"):
        named_policy("no_such_policy")


def test_snapshot_dirsync_failpoint_sits_after_the_rename(tmp_path):
    """``snapshot.commit.dirsync`` fires after the manifest's rename and
    before the parent directory's fsync."""
    d = tmp_path / "snap"
    d.mkdir()
    with failpoints.armed("snapshot.commit.dirsync"):
        with pytest.raises(failpoints.InjectedFault):
            snap.write_manifest(str(d), step=1, checksums={})
    final = os.path.join(str(d), snap.MANIFEST_NAME)
    assert os.path.exists(final)
    assert not os.path.exists(final + ".part")
    assert json.load(open(final))["step"] == 1
