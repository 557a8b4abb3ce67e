"""The port's snapshot commit protocol (npairloss_tpu_torch/resilience/)
against the JAX package's ``npairloss_tpu.resilience``.

  * a port snapshot passes the JAX package's ``validate_snapshot`` and
    the port's own, with the JAX manifest's keys and record keys;
  * ``state_checksums`` gives the JAX package's CRC-32, shape and dtype
    for the same bytes (fp32, bf16, int32);
  * ``list_snapshots``, ``gc_snapshots`` and ``quarantine_snapshots``
    act alike on identical directory trees;
  * the failpoint drills of ``tests/test_resilience.py`` on the port's
    Solver: a crash before the rename leaves an invisible ``.tmp-`` dir,
    a torn commit is rejected at restore by its checksums, transient
    save and restore errors are retried, a manifest-less snapshot is
    skipped by ``restore_auto`` but loads by path, a truncated manifest
    is unreadable;
  * ``NPAIRLOSS_FAILPOINTS`` and the retry schedule parse and draw the
    same in both copies.

Every comparison is exact: the checks are on bytes, names and steps.
"""

import dataclasses
import json
import os
import random
import signal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npairloss_tpu.resilience import failpoints as jax_failpoints
from npairloss_tpu.resilience import preempt as jax_preempt
from npairloss_tpu.resilience import retrying as jax_retrying
from npairloss_tpu.resilience import snapshot as jax_snapshot
from npairloss_tpu_torch.data.synthetic import synthetic_identity_batches
from npairloss_tpu_torch.models import get_model
from npairloss_tpu_torch.ops.npair_loss import NPairLossConfig
from npairloss_tpu_torch.resilience import (
    EXIT_PREEMPTED,
    InjectedFault,
    PreemptionSignal,
    RetryPolicy,
    failpoints,
    retrying,
    snapshot,
)
from npairloss_tpu_torch.resilience.snapshot import (
    SnapshotValidationError,
    TMP_MARKER,
)
from npairloss_tpu_torch.train.solver import Solver, SolverConfig


@pytest.fixture(autouse=True)
def _clean_failpoints():
    failpoints.reset()
    jax_failpoints.reset()
    yield
    failpoints.reset()
    jax_failpoints.reset()


def _make_solver(tmp_path, snapshot=0, max_keep=0, seed=0):
    cfg = SolverConfig(
        base_lr=0.5, lr_policy="fixed", momentum=0.9, weight_decay=0.0,
        display=0, test_interval=0, average_loss=10,
        snapshot=snapshot, snapshot_prefix=str(tmp_path / "snap" / "m_"),
        snapshot_max_keep=max_keep,
    )
    model = get_model("mlp", device="cpu", input_shape=(16,), hidden=(32,),
                      embedding_dim=16, seed=seed)
    solver = Solver(model, NPairLossConfig(), cfg,
                    snapshot_retry=RetryPolicy(base_delay=0.001, jitter=0.0))
    return solver, synthetic_identity_batches(8, 8, 2, (16,), noise=0.5)


def _stepped(tmp_path, **kw):
    solver, batches = _make_solver(tmp_path, **kw)
    solver.step(*next(batches))
    return solver, batches


def _same_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert set(sa) == set(sb)
    return all(torch.equal(sa[k], sb[k]) for k in sa)


# -- the format ---------------------------------------------------------------


def test_port_snapshot_passes_both_validators(tmp_path):
    solver, _ = _stepped(tmp_path)
    path = solver.save_snapshot(1)
    mine = snapshot.validate_snapshot(path)
    theirs = jax_snapshot.validate_snapshot(path)
    assert mine == theirs
    assert mine["step"] == 1 and mine["format"] == "npairloss-snapshot-v1"
    # The JAX package's own manifest carries the same keys.
    ref = tmp_path / "ref"
    ref.mkdir()
    jax_snapshot.write_manifest(str(ref), 1, {"a": {"crc32": 0, "shape": [],
                                                   "dtype": "int32"}})
    assert set(mine) == set(jax_snapshot.read_manifest(str(ref)))
    assert set(mine["arrays"]) == set(solver.state_dict())
    assert all(set(r) == {"crc32", "shape", "dtype"}
               for r in mine["arrays"].values())
    assert mine["arrays"]["iteration"]["dtype"] == "int64"
    assert not [n for n in os.listdir(tmp_path / "snap") if TMP_MARKER in n]
    assert (snapshot.MANIFEST_NAME, snapshot.SNAPSHOT_FORMAT,
            snapshot.TMP_MARKER, snapshot.QUARANTINE_SUFFIX) == (
        jax_snapshot.MANIFEST_NAME, jax_snapshot.SNAPSHOT_FORMAT,
        jax_snapshot.TMP_MARKER, jax_snapshot.QUARANTINE_SUFFIX)
    assert snapshot.snapshot_info(path)["step"] == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_state_checksums_match_jax(dtype):
    rng = np.random.default_rng(7)
    arrays = {"w": rng.standard_normal((5, 3)).astype(np.float32) * 3,
              "b": rng.standard_normal((7,)).astype(np.float32),
              "s": np.float32(rng.standard_normal())}
    if dtype == "int32":
        arrays = {k: (v * 100).astype(np.int32) for k, v in arrays.items()}
    jax_tree = {k: jnp.asarray(v, dtype=getattr(jnp, dtype))
                for k, v in arrays.items()}
    port = {k: torch.from_numpy(np.asarray(v)).to(getattr(torch, dtype))
            for k, v in arrays.items()}
    want = jax_snapshot.state_checksums(jax_tree)
    got = snapshot.state_checksums(port)
    assert got == {k.strip("[]'"): v for k, v in want.items()}
    assert {r["dtype"] for r in got.values()} == {dtype}


def _tree(root):
    """One directory tree of committed snapshots and the debris around
    them."""
    root.mkdir()
    for step in (1, 2, 3, 5, 10):
        (root / f"m_iter_{step}.ckpt").mkdir()
    (root / "m_iter_4.ckpt.tmp-12-ab01").mkdir()
    (root / "m_iter_7.ckpt.quarantined").mkdir()
    (root / "m_iter_6.ckpt").write_text("a file, not a snapshot")
    (root / "x_iter_8.ckpt").mkdir()
    (root / "m_iter_9.ckpt.old").mkdir()
    return str(root / "m_")


@pytest.mark.parametrize("op", ["list", "gc0", "gc1", "gc2", "quarantine"])
def test_discovery_gc_and_quarantine_match_jax(tmp_path, op):
    out = {}
    for name, mod in (("jax", jax_snapshot), ("port", snapshot)):
        prefix = _tree(tmp_path / name)
        if op == "list":
            res = mod.list_snapshots(prefix)
        elif op.startswith("gc"):
            res = mod.gc_snapshots(prefix, int(op[2:]))
        else:
            res = mod.quarantine_snapshots(prefix, 3)
        left = sorted(os.listdir(tmp_path / name))
        norm = sorted(os.path.basename(r[1] if isinstance(r, tuple) else r)
                      for r in res)
        steps = [r[0] for r in res] if op == "list" else None
        out[name] = (norm, steps, left)
    assert out["port"] == out["jax"]
    if op == "gc1":
        assert out["port"][2] == ["m_iter_10.ckpt", "m_iter_6.ckpt",
                                  "m_iter_9.ckpt.old", "x_iter_8.ckpt"]


# -- the failpoint drills -----------------------------------------------------


def test_commit_crash_before_rename_is_invisible_to_resume(tmp_path):
    solver, _ = _stepped(tmp_path)
    failpoints.arm("snapshot.commit.crash", times=1)
    with pytest.raises(InjectedFault):
        solver.save_snapshot(1)
    # Tensors and manifest hit disk, the rename never happened.
    assert not os.path.exists(solver.snapshot_path(1))
    tmp = [n for n in os.listdir(tmp_path / "snap") if TMP_MARKER in n]
    assert len(tmp) == 1
    assert sorted(os.listdir(tmp_path / "snap" / tmp[0])) == [
        "manifest.json", "state.pt"]
    assert snapshot.list_snapshots(solver.cfg.snapshot_prefix) == []
    assert jax_snapshot.list_snapshots(solver.cfg.snapshot_prefix) == []
    solver2, _ = _make_solver(tmp_path, seed=1)
    assert solver2.restore_auto() is None  # fresh start
    assert solver2.iteration == 0


def test_dirsync_crash_publishes_nothing(tmp_path):
    solver, _ = _stepped(tmp_path)
    failpoints.arm("snapshot.commit.dirsync", times=1)
    with pytest.raises(InjectedFault):
        solver.save_snapshot(1)
    assert snapshot.list_snapshots(solver.cfg.snapshot_prefix) == []


def test_injected_torn_commit_is_rejected_at_restore(tmp_path):
    solver, _ = _stepped(tmp_path)
    failpoints.arm("snapshot.commit.torn", times=1)
    path = solver.save_snapshot(1)
    snapshot.validate_snapshot(path)  # structurally fine ...
    jax_snapshot.validate_snapshot(path)
    solver2, _ = _make_solver(tmp_path, seed=1)
    before = {k: v.clone() for k, v in solver2.state_dict().items()}
    with pytest.raises(SnapshotValidationError, match="checksum"):
        solver2.restore_snapshot(path)  # ... but its bytes do not match
    assert solver2.restore_auto() is None
    assert all(torch.equal(before[k], v)
               for k, v in solver2.state_dict().items())


def test_resume_auto_skips_a_corrupt_snapshot_with_reason(tmp_path, caplog):
    solver, batches = _make_solver(tmp_path)
    for k in (1, 2):
        solver.step(*next(batches))
        solver.save_snapshot(k)
    newest = solver.snapshot_path(2)
    manifest = snapshot.read_manifest(newest)
    next(iter(manifest["arrays"].values()))["crc32"] ^= 1
    with open(os.path.join(newest, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    solver2, _ = _make_solver(tmp_path, seed=1)
    with caplog.at_level("WARNING", logger="npairloss_tpu_torch.solver"):
        restored = solver2.restore_auto()
    assert restored == solver.snapshot_path(1)
    assert solver2.iteration == 1
    skip = [r for r in caplog.records if "skipping snapshot" in r.message]
    assert skip and "checksum mismatch" in skip[0].message


def test_transient_save_error_is_retried(tmp_path, caplog):
    solver, batches = _make_solver(tmp_path, snapshot=2)
    failpoints.arm("snapshot.save.io", times=1)
    with caplog.at_level("WARNING",
                         logger="npairloss_tpu_torch.resilience"):
        solver.train(batches, num_iters=3)
    assert any("retrying" in r.message for r in caplog.records)
    assert snapshot.validate_snapshot(solver.snapshot_path(2))["step"] == 2


def test_transient_restore_error_is_retried(tmp_path, caplog):
    solver, _ = _stepped(tmp_path)
    path = solver.save_snapshot(1)
    solver2, _ = _make_solver(tmp_path, seed=1)
    failpoints.arm("snapshot.restore.io", times=1)
    with caplog.at_level("WARNING",
                         logger="npairloss_tpu_torch.resilience"):
        assert solver2.restore_snapshot(path) == path
    assert any("retrying" in r.message for r in caplog.records)
    assert _same_state(solver, solver2)


def test_manifest_less_snapshot_skipped_on_auto_but_loads_explicitly(
        tmp_path, caplog):
    solver, _ = _stepped(tmp_path)
    path = solver.save_snapshot(1)
    os.remove(os.path.join(path, "manifest.json"))
    solver2, _ = _make_solver(tmp_path, seed=1)
    with caplog.at_level("WARNING", logger="npairloss_tpu_torch.solver"):
        assert solver2.restore_auto() is None
    assert any("no manifest" in r.message for r in caplog.records)
    solver3, _ = _make_solver(tmp_path, seed=1)
    solver3.restore_snapshot(path)
    assert solver3.iteration == 1
    assert _same_state(solver, solver3)


def test_explicit_restore_rejects_a_truncated_manifest(tmp_path):
    solver, _ = _stepped(tmp_path)
    path = solver.save_snapshot(1)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        f.write('{"format": "npairloss-snapsho')  # truncated mid-write
    solver2, _ = _make_solver(tmp_path, seed=1)
    with pytest.raises(SnapshotValidationError, match="unreadable manifest"):
        solver2.restore_snapshot(path)
    with pytest.raises(jax_snapshot.SnapshotValidationError,
                       match="unreadable manifest"):
        jax_snapshot.validate_snapshot(path)


def test_snapshot_of_another_model_is_refused_untouched(tmp_path):
    solver, _ = _stepped(tmp_path)
    path = solver.save_snapshot(1)
    cfg = SolverConfig(snapshot_prefix=str(tmp_path / "snap" / "m_"))
    other = Solver(get_model("mlp", device="cpu", input_shape=(16,),
                             hidden=(8,), embedding_dim=16), cfg=cfg)
    with pytest.raises(SnapshotValidationError, match="shapes"):
        other.restore_snapshot(path)
    assert other.iteration == 0


def test_snapshot_retention_gc(tmp_path):
    solver, batches = _make_solver(tmp_path, snapshot=1, max_keep=2)
    solver.train(batches, num_iters=5)
    snaps = snapshot.list_snapshots(solver.cfg.snapshot_prefix)
    assert [s for s, _ in snaps] == [4, 5]
    for _, p in snaps:
        snapshot.validate_snapshot(p)
        jax_snapshot.validate_snapshot(p)


# -- the stdlib copies --------------------------------------------------------


@pytest.mark.parametrize("spec", [
    "snapshot.save.io:2,data.worker",
    "train.collapse:3@2, snapshot.commit.torn@1 ,bad:x",
    "serve.latency:0,snapshot.restore.io:1@3",
])
def test_failpoint_env_parses_the_same(monkeypatch, spec):
    monkeypatch.setenv("NPAIRLOSS_FAILPOINTS", spec)
    names = ["snapshot.save.io", "data.worker", "train.collapse",
             "snapshot.commit.torn", "bad", "serve.latency",
             "snapshot.restore.io"]
    fires = {}
    for name, mod in (("jax", jax_failpoints), ("port", failpoints)):
        mod.reset()
        fires[name] = [[mod.should_fire(n) for n in names]
                       for _ in range(6)]
    assert fires["port"] == fires["jax"]
    assert failpoints.ENV_VAR == jax_failpoints.ENV_VAR


def test_retry_schedule_and_preemption_contract_match_jax():
    for kw in ({}, {"jitter_cap_s": 0.05, "max_delay": 1.0}):
        mine, theirs = RetryPolicy(**kw), jax_retrying.RetryPolicy(**kw)
        a, b = random.Random(3), random.Random(3)
        assert [mine.delay(k, a) for k in range(1, 8)] == \
            [theirs.delay(k, b) for k in range(1, 8)]
    for name in ("wal_replay", "wal_segment_open"):
        assert retrying.named_policy(name) == RetryPolicy(
            **dataclasses.asdict(jax_retrying.named_policy(name)))
    assert EXIT_PREEMPTED == jax_preempt.EXIT_PREEMPTED == 75
    sig = PreemptionSignal()
    assert not sig.requested
    sig.request(signal.SIGTERM)
    assert sig.requested and sig.signum == signal.SIGTERM
