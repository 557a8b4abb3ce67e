"""The port's divergence guard and requested rollbacks
(npairloss_tpu_torch/resilience/guard.py, the Solver's recovery paths)
in both loops, against the JAX package's ``npairloss_tpu.resilience``.

  * the guard's streak, its config's validation and the CLI flags'
    names, defaults and choices equal the JAX package's;
  * the drills of tests/test_resilience.py and tests/test_remediate.py
    on the port's Solver, in the synchronous and the pipelined loop:
    the rollback restoring (and scaling) lr, the rollback skipping the
    snapshots of the NaN streak and quarantining them, halt, the
    exhausted budget, no snapshot, ``train.collapse`` poisoning one row,
    requested rollbacks run and skipped;
  * the same rollback events as the JAX Solver's in the same drill;
  * the snapshots left behind pass the JAX package's validator (its
    ``resilience/snapshot.py`` loaded by file path).

Every comparison is exact: events, iterations, log lines, steps, bytes.
"""

import argparse
import dataclasses
import importlib.util
import io
import json
import os
import time
from contextlib import redirect_stdout

import numpy as np
import pytest

from npairloss_tpu import cli as jax_cli
from npairloss_tpu.data import synthetic_identity_batches as jax_batches
from npairloss_tpu.models import get_model as jax_get_model
from npairloss_tpu.ops.npair_loss import NPairLossConfig as JaxLossConfig
from npairloss_tpu.resilience import failpoints as jax_failpoints
from npairloss_tpu.resilience import guard as jax_guard
from npairloss_tpu.train import Solver as JaxSolver
from npairloss_tpu.train import SolverConfig as JaxSolverConfig
from npairloss_tpu_torch import cli
from npairloss_tpu_torch.data.synthetic import synthetic_identity_batches
from npairloss_tpu_torch.models import get_model
from npairloss_tpu_torch.ops.npair_loss import NPairLossConfig
from npairloss_tpu_torch.resilience import (
    ACTIONS,
    DivergenceConfig,
    DivergenceError,
    DivergenceGuard,
    RetryPolicy,
    RollbackRequest,
    failpoints,
    gc_snapshots,
    list_snapshots,
    quarantine_snapshots,
)
from npairloss_tpu_torch.resilience.snapshot import QUARANTINE_SUFFIX
from npairloss_tpu_torch.train.solver import Solver, SolverConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOOPS = [pytest.param(False, id="sync"), pytest.param(True, id="pipelined")]


def _jax_validator():
    """``validate_snapshot`` of the JAX package's
    ``resilience/snapshot.py``, loaded by file path."""
    path = os.path.join(REPO, "npairloss_tpu", "resilience", "snapshot.py")
    spec = importlib.util.spec_from_file_location("_jax_snapshot_by_path",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.validate_snapshot


@pytest.fixture(autouse=True)
def _clean_failpoints():
    failpoints.reset()
    jax_failpoints.reset()
    yield
    failpoints.reset()
    jax_failpoints.reset()


def _cfg_kw(tmp_path, pipeline, **kw):
    base = dict(base_lr=0.5, lr_policy="fixed", momentum=0.9,
                weight_decay=0.0, display=0, test_interval=0,
                average_loss=10, snapshot=0,
                snapshot_prefix=str(tmp_path / "snap" / "m_"),
                pipeline=pipeline)
    base.update(kw)
    return base


def _make_solver(tmp_path, pipeline=False, divergence=None, **kw):
    solver = Solver(
        get_model("mlp", device="cpu", input_shape=(16,), hidden=(32,),
                  embedding_dim=16, seed=0),
        NPairLossConfig(), SolverConfig(**_cfg_kw(tmp_path, pipeline, **kw)),
        snapshot_retry=RetryPolicy(base_delay=0.001, jitter=0.0))
    solver.divergence = divergence
    return solver, synthetic_identity_batches(8, 8, 2, (16,), noise=0.5)


def _make_jax_solver(tmp_path, pipeline=False, divergence=None, **kw):
    solver = JaxSolver(
        jax_get_model("mlp", hidden=(32,), embedding_dim=16),
        JaxLossConfig(), JaxSolverConfig(**_cfg_kw(tmp_path, pipeline, **kw)),
        input_shape=(16,))
    solver.divergence = divergence
    return solver, jax_batches(8, 8, 2, (16,), noise=0.5)


def _arm_nan(times, after, fps=failpoints):
    """``step.nan_loss`` for ``times`` steps after the first ``after``
    (by step count, so the pipelined loop's staging thread, which pulls
    batches ahead, arms it at the same step as the synchronous loop)."""
    fps.arm("step.nan_loss", times=times, delay=after)


# -- the guard itself ------------------------------------------------------


@pytest.mark.parametrize("losses, patience", [
    ([1.0, float("nan"), float("nan"), 2.0, float("inf")], 2),
    ([float("nan")] * 5, 3),
    ([0.0, 1.0, -1.0], 1),
    ([float("nan"), 1.0, float("nan"), float("-inf"), float("nan")], 3),
])
def test_guard_observe_matches_jax(losses, patience):
    mine = DivergenceGuard(DivergenceConfig(patience=patience))
    theirs = jax_guard.DivergenceGuard(
        jax_guard.DivergenceConfig(patience=patience))
    for v in losses:
        assert mine.observe(v) == theirs.observe(v)
        assert mine.streak == theirs.streak


@pytest.mark.parametrize("kw", [
    {}, {"patience": 0}, {"patience": 1}, {"action": "panic"},
    {"action": "halt"}, {"lr_scale": 0.0}, {"lr_scale": 1.5},
    {"lr_scale": 0.5}, {"max_rollbacks": 0},
])
def test_divergence_config_validation_matches_jax(kw):
    def outcome(cls):
        try:
            return dataclasses.asdict(cls(**kw))
        except ValueError as e:
            return f"ValueError: {e}"

    assert outcome(DivergenceConfig) == outcome(jax_guard.DivergenceConfig)
    assert ACTIONS == jax_guard.ACTIONS


@pytest.mark.parametrize("lr_scale", [1.0, 0.5, 0.0, 2.0])
def test_rollback_request_validation_matches_jax(lr_scale):
    def outcome(cls):
        try:
            return dataclasses.asdict(cls("r", 1.0, lr_scale))
        except ValueError as e:
            return f"ValueError: {e}"

    assert outcome(RollbackRequest) == outcome(jax_guard.RollbackRequest)


# -- the divergence guard in both loops -------------------------------------


@pytest.mark.parametrize("pipeline", LOOPS)
def test_divergence_rollback_restores_and_scales_lr(tmp_path, pipeline):
    """Snapshots at 2 and 4; NaNs at 5 and 6 trip the guard; the step-4
    update is implicated by the first NaN, so the target is 2."""
    solver, batches = _make_solver(
        tmp_path, pipeline, snapshot=2,
        divergence=DivergenceConfig(patience=2, action="rollback",
                                    lr_scale=0.5, max_rollbacks=1))
    logs, events = [], []
    _arm_nan(2, 4)
    final = solver.train(batches, num_iters=8,
                         log_fn=logs.append, record_fn=events.append)
    assert any("rolled back to iteration 2" in line for line in logs)
    assert solver.iteration == 8
    assert solver.cfg.base_lr == pytest.approx(0.25)
    assert solver.rate_fn(0) == pytest.approx(0.25)
    assert np.isfinite(final["loss"])
    rb = [e for e in events if e["event"] == "rollback"]
    assert [(e["iteration"], e["to_iteration"], list(e)) for e in rb] == [
        (6, 2, ["event", "iteration", "to_iteration", "snapshot"])]
    validate = _jax_validator()
    for step, path in list_snapshots(solver.cfg.snapshot_prefix):
        assert validate(path)["step"] == step


def test_divergence_rollback_events_match_the_jax_solver(tmp_path):
    """The same drill on the JAX Solver and the port's (both loops): the
    same rollback records, log line shape and final iteration."""
    kw = dict(snapshot=2, divergence=None)
    out = {}
    for name, make, fps in (("jax", _make_jax_solver, jax_failpoints),
                            ("sync", _make_solver, failpoints),
                            ("pipe", _make_solver, failpoints)):
        solver, batches = make(tmp_path / name, name == "pipe", **kw)
        solver.divergence = (jax_guard.DivergenceConfig if name == "jax"
                             else DivergenceConfig)(
            patience=2, action="rollback", lr_scale=0.5, max_rollbacks=1)
        logs, events = [], []
        _arm_nan(2, 4, fps)
        solver.train(batches, num_iters=8,
                     log_fn=logs.append, record_fn=events.append)
        prefix = os.path.abspath(str(tmp_path / name))
        out[name] = ([json.dumps(e).replace(prefix, "<p>") for e in events],
                     [ln.replace(prefix, "<p>") for ln in logs
                      if "rolled back" in ln], solver.iteration)
    assert out["sync"] == out["jax"] == out["pipe"]


@pytest.mark.parametrize("pipeline", LOOPS)
def test_divergence_rollback_skips_snapshots_inside_nan_streak(tmp_path,
                                                               pipeline):
    """NaNs at 3, 4, 5 (patience 3): snapshots 3 and 4 were committed
    mid-streak and 2 is implicated by the first NaN — the rollback lands
    on 1 and the suspect snapshots are quarantined (then swept by GC as
    retraining re-commits those steps)."""
    solver, batches = _make_solver(
        tmp_path, pipeline, snapshot=1,
        divergence=DivergenceConfig(patience=3, action="rollback",
                                    max_rollbacks=1))
    moved = []
    import npairloss_tpu_torch.train.solver as tsolver

    orig = tsolver.quarantine_snapshots

    def recording(prefix, min_step):
        got = orig(prefix, min_step)
        moved.append([os.path.basename(p) for p in got])
        return got

    tsolver.quarantine_snapshots = recording
    try:
        logs = []
        _arm_nan(3, 2)
        solver.train(batches, num_iters=6, log_fn=logs.append)
    finally:
        tsolver.quarantine_snapshots = orig
    assert any("rolled back to iteration 1" in line for line in logs)
    assert solver.iteration == 6
    if pipeline:
        # The window (capacity 1: snapshot every step) reads each step,
        # so the trip is at 5 in both loops.
        assert solver._pipeline_window_capacity(False) == 1
    assert moved == [[f"m_iter_{k}.ckpt{QUARANTINE_SUFFIX}"
                      for k in (2, 3, 4)]]
    assert [s for s, _ in list_snapshots(solver.cfg.snapshot_prefix)] == \
        [1, 2, 3, 4, 5, 6]
    validate = _jax_validator()
    for step, path in list_snapshots(solver.cfg.snapshot_prefix):
        assert validate(path)["step"] == step


def test_quarantine_hides_suspect_snapshots_and_gc_sweeps(tmp_path):
    solver, batches = _make_solver(tmp_path, snapshot=1)
    solver.train(batches, num_iters=3, log_fn=lambda s: None)
    prefix = solver.cfg.snapshot_prefix
    assert [s for s, _ in list_snapshots(prefix)] == [1, 2, 3]
    moved = quarantine_snapshots(prefix, min_step=1)
    assert len(moved) == 2 and all(
        p.endswith(QUARANTINE_SUFFIX) for p in moved)
    validate = _jax_validator()
    for p in moved:  # checksum-valid bytes, only renamed aside
        assert validate(p)["step"] in (2, 3)
    assert [s for s, _ in list_snapshots(prefix)] == [1]
    solver2, _ = _make_solver(tmp_path)
    assert solver2.restore_auto() == solver.snapshot_path(1)
    swept = gc_snapshots(prefix, 0)
    assert sorted(swept) == sorted(moved)
    assert not [n for n in os.listdir(tmp_path / "snap")
                if n.endswith(QUARANTINE_SUFFIX)]


@pytest.mark.parametrize("pipeline", LOOPS)
def test_divergence_halt_raises(tmp_path, pipeline):
    solver, batches = _make_solver(
        tmp_path, pipeline,
        divergence=DivergenceConfig(patience=2, action="halt"))
    failpoints.arm("step.nan_loss", times=2)
    with pytest.raises(DivergenceError,
                       match="2 consecutive non-finite losses at iteration "
                       "2$"):
        solver.train(batches, num_iters=6, log_fn=lambda s: None)


@pytest.mark.parametrize("pipeline", LOOPS)
def test_divergence_rollback_budget_exhausted_halts(tmp_path, pipeline):
    solver, batches = _make_solver(
        tmp_path, pipeline, snapshot=1,
        divergence=DivergenceConfig(patience=1, action="rollback",
                                    max_rollbacks=1))
    with pytest.raises(DivergenceError, match="budget 1 exhausted"):
        _arm_nan(None, 2)
        solver.train(batches, num_iters=6, log_fn=lambda s: None)


@pytest.mark.parametrize("pipeline", LOOPS)
def test_divergence_without_snapshot_halts_with_reason(tmp_path, pipeline):
    solver, batches = _make_solver(
        tmp_path, pipeline,
        divergence=DivergenceConfig(patience=1, action="rollback"))
    failpoints.arm("step.nan_loss", times=1)
    with pytest.raises(DivergenceError, match="no valid snapshot"):
        solver.train(batches, num_iters=4, log_fn=lambda s: None)


# -- the CLI ------------------------------------------------------------------

_FLAGS = ("divergence_patience", "divergence_action", "divergence_lr_scale",
          "divergence_max_rollbacks", "pipeline", "pipeline_depth",
          "pipeline_window", "compile_cache", "engine", "mesh", "mp",
          "partition_rules", "coordinator", "num_processes", "process_id")


def _train_actions(parser):
    sub = next(a for a in parser._actions
               if a.__class__.__name__ == "_SubParsersAction")
    return {a.dest: a for a in sub.choices["train"]._actions}


def _jax_parser(monkeypatch):
    """The JAX CLI's parser, which its ``main`` builds inline: taken at
    its ``parse_args``."""
    got = {}

    class Taken(Exception):
        pass

    def take(self, *a, **kw):
        got["parser"] = self
        raise Taken

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", take)
    with pytest.raises(Taken):
        jax_cli.main(["train"])
    monkeypatch.undo()
    return got["parser"]


@pytest.mark.parametrize("dest", _FLAGS)
def test_train_flags_match_the_jax_cli(dest, monkeypatch):
    mine = _train_actions(cli.build_parser())[dest]
    theirs = _train_actions(_jax_parser(monkeypatch))[dest]
    assert mine.option_strings == theirs.option_strings
    assert mine.default == theirs.default
    assert mine.choices == theirs.choices
    assert mine.type == theirs.type
    assert mine.metavar == theirs.metavar


def test_serve_takes_compile_cache_and_train_refuses_mesh(capsys, caplog,
                                                          monkeypatch):
    """``serve`` takes ``--compile-cache`` and not ``--mesh`` (the
    mesh-sharded gallery is not ported); ``train --mesh 2`` parses, and
    outside a process group exits 2 with the launch recipe."""
    p = cli.build_parser()
    args = p.parse_args(["serve", "--index", "x.gidx", "--compile-cache",
                         "cc"])
    assert args.compile_cache == "cc"
    with pytest.raises(SystemExit):
        p.parse_args(["serve", "--index", "x.gidx", "--mesh", "2"])
    assert "unrecognized arguments: --mesh" in capsys.readouterr().err
    assert p.parse_args(["train", "--solver", "s", "--mesh", "2"]).mesh == 2
    monkeypatch.chdir(REPO)
    assert cli.main(["train", "--solver", "examples/tiny_solver.prototxt",
                     "--synthetic", "--device", "cpu", "--mesh", "2"]) == 2
    assert "not in a process group" in caplog.text


def _write_solver(tmp_path, **kw):
    text = open(os.path.join(REPO, "examples", "tiny_solver.prototxt")).read()
    for k, v in kw.items():
        text = text.replace(f"{k}: 0\n", f"{k}: {v}\n") if f"{k}: 0\n" in \
            text else text + f"{k}: {v}\n"
    text = text.replace('net: "examples/tiny_net.prototxt"',
                        f'net: "{REPO}/examples/tiny_net.prototxt"')
    path = tmp_path / "solver.prototxt"
    path.write_text(text)
    return str(path)


@pytest.mark.parametrize("pipeline", LOOPS)
def test_cli_divergence_flags(tmp_path, pipeline):
    """``--divergence-patience 2 --divergence-action halt`` exits 1 with
    the diagnosis; ``rollback`` restores and finishes; both loops."""
    solver = _write_solver(tmp_path, snapshot=2)
    extra = ["--pipeline"] if pipeline else []
    base = ["train", "--solver", solver, "--synthetic", "--device", "cpu",
            "--snapshot_prefix", str(tmp_path / "m_"), *extra]
    failpoints.arm("step.nan_loss", times=2)
    with redirect_stdout(io.StringIO()):
        rc = cli.main(base + ["--max_iter", "8", "--divergence-patience",
                              "2", "--divergence-action", "halt"])
    assert rc == 1
    failpoints.reset()
    events = tmp_path / "e.jsonl"
    failpoints.arm("step.nan_loss", times=2, delay=4)
    out = io.StringIO()
    with redirect_stdout(out):
        rc = cli.main(base + ["--max_iter", "10", "--log-json", str(events),
                              "--divergence-patience", "2",
                              "--divergence-lr-scale", "0.5",
                              "--divergence-max-rollbacks", "1"])
    assert rc == 0
    assert "rolled back to iteration" in out.getvalue()
    rb = [json.loads(ln) for ln in events.read_text().splitlines()
          if '"rollback"' in ln]
    assert len(rb) == 1 and rb[0]["iteration"] == 6
    assert "lr=0.025" in out.getvalue()
    with redirect_stdout(io.StringIO()):
        assert cli.main(base + ["--max_iter", "2", "--divergence-patience",
                                "1", "--divergence-lr-scale", "0"]) == 2


# -- train.collapse and requested rollbacks (tests/test_remediate.py) ------


@pytest.mark.parametrize("pipeline", LOOPS)
def test_train_collapse_failpoint_poisons_row(tmp_path, pipeline):
    solver, batches = _make_solver(tmp_path, pipeline, display=1)
    events = []
    failpoints.arm("train.collapse", times=2)
    solver.train(batches, num_iters=4, record_fn=events.append,
                 log_fn=lambda s: None)
    displays = [e for e in events if e["event"] == "display"]
    assert [e.get("an_threshold_mean") for e in displays] == \
        [1.0, 1.0, None, None]


def test_train_collapse_rows_match_the_jax_solver(tmp_path):
    keys = {}
    for name, make, fps in (("jax", _make_jax_solver, jax_failpoints),
                            ("port", _make_solver, failpoints)):
        solver, batches = make(tmp_path / name, display=1)
        events = []
        fps.arm("train.collapse", times=2)
        solver.train(batches, num_iters=4, record_fn=events.append,
                     log_fn=lambda s: None)
        keys[name] = [list(e) for e in events]
    assert keys["port"] == keys["jax"]


@pytest.mark.parametrize("pipeline", LOOPS)
def test_requested_rollback_executes_and_skips(tmp_path, pipeline):
    solver, batches = _make_solver(tmp_path, pipeline, snapshot=2,
                                   display=4 if pipeline else 0)
    events = []
    fired = {"done": False}

    def record(ev):
        events.append(ev)
        if ev["event"] == "snapshot" and ev["iteration"] >= 2 \
                and not fired["done"]:
            fired["done"] = True
            solver.request_rollback(RollbackRequest(
                reason="collapse alert", before_wall_time=time.time()))

    solver.train(batches, num_iters=6 if not pipeline else 8,
                 record_fn=record, log_fn=lambda s: None)
    rb = [e for e in events if e["event"] == "rollback"]
    assert len(rb) == 1 and rb[0]["requested"] is True
    # The next safe point: the next step (sync), the next window
    # boundary (pipelined: windows of 2, the snapshot cadence).
    assert rb[0]["iteration"] == (3 if not pipeline else 4)
    assert rb[0]["to_iteration"] == 2
    assert solver.iteration == (6 if not pipeline else 8)

    # A request predating every snapshot SKIPS; training continues.
    solver2, batches2 = _make_solver(tmp_path / "two", pipeline, snapshot=2)
    events2, logs2 = [], []
    armed = {"done": False}

    def record2(ev):
        events2.append(ev)
        if ev["event"] == "snapshot" and not armed["done"]:
            armed["done"] = True
            solver2.request_rollback(RollbackRequest(
                reason="too early", before_wall_time=1.0))

    solver2.train(batches2, num_iters=4, record_fn=record2,
                  log_fn=logs2.append)
    assert not [e for e in events2 if e["event"] == "rollback"]
    assert any("skipped: no snapshot" in ln for ln in logs2)
    assert solver2.iteration == 4


def test_requested_rollback_matches_the_jax_solver(tmp_path):
    """The JAX and the port Solvers take the same request at the same
    step, with the same record."""
    out = {}
    for name, make, req_cls in (
            ("jax", _make_jax_solver, jax_guard.RollbackRequest),
            ("port", _make_solver, RollbackRequest)):
        solver, batches = make(tmp_path / name, snapshot=2)
        events = []
        fired = {"done": False}

        def record(ev, solver=solver, events=events, fired=fired,
                   req_cls=req_cls):
            events.append(ev)
            if ev["event"] == "snapshot" and ev["iteration"] == 4 \
                    and not fired["done"]:
                fired["done"] = True
                solver.request_rollback(req_cls(
                    reason="collapse alert", before_wall_time=time.time()))

        solver.train(batches, num_iters=6, record_fn=record,
                     log_fn=lambda s: None)
        prefix = os.path.abspath(str(tmp_path / name))
        out[name] = [json.dumps(e).replace(prefix, "<p>") for e in events]
    assert out["port"] == out["jax"]
