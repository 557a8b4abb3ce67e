"""The port's sync-free stepping (npairloss_tpu_torch/pipeline/, the
Solver's pipelined loop) against its synchronous loop and the JAX
package's ``npairloss_tpu.pipeline``.

On the CPU the pipelined step runs its body eagerly (the card replays it
as one captured CUDA graph: chip_smoke phase 5h).  Tolerances: the
pipelined loop against the port's synchronous loop — display lines,
``--log-json`` records and the returned metrics byte for byte, the
parameters bit for bit; against the JAX package — the controller's wait
order, the window's rows and counters, the capacity rule and the
exported names exactly; the JAX pipelined Solver's metrics within 1e-5
(the same fp32 step, matmuls summed in another order); the JAX CLI's
``--pipeline`` stream in its events, iterations, keys and masked display
lines exactly.
"""

import dataclasses
import io
import json
import os
import re
import threading
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from npairloss_tpu import cli as jax_cli
from npairloss_tpu import pipeline as jax_pipeline
from npairloss_tpu.config import load_net as jax_load_net
from npairloss_tpu.config import load_solver as jax_load_solver
from npairloss_tpu.models import get_model as jax_get_model
from npairloss_tpu.resilience import failpoints as jax_failpoints
from npairloss_tpu.train import Solver as JaxSolver
from npairloss_tpu.train import SolverConfig as JaxSolverConfig
from npairloss_tpu_torch import cli
from npairloss_tpu_torch import device as tdevice
from npairloss_tpu_torch import pipeline
from npairloss_tpu_torch.config.schema import load_net, load_solver
from npairloss_tpu_torch.data.synthetic import synthetic_identity_batches
from npairloss_tpu_torch.models import get_model
from npairloss_tpu_torch.ops.npair_loss import MiningMethod, NPairLossConfig
from npairloss_tpu_torch.pipeline import (
    DevicePrefetcher,
    DispatchController,
    HostSyncMonitor,
    MetricWindow,
    PrefetchStageError,
    SyncGuardViolation,
)
from npairloss_tpu_torch.pipeline.controller import step_token
from npairloss_tpu_torch.resilience import (
    DivergenceConfig,
    PreemptionSignal,
    TrainingPreempted,
    failpoints,
)
from npairloss_tpu_torch.train.optim import scaled_lr
from npairloss_tpu_torch.train.solver import Solver, SolverConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_SOLVER = os.path.join(REPO, "examples", "tiny_solver.prototxt")
TINY_NET = os.path.join(REPO, "examples", "tiny_net.prototxt")
TOL = 1e-5


@pytest.fixture(autouse=True)
def _clean_failpoints():
    failpoints.reset()
    jax_failpoints.reset()
    yield
    failpoints.reset()
    jax_failpoints.reset()


def _make_solver(pipeline_on, **cfg_kw):
    kw = dict(base_lr=0.5, lr_policy="fixed", momentum=0.9, weight_decay=0.0,
              display=5, test_interval=0, snapshot=0, average_loss=10,
              pipeline=pipeline_on)
    kw.update(cfg_kw)
    loss_cfg = NPairLossConfig(margin_diff=-0.05,
                               an_mining_method=MiningMethod.HARD,
                               ap_mining_method=MiningMethod.RAND)
    model = get_model("mlp", device="cpu", input_shape=(16,), hidden=(32,),
                      embedding_dim=16, seed=0)
    return (Solver(model, loss_cfg, SolverConfig(**kw)),
            synthetic_identity_batches(8, 8, 2, (16,), noise=0.6))


def _params_equal(a, b):
    return all(torch.equal(x, y) for x, y in
               zip(a.state_dict().values(), b.state_dict().values()))


# -- unit pieces -----------------------------------------------------------


class _FakeToken:
    def __init__(self, log, name):
        self.log, self.name = log, name

    def block_until_ready(self):
        self.log.append(self.name)


def test_dispatch_controller_bounds_like_jax():
    logs = {}
    for name, cls in (("port", DispatchController),
                      ("jax", jax_pipeline.DispatchController)):
        log = logs[name] = []
        ctl = cls(max_in_flight=2)
        for i in range(5):
            ctl.reserve()
            assert ctl.in_flight <= 1
            ctl.admit(_FakeToken(log, i))
        assert log == [0, 1, 2]
        ctl.drain()
        assert ctl.blocked == 3
        with pytest.raises(ValueError):
            cls(0)
    assert logs["port"] == logs["jax"] == [0, 1, 2, 3, 4]


def test_cpu_step_token_is_already_done():
    tok = step_token(torch.device("cpu"))
    tok.block_until_ready()
    ctl = DispatchController(1)
    ctl.admit(tok)
    ctl.reserve()
    assert ctl.blocked == 1 and ctl.in_flight == 0


def _window_rows(win, steps, which):
    """Feed ``steps`` (loss, top1) pairs through the port's or the JAX
    window; (rows, counters) from the host read."""
    if which == "port":
        ring = win.init_ring("cpu")
        for loss, top1 in steps:
            win.update(ring, {"loss": torch.tensor(loss),
                              "top1": torch.tensor(top1)})
        host = win.fetch(ring)
        return win, ring, host
    ring = win.init_ring()
    for loss, top1 in steps:
        ring = win.update(ring, {"loss": np.float32(loss),
                                 "top1": np.float32(top1)})
    return win, ring, jax.device_get(ring)


@pytest.mark.parametrize("steps", [
    [(1.0, 0.5), (float("nan"), 0.25)],
    [(float("nan"), 0.0), (float("inf"), 1.0), (2.0, 0.75)],
    [(0.5, 0.5)] * 4,
])
def test_metric_window_roundtrip_and_streak_like_jax(steps):
    _, pring, phost = _window_rows(MetricWindow(["loss", "top1"], 4), steps,
                                   "port")
    jwin, jring, jhost = _window_rows(
        jax_pipeline.MetricWindow(["loss", "top1"], 4), steps, "jax")
    prow = MetricWindow(["loss", "top1"], 4).read(phost)
    jrow = jwin.read(jhost)
    assert [list(r) for r in prow] == [list(r) for r in jrow]
    for a, b in zip(prow, jrow):
        for k in a:
            assert np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes()
    for k in ("pos", "streak", "max_streak"):
        assert phost[k] == int(jhost[k]), k
    # Reset rewinds the buffer but carries the in-flight streak.
    win = MetricWindow(["loss", "top1"], 4)
    win.reset(pring)
    jring = jwin.reset(jring)
    for k in ("pos", "streak", "max_streak"):
        assert int(pring[k]) == int(jax.device_get(jring[k])), k
    with pytest.raises(ValueError):
        MetricWindow(["top1"], 4)
    with pytest.raises(ValueError):
        MetricWindow(["loss"], 0)


def test_metric_window_overflow_clamps_and_is_reported():
    win = MetricWindow(["loss"], 2)
    ring = win.init_ring("cpu")
    for v in (1.0, 2.0, 3.0):
        win.update(ring, {"loss": torch.tensor(v)})
    host = win.fetch(ring)
    assert host["pos"] == 3
    assert host["buf"][:, 0].tolist() == [1.0, 3.0]  # clamped, as JAX
    with pytest.raises(ValueError, match="overflowed"):
        win.read(host)


def test_prefetcher_stages_ahead_and_closes():
    placed = []

    def place(x, lab):
        placed.append(threading.get_ident())
        return tdevice.upload(x, torch.device("cpu")), lab

    def gen():
        for i in range(100):
            yield np.full((2, 4), i, np.float32), np.arange(2)

    with DevicePrefetcher(gen(), place, depth=2) as pf:
        for i in range(5):
            x, _ = pf.get()
            assert float(x[0, 0]) == i
        assert pf.consumed == 5 and pf.staged >= 5
    assert set(placed) != {threading.get_ident()}
    assert not pf._thread.is_alive()
    with pytest.raises(RuntimeError):
        pf.get()
    with pytest.raises(ValueError):
        DevicePrefetcher(gen(), place, depth=0)


def test_prefetcher_end_of_data_and_failure_like_jax():
    place = lambda x, lab: (x, lab)  # noqa: E731
    for cls, fps in ((DevicePrefetcher, failpoints),
                     (jax_pipeline.DevicePrefetcher, jax_failpoints)):
        pf = cls(iter([(1, 2)]), place, depth=2)
        assert pf.get() == (1, 2)
        with pytest.raises(StopIteration):
            pf.get()
        pf.close()

        def gen():
            yield np.zeros(1), np.zeros(1)
            yield np.zeros(1), np.zeros(1)
            yield np.zeros(1), np.zeros(1)

        fps.arm("pipeline.stage", times=1, delay=1)
        pf = cls(gen(), place, depth=2)
        pf.get()
        err = PrefetchStageError if cls is DevicePrefetcher \
            else jax_pipeline.PrefetchStageError
        with pytest.raises(err) as ei:
            pf.get()
        assert ei.value.batch_index == 1
        pf.close()
        assert not pf._thread.is_alive()
        fps.reset()


def test_pipeline_exports_match_jax():
    assert pipeline.__all__ == jax_pipeline.__all__


def test_device_lr_product_is_the_host_product_bit_for_bit():
    """The captured step forms ``lr * lr_mult`` on the device from an lr
    written before each replay; it must round as the host's fp32
    product does, for every schedule value and multiplier."""
    rng = np.random.default_rng(0)
    lrs = np.float32(10.0) ** rng.uniform(-9, 1, 2000).astype(np.float32)
    mults = [1.0, 2.0, 0.1, 10.0, 0.0, 1e-3, 3.7] + list(
        rng.uniform(0, 20, 50))
    for lr in lrs:
        for lmul in mults:
            host = scaled_lr(float(lr), lmul)
            dev = scaled_lr(torch.tensor(float(lr), dtype=torch.float32),
                            lmul)
            assert dev.dtype == torch.float32 and dev.dim() == 0
            assert np.float32(host).tobytes() == dev.numpy().tobytes()
            assert host == float(np.float32(lr) * np.float32(lmul))
    g = torch.randn(1000)
    for lr in lrs[:50]:
        assert torch.equal(g * scaled_lr(float(lr), 2.0),
                           g * scaled_lr(torch.tensor(float(lr)), 2.0))


# -- parity ------------------------------------------------------------------


def _train(pipeline_on, n=12, test=True, **kw):
    solver, batches = _make_solver(pipeline_on, **kw)
    logs, recs = [], []
    last = solver.train(
        batches, num_iters=n, log_fn=logs.append, record_fn=recs.append,
        test_batches=(synthetic_identity_batches(8, 8, 2, (16,), noise=0.6,
                                                 seed=1) if test else None))
    return solver, logs, recs, last


def test_pipelined_parity_with_the_sync_loop():
    """Display and TEST lines, records and the returned metrics byte for
    byte; parameters, momentum and iteration bit for bit."""
    kw = dict(test_interval=6, test_iter=1, test_initialization=False)
    s_sync, logs_s, recs_s, last_s = _train(False, **kw)
    s_pipe, logs_p, recs_p, last_p = _train(True, **kw)
    assert logs_s == logs_p and len(logs_s) == 4
    assert json.dumps(recs_s) == json.dumps(recs_p)
    assert json.dumps(last_s) == json.dumps(last_p)
    assert _params_equal(s_sync, s_pipe)
    assert s_pipe.pipeline_stats["eager_steps"] == 12
    assert s_pipe.pipeline_stats["consumed"] == 12


def _jax_and_port(pipeline_on):
    jcfg, _ = jax_load_solver(TINY_SOLVER)
    tcfg, _ = load_solver(TINY_SOLVER)
    kw = dict(display=4, snapshot=0, test_interval=0, pipeline=pipeline_on)
    jcfg = dataclasses.replace(jcfg, **kw)
    tcfg = dataclasses.replace(tcfg, **kw)
    jnet, tnet = jax_load_net(TINY_NET), load_net(TINY_NET)
    js = JaxSolver(jax_get_model("mlp"), jnet.loss.loss, jcfg,
                   input_shape=(8, 8, 3))
    js.init()
    ts = Solver(get_model("mlp", device="cpu", input_shape=(8, 8, 3)),
                tnet.loss.loss, tcfg)
    ts.load_params(jax.tree_util.tree_map(np.asarray, js.state["params"]))
    return js, ts


def test_pipelined_trajectory_matches_the_jax_pipelined_solver():
    """The JAX and the port pipelined Solvers from the same initial
    parameters on the same batches: the same display records (keys, in
    order; values within 1e-5)."""
    js, ts = _jax_and_port(True)
    recs = {}
    for name, s in (("jax", js), ("port", ts)):
        recs[name] = []
        s.train(synthetic_identity_batches(32, 8, 2, (8, 8, 3), noise=2.0,
                                           seed=3), num_iters=12,
                log_fn=lambda m: None, record_fn=recs[name].append)
    assert [list(r) for r in recs["port"]] == [list(r) for r in recs["jax"]]
    assert [r["iteration"] for r in recs["port"]] == [4, 8, 12]
    for a, b in zip(recs["port"], recs["jax"]):
        for k, v in a.items():
            if isinstance(v, float):
                np.testing.assert_allclose(v, b[k], rtol=TOL, atol=TOL,
                                           err_msg=k)


def _mask(line):
    return re.sub(r"-?\d+(\.\d+)?(e[-+]?\d+)?", "#", line)


def test_cli_pipeline_stream_matches_sync_and_the_jax_cli(tmp_path):
    """``train --pipeline``: the port's stream equals its synchronous
    stream byte for byte; against the JAX CLI's ``--pipeline`` stream
    (which shards over the 8 test devices) the same events, iterations,
    keys and masked display lines."""
    streams, outs = {}, {}
    for name, main, extra in (
            ("jax", jax_cli.main, ["--pipeline"]),
            ("port", cli.main, ["--device", "cpu", "--pipeline"]),
            ("port_sync", cli.main, ["--device", "cpu"])):
        path = tmp_path / f"{name}.jsonl"
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = main(["train", "--solver", TINY_SOLVER, "--synthetic",
                       "--log-json", str(path), *extra])
        assert rc == 0
        streams[name] = path.read_text()
        outs[name] = buf.getvalue()
    assert streams["port"] == streams["port_sync"]
    assert outs["port"] == outs["port_sync"]
    recs = {k: [json.loads(ln) for ln in v.splitlines()]
            for k, v in streams.items()}
    key = lambda rs: [(r["event"], r["iteration"], list(r))  # noqa: E731
                      for r in rs]
    assert key(recs["port"]) == key(recs["jax"])
    display = lambda out: [_mask(ln) for ln in out.splitlines()  # noqa: E731
                           if ln.startswith("iter ")]
    assert display(outs["port"]) == display(outs["jax"])


# -- the sync-free contract ------------------------------------------------


def test_pipelined_no_midwindow_host_syncs():
    solver, batches = _make_solver(True)
    mon = HostSyncMonitor(strict=True)
    solver.sync_monitor = mon
    solver.train(batches, num_iters=20, log_fn=lambda s: None)
    c = mon.counts()
    # Every batch upload happened on the staging thread...
    assert c["put_guarded"] == 0 and c["put"] >= 20
    # ...and the step-loop thread read back once per window
    # (display=5 -> boundaries at 5/10/15/20).
    assert c["get_guarded"] == 4
    assert mon.violations() == []


def test_sync_monitor_records_and_enforces():
    cpu = torch.device("cpu")
    with HostSyncMonitor(strict=False) as mon:
        tdevice.upload(np.zeros(2, np.float32), cpu)
        with mon.allowed():
            tdevice.fetch(torch.zeros(2))
        t = threading.Thread(target=tdevice.fetch, args=(torch.zeros(1),))
        t.start()
        t.join()
    assert mon.counts() == {"put": 1, "get": 2, "put_guarded": 1,
                            "get_guarded": 1}
    assert [v["op"] for v in mon.violations()] == ["put"]
    with HostSyncMonitor(strict=True) as mon:
        with pytest.raises(SyncGuardViolation, match="device.fetch"):
            tdevice.fetch(torch.zeros(1))
        with mon.dispatch_guard(cpu):  # no card: a no-op
            pass
    # The patch is undone on exit.
    assert tdevice.upload.__module__ == "npairloss_tpu_torch.device"
    assert tdevice.fetch.__module__ == "npairloss_tpu_torch.device"


@pytest.mark.parametrize("value, strict", [("", None), ("0", None),
                                           ("off", None), ("count", False),
                                           ("1", False), ("strict", True),
                                           ("STRICT", True)])
def test_monitor_from_env_like_jax(monkeypatch, value, strict):
    monkeypatch.setenv(pipeline.syncguard.ENV_VAR, value)
    mine = pipeline.monitor_from_env()
    theirs = jax_pipeline.monitor_from_env()
    assert pipeline.syncguard.ENV_VAR == jax_pipeline.syncguard.ENV_VAR
    if strict is None:
        assert mine is None and theirs is None
    else:
        assert mine.strict is strict is theirs.strict


@pytest.mark.parametrize("display, test_interval, snapshot, window, test", [
    (100, 2000, 30, 0, False), (0, 0, 0, 0, False), (0, 0, 0, 7, False),
    (5, 0, 0, 7, False), (4, 6, 0, 0, True), (4, 6, 0, 0, False),
    (0, 3, 9, 0, True), (10, 10, 10, 3, True), (0, 0, 12, 20, False),
    (1, 0, 0, 0, False),
])
def test_pipeline_window_capacity_matches_jax(display, test_interval,
                                              snapshot, window, test):
    kw = dict(display=display, test_interval=test_interval,
              snapshot=snapshot, pipeline_window=window)
    solver, _ = _make_solver(True, **kw)
    js = JaxSolver(jax_get_model("mlp", hidden=(32,), embedding_dim=16),
                   NPairLossConfig(), JaxSolverConfig(**kw),
                   input_shape=(16,))
    assert solver._pipeline_window_capacity(test) == \
        js._pipeline_window_capacity(test)


def test_pipelined_exhaustion_flushes_window_tail():
    """A stream that ends mid-window raises StopIteration in both loops;
    the pipelined loop flushes the unread tail into the loss window, so
    it holds what the synchronous loop's holds."""
    def seven():
        g = synthetic_identity_batches(8, 8, 2, (16,), noise=0.6)
        for _ in range(7):
            yield next(g)

    windows = {}
    for pipe in (False, True):
        solver, _ = _make_solver(pipe, display=0, pipeline_window=10)
        with pytest.raises(StopIteration):
            solver.train(seven(), num_iters=50, log_fn=lambda s: None)
        assert solver.iteration == 7
        windows[pipe] = [float(v) for v in solver._loss_window]
        if pipe:
            params_pipe = solver
        else:
            params_sync = solver
    assert windows[True] == windows[False] and len(windows[True]) == 7
    assert _params_equal(params_sync, params_pipe)


def test_pipe_key_holds_lr_out_and_update_constants_in():
    """An lr change (a rollback's lr_scale) keeps the captured step; a
    change of what the step holds as a constant drops it."""
    solver, batches = _make_solver(True, display=0, pipeline_window=2)
    solver.train(batches, num_iters=2, log_fn=lambda s: None)
    step = solver._pipe
    key = step.key
    solver.cfg = dataclasses.replace(solver.cfg, base_lr=0.25)
    solver.train(batches, num_iters=4, log_fn=lambda s: None)
    assert solver._pipe is step and step.key == key
    assert solver.rate_fn(0) == 0.25
    solver.cfg = dataclasses.replace(solver.cfg, momentum=0.5)
    solver.train(batches, num_iters=6, log_fn=lambda s: None)
    assert solver._pipe is not step


def test_restore_copies_in_place(tmp_path):
    """A restore (a rollback) writes every parameter, buffer and momentum
    tensor in place, so a captured step's addresses stay valid."""
    solver, batches = _make_solver(True, display=0, snapshot=2,
                                   snapshot_prefix=str(tmp_path / "a_"))
    solver.train(batches, num_iters=4, log_fn=lambda s: None)
    ptrs = {k: v.data_ptr() for k, v in solver.state_dict().items()
            if k != "iteration"}
    before = {k: v.clone() for k, v in solver.state_dict().items()}
    assert solver.restore_auto(max_step=2) is not None
    after = solver.state_dict()
    assert solver.iteration == 2
    assert {k: v.data_ptr() for k, v in after.items()
            if k != "iteration"} == ptrs
    assert any(not torch.equal(before[k], after[k]) for k in ptrs)


# -- resilience interop ----------------------------------------------------


def test_pipelined_guard_rollback_windowed(tmp_path):
    """step.nan_loss mid-window: the guard trips at the boundary read,
    rolls back to a pre-streak snapshot, and training continues."""
    solver, batches = _make_solver(True, display=0, snapshot=4,
                                   pipeline_window=4,
                                   snapshot_prefix=str(tmp_path / "g_"))
    solver.divergence = DivergenceConfig(patience=2, action="rollback",
                                         max_rollbacks=1)
    logs = []
    solver.train(batches, num_iters=6, log_fn=logs.append)
    failpoints.arm("step.nan_loss", times=2)
    solver.train(batches, num_iters=10, log_fn=logs.append)
    rolled = [s for s in logs if "rolled back to iteration 4" in s]
    assert rolled, logs
    assert "2 consecutive non-finite losses at iteration 8" in rolled[0]
    assert solver.iteration == 10


def test_pipelined_guard_streak_resets_after_poisoned_window(monkeypatch):
    """A sub-patience poison streak at a window TAIL is RESET by a later
    all-finite window: a lone NaN windows later must not complete a
    phantom streak."""
    calls = {"n": 0}
    real = failpoints.should_fire

    def fake(name):
        if name == "step.nan_loss":
            calls["n"] += 1
            return calls["n"] in (3, 4, 9)
        return real(name)

    monkeypatch.setattr(failpoints, "should_fire", fake)
    solver, batches = _make_solver(True, display=0, snapshot=0,
                                   pipeline_window=4)
    solver.divergence = DivergenceConfig(patience=3, action="halt")
    solver.train(batches, num_iters=12, log_fn=lambda s: None)
    assert solver.iteration == 12


def test_pipelined_crash_resume_replays_batch_index(tmp_path):
    """A pipeline.stage crash mid-window surfaces with its batch index,
    drains cleanly, and a resume from the last snapshot on the stream
    from that index ends on the uninterrupted synchronous run's
    parameters bit for bit."""
    stream = list(zip(range(32), synthetic_identity_batches(
        8, 8, 2, (16,), noise=0.6)))

    def indexed(start=0):
        for _, b in stream[start:]:
            yield b

    cfg = dict(display=0, snapshot=4, pipeline_window=4,
               snapshot_prefix=str(tmp_path / "c_"))
    ref, _ = _make_solver(False, **{**cfg,
                                    "snapshot_prefix": str(tmp_path / "r_")})
    ref.train(indexed(), num_iters=8, log_fn=lambda s: None)

    class ArmAtBatch6:
        def __init__(self):
            self.it = indexed()
            self.n = 0

        def __iter__(self):
            return self

        def __next__(self):
            if self.n == 6:
                failpoints.arm("pipeline.stage", times=1)
            self.n += 1
            return next(self.it)

    crashed, _ = _make_solver(True, **cfg)
    with pytest.raises(PrefetchStageError) as ei:
        crashed.train(ArmAtBatch6(), num_iters=16, log_fn=lambda s: None)
    assert ei.value.batch_index == 6
    assert not [t for t in threading.enumerate()
                if t.name == "npairloss-pipeline-stage" and t.is_alive()]
    resumed, _ = _make_solver(True, **cfg)
    assert resumed.restore_auto() and resumed.iteration == 4
    resumed.train(indexed(start=resumed.iteration), num_iters=8,
                  log_fn=lambda s: None)
    assert _params_equal(ref, resumed)


def test_pipelined_preempt_flushes_partial_window(tmp_path):
    solver, batches = _make_solver(True, display=0, snapshot=0,
                                   pipeline_window=10,
                                   snapshot_prefix=str(tmp_path / "p_"))
    solver.preempt = PreemptionSignal()
    solver.preempt.request()
    with pytest.raises(TrainingPreempted) as ei:
        solver.train(batches, num_iters=50, log_fn=lambda s: None)
    assert ei.value.step == 1
    assert os.path.isdir(ei.value.snapshot_path)
    assert len(solver._loss_window) == 1


def test_preempt_mid_window_matches_the_sync_loop(tmp_path):
    """A preemption requested before step 6 of a 10-step window: both
    loops stop at 6 with the same records and loss window."""
    out = {}
    for pipe in (False, True):
        solver, batches = _make_solver(
            pipe, display=0, snapshot=4, pipeline_window=10,
            snapshot_prefix=str(tmp_path / f"{pipe}_"))
        solver.preempt = PreemptionSignal()
        recs = []
        # Request the stop from the training thread just before step 6.
        step_fn = solver._pipelined_step if pipe else solver.step

        def stepping(*a, _f=step_fn, _s=solver, **kw):
            if _s.iteration == 5:
                _s.preempt.request()
            return _f(*a, **kw)

        if pipe:
            solver._pipelined_step = stepping
        else:
            solver.step = stepping
        with pytest.raises(TrainingPreempted) as ei:
            solver.train(batches, num_iters=20, log_fn=lambda s: None,
                         record_fn=recs.append)
        out[pipe] = (ei.value.step, [r["event"] for r in recs],
                     [float(v) for v in solver._loss_window])
    assert out[True] == out[False]
    assert out[True][0] == 6 and out[True][1] == ["snapshot", "preempt"]


def test_data_worker_failpoint_respawns_the_loader_worker():
    """The port's loader fires ``data.worker`` where the JAX loader does:
    one crash respawns the worker, a permanent one surfaces as
    ``PrefetchWorkerError`` after the respawn budget."""
    from npairloss_tpu_torch.config.schema import DataLayerConfig
    from npairloss_tpu_torch.data import ArrayDataset
    from npairloss_tpu_torch.data.loader import (
        MultibatchLoader,
        PrefetchWorkerError,
    )

    ds = ArrayDataset(np.zeros((8, 4, 4, 3), np.uint8), np.arange(8) // 2)
    cfg = DataLayerConfig(identity_num_per_batch=2, img_num_per_identity=2)
    failpoints.arm("data.worker", times=1)
    with MultibatchLoader(ds, cfg, device="cpu", max_worker_restarts=2) \
            as loader:
        x, lab = next(loader)
        assert tuple(x.shape) == (4, 4, 4, 3)
    failpoints.arm("data.worker", times=None)
    with MultibatchLoader(ds, cfg, device="cpu", max_worker_restarts=1) \
            as loader:
        with pytest.raises(PrefetchWorkerError) as ei:
            next(loader)
        assert ei.value.respawns == 1


def test_capture_failure_names_the_first_error_and_its_call_site():
    """A failed capture raises the invalidated capture's own error last;
    the message names the op that broke it, and where it was called."""
    from npairloss_tpu_torch.train.solver import _first_failure

    def step():
        raise RuntimeError("operation not permitted when stream is "
                           "capturing\nmore")

    try:
        try:
            step()
        except RuntimeError:
            raise ValueError("operation failed due to a previous error")
    except ValueError as e:
        msg = _first_failure(e)
    assert msg.startswith("RuntimeError: operation not permitted when "
                          "stream is capturing at test_torch_pipeline.py:")
    assert "raise RuntimeError" in msg and "more" not in msg


# -- the compile cache -------------------------------------------------------


def test_compile_cache_points_both_builds_at_the_dir(tmp_path, caplog):
    from npairloss_tpu_torch.data import native
    from npairloss_tpu_torch.ops import _build

    defaults = (_build.BUILD_DIR, native.BUILD_DIR)
    try:
        got = pipeline.enable_compile_cache(str(tmp_path / "cc"))
        assert got == str(tmp_path / "cc")
        assert pipeline.compile_cache_dir() == got
        assert _build.BUILD_DIR == tmp_path / "cc" / "kernels"
        assert native.BUILD_DIR == tmp_path / "cc" / "native"
        assert pipeline.enable_compile_cache(str(tmp_path / "cc")) == got
    finally:
        pipeline.disable_compile_cache()
    assert (_build.BUILD_DIR, native.BUILD_DIR) == defaults
    assert pipeline.compile_cache_dir() is None
    # An unusable directory is logged, never fatal.
    blocker = tmp_path / "file"
    blocker.write_text("x")
    assert pipeline.enable_compile_cache(str(blocker / "cc")) is None
    assert "compile cache unavailable" in caplog.text
    assert (_build.BUILD_DIR, native.BUILD_DIR) == defaults


def test_train_compile_cache_flag_sets_the_build_dirs(tmp_path):
    from npairloss_tpu_torch.ops import _build

    try:
        with redirect_stdout(io.StringIO()):
            rc = cli.main(["train", "--solver", TINY_SOLVER, "--synthetic",
                           "--device", "cpu", "--max_iter", "2",
                           "--compile-cache", str(tmp_path / "cc")])
        assert rc == 0
        assert _build.BUILD_DIR == tmp_path / "cc" / "kernels"
    finally:
        pipeline.disable_compile_cache()


@pytest.mark.parametrize("already_ended", [False, True])
def test_a_failed_capture_hands_its_pool_back(monkeypatch, already_ended):
    """A capture that fails (a host read inside it) must end the caching
    allocator's allocation to the graph's pool and release the pool:
    PyTorch's own ``capture_end`` raises before it ends it, and until it
    is ended ``empty_cache`` returns no cached block.  Where the end
    raises (``capture_end`` ended it: the body raised inside a capture
    that stayed valid, ``already_ended``), the graph owns the pool and
    releases it when freed, so a release here would be a second one.
    The card's side is ``chip_smoke.py``'s refusal drill; here the CUDA
    calls are fakes that record what ``Solver._capture`` asks of them."""
    import contextlib
    import types

    from npairloss_tpu_torch.train.solver import PipelineCaptureError

    calls = []
    handle = (0, 7)
    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: handle)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: object())

    @contextlib.contextmanager
    def graph(g, pool=None, capture_error_mode=None):
        calls.append(("capture", pool, capture_error_mode))
        yield

    def end(idx, pool):
        calls.append(("end", idx, pool))
        if already_ended:
            raise RuntimeError("endAllocatePool: not currently recording")

    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch._C, "_cuda_endAllocateToPool", end,
                        raising=False)
    monkeypatch.setattr(torch._C, "_cuda_releasePool",
                        lambda idx, pool: calls.append(("release", idx, pool)),
                        raising=False)
    solver, _ = _make_solver(True)
    solver.device = torch.device("cuda", 0)

    def body(*a):
        if already_ended:
            raise ValueError("a shape the step does not take")
        raise RuntimeError("operation not permitted when stream is capturing")

    solver._pipelined_body = body
    p = types.SimpleNamespace(x=torch.zeros(2, 16), lab=torch.zeros(2))
    with pytest.raises(PipelineCaptureError,
                       match="does not take" if already_ended
                       else "not permitted"):
        solver._capture(p, 4)
    want = [("capture", handle, "thread_local"), ("end", 0, handle)]
    if not already_ended:
        want.append(("release", 0, handle))
    assert calls == want
    assert solver.pipeline_stats["captures"] == 0
