"""Resume in the port (npairloss_tpu_torch/train/solver.py, cli.py
``train``) against the JAX package's Solver and CLI.

  * the iteration cadence of ``tests/test_solver.py``'s
    ``test_iteration_resume_cadence`` on both packages from the JAX
    solver's own initial parameters: snapshots at 3 and 6 but not 7,
    iteration 3 after the restore, the final lr 0.5 * 0.5**3, and the
    port's parameters within 1e-5 of JAX's (the tolerance of
    ``test_ten_step_trajectory_matches_jax_solver``: the same fp32
    update, matmuls summed in another order);
  * a resumed port run equals the uninterrupted one bit for bit —
    parameters, buffers (a BatchNorm's running statistics), momentum —
    on the dense and the blockwise engine;
  * the preemption drill of ``tests/test_resilience.py``: a requested
    stop (``PreemptionSignal.request``, or a real SIGTERM) commits an
    emergency snapshot at k, and the relaunch resumes at k + 1;
  * ``train --resume auto`` first starts fresh, then restores, with one
    injected ``snapshot.save.io`` retried and ``--snapshot-keep``, on
    the port's and the JAX CLI: the same snapshot steps and the same
    ``--log-json`` event streams (events, iterations, keys);
  * ``train --weights w.npz``: iteration 0, zero momentum, the file's
    parameters.
"""

import dataclasses
import io
import json
import os
import signal
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from npairloss_tpu import cli as jax_cli
from npairloss_tpu.data import synthetic_identity_batches
from npairloss_tpu.models import get_model as jax_get_model
from npairloss_tpu.ops.npair_loss import MiningMethod as JaxMining
from npairloss_tpu.ops.npair_loss import NPairLossConfig as JaxLossConfig
from npairloss_tpu.resilience import failpoints as jax_failpoints
from npairloss_tpu.resilience import snapshot as jax_snapshot
from npairloss_tpu.train import Solver as JaxSolver
from npairloss_tpu.train import SolverConfig as JaxSolverConfig
from npairloss_tpu_torch import cli
from npairloss_tpu_torch.models import convert, get_model
from npairloss_tpu_torch.models.mlp import MLPEmbedding
from npairloss_tpu_torch.ops.npair_loss import MiningMethod, NPairLossConfig
from npairloss_tpu_torch.resilience import (
    PreemptionSignal,
    RetryPolicy,
    TrainingPreempted,
    failpoints,
    snapshot,
)
from npairloss_tpu_torch.train.solver import Solver, SolverConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


@pytest.fixture(autouse=True)
def _clean_failpoints():
    failpoints.reset()
    jax_failpoints.reset()
    yield
    failpoints.reset()
    jax_failpoints.reset()


# -- the cadence, against the JAX Solver --------------------------------------


def _cadence_cfg(tmp_path, cls):
    return cls(base_lr=0.5, lr_policy="step", stepsize=2, gamma=0.5,
               momentum=0.9, weight_decay=0.0, display=0, test_interval=0,
               average_loss=10, snapshot=3,
               snapshot_prefix=str(tmp_path / "snap_"))


def _jax_solver(tmp_path, params=None):
    js = JaxSolver(
        jax_get_model("mlp", hidden=(64,), embedding_dim=32),
        JaxLossConfig(margin_diff=-0.05, an_mining_method=JaxMining.HARD,
                      ap_mining_method=JaxMining.RAND),
        _cadence_cfg(tmp_path, JaxSolverConfig), input_shape=(16,))
    js.init()
    if params is not None:
        js.load_params(params)
    return js


def _port_solver(tmp_path, params, seed=5):
    model = get_model("mlp", device="cpu", input_shape=(16,), hidden=(64,),
                      embedding_dim=32, seed=seed)
    ts = Solver(model,
                NPairLossConfig(margin_diff=-0.05,
                                an_mining_method=MiningMethod.HARD,
                                ap_mining_method=MiningMethod.RAND),
                _cadence_cfg(tmp_path, SolverConfig))
    if params is not None:
        ts.load_params(params)
    return ts


def _batches():
    return synthetic_identity_batches(16, 16, 2, (16,), noise=0.6)


def test_iteration_resume_cadence(tmp_path):
    """Caffe solverstate semantics on both packages: a solver restored
    from the iter-3 snapshot resumes at 4 with the snapshot cadence and
    the lr schedule aligned."""
    js = _jax_solver(tmp_path / "jax")
    p0 = jax.tree_util.tree_map(np.asarray, js.state["params"])
    ts = _port_solver(tmp_path / "port", p0)
    for solver in (js, ts):
        solver.train(_batches(), num_iters=4, log_fn=lambda s: None)
        assert solver.iteration == 4
        assert os.path.exists(solver.snapshot_path(3))

    # Fresh solvers restore iter 3: iteration comes back from the
    # snapshot, not from the path.
    js2 = _jax_solver(tmp_path / "jax")
    ts2 = _port_solver(tmp_path / "port", None, seed=9)
    finals = []
    for solver in (js2, ts2):
        solver.restore_snapshot(solver.snapshot_path(3))
        assert solver.iteration == 3
        logs = []
        finals.append(solver.train(_batches(), num_iters=7,
                                   log_fn=logs.append))
        assert any("resuming from iteration 3" in ln for ln in logs)
        assert solver.iteration == 7
        assert os.path.exists(solver.snapshot_path(6))
        assert not os.path.exists(solver.snapshot_path(7))
        assert float(finals[-1]["lr"]) == pytest.approx(0.5 * 0.5 ** 3)
    port_steps = snapshot.list_snapshots(ts2.cfg.snapshot_prefix)
    jax_steps = jax_snapshot.list_snapshots(js2.cfg.snapshot_prefix)
    assert [s for s, _ in port_steps] == [s for s, _ in jax_steps] == [3, 6]
    want = convert.from_jax_params(
        jax.tree_util.tree_map(np.asarray, js2.state["params"]))
    for name, p in ts2.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=TOL, atol=TOL, err_msg=name)
    for k in finals[0]:
        np.testing.assert_allclose(float(finals[1][k]), float(finals[0][k]),
                                   rtol=TOL, atol=TOL, err_msg=k)


def test_restored_at_target_has_nothing_to_do(tmp_path):
    ts = _port_solver(tmp_path, None)
    ts.train(_batches(), num_iters=3, log_fn=lambda s: None)
    ts2 = _port_solver(tmp_path, None, seed=9)
    assert ts2.restore_auto() == ts.snapshot_path(3)
    logs = []
    assert ts2.train(_batches(), num_iters=3, log_fn=logs.append) == {}
    assert logs == ["resuming from iteration 3",
                    "nothing to do: restored iteration 3 >= target 3 "
                    "(num_iters is the TOTAL max_iter target, not an "
                    "increment)"]


# -- resumed = uninterrupted, bit for bit -------------------------------------


class _BNMLP(torch.nn.Module):
    """The MLP behind a BatchNorm: running statistics are buffers."""

    def __init__(self, seed):
        super().__init__()
        self.bn = torch.nn.BatchNorm1d(16)
        self.mlp = MLPEmbedding(16, hidden=(32,), embedding_dim=16)
        self.mlp.reset_parameters(seed)

    def forward(self, x):
        return self.mlp(self.bn(x.reshape(x.shape[0], -1)))


def _resume_solver(tmp_path, variant, seed):
    cfg = SolverConfig(base_lr=0.2, lr_policy="step", stepsize=2, gamma=0.5,
                       momentum=0.9, weight_decay=0.001, display=0,
                       test_interval=0, snapshot=3,
                       snapshot_prefix=str(tmp_path / "m_"))
    if variant == "dense_bn":
        model = _BNMLP(seed)
    else:
        model = get_model("mlp", device="cpu", input_shape=(16,),
                          hidden=(32,), embedding_dim=16, seed=seed)
    loss = NPairLossConfig(margin_diff=-0.05,
                           ap_mining_method=MiningMethod.RELATIVE_HARD,
                           identsn=-0.5)
    return Solver(model, loss, cfg, engine="blockwise" if variant ==
                  "blockwise" else "dense", param_mults=((1.0, 1.0),
                                                         (2.0, 0.0)))


@pytest.mark.parametrize("variant", ["dense", "blockwise", "dense_bn"])
def test_resumed_run_equals_uninterrupted_bit_for_bit(tmp_path, variant):
    gen = synthetic_identity_batches(16, 8, 2, (16,), noise=0.8, seed=4)
    batches = [next(gen) for _ in range(6)]
    a = _resume_solver(tmp_path, variant, seed=0)
    a.train(iter(batches), num_iters=6, log_fn=lambda s: None)
    b = _resume_solver(tmp_path, variant, seed=1)
    b.restore_snapshot(a.snapshot_path(3))
    assert b.iteration == 3
    b.train(iter(batches[3:]), num_iters=6, log_fn=lambda s: None)
    sa, sb = a.state_dict(), b.state_dict()
    assert set(sa) == set(sb)
    differ = [k for k in sa if not torch.equal(sa[k], sb[k])]
    assert differ == []
    if variant == "dense_bn":
        assert "model/bn.running_mean" in sa
        assert int(sa["model/bn.num_batches_tracked"]) == 6
    assert any(bool((v != 0).any()) for k, v in sa.items()
               if k.startswith("momentum/"))


# -- preemption ---------------------------------------------------------------


class _StopAt:
    """Batches that ask for a stop while producing batch ``fire_at``:
    by ``PreemptionSignal.request`` or by a real SIGTERM to this
    process (its handler runs on the main thread before the poll)."""

    def __init__(self, batches, fire_at, sig, how):
        self.batches, self.fire_at, self.sig, self.how = (
            batches, fire_at, sig, how)
        self.count = 0

    def __iter__(self):
        return self

    def __next__(self):
        self.count += 1
        if self.count == self.fire_at:
            if self.how == "request":
                self.sig.request(signal.SIGTERM)
            else:
                os.kill(os.getpid(), signal.SIGTERM)
        return next(self.batches)


def _preempt_solver(tmp_path):
    cfg = SolverConfig(base_lr=0.5, lr_policy="fixed", momentum=0.9,
                       weight_decay=0.0, display=0, test_interval=0,
                       average_loss=10, snapshot=0,
                       snapshot_prefix=str(tmp_path / "snap" / "m_"))
    model = get_model("mlp", device="cpu", input_shape=(16,), hidden=(32,),
                      embedding_dim=16)
    return Solver(model, NPairLossConfig(), cfg,
                  snapshot_retry=RetryPolicy(base_delay=0.001, jitter=0.0))


def _drill_batches():
    return synthetic_identity_batches(8, 8, 2, (16,), noise=0.5)


@pytest.mark.parametrize("how", ["request", "sigterm"])
def test_preemption_emergency_snapshot_then_resume_at_k_plus_1(tmp_path,
                                                               how):
    ref = _preempt_solver(tmp_path / "ref")
    ref_final = ref.train(_drill_batches(), num_iters=6,
                          log_fn=lambda s: None)

    solver = _preempt_solver(tmp_path)
    records = []
    before = signal.getsignal(signal.SIGTERM)
    with PreemptionSignal() as sig:
        solver.preempt = sig
        with pytest.raises(TrainingPreempted) as ei:
            solver.train(_StopAt(_drill_batches(), 4, sig, how),
                         num_iters=6, log_fn=lambda s: None,
                         record_fn=records.append)
    k = ei.value.step
    assert k == 4 and ei.value.signum == signal.SIGTERM
    assert records == [{"event": "preempt", "iteration": 4,
                        "snapshot": ei.value.snapshot_path}]
    assert snapshot.validate_snapshot(ei.value.snapshot_path)["step"] == k
    assert jax_snapshot.validate_snapshot(ei.value.snapshot_path)["step"] \
        == k

    solver2 = _preempt_solver(tmp_path)
    assert solver2.restore_auto() == ei.value.snapshot_path
    assert solver2.iteration == k
    logs = []
    final = solver2.train(_drill_batches(), num_iters=6, log_fn=logs.append)
    assert any("resuming from iteration 4" in ln for ln in logs)
    assert solver2.iteration == 6
    assert sorted(final) == sorted(ref_final)
    assert signal.getsignal(signal.SIGTERM) == before


# -- the CLI ------------------------------------------------------------------


def _write_solver(tmp_path, name, max_iter, snapshot):
    path = tmp_path / f"{name}_solver.prototxt"
    path.write_text(
        'net: "examples/tiny_net.prototxt"\nbase_lr: 0.05\n'
        'lr_policy: "fixed"\nmomentum: 0.9\n'
        f"max_iter: {max_iter}\ndisplay: 2\naverage_loss: 2\n"
        "test_interval: 2\ntest_iter: 1\ntest_initialization: false\n"
        f"snapshot: {snapshot}\n"
        f'snapshot_prefix: "{tmp_path}/{name}/m_"\n')
    return str(path)


def _run(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue().splitlines()


def test_cli_resume_auto_fresh_then_restore_matches_jax(tmp_path,
                                                        monkeypatch):
    """The supervisor contract on both CLIs: the same command line
    starts fresh and then restores, with one transient save fault
    (armed through NPAIRLOSS_FAILPOINTS) retried along the way."""
    monkeypatch.chdir(REPO)
    monkeypatch.setenv("NPAIRLOSS_FAILPOINTS", "snapshot.save.io:1")
    runs = {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        solver = _write_solver(tmp_path, name, max_iter=4, snapshot=2)
        events = tmp_path / f"{name}.jsonl"
        base = ["train", "--solver", solver, "--model", "mlp", "--synthetic",
                "--resume", "auto", "--snapshot-keep", "2", "--log-json",
                str(events), *extra]
        rc1, out1 = _run(main, base)
        steps1 = [s for s, _ in snapshot.list_snapshots(
            f"{tmp_path}/{name}/m_")]
        rc2, out2 = _run(main, base + ["--max_iter", "6"])
        steps2 = [s for s, _ in snapshot.list_snapshots(
            f"{tmp_path}/{name}/m_")]
        recs = [json.loads(ln) for ln in events.read_text().splitlines()]
        runs[name] = (rc1, rc2, steps1, steps2,
                      [(r["event"], r["iteration"], list(r)) for r in recs],
                      "resuming from iteration 4" in out2,
                      list(json.loads(out2[-1])))
    assert runs["port"] == runs["jax"]
    rc1, rc2, steps1, steps2, stream, resumed, _ = runs["port"]
    assert (rc1, rc2, steps1, steps2, resumed) == (0, 0, [2, 4], [4, 6],
                                                   True)
    assert [e for e, *_ in stream] == [
        "display", "test", "snapshot", "display", "test", "snapshot",
        "display", "test", "snapshot"]
    for _, path in snapshot.list_snapshots(f"{tmp_path}/port/m_"):
        jax_snapshot.validate_snapshot(path)


def test_cli_weights_start_at_iteration_zero(tmp_path, monkeypatch):
    monkeypatch.chdir(REPO)
    js = JaxSolver(jax_get_model("mlp"), JaxLossConfig(),
                   JaxSolverConfig(), input_shape=(8, 8, 3))
    js.init()
    params = jax.tree_util.tree_map(np.asarray, js.state["params"])
    wpath = str(tmp_path / "w.npz")
    convert.save_weights_npz(params, wpath)
    argv = ["train", "--solver", "examples/tiny_solver.prototxt",
            "--synthetic", "--device", "cpu", "--weights", wpath]
    solver, _, _ = cli._build_solver(cli.build_parser().parse_args(argv))
    assert solver.iteration == 0
    assert all(not bool((m != 0).any()) for m in solver.momentum.values())
    want = convert.from_jax_params(params)
    assert set(want) == set(solver.params)
    for name, p in solver.params.items():
        assert torch.equal(p.detach(), want[name]), name
    rc, out = _run(cli.main, argv + ["--max_iter", "2"])
    assert rc == 0 and np.isfinite(json.loads(out[-1])["loss"])


def test_cli_resume_path_wins_over_weights(tmp_path, monkeypatch):
    monkeypatch.chdir(REPO)
    solver_path = _write_solver(tmp_path, "p", max_iter=2, snapshot=2)
    base = ["train", "--solver", solver_path, "--model", "mlp",
            "--synthetic", "--device", "cpu"]
    assert _run(cli.main, base)[0] == 0
    snap = f"{tmp_path}/p/m_iter_2.ckpt"
    weights = str(tmp_path / "w.npz")
    convert.save_weights_npz(convert.to_jax_params(get_model(
        "mlp", device="cpu", input_shape=(8, 8, 3), seed=3)), weights)
    args = cli.build_parser().parse_args(
        base + ["--resume", snap, "--weights", weights,
                "--snapshot_prefix", str(tmp_path / "q" / "n_")])
    solver, _, _ = cli._build_solver(args)
    assert solver.iteration == 2
    assert solver.cfg.snapshot_prefix == str(tmp_path / "q" / "n_")
    ref = Solver(get_model("mlp", device="cpu", input_shape=(8, 8, 3)),
                 cfg=dataclasses.replace(solver.cfg))
    ref.restore_snapshot(snap)
    assert all(torch.equal(v, ref.state_dict()[k])
               for k, v in solver.state_dict().items())


def test_cli_sigterm_exits_75_with_a_committed_snapshot(tmp_path,
                                                        monkeypatch):
    """The CLI's preemption contract in process: a stop requested during
    step 3 finishes the step, commits iter 3, prints the JAX CLI's
    ``{"preempted": true, ...}`` line and returns 75."""
    from npairloss_tpu_torch.resilience import preempt as tpreempt

    monkeypatch.chdir(REPO)
    solver_path = _write_solver(tmp_path, "s", max_iter=6, snapshot=0)
    orig = Solver.step

    def step(self, inputs, labels):
        if self.iteration == 2:
            self.preempt.request(signal.SIGTERM)
        return orig(self, inputs, labels)

    monkeypatch.setattr(Solver, "step", step)
    before = signal.getsignal(signal.SIGTERM)
    rc, out = _run(cli.main, ["train", "--solver", solver_path, "--model",
                              "mlp", "--synthetic", "--device", "cpu"])
    assert rc == tpreempt.EXIT_PREEMPTED == 75
    rec = json.loads(out[-1])
    assert rec == {"preempted": True, "iteration": 3,
                   "snapshot": f"{tmp_path}/s/m_iter_3.ckpt",
                   "resume": "--resume auto"}
    assert snapshot.validate_snapshot(rec["snapshot"])["step"] == 3
    assert not [n for n in os.listdir(tmp_path / "s") if ".tmp-" in n]
    assert signal.getsignal(signal.SIGTERM) == before  # uninstalled
