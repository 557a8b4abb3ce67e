"""The port's solver and ``train`` CLI (npairloss_tpu_torch/train/solver.py,
npairloss_tpu_torch/cli.py) against the JAX package's ``Solver`` and CLI.

Tolerances: the 10-step trajectory (loss, metric tops, lr, every
parameter after every step) within 1e-5 — the same fp32 update, matmuls
summed in another order; the CLI's event stream (events, iterations,
keys, key order) and its display lines with the numbers masked out
exactly.
"""

import dataclasses
import io
import json
import os
import re
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from npairloss_tpu import cli as jax_cli
from npairloss_tpu.config import load_net as jax_load_net
from npairloss_tpu.config import load_solver as jax_load_solver
from npairloss_tpu.data import synthetic_identity_batches
from npairloss_tpu.models import get_model as jax_get_model
from npairloss_tpu.resilience import snapshot as jax_snapshot
from npairloss_tpu.train import Solver as JaxSolver
from npairloss_tpu_torch import cli
from npairloss_tpu_torch.config.schema import load_net, load_solver
from npairloss_tpu_torch.models import convert, get_model
from npairloss_tpu_torch.ops.npair_loss import MiningMethod, NPairLossConfig
from npairloss_tpu_torch.resilience import snapshot
from npairloss_tpu_torch.train.solver import Solver, SolverConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_SOLVER = os.path.join(REPO, "examples", "tiny_solver.prototxt")
TINY_NET = os.path.join(REPO, "examples", "tiny_net.prototxt")
TOL = 1e-5


@pytest.fixture(autouse=True)
def _repo_cwd(monkeypatch):
    # The tiny solver names its net relative to the repository root.
    monkeypatch.chdir(REPO)


def _solvers(variant):
    """The JAX Solver and the port's on the tiny net, the port starting
    from the JAX solver's own initial parameters."""
    jcfg, _ = jax_load_solver(TINY_SOLVER)
    tcfg, _ = load_solver(TINY_SOLVER)
    if variant == "step_wd":  # an lr change, weight decay, bias recipe
        kw = dict(lr_policy="step", gamma=0.5, stepsize=4,
                  weight_decay=0.001)
        jcfg, tcfg = dataclasses.replace(jcfg, **kw), \
            dataclasses.replace(tcfg, **kw)
    mults = ((1.0, 1.0), (2.0, 0.0)) if variant == "step_wd" else None
    jnet, tnet = jax_load_net(TINY_NET), load_net(TINY_NET)
    js = JaxSolver(jax_get_model("mlp"), jnet.loss.loss, jcfg,
                   input_shape=(8, 8, 3), param_mults=mults)
    js.init()
    tm = get_model("mlp", device="cpu", input_shape=(8, 8, 3))
    ts = Solver(tm, tnet.loss.loss, tcfg, param_mults=mults)
    ts.load_params(jax.tree_util.tree_map(np.asarray, js.state["params"]))
    return js, ts


@pytest.mark.parametrize("variant", ["tiny_solver", "step_wd"])
def test_ten_step_trajectory_matches_jax_solver(variant):
    js, ts = _solvers(variant)
    batches = synthetic_identity_batches(32, 8, 2, (8, 8, 3), noise=2.0,
                                         seed=3)
    losses = []
    for step in range(10):
        x, lab = next(batches)
        jm = js.step(x, lab)
        tmets = ts.step(x, lab)
        assert list(tmets) == list(jm)
        for k in jm:
            np.testing.assert_allclose(float(tmets[k]), float(jm[k]),
                                       rtol=TOL, atol=TOL,
                                       err_msg=f"{k} at step {step}")
        want = convert.from_jax_params(
            jax.tree_util.tree_map(np.asarray, js.state["params"]))
        for name, p in ts.params.items():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       rtol=TOL, atol=TOL,
                                       err_msg=f"{name} at step {step}")
        losses.append(float(jm["loss"]))
    assert ts.iteration == 10 == js.iteration
    assert max(losses) > 0  # the trajectory moved the parameters


def test_recall_reaches_one_on_synthetic_clusters():
    cfg = SolverConfig(base_lr=0.5, lr_policy="fixed", momentum=0.9,
                       weight_decay=0.0, display=0, test_interval=0,
                       snapshot=0, average_loss=10)
    loss_cfg = NPairLossConfig(margin_diff=-0.05,
                               an_mining_method=MiningMethod.HARD)
    model = get_model("mlp", device="cpu", input_shape=(16,), hidden=(64,),
                      embedding_dim=32, seed=1)
    solver = Solver(model, loss_cfg, cfg)
    batches = synthetic_identity_batches(16, 16, 2, (16,), noise=0.6)
    recalls = []
    for _ in range(150):
        m = solver.step(*next(batches))
        recalls.append(float(m["retrieve_top1"]))
    assert recalls[0] < 1.0
    assert max(recalls[-10:]) == 1.0, recalls[-10:]
    assert float(m["loss"]) < 0.5


def _mask(line):
    return re.sub(r"-?\d+(\.\d+)?(e[-+]?\d+)?", "#", line)


def test_cli_event_stream_matches_jax_cli(tmp_path):
    """``train --solver examples/tiny_solver.prototxt --synthetic --device
    cpu --log-json``: the same events with the same keys in the same
    order, the same display lines and the same final line's keys as the
    JAX CLI (which shards the batch over the 8 test devices — values
    differ, the stream does not)."""
    streams, outs = {}, {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        path = tmp_path / f"{name}.jsonl"
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = main(["train", "--solver", "examples/tiny_solver.prototxt",
                       "--synthetic", "--log-json", str(path), *extra])
        assert rc == 0
        streams[name] = [json.loads(ln) for ln in path.read_text()
                         .splitlines()]
        outs[name] = buf.getvalue().strip().splitlines()
    key = lambda recs: [(r["event"], r["iteration"], list(r))  # noqa: E731
                        for r in recs]
    assert key(streams["port"]) == key(streams["jax"])
    assert [e for e, *_ in key(streams["port"])] == [
        "display", "test", "display", "test"]
    assert list(json.loads(outs["port"][-1])) == list(
        json.loads(outs["jax"][-1]))
    display = lambda lines: [_mask(ln) for ln in lines  # noqa: E731
                             if ln.startswith("iter ")]
    assert display(outs["port"]) == display(outs["jax"])
    for rec in streams["port"]:
        assert all(np.isfinite(v) for v in rec.values()
                   if isinstance(v, float))


@pytest.mark.parametrize("flag", [["--mesh", "2"]])
def test_unported_train_flags_are_refused(flag, caplog):
    """``--mesh 2`` in a process outside any process group exits 2 with
    the launch recipe (torchrun, or the three launch flags)."""
    rc = cli.main(["train", "--solver", "examples/tiny_solver.prototxt",
                   "--synthetic", "--device", "cpu", *flag])
    assert rc == 2
    assert "torchrun --nproc-per-node 2 -m npairloss_tpu_torch train" \
        in caplog.text
    assert "--coordinator HOST:PORT --num-processes 2" in caplog.text


def test_train_without_synthetic_exits_2(tmp_path, caplog):
    """Without ``--synthetic`` the net's list files feed the run: a data
    layer whose ``source`` does not exist exits 2 naming the phase and
    the path, and one with no ``source`` (the tiny net) names the phase,
    with the JAX CLI's messages."""
    missing = str(tmp_path / "no_such_list.txt")
    net = tmp_path / "net.prototxt"
    net.write_text(open(TINY_NET).read().replace(
        "multi_batch_data_param {",
        f'multi_batch_data_param {{\n        source: "{missing}"'))
    rc = cli.main(["train", "--solver", "examples/tiny_solver.prototxt",
                   "--net", str(net), "--device", "cpu"])
    assert rc == 2
    assert f"TRAIN data source {missing!r} does not exist" in caplog.text
    caplog.clear()
    rc = cli.main(["train", "--solver", "examples/tiny_solver.prototxt",
                   "--device", "cpu"])
    assert rc == 2
    assert "TRAIN data layer has no `source` list file" in caplog.text


def test_unported_trunk_exits_2_naming_its_queue_item(caplog):
    """A trunk name that neither registry has (the ResNet and ViT trunks
    are in both now): train exits 2 with the "unknown model" refusal,
    not a traceback, and ``get_model`` raises ``KeyError`` as JAX's
    does."""
    rc = cli.main(["train", "--solver",
                   "examples/resnet50_sop_solver.prototxt", "--synthetic",
                   "--device", "cpu", "--max_iter", "1", "--model",
                   "resnet101"])
    assert rc == 2
    assert "unknown model 'resnet101'" in caplog.text
    with pytest.raises(KeyError, match="resnet101"):
        get_model("resnet101", device="cpu")
    with pytest.raises(KeyError, match="resnet101"):
        jax_get_model("resnet101")


def test_port_registry_equals_the_jax_registry():
    from npairloss_tpu.models import available_models as jax_available
    from npairloss_tpu_torch.models import available_models

    assert available_models() == jax_available()
    assert {"resnet50", "resnet50_s2d", "resnet18", "vit_b16"} <= set(
        available_models())


def test_snapshot_cadence_fires_as_in_jax(tmp_path):
    """``snapshot: 5`` within ``max_iter 10`` commits iter 5 and iter 10
    in both CLIs (the JAX one shards over the 8 test devices), each with
    a ``snapshot`` event after the step's display and test events; the
    library's ``train`` does the same."""
    solver = tmp_path / "solver.prototxt"
    solver.write_text(open(TINY_SOLVER).read().replace(
        "snapshot: 0", "snapshot: 5").replace(
        'net: "examples/tiny_net.prototxt"', f'net: "{TINY_NET}"'))
    streams = {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        events = tmp_path / f"{name}.jsonl"
        with redirect_stdout(io.StringIO()):
            rc = main(["train", "--solver", str(solver), "--synthetic",
                       "--snapshot_prefix", str(tmp_path / name / "m_"),
                       "--log-json", str(events), *extra])
        assert rc == 0
        steps = [s for s, _ in snapshot.list_snapshots(
            str(tmp_path / name / "m_"))]
        assert steps == [5, 10], name
        streams[name] = [(r["event"], r["iteration"]) for r in map(
            json.loads, events.read_text().splitlines())]
    assert streams["port"] == streams["jax"] == [
        ("display", 5), ("test", 5), ("snapshot", 5),
        ("display", 10), ("test", 10), ("snapshot", 10)]
    for _, path in snapshot.list_snapshots(str(tmp_path / "port" / "m_")):
        assert jax_snapshot.validate_snapshot(path)["step"] in (5, 10)
    ts = Solver(get_model("mlp", device="cpu", input_shape=(8, 8, 3)),
                cfg=SolverConfig(snapshot=5, max_iter=10, display=0,
                                 test_interval=0,
                                 snapshot_prefix=str(tmp_path / "lib_")))
    ts.train(synthetic_identity_batches(32, 8, 2, (8, 8, 3), seed=1),
             log_fn=lambda s: None)
    assert [s for s, _ in snapshot.list_snapshots(
        str(tmp_path / "lib_"))] == [5, 10]


def test_train_needs_a_card_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", "--solver", "examples/tiny_solver.prototxt",
                  "--synthetic", "--max_iter", "1"])


def test_init_draws_the_seeded_weights_and_resets_the_optimizer():
    ts = Solver(get_model("mlp", device="cpu", input_shape=(8, 8, 3),
                          seed=7), cfg=SolverConfig(random_seed=3))
    ts.step(*next(synthetic_identity_batches(32, 8, 2, (8, 8, 3), noise=2.0,
                                             seed=0)))
    ts.init()
    want = get_model("mlp", device="cpu", input_shape=(8, 8, 3), seed=3)
    for name, p in want.named_parameters():
        assert torch.equal(ts.params[name].detach(), p.detach()), name
    assert ts.iteration == 0
    assert all(not bool((v != 0).any()) for v in ts.momentum.values())


def test_load_params_resets_the_optimizer():
    _, ts = _solvers("tiny_solver")
    ts.step(*next(synthetic_identity_batches(32, 8, 2, (8, 8, 3), noise=2.0,
                                             seed=0)))
    assert ts.iteration == 1
    assert any(bool((v != 0).any()) for v in ts.momentum.values())
    ts.load_params(convert.to_jax_params(ts.model))
    assert ts.iteration == 0
    assert all(not bool((v != 0).any()) for v in ts.momentum.values())
