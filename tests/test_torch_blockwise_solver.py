"""The blockwise engine in the port's solver and ``train`` CLI
(``Solver(engine="blockwise")``, ``train --engine blockwise``) against the
port's dense solver, the JAX package's dense solver and the JAX CLI.

Tolerances: the 5-step trajectory (loss, metric tops, every parameter
after every step) within 1e-5 — the same update from a gradient whose
fp32 sums run in another order; the CLI's event stream (events,
iterations, keys, key order) and its display lines with the numbers
masked out exactly.
"""

import io
import json
import os
import re
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest

from npairloss_tpu import cli as jax_cli
from npairloss_tpu.config import load_net as jax_load_net
from npairloss_tpu.config import load_solver as jax_load_solver
from npairloss_tpu.data import synthetic_identity_batches
from npairloss_tpu.models import get_model as jax_get_model
from npairloss_tpu.train import Solver as JaxSolver
from npairloss_tpu_torch import cli
from npairloss_tpu_torch.config.schema import load_net, load_solver
from npairloss_tpu_torch.models import convert, get_model
from npairloss_tpu_torch.ops import _build
from npairloss_tpu_torch.train.solver import Solver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_SOLVER = os.path.join(REPO, "examples", "tiny_solver.prototxt")
TINY_NET = os.path.join(REPO, "examples", "tiny_net.prototxt")
TOL = 1e-5


@pytest.fixture(autouse=True)
def _repo_cwd(monkeypatch):
    # The tiny solver names its net relative to the repository root.
    monkeypatch.chdir(REPO)


def test_five_step_trajectory_matches_dense_and_jax():
    """The port's blockwise solver, the port's dense solver and the JAX
    dense solver from the JAX solver's initial parameters on the MLP over
    ``examples/tiny_net.prototxt``."""
    jcfg, _ = jax_load_solver(TINY_SOLVER)
    tcfg, _ = load_solver(TINY_SOLVER)
    jnet, tnet = jax_load_net(TINY_NET), load_net(TINY_NET)
    js = JaxSolver(jax_get_model("mlp"), jnet.loss.loss, jcfg,
                   input_shape=(8, 8, 3), engine="dense")
    js.init()
    init = jax.tree_util.tree_map(np.asarray, js.state["params"])
    ports = {}
    for engine in ("dense", "blockwise"):
        ts = Solver(get_model("mlp", device="cpu", input_shape=(8, 8, 3)),
                    tnet.loss.loss, tcfg, engine=engine)
        ts.load_params(init)
        ports[engine] = ts
    batches = synthetic_identity_batches(32, 8, 2, (8, 8, 3), noise=2.0,
                                         seed=4)
    _build.reset_launch_counts()
    for step in range(5):
        x, lab = next(batches)
        jm = js.step(x, lab)
        want = convert.from_jax_params(
            jax.tree_util.tree_map(np.asarray, js.state["params"]))
        for engine, ts in ports.items():
            tm = ts.step(x, lab)
            assert list(tm) == list(jm)
            for k in jm:
                np.testing.assert_allclose(
                    float(tm[k]), float(jm[k]), rtol=TOL, atol=TOL,
                    err_msg=f"{engine} {k} at step {step}")
            for name, p in ts.params.items():
                np.testing.assert_allclose(
                    p.detach().numpy(), want[name].numpy(), rtol=TOL,
                    atol=TOL, err_msg=f"{engine} {name} at step {step}")
    assert float(jm["loss"]) > 0
    # On the CPU the wrappers ran their plain sweeps and launched nothing.
    assert _build.launch_counts()["npair_stats"] == 0


def _mask(line):
    return re.sub(r"-?\d+(\.\d+)?(e[-+]?\d+)?", "#", line)


def test_cli_blockwise_event_stream_matches_jax_cli(tmp_path):
    """``train --engine blockwise --pos-topk 0 --sim-cache off``: the
    same events, keys, key order, display lines and final line's keys as
    the JAX CLI with the same flags."""
    flags = ["--engine", "blockwise", "--pos-topk", "0", "--sim-cache", "off"]
    streams, outs = {}, {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        path = tmp_path / f"{name}.jsonl"
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = main(["train", "--solver", "examples/tiny_solver.prototxt",
                       "--synthetic", "--log-json", str(path), *flags,
                       *extra])
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


@pytest.mark.parametrize("flags", [["--engine", "sparse"],
                                   ["--mesh", "two"],
                                   ["--pos-topk", "-1"],
                                   ["--sim-cache", "maybe"],
                                   ["--pos-topk", "many"]])
def test_unported_engines_and_bad_values_are_argparse_errors(flags, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["train", "--solver", "examples/tiny_solver.prototxt",
                  "--synthetic", "--device", "cpu", *flags])
    assert exc.value.code == 2
    assert "argument" in capsys.readouterr().err


def test_solver_refuses_ring_and_unknown_engines():
    model = get_model("mlp", device="cpu", input_shape=(8, 8, 3))
    with pytest.raises(ValueError, match='engine="ring" requires a mesh'):
        Solver(model, engine="ring")
    with pytest.raises(ValueError, match="unknown engine"):
        Solver(model, engine="sparse")
