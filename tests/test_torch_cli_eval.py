"""The port's ``test``, ``extract``, ``eval`` and ``time`` commands
(npairloss_tpu_torch/cli.py) against the JAX CLI, on the tiny solver
with ``--model mlp --synthetic``, each package given the same weights:
JAX restores a snapshot of its solver (``--resume``, ``--mesh 1``), the
port loads that snapshot's parameters as a weights file.

Tolerances: the ``test`` metrics and the extracted embeddings within
1e-5 (the same fp32 forward, matmuls summed in another order); labels,
the ``eval`` JSON (Recall@K on the same .npy files, rounded to 4
digits), ``time``'s key set (less JAX's ``fetch_floor_ms``,
``step_flops`` and ``mfu``) and the exit-2 refusals with their messages
exactly.
"""

import io
import json
import logging
import os
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
from npairloss_tpu_torch.models import convert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_SOLVER = os.path.join(REPO, "examples", "tiny_solver.prototxt")
TINY_NET = os.path.join(REPO, "examples", "tiny_net.prototxt")
TOL = 1e-5


@pytest.fixture(autouse=True)
def _repo_cwd(monkeypatch):
    monkeypatch.chdir(REPO)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A JAX snapshot of the tiny net after two steps, and its
    parameters as a weights file."""
    import dataclasses

    root = tmp_path_factory.mktemp("cli_eval")
    jcfg, _ = jax_load_solver(TINY_SOLVER)
    jcfg = dataclasses.replace(jcfg, snapshot_prefix=str(root / "m_"))
    jnet = jax_load_net(TINY_NET)
    js = JaxSolver(jax_get_model("mlp"), jnet.loss.loss, jcfg,
                   input_shape=(8, 8, 3))
    js.init()
    batches = synthetic_identity_batches(32, 8, 2, (8, 8, 3), noise=2.0,
                                         seed=3)
    for _ in range(2):
        js.step(*next(batches))
    snap = js.save_snapshot(2)
    js._ckpt().wait_until_finished()
    npz = str(root / "w.npz")
    convert.save_weights_npz(
        jax.tree_util.tree_map(np.asarray, js.state["params"]), npz)
    return {"root": root, "snapshot": snap, "npz": npz}


def _run(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue().strip().splitlines()


def _both(weights, cmd, extra=()):
    """(JAX rc, lines), (port rc, lines) for one command."""
    base = [cmd, "--solver", TINY_SOLVER, "--model", "mlp", *extra]
    j = _run(jax_cli.main, base + ["--resume", weights["snapshot"],
                                   "--mesh", "1"])
    p = _run(cli.main, base + ["--weights", weights["npz"], "--device",
                               "cpu"])
    return j, p


def test_test_command_matches_jax(weights):
    (jrc, jout), (prc, pout) = _both(weights, "test", ["--synthetic"])
    assert jrc == prc == 0
    want, got = json.loads(jout[-1]), json.loads(pout[-1])
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL,
                                   err_msg=k)


def test_extract_then_eval_match_jax(weights):
    out = {}
    for name, main, extra in (
            ("jax", jax_cli.main, ["--resume", weights["snapshot"],
                                   "--mesh", "1"]),
            ("port", cli.main, ["--weights", weights["npz"], "--device",
                                "cpu"])):
        prefix = str(weights["root"] / f"{name}_f")
        rc, lines = _run(main, ["extract", "--solver", TINY_SOLVER,
                                "--model", "mlp", "--synthetic",
                                "--batches", "3", "--out", prefix, *extra])
        assert rc == 0
        out[name] = (json.loads(lines[-1]), np.load(prefix + ".emb.npy"),
                     np.load(prefix + ".labels.npy"))
    (jrec, jemb, jlab), (prec, pemb, plab) = out["jax"], out["port"]
    assert list(prec) == list(jrec) and prec["shape"] == jrec["shape"] \
        == [48, 64]
    np.testing.assert_allclose(pemb, jemb, rtol=TOL, atol=TOL)
    assert plab.dtype == jlab.dtype and np.array_equal(plab, jlab)
    assert abs(prec["mean_norm"] - 1.0) < 1e-5

    # eval over the JAX extract's files, in both packages.
    prefix = str(weights["root"] / "jax_f")
    evals = {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        rc, lines = _run(main, ["eval", "--prefix", prefix, "--ks", "1",
                                "2", "4", "100", "--query-block", "20",
                                *extra])
        assert rc == 0
        evals[name] = lines[-1]
    assert evals["port"] == evals["jax"]
    assert json.loads(evals["port"])["gallery_size"] == 48
    rc, lines = _run(cli.main, ["eval", "--prefix", prefix, "--nmi",
                                "--device", "cpu"])
    assert rc == 0 and 0.0 <= json.loads(lines[-1])["nmi"] <= 1.0


@pytest.mark.parametrize("forward_only", [False, True])
def test_time_record_keys_match_jax(weights, forward_only):  # slow-ok: time's record against the JAX CLI's
    extra = ["--iterations", "2", "--batch", "8"] + (
        ["--forward-only"] if forward_only else [])
    (jrc, jout), (prc, pout) = _both(weights, "time", extra)
    assert jrc == prc == 0
    want, got = json.loads(jout[-1]), json.loads(pout[-1])
    # The port counts the step's FLOPs (obs.perf.count) where JAX asks
    # XLA; neither has a peak for the CPU, so neither prints an mfu.
    assert set(got) == set(want) - {"fetch_floor_ms"}
    assert ("step_flops" in got) == (not forward_only) and "mfu" not in got
    assert got["device"] == "cpu:cpu" and got["batch"] == want["batch"] == 8
    assert got["engine"] == want["engine"] == "dense"
    assert all(got[k] > 0 for k in got if k.endswith("_ms")
               and k not in ("loss_forward_ms", "backward_ms"))


def _net_without(tmp_path, phase):
    text = open(TINY_NET).read()
    blocks = text.split("layer {")
    keep = [b for b in blocks if f"include {{ phase: {phase} }}" not in b]
    path = tmp_path / f"no_{phase.lower()}.prototxt"
    path.write_text("layer {".join(keep))
    return str(path)


def _refusal_argv(case, tmp_path):
    if case == "test_iterations_0":
        return ["test", "--solver", TINY_SOLVER, "--model", "mlp",
                "--synthetic", "--iterations", "0"]
    if case == "test_no_test_layer":
        return ["test", "--solver", TINY_SOLVER, "--net",
                _net_without(tmp_path, "TEST"), "--model", "mlp",
                "--synthetic"]
    if case == "extract_no_train_layer":
        return ["extract", "--solver", TINY_SOLVER, "--net",
                _net_without(tmp_path, "TRAIN"), "--model", "mlp",
                "--synthetic", "--phase", "train"]
    if case == "net_not_found":
        return ["test", "--solver", TINY_SOLVER, "--net",
                str(tmp_path / "missing.prototxt"), "--synthetic"]
    if case == "eval_missing":
        return ["eval", "--prefix", str(tmp_path / "none")]
    if case == "eval_rows":
        np.save(tmp_path / "r.emb.npy", np.zeros((5, 4), np.float32))
        np.save(tmp_path / "r.labels.npy", np.zeros((3,), np.int32))
        return ["eval", "--prefix", str(tmp_path / "r")]
    if case == "time_ids_0":
        return ["time", "--solver", TINY_SOLVER, "--model", "mlp", "--ids",
                "0"]
    if case == "time_iterations_0":
        return ["time", "--solver", TINY_SOLVER, "--model", "mlp",
                "--iterations", "0"]
    raise KeyError(case)


@pytest.mark.parametrize("case", [
    "test_iterations_0", "test_no_test_layer", "extract_no_train_layer",
    "net_not_found", "eval_missing", "eval_rows", "time_ids_0",
    "time_iterations_0"])
def test_refusals_exit_2_with_the_jax_message(case, tmp_path, caplog):
    argv = _refusal_argv(case, tmp_path)
    msgs = {}
    for name, main, extra, logger in (
            ("jax", jax_cli.main, ["--mesh", "1"] if argv[0] != "eval"
             else [], "npairloss_tpu.cli"),
            ("port", cli.main, ["--device", "cpu"], "npairloss_tpu_torch")):
        caplog.clear()
        with caplog.at_level(logging.ERROR):
            rc, _ = _run(main, argv + extra)
        assert rc == 2, name
        msgs[name] = [r.getMessage() for r in caplog.records
                      if r.levelno >= logging.ERROR
                      and r.name.startswith(logger)]
    assert msgs["port"] == msgs["jax"] and len(msgs["port"]) == 1


@pytest.mark.parametrize("argv", [
    ["test", "--synthetic"], ["extract", "--synthetic"], ["time"],
    ["train", "--synthetic", "--resume", "auto"]])
def test_commands_need_a_card_unless_cpu_is_asked_for(argv, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([argv[0], "--solver", TINY_SOLVER, "--model", "mlp",
                  *argv[1:]])
