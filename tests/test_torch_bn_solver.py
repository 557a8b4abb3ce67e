"""The port's ``Solver`` on the Inception-BN trunk (``googlenet_bn``)
against the JAX ``Solver``: the same initial weights and ``batch_stats``
(the JAX init's, carried over by ``models/convert.py``), the same
batches, 3 steps at 64x64, batch 8, with the reference's bias recipe and
a weight decay large enough to show on BN's scale and bias.

In fp32 the two trunks' gradients through 57 BatchNorms are each
1e-2..4e-2 of their largest entry off the exact ones (ill-conditioned,
``tests/test_torch_googlenet_bn.py``), which after one update moves the
embeddings by 1e-3 — more than any fault this test looks for.  So the
solvers run ``fp32_parity`` with the trunk's compute dtype raised to
fp64 (one rule-free policy object on each side; parameters, momentum,
the update, the loss and the embedding stay fp32): each step's loss and
metric tops within 1e-5 relative, every parameter within 1e-4 of its
own largest entry (a BN bias starts at 0, reaches ~4e-4 in 3 steps, and
its gradient is a cancelling sum of the fp32 loss cotangents: measured
1.8e-5; a decay or lr multiplier wrong on it would be 5e-4 off), every
running statistic within 1e-5 of its scale
(its largest |entry|; for a mean also the sqrt of the largest running
variance beside it).  The TEST phase's metrics likewise.  Under
``fp32_parity`` itself: within the port, snapshot and resume bit for
bit, BN buffers included, and the ``train --model googlenet_bn
--precision fp32_parity`` event stream has the JAX CLI's shape (events,
iterations, keys).
"""

import io
import json
import os
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from npairloss_tpu import cli as jax_cli
from npairloss_tpu.data import synthetic_identity_batches
from npairloss_tpu.models import get_model as jax_get_model
from npairloss_tpu.models import precision as jprec
from npairloss_tpu.train import Solver as JaxSolver
from npairloss_tpu.train import SolverConfig as JaxSolverConfig
from npairloss_tpu_torch import cli
from npairloss_tpu_torch.models import convert, get_model
from npairloss_tpu_torch.models import precision as tprec
from npairloss_tpu_torch.ops.npair_loss import NPairLossConfig
from npairloss_tpu_torch.train.solver import Solver, SolverConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
PARAM_TOL = 1e-4
SHAPE = (64, 64, 3)
KW = dict(base_lr=0.01, lr_policy="fixed", momentum=0.9, weight_decay=0.05,
          display=0, test_interval=0, snapshot=0, average_loss=1)
MULTS = ((1.0, 1.0), (2.0, 0.0))


def _batches(seed):
    return synthetic_identity_batches(16, 4, 2, SHAPE, noise=0.6, seed=seed)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, what, scale=None, tol=TOL):
    scale = max(float(np.abs(want).max()), scale or 0.0, 1e-30)
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max()) / scale
    assert err <= tol, f"{what}: {err:.3g} of {scale:.3g}"


def _check_stats(solver, js):
    got = convert.flatten_params(
        convert.to_jax_params(solver.model, with_batch_stats=True)[1])
    want = convert.flatten_params(_np(js.state["batch_stats"]))
    assert got.keys() == want.keys()
    for k, w in want.items():
        scale = (float(np.sqrt(want[k[:-4] + "var"].max()))
                 if k.endswith("/mean") else None)
        _close(got[k], w, k, scale)


@pytest.fixture(scope="module")
def solvers():
    import jax.numpy as jnp

    tpol = tprec.PrecisionPolicy(name="fp32_parity_f64",
                                 compute_dtype=torch.float64)
    jpol = jprec.PrecisionPolicy(name="fp32_parity_f64",
                                 compute_dtype=jnp.float64)
    torch.backends.mkldnn.enabled = False
    try:
        with jax.enable_x64(True):
            cfg = NPairLossConfig()
            js = JaxSolver(jax_get_model("googlenet_bn", policy=jpol), cfg,
                           JaxSolverConfig(**KW), input_shape=SHAPE,
                           precision=jpol, param_mults=MULTS)
            js.init()
            model = get_model("googlenet_bn", device="cpu", policy=tpol)
            ts = Solver(model, cfg, SolverConfig(**KW), precision=tpol,
                        param_mults=MULTS)
            ts.load_params(_np(js.state["params"]),
                           _np(js.state["batch_stats"]))
            jb, tb = _batches(3), _batches(3)
            trace = []
            for step in range(3):
                jm = js.step(*next(jb))
                tm = ts.step(*next(tb))
                trace.append((step, jm,
                              {k: float(v) for k, v in tm.items()}))
            test = (js.evaluate(_batches(5), 1),
                    ts.evaluate(_batches(5), 1))
            yield js, ts, trace, test
    finally:
        torch.backends.mkldnn.enabled = True


def test_three_bn_steps_match_the_jax_solver(solvers):  # slow-ok: the BN solver's steps against JAX's, in fp64
    js, ts, trace, _ = solvers
    assert ts.matmul_precision is None
    assert ts.precision_policy.describe() == js.precision_policy.describe()
    for step, jm, tm in trace:
        assert list(tm) == list(jm)
        for k in jm:
            np.testing.assert_allclose(tm[k], float(jm[k]), rtol=TOL,
                                       atol=TOL, err_msg=f"{k}, step {step}")
    assert ts.iteration == js.iteration == 3
    want = convert.from_jax_params(_np(js.state["params"]))
    got = dict(ts.model.named_parameters())
    assert got.keys() == want.keys()
    for name, w in want.items():
        _close(got[name].detach().numpy(), w.numpy(), name, tol=PARAM_TOL)
    _check_stats(ts, js)


def test_test_phase_uses_the_running_statistics(solvers):  # slow-ok: the BN TEST phase against JAX's solver
    """``evaluate`` runs the trunk in eval mode: the running statistics
    stay as they are and the metrics match JAX's TEST step, which
    normalizes by them too; a forward on batch statistics differs."""
    js, ts, _, (jtest, ttest) = solvers
    assert list(ttest) == sorted(jtest)
    for k in jtest:
        np.testing.assert_allclose(ttest[k], jtest[k], rtol=TOL, atol=TOL,
                                   err_msg=k)
    before = {n: b.clone() for n, b in ts.model.named_buffers()}
    x, lab = next(_batches(5))
    again = ts.evaluate(iter([(x, lab)]), 1)
    assert again == ttest
    for n, b in ts.model.named_buffers():
        assert torch.equal(b, before[n]), n
    with torch.no_grad():
        emb_eval = ts.model.eval()(torch.from_numpy(x))
        emb_train = ts.model.train()(torch.from_numpy(x))
    assert not torch.allclose(emb_eval, emb_train, atol=1e-3)


def test_snapshot_resume_is_bit_for_bit_with_bn_buffers(tmp_path):  # slow-ok: the only BN-buffer resume check
    kw = dict(KW, snapshot=2, snapshot_prefix=str(tmp_path / "bn_"))

    def solver():
        model = get_model("googlenet_bn", device="cpu", policy="fp32_parity",
                          seed=4)
        return Solver(model, NPairLossConfig(), SolverConfig(**kw),
                      precision="fp32_parity")

    batches = [next(_batches(s)) for s in range(3)]
    a = solver()
    for x, lab in batches:
        a.step(x, lab)
        if a.iteration == 2:
            a.save_snapshot(2)
    b = solver()
    assert b.restore_auto() is not None and b.iteration == 2
    b.step(*batches[2])
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    assert any(k.endswith("BatchNorm_0.var") for k in sa)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_bn_cli_event_stream_matches_jax_cli(tmp_path, monkeypatch):  # slow-ok: both CLIs' googlenet_bn event streams, end to end
    """``train --model googlenet_bn --precision fp32_parity`` on the tiny
    solver (8x8 crops; the JAX CLI shards over the 8 test devices):
    the same events, iterations and keys, the same final line's keys."""
    monkeypatch.chdir(REPO)
    streams, finals = {}, {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        path = tmp_path / f"{name}.jsonl"
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = main(["train", "--solver", "examples/tiny_solver.prototxt",
                       "--model", "googlenet_bn", "--precision",
                       "fp32_parity", "--max_iter", "5", "--synthetic",
                       "--log-json", str(path), *extra])
        assert rc == 0
        streams[name] = [json.loads(ln) for ln in path.read_text()
                         .splitlines()]
        finals[name] = json.loads(buf.getvalue().strip().splitlines()[-1])
    key = lambda recs: [(r["event"], r["iteration"], list(r))  # noqa: E731
                        for r in recs]
    assert key(streams["port"]) == key(streams["jax"])
    assert [e for e, *_ in key(streams["port"])] == ["display", "test"]
    assert list(finals["port"]) == list(finals["jax"])
    for rec in streams["port"] + [finals["port"]]:
        assert all(np.isfinite(v) for v in rec.values()
                   if isinstance(v, float))
