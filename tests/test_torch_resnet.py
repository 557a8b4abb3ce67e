"""The port's ResNet trunks (``models/resnet.py``) against the flax
trunks of ``npairloss_tpu/models/resnet.py`` on the same weights and
``batch_stats``, carried over from the flax init by ``models/convert.py``.
Inputs come from a numpy seed.

* A shallow trunk (``stage_sizes=(1, 1, 1, 1)``, width 8) at 32x32,
  batch 4, both sides computing in fp64 (flax under
  ``jax.enable_x64``, the port at ``dtype=torch.float64``; parameters,
  input and embedding stay fp32), as ``tests/test_torch_googlenet_bn.py``
  holds BatchNorm: train-mode and eval-mode embeddings within 1e-6, the
  updated running statistics within 1e-6 of their scale, the input and
  every parameter gradient within 1e-5 of its own largest entry.  The
  first block of stage 1 projects at stride 1 (its channels differ) and
  each later stage's first block strides on its 3x3: a trunk that
  strided on the 1x1 or skipped the projection would be off by O(1).
* In bf16 (the trunks' default compute dtype) the same trunk within
  3e-2 of flax's embedding (unit rows; one bf16 ulp is 2^-8 relative,
  and nine convolutions round their outputs).
* ``resnet50``, ``resnet50_s2d`` and ``resnet18``: the port's parameter
  and statistics names and shapes are flax's (``jax.eval_shape``, no
  compute); ``resnet50_s2d`` on the converted stem kernel gives
  ``resnet50``'s embedding within 1e-5 (the s2d rewrite is exact; the
  sums run in another order), and a space-to-depth kernel refuses the
  plain stem.
* 3 ``Solver`` steps of ``resnet50`` at 64x64, batch 8, against the JAX
  ``Solver`` (the pattern of ``tests/test_torch_bn_solver.py``): both
  under a rule-free policy computing in fp64, the same initial weights
  and batches; each step's loss and metric tops within 1e-5 relative;
  after the first step every parameter and running statistic within
  1e-5 of its own scale (measured 3.6e-7).  Later steps are compared by
  their losses alone: the trajectory is chaotic at this size (53
  BatchNorms, the last stage's over 32 values a channel, ReLUs at their
  kinks): the two solvers' fp32 loss cotangents differ in their last
  bits, and the parameters part by 2e-2 (a BatchNorm bias) and 2e-5 (a
  kernel) of their scale after step 2, 6e-2 and 8e-4 after step 3 —
  less than the port moves from itself when its input batch changes by
  one ulp (4e-1 and 7e-3 after 3 steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npairloss_tpu.data import synthetic_identity_batches
from npairloss_tpu.models import get_model as jax_get_model
from npairloss_tpu.models import precision as jprec
from npairloss_tpu.models.resnet import ResNetEmbedding as JaxResNet
from npairloss_tpu.train import Solver as JaxSolver
from npairloss_tpu.train import SolverConfig as JaxSolverConfig
from npairloss_tpu_torch import cli
from npairloss_tpu_torch.models import convert, get_model
from npairloss_tpu_torch.models import precision as tprec
from npairloss_tpu_torch.models.layers import BatchNorm
from npairloss_tpu_torch.models.resnet import ResNetEmbedding
from npairloss_tpu_torch.ops.npair_loss import NPairLossConfig
from npairloss_tpu_torch.train.solver import Solver, SolverConfig

SHALLOW = dict(stage_sizes=(1, 1, 1, 1), width=8)
F64 = {"emb": 1e-6, "stats": 1e-6, "grad": 1e-5}
BF16_EMB = 3e-2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol, what, scale=None):
    scale = max(float(np.abs(want).max()), scale or 0.0, 1e-30)
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max()) / scale
    assert err <= tol, f"{what}: max error {err:.3g} of max {scale:.3g}"


def _stat_scale(stats, key):
    if not key.endswith("/mean"):
        return None
    return float(np.sqrt(stats[key[:-len("mean")] + "var"].max()))


@pytest.fixture(scope="module")
def shallow_run():
    """One jitted fp64 flax program: the train-mode forward with its
    updated batch_stats, the eval-mode forward on them and the gradients
    of a probe objective; the bf16 train- and eval-mode forwards."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    probe = rng.standard_normal((4, 256)).astype(np.float32)
    variables = jax.tree_util.tree_map(np.array, jax.jit(
        lambda k, x: JaxResNet(dtype=jnp.float32, **SHALLOW).init(
            k, x, train=False))(jax.random.PRNGKey(5), jnp.asarray(x)))
    # Nonzero BN scale, bias and running statistics, so the mapping of
    # each leaf shows.
    for i, (path, leaf) in enumerate(sorted(
            convert.flatten_params(variables).items())):
        if leaf.ndim == 1:
            r = np.random.default_rng(i).uniform(0.5, 1.5, leaf.shape)
            leaf[...] = (r if path.endswith(("scale", "var"))
                         else r - 1.0).astype(np.float32)
    out = {"x": x, "probe": probe, "variables": variables}
    with jax.enable_x64(True):
        jm = JaxResNet(dtype=jnp.float64, **SHALLOW)

        def run(params, stats, x):
            def obj(p, x):
                emb, upd = jm.apply({"params": p, "batch_stats": stats}, x,
                                    train=True, mutable=["batch_stats"])
                return jnp.sum(emb * probe), (emb, upd["batch_stats"])

            (_, (emb, new)), (gp, gx) = jax.value_and_grad(
                obj, argnums=(0, 1), has_aux=True)(params, x)
            emb_eval = jm.apply({"params": params, "batch_stats": new}, x,
                                train=False)
            return emb, new, emb_eval, gp, gx

        (out["emb"], out["new_stats"], out["emb_eval"], out["grad_params"],
         out["grad_x"]) = _np(jax.jit(run)(variables["params"],
                                           variables["batch_stats"],
                                           jnp.asarray(x)))
    jb = JaxResNet(dtype=jnp.bfloat16, **SHALLOW)
    out["bf16_train"] = np.asarray(jax.jit(
        lambda v, x: jb.apply(v, x, train=True,
                              mutable=["batch_stats"])[0])(variables, x))
    out["bf16_eval"] = np.asarray(jax.jit(
        lambda v, x: jb.apply(v, x, train=False))(variables, x))
    return out


def _port(run, dtype):
    tm = ResNetEmbedding(dtype=dtype, **SHALLOW)
    convert.load_jax_params(tm, run["variables"])
    return tm


def test_shallow_trunk_train_step_matches_flax_in_fp64(shallow_run,
                                                       monkeypatch):
    run = shallow_run
    monkeypatch.setattr(torch.backends.mkldnn, "enabled", False)
    tm = _port(run, torch.float64).train()
    assert tm.stage2_block1.project and tm.stage1_block1.project
    x = torch.from_numpy(run["x"]).requires_grad_()
    emb = tm(x)
    assert emb.dtype == torch.float32 and emb.shape == (4, 256)
    np.testing.assert_allclose(emb.detach().numpy(), run["emb"],
                               rtol=F64["emb"], atol=F64["emb"])
    got = convert.flatten_params(
        convert.to_jax_params(tm, with_batch_stats=True)[1])
    want = convert.flatten_params(run["new_stats"])
    assert set(got) == set(want)
    assert len(got) == 2 * sum(isinstance(m, BatchNorm)
                               for m in tm.modules())
    for k in want:
        _close(got[k], want[k], F64["stats"], k, _stat_scale(want, k))
    (emb * torch.from_numpy(run["probe"])).sum().backward()
    _close(x.grad.numpy(), run["grad_x"], F64["grad"], "input")
    want_g = convert.from_jax_params(run["grad_params"])
    params = dict(tm.named_parameters())
    assert set(params) == set(want_g)
    for name, w in want_g.items():
        _close(params[name].grad.numpy(), w.numpy(), F64["grad"], name)
    tm.eval()
    with torch.no_grad():
        emb_eval = tm(torch.from_numpy(run["x"]))
    np.testing.assert_allclose(emb_eval.numpy(), run["emb_eval"],
                               rtol=F64["emb"], atol=F64["emb"])


@pytest.mark.parametrize("train", [True, False])
def test_shallow_trunk_in_bf16_within_a_bf16_tolerance(shallow_run, train):
    run = shallow_run
    tm = _port(run, torch.bfloat16).train(train)
    with torch.no_grad():
        emb = tm(torch.from_numpy(run["x"]))
    assert emb.dtype == torch.float32
    want = run["bf16_train" if train else "bf16_eval"]
    err = float(np.abs(emb.numpy() - want).max())
    assert err <= BF16_EMB, err


@pytest.mark.parametrize("name", ["resnet50", "resnet50_s2d", "resnet18"])
def test_trunk_tree_names_and_shapes_equal_flax(name):
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(
        lambda: jax_get_model(name, dtype=jnp.float32).init(
            jax.random.PRNGKey(0), x, train=False))
    want = {k: v.shape for k, v in convert.flatten_params(
        jax.tree_util.tree_map(lambda a: np.empty(a.shape, np.float32),
                               shapes)).items()}
    tm = get_model(name, device="cpu", dtype=torch.float32)
    params, stats = convert.to_jax_params(tm, with_batch_stats=True)
    got = {k: v.shape for k, v in convert.flatten_params(
        {"params": params, "batch_stats": stats}).items()}
    assert got == want
    assert tm.embedding_dim == 2048


def test_s2d_stem_equals_the_plain_stem_on_converted_weights(monkeypatch):
    monkeypatch.setattr(torch.backends.mkldnn, "enabled", False)
    plain = get_model("resnet50", device="cpu", dtype=torch.float32, seed=4)
    s2d = get_model("resnet50_s2d", device="cpu", dtype=torch.float32)
    params, stats = convert.to_jax_params(plain, with_batch_stats=True)
    convert.load_jax_params(s2d, params, stats)
    assert tuple(s2d.conv_stem.weight.shape) == (64, 12, 4, 4)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        want, got = plain(x), s2d(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    back = convert.to_jax_params(s2d)
    with pytest.raises(ValueError, match="space-to-depth stem"):
        convert.load_jax_params(plain, back)


@pytest.mark.parametrize("model", ["resnet50", "vit_b16"])
def test_train_remat_exits_2_as_jax_refuses_it(model, caplog):
    """Neither trunk family has ``remat`` in JAX (flax raises
    ``TypeError``): ``train --remat`` refuses it with exit 2, no silent
    fallback to a trunk without it."""
    with pytest.raises(TypeError):
        jax_get_model(model, remat=True)
    rc = cli.main(["train", "--solver",
                   "examples/resnet50_sop_solver.prototxt", "--synthetic",
                   "--device", "cpu", "--max_iter", "1", "--model", model,
                   "--remat"])
    assert rc == 2
    assert f"model {model!r} does not take --remat" in caplog.text


SHAPE = (64, 64, 3)
KW = dict(base_lr=0.01, lr_policy="fixed", momentum=0.9, weight_decay=0.05,
          display=0, test_interval=0, snapshot=0, average_loss=1)
MULTS = ((1.0, 1.0), (2.0, 0.0))


def _batches(seed):
    return synthetic_identity_batches(16, 4, 2, SHAPE, noise=0.6, seed=seed)


def _check_state(ts, js):
    want = convert.from_jax_params(_np(js.state["params"]))
    got = dict(ts.model.named_parameters())
    assert got.keys() == want.keys()
    for name, w in want.items():
        _close(got[name].detach().numpy(), w.numpy(), 1e-5, name)
    got_s = convert.flatten_params(
        convert.to_jax_params(ts.model, with_batch_stats=True)[1])
    want_s = convert.flatten_params(_np(js.state["batch_stats"]))
    assert got_s.keys() == want_s.keys()
    for k, w in want_s.items():
        _close(got_s[k], w, 1e-5, k, _stat_scale(want_s, k))


def test_three_resnet50_solver_steps_match_the_jax_solver():  # slow-ok: the one ResNet-50 Solver trajectory against JAX (~35 s, most of it XLA)
    tpol = tprec.PrecisionPolicy(name="fp32_parity_f64",
                                 compute_dtype=torch.float64)
    jpol = jprec.PrecisionPolicy(name="fp32_parity_f64",
                                 compute_dtype=jnp.float64)
    torch.backends.mkldnn.enabled = False
    try:
        with jax.enable_x64(True):
            cfg = NPairLossConfig()
            js = JaxSolver(jax_get_model("resnet50", policy=jpol), cfg,
                           JaxSolverConfig(**KW), input_shape=SHAPE,
                           precision=jpol, param_mults=MULTS)
            js.init()
            model = get_model("resnet50", device="cpu", policy=tpol)
            assert model.dtype == torch.float64
            ts = Solver(model, cfg, SolverConfig(**KW), precision=tpol,
                        param_mults=MULTS)
            ts.load_params(_np(js.state["params"]),
                           _np(js.state["batch_stats"]))
            jb, tb = _batches(3), _batches(3)
            for step in range(3):
                jm = js.step(*next(jb))
                tm = {k: float(v) for k, v in ts.step(*next(tb)).items()}
                assert list(tm) == list(jm)
                for k in jm:
                    np.testing.assert_allclose(
                        tm[k], float(jm[k]), rtol=1e-5, atol=1e-5,
                        err_msg=f"{k}, step {step}")
                if step == 0:
                    _check_state(ts, js)
    finally:
        torch.backends.mkldnn.enabled = True
