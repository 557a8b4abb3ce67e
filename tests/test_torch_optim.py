"""The port's Caffe SGD and lr policies (npairloss_tpu_torch/train/optim.py)
against the JAX package's ``train/optim.py``.

Tolerance: rates within 1e-6 relative (both fp32; numpy's and XLA's
``pow`` may differ by an ulp); a parameter trajectory within 1e-6
(the same fp32 operations in the same order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npairloss_tpu.train.optim import caffe_sgd as jax_caffe_sgd
from npairloss_tpu.train.optim import lr_schedule as jax_lr_schedule
from npairloss_tpu_torch.train import optim

POLICIES = [
    ("fixed", {}),
    ("step", dict(gamma=0.5, stepsize=10)),
    ("exp", dict(gamma=0.95)),
    ("inv", dict(gamma=0.5, power=0.75)),
    ("multistep", dict(gamma=0.1, stepvalues=(5, 8, 20))),
    ("poly", dict(power=2.0, max_iter=30)),
    ("sigmoid", dict(gamma=0.3, stepsize=12)),
]


@pytest.mark.parametrize("policy,kw", POLICIES, ids=[p for p, _ in POLICIES])
def test_lr_policies_match_jax(policy, kw):
    got = optim.lr_schedule(policy, 0.01, **kw)
    want = jax_lr_schedule(policy, 0.01, **kw)
    steps = [0, 1, 4, 5, 8, 9, 10, 11, 25, 30, 45]
    np.testing.assert_allclose([got(s) for s in steps],
                               [float(want(jnp.int32(s))) for s in steps],
                               rtol=1e-6)
    assert all(isinstance(got(s), float) for s in steps)


def test_lr_policy_errors():
    with pytest.raises(ValueError, match="poly"):
        optim.lr_schedule("poly", 0.1)
    with pytest.raises(ValueError, match="unknown"):
        optim.lr_schedule("cosine", 0.1)


def test_step_policy_is_fp32():
    """base * gamma^floor(step/stepsize) in fp32: the rate is an fp32
    value, exactly JAX's at the step boundaries."""
    got = optim.lr_schedule("step", 0.001, gamma=0.5, stepsize=10000)
    want = jax_lr_schedule("step", 0.001, gamma=0.5, stepsize=10000)
    for s in (0, 9999, 10000, 25000):
        assert got(s) == float(want(jnp.int32(s)))
        assert got(s) == float(np.float32(got(s)))


def test_bias_rule_and_param_mults():
    names = ["conv1.Conv_0.weight", "conv1.Conv_0.bias", "bn.bias",
             "bn.scale", "head.weight", "head.bias", "bias"]
    assert optim.conv_bias_names(names) == {"conv1.Conv_0.bias", "head.bias"}
    m = optim.param_mults(names, ((1.0, 1.0), (2.0, 0.0)))
    assert m["conv1.Conv_0.bias"] == (2.0, 0.0)
    assert m["bn.bias"] == (1.0, 1.0)
    assert m["head.weight"] == (1.0, 1.0)
    assert optim.param_mults(names) == {n: (1.0, 1.0) for n in names}


def test_caffe_sgd_trajectory_matches_jax_across_an_lr_change():
    """Momentum, weight decay and the (1,1)/(2,0) bias recipe, with the
    lr halving mid-run: lr folds in BEFORE momentum."""
    rng = np.random.default_rng(0)
    shapes = {"conv": {"kernel": (3, 3, 2, 4), "bias": (4,)},
              "head": {"kernel": (5, 3), "bias": (3,)}}
    params = {m: {k: rng.standard_normal(s).astype(np.float32)
                  for k, s in sub.items()} for m, sub in shapes.items()}
    grads = [{m: {k: rng.standard_normal(s).astype(np.float32)
                  for k, s in sub.items()} for m, sub in shapes.items()}
             for _ in range(8)]
    mults = ((1.0, 1.0), (2.0, 0.0))
    rate = jax_lr_schedule("step", 0.1, gamma=0.5, stepsize=3)
    tx = jax_caffe_sgd(rate, momentum=0.9, weight_decay=0.01,
                       param_mults=mults)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)

    def flat(tree):
        return {f"{m}.{'weight' if k == 'kernel' else k}": v
                for m, sub in tree.items() for k, v in sub.items()}

    tp = {n: torch.from_numpy(np.array(v)) for n, v in flat(params).items()}
    buf = {n: torch.zeros_like(v) for n, v in tp.items()}
    t_rate = optim.lr_schedule("step", 0.1, gamma=0.5, stepsize=3)
    table = optim.param_mults(list(tp), mults)
    for step, g in enumerate(grads):
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state,
                               jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
        optim.caffe_sgd(tp, {n: torch.from_numpy(v)
                             for n, v in flat(g).items()},
                        buf, t_rate(step), 0.9, 0.01, table)
        for n, v in flat(jax.tree_util.tree_map(np.asarray, jp)).items():
            np.testing.assert_allclose(tp[n].numpy(), v, rtol=1e-6,
                                       atol=1e-7, err_msg=f"{n} step {step}")
