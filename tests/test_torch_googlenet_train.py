"""Training gradients of the port's ``googlenet_pallas`` trunk against the
flax trunk on the same weights (carried across by ``models/convert.py``):
parameter and input gradients of one objective, at 64x64, fp32.  The JAX
trunk runs its Pallas stem kernels in interpret mode; the port's trunk
runs its stem autograd Functions over their plain versions.

The biases are 0: the init's 0.2 biases make this BN-free trunk map
every image to nearly one embedding, and its gradients then sit at the
level of fp32 rounding in either framework (1e-3 apart), which no
tolerance separates from a fault.

Tolerance: every gradient within 1e-4 of the flax gradient, relative to
that gradient's own largest entry (fp32 through ~60 convolutions summed
in another order; measured 2e-5); the objective within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npairloss_tpu.models import get_model as jax_get_model
from npairloss_tpu.models import googlenet as jgoog
from npairloss_tpu.models import layers as jlayers
from npairloss_tpu.ops.npair_loss import npair_loss as jax_npair_loss
from npairloss_tpu_torch.models import convert, get_model
from npairloss_tpu_torch.ops.npair_loss import npair_loss

TOL = 1e-4


def _tree(seed=0):
    """A plain-layout flax tree: the port's seeded kernels, zero biases."""
    m = get_model("googlenet", device="cpu", dtype=torch.float32, seed=seed)
    flat = convert.flatten_params(convert.to_jax_params(m))
    for k in flat:
        if k.endswith("/bias"):
            flat[k] = np.zeros_like(flat[k])
    return convert.unflatten_params(flat)


def _pallas_layout(tree):
    p = dict(tree)
    p["conv1"] = {"Conv_0": {
        "kernel": jlayers.conv1_kernel_to_s2d(p["conv1"]["Conv_0"]["kernel"]),
        "bias": p["conv1"]["Conv_0"]["bias"]}}
    p, _ = jgoog.fuse_inception_1x1_params(p)
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module")
def setup():
    tree = _tree()
    rng = np.random.default_rng(1)
    images = rng.standard_normal((4, 64, 64, 3)).astype(np.float32)
    labels = np.array([0, 0, 1, 1], np.int32)
    probe = rng.standard_normal((4, 1024)).astype(np.float32)
    return tree, images, labels, probe


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= TOL, f"{what}: max error {err:.3g} of max |grad| {scale:.3g}"


@pytest.mark.parametrize("objective", ["probe", "npair"])
def test_pallas_trunk_gradients_match_flax(setup, objective, monkeypatch):  # slow-ok: the stem kernels' trunk gradients against flax
    tree, images, labels, probe = setup
    jm = jax_get_model("googlenet_pallas", dtype=jnp.float32)

    def jax_obj(p, x):
        emb = jm.apply({"params": p}, x, train=True)
        if objective == "probe":
            return jnp.sum(emb * probe)
        return jax_npair_loss(emb, jnp.asarray(labels))

    jval, (jgp, jgx) = jax.jit(jax.value_and_grad(jax_obj, argnums=(0, 1)))(
        _pallas_layout(tree), jnp.asarray(images))
    jax.block_until_ready((jval, jgp, jgx))

    tm = get_model("googlenet_pallas", device="cpu", dtype=torch.float32)
    convert.load_jax_params(tm, tree)
    tm.train()
    x = torch.from_numpy(images).requires_grad_()
    # PyTorch's own convolutions: oneDNN's first call in a process may
    # take another algorithm and move this objective by up to 3.5e-4.
    monkeypatch.setattr(torch.backends.mkldnn, "enabled", False)
    emb = tm(x)
    val = (emb * torch.from_numpy(probe)).sum() if objective == "probe" \
        else npair_loss(emb, torch.from_numpy(labels))
    val.backward()

    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-5, atol=1e-6)
    _close(x.grad.numpy(), np.asarray(jgx), "input")
    want = convert.from_jax_params(jax.tree_util.tree_map(np.asarray, jgp))
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].grad
        assert g is not None, name
        _close(g.numpy(), w.numpy(), name)
