"""The port's ViT trunk (``models/vit.py``) against the flax trunk of
``npairloss_tpu/models/vit.py`` on the same weights, carried over from
the flax init by ``models/convert.py``: depth 2, hidden 64, 4 heads, MLP
128, patch 8 at 32x32 (17 tokens), batch 3; inputs from a numpy seed.

* fp32: the embeddings within 2e-6 of flax's (unit rows; fp32 sums in
  another order), the input gradient and every parameter gradient of a
  probe objective within 1e-4 of its own largest entry — except the
  ``key`` biases', which is zero up to rounding (a softmax ignores a
  constant added to all of a query's scores): both sides' are held
  within 1e-6 absolute.
* Under the ``mxu`` policy (bf16 compute resolved per module at
  ``patchify``, ``block{i}/attn`` and ``block{i}/mlp``, fp32 LayerNorms
  and output) within 3e-2 of flax's embedding: one bf16 ulp is 2^-8
  relative, and every product, the softmax and the GELU round to bf16.
* The full ``vit_b16`` tree at 224x224: the port's names and shapes are
  flax's (``jax.eval_shape``, no compute), and random leaves go through
  ``load_jax_params`` and back through ``to_jax_params`` bit for bit
  (the 3-D ``DenseGeneral`` kernels, the 2-D biases, ``cls`` and
  ``pos_embed``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npairloss_tpu.models import get_model as jax_get_model
from npairloss_tpu.models import precision as jprec
from npairloss_tpu.models.vit import ViTEmbedding as JaxViT
from npairloss_tpu_torch.models import convert, get_model
from npairloss_tpu_torch.models import precision as tprec
from npairloss_tpu_torch.models.vit import ViTEmbedding

SMALL = dict(patch=8, hidden=64, depth=2, num_heads=4, mlp_dim=128)
EMB_TOL = 2e-6
GRAD_TOL = 1e-4
BF16_EMB = 3e-2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max()) / scale
    assert err <= tol, f"{what}: max error {err:.3g} of max {scale:.3g}"


@pytest.fixture(scope="module")
def vit_run():
    rng = np.random.default_rng(21)
    x = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    probe = rng.standard_normal((3, 64)).astype(np.float32)
    jm = JaxViT(dtype=jnp.float32, **SMALL)
    params = jax.tree_util.tree_map(np.array, jax.jit(
        lambda k, x: jm.init(k, x, train=False))(
            jax.random.PRNGKey(2), jnp.asarray(x))["params"])
    # Nonzero biases and cls, so each leaf's mapping shows.
    for i, (path, leaf) in enumerate(sorted(
            convert.flatten_params(params).items())):
        if path.endswith("bias") or path == "cls":
            leaf[...] = np.random.default_rng(i).uniform(
                -0.2, 0.2, leaf.shape).astype(np.float32)

    def obj(p, x):
        emb = jm.apply({"params": p}, x, train=False)
        return jnp.sum(emb * probe), emb

    (_, emb), (gp, gx) = jax.jit(jax.value_and_grad(
        obj, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    jmxu = jax_get_model("vit_b16", policy="mxu", **SMALL)
    mxu = jax.jit(lambda p, x: jmxu.apply({"params": p}, x, train=False))(
        params, jnp.asarray(x))
    return {"x": x, "probe": probe, "params": params, "emb": np.asarray(emb),
            "grad_params": _np(gp), "grad_x": np.asarray(gx),
            "mxu": np.asarray(mxu)}


def test_fp32_forward_and_gradients_match_flax(vit_run):
    run = vit_run
    tm = ViTEmbedding(dtype=torch.float32, image_size=32, **SMALL)
    convert.load_jax_params(tm, run["params"])
    x = torch.from_numpy(run["x"]).requires_grad_()
    emb = tm(x)
    assert emb.shape == (3, 64) and emb.dtype == torch.float32
    np.testing.assert_allclose(emb.detach().numpy(), run["emb"], rtol=0,
                               atol=EMB_TOL)
    (emb * torch.from_numpy(run["probe"])).sum().backward()
    _close(x.grad.numpy(), run["grad_x"], GRAD_TOL, "input")
    want = convert.from_jax_params(run["grad_params"])
    params = dict(tm.named_parameters())
    assert set(params) == set(want)
    for name, w in want.items():
        g = params[name].grad.numpy()
        if name.endswith("attn.key.bias"):
            assert max(np.abs(g).max(), np.abs(w.numpy()).max()) <= 1e-6
            continue
        _close(g, w.numpy(), GRAD_TOL, name)


def test_mxu_policy_forward_within_a_bf16_tolerance(vit_run):
    run = vit_run
    tm = get_model("vit_b16", device="cpu", policy="mxu",
                   input_shape=(32, 32, 3), **SMALL)
    assert tm.policy is tprec.get_policy("mxu")
    assert tm.block1.attn.mp.compute_dtype == torch.bfloat16
    assert tm.block1.mlp.mp.compute_dtype == torch.bfloat16
    assert tm.mp == tprec.ModulePrecision(
        param_dtype=torch.float32, compute_dtype=torch.bfloat16,
        matmul_precision=jprec.get_policy("mxu").resolve(
            "patchify").matmul_precision)
    convert.load_jax_params(tm, run["params"])
    with torch.no_grad():
        emb = tm(torch.from_numpy(run["x"]))
    assert emb.dtype == torch.float32
    err = float(np.abs(emb.numpy() - run["mxu"]).max())
    assert err <= BF16_EMB, err


def test_vit_b16_tree_round_trips_through_convert():
    x = jnp.zeros((1, 224, 224, 3), jnp.float32)
    shapes = jax.eval_shape(
        lambda: jax_get_model("vit_b16", dtype=jnp.float32).init(
            jax.random.PRNGKey(0), x, train=False))["params"]
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), shapes)
    want = convert.flatten_params(tree)
    assert want["pos_embed"].shape == (1, 197, 768)
    assert want["block0/attn/query/kernel"].shape == (768, 12, 64)
    assert want["block0/attn/out/kernel"].shape == (12, 64, 768)
    tm = get_model("vit_b16", device="cpu", dtype=torch.float32)
    fresh = convert.flatten_params(convert.to_jax_params(tm))
    assert {k: v.shape for k, v in fresh.items()} == \
        {k: v.shape for k, v in want.items()}
    convert.load_jax_params(tm, tree)
    back = convert.flatten_params(convert.to_jax_params(tm))
    assert back.keys() == want.keys()
    for k, v in want.items():
        assert np.array_equal(back[k], v), k
    assert tm.embedding_dim == 768


@pytest.mark.parametrize("mining", ["flagship", "absolute"])
def test_stretch_tool_steps_a_small_vit_on_the_cpu(mining):
    """``tools/vit_stretch.py``: a training step of the ViT trunk through
    the blockwise loss (the plain sweeps on the CPU), at a small width."""
    from npairloss_tpu_torch.tools import vit_stretch

    rec = vit_stretch.run(16, 32, 1, mining, device="cpu", **SMALL)
    assert rec["batch"] == 16 and rec["tokens"] == 17 and rec["steps"] == 1
    assert np.isfinite(rec["loss"]) and rec["peak_bytes"] is None
    assert not any(rec["launches"].values())
    assert vit_stretch.main(["--batch", "1"]) == 2
