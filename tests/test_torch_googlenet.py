"""The port's GoogLeNet trunk (npairloss_tpu_torch/models) against the
flax trunk of the JAX package, on the same weights carried across by
``models/convert.py``.

Tolerance: fp32 embeddings within 1e-4 absolute (unit vectors after ~60
convolutions summed in another order); converters and layout helpers
exactly.  The JAX ``googlenet_pallas`` trunk runs its stem kernels in
Pallas interpret mode on the CPU; the port's runs their plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npairloss_tpu.models import get_model as jax_get_model
from npairloss_tpu.models import googlenet as jgoog
from npairloss_tpu.models import layers as jlayers
from npairloss_tpu.ops.normalize import l2_normalize as jax_l2_normalize
from npairloss_tpu_torch.models import get_model
from npairloss_tpu_torch.models import convert, layers
from npairloss_tpu_torch.ops.normalize import l2_normalize

ATOL = 1e-4


def plain_tree(seed=0):
    """A flax-layout param tree of the plain trunk (7x7 stem, unfused
    1x1s), numpy leaves: the port's seeded init, biases perturbed so
    every channel differs."""
    m = get_model("googlenet", device="cpu", dtype=torch.float32, seed=seed)
    rng = np.random.default_rng(seed)
    flat = {}
    for key, t in m.state_dict().items():
        path, leaf = key.rsplit(".", 1)
        a = t.numpy()
        if leaf == "weight":
            flat[path.replace(".", "/") + "/kernel"] = np.ascontiguousarray(
                a.transpose(2, 3, 1, 0))
        else:
            flat[path.replace(".", "/") + "/bias"] = (
                a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
    return convert.unflatten_params(flat)


@pytest.fixture(scope="module")
def tree():
    return plain_tree()


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(1).standard_normal(
        (2, 64, 64, 3)).astype(np.float32)


def _jax_params(name, tree):
    p = jax.tree_util.tree_map(np.asarray, tree)
    if name in ("googlenet_s2d", "googlenet_mxu", "googlenet_pallas"):
        p = dict(p)
        p["conv1"] = {"Conv_0": {
            "kernel": jlayers.conv1_kernel_to_s2d(p["conv1"]["Conv_0"]["kernel"]),
            "bias": p["conv1"]["Conv_0"]["bias"]}}
    if name in ("googlenet_fused", "googlenet_mxu", "googlenet_pallas"):
        p, _ = jgoog.fuse_inception_1x1_params(p)
    return p


@pytest.mark.parametrize("name", ["googlenet", "googlenet_mxu",
                                  "googlenet_pallas"])
def test_trunk_matches_flax_fp32(name, tree, images):  # slow-ok: the GoogLeNet trunks' fp32 forward against flax
    jm = jax_get_model(name, dtype=jnp.float32)
    want = np.asarray(jax.jit(lambda p, x: jm.apply({"params": p}, x))(
        _jax_params(name, tree), jnp.asarray(images)))
    tm = get_model(name, device="cpu", dtype=torch.float32)
    convert.load_jax_params(tm, tree)
    with torch.inference_mode():
        got = tm(torch.from_numpy(images)).numpy()
    assert got.shape == (2, 1024)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_trunk_bf16_default_matches_flax(tree, images):  # slow-ok: the GoogLeNet trunk's bf16 forward against flax
    """Without a policy both trunks compute in bf16 over fp32 params."""
    jm = jax_get_model("googlenet_pallas")
    assert jm.dtype == jnp.bfloat16
    tm = get_model("googlenet_pallas", device="cpu")
    assert tm.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    want = np.asarray(jax.jit(lambda p, x: jm.apply({"params": p}, x))(
        _jax_params("googlenet_pallas", tree), jnp.asarray(images)))
    convert.load_jax_params(tm, tree)
    with torch.inference_mode():
        got = tm(torch.from_numpy(images)).float().numpy()
    cos = (got * want).sum(1)
    assert cos.min() > 0.99, cos


def test_conv1_kernel_to_s2d_matches_jax():
    k = np.random.default_rng(2).standard_normal((7, 7, 3, 64)).astype(
        np.float32)
    np.testing.assert_array_equal(convert.conv1_kernel_to_s2d(k),
                                  jlayers.conv1_kernel_to_s2d(k))


def test_fuse_inception_1x1_params_matches_jax(tree):
    got = convert.flatten_params(convert.fuse_inception_1x1_params(tree))
    want, _ = jgoog.fuse_inception_1x1_params(
        jax.tree_util.tree_map(np.asarray, tree))
    want = convert.flatten_params(jax.tree_util.tree_map(np.asarray, want))
    assert set(got) == set(want)
    for key in got:
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("name", ["googlenet", "googlenet_s2d",
                                  "googlenet_fused", "googlenet_mxu",
                                  "googlenet_pallas"])
def test_from_jax_params_covers_every_layout(name, tree):
    tm = get_model(name, device="cpu", dtype=torch.float32)
    sd = convert.from_jax_params(convert.adapt_params(
        tree, tm.stem_s2d, tm.fuse_1x1))
    want = tm.state_dict()
    assert list(sorted(sd)) == list(sorted(want))
    for key in sd:
        assert sd[key].shape == want[key].shape, key
    w = sd["conv2.Conv_0.weight"].numpy()
    np.testing.assert_array_equal(
        w, tree["conv2"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1))


def test_weights_npz_round_trip(tree, images, tmp_path):  # slow-ok: the --weights format against flax's tree
    path = str(tmp_path / "w.npz")
    convert.save_weights_npz(tree, path)
    a = get_model("googlenet_mxu", device="cpu", dtype=torch.float32)
    b = get_model("googlenet_mxu", device="cpu", dtype=torch.float32,
                  seed=5)
    convert.load_jax_params(a, tree)
    convert.load_weights_npz(b, path)
    x = torch.from_numpy(images[:1])
    with torch.inference_mode():
        np.testing.assert_array_equal(a(x).numpy(), b(x).numpy())


def test_space_to_depth_matches_jax():
    x = np.random.default_rng(3).standard_normal((2, 6, 4, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        layers.space_to_depth(torch.from_numpy(x)).numpy(),
        np.asarray(jlayers.space_to_depth(jnp.asarray(x))))
    with pytest.raises(ValueError):
        layers.space_to_depth(torch.zeros((1, 5, 4, 3)))


@pytest.mark.parametrize("hw,window,stride", [((7, 9), 3, 2),
                                              ((8, 8), 3, 2),
                                              ((5, 6), 3, 1)])
def test_same_max_pool_matches_jax(hw, window, stride):
    x = np.random.default_rng(4).standard_normal((2, *hw, 5)).astype(
        np.float32)
    np.testing.assert_array_equal(
        layers.max_pool(torch.from_numpy(x), window, stride).numpy(),
        np.asarray(jlayers.max_pool(jnp.asarray(x), window, stride)))


def test_asymmetric_conv_padding_matches_jax():
    """SAME at 224-like even sizes pads the 7x7/s2 stem (2, 3)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 16, 16, 3)).astype(np.float32)
    k = rng.standard_normal((7, 7, 3, 4)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST)
    got = layers.conv2d_nhwc(torch.from_numpy(x),
                             torch.from_numpy(k.transpose(3, 2, 0, 1)),
                             None, (2, 2), "SAME")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_l2_normalize_and_avg_pool_match_jax():
    x = np.random.default_rng(6).standard_normal((3, 4, 5, 7)).astype(
        np.float32)
    x[0] = 0.0
    np.testing.assert_allclose(
        layers.global_avg_pool(torch.from_numpy(x)).numpy(),
        np.asarray(jlayers.global_avg_pool(jnp.asarray(x))), atol=1e-7)
    v = x.reshape(3, -1)
    np.testing.assert_allclose(l2_normalize(torch.from_numpy(v)).numpy(),
                               np.asarray(jax_l2_normalize(jnp.asarray(v))),
                               atol=1e-7)
