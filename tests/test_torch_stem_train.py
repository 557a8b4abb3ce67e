"""Training through the port's stem ops (npairloss_tpu_torch/ops/stem.py):
the LRN backward (cache on and off), the bias+ReLU(+pool) backward and the
autograd Functions that carry them, against ``jax.vjp`` of the JAX
package's Pallas ops (interpret mode on the CPU).  On CPU tensors the
Functions call the plain versions of the kernels.

Tolerances: fp32 within 1e-6 relative plus 2e-6 absolute (two fp32 ulps
at |v| < 8: the same arithmetic, rsqrt/exp/log from two libraries);
bf16 within 2^-7 relative (one bf16 ulp) plus 1e-6; the cached and the
recompute plain backward bit for bit; bias+ReLU(+pool) exactly (masks
and copies of the same fp32 values), their bias gradients within 1e-6
(fp32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npairloss_tpu.ops import pallas_stem as ps
from npairloss_tpu_torch.models.layers import ConvBlock
from npairloss_tpu_torch.ops import stem

RTOL, ATOL = 1e-6, 2e-6
BF16_RTOL = 2.0 ** -7


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _bf16_round(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


# (shape, size): odd and even windows, C below, at and above the
# Pallas kernel's 128 lanes, and ragged row counts.
LRN_CASES = [((2, 5, 3, 64), 5), ((1, 4, 4, 200), 4), ((3, 7, 2, 192), 5),
             ((2, 3, 5, 37), 6), ((1, 9, 9, 96), 3)]


@pytest.mark.parametrize("cache", [True, False])
@pytest.mark.parametrize("shape,size", LRN_CASES)
def test_lrn_backward_matches_jax_vjp(shape, size, cache):
    x = _rand(shape, 1, scale=3.0)
    g = _rand(shape, 2)
    out, vjp = jax.vjp(lambda a: ps.fused_lrn(a, size=size, cache=cache),
                       jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    yt = stem.fused_lrn(xt, size=size, cache=cache)
    yt.backward(torch.from_numpy(g))
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(out),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("cache", [True, False])
def test_lrn_backward_bf16_matches_jax_vjp(cache):
    shape = (2, 6, 5, 192)
    x = _bf16_round(_rand(shape, 3, scale=4.0))
    g = _bf16_round(_rand(shape, 4))
    xb = jnp.asarray(x, jnp.bfloat16)
    _, vjp = jax.vjp(lambda a: ps.fused_lrn(a, cache=cache), xb)
    (dx_j,) = vjp(jnp.asarray(g, jnp.bfloat16))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    stem.fused_lrn(xt, cache=cache).backward(
        torch.from_numpy(g).to(torch.bfloat16))
    assert xt.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(xt.grad.float().numpy(),
                               np.asarray(dx_j.astype(jnp.float32)),
                               rtol=BF16_RTOL, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,size", LRN_CASES[:3])
def test_cached_and_recompute_plain_backward_are_bit_identical(shape, size,
                                                               dtype):
    x = torch.from_numpy(_rand(shape, 5, scale=3.0)).to(dtype)
    g = torch.from_numpy(_rand(shape, 6)).to(dtype)
    out, d = stem.lrn_fwd_cached_plain(x, size)
    assert d.dtype == torch.float32
    assert torch.equal(out, stem.lrn_plain(x, size))
    assert torch.equal(stem.lrn_bwd_plain(x, g, d, size),
                       stem.lrn_bwd_plain(x, g, None, size))


def test_lrn_generic_beta_backward_matches_jax():
    """beta != 0.75 takes exp(-beta log d) in both."""
    x, g = _rand((2, 4, 4, 64), 7, scale=4.0), _rand((2, 4, 4, 64), 8)
    kw = dict(size=3, alpha=2e-3, beta=0.5, k=2.0)
    _, vjp = jax.vjp(lambda a: ps.fused_lrn(a, **kw), jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(g))
    dx = stem.lrn_bwd_plain(torch.from_numpy(x), torch.from_numpy(g), None,
                            **kw)
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_j), rtol=RTOL,
                               atol=ATOL)


def _spy(monkeypatch, *names):
    calls = []
    for name in names:
        orig = getattr(stem, name)

        def wrapper(*a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(*a, **k)

        monkeypatch.setattr(stem, name, wrapper)
    return calls


def test_fused_lrn_routes_like_the_jax_custom_vjp(monkeypatch):
    """No graph -> the uncached forward (the JAX primal); with a graph the
    cache budget picks cached forward + cached backward, or the uncached
    forward + the recomputing backward."""
    calls = _spy(monkeypatch, "lrn_fwd", "lrn_fwd_cached", "lrn_bwd",
                 "lrn_bwd_cached")
    x = torch.from_numpy(_rand((2, 3, 3, 64), 9))
    with torch.no_grad():
        stem.fused_lrn(x.clone().requires_grad_())
    stem.fused_lrn(x)
    assert calls == ["lrn_fwd", "lrn_fwd"]
    calls.clear()
    stem.fused_lrn(x.clone().requires_grad_()).sum().backward()
    assert calls == ["lrn_fwd_cached", "lrn_bwd_cached"]
    calls.clear()
    monkeypatch.setattr(stem, "LRN_CACHE_AUTO_BYTES", 0)
    stem.fused_lrn(x.clone().requires_grad_()).sum().backward()
    assert calls == ["lrn_fwd", "lrn_bwd"]
    calls.clear()
    stem.fused_lrn(x.clone().requires_grad_(), cache=True).sum().backward()
    assert calls == ["lrn_fwd_cached", "lrn_bwd_cached"]


def test_cache_budget_counts_the_unpadded_denominator():
    assert stem.resolve_lrn_cache_auto(stem.LRN_CACHE_AUTO_BYTES, None)
    assert not stem.resolve_lrn_cache_auto(stem.LRN_CACHE_AUTO_BYTES + 1,
                                           None)
    assert stem.resolve_lrn_cache_auto(1 << 40, True)
    assert not stem.resolve_lrn_cache_auto(1, False)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_bias_relu_backward_matches_jax_vjp(dtype):
    shape = (2, 5, 4, 64)
    x = _rand(shape, 10)
    b = _rand((64,), 12, scale=0.5)
    x[0, 0, 0, :8] = -b[:8]  # x + b == 0: the strict mask drops them
    g = _rand(shape, 13)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    if dtype == "bf16":
        x, g = _bf16_round(x), _bf16_round(g)
    _, vjp = jax.vjp(ps.fused_bias_relu, jnp.asarray(x, jdt), jnp.asarray(b))
    dx_j, db_j = vjp(jnp.asarray(g, jdt))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    stem.fused_bias_relu(xt, bt).backward(torch.from_numpy(g).to(tdt))
    np.testing.assert_array_equal(xt.grad.float().numpy(),
                                  np.asarray(dx_j.astype(jnp.float32)))
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(db_j), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 8, 8, 64), (1, 7, 9, 64),
                                   (2, 12, 11, 32)])
def test_bias_relu_pool_backward_matches_jax_vjp(shape):
    x, b, = _rand(shape, 14), _rand(shape[-1:], 15, scale=0.5)
    _, vjp = jax.vjp(ps.fused_bias_relu_pool, jnp.asarray(x), jnp.asarray(b))
    out = ps.fused_bias_relu_pool(jnp.asarray(x), jnp.asarray(b))
    g = _rand(out.shape, 16)
    dx_j, db_j = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    stem.fused_bias_relu_pool(xt, bt).backward(torch.from_numpy(g))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(dx_j))
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(db_j), rtol=1e-6,
                               atol=1e-6)


def test_bias_relu_pool_bf16_ties_send_the_gradient_to_one_tap():
    """bf16 values on a coarse grid tie within pool windows; XLA's
    reduce_window VJP routes each window's gradient to ONE maximal tap,
    and so must the port (``torch.maximum`` taps would split it)."""
    rng = np.random.default_rng(17)
    x = (np.round(rng.standard_normal((2, 9, 7, 64)) * 2) / 2).astype(
        np.float32)
    b = np.zeros(64, np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    out, vjp = jax.vjp(ps.fused_bias_relu_pool, xb, jnp.asarray(b))
    g = _bf16_round(rng.standard_normal(out.shape).astype(np.float32))
    dx_j, db_j = vjp(jnp.asarray(g, jnp.bfloat16))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    stem.fused_bias_relu_pool(xt, bt).backward(
        torch.from_numpy(g).to(torch.bfloat16))
    np.testing.assert_array_equal(xt.grad.float().numpy(),
                                  np.asarray(dx_j.astype(jnp.float32)))
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(db_j), rtol=1e-6,
                               atol=1e-6)
    # The tie rule is real here: differentiating the plain version's
    # chain of torch.maximum taps would give another dx.
    xs = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    stem.bias_relu_pool_plain(xs, torch.from_numpy(b)).backward(
        torch.from_numpy(g).to(torch.bfloat16))
    assert not torch.equal(xs.grad, xt.grad)


@pytest.mark.parametrize("fuse_pool", [None, (3, 2)])
def test_fused_epilogue_gives_conv_gradients(fuse_pool):
    """The slice-1 fault: the fused epilogue's output carried no grad_fn,
    so conv1/conv2_reduce/conv2 got no gradient.  Through the Functions
    the fused block's weight, bias and input gradients equal the unfused
    block's (+ the pool the caller would add)."""
    from npairloss_tpu_torch.models.layers import max_pool

    torch.manual_seed(0)
    fused = ConvBlock(8, 16, (3, 3), fused_epilogue=True, fuse_pool=fuse_pool)
    plain = ConvBlock(8, 16, (3, 3))
    plain.load_state_dict(fused.state_dict())
    x = torch.randn(2, 9, 9, 8)
    xf, xp = x.clone().requires_grad_(), x.clone().requires_grad_()
    yf = fused(xf)
    yp = plain(xp)
    if fuse_pool is not None:
        yp = max_pool(yp, *fuse_pool)
    assert yf.grad_fn is not None
    g = torch.randn(yf.shape)
    yf.backward(g)
    yp.backward(g)
    for pf, pp in ((fused.Conv_0.weight, plain.Conv_0.weight),
                   (fused.Conv_0.bias, plain.Conv_0.bias)):
        assert pf.grad is not None and bool((pf.grad != 0).any())
        np.testing.assert_allclose(pf.grad.numpy(), pp.grad.numpy(),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xf.grad.numpy(), xp.grad.numpy(), rtol=1e-5,
                               atol=1e-6)
