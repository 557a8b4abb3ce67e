"""The port's stem kernels (npairloss_tpu_torch/ops/stem.py) against the
JAX package: the Pallas kernels of ops/pallas_stem.py (interpret mode on
the CPU) and the XLA references.  On CPU tensors the port's wrappers run
their plain versions, which repeat the CUDA kernels' arithmetic.

Tolerance: fp32 results within 1e-6 relative (and 1e-7 absolute for
values near zero) — the same math in another order at most; bf16 results
within one bf16 ulp (2^-8 relative) of the JAX kernel's, since both round
one fp32 value once.
"""

import importlib.util
import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npairloss_tpu.models.layers import local_response_norm
from npairloss_tpu.ops import pallas_stem as ps
from npairloss_tpu_torch.ops import stem

RTOL, ATOL = 1e-6, 1e-7
BF16_RTOL = 2.0 ** -8

# C in {64, 192, 200}; rows below (15, 98) and above (288, 300) the
# Pallas kernel's 256-row block.
LRN_SHAPES = [
    (1, 5, 3, 64),
    (2, 7, 7, 192),
    (2, 12, 12, 192),
    (3, 10, 10, 200),
]


def _rand(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _port(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.mark.parametrize("shape", LRN_SHAPES)
def test_lrn_matches_pallas_and_xla(shape):
    x = _rand(shape, seed=1, scale=3.0)
    got = stem.fused_lrn(_port(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(ps.fused_lrn(jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        got, np.asarray(local_response_norm(jnp.asarray(x))),
        rtol=RTOL, atol=ATOL)


def test_lrn_generic_beta_and_params():
    """beta != 0.75 takes exp(-beta*log d) in the kernel."""
    x = _rand((2, 4, 4, 200), seed=2, scale=4.0)
    kw = dict(size=3, alpha=2e-3, beta=0.5, k=2.0)
    got = stem.fused_lrn(_port(x), **kw).numpy()
    np.testing.assert_allclose(
        got, np.asarray(ps.fused_lrn(jnp.asarray(x), **kw)),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        got, np.asarray(local_response_norm(jnp.asarray(x), **kw)),
        rtol=RTOL, atol=ATOL)


def test_lrn_bf16_round_trip():
    x = _rand((2, 9, 9, 192), seed=3, scale=8.0)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(ps.fused_lrn(xb).astype(jnp.float32))
    got_t = stem.fused_lrn(_port(np.asarray(xb.astype(jnp.float32)))
                           .to(torch.bfloat16))
    assert got_t.dtype == torch.bfloat16
    np.testing.assert_allclose(got_t.float().numpy(), want,
                               rtol=BF16_RTOL, atol=0)


@pytest.mark.parametrize("shape", [(2, 6, 6, 64), (1, 17, 18, 192),
                                   (3, 5, 4, 200)])
def test_bias_relu_matches_pallas(shape):
    x = _rand(shape, seed=4)
    b = _rand(shape[-1:], seed=5, scale=0.5)
    got = stem.fused_bias_relu(_port(x), _port(b)).numpy()
    want = np.asarray(ps.fused_bias_relu(jnp.asarray(x), jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.maximum(x + b, 0.0))


def test_bias_relu_bf16_round_trip():
    xb = jnp.asarray(_rand((2, 7, 7, 64), seed=6, scale=4.0), jnp.bfloat16)
    b = _rand((64,), seed=7)
    want = np.asarray(ps.fused_bias_relu(xb, jnp.asarray(b))
                      .astype(jnp.float32))
    got = stem.fused_bias_relu(
        _port(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16),
        _port(b))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("shape", [(2, 8, 8, 64), (1, 7, 9, 64),
                                   (2, 5, 5, 192), (1, 14, 13, 200)])
def test_bias_relu_pool_matches_pallas_and_xla(shape):
    """Odd H/W exercise the asymmetric SAME pads."""
    x = _rand(shape, seed=8)
    b = _rand(shape[-1:], seed=9, scale=0.5)
    got = stem.fused_bias_relu_pool(_port(x), _port(b)).numpy()
    want = np.asarray(ps.fused_bias_relu_pool(jnp.asarray(x), jnp.asarray(b)))
    ref = np.asarray(ps._reference_bias_relu_pool(
        jnp.asarray(x), jnp.asarray(b), 3, 2))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref)


def test_bias_relu_pool_bf16_round_trip():
    xb = jnp.asarray(_rand((2, 9, 7, 64), seed=10, scale=3.0), jnp.bfloat16)
    b = _rand((64,), seed=11)
    want = np.asarray(ps.fused_bias_relu_pool(xb, jnp.asarray(b))
                      .astype(jnp.float32))
    got = stem.fused_bias_relu_pool(
        _port(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16),
        _port(b))
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_bias_relu_ops_keep_nan_as_jax_does(dtype):
    """Planted NaN pre-activations stay NaN through the ReLU and the
    pool's max, as ``jnp.maximum`` keeps them: the plain versions (which
    the kernels must equal on the card) against the Pallas kernels."""
    x = _rand((1, 7, 9, 64), seed=12)
    x[0, 0, 0, 3] = x[0, 3, 4, 10] = x[0, 6, 8, 63] = np.nan
    b = _rand((64,), seed=13, scale=0.5)
    xj = jnp.asarray(x).astype(dtype)
    xt = _port(np.asarray(xj.astype(jnp.float32))).to(
        torch.float32 if dtype is np.float32 else torch.bfloat16)
    for plain, pallas in ((stem.bias_relu_plain, ps.fused_bias_relu),
                          (stem.bias_relu_pool_plain,
                           ps.fused_bias_relu_pool)):
        got = plain(xt, _port(b)).float().numpy()
        want = np.asarray(pallas(xj, jnp.asarray(b), interpret=True)
                          .astype(jnp.float32))
        assert np.isnan(want).sum() >= 3
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 3, 5, 3), (2, 5, 7, 64),
                                   (1, 7, 9, 192)])
def test_bias_relu_plain_is_the_pallas_kernels_bits(shape, dtype):
    """``bias_relu_plain`` (what the card's kernel must equal bit for bit,
    on its vector path and its scalar path) against the Pallas kernel in
    interpret mode: C = 3 (the scalar path's odd C, with an odd element
    count), 64 and 192, NaN planted, bit for bit."""
    x = _rand(shape, seed=16, scale=2.0)
    flat = x.reshape(-1)
    flat[::7] = np.nan
    b = _rand(shape[-1:], seed=17, scale=0.5)
    xj = jnp.asarray(x).astype(dtype)
    xt = _port(np.asarray(xj.astype(jnp.float32))).to(
        torch.float32 if dtype is np.float32 else torch.bfloat16)
    got = stem.bias_relu_plain(xt, _port(b))
    want = np.asarray(ps.fused_bias_relu(xj, jnp.asarray(b), interpret=True))
    assert got.dtype == xt.dtype and np.isnan(want.astype(np.float32)).any()
    if dtype is np.float32:
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      want.view(np.uint32))
    else:  # bf16 bits, NaN positions compared as NaN
        np.testing.assert_array_equal(got.float().numpy(),
                                      want.astype(np.float32))


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_pool_check_compares_nan_positions():
    """chip_smoke.py holds the pool kernel to the plain version's bits,
    NaN positions included: its comparison accepts the plain version and
    rejects a pool that drops NaN (the fault of fmaxf) or moves a value."""
    cs = _chip_smoke()
    a = torch.tensor([1.0, float("nan"), 0.0])
    assert cs.same_nan_and_bits(torch, a, a.clone())
    assert cs.same_nan_and_bits(torch, a, torch.tensor(
        [1.0, float("nan"), -0.0]))
    for other in ([1.0, 0.0, 0.0], [1.0, float("nan"), float("nan")],
                  [1.5, float("nan"), 0.0]):
        assert not cs.same_nan_and_bits(torch, a, torch.tensor(other))
    x = torch.from_numpy(_rand((2, 7, 9, 64), seed=14))
    b = torch.from_numpy(_rand((64,), seed=15))
    for window in (3, 7):
        assert cs.pool_matches_plain(torch, stem, x, b, nan_step=97,
                                     window=window)

    def drops_nan(t, bias, window=3, stride=2):
        return stem.bias_relu_pool_plain(t.nan_to_num(0.0), bias, window,
                                         stride)

    fault = types.SimpleNamespace(
        fused_bias_relu_pool=drops_nan,
        bias_relu_pool_plain=stem.bias_relu_pool_plain)
    assert not cs.pool_matches_plain(torch, fault, x, b, nan_step=97)


def test_chip_smoke_bias_relu_check_compares_bits_and_nan_positions():
    """chip_smoke.py's bias+ReLU check accepts the plain version (on the
    CPU: the wrapper itself) with NaN planted, keeping an operand's
    storage offset, and rejects a kernel that drops NaN or rounds."""
    cs = _chip_smoke()
    buf = torch.from_numpy(_rand((2 * 7 * 9 * 3 + 1,), seed=18))
    x = buf[1:].view(2, 7, 9, 3)  # one element off 16-byte alignment
    assert cs.with_nans(x, 5).storage_offset() == 1
    b = torch.from_numpy(_rand((3,), seed=19))
    same, counts = cs.bias_relu_matches_plain(torch, stem, x, b, nan_step=5)
    assert same and counts == {"launches": 0, "scalar_launches": 0}

    def fake(kernel):
        kernel.launches = kernel.scalar_launches = 0
        return types.SimpleNamespace(fused_bias_relu=kernel,
                                     bias_relu_plain=stem.bias_relu_plain)

    for wrong in (lambda t, bias: stem.bias_relu_plain(t.nan_to_num(0.0),
                                                       bias),
                  lambda t, bias: stem.bias_relu_plain(t, bias) * (1 + 1e-6)):
        assert not cs.bias_relu_matches_plain(torch, fake(wrong), x, b,
                                              nan_step=5)[0]


def test_chip_smoke_profile_counts_every_stem_kernel():
    """Every kernel of csrc/stem.cu falls in chip_smoke's stem category of
    a step's profile (a kernel that it misses is counted as elementwise
    glue, and the stem's time per step reads short); the blockwise
    kernels fall in theirs, PyTorch's pooling in pooling."""
    cs = _chip_smoke()
    src = (Path(stem.__file__).resolve().parents[1] / "csrc" / "stem.cu"
           ).read_text()
    names = set(re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\(\d+\)\s+)?(\w+)\(",
        src))
    assert {"lrn_fwd_vec_kernel", "lrn_bwd_vec_kernel", "bias_relu_kernel",
            "bias_relu_vec_kernel", "bias_relu_pool3s2_kernel"} <= names
    for name in names:
        assert cs.step_category(f"void {name}<float, true>(float const*)") \
            == "stem kernels (csrc/stem.cu)", name
    assert cs.step_category("void npair_stats_kernel<8>()") == \
        "blockwise kernels (csrc/npair_blockwise.cu)"
    assert cs.step_category("round_bf16_kernel(float const*, float*)") == \
        "blockwise kernels (csrc/npair_blockwise.cu)"
    assert cs.step_category("void at::native::reduce_kernel<128, 4>") == \
        "torch elementwise and reductions"
    assert cs.step_category("void at::native::max_pool_forward_nhwc") == \
        "pooling"


@pytest.mark.parametrize("n,window,stride", [(112, 3, 2), (56, 3, 2),
                                             (7, 3, 2), (14, 3, 1),
                                             (224, 7, 2)])
def test_same_pads_match_jax(n, window, stride):
    assert stem.same_pads(n, window, stride) == ps._same_pads(
        n, window, stride)


def test_stem_pads_at_the_path_shapes():
    """112 -> 56 pools with (0, 1): the asymmetric pad of the trap list."""
    assert stem.same_pads(112, 3, 2) == (56, 0, 1)


# C = 100 and C = 8: on the card, C = 100 takes the LRN forward's scalar
# path in bf16 (not a multiple of the 8-wide vector) and C = 8 its vector
# path at a narrow row (one vector a row); here the plain versions both
# paths are held to, against the Pallas forward kernels (out, and the
# cached kernel's d).
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 7, 9, 100), (3, 5, 6, 8)])
def test_lrn_forward_plain_versions_match_pallas(shape, dtype):
    x = _rand(shape, seed=7, scale=6.0)
    xj = jnp.asarray(x, dtype)
    xt = _port(np.asarray(xj.astype(jnp.float32)))
    if dtype != np.float32:
        xt = xt.to(torch.bfloat16)
    rows, c = int(np.prod(shape[:-1])), shape[-1]
    p = ps._LRNParams(size=5, alpha=1e-4, beta=0.75, k=1.0, cached=True,
                      interpret=True)
    want, d2 = ps._fused_lrn_fwd_impl(xj, p)
    want = np.asarray(want.astype(jnp.float32))
    want_d = np.asarray(d2)[:rows, :c].reshape(shape)
    out, d = stem.lrn_fwd_cached_plain(xt)
    rtol = RTOL if dtype == np.float32 else BF16_RTOL
    np.testing.assert_allclose(out.float().numpy(), want, rtol=rtol,
                               atol=ATOL)
    np.testing.assert_allclose(d.numpy(), want_d, rtol=RTOL, atol=0)
    assert torch.equal(stem.lrn_plain(xt), out)
    # The CPU wrappers run these plain versions.
    assert torch.equal(stem.lrn_fwd(xt), out)
    o2, d_w = stem.lrn_fwd_cached(xt)
    assert torch.equal(o2, out) and torch.equal(d_w, d)
