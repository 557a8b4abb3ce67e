"""GoogLeNet stem kernels: LRN forward and backward (with the denominator
cache), bias + ReLU, bias + ReLU + pool.

Port of ``npairloss_tpu/ops/pallas_stem.py``.  Two layers:

* Kernel wrappers (``lrn_fwd``, ``lrn_fwd_cached``, ``lrn_bwd``,
  ``lrn_bwd_cached`` and the forward launches inside ``fused_bias_relu``
  and ``fused_bias_relu_pool``): on a CPU tensor they run the plain
  PyTorch version beside them, on a CUDA tensor they launch the
  hand-written kernel in ``csrc/stem.cu`` or raise — never a fallback.
  Each carries a ``launches`` counter, bumped where its kernel launches.
* The differentiable ops ``fused_lrn``, ``fused_bias_relu`` and
  ``fused_bias_relu_pool``: ``torch.autograd.Function``s (the JAX
  ``custom_vjp``s) whose forward and backward call the wrappers above,
  so the CPU tests run the same Functions the card runs.

All tensors are NHWC (channels last), as in the JAX package.  The plain
versions repeat the kernels' arithmetic (fp32 math, one rounding to the
input's type on the store, the same window-sum order, no fused
multiply-add), so the CPU tests hold them against the JAX package and
``chip_smoke.py`` holds the kernels against them on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from npairloss_tpu_torch.obs.perf.count import priced
from npairloss_tpu_torch.ops._build import (
    bump,
    check,
    counted,
    library,
    stream_ptr,
)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# fp32 bytes of the LRN denominator below which a grad-enabled forward
# caches it for the backward (``cache=None``).  The port budgets its own
# unpadded ``d`` (``x.numel() * 4``); the JAX package budgets the TPU's
# 128-lane padded tensor.  The cached and recompute paths give the same
# bits, so where the switch sits changes no result, only memory and time.
# Read at every call: setting it to 0 forces the recompute backward.
LRN_CACHE_AUTO_BYTES = 2 << 30

_LRN_MAX_C = 8192       # the forward kernels' channel tile
_LRN_BWD_MAX_C = 4096   # the backward kernels stage two fp32 tiles


def _f32(v: float) -> float:
    """A Python float holding ``v`` rounded to fp32 (the kernels' and the
    JAX reference's scalar precision)."""
    return float(np.float32(v))


def same_pads(n: int, window: int, stride: int) -> Tuple[int, int, int]:
    """(out, pad_lo, pad_hi) of XLA SAME padding on an axis of size n —
    asymmetric: the extra pad goes high."""
    out = -(-n // stride)
    total = max((out - 1) * stride + window - n, 0)
    return out, total // 2, total - total // 2


def _check_cuda(what: str, x: torch.Tensor, *others: torch.Tensor) -> int:
    """Validate a kernel operand; returns its dtype code."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: expected a CPU or CUDA tensor, "
                         f"got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {x.dtype} not supported "
                        "(float32 or bfloat16)")
    if not x.is_contiguous():
        raise ValueError(f"{what}: input must be contiguous (NHWC)")
    for o in others:
        if o.device != x.device:
            raise ValueError(f"{what}: operands on {o.device} and {x.device}")
    return _DTYPES[x.dtype]


def _check_same(what: str, x: torch.Tensor, *others: torch.Tensor) -> None:
    for o in others:
        if o.shape != x.shape or not o.is_contiguous():
            raise ValueError(f"{what}: operand of shape {tuple(o.shape)} "
                             f"must be contiguous and match {tuple(x.shape)}")


def _bias_f32(bias: torch.Tensor, c: int, device) -> torch.Tensor:
    if bias.shape != (c,):
        raise ValueError(f"bias shape {tuple(bias.shape)} != ({c},)")
    return bias.to(device=device, dtype=torch.float32).contiguous()


# -- LRN: plain versions --------------------------------------------------------


def _win_sum(v: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Channel-window sum with zero fill, ``out[..., i] = sum_{o=-lo..hi}
    v[..., i+o]``, lowest offset first (the Pallas ``_win_sum`` order)."""
    c = v.shape[-1]
    vp = F.pad(v, (lo, hi))
    out = vp[..., 0:c]
    for o in range(1, lo + hi + 1):
        out = out + vp[..., o:o + c]
    return out


def _denominator(xf: torch.Tensor, size: int, alpha: float,
                 k: float) -> torch.Tensor:
    """fp32 ``d = k + alpha/size * W(x^2)``, lo = size//2,
    hi = size-1-size//2."""
    win = _win_sum(xf * xf, size // 2, size - 1 - size // 2)
    return _f32(k) + _f32(alpha / size) * win


def _pow_neg_beta(d: torch.Tensor, beta: float) -> torch.Tensor:
    if beta == 0.75:
        r = torch.sqrt(torch.rsqrt(d))
        return r * r * r
    return torch.exp(_f32(-beta) * torch.log(d))


def lrn_plain(x: torch.Tensor, size: int = 5, alpha: float = 1e-4,
              beta: float = 0.75, k: float = 1.0) -> torch.Tensor:
    """Caffe across-channel LRN over the last axis: ``x * (k + alpha/size
    * W(x^2))^-beta``."""
    return lrn_fwd_cached_plain(x, size, alpha, beta, k)[0]


def lrn_fwd_cached_plain(x: torch.Tensor, size: int = 5, alpha: float = 1e-4,
                         beta: float = 0.75, k: float = 1.0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(LRN output in x's type, fp32 denominator d)."""
    xf = x.float()
    d = _denominator(xf, size, alpha, k)
    return (xf * _pow_neg_beta(d, beta)).to(x.dtype), d


def lrn_bwd_plain(x: torch.Tensor, g: torch.Tensor,
                  d: Optional[torch.Tensor] = None, size: int = 5,
                  alpha: float = 1e-4, beta: float = 0.75,
                  k: float = 1.0) -> torch.Tensor:
    """Analytic LRN dx (pallas_stem.py:136-162): with f = d^-beta,
    ``dx = g f - (2 alpha beta / size) x W^T(g x f / d)``, W^T the window
    with lo and hi swapped.  ``d=None`` recomputes the denominator with
    the forward's own function, so both ways give the same bits."""
    xf = x.float()
    gf = g.to(x.dtype).float()
    if d is None:
        d = _denominator(xf, size, alpha, k)
    f = _pow_neg_beta(d, beta)
    t = _win_sum(gf * xf * (f / d), size - 1 - size // 2, size // 2)
    return (gf * f - _f32(2.0 * alpha / size * beta) * xf * t).to(x.dtype)


# -- LRN: kernel wrappers -------------------------------------------------------


# FLOP and byte formulas of the kernels (``obs.perf.count``), per
# element of x: the LRN forward squares (1), sums the window (size),
# scales and adds k (2) and multiplies by the power (1); the backward
# recomputes that denominator unless it is cached, weights g (2), sums
# the window again (size) and combines (3).  Bytes: each input read
# once, each output written once.


def _lrn_fwd_cost(x, size=5, *a, cached=False, **kw):
    n = x.numel()
    return n * (int(size) + 4), n * 2 * x.element_size() + cached * n * 4


def _lrn_fwd_cached_cost(x, size=5, *a, **kw):
    return _lrn_fwd_cost(x, size, cached=True)


def _lrn_bwd_cost(x, g, size=5, *a, **kw):
    n = x.numel()
    return n * (2 * int(size) + 9), n * 3 * x.element_size()


def _lrn_bwd_cached_cost(x, g, d, size=5, *a, **kw):
    n = x.numel()
    return n * (int(size) + 5), n * (3 * x.element_size() + 4)


def _bias_relu_cost(x, bias):
    n = x.numel()
    return 2 * n, 2 * n * x.element_size() + bias.numel() * 4


def _bias_relu_pool_cost(x, bias, window, stride):
    n, h, w, c = (int(v) for v in x.shape)
    ho = -(-h // int(stride))
    wo = -(-w // int(stride))
    out = n * ho * wo * c
    return (2 * x.numel() + out * int(window) ** 2,
            (x.numel() + out) * x.element_size() + c * 4)


def _lrn_rows(what: str, x: torch.Tensor, max_c: int) -> Tuple[int, int]:
    c = int(x.shape[-1])
    if c > max_c:
        raise ValueError(f"{what}: {c} channels exceed the kernel's "
                         f"{max_c}-channel tile")
    return x.numel() // max(c, 1), c


@counted
@priced("lrn_fwd", _lrn_fwd_cost)
def lrn_fwd(x: torch.Tensor, size: int = 5, alpha: float = 1e-4,
            beta: float = 0.75, k: float = 1.0) -> torch.Tensor:
    """The uncached LRN forward kernel (primal and no-grad forwards)."""
    if x.device.type == "cpu":
        return lrn_plain(x, size, alpha, beta, k)
    code = _check_cuda("lrn_fwd", x)
    rows, c = _lrn_rows("lrn_fwd", x, _LRN_MAX_C)
    out = torch.empty_like(x)
    err = library().npl_lrn_fwd(
        x.data_ptr(), out.data_ptr(), rows, c, int(size),
        _f32(alpha / size), float(beta), float(k), code,
        stream_ptr(x.device))
    check(err, "lrn_fwd")
    bump(lrn_fwd)
    return out


@counted
@priced("lrn_fwd_cached", _lrn_fwd_cached_cost)
def lrn_fwd_cached(x: torch.Tensor, size: int = 5, alpha: float = 1e-4,
                   beta: float = 0.75, k: float = 1.0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """LRN forward that also returns the fp32 denominator d."""
    if x.device.type == "cpu":
        return lrn_fwd_cached_plain(x, size, alpha, beta, k)
    code = _check_cuda("lrn_fwd_cached", x)
    rows, c = _lrn_rows("lrn_fwd_cached", x, _LRN_MAX_C)
    out = torch.empty_like(x)
    d = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    err = library().npl_lrn_fwd_cached(
        x.data_ptr(), out.data_ptr(), d.data_ptr(), rows, c, int(size),
        _f32(alpha / size), float(beta), float(k), code,
        stream_ptr(x.device))
    check(err, "lrn_fwd_cached")
    bump(lrn_fwd_cached)
    return out, d


def _launch_lrn_bwd(what: str, x, g, d, size, alpha, beta, k):
    code = _check_cuda(what, x, g, *(() if d is None else (d,)))
    _check_same(what, x, g, *(() if d is None else (d,)))
    if g.dtype != x.dtype or (d is not None and d.dtype != torch.float32):
        raise TypeError(f"{what}: g must be {x.dtype} and d float32")
    rows, c = _lrn_rows(what, x, _LRN_BWD_MAX_C)
    dx = torch.empty_like(x)
    err = library().npl_lrn_bwd(
        x.data_ptr(), g.data_ptr(), None if d is None else d.data_ptr(),
        dx.data_ptr(), rows, c, int(size), _f32(alpha / size), float(beta),
        float(k), _f32(2.0 * alpha / size * beta), code, stream_ptr(x.device))
    check(err, what)
    return dx


@counted
@priced("lrn_bwd", _lrn_bwd_cost)
def lrn_bwd(x: torch.Tensor, g: torch.Tensor, size: int = 5,
            alpha: float = 1e-4, beta: float = 0.75,
            k: float = 1.0) -> torch.Tensor:
    """LRN dx from (x, g), recomputing the denominator."""
    if x.device.type == "cpu":
        return lrn_bwd_plain(x, g, None, size, alpha, beta, k)
    dx = _launch_lrn_bwd("lrn_bwd", x, g, None, size, alpha, beta, k)
    bump(lrn_bwd)
    return dx


@counted
@priced("lrn_bwd_cached", _lrn_bwd_cached_cost)
def lrn_bwd_cached(x: torch.Tensor, g: torch.Tensor, d: torch.Tensor,
                   size: int = 5, alpha: float = 1e-4, beta: float = 0.75,
                   k: float = 1.0) -> torch.Tensor:
    """LRN dx from (x, g) and the forward's cached denominator d."""
    if x.device.type == "cpu":
        return lrn_bwd_plain(x, g, d, size, alpha, beta, k)
    dx = _launch_lrn_bwd("lrn_bwd_cached", x, g, d, size, alpha, beta, k)
    bump(lrn_bwd_cached)
    return dx


# -- LRN: the differentiable op --------------------------------------------------


def resolve_lrn_cache_auto(nbytes: int, cache: Optional[bool]) -> bool:
    """Explicit ``cache`` wins; None = cache when the fp32 denominator
    fits ``LRN_CACHE_AUTO_BYTES``."""
    if cache is not None:
        return bool(cache)
    return nbytes <= LRN_CACHE_AUTO_BYTES


class _LRN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, size, alpha, beta, k, cached):
        ctx.params = (size, alpha, beta, k)
        if cached:
            out, d = lrn_fwd_cached(x, size, alpha, beta, k)
            ctx.save_for_backward(x, d)
        else:
            out = lrn_fwd(x, size, alpha, beta, k)
            ctx.save_for_backward(x)
        return out

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        x = saved[0]
        g = g.to(x.dtype).contiguous()
        if len(saved) == 2:
            dx = lrn_bwd_cached(x, g, saved[1], *ctx.params)
        else:
            dx = lrn_bwd(x, g, *ctx.params)
        return dx, None, None, None, None, None


def fused_lrn(x: torch.Tensor, size: int = 5, alpha: float = 1e-4,
              beta: float = 0.75, k: float = 1.0,
              cache: Optional[bool] = None) -> torch.Tensor:
    """Across-channel LRN (NHWC), differentiable.  A forward that records
    no graph (``no_grad``, or an input that needs no grad) launches the
    uncached kernel, as the JAX primal does (pallas_stem.py:244-250).
    With a graph, ``cache`` (None = auto by ``LRN_CACHE_AUTO_BYTES``)
    picks the cached forward + ``lrn_bwd_cached`` or the uncached forward
    + the recomputing ``lrn_bwd``, which saves only x."""
    x = x.contiguous()
    if not (torch.is_grad_enabled() and x.requires_grad):
        return lrn_fwd(x, size, alpha, beta, k)
    cached = resolve_lrn_cache_auto(x.numel() * 4, cache)
    return _LRN.apply(x, int(size), float(alpha), float(beta), float(k),
                      cached)


# -- bias + ReLU --------------------------------------------------------------


def bias_relu_plain(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    y = x.float() + bias.float()
    return torch.clamp_min(y, 0.0).to(x.dtype)


@priced("fused_bias_relu", _bias_relu_cost)
def _bias_relu_fwd(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return bias_relu_plain(x, bias)
    code = _check_cuda("fused_bias_relu", x, bias)
    c = int(x.shape[-1])
    b = _bias_f32(bias, c, x.device)
    out = torch.empty_like(x)
    lib = library()
    vector = ctypes.c_int()
    check(lib.npl_bias_relu_path(x.data_ptr(), out.data_ptr(), x.numel(), c,
                                 code, ctypes.byref(vector)),
          "fused_bias_relu")
    err = lib.npl_bias_relu(
        x.data_ptr(), b.data_ptr(), out.data_ptr(), x.numel(), c, code,
        stream_ptr(x.device))
    check(err, "fused_bias_relu")
    bump(fused_bias_relu)
    if not vector.value:
        bump(fused_bias_relu, "scalar_launches")
    return out


class _BiasReLU(torch.autograd.Function):
    """Backward as the JAX VJP (pallas_stem.py:343-355): the output's
    sign is the mask (strict ``> 0``), db summed in fp32 and cast to the
    bias's type."""

    @staticmethod
    def forward(ctx, x, bias):
        out = _bias_relu_fwd(x, bias)
        ctx.save_for_backward(out)
        ctx.bias_dtype = bias.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        dx = torch.where(out > 0, g, torch.zeros((), dtype=g.dtype,
                                                 device=g.device))
        db = dx.float().sum(dim=tuple(range(g.dim() - 1)))
        return dx, db.to(ctx.bias_dtype)


@counted
def fused_bias_relu(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Conv epilogue ``relu(x + bias)``, bias broadcast over the last
    axis, fp32 math stored in x's type; differentiable.  ``launches``
    counts its forward kernel, ``scalar_launches`` the launches of those
    that took the kernel's scalar path (C not a multiple of the 16-byte
    vector, or operands off 16-byte alignment)."""
    return _BiasReLU.apply(x.contiguous(), bias)


fused_bias_relu.scalar_launches = 0


# -- bias + ReLU + max-pool ---------------------------------------------------


def bias_relu_pool_plain(x: torch.Tensor, bias: torch.Tensor,
                         window: int = 3, stride: int = 2) -> torch.Tensor:
    """``max_pool(relu(x + bias))`` with SAME padding (NHWC).  Zero fill
    is exact after the ReLU: every SAME window holds a real tap >= 0."""
    _, h, w, _ = x.shape
    ho, ph_lo, ph_hi = same_pads(h, window, stride)
    wo, pw_lo, pw_hi = same_pads(w, window, stride)
    y = torch.clamp_min(x.float() + bias.float(), 0.0)
    yp = F.pad(y, (0, 0, pw_lo, pw_hi, ph_lo, ph_hi))
    m = None
    for di in range(window):
        for dj in range(window):
            tap = yp[:, di:di + (ho - 1) * stride + 1:stride,
                     dj:dj + (wo - 1) * stride + 1:stride, :]
            m = tap if m is None else torch.maximum(m, tap)
    return m.to(x.dtype)


def bias_relu_pool_reference(x: torch.Tensor, bias: torch.Tensor,
                             window: int = 3, stride: int = 2
                             ) -> torch.Tensor:
    """The backward's recompute, differentiable as XLA's reference
    (pallas_stem.py:406-413): ``maximum(x + bias, 0)`` (a tie at 0 splits
    the gradient, as ``jnp.maximum`` does) and a -inf padded max-pool
    whose gradient goes to the first maximal tap of each window
    (``F.max_pool2d`` and XLA's select-and-scatter agree)."""
    _, h, w, _ = x.shape
    _, ph_lo, ph_hi = same_pads(h, window, stride)
    _, pw_lo, pw_hi = same_pads(w, window, stride)
    y = x.float() + bias.float()
    y = torch.maximum(y, torch.zeros((), dtype=y.dtype, device=y.device))
    yp = F.pad(y, (0, 0, pw_lo, pw_hi, ph_lo, ph_hi), value=float("-inf"))
    out = F.max_pool2d(yp.permute(0, 3, 1, 2), window, stride)
    return out.permute(0, 2, 3, 1).to(x.dtype)


@priced("fused_bias_relu_pool", _bias_relu_pool_cost)
def _bias_relu_pool_fwd(x, bias, window, stride):
    if x.device.type == "cpu":
        return bias_relu_pool_plain(x, bias, window, stride)
    code = _check_cuda("fused_bias_relu_pool", x, bias)
    if x.dim() != 4:
        raise ValueError(f"fused_bias_relu_pool: expected NHWC, got "
                         f"{tuple(x.shape)}")
    n, h, w, c = (int(s) for s in x.shape)
    ho, ph, _ = same_pads(h, window, stride)
    wo, pw, _ = same_pads(w, window, stride)
    b = _bias_f32(bias, c, x.device)
    out = torch.empty((n, ho, wo, c), dtype=x.dtype, device=x.device)
    err = library().npl_bias_relu_pool(
        x.data_ptr(), b.data_ptr(), out.data_ptr(), n, h, w, c, ho, wo,
        int(window), int(stride), ph, pw, code, stream_ptr(x.device))
    check(err, "fused_bias_relu_pool")
    bump(fused_bias_relu_pool)
    return out


class _BiasReLUPool(torch.autograd.Function):
    """Backward: one recompute through ``bias_relu_pool_reference`` and
    its autograd, as the JAX VJP recomputes through XLA
    (pallas_stem.py:446-458) — not through the plain version's chain of
    ``torch.maximum`` taps, which would split a tied window's gradient."""

    @staticmethod
    def forward(ctx, x, bias, window, stride):
        ctx.save_for_backward(x, bias)
        ctx.geom = (window, stride)
        return _bias_relu_pool_fwd(x, bias, window, stride)

    @staticmethod
    def backward(ctx, g):
        x, bias = ctx.saved_tensors
        with torch.enable_grad():
            xr = x.detach().requires_grad_()
            br = bias.detach().requires_grad_()
            out = bias_relu_pool_reference(xr, br, *ctx.geom)
            dx, db = torch.autograd.grad(out, (xr, br), g)
        return dx, db.to(bias.dtype), None, None


@counted
def fused_bias_relu_pool(x: torch.Tensor, bias: torch.Tensor,
                         window: int = 3, stride: int = 2) -> torch.Tensor:
    """Stem epilogue ``max_pool(relu(x + bias))`` (SAME, NHWC) in one
    pass — the pre-pool activation never reaches device memory;
    differentiable.  ``launches`` counts its forward kernel."""
    return _BiasReLUPool.apply(x.contiguous(), bias, int(window),
                               int(stride))
