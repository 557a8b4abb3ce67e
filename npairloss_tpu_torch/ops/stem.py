"""GoogLeNet stem kernels: LRN forward, bias + ReLU, bias + ReLU + pool.

Port of ``npairloss_tpu/ops/pallas_stem.py`` (forward kernels only; the
LRN backward and its denominator cache belong to the training slice).
Each public function is the kernel's wrapper: on a CPU tensor it runs
the plain PyTorch version beside it, on a CUDA tensor it launches the
hand-written kernel in ``csrc/stem.cu`` or raises — it never falls back.
All tensors are NHWC (channels last), as in the JAX package.

The plain versions repeat the kernels' arithmetic (fp32 math, one
rounding to the input's type on the store, the same window-sum order),
so the CPU tests hold them against the JAX package and ``chip_smoke.py``
holds the kernels against them on the card.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from npairloss_tpu_torch.ops._build import check, counted, library, stream_ptr

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def _bias_f32(bias: torch.Tensor, c: int, device) -> torch.Tensor:
    if bias.shape != (c,):
        raise ValueError(f"bias shape {tuple(bias.shape)} != ({c},)")
    return bias.to(device=device, dtype=torch.float32).contiguous()


# -- LRN ----------------------------------------------------------------------


def _pow_neg_beta(d: torch.Tensor, beta: float) -> torch.Tensor:
    if beta == 0.75:
        r = torch.sqrt(torch.rsqrt(d))
        return r * r * r
    return torch.exp(_f32(-beta) * torch.log(d))


def lrn_plain(x: torch.Tensor, size: int = 5, alpha: float = 1e-4,
              beta: float = 0.75, k: float = 1.0) -> torch.Tensor:
    """Caffe across-channel LRN over the last axis: ``x * (k + alpha/size
    * W(x^2))^-beta``, the window W zero-filled with lo = size//2,
    hi = size-1-size//2; the window sum runs lowest offset first."""
    xf = x.float()
    c = xf.shape[-1]
    lo, hi = size // 2, size - 1 - size // 2
    sqp = F.pad(xf * xf, (lo, hi))
    win = sqp[..., 0:c]
    for o in range(1, lo + hi + 1):
        win = win + sqp[..., o:o + c]
    d = _f32(k) + _f32(alpha / size) * win
    return (xf * _pow_neg_beta(d, beta)).to(x.dtype)


@counted
def fused_lrn(x: torch.Tensor, size: int = 5, alpha: float = 1e-4,
              beta: float = 0.75, k: float = 1.0) -> torch.Tensor:
    """Across-channel LRN (NHWC) — the kernel on CUDA, the plain version
    on the CPU."""
    if x.device.type == "cpu":
        return lrn_plain(x, size, alpha, beta, k)
    code = _check_cuda("fused_lrn", x)
    c = int(x.shape[-1])
    if c > 8192:
        raise ValueError(f"fused_lrn: {c} channels exceed the kernel's "
                         "8192-channel tile")
    out = torch.empty_like(x)
    rows = x.numel() // c
    err = library().npl_lrn_fwd(
        x.data_ptr(), out.data_ptr(), rows, c, int(size),
        _f32(alpha / size), float(beta), float(k), code,
        stream_ptr(x.device))
    check(err, "fused_lrn")
    fused_lrn.launches += 1
    return out


# -- bias + ReLU --------------------------------------------------------------


def bias_relu_plain(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    y = x.float() + bias.float()
    return torch.clamp_min(y, 0.0).to(x.dtype)


@counted
def fused_bias_relu(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Conv epilogue ``relu(x + bias)``, bias broadcast over the last
    axis, fp32 math stored in x's type."""
    if x.device.type == "cpu":
        return bias_relu_plain(x, bias)
    code = _check_cuda("fused_bias_relu", x, bias)
    c = int(x.shape[-1])
    b = _bias_f32(bias, c, x.device)
    out = torch.empty_like(x)
    err = library().npl_bias_relu(
        x.data_ptr(), b.data_ptr(), out.data_ptr(), x.numel(), c, code,
        stream_ptr(x.device))
    check(err, "fused_bias_relu")
    fused_bias_relu.launches += 1
    return out


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


@counted
def fused_bias_relu_pool(x: torch.Tensor, bias: torch.Tensor,
                         window: int = 3, stride: int = 2) -> torch.Tensor:
    """Stem epilogue ``max_pool(relu(x + bias))`` (SAME, NHWC) in one
    pass: the pre-pool activation never reaches device memory."""
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
    fused_bias_relu_pool.launches += 1
    return out
