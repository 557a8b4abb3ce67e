"""Model building blocks (port of ``npairloss_tpu/models/layers.py``).

Activations are NHWC at every public function, as in the JAX package.
Inside, a convolution or pool hands PyTorch ``x.permute(0, 3, 1, 2)``,
an NCHW view with channels-last strides, which cuDNN takes as it is.

XLA's SAME padding is asymmetric (the extra pad goes high) where
PyTorch's ``padding=`` is symmetric, so asymmetric cases pad explicitly
with ``F.pad``: zeros for convolutions, -inf for max-pooling.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from npairloss_tpu_torch.ops.stem import (
    fused_bias_relu,
    fused_bias_relu_pool,
    fused_lrn,
    lrn_plain,
    same_pads,
)

Padding = Union[str, Sequence[Tuple[int, int]]]


def local_response_norm(x: torch.Tensor, size: int = 5, alpha: float = 1e-4,
                        beta: float = 0.75, k: float = 1.0,
                        fused: bool = False,
                        cache: Optional[bool] = None) -> torch.Tensor:
    """Across-channel LRN (Caffe semantics, NHWC).  ``fused=True`` routes
    through the stem kernels (``ops.stem.fused_lrn``, forward and
    backward); ``cache`` is their denominator-cache knob (None = auto by
    size).  The default is the plain reference, which autograd
    differentiates."""
    if fused:
        return fused_lrn(x, size, alpha, beta, k, cache=cache)
    return lrn_plain(x, size, alpha, beta, k)


def _resolve_pads(padding: Padding, h: int, w: int, kernel: Tuple[int, int],
                  strides: Tuple[int, int]):
    if padding == "SAME":
        _, hlo, hhi = same_pads(h, kernel[0], strides[0])
        _, wlo, whi = same_pads(w, kernel[1], strides[1])
        return (hlo, hhi), (wlo, whi)
    (hlo, hhi), (wlo, whi) = padding
    return (int(hlo), int(hhi)), (int(wlo), int(whi))


def conv2d_nhwc(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor], strides: Tuple[int, int],
                padding: Padding) -> torch.Tensor:
    """NHWC conv with an OIHW weight and XLA padding semantics."""
    kh, kw = int(weight.shape[2]), int(weight.shape[3])
    (hlo, hhi), (wlo, whi) = _resolve_pads(
        padding, int(x.shape[1]), int(x.shape[2]), (kh, kw), strides)
    if hlo == hhi and wlo == whi:
        pad = (hlo, wlo)
    else:
        x = F.pad(x, (0, 0, wlo, whi, hlo, hhi))
        pad = (0, 0)
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, strides, pad)
    return y.permute(0, 2, 3, 1)


class ConvBlock(nn.Module):
    """Conv + bias + ReLU with Caffe 'xavier' init (bias 0.2), computed
    in ``dtype`` over fp32 parameters.  The parameter lives at
    ``Conv_0`` like the flax module's, so weights carry across by name.

    ``fused_epilogue`` runs the conv without bias and hands the bias +
    ReLU to the stem kernel's autograd Function (gradients reach the
    conv's weight and bias through its backward); ``fuse_pool=(window,
    stride)`` folds the following SAME max-pool into the same kernel (the
    caller then skips its own pool)."""

    def __init__(self, in_features: int, features: int,
                 kernel: Tuple[int, int], strides: Tuple[int, int] = (1, 1),
                 padding: Padding = "SAME",
                 dtype: torch.dtype = torch.float32,
                 fused_epilogue: bool = False,
                 fuse_pool: Optional[Tuple[int, int]] = None):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_features, features, kernel, strides,
                                bias=True)
        self.strides = tuple(strides)
        self.padding = padding
        self.dtype = dtype
        self.fused_epilogue = fused_epilogue
        self.fuse_pool = fuse_pool

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.xavier_uniform_(self.Conv_0.weight, generator=generator)
        nn.init.constant_(self.Conv_0.bias, 0.2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.Conv_0.weight.to(self.dtype)
        x = x.to(self.dtype)
        if self.fused_epilogue:
            y = conv2d_nhwc(x, w, None, self.strides,
                            self.padding).contiguous()
            if self.fuse_pool is not None:
                return fused_bias_relu_pool(y, self.Conv_0.bias,
                                            *self.fuse_pool)
            return fused_bias_relu(y, self.Conv_0.bias)
        y = conv2d_nhwc(x, w, self.Conv_0.bias.to(self.dtype), self.strides,
                        self.padding)
        return F.relu(y)


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """NHWC (N,H,W,C) -> (N,H/b,W/b,b*b*C); pixel (bh+dh, bw+dw, c)
    lands in channel (dh*b+dw)*C + c."""
    n, h, w, c = x.shape
    if h % block or w % block:
        raise ValueError(
            f"space_to_depth needs H, W divisible by {block}, got {h}x{w}")
    x = x.reshape(n, h // block, block, w // block, block, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // block, w // block, block * block * c)


def conv1_kernel_to_s2d(kernel: np.ndarray) -> np.ndarray:
    """(7,7,C,F) HWIO stem kernel -> its (4,4,4C,F) space-to-depth
    equivalent (lossless; see the JAX package's docstring for the
    derivation: tap p = 2u + d, the p = 7 slot stays zero)."""
    kernel = np.asarray(kernel)
    kh, kw, cin, cout = kernel.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"expected a 7x7 stem kernel, got {kernel.shape}")
    out = np.zeros((4, 4, 4 * cin, cout), dtype=kernel.dtype)
    for u in range(4):
        for v in range(4):
            for dh in range(2):
                for dw in range(2):
                    p, q = 2 * u + dh, 2 * v + dw
                    if p < 7 and q < 7:
                        d = (dh * 2 + dw) * cin
                        out[u, v, d:d + cin, :] = kernel[p, q, :, :]
    return out


def max_pool(x: torch.Tensor, window: int = 3,
             stride: int = 2) -> torch.Tensor:
    """NHWC SAME max-pool: pads with -inf, asymmetric where XLA is."""
    _, h, w, _ = x.shape
    _, hlo, hhi = same_pads(int(h), window, stride)
    _, wlo, whi = same_pads(int(w), window, stride)
    if hlo == hhi and wlo == whi and 2 * hlo <= window and 2 * wlo <= window:
        y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride, (hlo, wlo))
    else:
        xp = F.pad(x, (0, 0, wlo, whi, hlo, hhi), value=float("-inf"))
        y = F.max_pool2d(xp.permute(0, 3, 1, 2), window, stride)
    return y.permute(0, 2, 3, 1)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Mean over H, W, summed in fp32 and returned in x's type."""
    return x.float().mean(dim=(1, 2)).to(x.dtype)
