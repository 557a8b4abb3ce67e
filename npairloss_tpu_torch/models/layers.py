"""Model building blocks (port of ``npairloss_tpu/models/layers.py``).

Activations are NHWC at every public function, as in the JAX package.
Inside, a convolution or pool hands PyTorch ``x.permute(0, 3, 1, 2)``,
an NCHW view with channels-last strides, which cuDNN takes as it is.

XLA's SAME padding is asymmetric (the extra pad goes high) where
PyTorch's ``padding=`` is symmetric, so asymmetric cases pad explicitly
with ``F.pad``: zeros for convolutions, -inf for max-pooling.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from npairloss_tpu_torch.models.precision import module_precision
from npairloss_tpu_torch.obs.perf import count
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
    differentiates.  Its ops, forward and backward, count in region
    ``lrn`` (``obs.perf.count``), as the JAX trunk's ``named_scope``."""
    with count.scope("lrn", (x,)) as region:
        y = (fused_lrn(x, size, alpha, beta, k, cache=cache) if fused
             else lrn_plain(x, size, alpha, beta, k))
        region.outputs(y)
    return y


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


class BatchNorm(nn.Module):
    """BatchNorm over the channel axis of NHWC input, held to flax's
    ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``, not to
    ``nn.BatchNorm2d``: statistics in at least fp32 (fp64 stays fp64); the
    fast variance E[x^2] - E[x]^2 clipped at 0; the biased variance both
    to normalize and in the running update ``ra = 0.9 ra + 0.1 batch``;
    output ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` cast to
    ``dtype``.  Parameters ``scale`` (init 1) and ``bias`` (init 0),
    buffers ``mean`` (init 0) and ``var`` (init 1), as the flax tree
    names them; no ``num_batches_tracked``.

    In training mode the running statistics update once per forward,
    except inside :func:`no_stat_update` (a block's recompute under
    remat).

    With a mesh of G > 1 shards (``sync_batch_norm``) the batch
    statistics are the global batch's, as in the JAX package, whose trunk
    runs on the logical global batch: each rank's per-channel sums of x
    and x^2 are all-reduced in the forward, and their two gradients in
    the backward (``parallel.mesh.Mesh.all_reduce_sum``: every rank gets
    the same bits), so every rank ends on the same running statistics."""

    momentum = 0.9
    epsilon = 1e-5

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.mesh = None

    def reset_parameters(self) -> None:
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)
        self.mean.zero_()
        self.var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(_at_least_f32(x.dtype))
        if self.training:
            axes = tuple(range(x.dim() - 1))
            if self.mesh is not None and self.mesh.size > 1:
                mean, mean2 = _global_moments(xf, axes, self.mesh)
            else:
                mean, mean2 = xf.mean(dim=axes), (xf * xf).mean(dim=axes)
            var = torch.clamp_min(mean2 - mean * mean, 0.0)
            if not _STAT_UPDATE_OFF[0]:
                with torch.no_grad():
                    m = self.momentum
                    self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                    self.var.copy_(m * self.var + (1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale.to(xf.dtype)
        y = (xf - mean) * mul + self.bias.to(xf.dtype)
        return y.to(self.dtype)


def _at_least_f32(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _global_moments(xf: torch.Tensor, axes, mesh):
    """(E[x], E[x^2]) per channel over the global batch of ``mesh``'s
    equal shards."""
    from npairloss_tpu_torch.parallel.mesh import mesh_sum

    rows = xf.numel() // xf.shape[-1] * mesh.size
    sums = mesh_sum(torch.stack([xf.sum(dim=axes),
                                 (xf * xf).sum(dim=axes)]), mesh)
    return sums[0] / rows, sums[1] / rows


def sync_batch_norm(model: nn.Module, mesh) -> None:
    """Give every :class:`BatchNorm` of ``model`` the mesh whose global
    batch its statistics span (None: this rank's batch alone)."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.mesh = mesh


# Set while a remat'd block recomputes its forward in the backward pass:
# the running statistics were updated by the first forward already.
_STAT_UPDATE_OFF = [False]


@contextlib.contextmanager
def no_stat_update():
    """BatchNorm running statistics stay as they are inside."""
    prev = _STAT_UPDATE_OFF[0]
    _STAT_UPDATE_OFF[0] = True
    try:
        yield
    finally:
        _STAT_UPDATE_OFF[0] = prev


class ConvBlock(nn.Module):
    """Conv + bias + ReLU with Caffe 'xavier' init (bias 0.2), computed
    in ``dtype`` over fp32 parameters.  The parameter lives at
    ``Conv_0`` like the flax module's, so weights carry across by name.

    ``use_bn=True`` is the Inception-BN block: conv without bias, then
    :class:`BatchNorm` (``BatchNorm_0``), then ReLU.  ``policy`` (a
    ``models.precision.PrecisionPolicy``) resolves the block's parameter
    and compute dtypes against ``path``, its flax module path
    (``"inception_3a/b1x1"``); without one the block computes in
    ``dtype`` over fp32 parameters.

    ``fused_epilogue`` runs the conv without bias and hands the bias +
    ReLU to the stem kernel's autograd Function (gradients reach the
    conv's weight and bias through its backward); ``fuse_pool=(window,
    stride)`` folds the following SAME max-pool into the same kernel (the
    caller then skips its own pool).  A BN block has no bias and ignores
    both, as in JAX."""

    def __init__(self, in_features: int, features: int,
                 kernel: Tuple[int, int], strides: Tuple[int, int] = (1, 1),
                 padding: Padding = "SAME",
                 dtype: torch.dtype = torch.float32,
                 fused_epilogue: bool = False,
                 fuse_pool: Optional[Tuple[int, int]] = None,
                 use_bn: bool = False, policy=None, path: str = ""):
        super().__init__()
        self.mp = module_precision(policy, path, dtype)
        self.Conv_0 = nn.Conv2d(in_features, features, kernel, strides,
                                bias=not use_bn).to(self.mp.param_dtype)
        if use_bn:
            self.BatchNorm_0 = BatchNorm(features, self.mp.compute_dtype)
        self.use_bn = use_bn
        self.path = path
        self.strides = tuple(strides)
        self.padding = padding
        self.dtype = self.mp.compute_dtype
        self.fused_epilogue = fused_epilogue and not use_bn
        self.fuse_pool = fuse_pool

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.xavier_uniform_(self.Conv_0.weight, generator=generator)
        if self.use_bn:
            self.BatchNorm_0.reset_parameters()
        else:
            nn.init.constant_(self.Conv_0.bias, 0.2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.Conv_0.weight.to(self.dtype)
        x = x.to(self.dtype)
        if self.use_bn:
            y = conv2d_nhwc(x, w, None, self.strides, self.padding)
            return F.relu(self.BatchNorm_0(y))
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
    """Mean over H, W, summed in at least fp32 and returned in x's
    type."""
    return x.to(_at_least_f32(x.dtype)).mean(dim=(1, 2)).to(x.dtype)
