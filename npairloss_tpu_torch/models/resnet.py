"""ResNet-v1 embedding trunks — port of ``npairloss_tpu/models/resnet.py``
(``resnet50``, ``resnet50_s2d``, ``resnet18``).

Bottleneck blocks with BatchNorm (flax semantics: ``layers.BatchNorm``),
computed in ``dtype`` (bf16 by default) over fp32 parameters; the
embedding is the global average pool of the last stage (``width * 32``
channels: 2048 for ResNet-50), L2-normalized when ``normalize``.  The
stride of a downsampling block sits on its 3x3 ``conv2``, as in the JAX
trunk.  Module and parameter names follow the flax tree (``conv_stem``,
``bn_stem``, ``stage{s}_block{b}/{conv1,bn1,...,conv_proj,bn_proj}``),
so :mod:`.convert` carries weights across by path; each block's ``path``
is its flax module path, which ``obs.perf.count`` names regions by.

Padding is XLA's SAME (``layers.conv2d_nhwc``, ``layers.max_pool``):
asymmetric where XLA's is — the 7x7/s2 stem pads (2, 3) at 224, every
3x3/s2 ``conv2`` (0, 1), the max-pool with -inf.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from npairloss_tpu_torch.models.layers import (
    BatchNorm,
    conv2d_nhwc,
    global_avg_pool,
    max_pool,
    space_to_depth,
)
from npairloss_tpu_torch.obs.perf import count
from npairloss_tpu_torch.ops.normalize import l2_normalize

# flax's he_normal draws a normal truncated at 2 sigma, rescaled so the
# variance is 2/fan_in.
_TRUNC_STD = 0.87962566103423978


def _conv(cin: int, cout: int, k: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, bias=False)


def _he_normal(conv: nn.Conv2d, gen: torch.Generator) -> None:
    w = conv.weight
    std = math.sqrt(2.0 / (w.shape[1] * w.shape[2] * w.shape[3])) / _TRUNC_STD
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride ``strides``) -> 1x1 (``4 * features``), each
    conv followed by BatchNorm, plus a projected shortcut where the
    channels differ or the stride is not 1."""

    def __init__(self, in_features: int, features: int, strides: int,
                 dtype: torch.dtype, path: str):
        super().__init__()
        out = features * 4
        self.strides = strides
        self.dtype = dtype
        self.path = path
        self.conv1 = _conv(in_features, features, 1)
        self.bn1 = BatchNorm(features, dtype)
        self.conv2 = _conv(features, features, 3)
        self.bn2 = BatchNorm(features, dtype)
        self.conv3 = _conv(features, out, 1)
        self.bn3 = BatchNorm(out, dtype)
        self.project = in_features != out or strides != 1
        if self.project:
            self.conv_proj = _conv(in_features, out, 1)
            self.bn_proj = BatchNorm(out, dtype)

    def _conv_of(self, conv: nn.Conv2d, x: torch.Tensor,
                 strides: int = 1) -> torch.Tensor:
        return conv2d_nhwc(x, conv.weight.to(self.dtype), None,
                           (strides, strides), "SAME")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self._conv_of(self.conv1, x)))
        y = F.relu(self.bn2(self._conv_of(self.conv2, y, self.strides)))
        y = self.bn3(self._conv_of(self.conv3, y))
        residual = x
        if self.project:
            residual = self.bn_proj(self._conv_of(self.conv_proj, x,
                                                  self.strides))
        return F.relu(y + residual)


class ResNetEmbedding(nn.Module):
    """ResNet-v1 trunk; ``stage_sizes=(3, 4, 6, 3)`` is ResNet-50.
    ``stem_s2d`` rewrites the 7x7/s2 stem as space-to-depth(2) + a 4x4/s1
    conv over 12 channels padded ((1, 2), (1, 2)) — the same function on
    weights converted by ``conv1_kernel_to_s2d``.  No ``remat``, no
    ``policy`` and no ``caffe_pad``, as in JAX: passing one raises
    ``TypeError``."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 width: int = 64, dtype: torch.dtype = torch.bfloat16,
                 normalize: bool = True, stem_s2d: bool = False):
        super().__init__()
        self.stage_sizes = tuple(int(s) for s in stage_sizes)
        self.width = int(width)
        self.dtype = dtype
        self.normalize = normalize
        self.stem_s2d = stem_s2d
        if stem_s2d:
            self.conv_stem = _conv(12, width, 4)
        else:
            self.conv_stem = _conv(3, width, 7)
        self.bn_stem = BatchNorm(width, dtype)
        self.bn_stem.path = "bn_stem"
        ch = width
        self.blocks = []
        for stage, num_blocks in enumerate(self.stage_sizes):
            for block in range(num_blocks):
                name = f"stage{stage + 1}_block{block + 1}"
                blk = Bottleneck(ch, width * 2 ** stage,
                                 2 if stage > 0 and block == 0 else 1,
                                 dtype, name)
                setattr(self, name, blk)
                self.blocks.append(name)
                ch = width * 2 ** stage * 4
        # The pooled width (what engine planning reads).
        self.embedding_dim = ch

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        """He-normal kernels (flax's ``he_normal``), BatchNorm scale 1,
        bias 0, running mean 0 and var 1, drawn from a
        ``torch.Generator`` seeded with ``seed``."""
        gen = torch.Generator(device=self.conv_stem.weight.device)
        gen.manual_seed(int(seed))
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                _he_normal(m, gen)
            elif isinstance(m, BatchNorm):
                m.reset_parameters()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        with count.scope("conv_stem", (x,)) as region:
            w = self.conv_stem.weight.to(self.dtype)
            if self.stem_s2d:
                x = conv2d_nhwc(space_to_depth(x, 2), w, None, (1, 1),
                                ((1, 2), (1, 2)))
            else:
                x = conv2d_nhwc(x, w, None, (2, 2), "SAME")
            region.outputs(x)
        x = max_pool(F.relu(self.bn_stem(x)), 3, 2)
        for name in self.blocks:
            x = getattr(self, name)(x)
        # JAX: an fp32 sum, the mean rounded to the compute dtype, then
        # widened.
        x = global_avg_pool(x).float()
        if self.normalize:
            x = l2_normalize(x)
        return x
