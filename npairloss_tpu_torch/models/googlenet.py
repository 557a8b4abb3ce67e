"""GoogLeNet (Inception v1) embedding trunk — port of
``npairloss_tpu/models/googlenet.py`` (the bias/LRN trunk, Inception-BN
with ``use_bn``, block remat and the precision policy).

Input NHWC images (224x224x3 canonical), output the 1024-d pool5
feature, L2-normalized when ``normalize``.  Module and attribute names
follow the flax parameter tree (``conv1``, ``inception_3a.b1x1``, ...,
each conv at ``Conv_0``) so :mod:`.convert` maps weights across by path.

The bias/LRN trunk has no dropout and no batch norm, so training and
inference run the same forward; under autograd the ``pallas_stem``
trunk's gradients flow through the stem kernels' backward
(``ops/stem.py``).  The BN trunk normalizes by batch statistics in
training mode (``model.train()``) and updates its running statistics,
which it uses in eval mode, as flax's ``use_running_average=not
train`` does.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from npairloss_tpu_torch.models.layers import (
    ConvBlock,
    global_avg_pool,
    local_response_norm,
    max_pool,
    no_stat_update,
    space_to_depth,
)
from npairloss_tpu_torch.models.precision import PrecisionPolicy
from npairloss_tpu_torch.ops.normalize import l2_normalize

# (1x1, 3x3red, 3x3, 5x5red, 5x5, pool_proj) per block.
INCEPTION_PLAN = {
    "3a": (64, 96, 128, 16, 32, 32),
    "3b": (128, 128, 192, 32, 96, 64),
    "4a": (192, 96, 208, 16, 48, 64),
    "4b": (160, 112, 224, 24, 64, 64),
    "4c": (128, 128, 256, 24, 64, 64),
    "4d": (112, 144, 288, 32, 64, 64),
    "4e": (256, 160, 320, 32, 128, 128),
    "5a": (256, 160, 320, 32, 128, 128),
    "5b": (384, 192, 384, 48, 128, 128),
}


class Inception(nn.Module):
    """One inception block; ``fuse_1x1`` merges the three 1x1 convs that
    read the block input into one conv and slices its output (exact).
    ``path`` is the block's flax module path (``"inception_3a"``), which
    its convs extend for the precision policy's rules."""

    def __init__(self, in_features: int, plan, dtype: torch.dtype,
                 fuse_1x1: bool = False, use_bn: bool = False,
                 policy: Optional[PrecisionPolicy] = None, path: str = ""):
        super().__init__()
        p1, p3r, p3, p5r, p5, pp = plan
        self.split = (p1, p3r, p5r)
        self.fuse_1x1 = fuse_1x1

        def conv(i, f, k, name):
            return ConvBlock(i, f, k, dtype=dtype, use_bn=use_bn,
                             policy=policy, path=f"{path}/{name}")

        if fuse_1x1:
            self.fused_1x1 = conv(in_features, p1 + p3r + p5r, (1, 1),
                                  "fused_1x1")
        else:
            self.b1x1 = conv(in_features, p1, (1, 1), "b1x1")
            self.b3x3_reduce = conv(in_features, p3r, (1, 1), "b3x3_reduce")
            self.b5x5_reduce = conv(in_features, p5r, (1, 1), "b5x5_reduce")
        self.b3x3 = conv(p3r, p3, (3, 3), "b3x3")
        self.b5x5 = conv(p5r, p5, (5, 5), "b5x5")
        self.pool_proj = conv(in_features, pp, (1, 1), "pool_proj")
        self.out_features = p1 + p3 + p5 + pp

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fuse_1x1:
            p1, p3r, _ = self.split
            fused = self.fused_1x1(x)
            b1 = fused[..., :p1]
            b3 = fused[..., p1:p1 + p3r]
            b5 = fused[..., p1 + p3r:]
        else:
            b1 = self.b1x1(x)
            b3 = self.b3x3_reduce(x)
            b5 = self.b5x5_reduce(x)
        b3 = self.b3x3(b3)
        b5 = self.b5x5(b5)
        bp = self.pool_proj(max_pool(x, 3, 1))
        return torch.cat([b1, b3, b5, bp], dim=-1)


def _recompute_context():
    """``checkpoint``'s context_fn: nothing around the first forward, and
    BatchNorm's running update off around the recompute."""
    return contextlib.nullcontext(), no_stat_update()


class GoogLeNetEmbedding(nn.Module):
    """Inception-v1 trunk -> pool5 (1024-d) -> optional L2 normalize.

    ``dtype`` is the compute type (bf16 by default, over fp32
    parameters).  ``stem_s2d`` rewrites the 7x7/s2 stem as
    space-to-depth + a 4x4/s1 conv (exact; weights via
    ``conv1_kernel_to_s2d``); ``fuse_1x1`` merges each block's input
    1x1s; ``pallas_stem`` keeps the JAX flag's name and routes
    the stem tail — both LRNs and the conv1/conv2 epilogues — through
    the hand-written stem kernels (``ops/stem.py``).

    ``use_bn`` is Inception-BN, the trunk that trains from scratch:
    BatchNorm after every conv (no conv biases), no LRN, and so no stem
    kernel (``pallas_stem`` is ignored), as in JAX.  ``remat``
    checkpoints each inception block: only its input is kept for the
    backward, which re-runs its forward; the running statistics update
    once per step and the gradients are the same bits as without it.
    ``policy`` (``models.precision``) resolves every conv block's dtypes
    by its flax path, and the trunk's entry and exit casts from its
    ``compute_dtype`` and ``output_dtype``.  ``caffe_pad`` pads the plain
    7x7/s2 stem (3, 3) on each side, Caffe's geometry (``pad: 3``),
    where SAME pads (2, 3) at 224: for imported ``.caffemodel`` weights;
    the s2d stem ignores it, as in JAX."""

    # The pool5 width (what engine planning reads as the embedding width).
    embedding_dim = 1024

    def __init__(self, dtype: torch.dtype = torch.bfloat16,
                 normalize: bool = True, fuse_1x1: bool = False,
                 stem_s2d: bool = False, pallas_stem: bool = False,
                 use_bn: bool = False, remat: bool = False,
                 policy: Optional[PrecisionPolicy] = None,
                 caffe_pad: bool = False):
        super().__init__()
        self.dtype = dtype
        self.normalize = normalize
        self.fuse_1x1 = fuse_1x1
        self.stem_s2d = stem_s2d
        self.use_bn = use_bn
        self.remat = remat
        self.caffe_pad = caffe_pad
        self.policy = policy
        self.pallas_stem = pallas_stem and not use_bn
        fuse = self.pallas_stem
        pool = (3, 2) if fuse else None
        block = dict(dtype=dtype, use_bn=use_bn, policy=policy)
        if stem_s2d:
            self.conv1 = ConvBlock(12, 64, (4, 4), (1, 1),
                                   padding=((1, 2), (1, 2)),
                                   fused_epilogue=fuse, fuse_pool=pool,
                                   path="conv1", **block)
        else:
            self.conv1 = ConvBlock(3, 64, (7, 7), (2, 2),
                                   padding=(((3, 3), (3, 3)) if caffe_pad
                                            else "SAME"),
                                   fused_epilogue=fuse, fuse_pool=pool,
                                   path="conv1", **block)
        self.conv2_reduce = ConvBlock(64, 64, (1, 1), fused_epilogue=fuse,
                                      path="conv2_reduce", **block)
        self.conv2 = ConvBlock(64, 192, (3, 3), fused_epilogue=fuse,
                               path="conv2", **block)
        ch = 192
        for key in INCEPTION_PLAN:
            name = f"inception_{key}"
            blk = Inception(ch, INCEPTION_PLAN[key], dtype, fuse_1x1,
                            use_bn, policy, name)
            setattr(self, name, blk)
            ch = blk.out_features
        self.out_features = ch

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        """Xavier-uniform kernels and bias 0.2 (the flax initializers),
        drawn from a ``torch.Generator`` seeded with ``seed``; BatchNorm
        scale 1, bias 0, running mean 0 and var 1."""
        gen = torch.Generator(device=self.conv1.Conv_0.weight.device)
        gen.manual_seed(int(seed))
        for m in self.modules():
            if isinstance(m, ConvBlock):
                m.reset_parameters(gen)

    def _block(self, key: str, x: torch.Tensor) -> torch.Tensor:
        blk = getattr(self, f"inception_{key}")
        if self.remat and torch.is_grad_enabled():
            return checkpoint(blk, x, use_reentrant=False,
                              context_fn=_recompute_context)
        return blk(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fuse = self.pallas_stem
        use_lrn = not self.use_bn
        x = x.to(self.policy.compute_dtype if self.policy is not None
                 else self.dtype)
        if self.stem_s2d:
            x = space_to_depth(x, 2)
        x = self.conv1(x)
        if not fuse:
            x = max_pool(x, 3, 2)
        if use_lrn:
            x = local_response_norm(x, fused=fuse)
        x = self.conv2_reduce(x)
        x = self.conv2(x)
        if use_lrn:
            x = local_response_norm(x, fused=fuse)
        x = max_pool(x, 3, 2)
        x = self._block("3a", x)
        x = self._block("3b", x)
        x = max_pool(x, 3, 2)
        for key in ("4a", "4b", "4c", "4d", "4e"):
            x = self._block(key, x)
        x = max_pool(x, 3, 2)
        x = self._block("5a", x)
        x = self._block("5b", x)
        x = global_avg_pool(x).to(self.policy.output_dtype
                                  if self.policy is not None
                                  else torch.float32)
        if self.normalize:
            x = l2_normalize(x)
        return x
