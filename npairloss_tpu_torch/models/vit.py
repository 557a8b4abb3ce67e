"""ViT embedding trunk — port of ``npairloss_tpu/models/vit.py``
(``vit_b16``: patch 16, hidden 768, depth 12, 12 heads, MLP 3072).

Patchify as a conv, pre-LN encoder blocks, the CLS token's final
LayerNorm output as the embedding (L2-normalized when ``normalize``).
The arithmetic is flax's, written out:

* ``LayerNorm``: epsilon 1e-6, fast variance E[x^2] - E[x]^2 clipped at
  0, computed in at least fp32 and returned in fp32 (the JAX trunk's
  ``dtype=float32``), then cast to the compute dtype by the caller.
* Attention (``nn.MultiHeadDotProductAttention``): ``query``, ``key``,
  ``value`` are ``DenseGeneral``s with (hidden, heads, head_dim)
  kernels and (heads, head_dim) biases, ``out`` a (heads, head_dim,
  hidden) kernel; the query is divided by sqrt(head_dim) in the compute
  dtype before ``einsum('bqhd,bkhd->bhqk')``, the softmax runs in the
  compute dtype (``force_fp32_for_softmax=False``), then
  ``einsum('bhqk,bkhd->bqhd')``.  Every product is an explicit
  ``einsum`` (matmuls the step counter prices), never
  ``scaled_dot_product_attention``, which scales and rounds in its own
  order.
* ``nn.gelu`` is the tanh approximation.

A precision policy resolves each module's dtypes at its flax path
(``patchify``, ``block{i}/attn``, ``block{i}/mlp``); the LayerNorms stay
fp32 whatever the policy.  Parameter names follow the flax tree
(``patchify``, ``cls``, ``pos_embed``, ``block{i}/{ln1,attn/{query,key,
value,out},ln2,mlp/{Dense_0,Dense_1}}``, ``ln_final``); the
``DenseGeneral`` kernels keep flax's layout as their ``weight``.
``pos_embed`` has one row per token, so a trunk is built for one image
side (``image_size``): 197 tokens at 224², 17 at 64².
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from npairloss_tpu_torch.models.precision import (
    PrecisionPolicy,
    module_precision,
)
from npairloss_tpu_torch.obs.perf import count
from npairloss_tpu_torch.ops.normalize import l2_normalize

# flax's lecun_normal: a normal truncated at 2 sigma, rescaled so the
# variance is 1/fan_in.
_TRUNC_STD = 0.87962566103423978


def _lecun(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)`` over the last axis: the
    output is fp32 whatever the input's type."""

    epsilon = 1e-6

    def __init__(self, features: int, path: str = ""):
        super().__init__()
        self.path = path
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp_min((xf * xf).mean(dim=-1, keepdim=True)
                              - mean * mean, 0.0)
        mul = torch.rsqrt(var + self.epsilon) * self.scale.to(xf.dtype)
        return ((xf - mean) * mul + self.bias.to(xf.dtype)).float()


class DenseGeneral(nn.Module):
    """A flax ``DenseGeneral``'s kernel and bias, flax's shapes."""

    def __init__(self, kernel_shape, bias_shape, param_dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(kernel_shape,
                                               dtype=param_dtype))
        self.bias = nn.Parameter(torch.zeros(bias_shape, dtype=param_dtype))


class Attention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (self-attention, no mask, no
    dropout) in the module precision of ``path``."""

    def __init__(self, hidden: int, num_heads: int, mp, path: str):
        super().__init__()
        head = hidden // num_heads
        self.mp = mp
        self.path = path
        # sqrt(head_dim) rounded to the compute dtype, as flax divides.
        self.sqrt_depth = float(torch.tensor(math.sqrt(head),
                                             dtype=mp.compute_dtype))
        for name in ("query", "key", "value"):
            setattr(self, name, DenseGeneral((hidden, num_heads, head),
                                             (num_heads, head),
                                             mp.param_dtype))
        self.out = DenseGeneral((num_heads, head, hidden), (hidden,),
                                mp.param_dtype)

    def _proj(self, x: torch.Tensor, dense: DenseGeneral) -> torch.Tensor:
        dt = self.mp.compute_dtype
        return (torch.einsum("bti,ihd->bthd", x.to(dt), dense.weight.to(dt))
                + dense.bias.to(dt))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.mp.compute_dtype
        q = self._proj(x, self.query)
        k = self._proj(x, self.key)
        v = self._proj(x, self.value)
        q = q / self.sqrt_depth
        s = torch.einsum("bqhd,bkhd->bhqk", q, k)
        # jax.nn.softmax: the max is a constant to the gradient.
        e = torch.exp(s - s.amax(dim=-1, keepdim=True).detach())
        w = e / e.sum(dim=-1, keepdim=True)
        y = torch.einsum("bhqk,bkhd->bqhd", w, v)
        return (torch.einsum("bqhd,hdo->bqo", y, self.out.weight.to(dt))
                + self.out.bias.to(dt))


class MlpBlock(nn.Module):
    def __init__(self, hidden: int, mlp_dim: int, mp, path: str):
        super().__init__()
        self.mp = mp
        self.path = path
        self.Dense_0 = nn.Linear(hidden, mlp_dim).to(mp.param_dtype)
        self.Dense_1 = nn.Linear(mlp_dim, hidden).to(mp.param_dtype)

    def _dense(self, x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
        dt = self.mp.compute_dtype
        # flax adds the bias after the product, a second rounding.
        return x.to(dt) @ lin.weight.to(dt).T + lin.bias.to(dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.gelu(self._dense(x, self.Dense_0), approximate="tanh")
        return self._dense(x, self.Dense_1)


class EncoderBlock(nn.Module):
    def __init__(self, hidden: int, num_heads: int, mlp_dim: int,
                 dtype: torch.dtype, policy: Optional[PrecisionPolicy],
                 path: str):
        super().__init__()
        self.path = path
        self.mp = module_precision(policy, f"{path}/attn", dtype)
        self.ln1 = LayerNorm(hidden, f"{path}/ln1")
        self.attn = Attention(hidden, num_heads, self.mp, f"{path}/attn")
        self.ln2 = LayerNorm(hidden, f"{path}/ln2")
        self.mlp = MlpBlock(hidden, mlp_dim,
                            module_precision(policy, f"{path}/mlp", dtype),
                            f"{path}/mlp")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.mp.compute_dtype
        x = x + self.attn(self.ln1(x).to(dt))
        return x + self.mlp(self.ln2(x).to(dt))


class ViTEmbedding(nn.Module):
    """ViT trunk -> CLS embedding; the defaults are ViT-B/16 at 224²."""

    def __init__(self, patch: int = 16, hidden: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_dim: int = 3072,
                 dtype: torch.dtype = torch.bfloat16, normalize: bool = True,
                 policy: Optional[PrecisionPolicy] = None,
                 image_size: int = 224):
        super().__init__()
        if image_size % patch:
            raise ValueError(f"image side {image_size} is not a multiple "
                             f"of the patch {patch}")
        self.patch, self.hidden, self.depth = patch, hidden, depth
        self.dtype = dtype
        self.normalize = normalize
        self.policy = policy
        self.image_size = int(image_size)
        self.mp = module_precision(policy, "patchify", dtype)
        self.patchify = nn.Conv2d(3, hidden, patch, patch).to(
            self.mp.param_dtype)
        tokens = (self.image_size // patch) ** 2 + 1
        self.cls = nn.Parameter(torch.zeros(1, 1, hidden))
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, hidden))
        self.blocks = []
        for i in range(depth):
            setattr(self, f"block{i}", EncoderBlock(
                hidden, num_heads, mlp_dim, dtype, policy, f"block{i}"))
            self.blocks.append(f"block{i}")
        self.ln_final = LayerNorm(hidden, "ln_final")
        self.embedding_dim = hidden

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        """flax's initializers from a ``torch.Generator`` seeded with
        ``seed``: lecun-normal conv and dense kernels, zero biases and
        ``cls``, ``pos_embed`` normal(0.02), LayerNorm scale 1, bias 0."""
        gen = torch.Generator(device=self.cls.device)
        gen.manual_seed(int(seed))
        w = self.patchify.weight
        _lecun(w, w.shape[1] * w.shape[2] * w.shape[3], gen)
        nn.init.zeros_(self.patchify.bias)
        nn.init.zeros_(self.cls)
        nn.init.normal_(self.pos_embed, std=0.02, generator=gen)
        for m in self.modules():
            if isinstance(m, DenseGeneral):
                fan_in = (m.weight.shape[0] if m.bias.dim() == 2
                          else m.weight.shape[0] * m.weight.shape[1])
                _lecun(m.weight, fan_in, gen)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Linear):
                _lecun(m.weight, m.in_features, gen)
                nn.init.zeros_(m.bias)
            elif isinstance(m, LayerNorm):
                nn.init.ones_(m.scale)
                nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.mp.compute_dtype
        n = x.shape[0]
        x = x.to(dt)
        with count.scope("patchify", (x,)) as region:
            y = F.conv2d(x.permute(0, 3, 1, 2), self.patchify.weight.to(dt),
                         None, self.patch)
            # NHWC row-major tokens, as the flax reshape of the NHWC conv.
            y = y.permute(0, 2, 3, 1).reshape(n, -1, self.hidden) \
                + self.patchify.bias.to(dt)
            region.outputs(y)
        y = torch.cat([self.cls.expand(n, 1, self.hidden).to(dt), y], dim=1)
        y = y + self.pos_embed.to(dt)
        for name in self.blocks:
            y = getattr(self, name)(y)
        y = self.ln_final(y)
        out = (self.policy.output_dtype if self.policy is not None
               else torch.float32)
        emb = y[:, 0].to(out)
        if self.normalize:
            emb = l2_normalize(emb)
        return emb
