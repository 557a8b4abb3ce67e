"""Small MLP embedding net — the smoke model (``examples/tiny_net.prototxt``);
port of ``npairloss_tpu/models/mlp.py``.

Layer names follow the flax module (``dense0``, ..., ``head``), so
:mod:`.convert` carries weights across by path; a flax ``Dense`` kernel
is (in, out) and a ``nn.Linear`` weight (out, in).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from npairloss_tpu_torch.ops.normalize import l2_normalize

# flax's lecun_normal: a normal truncated at 2 sigma, rescaled so the
# variance is 1/fan_in.
_TRUNC_STD = 0.87962566103423978


class MLPEmbedding(nn.Module):
    def __init__(self, in_features: int, hidden: Sequence[int] = (128,),
                 embedding_dim: int = 64, dtype: torch.dtype = torch.float32,
                 normalize: bool = True):
        super().__init__()
        self.dtype = dtype
        self.normalize = normalize
        self.embedding_dim = int(embedding_dim)
        width = int(in_features)
        self.hidden = tuple(int(h) for h in hidden)
        for i, h in enumerate(self.hidden):
            setattr(self, f"dense{i}", nn.Linear(width, h))
            width = h
        self.head = nn.Linear(width, self.embedding_dim)

    def _layers(self):
        return [getattr(self, f"dense{i}") for i in range(len(self.hidden))] \
            + [self.head]

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        """lecun-normal kernels and zero biases (the flax ``Dense``
        initializers), drawn from a ``torch.Generator`` seeded with
        ``seed``."""
        gen = torch.Generator(device=self.head.weight.device)
        gen.manual_seed(int(seed))
        for lin in self._layers():
            std = math.sqrt(1.0 / lin.in_features) / _TRUNC_STD
            nn.init.trunc_normal_(lin.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=gen)
            nn.init.zeros_(lin.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).reshape(x.shape[0], -1)
        for lin in self._layers()[:-1]:
            x = F.relu(F.linear(x, lin.weight.to(self.dtype),
                                lin.bias.to(self.dtype)))
        x = F.linear(x, self.head.weight.to(self.dtype),
                     self.head.bias.to(self.dtype)).float()
        if self.normalize:
            x = l2_normalize(x)
        return x
