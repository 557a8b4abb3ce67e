"""L2 normalization (port of ``npairloss_tpu/ops/normalize.py``)."""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """``x * rsqrt(max(sum(x^2), eps))`` along ``dim``, computed in fp32
    and cast back, so bf16 activations keep unit norm."""
    xf = x.float()
    sq = (xf * xf).sum(dim=dim, keepdim=True)
    return (xf * torch.rsqrt(torch.clamp_min(sq, eps))).to(x.dtype)
