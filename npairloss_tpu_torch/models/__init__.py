"""Embedding model zoo of the port — ``get_model(name)`` mirrors
``npairloss_tpu.models.get_model`` for the GoogLeNet trunks the serving
slice runs.  Without a precision policy the JAX trunk computes in bf16
over fp32 parameters, and so does this one."""

from __future__ import annotations

from typing import Callable, Dict

import torch

from npairloss_tpu_torch.device import DeviceLike, resolve_device
from npairloss_tpu_torch.models.googlenet import GoogLeNetEmbedding

_REGISTRY: Dict[str, Callable[..., GoogLeNetEmbedding]] = {
    "googlenet": GoogLeNetEmbedding,
    "googlenet_s2d": lambda **kw: GoogLeNetEmbedding(stem_s2d=True, **kw),
    "googlenet_fused": lambda **kw: GoogLeNetEmbedding(fuse_1x1=True, **kw),
    "googlenet_mxu": lambda **kw: GoogLeNetEmbedding(
        stem_s2d=True, fuse_1x1=True, **kw),
    "googlenet_pallas": lambda **kw: GoogLeNetEmbedding(
        stem_s2d=True, fuse_1x1=True, pallas_stem=True, **kw),
}


def available_models():
    return sorted(_REGISTRY)


def get_model(name: str, *, device: DeviceLike = None, seed: int = 0,
              **kwargs) -> GoogLeNetEmbedding:
    """Build ``name`` on ``device`` (default: the card) in eval mode,
    initialized from ``seed``; ``dtype`` defaults to bf16 as in JAX."""
    key = name.lower()
    if key not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {available_models()}")
    dev = resolve_device(device)
    kwargs.setdefault("dtype", torch.bfloat16)
    model = _REGISTRY[key](**kwargs)
    model.reset_parameters(seed)
    return model.to(dev).eval()
