"""Embedding model zoo of the port — ``get_model(name)`` mirrors
``npairloss_tpu.models.get_model`` for the trunks ported so far: the
GoogLeNet bias/LRN trunks and the MLP smoke model.  Without a precision
policy the JAX GoogLeNet computes in bf16 over fp32 parameters and the
MLP in fp32, and so do these."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from npairloss_tpu_torch.device import DeviceLike, resolve_device
from npairloss_tpu_torch.models.googlenet import GoogLeNetEmbedding
from npairloss_tpu_torch.models.mlp import MLPEmbedding

_REGISTRY: Dict[str, Callable[..., torch.nn.Module]] = {
    "googlenet": GoogLeNetEmbedding,
    "googlenet_s2d": lambda **kw: GoogLeNetEmbedding(stem_s2d=True, **kw),
    "googlenet_fused": lambda **kw: GoogLeNetEmbedding(fuse_1x1=True, **kw),
    "googlenet_mxu": lambda **kw: GoogLeNetEmbedding(
        stem_s2d=True, fuse_1x1=True, **kw),
    "googlenet_pallas": lambda **kw: GoogLeNetEmbedding(
        stem_s2d=True, fuse_1x1=True, pallas_stem=True, **kw),
    "mlp": MLPEmbedding,
}


def available_models():
    return sorted(_REGISTRY)


def get_model(name: str, *, device: DeviceLike = None, seed: int = 0,
              input_shape: Optional[Sequence[int]] = None,
              **kwargs) -> torch.nn.Module:
    """Build ``name`` on ``device`` (default: the card) in eval mode,
    initialized from ``seed``.  ``dtype`` defaults to bf16 for the
    GoogLeNet trunks and fp32 for ``mlp``, as in JAX.  ``mlp`` needs
    ``input_shape`` (one example's shape) for its first layer's width,
    which flax infers at init."""
    key = name.lower()
    if key not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {available_models()}")
    dev = resolve_device(device)
    if key == "mlp":
        if input_shape is None:
            raise ValueError("get_model('mlp') needs input_shape")
        kwargs.setdefault("in_features", int(np.prod(input_shape)))
    else:
        kwargs.setdefault("dtype", torch.bfloat16)
    model = _REGISTRY[key](**kwargs)
    model.reset_parameters(seed)
    return model.to(dev).eval()


def model_for_net(net_cfg) -> str:
    """The trunk a net prototxt names when ``--model`` is not given (the
    JAX CLI's ``_model_for_net``, cli.py:746-754)."""
    name = (net_cfg.name or "").lower().replace(" ", "")
    if "resnet" in name:
        return "resnet50"
    if "vit" in name:
        return "vit_b16"
    if "mlp" in name:
        return "mlp"
    return "googlenet"  # the reference's flagship trunk (def.prototxt:1)
