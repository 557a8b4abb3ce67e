"""Embedding model zoo of the port — ``get_model(name, policy=...)``
mirrors ``npairloss_tpu.models.get_model`` name for name: the GoogLeNet
bias/LRN trunks, Inception-BN (``googlenet_bn``, ``inception_bn``,
``googlenet_bn_s2d``), the ResNets (``resnet50``, ``resnet50_s2d``,
``resnet18`` — bottleneck blocks at (2, 2, 2, 2), as in JAX), ViT-B/16
(``vit_b16``) and the MLP smoke model.  Without a precision policy the
JAX GoogLeNet, ResNet and ViT compute in bf16 over fp32 parameters and
the MLP in fp32, and so do these.  A policy (``models.precision``:
``"mxu"``, ``"bf16"``, ``"fp32_parity"`` or a ``PrecisionPolicy``)
supplies the default compute dtype, and the GoogLeNet trunks and ViT
(``_POLICY_AWARE``) resolve it per module.  The flagship pair is
``googlenet_mxu`` under ``"mxu"`` (``FLAGSHIP_TRUNK``,
``FLAGSHIP_POLICY``), as in JAX."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from npairloss_tpu_torch.device import DeviceLike, resolve_device
from npairloss_tpu_torch.models.googlenet import GoogLeNetEmbedding
from npairloss_tpu_torch.models.mlp import MLPEmbedding
from npairloss_tpu_torch.models.precision import (
    DEFAULT_POLICY,
    PrecisionPolicy,
    get_policy,
)
from npairloss_tpu_torch.models.resnet import ResNetEmbedding
from npairloss_tpu_torch.models.vit import ViTEmbedding

FLAGSHIP_TRUNK = "googlenet_mxu"
FLAGSHIP_POLICY = DEFAULT_POLICY

_REGISTRY: Dict[str, Callable[..., torch.nn.Module]] = {
    "googlenet": GoogLeNetEmbedding,
    "googlenet_embedding": GoogLeNetEmbedding,
    # Inception-BN: BatchNorm after every conv, no LRN — the trunk that
    # trains from scratch.
    "googlenet_bn": lambda **kw: GoogLeNetEmbedding(use_bn=True, **kw),
    "inception_bn": lambda **kw: GoogLeNetEmbedding(use_bn=True, **kw),
    "googlenet_bn_s2d": lambda **kw: GoogLeNetEmbedding(
        use_bn=True, stem_s2d=True, **kw),
    "googlenet_s2d": lambda **kw: GoogLeNetEmbedding(stem_s2d=True, **kw),
    "googlenet_fused": lambda **kw: GoogLeNetEmbedding(fuse_1x1=True, **kw),
    "googlenet_mxu": lambda **kw: GoogLeNetEmbedding(
        stem_s2d=True, fuse_1x1=True, **kw),
    "googlenet_pallas": lambda **kw: GoogLeNetEmbedding(
        stem_s2d=True, fuse_1x1=True, pallas_stem=True, **kw),
    # Resolved through FLAGSHIP_TRUNK at call time.
    "flagship": lambda **kw: _REGISTRY[FLAGSHIP_TRUNK](**kw),
    "resnet50": lambda **kw: ResNetEmbedding(stage_sizes=(3, 4, 6, 3), **kw),
    "resnet50_s2d": lambda **kw: ResNetEmbedding(
        stage_sizes=(3, 4, 6, 3), stem_s2d=True, **kw),
    "resnet18": lambda **kw: ResNetEmbedding(stage_sizes=(2, 2, 2, 2),
                                             width=64, **kw),
    "vit_b16": ViTEmbedding,
    "mlp": MLPEmbedding,
}

# Registry names whose trunks take the policy object and resolve it per
# module; the rest honour its compute dtype only.
_POLICY_AWARE = {
    "googlenet", "googlenet_embedding", "googlenet_bn", "inception_bn",
    "googlenet_s2d", "googlenet_bn_s2d", "googlenet_fused",
    "googlenet_mxu", "googlenet_pallas", "flagship", "vit_b16",
}


def available_models():
    return sorted(_REGISTRY)


def get_model(name: str, *, device: DeviceLike = None, seed: int = 0,
              input_shape: Optional[Sequence[int]] = None,
              policy: Optional[Union[str, PrecisionPolicy]] = None,
              **kwargs) -> torch.nn.Module:
    """Build ``name`` on ``device`` (default: the card) in eval mode,
    initialized from ``seed``.  ``dtype`` defaults to the policy's
    compute dtype, else fp32 for ``mlp`` and bf16 for the others, as in
    JAX.  ``mlp`` needs ``input_shape`` (one example's shape) for its
    first layer's width, and ``vit_b16`` takes its image side from it
    (default 224) for ``pos_embed``'s token count: flax infers both at
    init.  An option a trunk lacks (``remat=True`` for ``mlp``, a ResNet
    or ViT; ``caffe_pad`` for any but the GoogLeNet trunks) raises
    ``TypeError``."""
    key = name.lower()
    if key not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {available_models()}")
    dev = resolve_device(device)
    if policy is not None:
        pol = get_policy(policy)
        kwargs.setdefault("dtype", pol.compute_dtype)
        if key in _POLICY_AWARE:
            kwargs["policy"] = pol
    if key == "mlp":
        if input_shape is None:
            raise ValueError("get_model('mlp') needs input_shape")
        kwargs.setdefault("in_features", int(np.prod(input_shape)))
    else:
        if key == "vit_b16" and input_shape is not None:
            kwargs.setdefault("image_size", int(input_shape[0]))
        kwargs.setdefault("dtype", torch.bfloat16)
    model = _REGISTRY[key](**kwargs)
    model.reset_parameters(seed)
    return model.to(dev).eval()


def flagship_model(policy: Optional[Union[str, PrecisionPolicy]] =
                   FLAGSHIP_POLICY, **kwargs) -> torch.nn.Module:
    """The flagship trunk under the default (or given) policy."""
    return get_model(FLAGSHIP_TRUNK, policy=policy, **kwargs)


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
