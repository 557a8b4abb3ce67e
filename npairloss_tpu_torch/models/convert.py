"""Carry flax GoogLeNet weights into the port.

The flax tree is ``{block: {..., "Conv_0": {"kernel", "bias"}}}`` with
HWIO kernels; the port's modules carry the same names, so
``conv1/Conv_0/kernel`` becomes ``conv1.Conv_0.weight`` (OIHW) and
``inception_3a/b1x1/Conv_0/bias`` becomes
``inception_3a.b1x1.Conv_0.bias``.  Trunk layouts differ only in the
stem (7x7 vs space-to-depth 4x4) and the inception 1x1s (three convs vs
one fused conv); :func:`adapt_params` converts between them with numpy
copies of the JAX package's ``conv1_kernel_to_s2d`` and
``fuse_inception_1x1_params``.  The MLP's ``Dense`` kernels are (in,
out) in flax and (out, in) as ``nn.Linear`` weights.

A weights file (``serve --weights W.npz``, ``train --weights W.npz``)
is the flattened tree: one array per ``"/"``-joined path.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, Mapping

import numpy as np
import torch

from npairloss_tpu_torch.models.layers import conv1_kernel_to_s2d

__all__ = [
    "adapt_params", "conv1_kernel_to_s2d", "flatten_params",
    "from_jax_params", "fuse_inception_1x1_params", "load_jax_params",
    "load_weights_npz", "read_weights_npz", "save_weights_npz",
    "to_jax_params", "unflatten_params",
]


def flatten_params(tree: Mapping[str, Any], prefix: str = ""
                   ) -> Dict[str, np.ndarray]:
    """Nested dict -> ``{"a/b/c": array}``."""
    out: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            out.update(flatten_params(val, path))
        else:
            out[path] = np.asarray(val)
    return out


def unflatten_params(flat: Mapping[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, val in flat.items():
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(val)
    return tree


def fuse_inception_1x1_params(params: Mapping[str, Any]) -> Dict[str, Any]:
    """Plain-trunk tree -> the ``fuse_1x1`` layout: each block's b1x1,
    b3x3_reduce and b5x5_reduce leaves concatenated on the output axis
    (in that order) under ``fused_1x1``.  Exact."""
    out: Dict[str, Any] = {}
    for block, sub in params.items():
        if not block.startswith("inception_") or "b1x1" not in sub:
            out[block] = sub
            continue
        sub = dict(sub)
        parts = [sub.pop("b1x1"), sub.pop("b3x3_reduce"),
                 sub.pop("b5x5_reduce")]
        sub["fused_1x1"] = {
            mod: {leaf: np.concatenate([np.asarray(p[mod][leaf])
                                        for p in parts], axis=-1)
                  for leaf in parts[0][mod]}
            for mod in parts[0]
        }
        out[block] = sub
    return out


def adapt_params(params: Mapping[str, Any], stem_s2d: bool,
                 fuse_1x1: bool) -> Dict[str, Any]:
    """Convert a plain-layout tree to the layout a trunk expects (a tree
    already in that layout passes through)."""
    tree = dict(params)
    kernel = np.asarray(tree["conv1"]["Conv_0"]["kernel"])
    if stem_s2d and kernel.shape[:2] == (7, 7):
        tree["conv1"] = {"Conv_0": {
            "kernel": conv1_kernel_to_s2d(kernel),
            "bias": np.asarray(tree["conv1"]["Conv_0"]["bias"]),
        }}
    elif not stem_s2d and kernel.shape[:2] != (7, 7):
        raise ValueError("a space-to-depth stem kernel cannot feed the "
                         "plain 7x7 stem")
    if fuse_1x1:
        tree = fuse_inception_1x1_params(tree)
    elif any("fused_1x1" in v for k, v in tree.items()
             if k.startswith("inception_")):
        raise ValueError("fused 1x1 weights cannot feed an unfused trunk")
    return tree


def from_jax_params(params: Mapping[str, Any]) -> "collections.OrderedDict":
    """Flax param tree (numpy leaves) -> a state_dict: HWIO kernels
    become OIHW ``weight``s, biases carry over."""
    sd: "collections.OrderedDict[str, torch.Tensor]" = \
        collections.OrderedDict()
    for path, arr in flatten_params(params).items():
        parts = path.split("/")
        leaf = parts[-1]
        base = ".".join(parts[:-1])
        a = np.asarray(arr, np.float32)
        if leaf == "kernel":
            if a.ndim == 4:    # conv: HWIO -> OIHW
                a = a.transpose(3, 2, 0, 1)
            elif a.ndim == 2:  # Dense: (in, out) -> Linear (out, in)
                a = a.T
            else:
                raise ValueError(f"{path}: expected an HWIO or (in, out) "
                                 f"kernel, got {a.shape}")
            sd[f"{base}.weight"] = torch.from_numpy(np.ascontiguousarray(a))
        elif leaf == "bias":
            sd[f"{base}.bias"] = torch.from_numpy(a.copy())
        else:
            raise ValueError(f"{path}: unknown parameter leaf {leaf!r}")
    return sd


def load_jax_params(model: torch.nn.Module, params: Mapping[str, Any]
                    ) -> torch.nn.Module:
    """Load a flax tree (any GoogLeNet layout, or the MLP's) into
    ``model`` in place."""
    tree = params
    if hasattr(model, "stem_s2d"):
        tree = adapt_params(params, model.stem_s2d, model.fuse_1x1)
    model.load_state_dict(from_jax_params(tree), strict=True)
    return model


def to_jax_params(model: torch.nn.Module) -> Dict[str, Any]:
    """The inverse of :func:`from_jax_params` for the model's own layout:
    a flax-style tree with numpy leaves (OIHW -> HWIO, Linear -> (in,
    out))."""
    flat: Dict[str, np.ndarray] = {}
    for key, t in model.state_dict().items():
        path, leaf = key.rsplit(".", 1)
        a = t.detach().float().cpu().numpy()
        if leaf == "weight":
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
            leaf = "kernel"
        flat[path.replace(".", "/") + "/" + leaf] = np.ascontiguousarray(a)
    return unflatten_params(flat)


def read_weights_npz(path: str) -> Dict[str, Any]:
    """The flax param tree of a weights file (numpy leaves)."""
    with np.load(path) as f:
        return unflatten_params({k: f[k] for k in f.files})


def load_weights_npz(model: torch.nn.Module, path: str) -> torch.nn.Module:
    return load_jax_params(model, read_weights_npz(path))


def save_weights_npz(params: Mapping[str, Any], path: str) -> None:
    np.savez(path, **flatten_params(params))
