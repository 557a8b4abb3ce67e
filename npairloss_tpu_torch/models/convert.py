"""Carry flax weights into the port (GoogLeNet, ResNet, ViT, MLP).

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

BN trunks carry a second tree, flax's ``batch_stats``
(``{block: {"BatchNorm_0": {"mean", "var"}}}``): the BatchNorm's
``scale``/``bias`` are parameters and its running ``mean``/``var`` are
the module's buffers of those names.  Every converter takes and returns
it beside the params (``from_jax_params``, ``load_jax_params``,
``to_jax_params(with_batch_stats=True)``), and ``adapt_params``'s fused
1x1 layout concatenates the statistics too, as JAX's
``fuse_inception_1x1_params`` does.

The ResNet tree has no ``Conv_0`` level (``conv_stem/kernel``,
``stage1_block1/conv1/kernel``, ``bn_stem/scale``); its stem is 7x7 or
space-to-depth 4x4 (:func:`adapt_resnet_params`).  ViT adds flax's
``DenseGeneral`` leaves — 3-D kernels ((768, 12, 64) for ``query``,
``key``, ``value``; (12, 64, 768) for ``out``) and 2-D biases, which
keep flax's layout as torch parameters — and the top-level ``cls`` and
``pos_embed`` parameters, state_dict keys of those names.

A weights file (``serve --weights W.npz``, ``train --weights W.npz``)
is the flattened tree: one array per ``"/"``-joined path; a file with
running statistics holds the wrapped ``{"params", "batch_stats"}`` form
the JAX CLI reads (``params/...`` and ``batch_stats/...`` paths).
"""

from __future__ import annotations

import collections
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from npairloss_tpu_torch.models.layers import conv1_kernel_to_s2d

__all__ = [
    "adapt_params", "adapt_resnet_params", "conv1_kernel_to_s2d",
    "flatten_params",
    "from_jax_params", "fuse_inception_1x1_params", "load_jax_params",
    "load_weights_npz", "read_weights_npz", "save_weights_npz",
    "split_variables", "to_jax_params", "tree_from_state",
    "unflatten_params",
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
    (in that order) under ``fused_1x1``.  Exact; a ``batch_stats`` tree
    converts the same way (its leaves are per output channel too)."""
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


def split_variables(tree: Mapping[str, Any]
                    ) -> Tuple[Mapping[str, Any], Optional[Mapping[str, Any]]]:
    """(params, batch_stats or None) of a bare params tree or of the
    wrapped ``{"params", "batch_stats"}`` form."""
    if tree and set(tree) <= {"params", "batch_stats"} and "params" in tree:
        return tree["params"], tree.get("batch_stats") or None
    return tree, None


def _has_fused(tree: Mapping[str, Any]) -> bool:
    return any("fused_1x1" in v for k, v in tree.items()
               if k.startswith("inception_"))


def adapt_params(params: Mapping[str, Any], stem_s2d: bool,
                 fuse_1x1: bool) -> Dict[str, Any]:
    """Convert a plain-layout tree to the layout a trunk expects (a tree
    already in that layout passes through).  Only the stem kernel
    changes under ``stem_s2d``; a BN stem keeps its ``BatchNorm_0``."""
    tree = dict(params)
    kernel = np.asarray(tree["conv1"]["Conv_0"]["kernel"])
    if stem_s2d and kernel.shape[:2] == (7, 7):
        conv1 = dict(tree["conv1"])
        conv1["Conv_0"] = dict(conv1["Conv_0"],
                               kernel=conv1_kernel_to_s2d(kernel))
        tree["conv1"] = conv1
    elif not stem_s2d and kernel.shape[:2] != (7, 7):
        raise ValueError("a space-to-depth stem kernel cannot feed the "
                         "plain 7x7 stem")
    return _adapt_1x1(tree, fuse_1x1)


def adapt_resnet_params(params: Mapping[str, Any],
                        stem_s2d: bool) -> Dict[str, Any]:
    """A ResNet tree in the stem layout the trunk expects: a 7x7
    ``conv_stem`` kernel becomes the 4x4x12 space-to-depth one under
    ``stem_s2d`` (``conv1_kernel_to_s2d``); an s2d kernel cannot feed
    the plain stem."""
    tree = dict(params)
    kernel = np.asarray(tree["conv_stem"]["kernel"])
    if stem_s2d and kernel.shape[:2] == (7, 7):
        tree["conv_stem"] = dict(tree["conv_stem"],
                                 kernel=conv1_kernel_to_s2d(kernel))
    elif not stem_s2d and kernel.shape[:2] != (7, 7):
        raise ValueError("a space-to-depth stem kernel cannot feed the "
                         "plain 7x7 stem")
    return tree


def _adapt_1x1(tree: Mapping[str, Any], fuse_1x1: bool) -> Dict[str, Any]:
    if fuse_1x1 and not _has_fused(tree):
        return fuse_inception_1x1_params(tree)
    if not fuse_1x1 and _has_fused(tree):
        raise ValueError("fused 1x1 weights cannot feed an unfused trunk")
    return dict(tree)


# ViT's top-level parameters: state_dict keys of the same names.
_TOP_LEAVES = ("cls", "pos_embed")


def _leaf_key(path: str, arr: np.ndarray, buffers: bool):
    """(state_dict key, torch array) of one flax leaf."""
    parts = path.split("/")
    leaf = parts[-1]
    base = ".".join(parts[:-1])
    a = np.asarray(arr, np.float32)
    if not base and not buffers and leaf in _TOP_LEAVES:
        return leaf, a.copy()
    if buffers:
        if leaf not in ("mean", "var"):
            raise ValueError(f"{path}: unknown batch_stats leaf {leaf!r}")
        return f"{base}.{leaf}", a.copy()
    if leaf == "kernel":
        if a.ndim == 4:    # conv: HWIO -> OIHW
            a = a.transpose(3, 2, 0, 1)
        elif a.ndim == 2:  # Dense: (in, out) -> Linear (out, in)
            a = a.T
        elif a.ndim != 3:  # DenseGeneral keeps flax's layout
            raise ValueError(f"{path}: expected an HWIO, (in, out) or "
                             f"DenseGeneral kernel, got {a.shape}")
        return f"{base}.weight", np.ascontiguousarray(a)
    if leaf in ("bias", "scale"):
        return f"{base}.{leaf}", a.copy()
    raise ValueError(f"{path}: unknown parameter leaf {leaf!r}")


def from_jax_params(params: Mapping[str, Any],
                    batch_stats: Optional[Mapping[str, Any]] = None
                    ) -> "collections.OrderedDict":
    """Flax param tree (numpy leaves) -> a state_dict: HWIO kernels
    become OIHW ``weight``s, biases and BatchNorm scales carry over, and
    ``batch_stats``' running ``mean``/``var`` become the buffers of
    those names."""
    sd: "collections.OrderedDict[str, torch.Tensor]" = \
        collections.OrderedDict()
    for tree, buffers in ((params, False), (batch_stats or {}, True)):
        for path, arr in flatten_params(tree).items():
            key, a = _leaf_key(path, arr, buffers)
            sd[key] = torch.from_numpy(a)
    return sd


def load_jax_params(model: torch.nn.Module, params: Mapping[str, Any],
                    batch_stats: Optional[Mapping[str, Any]] = None
                    ) -> torch.nn.Module:
    """Load a flax tree (any GoogLeNet or ResNet layout, ViT's or the
    MLP's; bare or wrapped with its ``batch_stats``) into ``model`` in
    place.  Without
    ``batch_stats`` a BN trunk keeps its running statistics, as JAX's
    ``Solver.load_params`` does."""
    tree, wrapped_stats = split_variables(params)
    if batch_stats is None:
        batch_stats = wrapped_stats
    if hasattr(model, "fuse_1x1"):  # the GoogLeNet layouts
        tree = adapt_params(tree, model.stem_s2d, model.fuse_1x1)
        if batch_stats is not None:
            batch_stats = _adapt_1x1(batch_stats, model.fuse_1x1)
    elif hasattr(model, "stem_s2d"):  # the ResNet layouts
        tree = adapt_resnet_params(tree, model.stem_s2d)
    sd = from_jax_params(tree, batch_stats)
    buffers = dict(model.named_buffers())
    missing = [k for k in model.state_dict() if k not in sd]
    if batch_stats is None and all(k in buffers for k in missing):
        sd.update({k: buffers[k] for k in missing})
    model.load_state_dict(sd, strict=True)
    return model


def to_jax_params(model: torch.nn.Module, with_batch_stats: bool = False):
    """The inverse of :func:`from_jax_params` for the model's own layout:
    a flax-style params tree with numpy leaves (OIHW -> HWIO, Linear ->
    (in, out)); with ``with_batch_stats``, ``(params, batch_stats)``
    (``batch_stats`` None for a trunk without running statistics)."""
    params, stats = tree_from_state(
        model.state_dict(), {k for k, _ in model.named_buffers()})
    if not with_batch_stats:
        return params
    return params, stats


def tree_from_state(state: Mapping[str, torch.Tensor], buffers
                    ) -> Tuple[Dict[str, Any], Optional[Dict[str, Any]]]:
    """(params, batch_stats or None) flax trees of a state_dict, the
    names in ``buffers`` (running statistics) going to ``batch_stats``
    — what :func:`to_jax_params` returns for the model the state is
    of."""
    flat: Dict[str, np.ndarray] = {}
    stats: Dict[str, np.ndarray] = {}
    for key, t in state.items():
        a = t.detach().float().cpu().numpy()
        if "." not in key:  # ViT's top-level cls / pos_embed
            flat[key] = a.copy()
            continue
        path, leaf = key.rsplit(".", 1)
        if key in buffers:
            stats[path.replace(".", "/") + "/" + leaf] = a.copy()
            continue
        if leaf == "weight":
            if a.ndim == 4:
                a = a.transpose(2, 3, 1, 0)
            elif a.ndim == 2:
                a = a.T
            leaf = "kernel"
        flat[path.replace(".", "/") + "/" + leaf] = np.ascontiguousarray(a)
    return unflatten_params(flat), (unflatten_params(stats) if stats
                                    else None)


def read_weights_npz(path: str) -> Dict[str, Any]:
    """The flax tree of a weights file (numpy leaves): a bare params
    tree, or the wrapped ``{"params", "batch_stats"}`` form, which
    ``load_jax_params`` takes as it is."""
    with np.load(path) as f:
        return unflatten_params({k: f[k] for k in f.files})


def load_weights_npz(model: torch.nn.Module, path: str) -> torch.nn.Module:
    return load_jax_params(model, read_weights_npz(path))


def save_weights_npz(params: Mapping[str, Any], path: str,
                     batch_stats: Optional[Mapping[str, Any]] = None
                     ) -> None:
    """Write a params tree, wrapped with its ``batch_stats`` when given."""
    if batch_stats is not None:
        params = {"params": params, "batch_stats": batch_stats}
    np.savez(path, **flatten_params(params))
