"""Caffe <-> port weight migration for the GoogLeNet and ResNet-50
trunks — port of ``npairloss_tpu/models/caffe_import.py``, numpy only.

The trees here are flax-layout trees with numpy leaves (HWIO kernels,
``models/convert.py``'s form): ``convert.to_jax_params`` gives one for a
port model, ``convert.load_jax_params`` loads one, so the mapping is the
JAX package's line for line.

Layout notes:
  * Caffe conv kernels are OIHW; the trees hold HWIO —
    ``transpose(2,3,1,0)``.  Both run cross-correlation (no kernel
    flip): the weights carry over directly.
  * Stem-geometry caveat: Caffe pads conv1 symmetrically (pad: 3)
    while the trunk's default SAME pads (2, 3) at even inputs — a
    one-input-pixel phase shift of the stride-2 sampling grid.  For
    closest-to-Caffe inference on imported weights use
    ``GoogLeNetEmbedding(caffe_pad=True)`` (CLI ``--caffe-pad``).
  * Only the embedding trunk (through pool5/7x7_s1) migrates: the
    reference's aux-classifier heads (loss1/*, loss2/*, loss3/fc...)
    are ignored on import.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

# Our param-tree block name -> caffe layer name.
_STEM = {
    "conv1": "conv1/7x7_s2",
    "conv2_reduce": "conv2/3x3_reduce",
    "conv2": "conv2/3x3",
}
_BRANCH = {
    "b1x1": "1x1",
    "b3x3_reduce": "3x3_reduce",
    "b3x3": "3x3",
    "b5x5_reduce": "5x5_reduce",
    "b5x5": "5x5",
    "pool_proj": "pool_proj",
}
_STAGES = ("3a", "3b", "4a", "4b", "4c", "4d", "4e", "5a", "5b")


def _copy_tree(tree):
    """A new nested dict over the same leaves (the JAX package's
    ``tree_map(lambda x: x, ...)``)."""
    return {k: _copy_tree(v) if isinstance(v, dict) else v
            for k, v in tree.items()}


def caffe_layer_map() -> Dict[str, str]:
    """{(our block path "inception_3a/b1x1" | "conv1") : caffe name}."""
    out = dict(_STEM)
    for stage in _STAGES:
        for ours, theirs in _BRANCH.items():
            out[f"inception_{stage}/{ours}"] = f"inception_{stage}/{theirs}"
    return out


def googlenet_params_from_caffemodel(
    blobs: Dict[str, List[np.ndarray]], params,
):
    """New params for ``GoogLeNetEmbedding`` from caffemodel blobs.

    ``params`` is the target param tree (``convert.to_jax_params`` of
    the model) — used for shape validation and to carry any entries the
    caffemodel lacks.
    Raises KeyError/ValueError on missing layers or shape mismatches
    (silent partial loads corrupt finetunes).  Import the PLAIN trunk
    and apply `conv1_kernel_to_s2d` / `fuse_inception_1x1_params`
    afterwards for the s2d and fused variants
    (``convert.load_jax_params`` does).
    """
    new = _copy_tree(params)
    for path, caffe_name in caffe_layer_map().items():
        if caffe_name not in blobs:
            raise KeyError(
                f"caffemodel is missing layer {caffe_name!r} "
                f"(wanted for {path})"
            )
        parts = path.split("/")
        node = new
        for p in parts:
            node = node[p]
        conv = node["Conv_0"]
        want = tuple(conv["kernel"].shape)  # HWIO
        k = np.asarray(blobs[caffe_name][0], dtype=np.float32)
        if k.ndim != 4:
            raise ValueError(
                f"{caffe_name}: kernel blob has shape {k.shape}, wanted 4-D"
            )
        k = k.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        if tuple(k.shape) != want:
            raise ValueError(
                f"{caffe_name}: kernel {k.shape} vs model {want}"
            )
        conv["kernel"] = k
        if "bias" in conv:
            if len(blobs[caffe_name]) < 2:
                raise ValueError(f"{caffe_name}: missing bias blob")
            b = np.asarray(
                blobs[caffe_name][1], dtype=np.float32
            ).reshape(-1)
            if b.shape != tuple(conv["bias"].shape):
                raise ValueError(
                    f"{caffe_name}: bias {b.shape} vs model "
                    f"{conv['bias'].shape}"
                )
            conv["bias"] = b
    return new


def caffemodel_layers_from_googlenet_params(
    params,
) -> Dict[str, List[np.ndarray]]:
    """The reverse mapping: {caffe layer name: [kernel OIHW, bias]}.

    Feed to ``config.caffemodel.write_caffemodel`` to hand a trunk
    trained here back to a Caffe deployment."""
    out: Dict[str, List[np.ndarray]] = {}
    for path, caffe_name in caffe_layer_map().items():
        node = params
        for p in path.split("/"):
            node = node[p]
        conv = node["Conv_0"]
        k = np.asarray(conv["kernel"]).transpose(3, 2, 0, 1)  # HWIO -> OIHW
        blobs = [k.astype(np.float32)]
        if "bias" in conv:
            blobs.append(np.asarray(conv["bias"], dtype=np.float32))
        out[caffe_name] = blobs
    return out


# -- ResNet-50 (BASELINE.json config 3's trunk) -----------------------------
#
# Caffe ResNet-50 (the canonical release the reference era used) names
# convs ``res{stage}{letter}_branch{1,2a,2b,2c}`` with separate
# ``bn*`` (mean, var, scale_factor) and ``scale*`` (gamma, beta) layers;
# our trunk is models/resnet.py (conv_stem/bn_stem +
# stage{s}_block{b}/{conv1..3,conv_proj,bn1..3,bn_proj}).
#
# Stride caveat: Caffe ResNet-50 is v1 (stride 2 on the 1x1 branch2a);
# this trunk is v1.5-style (stride on the 3x3).  Kernel SHAPES are
# identical, so the weights migrate cleanly as a finetune init — the
# same shape-compatible transfer torchvision's v1.5 popularized.

_RESNET_BRANCH = {
    "conv1": "branch2a", "bn1": "branch2a",
    "conv2": "branch2b", "bn2": "branch2b",
    "conv3": "branch2c", "bn3": "branch2c",
    "conv_proj": "branch1", "bn_proj": "branch1",
}


def _resnet_block_names(stage_sizes=(3, 4, 6, 3)):
    """[(ours_block, caffe_block)] e.g. ("stage1_block1", "2a")."""
    out = []
    for s, n in enumerate(stage_sizes):
        for b in range(n):
            out.append((f"stage{s + 1}_block{b + 1}",
                        f"{s + 2}{chr(ord('a') + b)}"))
    return out


def _caffe_bn(blobs, bn_name, scale_name, want_c):
    """(scale, bias, mean, var) from a Caffe BatchNorm + Scale pair.

    Caffe's BatchNorm stores running sums times a scale_factor blob;
    gamma/beta live in the separate Scale layer."""
    if bn_name not in blobs:
        raise KeyError(f"caffemodel is missing layer {bn_name!r}")
    if scale_name not in blobs:
        raise KeyError(f"caffemodel is missing layer {scale_name!r}")
    bn = [np.asarray(b, np.float32).reshape(-1) for b in blobs[bn_name]]
    sc = [np.asarray(b, np.float32).reshape(-1) for b in blobs[scale_name]]
    if len(bn) < 2 or len(sc) < 2:
        raise ValueError(f"{bn_name}/{scale_name}: unexpected blob count")
    factor = float(bn[2][0]) if len(bn) > 2 and bn[2].size else 1.0
    factor = factor if factor != 0.0 else 1.0
    mean, var = bn[0] / factor, bn[1] / factor
    gamma, beta = sc[0], sc[1]
    for name, arr in (("mean", mean), ("var", var),
                      ("gamma", gamma), ("beta", beta)):
        if arr.shape != (want_c,):
            raise ValueError(
                f"{bn_name}: {name} has shape {arr.shape}, wanted ({want_c},)"
            )
    return gamma, beta, mean, var


def resnet50_params_from_caffemodel(blobs, params, batch_stats):
    """(params, batch_stats) for ``ResNetEmbedding(stage_sizes=(3,4,6,3))``
    from canonical Caffe ResNet-50 blobs.  Loud on missing layers and
    shape mismatches, like the GoogLeNet path."""
    new_p = _copy_tree(params)
    new_s = _copy_tree(batch_stats)

    def set_conv(node, caffe_name):
        k = np.asarray(blobs[caffe_name][0], np.float32)
        if k.ndim != 4:
            raise ValueError(f"{caffe_name}: kernel {k.shape} not 4-D")
        k = k.transpose(2, 3, 1, 0)
        want = tuple(np.shape(node["kernel"]))
        if tuple(k.shape) != want:
            raise ValueError(f"{caffe_name}: kernel {k.shape} vs {want}")
        node["kernel"] = k

    def set_bn(p_node, s_node, bn_name, scale_name):
        c = int(np.shape(p_node["scale"])[0])
        gamma, beta, mean, var = _caffe_bn(blobs, bn_name, scale_name, c)
        p_node["scale"], p_node["bias"] = gamma, beta
        s_node["mean"], s_node["var"] = mean, var

    if "conv1" not in blobs:
        raise KeyError("caffemodel is missing layer 'conv1'")
    set_conv(new_p["conv_stem"], "conv1")
    set_bn(new_p["bn_stem"], new_s["bn_stem"], "bn_conv1", "scale_conv1")

    for ours_block, cb in _resnet_block_names():
        p_blk, s_blk = new_p[ours_block], new_s[ours_block]
        for ours, branch in _RESNET_BRANCH.items():
            if ours not in p_blk:
                continue  # non-proj blocks have no conv_proj/bn_proj
            if ours.startswith("conv"):
                name = f"res{cb}_{branch}"
                if name not in blobs:
                    raise KeyError(f"caffemodel is missing layer {name!r}")
                set_conv(p_blk[ours], name)
            else:
                set_bn(p_blk[ours], s_blk[ours],
                       f"bn{cb}_{branch}", f"scale{cb}_{branch}")
    return new_p, new_s


def caffemodel_layers_from_resnet50_params(params, batch_stats):
    """Reverse mapping: canonical Caffe ResNet-50 layer blobs
    (BatchNorm scale_factor written as 1)."""
    out: Dict[str, List[np.ndarray]] = {}

    def put(conv_node, bn_node, stats_node, conv_name, bn_name, scale_name):
        k = np.asarray(conv_node["kernel"], np.float32).transpose(3, 2, 0, 1)
        out[conv_name] = [k]
        out[bn_name] = [
            np.asarray(stats_node["mean"], np.float32),
            np.asarray(stats_node["var"], np.float32),
            np.ones((1,), np.float32),
        ]
        out[scale_name] = [
            np.asarray(bn_node["scale"], np.float32),
            np.asarray(bn_node["bias"], np.float32),
        ]

    put(params["conv_stem"], params["bn_stem"], batch_stats["bn_stem"],
        "conv1", "bn_conv1", "scale_conv1")
    for ours_block, cb in _resnet_block_names():
        p_blk, s_blk = params[ours_block], batch_stats[ours_block]
        for ours, branch in _RESNET_BRANCH.items():
            if ours not in p_blk or not ours.startswith("conv"):
                continue
            bn = ours.replace("conv", "bn")
            put(p_blk[ours], p_blk[bn], s_blk[bn],
                f"res{cb}_{branch}",
                f"bn{cb}_{branch}", f"scale{cb}_{branch}")
    return out


# -- SolverState history (optimizer-state migration) ------------------------
#
# Caffe's SGDSolver snapshots its momentum as SolverState.history: one
# BlobProto per learnable parameter, in net parameter order (layer order
# of the prototxt, weight then bias within a layer).  The GoogLeNet
# trunk's learnable params are exactly the conv kernels+biases that
# caffe_layer_map() enumerates, and the solver's momentum (as a tree)
# mirrors the params tree — so the weight converters apply verbatim to
# momentum and define the canonical blob order.


def googlenet_history_from_momentum(momentum_params) -> List[np.ndarray]:
    """SolverState ``history`` blob list (net order, OIHW kernels) from a
    momentum tree shaped like the GoogLeNet params tree."""
    hist: List[np.ndarray] = []
    for blobs in caffemodel_layers_from_googlenet_params(
            momentum_params).values():
        hist.extend(blobs)
    return hist


def googlenet_momentum_from_history(history, momentum_template,
                                    strict: bool = False):
    """(momentum tree, skipped blob count) from SolverState ``history``.

    The reference's full training net carries aux-classifier heads
    (loss1/*, loss2/*) whose learnable params are INTERLEAVED with the
    trunk's in net order, so a genuine reference ``.solverstate`` has
    more history blobs than the embedding trunk.  Default mode aligns
    by shape-guided greedy matching: expected trunk blobs (OIHW kernel
    then bias per conv, layer-map order) consume history in order,
    skipping non-matching aux blobs — safe for the GoogLeNet+aux
    topology because within a layer the bias immediately follows its
    kernel (nothing can interpose), and across layers the skip scans
    for a 4-D kernel shape no aux blob shares.  ``strict=True`` demands
    an exact 1:1 sequence (round-trip tests / files this repo wrote).
    Every expected blob must be found and shapes are validated — a
    silent partial load would corrupt the resumed trajectory."""
    named: Dict[str, List[np.ndarray]] = {}
    i = 0
    skipped = 0
    for path, caffe_name in caffe_layer_map().items():
        node = momentum_template
        for p in path.split("/"):
            node = node[p]
        conv = node["Conv_0"]
        h, w, cin, cout = conv["kernel"].shape
        expect = [(cout, cin, h, w)]  # history kernels are OIHW
        if "bias" in conv:
            expect.append(tuple(conv["bias"].shape))

        def _matches(blob, shp):
            if len(shp) == 4:  # kernel: exact 4-D match
                return tuple(blob.shape) == shp
            # bias (n,): tolerate the legacy 4-D (1,1,1,n) blob storage
            # the weight path also accepts (old-Caffe forks write it).
            return blob.size == shp[0] and max(blob.shape) == blob.size

        blobs: List[np.ndarray] = []
        for shp in expect:
            while i < len(history) and not _matches(history[i], shp):
                if strict:
                    raise ValueError(
                        f"solverstate history blob {i} has shape "
                        f"{tuple(history[i].shape)}; layer "
                        f"{caffe_name!r} wanted {shp} (strict mode)"
                    )
                skipped += 1
                i += 1
            if i >= len(history):
                raise ValueError(
                    f"solverstate history exhausted at layer "
                    f"{caffe_name!r} (wanted shape {shp}) — "
                    f"{len(history)} blobs, {skipped} skipped"
                )
            blobs.append(np.asarray(history[i]))
            i += 1
        named[caffe_name] = blobs
    trailing = len(history) - i
    if trailing:
        if strict:
            raise ValueError(
                f"solverstate history has {trailing} trailing blobs the "
                "GoogLeNet trunk does not consume (strict mode)"
            )
        skipped += trailing
    return googlenet_params_from_caffemodel(named, momentum_template), \
        skipped
