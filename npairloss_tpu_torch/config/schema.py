"""Typed views over parsed prototxt — the L5/L6 config surface (a copy of
``npairloss_tpu/config/schema.py`` over the port's own loss config and
solver config).

Maps the text-format messages of the reference's three config layers onto
the framework's dataclasses:

  * ``NPairLossParameter`` (reference: caffe.proto:3-23, read at
    npair_multi_class_loss.cpp:32-42) -> :class:`NPairLossConfig`;
  * ``SolverParameter`` subset (usage/solver.prototxt:1-17) ->
    :class:`npairloss_tpu_torch.train.solver.SolverConfig`;
  * the net prototxt's data/augmentation/loss layers
    (usage/def.prototxt) -> :class:`NetConfig` with per-phase
    :class:`DataLayerConfig`, :class:`TransformerConfig`, and the loss
    layer's mining config + top names.

Proto defaults are reproduced exactly (margin_ident 0, margin_diff 0,
identsn -1, diffsn -1, regions LOCAL, methods RAND — caffe.proto:4-22).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from npairloss_tpu_torch.config.prototxt import Message, parse, parse_file
from npairloss_tpu_torch.ops.npair_loss import (
    MiningMethod,
    MiningRegion,
    NPairLossConfig,
)

# ---------------------------------------------------------------------------
# NPairLossParameter (caffe.proto:3-23)
# ---------------------------------------------------------------------------

_REGIONS = {e.name: e for e in MiningRegion}
_METHODS = {e.name: e for e in MiningMethod}


def npair_param_to_config(msg: Optional[Message]) -> NPairLossConfig:
    """``npair_loss_param { ... }`` block -> NPairLossConfig.

    Missing fields take the proto defaults (caffe.proto:4-22); enum values
    may appear as bare identifiers (GLOBAL) or their numeric tags (0).
    """
    if msg is None:
        msg = Message()

    def enum(key: str, table, default):
        v = msg.get(key, None)
        if v is None:
            return default
        if isinstance(v, int):
            return type(default)(v)
        try:
            return table[str(v)]
        except KeyError:
            raise ValueError(f"unknown {key} value {v!r}") from None

    return NPairLossConfig(
        margin_ident=float(msg.get("margin_ident", 0.0)),
        margin_diff=float(msg.get("margin_diff", 0.0)),
        identsn=float(msg.get("identsn", -1.0)),
        diffsn=float(msg.get("diffsn", -1.0)),
        ap_mining_region=enum("ap_mining_region", _REGIONS, MiningRegion.LOCAL),
        ap_mining_method=enum("ap_mining_method", _METHODS, MiningMethod.RAND),
        an_mining_region=enum("an_mining_region", _REGIONS, MiningRegion.LOCAL),
        an_mining_method=enum("an_mining_method", _METHODS, MiningMethod.RAND),
    )


# ---------------------------------------------------------------------------
# Solver (usage/solver.prototxt)
# ---------------------------------------------------------------------------


def solver_from_message(msg: Message):
    """SolverParameter text -> (SolverConfig, net_path or None).

    Field names/defaults mirror the Caffe solver contract the reference
    exercises (solver.prototxt:1-17); ``solver_mode`` is accepted and
    ignored (the device is the solver's).
    """
    from npairloss_tpu_torch.train.solver import SolverConfig

    defaults = SolverConfig()
    cfg = SolverConfig(
        base_lr=float(msg.get("base_lr", defaults.base_lr)),
        lr_policy=str(msg.get("lr_policy", defaults.lr_policy)),
        gamma=float(msg.get("gamma", defaults.gamma)),
        stepsize=int(msg.get("stepsize", defaults.stepsize)),
        power=float(msg.get("power", defaults.power)),
        stepvalues=tuple(int(v) for v in msg.getlist("stepvalue")),
        momentum=float(msg.get("momentum", defaults.momentum)),
        weight_decay=float(msg.get("weight_decay", defaults.weight_decay)),
        max_iter=int(msg.get("max_iter", defaults.max_iter)),
        display=int(msg.get("display", defaults.display)),
        average_loss=int(msg.get("average_loss", defaults.average_loss)),
        test_iter=int(msg.get("test_iter", defaults.test_iter)),
        test_interval=int(msg.get("test_interval", defaults.test_interval)),
        test_initialization=bool(
            msg.get("test_initialization", defaults.test_initialization)
        ),
        snapshot=int(msg.get("snapshot", defaults.snapshot)),
        snapshot_prefix=str(msg.get("snapshot_prefix", defaults.snapshot_prefix)),
        random_seed=int(msg.get("random_seed", defaults.random_seed)),
    )
    net = msg.get("net", None)
    return cfg, (str(net) if net is not None else None)


def load_solver(path: str):
    return solver_from_message(parse_file(path))


# ---------------------------------------------------------------------------
# Net (usage/def.prototxt)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TransformParam:
    """Caffe ``transform_param`` (def.prototxt:10-16, 40-46)."""

    mirror: bool = False
    crop_size: int = 0
    mean_value: Tuple[float, ...] = ()
    scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """``data_transformer_l_param`` of the DataTransformer layer
    (def.prototxt:69-83): geometric + photometric augmentation."""

    delta1_sigma: float = 0.0
    delta2_sigma: float = 0.0
    delta3_sigma: float = 0.0
    delta4_sigma: float = 0.0
    rotate_angle_scope: float = 0.0
    translation_w_scope: float = 0.0
    translation_h_scope: float = 0.0
    scale_w_scope: float = 1.0
    scale_h_scope: float = 1.0
    h_flip: bool = False
    elastic_transform: bool = False
    amplitude: float = 1.0
    radius: float = 1.0


@dataclasses.dataclass(frozen=True)
class DataLayerConfig:
    """``MultibatchData`` layer (def.prototxt:2-59): the identity-balanced
    batch contract — ids/batch x imgs/id — that the mining statistics
    depend on (SURVEY.md §3.5)."""

    phase: str = "TRAIN"
    root_folder: str = ""
    source: str = ""
    batch_size: int = 0
    shuffle: bool = False
    new_height: int = 0
    new_width: int = 0
    identity_num_per_batch: int = 0
    img_num_per_identity: int = 0
    rand_identity: bool = False
    transform: TransformParam = TransformParam()


@dataclasses.dataclass(frozen=True)
class LossLayerConfig:
    name: str = ""
    bottoms: Tuple[str, ...] = ()
    tops: Tuple[str, ...] = ()
    loss_weights: Tuple[float, ...] = ()
    loss: NPairLossConfig = NPairLossConfig()


@dataclasses.dataclass(frozen=True)
class NetConfig:
    """Everything the framework consumes from a def.prototxt."""

    name: str = ""
    data: Dict[str, DataLayerConfig] = dataclasses.field(default_factory=dict)
    transformer: Optional[TransformerConfig] = None
    loss: Optional[LossLayerConfig] = None
    l2_normalize: bool = False
    # Per-parameter ((w_lr_mult, w_decay_mult), (b_lr_mult,
    # b_decay_mult)) from the net's conv `param` blocks, or None when
    # the net declares none.  The reference template trains biases at
    # 2x lr with no decay (usage/def.prototxt:90-97); Caffe scopes this
    # per layer, but the template (like bvlc_googlenet) uses one recipe
    # throughout, so the first declaring layer defines it.
    param_mults: Optional[Tuple[Tuple[float, float],
                                Tuple[float, float]]] = None
    # Set (with param_mults=None) when the net declares two DIFFERENT
    # per-layer recipes (e.g. frozen layers at lr_mult 0 plus a
    # trainable head).  One net-wide recipe is all the solver honors,
    # so TRAINING such a net must fail loudly — but parse-time is too
    # early: inference-only commands (test/extract/parse/eval) don't
    # consume multipliers and must still load the net.  The train path
    # checks this field before stepping (cli.cmd_train).
    param_mults_conflict: Optional[str] = None
    # All layers in file order as raw Messages, for anything not modeled.
    layers: Tuple[Message, ...] = ()


def _phase_of(layer: Message) -> Optional[str]:
    inc = layer.get("include", None)
    if inc is None:
        return None
    phase = inc.get("phase", None)
    return str(phase) if phase is not None else None


def _transform_param(layer: Message) -> TransformParam:
    tp = layer.get("transform_param", None)
    if tp is None:
        return TransformParam()
    return TransformParam(
        mirror=bool(tp.get("mirror", False)),
        crop_size=int(tp.get("crop_size", 0)),
        mean_value=tuple(float(v) for v in tp.getlist("mean_value")),
        scale=float(tp.get("scale", 1.0)),
    )


def _data_layer(layer: Message) -> DataLayerConfig:
    mb = layer.get("multi_batch_data_param", Message())
    return DataLayerConfig(
        phase=_phase_of(layer) or "TRAIN",
        root_folder=str(mb.get("root_folder", "")),
        source=str(mb.get("source", "")),
        batch_size=int(mb.get("batch_size", 0)),
        shuffle=bool(mb.get("shuffle", False)),
        new_height=int(mb.get("new_height", 0)),
        new_width=int(mb.get("new_width", 0)),
        identity_num_per_batch=int(mb.get("identity_num_per_batch", 0)),
        img_num_per_identity=int(mb.get("img_num_per_identity", 0)),
        rand_identity=bool(mb.get("rand_identity", False)),
        transform=_transform_param(layer),
    )


def _transformer_layer(layer: Message) -> TransformerConfig:
    tp = layer.get("data_transformer_l_param", Message())
    return TransformerConfig(
        delta1_sigma=float(tp.get("delta1_sigma", 0.0)),
        delta2_sigma=float(tp.get("delta2_sigma", 0.0)),
        delta3_sigma=float(tp.get("delta3_sigma", 0.0)),
        delta4_sigma=float(tp.get("delta4_sigma", 0.0)),
        rotate_angle_scope=float(tp.get("rotate_angle_scope", 0.0)),
        translation_w_scope=float(tp.get("translation_w_scope", 0.0)),
        translation_h_scope=float(tp.get("translation_h_scope", 0.0)),
        scale_w_scope=float(tp.get("scale_w_scope", 1.0)),
        scale_h_scope=float(tp.get("scale_h_scope", 1.0)),
        h_flip=bool(tp.get("h_flip", False)),
        elastic_transform=bool(tp.get("elastic_transform", False)),
        amplitude=float(tp.get("amplitude", 1.0)),
        radius=float(tp.get("radius", 1.0)),
    )


def _loss_layer(layer: Message) -> LossLayerConfig:
    return LossLayerConfig(
        name=str(layer.get("name", "")),
        bottoms=tuple(str(b) for b in layer.getlist("bottom")),
        tops=tuple(str(t) for t in layer.getlist("top")),
        loss_weights=tuple(float(w) for w in layer.getlist("loss_weight")),
        loss=npair_param_to_config(layer.get("npair_loss_param", None)),
    )


def net_from_message(msg: Message) -> NetConfig:
    layers = tuple(msg.getlist("layer"))
    data: Dict[str, DataLayerConfig] = {}
    transformer: Optional[TransformerConfig] = None
    loss: Optional[LossLayerConfig] = None
    l2_normalize = False
    param_mults = None
    param_mults_conflict = None
    for layer in layers:
        ltype = str(layer.get("type", ""))
        if ltype == "MultibatchData":
            d = _data_layer(layer)
            data[d.phase] = d
        elif ltype == "DataTransformer":
            transformer = _transformer_layer(layer)
        elif ltype == "L2Normalize":
            l2_normalize = True
        elif ltype == "NPairMultiClassLoss":
            loss = _loss_layer(layer)
        lm = _layer_param_mults(layer)
        if lm is not None:
            if (param_mults_conflict is None and param_mults is not None
                    and lm != param_mults):
                # One net-wide recipe is an approximation (Caffe scopes
                # param blocks per layer); two DIFFERENT recipes in one
                # net (e.g. a frozen trunk + trainable head) cannot be
                # honored.  Recorded (not raised) so inference-only
                # commands still load the net; the train path fails
                # loudly on this field rather than train silently wrong.
                param_mults_conflict = (
                    "net declares conflicting param lr/decay multipliers"
                    f" ({param_mults} vs {lm} at layer "
                    f"{str(layer.get('name', '?'))!r}); per-layer "
                    "multipliers beyond one net-wide recipe are not "
                    "supported for training"
                )
            param_mults = lm
    if param_mults_conflict is not None:
        param_mults = None
    return NetConfig(
        name=str(msg.get("name", "")),
        data=data,
        transformer=transformer,
        loss=loss,
        l2_normalize=l2_normalize,
        param_mults=param_mults,
        param_mults_conflict=param_mults_conflict,
        layers=layers,
    )


def _layer_param_mults(layer: Message):
    """((w_lr, w_decay), (b_lr, b_decay)) from a layer's two ``param``
    blocks (weight blob then bias blob, Caffe's positional order —
    usage/def.prototxt:90-97), else None.  Legacy string-valued
    ``param`` entries (blob name sharing) are ignored."""
    blocks = [b for b in layer.getlist("param") if isinstance(b, Message)]
    if len(blocks) != 2:
        return None

    def mults(b: Message) -> Tuple[float, float]:
        return (float(b.get("lr_mult", 1.0)),
                float(b.get("decay_mult", 1.0)))

    return (mults(blocks[0]), mults(blocks[1]))


def load_net(path: str) -> NetConfig:
    return net_from_message(parse_file(path))


def net_from_text(text: str) -> NetConfig:
    return net_from_message(parse(text))
