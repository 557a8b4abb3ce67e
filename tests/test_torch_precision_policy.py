"""The port's precision policies (npairloss_tpu_torch/models/precision.py)
against the JAX package's (npairloss_tpu/models/precision.py).

Everything here is exact: registry names, ``describe()`` dicts, resolved
dtypes (compared by JAX's dtype names) and precisions, and which errors
bad policies raise.
"""

import re

import jax
import jax.numpy as jnp
import pytest
import torch

from npairloss_tpu import cli as jax_cli
from npairloss_tpu.models import get_model as jax_get_model
from npairloss_tpu.models import precision as jprec
from npairloss_tpu.train import Solver as JaxSolver
from npairloss_tpu_torch import cli
from npairloss_tpu_torch.models import (
    FLAGSHIP_POLICY,
    FLAGSHIP_TRUNK,
    available_models,
    flagship_model,
    get_model,
)
from npairloss_tpu_torch.models import precision as tprec
from npairloss_tpu_torch.models.layers import ConvBlock
from npairloss_tpu_torch.ops.npair_loss import NPairLossConfig
from npairloss_tpu_torch.train.solver import Solver

_JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _flax_conv_paths(name, **kw):
    """The "/"-joined flax paths of every ConvBlock of a JAX trunk: the
    modules that hold a ``Conv_0``."""
    model = jax_get_model(name, **kw)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, 64, 64, 3)), train=False))
    out = []

    def walk(tree, prefix):
        if "Conv_0" in tree:
            out.append("/".join(prefix))
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + [k])

    walk(shapes["params"], [])
    return sorted(out)


def _port_conv_paths(model):
    return sorted(m.path for m in model.modules() if isinstance(m, ConvBlock))


def _same(tmp, jmp):
    """A port ModulePrecision equals a JAX one field by field."""
    return (tprec.dtype_name(tmp.param_dtype)
            == jnp.dtype(jmp.param_dtype).name
            and tprec.dtype_name(tmp.compute_dtype)
            == jnp.dtype(jmp.compute_dtype).name
            and tmp.matmul_precision == jmp.matmul_precision)


def test_registry_and_default_equal_jax():
    assert list(tprec.available_policies()) == list(
        jprec.available_policies())
    assert tprec.DEFAULT_POLICY == jprec.DEFAULT_POLICY == "mxu"
    assert FLAGSHIP_POLICY == "mxu" and FLAGSHIP_TRUNK == "googlenet_mxu"
    with pytest.raises(KeyError, match="unknown precision policy"):
        tprec.get_policy("fp16")
    pol = tprec.get_policy("MXU")
    assert tprec.get_policy(pol) is pol


@pytest.mark.parametrize("name", ["bf16", "fp32_parity", "mxu"])
def test_shipped_policy_describe_equals_jax(name):
    assert tprec.get_policy(name).describe() == \
        jprec.get_policy(name).describe()


RULES = (
    (r"(^|/)conv1(/|$)", {"compute_dtype": "float32",
                          "matmul_precision": "highest"}),
    (r"inception_4[a-c]/b3x3", {"param_dtype": "bfloat16"}),
    (r"fused_1x1|b5x5_reduce", {"matmul_precision": None}),
)


def _policies(rules=RULES):
    """The same rules as a port and a JAX policy over the mxu defaults."""
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    tr = tuple((p, {k: tdt.get(v, v) if k.endswith("dtype") else v
                    for k, v in o.items()}) for p, o in rules)
    jr = tuple((p, {k: jnp.dtype(v) if k.endswith("dtype") else v
                    for k, v in o.items()}) for p, o in rules)
    base = dict(matmul_precision="default", loss_matmul_precision="default")
    return (tprec.PrecisionPolicy(name="t", rules=tr, **base),
            jprec.PrecisionPolicy(name="t", rules=jr, **base))


@pytest.mark.parametrize("trunk", ["googlenet_bn", "googlenet_mxu"])
def test_rules_resolve_flax_paths_as_jax_does(trunk):
    """The port's conv blocks carry the flax module paths (not torch's
    dotted names), and the same rules resolve every one of them — and
    their tuple forms — to the same answer as JAX."""
    paths = _flax_conv_paths(trunk)
    model = get_model(trunk, device="cpu", dtype=torch.float32)
    assert _port_conv_paths(model) == paths
    tpol, jpol = _policies()
    hits = set()
    for path in paths + ["head", "inception_4b/b3x3_reduce/x"]:
        tmp, jmp = tpol.resolve(path), jpol.resolve(path)
        assert _same(tmp, jmp), path
        assert tpol.resolve(tuple(path.split("/"))) == tmp
        hits.add((tmp.param_dtype, tmp.compute_dtype, tmp.matmul_precision))
    assert len(hits) >= 3  # the rules did select modules


def test_policy_reaches_each_conv_block():
    """A policy-aware trunk resolves each block through its path: the
    conv1 rule keeps fp32 there, the rest compute in bf16."""
    tpol, _ = _policies()
    model = get_model("googlenet_bn", device="cpu", policy=tpol)
    for m in model.modules():
        if isinstance(m, ConvBlock):
            assert m.mp == tpol.resolve(m.path), m.path
            assert m.Conv_0.weight.dtype == m.mp.param_dtype
    assert model.conv1.dtype == torch.float32
    assert model.inception_3a.b1x1.dtype == torch.bfloat16
    assert model.inception_4b.b3x3.Conv_0.weight.dtype == torch.bfloat16
    x = torch.randn(2, 64, 64, 3)
    out = model(x)
    assert out.dtype == torch.float32 and out.shape == (2, 1024)


def test_bad_policies_raise_as_jax_does():
    tdt = torch.float32
    cases = [
        (dict(rules=(("x", {"dtype": tdt}),)),
         dict(rules=(("x", {"dtype": jnp.float32}),)),
         ValueError, "unknown field"),
        (dict(rules=(("x", {"matmul_precision": "fast"}),)),
         dict(rules=(("x", {"matmul_precision": "fast"}),)),
         ValueError, "matmul_precision"),
        (dict(rules=(("(", {}),)), dict(rules=(("(", {}),)), re.error, None),
        (dict(matmul_precision="fastest"), dict(matmul_precision="fastest"),
         ValueError, "matmul_precision must be"),
        (dict(loss_matmul_precision="x"), dict(loss_matmul_precision="x"),
         ValueError, "loss_matmul_precision must be"),
    ]
    for tkw, jkw, exc, match in cases:
        with pytest.raises(exc, match=match):
            jprec.PrecisionPolicy(name="bad", **jkw)
        with pytest.raises(exc, match=match):
            tprec.PrecisionPolicy(name="bad", **tkw)


def test_fallback_equals_the_no_policy_behaviour():
    for dt in (torch.float32, torch.bfloat16):
        tmp = tprec.module_precision(None, ("anything",), dt)
        jmp = jprec.module_precision(None, ("anything",), _JAX_DTYPES[dt])
        assert tmp == tprec.ModulePrecision(torch.float32, dt, None)
        assert _same(tmp, jmp)
    # A trunk without a policy computes in its dtype over fp32 params, as
    # the policy-less constructors did; fp32_parity is the same trunk.
    x = torch.randn(2, 64, 64, 3)
    a = get_model("googlenet_bn", device="cpu", dtype=torch.float32).train()
    b = get_model("googlenet_bn", device="cpu",
                  policy="fp32_parity").train()
    assert torch.equal(a(x), b(x))


def test_cli_choices_are_pinned_to_the_registry():
    assert sorted(cli._PRECISION_CHOICES) == list(
        tprec.available_policies())
    assert cli._PRECISION_CHOICES == jax_cli._PRECISION_CHOICES
    parser = cli.build_parser()
    for cmd in ("train", "test", "extract", "time"):
        args = parser.parse_args([cmd, "--solver", "s", "--precision",
                                  "mxu"])
        assert args.precision == "mxu"
    args = parser.parse_args(["train", "--solver", "s", "--remat",
                              "--matmul-precision", "default"])
    assert args.remat and args.matmul_precision == "default"


def test_registry_names_and_flagship():
    for name in ("googlenet_embedding", "googlenet_bn", "inception_bn",
                 "googlenet_bn_s2d", "flagship"):
        assert name in available_models()
        assert cli._unported_model(name) is None
    m = flagship_model(device="cpu")
    assert m.stem_s2d and m.fuse_1x1 and m.policy.name == "mxu"
    assert m.dtype == torch.bfloat16
    bn = get_model("googlenet_bn_s2d", device="cpu", dtype=torch.float32)
    assert bn.use_bn and bn.stem_s2d and not bn.pallas_stem
    with pytest.raises(TypeError):
        get_model("mlp", device="cpu", input_shape=(8,), remat=True)


@pytest.mark.parametrize("precision,explicit,want", [
    (None, None, None), ("mxu", None, "default"), ("bf16", None, None),
    ("fp32_parity", None, None), ("mxu", "highest", "highest"),
    (None, "default", "default")])
def test_solver_takes_matmul_precision_from_the_policy(precision, explicit,
                                                        want):
    model = get_model("mlp", device="cpu", input_shape=(8,))
    s = Solver(model, NPairLossConfig(), precision=precision,
               matmul_precision=explicit)
    js = JaxSolver(jax_get_model("mlp"), input_shape=(8,),
                   precision=precision, matmul_precision=explicit)
    assert s.matmul_precision == js.matmul_precision == want
    if precision is None:
        assert s.precision_policy is None
    else:
        assert s.precision_policy.describe() == \
            js.precision_policy.describe()
