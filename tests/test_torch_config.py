"""The port's prototxt front end (npairloss_tpu_torch/config) against the
JAX package's ``config``: every ``examples/*.prototxt`` parses to the same
values, and the parser's primitives agree.  Exact comparisons.
"""

import dataclasses
import glob
import os

import pytest

from npairloss_tpu import config as jcfg
from npairloss_tpu.train import SolverConfig as JaxSolverConfig
from npairloss_tpu_torch.config import prototxt as tproto
from npairloss_tpu_torch.config import schema as tschema
from npairloss_tpu_torch.train.solver import SolverConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(glob.glob(os.path.join(REPO, "examples", "*.prototxt")))
SOLVERS = [p for p in EXAMPLES if p.endswith("_solver.prototxt")]
NETS = [p for p in EXAMPLES if not p.endswith("_solver.prototxt")]


def _plain(v):
    """Dataclass/enum/Message tree -> comparable plain values (enums by
    value, so the two packages' enum classes compare equal)."""
    if dataclasses.is_dataclass(v):
        return {f.name: _plain(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    if isinstance(v, (jcfg.Message, tproto.Message)):
        return [(k, _plain(x)) for k, x in v.items()]
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if hasattr(v, "value") and hasattr(v, "name"):  # IntEnum
        return int(v)
    return v


def test_examples_found():
    assert len(SOLVERS) >= 3 and len(NETS) >= 4


@pytest.mark.parametrize("path", NETS, ids=os.path.basename)
def test_net_parses_like_jax(path):
    assert _plain(tschema.load_net(path)) == _plain(jcfg.load_net(path))


@pytest.mark.parametrize("path", SOLVERS, ids=os.path.basename)
def test_solver_parses_like_jax(path):
    cfg, net = tschema.load_solver(path)
    jc, jnet = jcfg.load_solver(path)
    assert net == jnet
    got = dataclasses.asdict(cfg)
    want = dataclasses.asdict(jc)
    assert set(got) <= set(want)
    assert got == {k: want[k] for k in got}


def test_solver_config_defaults_match_jax():
    """The port's SolverConfig is the JAX one, field for field, in the
    same order, with the same defaults."""
    got = dataclasses.asdict(SolverConfig())
    want = dataclasses.asdict(JaxSolverConfig())
    assert got == {k: want[k] for k in got}
    assert set(want) - set(got) == set()
    assert list(got) == list(want)


TEXTS = [
    'name: "n" x: 1 y: -2.5e-3 z: true s: "a\\"b" e: GLOBAL',
    "layer { name: 'a' param { lr_mult: 1 decay_mult: 1 } "
    "param { lr_mult: 2 decay_mult: 0 } } layer: { name: 'b' }",
    "# comment with non-ASCII text: 中文\nk: 1 # trailing\n.\n",
]


@pytest.mark.parametrize("text", TEXTS)
def test_parser_primitives_match_jax(text):
    got, want = tproto.parse(text), jcfg.parse(text)
    assert _plain(got) == _plain(want)
    assert tproto.dumps(got) == jcfg.dumps(want)


def test_parse_errors_match_jax():
    for bad in ("a {", "}", "a:", "a b", "a: }"):
        with pytest.raises(tproto.PrototxtParseError):
            tproto.parse(bad)
        with pytest.raises(jcfg.PrototxtParseError):
            jcfg.parse(bad)


def test_npair_param_to_config_numeric_enums_and_defaults():
    msg = tproto.parse("npair_loss_param { ap_mining_region: 0 "
                       "an_mining_method: RELATIVE_EASY diffsn: -0.2 }")
    got = tschema.npair_param_to_config(msg["npair_loss_param"])
    want = jcfg.npair_param_to_config(jcfg.parse(
        "ap_mining_region: 0 an_mining_method: RELATIVE_EASY diffsn: -0.2"))
    assert _plain(got) == _plain(want)
    assert _plain(tschema.npair_param_to_config(None)) == _plain(
        jcfg.npair_param_to_config(None))
    with pytest.raises(ValueError, match="unknown"):
        tschema.npair_param_to_config(tproto.parse("ap_mining_method: X"))


def test_net_from_text_param_mults_conflict_matches_jax():
    text = """
name: "n"
layer { name: "a" type: "Convolution"
        param { lr_mult: 1 decay_mult: 1 } param { lr_mult: 2 decay_mult: 0 } }
layer { name: "b" type: "Convolution"
        param { lr_mult: 0 decay_mult: 0 } param { lr_mult: 0 decay_mult: 0 } }
"""
    got, want = tschema.net_from_text(text), jcfg.net_from_text(text)
    assert _plain(got) == _plain(want)
    assert got.param_mults is None and got.param_mults_conflict
