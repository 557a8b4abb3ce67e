"""The port's small CLI commands against the JAX CLI on the same inputs:
``parse`` (byte for byte on every ``examples/*.prototxt``, text and
``--json``), ``device-query`` (the same keys; ``--device cpu`` lists the
CPU) and ``train --debug-checks`` in both loops.

``--debug-checks`` checks a step's metric scalars on the host inside the
synchronous loop's step, where the JAX step checks them: before the
loop's ``step.nan_loss`` poison, which only the observed row sees, so
neither CLI stops on that failpoint, in either loop.  A genuinely
non-finite step (a NaN parameter in the initial weights) stops both
synchronous loops with the same ``FloatingPointError`` naming the same
metric; neither pipelined loop checks (JAX's calls no check there), so
both run to the end.  The JAX CLI runs with ``--mesh 1`` (one device, as
the port's).  The slice's new flags and commands (``serve
--telemetry-dir/--trace-dir``, ``prof --step serve``/``--fleet`` and the
serve-profile flags, ``train --debug-checks``, ``parse``, ``timeline``)
carry the JAX CLI's option strings, defaults, choices and types."""

import contextlib
import glob
import io
import json
import os
import re

import numpy as np
import pytest

from npairloss_tpu import cli as jax_cli
from npairloss_tpu_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(glob.glob(os.path.join(REPO, "examples", "*.prototxt")))


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.mark.parametrize("as_json", [False, True], ids=["text", "json"])
@pytest.mark.parametrize("path", EXAMPLES, ids=os.path.basename)
def test_parse_matches_jax_cli_byte_for_byte(path, as_json):
    extra = ["--json"] if as_json else []
    rc_j, out_j = _run(jax_cli.main, ["parse", path, *extra])
    rc_p, out_p = _run(cli.main, ["parse", path, *extra])
    assert rc_p == rc_j == 0
    assert out_p == out_j
    assert out_p.strip()


def test_device_query_keys_match_jax_cli():
    rc_j, out_j = _run(jax_cli.main, ["device-query"])
    rc_p, out_p = _run(cli.main, ["device-query", "--device", "cpu"])
    assert rc_p == rc_j == 0
    j, p = json.loads(out_j), json.loads(out_p)
    assert list(p) == list(j)
    assert list(p["devices"][0]) == list(j["devices"][0])
    assert p["default_backend"] == j["default_backend"] == "cpu"
    assert (p["process_index"], p["process_count"]) == (
        j["process_index"], j["process_count"]) == (0, 1)
    dev, jdev = p["devices"][0], j["devices"][0]
    assert (dev["platform"], dev["device_kind"]) == (
        jdev["platform"], jdev["device_kind"]) == ("cpu", "cpu")
    assert p["local_device_count"] == len(p["devices"]) == 1


def test_device_query_without_a_card_refuses():
    # Nothing falls back to the CPU quietly: the default is the card.
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["device-query"])


# -- train --debug-checks -----------------------------------------------------


def _failpoints():
    from npairloss_tpu.resilience import failpoints as jfp
    from npairloss_tpu_torch.resilience import failpoints as pfp

    return jfp, pfp


@pytest.fixture
def clean_checks():
    from npairloss_tpu.utils import debug as jdebug
    from npairloss_tpu_torch.utils import debug as pdebug

    jfp, pfp = _failpoints()
    yield
    jdebug.enable_debug_checks(False)
    pdebug.enable_debug_checks(False)
    jfp.reset()
    pfp.reset()


def _argv(tmp_path, name, pipeline, extra=()):
    return ["train", "--solver",
            os.path.join(REPO, "examples", "tiny_solver.prototxt"),
            "--synthetic", "--debug-checks", "--no-preempt-handler",
            "--snapshot_prefix", str(tmp_path / f"{name}_"),
            *(["--pipeline"] if pipeline else []), *extra]


def _mask(line):
    return re.sub(r"-?\d+(\.\d+)?(e[-+]?\d+)?", "#", line)


def _displays(out):
    return [ln for ln in out.splitlines() if ln.startswith("iter ")]


@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipelined"])
def test_debug_checks_do_not_see_the_nan_loss_failpoint(
        tmp_path, clean_checks, pipeline):
    jfp, pfp = _failpoints()
    outs = {}
    for name, main, fp, extra in (
            ("jax", jax_cli.main, jfp, ["--mesh", "1"]),
            ("port", cli.main, pfp, ["--device", "cpu"])):
        fp.arm("step.nan_loss", times=1, delay=2)
        rc, out = _run(main, _argv(tmp_path, name, pipeline, extra))
        fp.reset()
        assert rc == 0, name
        outs[name] = _displays(out)
    assert [_mask(ln) for ln in outs["port"]] == [
        _mask(ln) for ln in outs["jax"]]
    nan = lambda lines: [i for i, ln in enumerate(lines)  # noqa: E731
                         if "loss=nan" in ln]
    assert nan(outs["port"]) == nan(outs["jax"]) == [0]


def _nan_weights(tmp_path):
    """One parameter tree with a NaN in the head's bias, written as the
    port's .npz and the JAX CLI's msgpack."""
    import flax.serialization

    from npairloss_tpu_torch.models import get_model
    from npairloss_tpu_torch.models.convert import (
        save_weights_npz,
        to_jax_params,
    )

    model = get_model("mlp", input_shape=(8, 8, 3), seed=3, device="cpu")
    tree = to_jax_params(model)
    tree["head"]["bias"] = np.array(tree["head"]["bias"], np.float32)
    tree["head"]["bias"][0] = np.nan
    npz = tmp_path / "w.npz"
    save_weights_npz(tree, str(npz))
    msg = tmp_path / "w.msgpack"
    msg.write_bytes(flax.serialization.msgpack_serialize(tree))
    return str(msg), str(npz)


@pytest.mark.parametrize("pipeline", [False, True], ids=["sync", "pipelined"])
def test_debug_checks_stop_a_non_finite_step_as_jax_does(
        tmp_path, clean_checks, pipeline):
    msg, npz = _nan_weights(tmp_path)
    results = {}
    for name, main, extra in (
            ("jax", jax_cli.main, ["--mesh", "1", "--weights", msg]),
            ("port", cli.main, ["--device", "cpu", "--weights", npz])):
        try:
            rc, out = _run(main, _argv(tmp_path, name, pipeline, extra))
            results[name] = ("rc", rc, [_mask(ln) for ln in _displays(out)])
        except FloatingPointError as e:
            results[name] = ("raised", type(e).__name__, str(e))
    assert results["port"] == results["jax"]
    if pipeline:
        assert results["port"][:2] == ("rc", 0)
    else:
        kind, typ, message = results["port"]
        assert kind == "raised" and typ == "FloatingPointError"
        assert re.match(r"non-finite step metrics\['\w+'\]: nan", message)


# -- the new commands and flags beside the JAX CLI's ----------------------------

NEW_FLAGS = [("serve", "telemetry_dir"), ("serve", "trace_dir"),
             ("prof", "step"), ("prof", "fleet"), ("prof", "gallery"),
             ("prof", "dim"), ("prof", "top_k"), ("prof", "buckets"),
             ("prof", "out"), ("train", "debug_checks"), ("parse", "file"),
             ("parse", "json"), ("timeline", "run_dir"), ("timeline", "out")]


@pytest.mark.parametrize("cmd,dest", NEW_FLAGS,
                         ids=[f"{c}-{d}" for c, d in NEW_FLAGS])
def test_new_flags_match_the_jax_cli(cmd, dest, monkeypatch):
    from test_torch_serve_tier import _jax_parser, _sub_actions

    mine = _sub_actions(cli.build_parser(), cmd)[dest]
    theirs = _sub_actions(_jax_parser(monkeypatch), cmd)[dest]
    assert mine.option_strings == theirs.option_strings
    assert mine.default == theirs.default
    assert mine.choices == theirs.choices
    assert mine.type == theirs.type
    assert mine.nargs == theirs.nargs
