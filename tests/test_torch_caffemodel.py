"""Caffe weight interchange in the port (``config/caffemodel.py``,
``models/caffe_import.py``, ``import-caffemodel`` / ``export-caffemodel``,
``train --caffe-solverstate``, ``--caffe-pad``) against the JAX package.

No real ``.caffemodel`` exists here, so the blobs are the JAX package's
own export of random trees (numpy seed): the port's codec must write the
JAX codec's bytes for the same layers and solverstate; its GoogLeNet and
ResNet-50 imports must give the JAX imports' trees leaf for leaf (the
ResNet import divides by Caffe BatchNorm's scale factor); its exports
must be byte-equal to JAX's; the momentum <-> history maps must agree
and round-trip, aux-classifier blobs skipped alike; ``caffe_pad`` must
give the JAX trunk's embeddings (fp32, within 1e-5) and differ from the
SAME stem; the CLI round trip (caffemodel -> ``.npz`` -> caffemodel)
must reproduce the file's bytes and the JAX CLI's imported tree; and
``--caffe-solverstate`` without ``--weights``, with ``--resume`` or on
another trunk than plain ``googlenet`` exits 2, as in JAX
(``npairloss_tpu/cli.py:345-389``).
"""

import io
import json
import os
from contextlib import redirect_stdout

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npairloss_tpu import cli as jax_cli
from npairloss_tpu.config import caffemodel as jcodec
from npairloss_tpu.models import caffe_import as jci
from npairloss_tpu.models import get_model as jax_get_model
from npairloss_tpu_torch import cli
from npairloss_tpu_torch.config import caffemodel as tcodec
from npairloss_tpu_torch.models import caffe_import as tci
from npairloss_tpu_torch.models import convert, get_model
from npairloss_tpu_torch.train.solver import Solver, SolverConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_tree(template, seed, positive=()):
    """Random fp32 leaves in ``template``'s shapes (a leaf whose path
    ends with one of ``positive`` is drawn in (0.5, 1.5))."""
    rng = np.random.default_rng(seed)
    flat = convert.flatten_params(template)
    return convert.unflatten_params({
        k: (rng.uniform(0.5, 1.5, v.shape) if k.endswith(positive)
            else rng.standard_normal(v.shape)).astype(np.float32)
        for k, v in flat.items()})


def _jax_template(name):
    shapes = jax.eval_shape(
        lambda: jax_get_model(name, dtype=jnp.float32).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)),
            train=False))
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    return zeros["params"], zeros.get("batch_stats", {})


@pytest.fixture(scope="module")
def trees():
    """Per family: random (params, batch_stats) and the JAX export's
    blobs of them."""
    gp, _ = _jax_template("googlenet")
    rp, rs = _jax_template("resnet50")
    g = _random_tree(gp, 1)
    r = _random_tree(rp, 2, ("scale",))
    s = _random_tree(rs, 3, ("var",))
    return {
        "googlenet": (g, {}, jci.caffemodel_layers_from_googlenet_params(g)),
        "resnet50": (r, s, jci.caffemodel_layers_from_resnet50_params(r, s)),
    }


def _assert_trees_equal(got, want):
    got, want = convert.flatten_params(got), convert.flatten_params(want)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert np.array_equal(got[k], v), k


def test_codec_writes_the_jax_bytes(trees):
    layers = trees["resnet50"][2]
    data = tcodec.write_caffemodel(layers)
    assert data == jcodec.write_caffemodel(layers)
    assert tcodec.write_caffemodel(layers, "n") == \
        jcodec.write_caffemodel(layers, "n")
    back = tcodec.parse_caffemodel(data)
    assert list(back) == list(jcodec.parse_caffemodel(data)) == list(layers)
    for name, blobs in layers.items():
        for a, b in zip(back[name], blobs):
            assert np.array_equal(a, b) and a.dtype == np.float32
    hist = [b for blobs in trees["googlenet"][2].values() for b in blobs]
    ss = tcodec.write_solverstate(17, hist, current_step=2,
                                  learned_net="m.caffemodel")
    assert ss == jcodec.write_solverstate(17, hist, current_step=2,
                                          learned_net="m.caffemodel")
    got = tcodec.parse_solverstate(ss)
    want = jcodec.parse_solverstate(ss)
    assert {k: got[k] for k in ("iter", "learned_net", "current_step")} == \
        {k: want[k] for k in ("iter", "learned_net", "current_step")} == \
        {"iter": 17, "learned_net": "m.caffemodel", "current_step": 2}
    assert all(np.array_equal(a, b) for a, b in zip(got["history"], hist))


@pytest.mark.parametrize("family", ["googlenet", "resnet50"])
def test_import_equals_jax_and_export_is_byte_equal(trees, family):
    params, stats, layers = trees[family]
    tp, ts = cli._template(family)
    jp, js = _jax_template(family)
    if family == "resnet50":
        # A Caffe BatchNorm stores its running sums times a scale factor.
        layers = {k: ([v[0] * 4.0, v[1] * 4.0, np.array([4.0], np.float32)]
                      if k.startswith("bn") else v)
                  for k, v in layers.items()}
        got = tci.resnet50_params_from_caffemodel(layers, tp, ts)
        want = jci.resnet50_params_from_caffemodel(layers, jp, js)
        for g, w in zip(got, want):
            _assert_trees_equal(g, jax.tree_util.tree_map(np.asarray, w))
        _assert_trees_equal(got[0], params)
        exported = tci.caffemodel_layers_from_resnet50_params(*got)
        want_layers = jci.caffemodel_layers_from_resnet50_params(
            params, stats)
    else:
        got = tci.googlenet_params_from_caffemodel(layers, tp)
        want = jci.googlenet_params_from_caffemodel(layers, jp)
        _assert_trees_equal(got, jax.tree_util.tree_map(np.asarray, want))
        _assert_trees_equal(got, params)
        exported = tci.caffemodel_layers_from_googlenet_params(got)
        want_layers = jci.caffemodel_layers_from_googlenet_params(params)
    assert tcodec.write_caffemodel(exported) == \
        jcodec.write_caffemodel(want_layers)


def test_solverstate_history_round_trips_as_in_jax(trees):
    mom = _random_tree(trees["googlenet"][0], 9)
    hist = tci.googlenet_history_from_momentum(mom)
    want = jci.googlenet_history_from_momentum(mom)
    assert len(hist) == len(want) == 2 * len(tci.caffe_layer_map())
    assert all(np.array_equal(a, b) for a, b in zip(hist, want))
    st = tcodec.parse_solverstate(tcodec.write_solverstate(5, hist))
    back, skipped = tci.googlenet_momentum_from_history(
        st["history"], trees["googlenet"][0], strict=True)
    assert skipped == 0
    _assert_trees_equal(back, mom)
    # Aux-classifier blobs interleaved in net order are skipped alike.
    aux = [np.ones((128, 512, 1, 1), np.float32), np.ones(128, np.float32)]
    mixed = hist[:40] + aux + hist[40:] + aux
    got = tci.googlenet_momentum_from_history(mixed, trees["googlenet"][0])
    want = jci.googlenet_momentum_from_history(mixed, trees["googlenet"][0])
    assert got[1] == want[1] == 4
    _assert_trees_equal(got[0], jax.tree_util.tree_map(np.asarray, want[0]))


def test_caffe_pad_equals_the_jax_stem(monkeypatch):
    monkeypatch.setattr(torch.backends.mkldnn, "enabled", False)
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    jm = jax_get_model("googlenet", dtype=jnp.float32, caffe_pad=True)
    params = jax.tree_util.tree_map(np.array, jax.jit(
        lambda k, x: jm.init(k, x, train=False))(
            jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    for path, leaf in convert.flatten_params(params).items():
        if path.endswith("bias"):
            leaf[...] = 0.0  # the 0.2 init biases collapse the embedding
    want = np.asarray(jax.jit(lambda p, x: jm.apply(
        {"params": p}, x, train=False))(params, jnp.asarray(x)))
    embs = {}
    for pad in (True, False):
        tm = get_model("googlenet", device="cpu", dtype=torch.float32,
                       caffe_pad=pad)
        convert.load_jax_params(tm, params)
        with torch.no_grad():
            embs[pad] = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(embs[True], want, rtol=0, atol=1e-5)
    assert np.abs(embs[False] - want).max() > 1e-3
    # The s2d stem ignores it, as in JAX; the other trunks refuse it.
    assert get_model("googlenet_s2d", device="cpu", caffe_pad=True) \
        .conv1.padding == ((1, 2), (1, 2))
    with pytest.raises(TypeError):
        get_model("resnet18", device="cpu", caffe_pad=True)


def _run(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.mark.parametrize("family", ["googlenet", "resnet50"])
def test_cli_import_export_round_trip(tmp_path, trees, family):
    _, _, layers = trees[family]
    src = tmp_path / "in.caffemodel"
    src.write_bytes(tcodec.write_caffemodel(layers))
    npz, back = tmp_path / "w.npz", tmp_path / "out.caffemodel"
    rc, out = _run(cli.main, ["import-caffemodel", "--weights", str(src),
                              "--model", family, "--out", str(npz)])
    assert rc == 0, out
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["caffemodel_layers"] == len(layers)
    msg = tmp_path / "w.msgpack"
    rc, jout = _run(jax_cli.main, ["import-caffemodel", "--weights",
                                   str(src), "--model", family, "--out",
                                   str(msg)])
    assert rc == 0
    assert json.loads(jout.strip().splitlines()[-1])["mapped_convs"] == \
        rec["mapped_convs"]
    jtree = flax.serialization.msgpack_restore(msg.read_bytes())
    if not jtree["batch_stats"]:
        jtree = jtree["params"]
    _assert_trees_equal(convert.read_weights_npz(str(npz)), jtree)
    rc, out = _run(cli.main, ["export-caffemodel", "--weights", str(npz),
                              "--model", family, "--out", str(back)])
    assert rc == 0, out
    assert back.read_bytes() == src.read_bytes()


def _small_net(tmp_path):
    net = open(os.path.join(REPO, "examples/googlenet_cub.prototxt")).read()
    for a, b in (("crop_size: 224", "crop_size: 32"),
                 ("batch_size: 120", "batch_size: 8"),
                 ("identity_num_per_batch: 60", "identity_num_per_batch: 4"),
                 ("batch_size: 30", "batch_size: 8"),
                 ("identity_num_per_batch: 15", "identity_num_per_batch: 4")):
        net = net.replace(a, b)
    path = tmp_path / "net.prototxt"
    path.write_text(net)
    solver = tmp_path / "solver.prototxt"
    solver.write_text(
        f'net: "{path}"\nbase_lr: 0.001\nlr_policy: "fixed"\n'
        "momentum: 0.9\nweight_decay: 0.0002\nmax_iter: 8\ndisplay: 1\n"
        "test_iter: 1\ntest_interval: 0\ntest_initialization: false\n"
        f'snapshot: 0\nsnapshot_prefix: "{tmp_path}/snap_"\n')
    return str(solver)


def test_caffe_solverstate_refusals(tmp_path, caplog):
    solver = _small_net(tmp_path)
    base = ["train", "--solver", solver, "--synthetic", "--device", "cpu"]
    ss = tmp_path / "s.solverstate"
    ss.write_bytes(tcodec.write_solverstate(3, []))
    assert cli.main(base + ["--caffe-solverstate", str(ss)]) == 2
    assert "--caffe-solverstate needs --weights" in caplog.text
    assert cli.main(base + ["--caffe-solverstate", str(ss), "--weights",
                            "w.npz", "--resume", "auto"]) == 2
    assert "conflicts with --resume" in caplog.text
    w = tmp_path / "w.npz"
    tm = get_model("googlenet_s2d", device="cpu", dtype=torch.float32)
    convert.save_weights_npz(convert.to_jax_params(tm), str(w))
    assert cli.main(base + ["--caffe-solverstate", str(ss), "--weights",
                            str(w), "--model", "googlenet_s2d"]) == 2
    assert "plain GoogLeNet trunk only" in caplog.text
    assert cli.main(["export-caffemodel", "--weights", str(w), "--model",
                     "resnet50", "--solverstate-out",
                     str(tmp_path / "x")]) == 2
    assert cli.main(["export-caffemodel", "--weights", str(w),
                     "--solverstate-out", str(tmp_path / "x"),
                     "--out", str(tmp_path / "m.caffemodel")]) == 2
    assert "needs a training snapshot" in caplog.text
    assert not (tmp_path / "m.caffemodel").exists()
    assert cli.main(["export-caffemodel", "--out", str(tmp_path / "y")]) == 2


def test_train_resumes_momentum_and_iteration_from_a_solverstate(tmp_path,
                                                                  trees):
    """``train --weights W --caffe-solverstate S`` on plain ``googlenet``
    (crop 32, batch 8): the momentum is the history's, as JAX's map
    gives it, and the run continues from the solverstate's iteration to
    ``max_iter`` (one step); its snapshot exports back to the same
    weights and a solverstate of its momentum."""
    solver_path = _small_net(tmp_path)
    tm = get_model("googlenet", device="cpu", dtype=torch.float32)
    w = tmp_path / "w.npz"
    convert.save_weights_npz(convert.to_jax_params(tm), str(w))
    mom = _random_tree(trees["googlenet"][0], 12)
    ss = tmp_path / "s.solverstate"
    ss.write_bytes(tcodec.write_solverstate(
        7, jci.googlenet_history_from_momentum(mom)))
    solver = Solver(tm, cfg=SolverConfig(snapshot=0))
    assert solver.load_caffe_solverstate(str(ss)) == 7
    got = convert.tree_from_state(solver.momentum, ())[0]
    _assert_trees_equal(got, mom)
    events = tmp_path / "e.jsonl"
    rc = cli.main(["train", "--solver", solver_path, "--synthetic",
                   "--device", "cpu", "--weights", str(w),
                   "--caffe-solverstate", str(ss), "--log-json", str(events),
                   "--precision", "fp32_parity"])
    assert rc == 0
    iters = [json.loads(ln)["iteration"] for ln in
             events.read_text().splitlines()
             if json.loads(ln).get("event") == "display"]
    assert iters == [8]
