"""The real-JPEG chain through both CLIs (``tools/e2e_real_jpeg.py``, the
twin of ``scripts/e2e_real_jpeg.py``): the same generated JPEG tree and
zero-shot lists, the same net and solver, and one seed-made MLP
parameter tree written as the JAX CLI's msgpack and the port's ``.npz``
(the packages' init RNGs differ); then ``train`` -> snapshot ->
``--resume`` -> ``extract`` -> ``eval`` in each.  The held-out
(zero-shot) gallery Recall@1 of the two CLIs must agree.

Tier-1 (32 x 32 images, the crop the whole image, no mirror, 20 steps):
the sampler draws the same index stream in both packages and the
transform is the identity, so both train on the same batches and the
trajectories differ only by float rounding — Recall@1 within 2/32 (two
of the 32 held-out queries).  The slow case runs the JAX script's sizes
(64 x 64, random 56 crops and mirrors, 400 steps): the augmentations
draw from different generators, so the runs differ like two seeds —
Recall@1 within 0.15.  Both CLIs reach Recall@1 1.0 there, so the slow
case also holds the last TEST pass's loss, which is not saturated: both
below half the first TEST pass's (the same weights and batches in both),
and within 0.15 of each other, the spread of two such runs (measured,
port against JAX at iterations 100 / 200 / 300 / 400: 0.2189 / 0.1257,
0.2436 / 0.1164, 0.211 / 0.1212, 0.1613 / 0.1324, from 0.77 at 0).  In both cases each CLI must have learned: its last TEST pass's
zero-shot retrieve_top1 above its first, its last display loss below its
first.  The JAX CLI runs in process with ``--mesh 1``; both decode with
PIL (``--native never``)."""

import contextlib
import io
import json
import os

import numpy as np
import pytest

from npairloss_tpu_torch.tools import e2e_real_jpeg as tool


def _weights(ws, side, seed=5):
    """One seed-made MLP tree (numpy), as msgpack and as .npz."""
    import flax.serialization

    from npairloss_tpu_torch.models import get_model
    from npairloss_tpu_torch.models.convert import (
        save_weights_npz,
        to_jax_params,
    )

    shapes = to_jax_params(get_model("mlp", input_shape=(side, side, 3),
                                     device="cpu"))
    rng = np.random.default_rng(seed)
    tree = {}
    for layer, leaves in sorted(shapes.items()):
        fan_in = leaves["kernel"].shape[0]
        tree[layer] = {
            "kernel": (rng.standard_normal(leaves["kernel"].shape)
                       / np.sqrt(fan_in)).astype(np.float32),
            "bias": np.zeros(leaves["bias"].shape, np.float32)}
    msg = os.path.join(ws, "w.msgpack")
    with open(msg, "wb") as f:
        f.write(flax.serialization.msgpack_serialize({"params": tree}))
    npz = os.path.join(ws, "w.npz")
    save_weights_npz(tree, npz)
    return msg, npz


def _jax(argv, log):
    from npairloss_tpu import cli as jax_cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = jax_cli.main(argv)
    with open(log, "w") as f:
        f.write(buf.getvalue())
    assert rc == 0, buf.getvalue()[-2000:]
    return buf.getvalue()


def _jax_chain(ws, jws, steps, weights):
    """The port tool's chain through the JAX CLI: the same solver, its
    snapshots under ``jws``."""
    solver = os.path.join(jws, "solver.prototxt")
    with open(os.path.join(ws, "solver.prototxt")) as f:
        text = f.read().replace(f'"{ws}/snap_"', f'"{jws}/snap_"')
    with open(solver, "w") as f:
        f.write(text)
    common = ["--solver", solver, "--model", "mlp", "--native", "never",
              "--mesh", "1"]
    out1 = _jax(["train", *common, "--weights", weights],
                os.path.join(jws, "train.log"))
    snap_at = steps // 2
    out2 = _jax(["train", *common, "--resume",
                 os.path.join(jws, f"snap_iter_{snap_at}.ckpt")],
                os.path.join(jws, "resume.log"))
    n_test = (tool.IDS - tool.TRAIN_CLASSES) * tool.PER_ID
    _jax(["extract", *common, "--phase", "TEST", "--batches",
          str(n_test // 16), "--resume",
          os.path.join(jws, f"snap_iter_{steps}.ckpt"),
          "--out", os.path.join(jws, "feats")],
         os.path.join(jws, "extract.log"))
    out4 = _jax(["eval", "--prefix", os.path.join(jws, "feats"),
                 "--ks", "1", "2", "4"], os.path.join(jws, "eval.log"))
    train, test, _ = tool.parse_curve(out1)
    _, _, resumed_from = tool.parse_curve(out2)
    return {"train_curve": train, "test_curve": test,
            "resumed_from": resumed_from,
            "gallery": json.loads(out4.strip().splitlines()[-1])}


def _both(tmp_path, steps, side, crop, mirror):
    ws = str(tmp_path / "ws")
    jws = str(tmp_path / "jax")
    os.makedirs(ws)
    os.makedirs(jws)
    geometry = tool.prepare(ws, steps, 0.03, side=side, crop=crop,
                            mirror=mirror)
    msg, npz = _weights(ws, crop)
    port = tool.run_chain(ws, steps, "mlp", geometry, "cpu", weights=npz,
                          native="never")
    jax = _jax_chain(ws, jws, steps, msg)
    return port, jax, geometry


def _check(port, jax, geometry, tol):
    n_test = (tool.IDS - tool.TRAIN_CLASSES) * tool.PER_ID
    for res in (port, jax):
        assert res["resumed_from"] == geometry["snapshot_at"]
        assert res["gallery"]["gallery_size"] == n_test
        train, test = res["train_curve"], res["test_curve"]
        assert train and len(test) > 1
        # Each learned: the zero-shot R@1 beats the first TEST pass's,
        # the last display loss is below the first.
        assert test[-1]["retrieve_top1"] > test[0]["retrieve_top1"], test
        assert train[-1]["loss"] < train[0]["loss"], train
    r_port = port["gallery"]["recall_at_1"]
    r_jax = jax["gallery"]["recall_at_1"]
    assert abs(r_port - r_jax) <= tol, (r_port, r_jax)
    return r_port, r_jax


def test_jpeg_chain_recall_matches_jax_cli_tiny(tmp_path):  # slow-ok: the real-JPEG chain through both CLIs
    port, jax, geometry = _both(tmp_path, steps=20, side=32, crop=32,
                                mirror=False)
    _check(port, jax, geometry, tol=2 / 32 + 1e-6)
    # The same batches from the same weights: the first display rows'
    # losses agree closely.
    lp = port["train_curve"][0]["loss"]
    lj = jax["train_curve"][0]["loss"]
    assert lp == pytest.approx(lj, rel=1e-3, abs=1e-3)


def test_tool_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
    """Without ``--device`` the chain's device is the card: with none,
    the tool stops before it writes anything."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ws = tmp_path / "ws"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["--workdir", str(ws)])
    assert not ws.exists()


@pytest.mark.slow
def test_jpeg_chain_recall_matches_jax_cli_script_sizes(tmp_path):
    port, jax, geometry = _both(tmp_path, steps=400, side=tool.SIDE,
                                crop=tool.CROP, mirror=True)
    r_port, r_jax = _check(port, jax, geometry, tol=0.15)
    first = port["test_curve"][0]["loss"]
    assert jax["test_curve"][0]["loss"] == pytest.approx(first, rel=1e-3)
    l_port = port["test_curve"][-1]["loss"]
    l_jax = jax["test_curve"][-1]["loss"]
    assert max(l_port, l_jax) < first / 2, (first, l_port, l_jax)
    assert abs(l_port - l_jax) <= 0.15, (l_port, l_jax)
    print(json.dumps({"port_gallery": port["gallery"],
                      "jax_gallery": jax["gallery"],
                      "port_final_test": port["test_curve"][-1],
                      "jax_final_test": jax["test_curve"][-1]}))
