"""The port's serving slice (npairloss_tpu_torch/serve, ops/kmeans.py,
the CLI) against the JAX package on the CPU.

  * a ``.gidx`` committed by either package loads in the other;
  * the flat, IVF-scan and IVF-fused engines (the fused probe runs its
    plain version on the CPU) answer the same queries with the same
    rows as the JAX engines, scores within 1e-5;
  * k-means matches JAX once both start from the same first point;
  * ``encode`` with converted weights matches the JAX engine (1e-4);
  * ``run_jsonl`` answers every record and keeps the drain invariant;
  * ``python -m npairloss_tpu_torch index`` + ``serve`` run as
    subprocesses with ``--device cpu``.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npairloss_tpu.models import get_model as jax_get_model
from npairloss_tpu.ops import kmeans as jkmeans
from npairloss_tpu.serve import EngineConfig as JEngineConfig
from npairloss_tpu.serve import GalleryIndex as JGalleryIndex
from npairloss_tpu.serve import QueryEngine as JQueryEngine
from npairloss_tpu.serve.index import load_index as jax_load_index
from npairloss_tpu.serve.ivf import IVFIndex as JIVFIndex
from npairloss_tpu.serve.ivf import topk_recall as jax_topk_recall
from npairloss_tpu_torch.models import convert, get_model
from npairloss_tpu_torch.ops import kmeans
from npairloss_tpu_torch.serve.batcher import BatcherConfig
from npairloss_tpu_torch.serve.engine import EngineConfig, QueryEngine
from npairloss_tpu_torch.serve.index import GalleryIndex, load_index
from npairloss_tpu_torch.serve.ivf import IVFIndex, topk_recall
from npairloss_tpu_torch.serve.server import (
    Freshness,
    RetrievalServer,
    ServerConfig,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
N, D, IDS, KC = 320, 32, 40, 8


def gallery(seed=0):
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((IDS, D)).astype(np.float32)
    labels = np.repeat(np.arange(IDS, dtype=np.int32), N // IDS)
    emb = centres[labels] + 0.4 * rng.standard_normal((N, D)).astype(
        np.float32)
    emb[7] = emb[3]  # a duplicated row pins the tie rule end to end
    return emb, labels


def queries(emb, seed=1):
    rng = np.random.default_rng(seed)
    return np.concatenate([emb[[3, 7, 50, 311]],
                           rng.standard_normal((6, D)).astype(np.float32)])


@pytest.fixture(scope="module")
def committed(tmp_path_factory):
    """A flat and an IVF index, built and committed by the JAX package."""
    root = tmp_path_factory.mktemp("gidx")
    emb, labels = gallery()
    flat = JGalleryIndex.build(emb, labels)
    ivf = JIVFIndex.build_ivf(emb, labels, clusters=KC, seed=0)
    return {"flat": (flat, flat.save(str(root / "flat.gidx"))),
            "ivf": (ivf, ivf.save(str(root / "ivf.gidx")))}


@pytest.mark.parametrize("kind", ["flat", "ivf"])
def test_jax_index_loads_in_port(committed, kind):
    jidx, path = committed[kind]
    idx = load_index(path, device="cpu")
    assert type(idx) is (IVFIndex if kind == "ivf" else GalleryIndex)
    np.testing.assert_array_equal(idx.host_emb, jidx._host_emb)
    np.testing.assert_array_equal(idx.host_labels, jidx._host_labels)
    np.testing.assert_array_equal(idx.ids, jidx.ids)
    if kind == "ivf":
        np.testing.assert_array_equal(idx.centroids_host, jidx.centroids_host)
        np.testing.assert_array_equal(idx.assign_host, jidx.assign_host)
        assert idx.n_clusters == jidx.n_clusters


@pytest.mark.parametrize("kind", ["flat", "ivf"])
def test_port_index_loads_in_jax(kind, tmp_path):
    emb, labels = gallery(seed=2)
    if kind == "ivf":
        idx = IVFIndex.build_ivf(emb, labels, clusters=KC, device="cpu")
    else:
        idx = GalleryIndex.build(emb, labels, device="cpu")
    path = idx.save(str(tmp_path / "p.gidx"))
    jidx = jax_load_index(path)
    assert jidx.KIND == idx.KIND
    np.testing.assert_array_equal(jidx._host_emb, idx.host_emb)
    np.testing.assert_array_equal(jidx.ids, idx.ids)
    if kind == "ivf":
        np.testing.assert_array_equal(jidx.assign_host, idx.assign_host)


ENGINES = [
    pytest.param("flat", "fp32", "scan", id="flat-fp32"),
    pytest.param("flat", "bf16", "scan", id="flat-bf16"),
    pytest.param("ivf", "fp32", "scan", id="ivf-scan-fp32"),
    pytest.param("ivf", "int8", "scan", id="ivf-scan-int8"),
    pytest.param("ivf", "fp32", "fused", id="ivf-fused-fp32"),
    pytest.param("ivf", "bf16", "fused", id="ivf-fused-bf16"),
]


@pytest.mark.parametrize("kind,scoring,impl", ENGINES)
def test_engine_answers_match_jax(committed, kind, scoring, impl):
    jidx, path = committed[kind]
    kw = dict(top_k=5, buckets=(4, 8), gallery_block=96, probes=3,
              scoring=scoring, probe_impl=impl)
    q = queries(jidx._host_emb)
    want = JQueryEngine(jidx, JEngineConfig(**kw)).query(q)
    eng = QueryEngine(load_index(path, device="cpu"), EngineConfig(**kw))
    got = eng.query(q)
    for key in ("rows", "labels", "ids"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=ATOL)
    assert got["rows"][0, :2].tolist() == [3, 7]  # duplicate: lower row


def test_kmeans_matches_jax_from_the_same_first_point():
    emb, _ = gallery(seed=3)
    x = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    first = int(jax.random.randint(jax.random.PRNGKey(0), (), 0, N))
    want = np.asarray(jkmeans.kmeans_fit(x, KC, iters=5, seed=0))
    got = kmeans.kmeans_fit(x, KC, iters=5, seed=0, first=first,
                            device="cpu")
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_array_equal(
        kmeans.assign_to_centroids(x, got, block=100, device="cpu"),
        jkmeans.assign_to_centroids(x, want, block=100))


def test_ivf_build_matches_jax_from_the_same_first_point(committed):
    jidx, _ = committed["ivf"]
    emb, labels = gallery()
    first = int(jax.random.randint(jax.random.PRNGKey(0), (), 0, N))
    idx = IVFIndex.build_ivf(emb, labels, clusters=KC, seed=0, first=first,
                             device="cpu")
    np.testing.assert_allclose(idx.centroids_host, jidx.centroids_host,
                               atol=ATOL)
    np.testing.assert_array_equal(idx.assign_host, jidx.assign_host)


def test_encode_with_converted_weights_matches_jax(committed):
    from test_torch_googlenet import plain_tree

    from npairloss_tpu.models import googlenet as jgoog
    from npairloss_tpu.models import layers as jlayers

    tree = plain_tree(seed=4)
    p = jax.tree_util.tree_map(np.asarray, tree)
    p["conv1"] = {"Conv_0": {
        "kernel": jlayers.conv1_kernel_to_s2d(p["conv1"]["Conv_0"]["kernel"]),
        "bias": p["conv1"]["Conv_0"]["bias"]}}
    p, _ = jgoog.fuse_inception_1x1_params(p)
    images = np.random.default_rng(5).standard_normal(
        (3, 32, 32, 3)).astype(np.float32)
    emb = np.random.default_rng(6).standard_normal((40, 1024)).astype(
        np.float32)
    lab = np.arange(40, dtype=np.int32)
    jeng = JQueryEngine(JGalleryIndex.build(emb, lab),
                        JEngineConfig(top_k=3, buckets=(4,)),
                        model=jax_get_model("googlenet_mxu",
                                            dtype=jnp.float32),
                        state={"params": p})
    model = get_model("googlenet_mxu", device="cpu", dtype=torch.float32)
    convert.load_jax_params(model, tree)
    eng = QueryEngine(GalleryIndex.build(emb, lab, device="cpu"),
                      EngineConfig(top_k=3, buckets=(4,)), model=model)
    np.testing.assert_allclose(eng.encode(images), jeng.encode(images),
                               atol=1e-4)


def test_run_jsonl_answers_and_drain_invariant(committed):
    import io

    _, path = committed["ivf"]
    idx = load_index(path, device="cpu")
    eng = QueryEngine(idx, EngineConfig(top_k=4, buckets=(1, 8),
                                        probes=3, probe_impl="fused"))
    eng.warmup()
    q = queries(idx.host_emb)
    lines = [json.dumps({"id": i, "embedding": r.tolist()})
             for i, r in enumerate(q)]
    lines.insert(2, "{not json")
    lines.append(json.dumps({"id": "short", "embedding": [0.0] * 3}))
    lines.append(json.dumps({"id": "empty"}))
    lines.append(json.dumps({"id": "img", "input": [[[0.0] * 3] * 4] * 4}))
    server = RetrievalServer(eng, BatcherConfig(max_batch=8),
                             ServerConfig(poll_s=0.01, explicit_drops=True),
                             freshness=Freshness.collect(idx, path))
    out = io.StringIO()
    assert server.run_jsonl(io.StringIO("\n".join(lines) + "\n"), out) == 0
    rows = [json.loads(ln) for ln in out.getvalue().splitlines()]
    summary = rows[-1]
    by_id = {r["id"]: r for r in rows[:-1]}
    direct = eng.query(q)
    for i in range(len(q)):
        got = [n["row"] for n in by_id[i]["neighbors"]]
        assert got == direct["rows"][i].tolist()
        assert "index_age_s" in by_id[i]
    for bad in ("short", "empty", "img", None):
        assert "error" in by_id[bad]
    assert summary["event"] == "serve_drain"
    assert summary["queries"] == len(q) + 3
    assert summary["answered"] == len(q)
    assert summary["errors"] == 4 and summary["errors_refused"] == 1
    assert summary["queries_dropped"] == 0
    assert summary["queries"] == (summary["answered"] + summary["errors"]
                                  - summary["errors_refused"]
                                  + summary["rejected"])
    assert "compiles_after_warmup" not in summary
    assert summary["probe_impl"] == "fused"


def test_topk_recall_matches_jax():
    rng = np.random.default_rng(7)
    a = np.argsort(rng.random((6, 20)), axis=1)[:, :5]
    e = np.argsort(rng.random((6, 20)), axis=1)[:, :5]
    assert topk_recall(a, e) == jax_topk_recall(a, e)
    assert topk_recall(a, e, 3) == jax_topk_recall(a, e, 3)
    assert topk_recall(a, a) == 1.0


def test_cli_index_and_serve_subprocess(tmp_path):
    emb, labels = gallery(seed=8)
    prefix = str(tmp_path / "f")
    np.save(prefix + ".emb.npy", emb)
    np.save(prefix + ".labels.npy", labels)
    env = dict(os.environ, PYTHONPATH=REPO)
    run = lambda args, **kw: subprocess.run(  # noqa: E731
        [sys.executable, "-m", "npairloss_tpu_torch", *args],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=300, **kw)
    ix = run(["index", "--prefix", prefix, "--kind", "ivf",
              "--clusters", "6", "--device", "cpu"])
    assert ix.returncode == 0, ix.stderr
    info = json.loads(ix.stdout.strip().splitlines()[-1])
    assert info["kind"] == "ivf-index" and info["clusters"] == 6
    rows = [0, 41, 299]
    stdin = "".join(json.dumps({"id": r, "embedding": emb[r].tolist()}) + "\n"
                    for r in rows) + "{oops\n"
    sv = run(["serve", "--index", prefix + ".gidx", "--index-kind", "ivf",
              "--probes", "6", "--probe-impl", "fused", "--top-k", "3",
              "--buckets", "1,4", "--explicit-drops", "--device", "cpu"],
             input=stdin)
    assert sv.returncode == 0, sv.stderr
    out = [json.loads(ln) for ln in sv.stdout.strip().splitlines()]
    by_id = {a["id"]: a for a in out[:-1]}
    for r in rows:
        assert by_id[r]["neighbors"][0]["row"] == r
        assert by_id[r]["neighbors"][0]["score"] > 0.99
    assert "error" in by_id[None]
    assert out[-1]["event"] == "serve_drain"
    assert out[-1]["queries_dropped"] == 0
    assert out[-1]["answered"] == 3
