"""The port's serving tier (npairloss_tpu_torch/serve: index add and
checkpoints, the IVF add and parity stamp, replicas, the HTTP front end,
durable ingest, the drain; train.solver.restore_for_inference; the
``index``/``serve`` CLI) against the JAX package on the CPU.

Where both packages get the same fp32 data, host arrays, ids, IVF
assignments, ``load_newest``'s choice, manifests, answer rows, labels
and ids are equal, and scores agree within ``ATOL``:

  * (c) flat and IVF ``add`` from one commit; checkpoint commits with
    ``ingest_watermark`` load in the other package; ``load_newest`` on
    torn, tmp and mixed-kind commits;
  * (d) ``measure_parity`` and the ingest record encoding;
  * (e) the replica tier: routing, whole-tier-down, crash reroute with
    zero client errors, ``explicit_drops``;
  * (f) ``run_http``'s status codes and bodies beside JAX's, a body
    coalesced by ``handle_many``, 503 while draining;
  * (g) SIGTERM on ``serve --device cpu`` (JSONL and ``--http 0``):
    exit 75, every admitted query answered, the drain record last;
  * (h) SIGKILLs against ``serve --wal-dir``: no acked row lost or
    duplicated;
  * (i) ``restore_for_inference``: a snapshot's encode equals the
    solver's trunk; a corrupt snapshot is refused.
"""

import base64
import http.client
import io
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from npairloss_tpu.resilience import PreemptionSignal as JPreemptionSignal
from npairloss_tpu.serve import BatcherConfig as JBatcherConfig
from npairloss_tpu.serve import EngineConfig as JEngineConfig
from npairloss_tpu.serve import GalleryIndex as JGalleryIndex
from npairloss_tpu.serve import QueryEngine as JQueryEngine
from npairloss_tpu.serve import RetrievalServer as JRetrievalServer
from npairloss_tpu.serve import ServerConfig as JServerConfig
from npairloss_tpu.serve import index as jindex
from npairloss_tpu.serve import ivf as jivf
from npairloss_tpu.serve import server as jserver
from npairloss_tpu_torch.ops import _build
from npairloss_tpu_torch.resilience import failpoints
from npairloss_tpu_torch.resilience import snapshot as snap
from npairloss_tpu_torch.resilience.preempt import (
    EXIT_PREEMPTED,
    PreemptionSignal,
)
from npairloss_tpu_torch.serve import index as pindex
from npairloss_tpu_torch.serve import ivf as pivf
from npairloss_tpu_torch.serve import server as pserver
from npairloss_tpu_torch.serve.batcher import BatcherConfig, QueueFullError
from npairloss_tpu_torch.serve.engine import EngineConfig, QueryEngine
from npairloss_tpu_torch.serve.index import GalleryIndex, load_newest
from npairloss_tpu_torch.serve.ivf import IVFIndex, topk_recall
from npairloss_tpu_torch.serve.manifest import (
    SnapshotValidationError,
    read_manifest,
)
from npairloss_tpu_torch.serve.replicas import ReplicaCrashError
from npairloss_tpu_torch.serve.server import RetrievalServer, ServerConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
CAP_ALIGN = 32  # the JAX package's TPU tiling rule for the IVF cap


@pytest.fixture(autouse=True)
def _disarm():
    failpoints.reset()
    yield
    failpoints.reset()


def make_gallery(rng, ids=12, per_id=6, dim=16, noise=0.3):
    centers = rng.standard_normal((ids, dim))
    labels = np.repeat(np.arange(ids), per_id).astype(np.int32)
    emb = centers[labels] + noise * rng.standard_normal((ids * per_id, dim))
    return emb.astype(np.float32), labels


def _answers_equal(got, want):
    np.testing.assert_array_equal(got["rows"], want["rows"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_array_equal(got["ids"], want["ids"])
    np.testing.assert_allclose(got["scores"], want["scores"], atol=ATOL)


# -- (c) index add, checkpoints, load_newest ----------------------------------


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("explicit_ids", [True, False])
def test_flat_add_matches_jax(rng, normalize, explicit_ids):
    emb, lab = make_gallery(rng)
    extra, extra_lab = make_gallery(rng, ids=3, per_id=3)
    ids = np.arange(5000, 5009) if explicit_ids else None
    jidx = JGalleryIndex.build(emb, lab)
    pidx = GalleryIndex.build(emb, lab, device="cpu")
    old = pidx.placed
    assert jidx.add(extra, extra_lab, ids=ids, normalize=normalize) \
        == pidx.add(extra, extra_lab, ids=ids, normalize=normalize) == 81
    assert pidx.placed is not old, "republish must swap, not mutate"
    np.testing.assert_array_equal(pidx.host_emb, jidx._host_emb)
    np.testing.assert_array_equal(pidx.host_labels, jidx._host_labels)
    np.testing.assert_array_equal(pidx.ids, jidx.ids)
    assert pidx.padded_size == pidx.size == int(pidx.placed.valid.sum())
    q = np.concatenate([emb[:3], extra[:5]])
    cfg = dict(top_k=5, buckets=(8,))
    _answers_equal(QueryEngine(pidx, EngineConfig(**cfg)).query(q),
                   JQueryEngine(jidx, JEngineConfig(**cfg)).query(q))


def _committed_ivf(tmp_path, rng):
    emb, lab = make_gallery(rng, ids=8, per_id=25)
    idx = jivf.IVFIndex.build_ivf(emb, lab, clusters=8, train_size=None)
    return idx.save(str(tmp_path / "base.gidx"))


def test_ivf_add_matches_jax(rng, tmp_path):
    """Both packages load one IVF commit and add the same rows: equal
    host arrays, assignments, centroids and answers; the cap is the
    largest cluster (JAX rounds it up to its TPU alignment)."""
    path = _committed_ivf(tmp_path, rng)
    jidx = jindex.load_index(path)
    pidx = pindex.load_index(path, device="cpu")
    old = pidx.layout
    extra = rng.standard_normal((40, 16)).astype(np.float32)
    extra[:30] += 3.0 * pidx.centroids_host[0]  # one cluster grows
    extra_lab = np.arange(40).astype(np.int32)
    jidx.add(extra, extra_lab)
    pidx.add(extra, extra_lab)
    assert pidx.layout is not old and pidx.layout.n_clusters == 8
    for name in ("_host_emb", "_host_labels", "ids", "assign_host",
                 "centroids_host"):
        np.testing.assert_array_equal(
            getattr(pidx, name.lstrip("_")), getattr(jidx, name), name)
    sizes = np.bincount(pidx.assign_host, minlength=8)
    assert pidx.layout.cap == sizes.max() > old.cap
    assert jidx.layout.cap == pidx.layout.cap + (-pidx.layout.cap) % CAP_ALIGN
    q = np.concatenate([extra[:8], pidx.host_emb[:8]])
    for probes in (2, 8):
        cfg = dict(top_k=6, buckets=(16,), probes=probes)
        for impl in ("scan", "fused"):
            _answers_equal(
                QueryEngine(pidx, EngineConfig(probe_impl=impl,
                                               **cfg)).query(q),
                JQueryEngine(jidx, JEngineConfig(**cfg)).query(q))


def test_ivf_add_full_probe_is_exact_and_refreshes_scored_slabs(rng):
    emb, lab = make_gallery(rng, ids=4, per_id=10)
    ivf = IVFIndex.build_ivf(emb, lab, clusters=4, train_size=None,
                             device="cpu")
    slab8, _ = ivf.scored_arrays("int8")
    assert ivf.scored_arrays("int8")[0] is slab8  # cached
    ivf.add(emb[:4] + 0.01, lab[:4])
    assert ivf.scored_arrays("int8")[0] is not slab8
    eng = QueryEngine(ivf, EngineConfig(top_k=6, buckets=(8,), probes=4,
                                        probe_impl="fused"))
    flat = GalleryIndex.build(ivf.host_emb, ivf.host_labels, ids=ivf.ids,
                              normalize=False, device="cpu")
    oracle = QueryEngine(flat, EngineConfig(top_k=6, buckets=(8,)))
    q = ivf.host_emb[-8:]
    assert topk_recall(eng.query(q)["rows"], oracle.query(q)["rows"]) == 1.0


@pytest.mark.parametrize("bad", ["ids", "dim"])
def test_add_refuses_what_jax_refuses(rng, bad):
    emb, lab = make_gallery(rng, ids=4, per_id=2)
    add = rng.standard_normal((3, 16 if bad == "ids" else 9)).astype(
        np.float32)
    ids = np.arange(7, dtype=np.int64) if bad == "ids" else None
    for idx in (JGalleryIndex.build(emb, lab),
                GalleryIndex.build(emb, lab, device="cpu")):
        with pytest.raises(ValueError, match=bad):
            idx.add(add, np.arange(3).astype(np.int32), ids=ids)


def _checkpoint(pkg, kind, emb, lab, path, wm):
    if pkg == "jax":
        idx = (jivf.IVFIndex.build_ivf(emb, lab, clusters=4,
                                       train_size=None) if kind == "ivf"
               else JGalleryIndex.build(emb, lab))
    else:
        idx = (IVFIndex.build_ivf(emb, lab, clusters=4, train_size=None,
                                  device="cpu") if kind == "ivf"
               else GalleryIndex.build(emb, lab, device="cpu"))
    idx.ingest_watermark = wm
    return idx.save(path)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("kind", ["flat", "ivf"])
@pytest.mark.parametrize("wm", [0, 17])
def test_checkpoint_commits_cross_load_with_watermark(rng, tmp_path, writer,
                                                      kind, wm):
    emb, lab = make_gallery(rng, ids=4, per_id=5)
    path = _checkpoint(writer, kind, emb, lab,
                       str(tmp_path / f"g_w{wm:012d}.gidx"), wm)
    jidx = jindex.load_index(path)
    pidx = pindex.load_index(path, device="cpu")
    assert jidx.ingest_watermark == pidx.ingest_watermark == wm
    assert ("ingest_watermark" in read_manifest(path)) == bool(wm)
    info = pindex.index_info(path)
    assert info == jindex.index_info(path)
    assert info["ingest_watermark"] == wm
    # A re-commit by the other package keeps the watermark.
    other = pidx if writer == "jax" else jidx
    again = other.save(str(tmp_path / "again.gidx"))
    assert pindex.index_info(again)["ingest_watermark"] == wm
    if kind == "ivf":
        assert pivf.IVFIndex.from_gallery(
            GalleryIndex.build(emb, lab, device="cpu"), clusters=2
        ).ingest_watermark == 0
        flat = GalleryIndex.build(emb, lab, device="cpu")
        flat.ingest_watermark = wm
        assert pivf.IVFIndex.from_gallery(
            flat, clusters=2).ingest_watermark == wm


def _rot(path):
    with open(os.path.join(path, "emb.npy"), "r+b") as f:
        f.seek(200)
        f.write(b"\xff\xff\xff\xff")


SCENARIOS = ["mixed-kinds", "torn-newest", "tmp-ignored", "checkpoint-wins",
             "torn-manifest", "all-torn"]


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_load_newest_picks_what_jax_picks(rng, tmp_path, scenario):
    emb, lab = make_gallery(rng, ids=4, per_id=5)
    pre = str(tmp_path / "g_")
    flat = JGalleryIndex.build(emb, lab)
    ivf = IVFIndex.build_ivf(emb, lab, clusters=3, train_size=None,
                             device="cpu")
    flat.save(pre + "0001.gidx")
    ivf.save(pre + "0002.gidx")
    if scenario == "torn-newest":
        flat.save(pre + "0003.gidx")
        _rot(pre + "0003.gidx")
    elif scenario == "tmp-ignored":
        flat.save(pre + "0003.gidx")
        os.rename(pre + "0003.gidx", pre + "0003.gidx.tmp-123-ab")
    elif scenario == "checkpoint-wins":
        flat.ingest_watermark = 4
        flat.save(pre + "w000000000004.gidx")
        ivf.save(pre + "9999.gidx")
    elif scenario == "torn-manifest":
        ivf.ingest_watermark = 9
        ivf.save(pre + "w000000000009.gidx")
        os.remove(pre + "w000000000009.gidx/manifest.json")
    elif scenario == "all-torn":
        _rot(pre + "0001.gidx")
        _rot(pre + "0002.gidx")
    assert ([n for n, _ in pindex.list_indexes(pre)]
            == [n for n, _ in jindex.list_indexes(pre)])
    got = load_newest(pre, device="cpu")
    want = jindex.load_newest(pre)
    if scenario == "all-torn":
        assert got is None and want is None
        return
    assert got[0] == want[0]
    assert got[1].KIND == want[1].KIND
    np.testing.assert_array_equal(got[1].ids, want[1].ids)
    assert got[1].ingest_watermark == want[1].ingest_watermark


def test_index_save_overwrite_never_destroys_committed_data(rng, tmp_path):
    """``index.commit.crash``: the old commit survives aside; a clean
    retry commits and clears the debris."""
    emb, lab = make_gallery(rng, ids=4, per_id=2)
    idx = GalleryIndex.build(emb, lab, device="cpu")
    path = str(tmp_path / "g.gidx")
    idx.save(path)
    original = np.load(os.path.join(path, "emb.npy"))
    idx.add(rng.standard_normal((3, emb.shape[1])).astype(np.float32),
            np.arange(3).astype(np.int32))
    with failpoints.armed("index.commit.crash"):
        with pytest.raises(failpoints.InjectedFault):
            idx.save(path)
    aside = [d for d in os.listdir(tmp_path)
             if "-prev" in d and d.startswith("g.gidx")]
    assert len(aside) == 1, aside
    np.testing.assert_array_equal(
        np.load(str(tmp_path / aside[0] / "emb.npy")), original)
    idx.save(path)
    assert jindex.load_index(path).size == idx.size
    assert not [d for d in os.listdir(tmp_path) if ".tmp-" in d]


# -- (d) the parity stamp and the ingest encoding -----------------------------


def test_measure_parity_matches_jax(rng, tmp_path):
    path = _committed_ivf(tmp_path, rng)
    want = jivf.measure_parity(jindex.load_index(path), probes=2, sample=48,
                               seed=3)
    got = pivf.measure_parity(pindex.load_index(path, device="cpu"),
                              probes=2, sample=48, seed=3)
    want.pop("measured_at")
    got.pop("measured_at")
    assert got == want


def test_index_cli_stamps_parity_jax_reads(rng, tmp_path):
    emb, lab = make_gallery(rng, ids=6, per_id=10)
    np.save(str(tmp_path / "e.npy"), emb)
    np.save(str(tmp_path / "l.npy"), lab)
    from npairloss_tpu_torch import cli

    out = str(tmp_path / "x.gidx")
    assert cli.main(["index", "--emb", str(tmp_path / "e.npy"), "--labels",
                     str(tmp_path / "l.npy"), "--out", out, "--kind", "ivf",
                     "--clusters", "4", "--parity-sample", "16",
                     "--parity-probes", "2", "--device", "cpu"]) == 0
    parity = read_manifest(out)["parity"]
    assert parity["probes"] == 2 and parity["sample"] == 16
    assert set(parity["recall"]) == {"fp32", "bf16", "int8"}
    assert jindex.load_index(out).parity == parity
    # --add-to keeps the stamp and re-commits in place.
    assert cli.main(["index", "--emb", str(tmp_path / "e.npy"), "--labels",
                     str(tmp_path / "l.npy"), "--add-to", out,
                     "--device", "cpu"]) == 0
    assert read_manifest(out)["parity"] == parity
    assert pindex.index_info(out)["size"] == 2 * emb.shape[0]
    assert cli.main(["index", "--info", out]) == 0


def test_ingest_encoding_matches_jax(rng):
    emb = rng.standard_normal((3, 5)).astype(np.float32)
    block = {"ids": [7, 8, 9], "labels": [1, 1, 2],
             "embeddings": emb.tolist()}
    body = pserver.encode_ingest_body(block)
    assert body == jserver.encode_ingest_body(block)
    body["seq"] = 4
    for a, b in zip(pserver.decode_ingest_payload(body),
                    jserver.decode_ingest_payload(body)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    np.testing.assert_array_equal(pserver.decode_ingest_payload(body)[0],
                                  emb)


BAD_INGEST = [
    ("not-object", [1, 2]),
    ("ragged", {"ids": [1], "labels": [1], "embeddings": [[1.0], [1.0, 2]]}),
    ("empty", {"ids": [], "labels": [], "embeddings": []}),
    ("labels", {"ids": [1, 2], "labels": [1], "embeddings": [[1.0], [2.0]]}),
    ("no-ids", {"labels": [1], "embeddings": [[1.0]]}),
]


@pytest.mark.parametrize("name,block", BAD_INGEST,
                         ids=[n for n, _ in BAD_INGEST])
def test_bad_ingest_blocks_refused_as_jax_refuses(name, block):
    def err(fn):
        try:
            fn(block)
        except (ValueError, TypeError) as e:
            return type(e), str(e)
        return None

    assert err(pserver.encode_ingest_body) == \
        err(jserver.encode_ingest_body) is not None


def test_decode_refuses_a_short_payload():
    body = {"seq": 3, "ids": [1, 2], "labels": [0, 0], "dim": 4,
            "emb": base64.b64encode(np.zeros(6, np.float32).tobytes())
            .decode()}
    with pytest.raises(ValueError, match="do not match"):
        pserver.decode_ingest_payload(body)
    with pytest.raises(ValueError, match="do not match"):
        jserver.decode_ingest_payload(body)


# -- (e) replicas -------------------------------------------------------------


def _tier(rng, n_replicas=2, max_queue=64, buckets=(1, 4), **cfg):
    emb, labels = make_gallery(rng)
    index = GalleryIndex.build(emb, labels, device="cpu")
    ecfg = EngineConfig(top_k=3, buckets=buckets)
    primary = QueryEngine(index, ecfg)
    primary.warmup()
    engines = [primary] + [QueryEngine(index, ecfg,
                                       share_compiled_with=primary)
                           for _ in range(n_replicas - 1)]
    server = RetrievalServer(
        engines, BatcherConfig(max_batch=buckets[-1], max_delay_ms=1.0,
                               max_queue=max_queue),
        ServerConfig(metrics_window=0, **cfg))
    return emb, server


def test_replicas_share_the_primarys_index_and_model(rng):
    emb, labels = make_gallery(rng)
    index = GalleryIndex.build(emb, labels, device="cpu")
    cfg = EngineConfig(top_k=3, buckets=(4,))
    primary = QueryEngine(index, cfg)
    primary.warmup()
    replica = QueryEngine(index, cfg, share_compiled_with=primary)
    assert replica.warmed and replica.index is primary.index
    assert replica.model is primary.model
    _answers_equal(replica.query(emb[:4]), primary.query(emb[:4]))
    other = GalleryIndex.build(emb, labels, device="cpu")
    with pytest.raises(ValueError, match="same index"):
        QueryEngine(other, cfg, share_compiled_with=primary)
    with pytest.raises(ValueError, match="same index"):
        QueryEngine(index, EngineConfig(top_k=4, buckets=(4,)),
                    share_compiled_with=primary)


def test_routing_prefers_least_loaded_live_replica(rng):
    _, server = _tier(rng, n_replicas=3)
    reps = server.replicaset.replicas
    reps[0].batcher._q.put(("x", None, 0.0))
    reps[2].alive = False
    assert server.replicaset.pick() is reps[1]
    reps[1].batcher._q.put(("x", None, 0.0))
    reps[1].batcher._q.put(("x", None, 0.0))
    assert server.replicaset.pick() is reps[0]


def test_whole_tier_down_rejects_and_counts(rng):
    _, server = _tier(rng, n_replicas=2)
    for rep in server.replicaset.replicas:
        rep.alive = False
    with pytest.raises(QueueFullError, match="no live replicas"):
        server.submit({"id": 0, "embedding": [0.0] * 16})
    s = server.summary()
    assert s["rejected"] == 1 and s["queries"] == 1
    assert s["queries"] == s["answered"] + s["errors"] + s["rejected"]
    assert s["replicas_alive"] == 0


@pytest.mark.parametrize("delay", [0, 2])
def test_replica_crash_reroutes_with_zero_client_errors(rng, delay):
    """One of two replicas dies mid-burst (at once, or after ``delay``
    dispatches): its batch reroutes to the survivor, no client sees an
    error, and the invariant holds."""
    emb, server = _tier(rng, n_replicas=2)
    server.replicaset.start()
    try:
        failpoints.arm("serve.replica_crash", times=1, delay=delay)
        answers = []
        for wave in range(4):
            answers += server.handle_many(
                [{"id": wave * 10 + i, "embedding": emb[i].tolist()}
                 for i in range(5)], timeout=30.0)
        tail = server.handle_many(
            [{"id": 100 + i, "embedding": emb[i].tolist()}
             for i in range(8)], timeout=30.0)
    finally:
        failpoints.reset()
        server.replicaset.close(drain=True)
    assert server.replicaset.alive_count == 1
    assert all("neighbors" in a for a in answers + tail), answers + tail
    s = server.summary()
    assert s["replicas"] == 2 and s["replicas_alive"] == 1
    assert s["queries"] == s["answered"] == 28 and s["errors"] == 0
    assert s["queries"] == s["answered"] + s["errors"] + s["rejected"], s


def test_dead_replica_drains_queued_batches_to_survivor(rng):
    emb, server = _tier(rng, n_replicas=2)
    rep = server.replicaset.replicas[0]
    fut = rep.batcher.submit({"id": 0, "embedding": emb[0].tolist()})
    rep.alive = False  # crashed between admission and dispatch
    server.replicaset.start()
    try:
        assert "neighbors" in fut.result(timeout=10.0)
    finally:
        server.replicaset.close(drain=True)


def test_dead_replica_fails_queued_batches_fast_when_tier_down(rng):
    emb, server = _tier(rng, n_replicas=1)
    rep = server.replicaset.replicas[0]
    rep.alive = False
    server.replicaset.start()
    try:
        fut = rep.batcher.submit({"id": 0, "embedding": emb[0].tolist()})
        with pytest.raises(ReplicaCrashError):
            fut.result(timeout=10.0)
    finally:
        server.replicaset.close(drain=True)


@pytest.mark.parametrize("explicit", [False, True])
def test_queries_dropped_absent_at_zero_unless_explicit(rng, explicit):
    emb, server = _tier(rng, n_replicas=1, explicit_drops=explicit)
    server.replicaset.start()
    try:
        server.handle_many([{"id": i, "embedding": emb[i].tolist()}
                            for i in range(6)], timeout=30.0)
    finally:
        server.replicaset.close(drain=True)
    s = server.summary()
    assert ("queries_dropped" in s) is explicit
    assert s.get("queries_dropped", 0) == 0
    assert ("queries_dropped" in server.healthz()) is explicit
    assert s["queries"] == s["answered"] + s["errors"] + s["rejected"], s
    for key in ("replicas", "replicas_alive", "ingest"):
        assert key not in s, key


def test_a_closed_batcher_counts_its_refusal_in_rejected(rng):
    emb, server = _tier(rng, n_replicas=1)
    server.replicaset.start()
    server.replicaset.close(drain=True)
    answers = server.handle_many([{"id": 0, "embedding": emb[0].tolist()}])
    assert "closed" in answers[0]["error"]
    s = server.summary()
    assert s["queries"] == s["rejected"] == 1 and "queries_dropped" not in s


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_a_backlog_dispatches_as_jaxs_batcher(pkg):
    """Queries queued behind a slow dispatch: once their deadlines have
    passed, each batch closes with what it holds, in both packages (the
    port keeps JAX's deadline rule: 21 batches of one)."""
    from npairloss_tpu.serve.batcher import MicroBatcher as JMicroBatcher
    from npairloss_tpu_torch.serve.batcher import MicroBatcher

    gate = threading.Event()

    def dispatch(items):
        gate.wait(timeout=30.0)  # the first batch holds the dispatcher
        return items

    cls, cfg = ((JMicroBatcher, JBatcherConfig) if pkg == "jax"
                else (MicroBatcher, BatcherConfig))
    b = cls(dispatch, cfg(max_batch=8, max_delay_ms=1.0,
                          max_queue=64)).start()
    futs = [b.submit(0)]
    time.sleep(0.05)  # the dispatcher took query 0 alone
    futs += [b.submit(i) for i in range(1, 21)]
    time.sleep(0.05)  # every deadline has passed
    gate.set()
    assert [f.result(timeout=30.0) for f in futs] == list(range(21))
    b.close(drain=True)
    assert b.batches == 21


def test_serve_bench_needs_a_card():
    from npairloss_tpu_torch.tools import serve_bench

    assert serve_bench.main([]) == 1


def test_engine_dispatch_count_stays_exact_under_threads(rng):
    """A reroute dispatches on a survivor's engine from a second thread:
    the engine's counter loses no dispatch."""
    emb, server = _tier(rng, n_replicas=1)
    engine = server.engine
    before = engine.dispatches

    def work():
        for i in range(50):
            engine.query(emb[i % 4][None])

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert engine.dispatches - before == 200


def test_launch_counters_stay_exact_under_threads():
    from npairloss_tpu_torch.ops.ivf_probe import probe_topk

    before = probe_topk.launches

    def work():
        for _ in range(2000):
            _build.bump(probe_topk)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert probe_topk.launches - before == 16000
    _build.bump(probe_topk, "launches", -16000)


# -- (f) the HTTP front end ---------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(port, method, path, body=None, timeout=30.0):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"null")
    finally:
        conn.close()


def _wait_port(port, deadline=30.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline:
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1):
                return
        except OSError:
            time.sleep(0.02)
    raise TimeoutError(f"nothing listens on {port}")


class _HttpRun:
    """A server's ``run_http`` on its own thread until ``stop()``."""

    def __init__(self, server, preempt, port):
        self.server, self.preempt, self.port = server, preempt, port
        self.rc = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()
        _wait_port(port)

    def _run(self):
        self.rc = self.server.run_http(self.port)

    def stop(self):
        self.preempt.request()
        self.thread.join(timeout=60.0)
        assert not self.thread.is_alive()
        return self.rc


@pytest.fixture(scope="module")
def http_pair():
    """The port's and the JAX package's HTTP servers on one gallery."""
    rng = np.random.default_rng(11)
    emb, lab = make_gallery(rng)
    j_eng = JQueryEngine(JGalleryIndex.build(emb, lab),
                         JEngineConfig(top_k=3, buckets=(1, 8)))
    j_eng.warmup()
    p_eng = QueryEngine(GalleryIndex.build(emb, lab, device="cpu"),
                        EngineConfig(top_k=3, buckets=(1, 8)))
    p_eng.warmup()
    jp, pp = JPreemptionSignal(), PreemptionSignal()
    jsrv = JRetrievalServer(j_eng, JBatcherConfig(max_batch=8,
                                                  max_delay_ms=50.0),
                            JServerConfig(metrics_window=0, poll_s=0.02),
                            preempt=jp)
    psrv = RetrievalServer(p_eng, BatcherConfig(max_batch=8,
                                                max_delay_ms=50.0),
                           ServerConfig(metrics_window=0, poll_s=0.02),
                           preempt=pp)
    runs = {"jax": _HttpRun(jsrv, jp, _free_port()),
            "port": _HttpRun(psrv, pp, _free_port())}
    yield emb, runs
    for run in runs.values():
        if run.thread.is_alive():
            run.stop()


HTTP_CASES = [
    ("one-query", "POST", "/query", "one"),
    ("body-of-3", "POST", "/query", "three"),
    ("bad-json", "POST", "/query", "{oops"),
    ("empty-body", "POST", "/query", "\n\n"),
    ("bad-record", "POST", "/query", json.dumps({"id": "x"})),
    ("unknown-post", "POST", "/nope", "one"),
    ("unknown-get", "GET", "/nope", None),
    ("metrics", "GET", "/metrics", None),
]


@pytest.mark.parametrize("case,method,path,body", HTTP_CASES,
                         ids=[c[0] for c in HTTP_CASES])
def test_http_codes_and_bodies_match_jax(http_pair, case, method, path,
                                         body):
    emb, runs = http_pair
    if body == "one":
        body = json.dumps({"id": 5, "embedding": emb[5].tolist()})
    elif body == "three":
        body = "\n".join(json.dumps({"id": i, "embedding": emb[i].tolist()})
                         for i in (1, 2, 40))
    got = _http(runs["port"].port, method, path, body)
    want = _http(runs["jax"].port, method, path, body)
    assert got[0] == want[0]
    gb, wb = got[1], want[1]
    if got[0] != 200:
        assert gb == wb
        return
    gb, wb = (gb, wb) if isinstance(wb, list) else ([gb], [wb])
    assert len(gb) == len(wb)
    for g, w in zip(gb, wb):
        assert set(g) == set(w) and g["id"] == w["id"]
        if "error" in w:
            assert g["error"] == w["error"]
            continue
        for gn, wn in zip(g["neighbors"], w["neighbors"]):
            for key in ("rank", "row", "gallery_id", "label"):
                assert gn[key] == wn[key]
            assert abs(gn["score"] - wn["score"]) <= ATOL


def test_http_healthz_matches_jax(http_pair):
    _, runs = http_pair
    got = _http(runs["port"].port, "GET", "/healthz")
    want = _http(runs["jax"].port, "GET", "/healthz")
    assert got[0] == want[0] == 200
    for key in ("ok", "draining", "event", "queries", "answered", "errors",
                "rejected"):
        assert got[1][key] == want[1][key], key
    for key in ("p50_ms", "p99_ms", "batches"):
        assert key in got[1]
    assert got[1]["draining"] is False


def test_handle_many_coalesces_a_body(rng):
    emb, server = _tier(rng, n_replicas=1, buckets=(1, 8))
    server.batcher.cfg = BatcherConfig(max_batch=8, max_delay_ms=500.0)
    server.replicaset.start()
    try:
        answers = server.handle_many(
            [{"id": i, "embedding": emb[i].tolist()} for i in range(8)])
    finally:
        server.replicaset.close(drain=True)
    assert [a["neighbors"][0]["row"] for a in answers] == list(range(8))
    assert server.summary()["batches"] == 1


def test_http_drain_answers_in_flight_and_refuses_late_requests(rng):
    emb, server = _tier(rng, n_replicas=2)
    preempt = PreemptionSignal()
    server.preempt = preempt
    release = threading.Event()
    for engine in server.engines:
        query = engine.query

        def held(q, *a, _query=query, **kw):
            release.wait(timeout=30.0)  # the query stays in flight
            return _query(q, *a, **kw)

        engine.query = held
    run = _HttpRun(server, preempt, _free_port())
    slow = {}

    def in_flight():
        slow["reply"] = _http(run.port, "POST", "/query",
                              json.dumps({"id": "slow",
                                          "embedding": emb[3].tolist()}))

    t = threading.Thread(target=in_flight)
    t.start()
    deadline = time.monotonic() + 30.0
    while server._inflight < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    preempt.request()
    late = _http(run.port, "POST", "/query",
                 json.dumps({"id": "late", "embedding": emb[4].tolist()}))
    health = _http(run.port, "GET", "/healthz")
    release.set()
    t.join(timeout=30.0)
    assert run.stop() == EXIT_PREEMPTED
    assert late == (503, {"error": "draining"})
    assert health[0] == 200 and health[1]["draining"] is True
    assert slow["reply"][0] == 200
    assert slow["reply"][1]["neighbors"][0]["row"] == 3
    s = server.summary()
    assert s["queries"] == s["answered"] == 1


def test_http_ingest_acks_after_the_wal_and_serves_the_rows(rng, tmp_path):
    """An ingest record in a POST body is appended, made durable and
    applied before its ack; the next query finds the row."""
    from npairloss_tpu_torch import cli
    from npairloss_tpu_torch.resilience.wal import WriteAheadLog

    emb, server = _tier(rng, n_replicas=2)
    index = server.engine.index
    base = index.save(str(tmp_path / "g_0001.gidx"))
    ingest = cli._IngestCheckpoints(index, base, str(tmp_path / "g_"))
    wal = WriteAheadLog(str(tmp_path / "wal"))
    server.attach_wal(wal, ingest.apply, checkpoint_fn=ingest.publish,
                      checkpoint_every=2)
    preempt = PreemptionSignal()
    server.preempt = preempt
    run = _HttpRun(server, preempt, _free_port())
    new = rng.standard_normal((3, 2, 16)).astype(np.float32)
    acks = []
    for b in range(3):
        code, ack = _http(run.port, "POST", "/query", json.dumps(
            {"id": f"in{b}", "ingest": {"ids": [900 + 2 * b, 901 + 2 * b],
                                        "labels": [50, 50],
                                        "embeddings": new[b].tolist()}}))
        assert code == 200
        acks.append(ack)
        assert wal.durable_seq >= ack["seq"]
    code, ans = _http(run.port, "POST", "/query", json.dumps(
        {"id": "q", "embedding": new[2][1].tolist()}))
    assert run.stop() == EXIT_PREEMPTED
    wal.close()
    assert [a["seq"] for a in acks] == [1, 2, 3]
    assert ans["neighbors"][0]["gallery_id"] == 905
    names = sorted(n for n in os.listdir(tmp_path) if n.startswith("g_w"))
    assert names == ["g_w000000000002.gidx", "g_w000000000003.gidx"]
    newest = jindex.load_newest(str(tmp_path / "g_"))
    assert newest[0].endswith("g_w000000000003.gidx")
    assert newest[1].ingest_watermark == 3
    assert sorted(newest[1].ids[-6:]) == list(range(900, 906))
    s = server.summary()
    assert s["ingest"]["vectors"] == 6 and s["queries"] == 1


@pytest.mark.parametrize("every", [1, 0])
def test_concurrent_ingests_apply_in_seq_order(rng, tmp_path, every):
    """Two request threads ingest at once and seq 1's fsync wait ends
    after seq 2 is appended: the records still apply in seq order, the
    watermark only grows, and the newest checkpoint holds every acked
    row (``every`` 0: one checkpoint after both acks)."""
    from npairloss_tpu_torch import cli
    from npairloss_tpu_torch.resilience.wal import WriteAheadLog

    emb, server = _tier(rng, n_replicas=1)
    index = server.engine.index
    base = index.save(str(tmp_path / "g_0001.gidx"))
    ingest = cli._IngestCheckpoints(index, base, str(tmp_path / "g_"))
    wal = WriteAheadLog(str(tmp_path / "wal"), flush_interval_s=0.002)
    appended = {1: threading.Event(), 2: threading.Event()}
    real_append, real_wait = wal.append, wal.wait_durable

    def append(payload):
        seq = real_append(payload)
        appended[seq].set()
        return seq

    def wait_durable(seq, timeout=30.0):
        if seq == 1:  # seq 2 overtakes seq 1 on its way to the fsync
            assert appended[2].wait(timeout=30.0)
            time.sleep(0.05)
        real_wait(seq, timeout)

    applied, marks = [], []

    def apply(payload):
        applied.append(payload["seq"])
        ingest.apply(payload)
        marks.append(server._ingest_watermark)

    wal.append, wal.wait_durable = append, wait_durable
    server.attach_wal(wal, apply, checkpoint_fn=ingest.publish,
                      checkpoint_every=every)
    acks = {}

    def send(b):
        rows = rng.standard_normal((2, 16)).astype(np.float32)
        acks[b] = server.handle_many([{"id": f"in{b}", "ingest": {
            "ids": [900 + 2 * b, 901 + 2 * b], "labels": [50, 50],
            "embeddings": rows.tolist()}}])[0]

    first = threading.Thread(target=send, args=(0,))
    first.start()
    assert appended[1].wait(timeout=30.0)
    second = threading.Thread(target=send, args=(1,))
    second.start()
    for t in (first, second):
        t.join(timeout=60.0)
    server.checkpoint_now()
    server._ingest_worker.shutdown(wait=True)
    wal.close()
    assert sorted(a["seq"] for a in acks.values()) == [1, 2], acks
    assert applied == [1, 2] and marks == sorted(marks)
    assert server.ingest_watermark == index.ingest_watermark == 2
    path, newest = load_newest(str(tmp_path / "g_"), device="cpu")
    assert path.endswith("g_w000000000002.gidx")
    assert newest.ingest_watermark == 2
    assert sorted(newest.ids[-4:].tolist()) == [900, 901, 902, 903]


# -- (g) the SIGTERM drain on a serve subprocess ------------------------------


@pytest.fixture(scope="module")
def served_gallery(tmp_path_factory):
    root = tmp_path_factory.mktemp("served")
    emb, lab = make_gallery(np.random.default_rng(5), ids=6, per_id=4,
                            dim=8)
    path = GalleryIndex.build(emb, lab, device="cpu").save(
        str(root / "g_0001.gidx"))
    return emb, path


def _serve(args, env=None):
    env = dict(os.environ, **(env or {}), PYTHONPATH=REPO)
    return subprocess.Popen(
        [sys.executable, "-m", "npairloss_tpu_torch", "serve", *args],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)


def _finish(proc, timeout=60):
    """(stdout, stderr) to the end, through the pipes' own buffers
    (``communicate`` reads the raw descriptors and would drop lines a
    ``readline`` already buffered)."""
    proc.stdin.close()
    timer = threading.Timer(timeout, proc.kill)
    timer.start()
    try:
        out = proc.stdout.read()
        err = proc.stderr.read()
        proc.wait()
    finally:
        timer.cancel()
    return out, err


def test_sigterm_drains_the_jsonl_front_end(served_gallery):
    """SIGTERM mid-stream: admission stops, every admitted query is
    answered in order, the drain record is last, exit 75."""
    emb, path = served_gallery
    proc = _serve(["--index", path, "--top-k", "3", "--buckets", "1,4,8",
                   "--device", "cpu"])
    try:
        for i in range(25):
            proc.stdin.write(json.dumps(
                {"id": i, "embedding": emb[i % len(emb)].tolist()}) + "\n")
        proc.stdin.flush()
        first = proc.stdout.readline()  # answers are flowing
        proc.send_signal(signal.SIGTERM)
        rest, err = _finish(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == EXIT_PREEMPTED, err[-2000:]
    recs = [json.loads(ln) for ln in (first + rest).splitlines()]
    summary = recs[-1]
    assert summary["event"] == "serve_drain"
    answers = recs[:-1]
    assert [a["id"] for a in answers] == list(range(len(answers)))
    assert all("neighbors" in a for a in answers)
    assert summary["answered"] == len(answers) == summary["queries"]


def test_sigterm_drains_the_http_front_end(served_gallery):
    """``serve --http 0``: SIGTERM while queries are in flight — each
    gets its answer, later requests 503, the drain record is the last
    stdout line, exit 75."""
    emb, path = served_gallery
    proc = _serve(["--index-prefix", os.path.join(os.path.dirname(path),
                                                  "g_"),
                   "--http", "0", "--top-k", "3", "--buckets", "1,4",
                   "--deadline-ms", "1", "--poll-s", "0.02",
                   "--replicas", "2", "--explicit-drops",
                   "--device", "cpu"],
                  env={"NPAIRLOSS_FAILPOINTS": "serve.latency:1000"})
    replies, stop = [], threading.Event()
    try:
        listening = json.loads(proc.stdout.readline())
        assert listening["event"] == "serve_listening"
        port = listening["port"]

        def client(k):
            i = 0
            while not stop.is_set():
                body = json.dumps({"id": f"{k}-{i}",
                                   "embedding": emb[i % len(emb)].tolist()})
                try:
                    replies.append(_http(port, "POST", "/query", body))
                except OSError:
                    return
                i += 1

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 60.0
        while sum(1 for c, _ in list(replies) if c == 200) < 4:
            assert time.monotonic() < deadline, "no answers from serve"
            time.sleep(0.02)
        proc.send_signal(signal.SIGTERM)
        time.sleep(0.3)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        out, err = _finish(proc)
    finally:
        stop.set()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == EXIT_PREEMPTED, err[-2000:]
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["event"] == "serve_drain"
    ok = [b for c, b in replies if c == 200]
    assert all("neighbors" in b for b in ok)
    assert (503, {"error": "draining"}) in replies
    assert {c for c, _ in replies} <= {200, 503}
    assert summary["answered"] == len(ok) == summary["queries"]
    assert summary["queries_dropped"] == 0 and summary["errors"] == 0


# -- (h) SIGKILLs against serve --wal-dir -------------------------------------


def test_sigkill_drill_zero_acked_loss(tmp_path):
    """Three SIGKILLs at seeded offsets, then a SIGTERM: every acked row
    is in the final checkpoint exactly once, the WAL replays only above
    each restart's watermark, and the JAX package loads the result."""
    rng = np.random.default_rng(1234)
    dim, kills = 16, 3
    base = rng.normal(size=(32, dim)).astype(np.float32)
    idx_dir = tmp_path / "idx"
    idx_dir.mkdir()
    GalleryIndex.build(base, np.arange(32, dtype=np.int32) % 4,
                       device="cpu").save(str(idx_dir / "g_0000.gidx"))
    cmd = ["--index-prefix", str(idx_dir / "g_"),
           "--wal-dir", str(tmp_path / "wal"), "--wal-flush-ms", "2",
           "--wal-checkpoint-every", "3", "--top-k", "5", "--buckets", "1,8",
           "--device", "cpu"]
    acked, sent = {}, {}
    batch_no = 0

    def batch():
        nonlocal batch_no
        b = batch_no
        batch_no += 1
        ids = [100000 + 10 * b + j for j in range(2)]
        emb = rng.normal(size=(2, dim)).astype(np.float32)
        rid = f"drill-{b}"
        sent[rid] = ids
        return json.dumps({"id": rid, "ingest": {
            "ids": ids, "labels": [9, 9], "embeddings": emb.tolist()}}) + "\n"

    replayed = []
    for k in range(kills + 1):
        proc = _serve(cmd)
        try:
            want = int(rng.integers(1, 4))
            for _ in range(want):
                proc.stdin.write(batch())
                proc.stdin.flush()
                ack = json.loads(proc.stdout.readline())
                assert ack["ingested"] == 2, ack
                acked[ack["id"]] = sent[ack["id"]]
            if k < kills:
                proc.stdin.write(batch())  # never acked: may or may not land
                proc.stdin.flush()
                proc.send_signal(signal.SIGKILL)
                _, err = _finish(proc)
                assert proc.returncode == -signal.SIGKILL
            else:
                proc.send_signal(signal.SIGTERM)
                out, err = _finish(proc)
                assert proc.returncode == EXIT_PREEMPTED
                drain = json.loads(out.strip().splitlines()[-1])
                assert drain["ingest"]["watermark"] \
                    == drain["ingest"]["checkpoint_watermark"]
            replayed.append(err)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    found = load_newest(str(idx_dir / "g_"), device="cpu")
    final_path, final = found
    assert "g_w" in os.path.basename(final_path)
    ids = final.ids.tolist()
    assert len(ids) == len(set(ids)), "a record was applied twice"
    lost = [i for rows in acked.values() for i in rows if i not in ids]
    assert lost == [], f"acked ids missing after {kills} kills: {lost}"
    assert all("wal: recovered" in e for e in replayed), replayed
    jfinal = jindex.load_newest(str(idx_dir / "g_"))
    assert jfinal[0] == final_path
    np.testing.assert_array_equal(jfinal[1].ids, final.ids)


def test_sigkill_after_concurrent_http_ingests_loses_no_acked_row(tmp_path):
    """8 threads POST ingests to ``serve --http`` with a checkpoint after
    every record, then SIGKILL: the restart's newest checkpoint plus
    its WAL replay hold every acked id exactly once."""
    rng = np.random.default_rng(77)
    dim = 8
    idx_dir = tmp_path / "idx"
    idx_dir.mkdir()
    GalleryIndex.build(rng.normal(size=(16, dim)).astype(np.float32),
                       np.arange(16, dtype=np.int32) % 4,
                       device="cpu").save(str(idx_dir / "g_0000.gidx"))
    cmd = ["--index-prefix", str(idx_dir / "g_"),
           "--wal-dir", str(tmp_path / "wal"), "--wal-flush-ms", "2",
           "--wal-checkpoint-every", "1", "--top-k", "3", "--buckets", "1,4",
           "--device", "cpu"]
    proc = _serve(["--http", "0", *cmd])
    acks, failures = [], []
    try:
        port = json.loads(proc.stdout.readline())["port"]

        def client(k):
            for b in range(4):
                ids = [10000 + 100 * k + 2 * b, 10001 + 100 * k + 2 * b]
                rows = np.random.default_rng(k * 10 + b).normal(
                    size=(2, dim)).astype(np.float32)
                code, ack = _http(port, "POST", "/query", json.dumps(
                    {"id": f"{k}-{b}", "ingest": {
                        "ids": ids, "labels": [3, 3],
                        "embeddings": rows.tolist()}}))
                (acks if code == 200 and "seq" in ack
                 else failures).append((ids, ack))

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        proc.send_signal(signal.SIGKILL)
        _finish(proc)
        assert proc.returncode == -signal.SIGKILL
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert failures == [] and len(acks) == 32
    assert sorted(a["seq"] for _, a in acks) == list(range(1, 33))
    # The restart replays above its checkpoint and, at EOF, publishes a
    # final checkpoint: every acked id must be in it exactly once.
    proc = _serve(cmd)
    out, err = _finish(proc)
    assert proc.returncode == 0, err[-2000:]
    path, final = load_newest(str(idx_dir / "g_"), device="cpu")
    assert final.ingest_watermark == 32, path
    ids = final.ids.tolist()
    assert len(ids) == len(set(ids)) == 16 + 64
    assert sorted(i for rows, _ in acks for i in rows) == sorted(ids[16:])


# -- (i) restore_for_inference ------------------------------------------------


IMG = (2, 2, 3)  # what serve --input-size 2 feeds the mlp


def _mlp_solver(tmp_path, seed=0):
    from npairloss_tpu_torch.models import get_model
    from npairloss_tpu_torch.ops.npair_loss import NPairLossConfig
    from npairloss_tpu_torch.train.solver import Solver, SolverConfig

    model = get_model("mlp", device="cpu", seed=seed, input_shape=IMG)
    return Solver(model, NPairLossConfig(),
                  SolverConfig(base_lr=0.1, lr_policy="fixed", display=0,
                               snapshot=0,
                               snapshot_prefix=str(tmp_path / "m_")))


def _trained(tmp_path, seed):
    from conftest import make_identity_batch

    rng = np.random.default_rng(seed)
    solver = _mlp_solver(tmp_path)
    (f,), (l,) = make_identity_batch(rng, 4, 2, int(np.prod(IMG)))
    f = f.reshape(-1, *IMG)
    solver.step(f, l)
    return solver, f, l, solver.save_snapshot(1)


def test_restore_for_inference_encodes_like_the_solver(tmp_path):
    from npairloss_tpu_torch.models import get_model
    from npairloss_tpu_torch.train.solver import (
        load_inference_state,
        restore_for_inference,
    )

    solver, f, l, path = _trained(tmp_path, 3)
    state = restore_for_inference(path, device="cpu")
    assert set(state) == {"params", "batch_stats"}
    assert state["batch_stats"] == {}
    model = load_inference_state(
        get_model("mlp", device="cpu", seed=9, input_shape=IMG), state)
    solver.model.eval()
    with torch.inference_mode():
        want = solver.model(torch.as_tensor(f))
        got = model(torch.as_tensor(f))
    assert torch.equal(got, want)
    from npairloss_tpu_torch.ops.normalize import l2_normalize

    idx = GalleryIndex.build(l2_normalize(want).numpy(), l, device="cpu")
    engine = QueryEngine(idx, EngineConfig(top_k=3, buckets=(1, 4)),
                         model=model)
    engine.warmup(input_shape=IMG)
    out = io.StringIO()
    server = RetrievalServer(engine, BatcherConfig(max_batch=4),
                             ServerConfig(metrics_window=0))
    lines = "".join(json.dumps({"id": i, "input": f[i].tolist()}) + "\n"
                    for i in range(4))
    assert server.run_jsonl(io.StringIO(lines), out) == 0
    recs = [json.loads(ln) for ln in out.getvalue().splitlines()]
    for r in recs[:-1]:
        assert r["neighbors"][0]["row"] == r["id"]
        assert r["neighbors"][0]["score"] == pytest.approx(1.0, abs=1e-5)


@pytest.mark.parametrize("what", ["model", "momentum", "manifest"])
def test_restore_for_inference_checks_only_the_model(tmp_path, what):
    from npairloss_tpu_torch.train.solver import restore_for_inference

    path = _trained(tmp_path, 4)[3]
    mpath = os.path.join(path, "manifest.json")
    if what == "manifest":
        with open(mpath, "w") as fh:
            fh.write("{torn")
    else:
        manifest = json.load(open(mpath))
        for k, rec in manifest["arrays"].items():
            if k.startswith(what + "/"):
                rec["crc32"] = (rec["crc32"] + 1) & 0xFFFFFFFF
        json.dump(manifest, open(mpath, "w"))
    if what == "momentum":
        assert restore_for_inference(path, device="cpu")["params"]
    else:
        with pytest.raises(snap.SnapshotValidationError):
            restore_for_inference(path, device="cpu")


def test_serve_snapshot_cli_answers_raw_inputs(tmp_path):
    from npairloss_tpu_torch import cli
    from npairloss_tpu_torch.ops.normalize import l2_normalize

    solver, f, l, path = _trained(tmp_path, 6)
    solver.model.eval()
    with torch.inference_mode():
        emb = l2_normalize(solver.model(torch.as_tensor(f))).numpy()
    gidx = GalleryIndex.build(emb, l, device="cpu").save(
        str(tmp_path / "g.gidx"))
    stdin = io.StringIO("".join(
        json.dumps({"id": i, "input": f[i].tolist()}) + "\n"
        for i in range(8)))
    out = io.StringIO()
    old_in, old_out = sys.stdin, sys.stdout
    sys.stdin, sys.stdout = stdin, out
    try:
        rc = cli.main(["serve", "--index", gidx, "--snapshot", path,
                       "--model", "mlp", "--input-size", "2", "--top-k", "2",
                       "--buckets", "1,8", "--device", "cpu"])
    finally:
        sys.stdin, sys.stdout = old_in, old_out
    assert rc == 0
    recs = [json.loads(ln) for ln in out.getvalue().splitlines()]
    assert [r["neighbors"][0]["row"] for r in recs[:-1]] == list(range(8))
    assert recs[-1]["snapshot_step"] == 1


# -- the CLI: flags beside the JAX CLI's, arg-only refusals -------------------


def _sub_actions(parser, cmd):
    sub = next(a for a in parser._actions
               if a.__class__.__name__ == "_SubParsersAction")
    return {a.dest: a for a in sub.choices[cmd]._actions}


def _jax_parser(monkeypatch):
    import argparse

    from npairloss_tpu import cli as jax_cli

    got = {}

    class Taken(Exception):
        pass

    def take(self, *a, **kw):
        got["parser"] = self
        raise Taken

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", take)
    with pytest.raises(Taken):
        jax_cli.main(["serve"])
    monkeypatch.undo()
    return got["parser"]


INDEX_FLAGS = ("emb", "labels", "out", "add_to", "no_normalize", "info",
               "kmeans_iters", "train_sample", "parity_sample",
               "parity_probes")
SERVE_FLAGS = ("http", "replicas", "index_prefix", "snapshot", "model",
               "ivf_clusters", "metrics_window", "poll_s", "no_warmup",
               "explicit_drops", "wal_dir", "wal_flush_ms",
               "wal_checkpoint_every")
NEW_FLAGS = ([("index", d) for d in INDEX_FLAGS]
             + [("serve", d) for d in SERVE_FLAGS])


@pytest.mark.parametrize("cmd,dest", NEW_FLAGS,
                         ids=[f"{c}-{d}" for c, d in NEW_FLAGS])
def test_serving_flags_match_the_jax_cli(cmd, dest, monkeypatch):
    from npairloss_tpu_torch import cli

    mine = _sub_actions(cli.build_parser(), cmd)[dest]
    theirs = _sub_actions(_jax_parser(monkeypatch), cmd)[dest]
    assert mine.option_strings == theirs.option_strings
    assert mine.default == theirs.default
    assert mine.choices == theirs.choices
    assert mine.type == theirs.type


@pytest.mark.parametrize("flag", ["--mesh", "--tenant-config", "--admission",
                                  "--live-obs", "--shadow-rate", "--qtrace",
                                  "--slo-config", "--watch-snapshots",
                                  "--remediate"])
def test_unported_serve_flags_are_refused(flag, capsys):
    from npairloss_tpu_torch import cli

    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["serve", "--index", "x", flag, "1"])
    assert "unrecognized arguments" in capsys.readouterr().err


@pytest.mark.parametrize("argv,needle", [
    (["--index", "x.gidx", "--wal-dir", "w"], "--wal-dir needs"),
    (["--index", "x.gidx", "--replicas", "0"], "--replicas must"),
    (["--index", "x.gidx", "--snapshot", "s", "--weights", "w"],
     "--snapshot and --weights"),
    (["--index-prefix", "/nonexistent/g_"], "no valid index"),
])
def test_serve_arg_checks_exit_2(argv, needle, caplog):
    from npairloss_tpu_torch import cli

    assert cli.main(["serve", *argv, "--device", "cpu"]) == 2
    assert needle in caplog.text
