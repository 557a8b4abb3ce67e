"""``serve/hotswap.py`` (``SnapshotSwapper``), ``RetrievalServer.
swap_engines``, the ``serve.stale_model`` failpoint and ``serve
--watch-snapshots`` in the port, held against the JAX package on the CPU
(``tests/test_remediate.py``'s hot-swap tests and
``tests/test_pallas_ivf.py``'s fused-probe swap, mirrored):

  * an index swap under three concurrent clients, on one and two
    replicas: no client error, nothing dropped, ``hot_swaps`` 1, no
    post-warmup compile, the detail dict (timings stripped) and the
    top-k ids after the swap equal JAX's, scores within ``SCORE_TOL``,
    and a second swap raises ``NothingNewerError`` with JAX's text;
  * a torn newer snapshot is skipped for the next older still-newer one
    by both scans;
  * a model swap (each package's own snapshot of the same mlp
    parameters, carried across by ``models/convert.py``) serves
    embeddings within ``EMB_TOL`` of JAX's tier, and the same top-k ids;
  * ``index_transform`` keeps an IVF posture through a flat commit; a
    swap keeps the fused probe path; the constructors refuse what JAX's
    refuse, with the same messages;
  * the remediation lifecycle driven by scripted alerts (swap, resolve,
    nothing newer) gives JAX's audit records once timings are stripped;
  * ``serve.stale_model`` adds JAX's constant to the published model age;
    ``serve --watch-snapshots`` without ``--snapshot`` exits 2 as JAX's,
    and the default policy table keeps the actions the invocation
    registers, as JAX's filter does.
"""

import contextlib
import io
import logging
import os
import threading
import time
import types

import numpy as np
import pytest

from npairloss_tpu import cli as jax_cli
from npairloss_tpu.resilience import failpoints as jfail
from npairloss_tpu.resilience import remediate as J
from npairloss_tpu_torch import cli
from npairloss_tpu_torch.resilience import failpoints as pfail
from npairloss_tpu_torch.resilience import remediate as P

SCORE_TOL = 1e-5   # answer scores, port against JAX (fp32 dot products)
EMB_TOL = 1e-5     # mlp embeddings after a model swap, port against JAX
IMG = (2, 2, 3)


@pytest.fixture(autouse=True)
def _clean():
    pfail.reset()
    jfail.reset()
    yield
    pfail.reset()
    jfail.reset()


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _serve_mods(pkg):
    if pkg == "jax":
        from npairloss_tpu import serve as S
        from npairloss_tpu.serve import hotswap as H
        from npairloss_tpu.serve import index as I
        from npairloss_tpu.serve import ivf as V
        from npairloss_tpu.serve import server as R
        return types.SimpleNamespace(
            EngineConfig=S.EngineConfig, QueryEngine=S.QueryEngine,
            BatcherConfig=S.BatcherConfig, RetrievalServer=S.RetrievalServer,
            ServerConfig=S.ServerConfig, Freshness=R.Freshness,
            GalleryIndex=S.GalleryIndex, IVFIndex=V.IVFIndex,
            load_index=I.load_index, H=H, dev={})
    from npairloss_tpu_torch.serve import batcher as B
    from npairloss_tpu_torch.serve import engine as E
    from npairloss_tpu_torch.serve import hotswap as H
    from npairloss_tpu_torch.serve import index as I
    from npairloss_tpu_torch.serve import ivf as V
    from npairloss_tpu_torch.serve import server as R
    return types.SimpleNamespace(
        EngineConfig=E.EngineConfig, QueryEngine=E.QueryEngine,
        BatcherConfig=B.BatcherConfig, RetrievalServer=R.RetrievalServer,
        ServerConfig=R.ServerConfig, Freshness=R.Freshness,
        GalleryIndex=I.GalleryIndex, IVFIndex=V.IVFIndex,
        load_index=lambda p: I.load_index(p, device="cpu"), H=H,
        dev={"device": "cpu"})


def _ask(server, rec):
    if hasattr(server, "handle"):
        return server.handle(rec)
    return server.handle_many([rec])[0]


def _tier(m, index, cfg, replicas, model=None, state=None, input_shape=None,
          freshness=None):
    """A warmed tier of ``replicas`` engines, started."""
    extra = {"state": state} if state is not None else {}
    primary = m.QueryEngine(index, cfg, model=model, **extra)
    primary.warmup(input_shape)
    engines = [primary] + [
        m.QueryEngine(index, cfg, model=model, share_compiled_with=primary,
                      **extra) for _ in range(replicas - 1)]
    for e in engines[1:]:
        e.warmed = True
    kw = {"input_shape": input_shape} if input_shape is not None else {}
    server = m.RetrievalServer(
        engines, m.BatcherConfig(max_batch=4, max_delay_ms=1.0),
        m.ServerConfig(metrics_window=0), freshness=freshness, **kw)
    server.replicaset.start()
    return server


def _compiles_after_warmup(server):
    if hasattr(server, "_compiles_after_warmup"):
        return server._compiles_after_warmup()
    return server.summary()["compiles_after_warmup"]


def _answers(server, queries):
    """(ids, scores) of each query's neighbors, in rank order."""
    ids, scores = [], []
    for i, q in enumerate(queries):
        a = _ask(server, {"id": i, "embedding": q.tolist()})
        ids.append([n["gallery_id"] for n in a["neighbors"]])
        scores.append([n["score"] for n in a["neighbors"]])
    return ids, np.asarray(scores)


@pytest.fixture(scope="module")
def commits(tmp_path_factory):
    """g.000 (48 unit rows) and g.001 (the same plus 7 added rows),
    committed by the JAX package: both load them."""
    from npairloss_tpu.serve import GalleryIndex

    d = tmp_path_factory.mktemp("hotswap")
    rng = np.random.default_rng(0)
    emb = _unit(rng, 48, 8)
    lab = (np.arange(48) % 6).astype(np.int32)
    prefix = str(d / "g.")
    idx = GalleryIndex.build(emb, lab, normalize=False)
    p1 = idx.save(prefix + "000.gidx")
    idx.add(rng.standard_normal((7, 8)).astype(np.float32),
            (np.arange(7) % 6).astype(np.int32))
    p2 = idx.save(prefix + "001.gidx")
    return emb, prefix, p1, p2


def _swap_under_load(pkg, commits, replicas):
    m = _serve_mods(pkg)
    emb, prefix, p1, p2 = commits
    index = m.load_index(p1)
    server = _tier(m, index, m.EngineConfig(top_k=3, buckets=(1, 4)),
                   replicas,
                   freshness=m.Freshness.collect(index=index, index_path=p1))
    stop = threading.Event()
    errors, answered = [], [0]

    def client(k):
        i = k
        while not stop.is_set():
            a = _ask(server, {"id": i, "embedding": emb[i % 48].tolist()})
            if "error" in a:
                errors.append(a)
            else:
                answered[0] += 1
            i += 1

    threads = [threading.Thread(target=client, args=(k,)) for k in range(3)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.1)
        swapper = m.H.SnapshotSwapper(server, index_prefix=prefix)
        detail = swapper.swap()
        time.sleep(0.1)
    finally:
        stop.set()
        for t in threads:
            t.join()
    try:
        s = server.summary()
        after = _answers(server, _unit(np.random.default_rng(5), 8, 8))
        with pytest.raises(m.H.NothingNewerError) as e:
            swapper.swap()
        out = {
            "detail": {k: v for k, v in detail.items() if k != "warmup_s"},
            "errors": errors, "answered": answered[0] > 0,
            "invariant": s["queries"] == s["answered"] + s["errors"]
            + s["rejected"],
            "hot_swaps": s["hot_swaps"],
            "compiles_after_warmup": _compiles_after_warmup(server),
            "index_path": server.freshness.index_path,
            "size": server.engine.index.size,
            "replicas": len(server.engines),
            "remediation_absent": "remediation" not in server.healthz(),
            "nothing_newer": str(e.value)}
    finally:
        server.replicaset.close(drain=True)
    return out, after


@pytest.mark.parametrize("replicas", [1, 2])
def test_index_swap_under_concurrent_queries_as_jax(commits, replicas):
    got, (gids, gscores) = _swap_under_load("port", commits, replicas)
    want, (wids, wscores) = _swap_under_load("jax", commits, replicas)
    assert got == want
    assert got["errors"] == [] and got["answered"] and got["invariant"]
    assert got["hot_swaps"] == 1 and got["compiles_after_warmup"] == 0
    assert got["detail"] == {"swapped": ["index"], "index_path": commits[3]}
    assert got["size"] == 55 and got["replicas"] == replicas
    assert gids == wids
    np.testing.assert_allclose(gscores, wscores, atol=SCORE_TOL)


# -- snapshots: each package's own, of the same mlp parameters ---------------


def _jax_params(seed):
    import jax

    from npairloss_tpu.models import get_model

    model = get_model("mlp", hidden=(32,), embedding_dim=16)
    variables = model.init(jax.random.PRNGKey(seed),
                           np.zeros((1, *IMG), np.float32))
    return model, jax.tree_util.tree_map(np.asarray, variables["params"])


def _commit(pkg, prefix, step, params):
    """Commit ``params`` as ``pkg``'s own training snapshot at ``step``."""
    path = f"{prefix}iter_{step}.ckpt"
    if pkg == "jax":
        import orbax.checkpoint as ocp

        from npairloss_tpu.resilience.snapshot import commit_snapshot

        return commit_snapshot(ocp.StandardCheckpointer(), path,
                               {"params": params}, step)
    from npairloss_tpu_torch.models import convert, get_model
    from npairloss_tpu_torch.resilience.snapshot import commit_snapshot

    model = convert.load_jax_params(
        get_model("mlp", device="cpu", input_shape=IMG, hidden=(32,),
                  embedding_dim=16), params)
    return commit_snapshot(path, {f"model/{k}": v for k, v in
                                  model.state_dict().items()}, step)


def _restore(pkg, path):
    if pkg == "jax":
        from npairloss_tpu.train import restore_for_inference

        return restore_for_inference(path)
    from npairloss_tpu_torch.train.solver import restore_for_inference

    return restore_for_inference(path, device="cpu")


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_swapper_skips_a_torn_newer_snapshot_as_jax(pkg, tmp_path):
    fail = jfail if pkg == "jax" else pfail
    m = _serve_mods(pkg)
    prefix = str(tmp_path / "snap" / "m_")
    _commit(pkg, prefix, 1, _jax_params(1)[1])
    fail.arm("snapshot.commit.torn", times=1)
    _commit(pkg, prefix, 2, _jax_params(2)[1])
    sw = m.H.SnapshotSwapper(
        server=types.SimpleNamespace(
            freshness=None, engine=types.SimpleNamespace(device="cpu")),
        snapshot_prefix=prefix, model=object())
    path, state = sw._restore_newer(m.Freshness(snapshot_step=0))
    assert os.path.basename(path) == "m_iter_1.ckpt"
    assert "params" in state
    assert sw._restore_newer(m.Freshness(snapshot_step=1)) is None
    # The skipped one is torn: its own restore refuses it.
    with pytest.raises(Exception, match="(?i)checksum|crc"):
        _restore(pkg, f"{prefix}iter_2.ckpt")


def _model_swap(pkg, tmp_path, emb, lab, images):
    m = _serve_mods(pkg)
    prefix = str(tmp_path / pkg / "m_")
    _, p1 = _jax_params(1)
    _, p2 = _jax_params(2)
    s1 = _commit(pkg, prefix, 1, p1)
    index = m.GalleryIndex.build(emb, lab, normalize=False, **m.dev)
    cfg = m.EngineConfig(top_k=3, buckets=(1, 4))
    if pkg == "jax":
        model, _ = _jax_params(1)
        state = _restore(pkg, s1)
    else:
        from npairloss_tpu_torch.models import get_model
        from npairloss_tpu_torch.train.solver import load_inference_state

        model = load_inference_state(
            get_model("mlp", device="cpu", input_shape=IMG, hidden=(32,),
                      embedding_dim=16, seed=7), _restore(pkg, s1))
        state = None
    server = _tier(m, index, cfg, 2, model=model, state=state,
                   input_shape=IMG,
                   freshness=m.Freshness.collect(index=index,
                                                 snapshot_path=s1))
    try:
        before = server.engine.encode(images)
        _commit(pkg, prefix, 2, p2)
        swapper = m.H.SnapshotSwapper(server, snapshot_prefix=prefix,
                                      model=model, input_shape=IMG)
        detail = swapper.swap()
        after = server.engine.encode(images)
        answers = [_ask(server, {"id": i, "input": images[i].tolist()})
                   for i in range(len(images))]
        out = {"swapped": detail["swapped"],
               "snapshot_step": detail["snapshot_step"],
               "snapshot": os.path.basename(detail["snapshot_path"]),
               "served_step": server.freshness.snapshot_step,
               "hot_swaps": server.summary()["hot_swaps"],
               "replicas": len(server.engines),
               "compiles_after_warmup": _compiles_after_warmup(server),
               "ids": [[n["gallery_id"] for n in a["neighbors"]]
                       for a in answers]}
    finally:
        server.replicaset.close(drain=True)
    return out, before, after


def test_model_swap_serves_the_new_snapshots_embeddings_as_jax(tmp_path):
    rng = np.random.default_rng(3)
    emb = _unit(rng, 24, 16)
    lab = np.arange(24, dtype=np.int32)
    images = rng.standard_normal((4, *IMG)).astype(np.float32)
    got, gb, ga = _model_swap("port", tmp_path, emb, lab, images)
    want, wb, wa = _model_swap("jax", tmp_path, emb, lab, images)
    assert got == want
    assert got["swapped"] == ["model"] and got["snapshot_step"] == 2
    assert got["compiles_after_warmup"] == 0 and got["replicas"] == 2
    np.testing.assert_allclose(gb, wb, atol=EMB_TOL)
    np.testing.assert_allclose(ga, wa, atol=EMB_TOL)
    # The swap changed what the tier encodes with.
    assert np.abs(ga - gb).max() > 1e-2


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_swap_applies_the_index_transform_as_jax(pkg, tmp_path):
    """A flat commit swapped into an IVF tier arrives clustered."""
    m = _serve_mods(pkg)
    rng = np.random.default_rng(0)
    emb = _unit(rng, 64, 8)
    lab = (np.arange(64) % 8).astype(np.int32)
    prefix = str(tmp_path / "g.")
    p1 = m.GalleryIndex.build(emb, lab, normalize=False, **m.dev).save(
        prefix + "000.gidx")
    ivf1 = m.IVFIndex.from_gallery(m.load_index(p1), clusters=4)
    server = _tier(m, ivf1, m.EngineConfig(top_k=3, buckets=(1,), probes=4),
                   1, freshness=m.Freshness.collect(index=ivf1,
                                                    index_path=p1))
    try:
        idx2 = m.load_index(p1)
        idx2.add(rng.standard_normal((4, 8)).astype(np.float32),
                 (np.arange(4) % 8).astype(np.int32))
        idx2.save(prefix + "001.gidx")
        swapper = m.H.SnapshotSwapper(
            server, index_prefix=prefix,
            index_transform=lambda i: m.IVFIndex.from_gallery(i, clusters=4))
        assert swapper.swap()["swapped"] == ["index"]
        assert isinstance(server.engine.index, m.IVFIndex)
        assert server.engine.index.size == 68
        a = _ask(server, {"id": 0, "embedding": emb[0].tolist()})
        assert a["neighbors"][0]["row"] == 0
    finally:
        server.replicaset.close(drain=True)


def test_a_swap_keeps_the_fused_probe_path():
    """``swap_engines`` with a tier rebuilt from the old config (the
    swapper's recipe) keeps serving the fused probe: /healthz stamps it,
    and the answers equal JAX's fused tier on the same committed IVF."""
    from npairloss_tpu_torch.serve.ivf import IVFIndex as PIVF

    rng = np.random.default_rng(0)
    emb = _unit(rng, 60, 16)
    lab = (np.arange(60) % 6).astype(np.int32)
    queries = _unit(np.random.default_rng(9), 6, 16)
    got = {}
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = PIVF.build_ivf(emb, lab, normalize=False, clusters=6,
                              train_size=None, device="cpu").save(
                                  os.path.join(d, "ivf.gidx"))
        for pkg in ("port", "jax"):
            m = _serve_mods(pkg)
            cfg = m.EngineConfig(top_k=3, buckets=(1, 4), probes=3,
                                 probe_impl="fused")
            server = _tier(m, m.load_index(path), cfg, 2)
            try:
                old = server.engine
                new_index = m.load_index(path)
                primary = m.QueryEngine(new_index, old.cfg)
                assert primary.warmup() >= 0.0
                replica = m.QueryEngine(new_index, old.cfg,
                                        share_compiled_with=primary)
                replica.warmed = True
                server.swap_engines([primary, replica],
                                    m.Freshness.collect(index=new_index))
                assert server.engine.probe_impl == "fused"
                assert server.healthz()["probe_impl"] == "fused"
                assert server.swaps == 1
                with pytest.raises(ValueError, match="replica count"):
                    server.swap_engines([primary])
                got[pkg] = _answers(server, queries)
            finally:
                server.replicaset.close(drain=True)
    assert got["port"][0] == got["jax"][0]
    np.testing.assert_allclose(got["port"][1], got["jax"][1], atol=SCORE_TOL)


def test_swapper_refuses_as_jax():
    msgs = {}
    for pkg in ("port", "jax"):
        m = _serve_mods(pkg)
        server = types.SimpleNamespace(freshness=None)
        out = []
        for kw in ({}, {"snapshot_prefix": "/tmp/x_"}):
            with pytest.raises(ValueError) as e:
                m.H.SnapshotSwapper(server, **kw)
            out.append(str(e.value))
        msgs[pkg] = out
    assert msgs["port"] == msgs["jax"]
    assert "needs an index_prefix" in msgs["port"][0]
    assert "needs the model" in msgs["port"][1]


# -- the remediation lifecycle, scripted ---------------------------------------


def _hotswap_lifecycle(pkg, commits, tmp_path):
    m = _serve_mods(pkg)
    R = J if pkg == "jax" else P
    _, prefix, p1, _ = commits
    index = m.load_index(p1)
    server = _tier(m, index, m.EngineConfig(top_k=3, buckets=(1, 4)), 1,
                   freshness=m.Freshness.collect(index=index, index_path=p1))
    log_path = str(tmp_path / f"{pkg}.jsonl")
    try:
        swapper = m.H.SnapshotSwapper(server, index_prefix=prefix)
        pol = R.RemediationPolicy(name="hotswap_index", slo="index_staleness",
                                  action="snapshot_hotswap", cooldown_s=10.0,
                                  max_attempts=2)
        eng = R.RemediationEngine([pol], {"snapshot_hotswap": swapper.swap},
                                  log_path=log_path, clock=lambda: 0.0)
        for aid, now in (("index_staleness-1", 100.0),):
            eng.tick({"index_staleness": {"alert_id": aid,
                                          "severity": "warning",
                                          "fired_at": now}}, now=now)
        eng.tick({}, now=105.0)   # resolved: the attempt succeeded
        eng.tick({"index_staleness": {"alert_id": "index_staleness-2",
                                      "severity": "warning",
                                      "fired_at": 200.0}}, now=200.0)
        eng.close()
    finally:
        server.replicaset.close(drain=True)
    recs = R.load_remediation_log(log_path)
    assert R.validate_remediation_log(recs) is None
    for r in recs:
        r.get("detail", {}).pop("warmup_s", None)
    return recs


def test_hotswap_remediation_lifecycle_gives_jaxs_records(commits, tmp_path):
    got = _hotswap_lifecycle("port", commits, tmp_path)
    want = _hotswap_lifecycle("jax", commits, tmp_path)
    assert got == want
    assert [(r["state"], r.get("detail", {}).get("swapped")) for r in got] \
        == [("attempted", None), ("succeeded", ["index"]),
            ("attempted", None), ("failed", None)]
    assert "no committed snapshot/index newer" in got[-1]["error"]
    assert "(alert index_staleness-2)" in got[-1]["error"]


# -- serve.stale_model and the CLI ---------------------------------------------


def test_stale_model_failpoint_bumps_the_published_age():
    from npairloss_tpu_torch.obs.live import MetricRegistry
    from npairloss_tpu_torch.serve.server import Freshness

    assert pfail.STALE_AGE_FAULT_S == jfail.STALE_AGE_FAULT_S
    now = time.time()
    server = types.SimpleNamespace(freshness=Freshness(
        snapshot_created=now - 10.0, index_created=now - 5.0))
    live = types.SimpleNamespace(registry=MetricRegistry())
    def age(name="serve_model_age_s"):
        cli._serve_probe(live, server, None)
        return live.registry.get(name).value

    clean = age()
    pfail.arm("serve.stale_model", times=1)
    stale = age()
    again = age()
    assert 10.0 <= clean < 20.0
    assert stale - clean == pytest.approx(pfail.STALE_AGE_FAULT_S, abs=5.0)
    assert again < 20.0
    # The index age is never bumped.
    assert live.registry.get("serve_index_age_s").value < 15.0


def _code(main, argv):
    with contextlib.redirect_stdout(io.StringIO()):
        try:
            return main(argv)
        except SystemExit as e:
            return e.code


def test_watch_snapshots_without_a_snapshot_exits_2_as_jax(commits, caplog):
    base = ["serve", "--index", commits[2], "--top-k", "3",
            "--watch-snapshots", "/tmp/nothing_"]
    caplog.set_level(logging.ERROR)
    rcs = {"jax": _code(jax_cli.main, base + ["--mesh", "1"])}
    jax_text = caplog.text
    caplog.clear()
    rcs["port"] = _code(cli.main, base + ["--device", "cpu"])
    assert rcs == {"jax": 2, "port": 2}
    assert "--watch-snapshots needs --snapshot" in jax_text
    assert "--watch-snapshots needs --snapshot" in caplog.text


@pytest.mark.parametrize("argv, extra", [
    (["--index-prefix", "PREFIX", "--index-kind", "ivf", "--ivf-clusters",
      "3"], ()),
    (["--index-prefix", "PREFIX"], ()),
    (["--index", "P1", "--index-kind", "ivf", "--ivf-clusters", "3"], ()),
    (["--index", "P1"], ("--admission", "slo")),
])
def test_default_policy_table_keeps_the_registered_actions(
        commits, tmp_path, argv, extra):
    _, prefix, p1, _ = commits
    argv = [{"PREFIX": prefix, "P1": p1}.get(a, a) for a in argv]
    args = cli.build_parser().parse_args([
        "serve", *argv, "--top-k", "3", "--device", "cpu",
        "--telemetry-dir", str(tmp_path / "tel"), "--live-obs",
        "--slo-tick", "3600", "--remediate-dry-run", *extra])
    server, _ = cli.build_server(args)
    try:
        names = [p.name for p in server.remediation.policies]
    finally:
        server.replicaset.close(drain=True)
        cli.close_observers(server)
    actions = {"rewarm", "load_shed"}
    if prefix in argv:
        actions.add("snapshot_hotswap")
    if "ivf" in argv:
        actions.add("escalate_probes")
    want = [p.name for p in J.default_policies("serve")
            if p.action in actions]
    assert names == want
    assert ("hotswap_index" in names) == (prefix in argv)
    assert ("probe_escalation" in names) == ("ivf" in argv)


def test_acked_rows_survive_an_index_swap(tmp_path, caplog):
    """``serve --wal-dir`` keeps acked rows pending, as JAX's: an index
    swap to another writer's newer commit serves that commit as it is
    (the rows stay pending, and the swap logs it), and the rows reach
    answers through the next checkpoint, which the next swap serves."""
    from npairloss_tpu_torch.serve.index import GalleryIndex

    rng = np.random.default_rng(4)
    emb = _unit(rng, 48, 8)
    lab = (np.arange(48) % 6).astype(np.int32)
    prefix = str(tmp_path / "g.")
    base = GalleryIndex.build(emb, lab, normalize=False, device="cpu")
    base.save(prefix + "000.gidx")
    args = cli.build_parser().parse_args([
        "serve", "--index-prefix", prefix, "--wal-dir",
        str(tmp_path / "wal"), "--wal-checkpoint-every", "0", "--top-k",
        "3", "--buckets", "1,4", "--device", "cpu", "--telemetry-dir",
        str(tmp_path / "tel"), "--live-obs", "--slo-tick", "3600",
        "--remediate-dry-run"])
    server, wal = cli.build_server(args)
    server.replicaset.start()
    new = _unit(rng, 4, 8)
    swap = server.remediation._actions["snapshot_hotswap"][0]

    def ingest(i, rows):
        ack = server.handle_many([{"id": f"in{i}", "ingest": {
            "ids": [900 + r for r in rows], "labels": [1] * len(rows),
            "embeddings": new[rows].tolist()}}])[0]
        assert ack.get("ingested") == len(rows), ack
        return ack["seq"]

    def top1(row):
        a = server.handle_many([{"id": "q", "embedding":
                                 new[row].tolist()}])[0]
        return a["neighbors"][0]["gallery_id"]

    try:
        assert ingest(0, [0, 1]) == 1
        assert 900 not in (top1(0), top1(1))
        # A newer commit without the acked rows (another writer's build).
        other = GalleryIndex.build(emb, lab, normalize=False, device="cpu")
        other.add(_unit(rng, 3, 8), np.zeros(3, np.int32))
        other.save(prefix + "001.gidx")
        assert swap(None)["swapped"] == ["index"]
        assert server.engine.index.size == 48 + 3
        assert 900 not in (top1(0), top1(1))
        # The checkpoint grows from the last published commit, as JAX's.
        assert server.checkpoint_now().endswith("g.w000000000001.gidx")
        assert swap(None)["swapped"] == ["index"]
        assert server.engine.index.size == 48 + 2
        assert [top1(0), top1(1)] == [900, 901]
        assert ingest(1, [2]) == 2
        assert server.checkpoint_now().endswith("g.w000000000002.gidx")
        assert ingest(2, [3]) == 3
        with caplog.at_level(logging.INFO, "npairloss_tpu_torch.serve"):
            assert swap(None)["swapped"] == ["index"]
        # The record above the swapped-in commit's watermark stays pending.
        assert "ingest watermark 1 -> 2 (WAL records above 2 remain " \
            "pending for the next checkpoint)" in caplog.text
        assert top1(2) == 902 and top1(3) != 903
        assert server.checkpoint_now().endswith("g.w000000000003.gidx")
        assert swap(None)["swapped"] == ["index"]
        assert [top1(2), top1(3)] == [902, 903]
        assert server.engine.index.ingest_watermark == 3
    finally:
        server.replicaset.close(drain=True)
        wal.close()
        cli.close_observers(server)


def test_acked_rows_survive_a_flat_escalation(tmp_path, monkeypatch):
    """The flat rung is built from the served rows, with their ingest
    watermark and ``created``; a row acked during its warm-up stays
    pending, as JAX's, and reaches answers through the next checkpoint
    and swap."""
    from npairloss_tpu_torch.serve.engine import QueryEngine
    from npairloss_tpu_torch.serve.index import GalleryIndex
    from npairloss_tpu_torch.serve.ivf import IVFIndex

    rng = np.random.default_rng(5)
    emb = _unit(rng, 48, 8)
    lab = (np.arange(48) % 6).astype(np.int32)
    prefix = str(tmp_path / "g.")
    GalleryIndex.build(emb, lab, normalize=False,
                       device="cpu").save(prefix + "000.gidx")
    args = cli.build_parser().parse_args([
        "serve", "--index-prefix", prefix, "--index-kind", "ivf",
        "--ivf-clusters", "3", "--probes", "3", "--wal-dir",
        str(tmp_path / "wal"), "--wal-checkpoint-every", "0", "--top-k",
        "3", "--buckets", "1,4", "--device", "cpu", "--telemetry-dir",
        str(tmp_path / "tel"), "--live-obs", "--slo-tick", "3600",
        "--remediate-dry-run"])
    server, wal = cli.build_server(args)
    server.replicaset.start()
    new = _unit(rng, 4, 8)
    swap = server.remediation._actions["snapshot_hotswap"][0]

    def ingest(i, rows):
        ack = server.handle_many([{"id": f"in{i}", "ingest": {
            "ids": [900 + r for r in rows], "labels": [1] * len(rows),
            "embeddings": new[rows].tolist()}}])[0]
        assert ack.get("ingested") == len(rows), ack
        return ack["seq"]

    def top1(row):
        a = server.handle_many([{"id": "q", "embedding":
                                 new[row].tolist()}])[0]
        return a["neighbors"][0]["gallery_id"]

    warm = QueryEngine.warmup
    during = []

    def warmup(self, *a, **k):
        if not during:  # the flat tier's warm-up, before its flip
            during.append(ingest(1, [2]))
        return warm(self, *a, **k)

    try:
        assert ingest(0, [0, 1]) == 1
        server.checkpoint_now()
        assert swap(None)["swapped"] == ["index"]
        served = server.engine.index
        assert isinstance(served, IVFIndex) and served.size == 48 + 2
        assert [top1(0), top1(1)] == [900, 901]
        monkeypatch.setattr(QueryEngine, "warmup", warmup)
        fn = server.remediation._actions["escalate_probes"][0]
        assert fn(None)["fallback"] == "flat"
        monkeypatch.setattr(QueryEngine, "warmup", warm)
        flat = server.engine.index
        assert during == [2]
        assert not isinstance(flat, IVFIndex)
        assert flat.size == served.size == 48 + 2
        assert flat.ingest_watermark == served.ingest_watermark == 1
        assert flat.created == served.created
        np.testing.assert_array_equal(flat.ids, served.ids)
        assert [top1(0), top1(1)] == [900, 901]
        assert top1(2) != 902
        assert ingest(2, [3]) == 3
        assert server.checkpoint_now().endswith("g.w000000000003.gidx")
        assert swap(None)["swapped"] == ["index"]
        assert [top1(2), top1(3)] == [902, 903]
        assert server.engine.index.ingest_watermark == 3
    finally:
        server.replicaset.close(drain=True)
        wal.close()
        cli.close_observers(server)
