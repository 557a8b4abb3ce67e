"""``obs/quality/escalate.py`` (``ProbeEscalator``) in the port, held
against the JAX package on the CPU (``tests/test_quality.py``'s probe
escalation tests, mirrored) on one committed IVF index both load:

  * the ladder doubles the probes up to the cluster count (1, 2, 4),
    then falls back to the flat scan, then raises
    ``EscalationExhaustedError`` with JAX's text; each rung's detail
    (timings stripped), the replica count, the untouched freshness and
    ``created`` stamp, the swap count, and the top-k ids at every rung
    equal JAX's (scores within ``SCORE_TOL``); the flat rung's ids equal
    the exact top-k with the lowest index winning a tie, and int8
    scoring becomes fp32 there;
  * the fused probe takes every rung;
  * the remediation lifecycle driven by scripted alerts (an escalation
    that resolves, then a sticky alert walking to the flat fallback and
    past it) gives JAX's audit records once timings are stripped.
"""

import types

import numpy as np
import pytest

from npairloss_tpu.resilience import remediate as J
from npairloss_tpu_torch.resilience import remediate as P

SCORE_TOL = 1e-5  # answer scores, port against JAX (fp32 dot products)


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def tiny_ivf(tmp_path_factory):
    """One 64 x 16 IVF index of 4 clusters, committed by the port."""
    from npairloss_tpu_torch.serve.ivf import IVFIndex

    rng = np.random.default_rng(0)
    emb = _unit(rng, 64, 16)
    lab = (np.arange(64) % 8).astype(np.int32)
    path = IVFIndex.build_ivf(emb, lab, clusters=4, seed=0, device="cpu").save(
        str(tmp_path_factory.mktemp("esc") / "ivf.gidx"))
    return emb, path


def _mods(pkg):
    if pkg == "jax":
        from npairloss_tpu import serve as S
        from npairloss_tpu.obs.quality import escalate as X
        from npairloss_tpu.serve import index as I
        from npairloss_tpu.serve import ivf as V
        from npairloss_tpu.serve.server import Freshness
        return types.SimpleNamespace(
            EngineConfig=S.EngineConfig, QueryEngine=S.QueryEngine,
            BatcherConfig=S.BatcherConfig, RetrievalServer=S.RetrievalServer,
            ServerConfig=S.ServerConfig, IVFIndex=V.IVFIndex, X=X,
            Freshness=Freshness, load=I.load_index)
    from npairloss_tpu_torch.obs.quality import escalate as X
    from npairloss_tpu_torch.serve import batcher as B
    from npairloss_tpu_torch.serve import engine as E
    from npairloss_tpu_torch.serve import index as I
    from npairloss_tpu_torch.serve import ivf as V
    from npairloss_tpu_torch.serve import server as R
    return types.SimpleNamespace(
        EngineConfig=E.EngineConfig, QueryEngine=E.QueryEngine,
        BatcherConfig=B.BatcherConfig, RetrievalServer=R.RetrievalServer,
        ServerConfig=R.ServerConfig, IVFIndex=V.IVFIndex, X=X,
        Freshness=R.Freshness,
        load=lambda p: I.load_index(p, device="cpu"))


def _server(m, path, probes, replicas=1, top_k=5, **cfg):
    idx = m.load(path)
    cfg = m.EngineConfig(top_k=top_k, buckets=(1,), probes=probes, **cfg)
    primary = m.QueryEngine(idx, cfg)
    primary.warmup()
    engines = [primary] + [m.QueryEngine(idx, cfg, share_compiled_with=primary)
                           for _ in range(replicas - 1)]
    for e in engines[1:]:
        e.warmed = True
    server = m.RetrievalServer(
        engines, m.BatcherConfig(max_batch=1, max_delay_ms=1.0),
        m.ServerConfig(metrics_window=0),
        freshness=m.Freshness.collect(index=idx, index_path=path))
    server.replicaset.start()
    return server


def _ask(server, rec):
    if hasattr(server, "handle"):
        return server.handle(rec)
    return server.handle_many([rec])[0]


def _answers(server, queries):
    out = [_ask(server, {"id": i, "embedding": q.tolist()})
           for i, q in enumerate(queries)]
    return ([[n["row"] for n in a["neighbors"]] for a in out],
            np.asarray([[n["score"] for n in a["neighbors"]] for a in out]))


def _ladder(pkg, path, queries, scoring, probe_impl):
    m = _mods(pkg)
    extra = {"probe_impl": probe_impl} if probe_impl else {}
    server = _server(m, path, probes=1, replicas=2, scoring=scoring, **extra)
    created = server.engine.index.created
    fresh = server.freshness
    rungs = []
    try:
        esc = m.X.ProbeEscalator(server)
        rungs.append(({}, _answers(server, queries)))
        for _ in range(3):
            d = esc.escalate()
            d.pop("warmup_s")
            eng = server.engine
            rungs.append((dict(d, kind=type(eng.index).__name__,
                               cfg_probes=eng.cfg.probes,
                               scoring=eng.cfg.scoring,
                               replicas=len(server.engines),
                               **({"impl": eng.probe_impl}
                                  if probe_impl else {}),
                               warmed=eng.warmed,
                               same_created=eng.index.created == created,
                               same_freshness=server.freshness is fresh),
                          _answers(server, queries)))
        with pytest.raises(m.X.EscalationExhaustedError) as e:
            esc.escalate()
        tail = {"exhausted": str(e.value), "swaps": server.swaps,
                "impl": getattr(server.engine, "probe_impl", None)}
    finally:
        server.replicaset.close(drain=True)
    return rungs, tail


@pytest.mark.parametrize("scoring", ["fp32", "int8"])
def test_ladder_and_flat_fallback_as_jax(tiny_ivf, scoring):
    emb, path = tiny_ivf
    queries = np.concatenate([emb[:6], _unit(np.random.default_rng(8), 6,
                                             16)])
    got, gtail = _ladder("port", path, queries, scoring, None)
    want, wtail = _ladder("jax", path, queries, scoring, None)
    assert [d for d, _ in got] == [d for d, _ in want]
    assert gtail["exhausted"] == wtail["exhausted"]
    assert gtail["swaps"] == wtail["swaps"] == 3
    assert [d.get("probes", d.get("fallback")) for d, _ in got[1:]] == [
        2, 4, "flat"]
    assert got[3][0]["scoring"] == "fp32" and got[3][0]["kind"] == \
        "GalleryIndex"
    assert all(d["replicas"] == 2 and d["warmed"] and d["same_created"]
               and d["same_freshness"] for d, _ in got[1:])
    for (_, (gi, gs)), (_, (wi, ws)) in zip(got, want):
        assert gi == wi
        np.testing.assert_allclose(gs, ws, atol=SCORE_TOL)
    # The flat rung is exact: the lowest index wins a tie.
    sims = queries @ emb.T
    exact = [sorted(range(64), key=lambda r: (-sims[i, r], r))[:5]
             for i in range(len(queries))]
    assert got[3][1][0] == exact


def test_every_rung_runs_the_fused_probe(tiny_ivf):
    """On the CPU the fused probe is its plain version; every IVF rung
    keeps ``probe_impl="fused"`` and answers as JAX's scan tier does."""
    emb, path = tiny_ivf
    queries = _unit(np.random.default_rng(11), 8, 16)
    got, gtail = _ladder("port", path, queries, "fp32", "fused")
    want, _ = _ladder("jax", path, queries, "fp32", None)
    assert [d.get("impl") for d, _ in got[1:]] == ["fused", "fused", None]
    for (_, (gi, gs)), (_, (wi, ws)) in zip(got, want):
        assert gi == wi
        np.testing.assert_allclose(gs, ws, atol=SCORE_TOL)


def _lifecycle(pkg, path, tmp_path):
    m = _mods(pkg)
    R = J if pkg == "jax" else P
    server = _server(m, path, probes=1)
    log_path = str(tmp_path / f"{pkg}.jsonl")
    try:
        esc = m.X.ProbeEscalator(server)
        pol = R.RemediationPolicy(
            name="probe_escalation", slo="serve_recall_floor",
            action="escalate_probes", cooldown_s=10.0, max_attempts=4)
        eng = R.RemediationEngine([pol], {"escalate_probes": esc.escalate},
                                  log_path=log_path, clock=lambda: 0.0)
        a1 = {"alert_id": "serve_recall_floor-1", "severity": "critical",
              "fired_at": 100.0}
        probes = [server.engine.cfg.probes]
        eng.tick({"serve_recall_floor": a1}, now=100.0)
        probes.append(server.engine.cfg.probes)
        eng.tick({}, now=105.0)
        a2 = {"alert_id": "serve_recall_floor-2", "severity": "critical",
              "fired_at": 200.0}
        for now in (200.0, 215.0, 230.0):
            eng.tick({"serve_recall_floor": a2}, now=now)
            probes.append(getattr(server.engine.cfg, "probes", None))
        flat = not isinstance(server.engine.index, m.IVFIndex)
        eng.close()
    finally:
        server.replicaset.close(drain=True)
    recs = R.load_remediation_log(log_path)
    assert R.validate_remediation_log(recs) is None
    for r in recs:
        r.get("detail", {}).pop("warmup_s", None)
    return recs, probes, flat


def test_escalation_remediation_lifecycle_gives_jaxs_records(tiny_ivf,
                                                              tmp_path):
    _, path = tiny_ivf
    got = _lifecycle("port", path, tmp_path)
    want = _lifecycle("jax", path, tmp_path)
    assert got == want
    recs, probes, flat = got
    assert probes[:2] == [1, 2] and probes[2] == 4 and flat
    assert [r["state"] for r in recs] == [
        "attempted", "succeeded", "attempted", "failed", "attempted",
        "failed", "attempted", "failed"]
    assert recs[1]["detail"] == {"probes": 2, "probes_before": 1}
    assert "already flat" in recs[-1]["error"]
