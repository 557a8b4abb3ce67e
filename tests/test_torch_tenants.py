"""Multi-tenant serving in the port (``serve/tenants.py``, the server's
tenant mode, ``serve --tenant-config``) held against the JAX package on
the CPU, at JAX's own test sizes (galleries of 24 x 16):

  * the stdlib copies key for key: manifests accepted and refused with
    the same problem lists, a ``QuotaGate`` on a frozen clock admitting
    the same sequence, ``tenant_slo_specs`` field by field;
  * JAX's ``_tenant_server`` miniature built in both packages: routing,
    the unknown-tenant refusal, ``TenantSwapper.swap_one`` leaving the
    neighbors bit-identical, same-geometry signature sharing and the
    quota-shed cross sums; answers (rows and ids exact, scores within
    ``SCORE_TOL``), ``stats_block`` keys and the summary counters equal
    JAX's;
  * ``serve --tenant-config`` over JSONL through both CLIs with
    ``--wal-dir``: the same answers, drain counters and checkpoint files
    under each tenant's prefix, and JAX's ``scripts/bench_check.py``
    (loaded by file path) accepts the port's run;
  * every ``build_server`` refusal exits 2 with JAX's words.
"""

import contextlib
import importlib.util
import io
import json
import logging
import os
import shutil
import types

import numpy as np
import pytest

from npairloss_tpu import cli as jax_cli
from npairloss_tpu_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORE_TOL = 1e-6  # answer scores, port against JAX (fp32 dot products)
COUNTERS = ("queries", "answered", "errors", "rejected")


def _mods(pkg):
    if pkg == "jax":
        from npairloss_tpu import serve as S
        from npairloss_tpu.obs.live.registry import MetricRegistry
        from npairloss_tpu.serve import hotswap as H
        from npairloss_tpu.serve import index as I
        from npairloss_tpu.serve import server as R
        from npairloss_tpu.serve import tenants as T
        return types.SimpleNamespace(
            S=S, T=T, H=H, Freshness=R.Freshness, Registry=MetricRegistry,
            build=lambda *a, **k: S.GalleryIndex.build(*a, **k),
            load=I.load_index)
    from npairloss_tpu_torch.obs.live.registry import MetricRegistry
    from npairloss_tpu_torch.serve import batcher as B
    from npairloss_tpu_torch.serve import engine as E
    from npairloss_tpu_torch.serve import hotswap as H
    from npairloss_tpu_torch.serve import index as I
    from npairloss_tpu_torch.serve import server as R
    from npairloss_tpu_torch.serve import tenants as T
    S = types.SimpleNamespace(
        EngineConfig=E.EngineConfig, QueryEngine=E.QueryEngine,
        BatcherConfig=B.BatcherConfig, RetrievalServer=R.RetrievalServer,
        ServerConfig=R.ServerConfig, GalleryIndex=I.GalleryIndex)
    return types.SimpleNamespace(
        S=S, T=T, H=H, Freshness=R.Freshness, Registry=MetricRegistry,
        build=lambda *a, **k: I.GalleryIndex.build(*a, device="cpu", **k),
        load=lambda p: I.load_index(p, device="cpu"))


# -- the stdlib copies --------------------------------------------------------


def _entry(tid="acme", **kw):
    d = {"tenant_id": tid, "index_prefix": f"/tmp/idx/{tid}-"}
    d.update(kw)
    return d


MANIFESTS = {
    "valid": {"schema": "npairloss-tenants-v1", "tenants": [
        _entry("acme", index_kind="ivf", probe_impl="fused", quota_qps=5.0,
               recall_floor=0.9, p99_ms=150.0), _entry("b-corp_2")]},
    "everything-wrong": {"schema": "wrong-schema", "tenants": [
        _entry("acme", quota_qps=-1), _entry("acme"), _entry("bad id!"),
        dict(_entry("c"), mystery_key=1),
        _entry("d", index_kind="hnsw", probe_impl="magic", quota_burst_s=0,
               recall_floor=2.0, recall_k=0, p99_ms=-1, admission="yes",
               probe_every=0), {"tenant_id": "e"}, 17]},
    "not-an-object": None,
    "no-tenants": {"schema": "npairloss-tenants-v1"},
    "empty-tenants": {"schema": "npairloss-tenants-v1", "tenants": []},
}


@pytest.mark.parametrize("name", sorted(MANIFESTS))
def test_manifests_are_judged_as_jaxs(name):
    jt, pt = _mods("jax").T, _mods("port").T
    man = MANIFESTS[name]
    problems = pt.validate_tenants_manifest(man)
    assert problems == jt.validate_tenants_manifest(man)
    assert (problems == []) == (name == "valid")
    if name == "valid":
        j, p = (t.TenantRegistry.from_manifest(man) for t in (jt, pt))
        assert p.ids() == j.ids()
        for tid in j.ids():
            assert vars(p.get(tid)) == vars(j.get(tid))
    else:
        with pytest.raises(ValueError, match="invalid tenants manifest"):
            pt.TenantRegistry.from_manifest(man)


def test_the_copied_constants_and_choices_match():
    from npairloss_tpu_torch.ops.ivf_probe import PROBE_IMPLS

    jt, pt = _mods("jax").T, _mods("port").T
    for name in ("TENANTS_SCHEMA", "INDEX_KINDS", "_INDEX_KIND_CHOICES",
                 "_PROBE_IMPL_CHOICES", "TENANT_SLO_SEP", "_SPEC_KEYS"):
        assert getattr(pt, name) == getattr(jt, name), name
    assert pt._ID_RE.pattern == jt._ID_RE.pattern
    assert pt._INDEX_KIND_CHOICES == tuple(pt.INDEX_KINDS)
    assert set(pt._PROBE_IMPL_CHOICES) == set(PROBE_IMPLS)
    for name in ("tenant_acme@x", "serve_p99", "a@b@c"):
        assert pt.tenant_of_slo(name) == jt.tenant_of_slo(name)


def test_quota_gates_admit_the_same_sequence():
    """A frozen clock stepped by hand: both buckets admit and shed the
    same queries, and publish the same labeled gauge and counter."""
    ticks = [0.0, 0.0, 0.0, 0.1, 0.2, 0.2, 1.0, 1.0, 1.0, 1.0, 3.5, 3.5]
    seqs, snaps = {}, {}
    for pkg in ("jax", "port"):
        m = _mods(pkg)
        reg = m.Registry()
        now = [0.0]
        gate = m.T.QuotaGate(qps=2.0, burst_s=1.5, clock=lambda: now[0],
                             registry=reg.view(tenant="acme"))
        out = []
        for t in ticks:
            now[0] = t
            out.append(gate.admit())
        seqs[pkg] = (out, gate.stats())
        snaps[pkg] = {k: v["value"] for k, v in reg.snapshot().items()}
    assert seqs["port"] == seqs["jax"]
    assert False in seqs["port"][0] and True in seqs["port"][0]
    assert snaps["port"] == snaps["jax"]


def test_tenant_slo_specs_field_by_field():
    for kw in ({"quota_qps": 5.0, "p99_ms": 150.0, "recall_floor": 0.9},
               {"recall_floor": 0.5, "recall_k": 5}, {}):
        got, want = (m.T.tenant_slo_specs(m.T.TenantSpec(
            tenant_id="acme", index_prefix="/p/a-", **kw))
            for m in (_mods("port"), _mods("jax")))
        assert [vars(s) for s in got] == [vars(s) for s in want]


# -- JAX's _tenant_server miniature in both packages --------------------------


def _gallery(seed, n=24, dim=16, id_base=0):
    r = np.random.default_rng(seed)
    emb = r.standard_normal((n, dim)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    return (emb, (np.arange(n) % 6).astype(np.int32),
            (np.arange(n) + id_base).astype(np.int64))


def _tenant_server(m, root, tenant_ids, quotas=None, replicas=1,
                   programs=None):
    """One replica tier serving one committed gallery per tenant under
    ``root/<tid>-``, the engines sharing through one ``ProgramCache``
    (JAX's ``tests/test_tenants.py`` miniature, with commits on disk for
    the swapper)."""
    programs = programs if programs is not None else m.T.ProgramCache()
    cfg = m.S.EngineConfig(top_k=3, buckets=(1, 4))
    entries, embs, anchor = {}, {}, None
    for t_i, tid in enumerate(tenant_ids):
        emb, lab, ids = _gallery(7 + t_i, id_base=1000 * t_i)
        embs[tid] = emb
        prefix = os.path.join(root, f"{tid}-")
        path = m.build(emb, lab, ids=ids, normalize=False).save(
            prefix + "0001.gidx")
        index = m.load(path)
        primary = programs.engine_for(index, cfg)
        if anchor is None:
            primary.warmup()
        else:
            primary.warmed = True  # shares the anchor's programs
        engines = [primary] + [
            m.S.QueryEngine(index, cfg, share_compiled_with=primary)
            for _ in range(replicas - 1)]
        for e in engines[1:]:
            e.warmed = True
        if anchor is None:
            anchor = engines
        spec = m.T.TenantSpec(
            tenant_id=tid, index_prefix=prefix,
            quota_qps=(quotas or {}).get(tid, 0.0), quota_burst_s=1.0)
        quota = None
        if spec.quota_qps:
            quota = m.T.QuotaGate(spec.quota_qps, spec.quota_burst_s,
                                  clock=lambda: 0.0)  # frozen: no refill
        entries[tid] = m.T.TenantEntry(
            spec, engines, quota=quota,
            freshness=m.Freshness.collect(index=index, index_path=path))
    server = m.S.RetrievalServer(
        anchor, m.S.BatcherConfig(max_batch=4, max_delay_ms=1.0,
                                  max_queue=64),
        m.S.ServerConfig(metrics_window=0, explicit_drops=True))
    server.enable_tenants(entries)
    server.replicaset.start()
    return server, embs, programs


def _q(tid, emb, i, qid=None):
    return {"id": qid if qid is not None else i, "tenant": tid,
            "embedding": emb[i].tolist()}


def _strip(answer):
    """An answer without its freshness ages (wall-clock dependent)."""
    return {k: v for k, v in answer.items() if not k.endswith("_age_s")}


def _same_answers(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _strip(g), _strip(w)
        assert set(g) == set(w) and g["id"] == w["id"], (g, w)
        assert g.get("tenant") == w.get("tenant")
        if "error" in w:
            assert g["error"] == w["error"]
            continue
        for gn, wn in zip(g["neighbors"], w["neighbors"], strict=True):
            for key in ("rank", "row", "gallery_id", "label"):
                assert gn[key] == wn[key], (gn, wn)
            # Wire scores carry 6 decimals: compare the difference at
            # that grain, not its binary residue.
            assert round(abs(gn["score"] - wn["score"]), 9) <= SCORE_TOL


def _both(tmp_path, tenant_ids, body, **kw):
    """Build the miniature in both packages, run ``body(m, server, embs,
    programs)`` on each, drain; returns {pkg: (result, summary)}."""
    out = {}
    for pkg in ("jax", "port"):
        m = _mods(pkg)
        root = tmp_path / pkg
        root.mkdir()
        server, embs, programs = _tenant_server(m, str(root), tenant_ids,
                                                **kw)
        try:
            res = body(m, server, embs, programs)
        finally:
            server.replicaset.close(drain=True)
        out[pkg] = (res, server.summary())
    return out


def _same_counters(got, want, clock="frozen"):
    """The drain summaries' counters equal; ``clock`` "wall": a quota's
    ``tokens`` refill with the wall clock between the last admit and the
    drain, so they are left out."""
    for key in COUNTERS + ("errors_unattributed", "queries_dropped"):
        assert got[key] == want[key], key
    assert sorted(got["tenants"]) == sorted(want["tenants"])
    for tid, row in want["tenants"].items():
        mine = got["tenants"][tid]
        assert set(mine) == set(row), tid
        for key in COUNTERS + ("index_kind",):
            assert mine[key] == row[key], (tid, key)
        if "quota" in row:
            skip = {"tokens"} if clock == "wall" else set()
            assert {k: v for k, v in mine["quota"].items() if k not in skip} \
                == {k: v for k, v in row["quota"].items() if k not in skip}


def test_routing_and_the_unknown_tenant_refusal(tmp_path):
    def body(m, server, embs, _):
        recs = [_q(tid, embs[tid], i, qid=f"{tid}{i}")
                for tid in ("acme", "bcorp") for i in (3, 17)]
        recs += [_q("ghost", embs["acme"], 0, qid="x"),
                 {"id": "y", "embedding": embs["acme"][0].tolist()}]
        return server.handle_many(recs)

    res = _both(tmp_path, ["acme", "bcorp"], body)
    (got, gs), (want, ws) = res["port"], res["jax"]
    _same_answers(got, want)
    assert [a["neighbors"][0]["row"] for a in got[:4]] == [3, 17, 3, 17]
    assert [a["neighbors"][0]["gallery_id"] for a in got[:4]] == \
        [3, 17, 1003, 1017]
    assert all("unknown tenant" in a["error"] for a in got[4:])
    _same_counters(gs, ws)
    assert gs["errors_unattributed"] == 2 and gs["queries"] == 4


def test_swap_one_leaves_the_neighbors_bit_identical(tmp_path):
    """A newer commit under acme's prefix: ``swap_one`` republishes acme
    alone; bcorp's engines are the same objects and its answers the same
    bits; acme answers from the new gallery; a second ``swap_one`` finds
    nothing newer, with JAX's message."""

    def body(m, server, embs, programs):
        before = server.handle_many([_q("bcorp", embs["bcorp"], 5)])
        b_engines = server.tenants["bcorp"].engines
        emb2, lab2, ids2 = _gallery(99, id_base=5000)
        prefix = server.tenants["acme"].spec.index_prefix
        m.build(emb2, lab2, ids=ids2, normalize=False).save(
            prefix + "0002.gidx")
        swapper = m.T.TenantSwapper(server, programs=programs)
        detail = swapper.swap_one("acme")
        assert server.tenants["bcorp"].engines is b_engines
        after = server.handle_many([_q("bcorp", embs["bcorp"], 5)])
        assert [_strip(a) for a in after] == [_strip(a) for a in before]
        acme = server.handle_many([_q("acme", emb2, 2)])
        with pytest.raises(m.H.NothingNewerError) as e:
            swapper.swap_one("acme")
        assert swapper.sweep() == {}
        swaps = {tid: server.tenants[tid].swaps for tid in server.tenants}
        return (before + after + acme,
                {k: v for k, v in detail.items()
                 if k not in ("warmup_s", "index_path")},
                os.path.basename(detail["index_path"]), str(e.value), swaps)

    res = _both(tmp_path, ["acme", "bcorp"], body)
    (got, gs), (want, ws) = res["port"], res["jax"]
    _same_answers(got[0], want[0])
    assert got[1:] == want[1:]
    assert got[0][2]["neighbors"][0]["gallery_id"] == 5002
    assert got[2] == "acme-0002.gidx" and got[4] == {"acme": 1, "bcorp": 0}
    _same_counters(gs, ws)
    assert gs["hot_swaps"] == ws["hot_swaps"] == 1


def test_same_geometry_tenants_share_signatures(tmp_path):
    def body(m, server, embs, programs):
        answers = server.handle_many(
            [_q(tid, embs[tid], 0) for tid in ("acme", "bcorp", "ccorp")])
        return (answers, programs.stats(), server._compiles_after_warmup())

    res = _both(tmp_path, ["acme", "bcorp", "ccorp"], body)
    (got, gs), (want, ws) = res["port"], res["jax"]
    _same_answers(got[0], want[0])
    assert got[1:] == want[1:] == ({"families": 1}, 0)
    _same_counters(gs, ws)


def test_quota_sheds_stay_on_their_tenant_and_cross_sum(tmp_path):
    def body(m, server, embs, _):
        recs = [_q("acme", embs["acme"], i, qid=f"a{i}") for i in range(6)]
        recs += [_q("bcorp", embs["bcorp"], i, qid=f"b{i}")
                 for i in range(3)]
        answers = server.handle_many(recs)
        blocks = {tid: sorted(e.stats_block())
                  for tid, e in server.tenants.items()}
        return answers, blocks

    res = _both(tmp_path, ["acme", "bcorp"], body, quotas={"acme": 2.0})
    (got, gs), (want, ws) = res["port"], res["jax"]
    _same_answers(got[0], want[0])
    assert got[1] == want[1]
    shed = [a for a in got[0] if "quota exceeded for tenant 'acme'"
            in a.get("error", "")]
    assert len(shed) == 4
    _same_counters(gs, ws)
    per = gs["tenants"]
    assert per["acme"]["rejected"] == per["acme"]["quota"]["sheds"] == 4
    assert per["bcorp"]["rejected"] == per["bcorp"]["errors"] == 0
    for key in COUNTERS:
        assert sum(row[key] for row in per.values()) == gs[key], key


def test_share_programs_refuses_what_jaxs_refuses():
    from npairloss_tpu_torch.serve.engine import EngineConfig, QueryEngine
    from npairloss_tpu_torch.serve.index import GalleryIndex
    from npairloss_tpu_torch.serve.ivf import IVFIndex

    emb, lab, ids = _gallery(1)
    flat = GalleryIndex.build(emb, lab, ids=ids, device="cpu")
    ivf = IVFIndex.build_ivf(emb, lab, clusters=2, device="cpu")
    cfg = EngineConfig(top_k=3, buckets=(1,))
    base = QueryEngine(flat, cfg)
    other = GalleryIndex.build(emb[::-1].copy(), lab, device="cpu")
    shared = QueryEngine(other, cfg, share_programs_with=base)
    assert shared._seen_sigs is base._seen_sigs
    assert shared.stream is None and shared.index is other
    for kw, needle in (
            ({"index": other, "cfg": EngineConfig(top_k=2, buckets=(1,))},
             "identical EngineConfig"),
            ({"index": ivf, "cfg": cfg}, "same index kind"),
            ({"index": other, "cfg": cfg,
              "model": types.SimpleNamespace()}, "same model object"),
            ({"index": other, "cfg": cfg, "share_compiled_with": base},
             "mutually exclusive")):
        with pytest.raises(ValueError, match=needle):
            QueryEngine(share_programs_with=base, **kw)
    meta = GalleryIndex.build(emb, lab, device="cpu")
    meta.device = __import__("torch").device("meta")
    with pytest.raises(ValueError, match="same device"):
        QueryEngine(meta, cfg, share_programs_with=base)


# -- serve --tenant-config through both CLIs ----------------------------------


def _commit_tenants(root):
    """Two committed galleries built by the JAX package (one commit
    loads in both packages): acme flat, bcorp IVF."""
    from npairloss_tpu.serve import GalleryIndex as JGalleryIndex
    from npairloss_tpu.serve.ivf import IVFIndex as JIVFIndex

    emb_a, lab_a, ids_a = _gallery(7)
    emb_b, lab_b, ids_b = _gallery(8, id_base=1000)
    os.makedirs(root / "idx")
    JGalleryIndex.build(emb_a, lab_a, ids=ids_a, normalize=False).save(
        str(root / "idx" / "acme-0001.gidx"))
    JIVFIndex.build_ivf(emb_b, lab_b, ids=ids_b, normalize=False,
                        clusters=3, seed=0).save(
        str(root / "idx" / "bcorp-0001.gidx"))
    return {"acme": emb_a, "bcorp": emb_b}


def _tenants_manifest(root):
    return {"schema": "npairloss-tenants-v1", "tenants": [
        {"tenant_id": "acme", "index_prefix": str(root / "idx" / "acme-"),
         "quota_qps": 0.5, "quota_burst_s": 6.0},
        {"tenant_id": "bcorp", "index_prefix": str(root / "idx" / "bcorp-"),
         "index_kind": "ivf"}]}


def _jsonl(main, argv, records):
    out = io.StringIO()
    stdin = io.StringIO("".join(json.dumps(r) + "\n" for r in records))
    with contextlib.redirect_stdout(out), \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr("sys.stdin", stdin)
        rc = main(argv)
    return rc, [json.loads(ln) for ln in out.getvalue().splitlines()]


def test_serve_tenant_config_cli_matches_jax(tmp_path):
    """One JSONL stream through both CLIs: queries for both tenants,
    acme past its quota, ingest to both, an unknown and a missing tenant.
    Answers, drain counters and each tenant's checkpoint equal JAX's, and
    JAX's ``bench_check.check_tenants`` accepts the port's run dir."""
    from npairloss_tpu_torch.serve.index import load_newest

    base = tmp_path / "base"
    embs = _commit_tenants(base)
    r = np.random.default_rng(3)
    new = {t: r.standard_normal((2, 16)).astype(np.float32)
           for t in embs}
    recs = [_q("acme", embs["acme"], i, qid=f"a{i}") for i in range(5)]
    recs += [_q("bcorp", embs["bcorp"], i, qid=f"b{i}") for i in (0, 9, 23)]
    recs += [{"id": f"in-{t}", "tenant": t, "ingest": {
        "ids": [9000 + k for k in range(2)], "labels": [5, 5],
        "embeddings": new[t].tolist()}} for t in ("acme", "bcorp")]
    recs += [_q("ghost", embs["acme"], 0, qid="x"),
             {"id": "y", "embedding": embs["acme"][0].tolist()},
             {"id": "z", "tenant": "bcorp", "embedding": new["bcorp"][0]
              .tolist()}]
    runs = {}
    for pkg, main, extra in (("jax", jax_cli.main, ["--mesh", "1"]),
                             ("port", cli.main, ["--device", "cpu"])):
        root = tmp_path / pkg
        shutil.copytree(base, root)
        with open(root / "tenants.json", "w") as f:
            json.dump(_tenants_manifest(root), f)
        rc, lines = _jsonl(main, [
            "serve", "--tenant-config", str(root / "tenants.json"),
            "--top-k", "3", "--buckets", "1,4", "--probes", "2",
            "--ivf-clusters", "3", "--poll-s", "0.01", "--explicit-drops",
            "--wal-dir", str(root / "wal"), "--wal-checkpoint-every", "0",
            *extra], recs)
        assert rc == 0
        with open(root / "answers.jsonl", "w") as f:
            f.write("".join(json.dumps(a) + "\n" for a in lines))
        ckpts = {t: sorted(os.listdir(root / "idx")) for t in embs}
        newest = {t: load_newest(str(root / "idx" / f"{t}-"),
                                 device="cpu")[1] for t in embs}
        runs[pkg] = (lines, ckpts, newest, root)
    (jl, jc, jn, _), (pl, pc, pn, proot) = runs["jax"], runs["port"]
    by_id = lambda lines: {a["id"]: a for a in lines[:-1]}  # noqa: E731
    jans, pans = by_id(jl), by_id(pl)
    assert sorted(pans, key=str) == sorted(jans, key=str)
    ids = [r["id"] for r in recs]
    _same_answers([pans[i] for i in ids if not str(i).startswith("in-")],
                  [jans[i] for i in ids if not str(i).startswith("in-")])
    for t in embs:
        ack = {k: pans[f"in-{t}"][k] for k in ("tenant", "ingested", "seq")}
        assert ack == {k: jans[f"in-{t}"][k]
                       for k in ("tenant", "ingested", "seq")}
        assert ack == {"tenant": t, "ingested": 2, "seq": 1}
    # The ingested rows are pending (JAX's rule): bcorp's own row misses.
    assert 9000 not in [n["gallery_id"] for n in pans["z"]["neighbors"]]
    for qid in ("a3", "a4"):
        assert pans[qid]["error"].startswith(
            "quota exceeded for tenant 'acme'")
    pd, jd = pl[-1], jl[-1]
    assert pd["event"] == jd["event"] == "serve_drain"
    _same_counters(pd, jd, clock="wall")
    for t in embs:
        assert pd["tenants"][t]["ingest"]["watermark"] == \
            jd["tenants"][t]["ingest"]["watermark"] == 1
        assert pd["tenants"][t]["ingest"]["checkpoint_watermark"] == 1
    assert pc == jc
    assert "acme-w000000000001.gidx" in pc["acme"]
    assert "bcorp-w000000000001.gidx" in pc["bcorp"]
    for t in embs:
        assert pn[t].ingest_watermark == jn[t].ingest_watermark == 1
        assert pn[t].KIND == jn[t].KIND
        np.testing.assert_array_equal(pn[t].ids, jn[t].ids)
        np.testing.assert_array_equal(pn[t].host_emb, jn[t].host_emb)
    assert sorted(os.listdir(proot / "wal")) == ["acme", "bcorp"]
    spec = importlib.util.spec_from_file_location(
        "bench_check_port_run", os.path.join(REPO, "scripts",
                                             "bench_check.py"))
    bench_check = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench_check)
    assert bench_check.check_tenants(str(proot / "tenants.json")) == []


REFUSALS = [
    ("bad-json", "{not json", []),
    ("bad-manifest", {"schema": "x", "tenants": [{"tenant_id": "a b"}]}, []),
    ("missing-file", None, []),
    ("snapshot", "ok", ["--snapshot", "s"]),
    ("watch", "ok", ["--snapshot", "s", "--watch-snapshots", "p"]),
    ("remediate", "ok", ["--remediate", "--live-obs", "--telemetry-dir",
                         "t"]),
]


@pytest.mark.parametrize("case,manifest,extra", REFUSALS,
                         ids=[c[0] for c in REFUSALS])
def test_build_server_refusals_use_jaxs_words(case, manifest, extra,
                                              tmp_path, caplog):
    path = tmp_path / "tenants.json"
    if manifest == "ok":
        manifest = {"schema": "npairloss-tenants-v1",
                    "tenants": [_entry("acme")]}
    if isinstance(manifest, str):
        path.write_text(manifest)
    elif manifest is not None:
        path.write_text(json.dumps(manifest))
    said = {}
    for pkg, main, dev in (("jax", jax_cli.main, ["--mesh", "1"]),
                           ("port", cli.main, ["--device", "cpu"])):
        caplog.clear()
        with caplog.at_level(logging.ERROR):
            assert main(["serve", "--tenant-config", str(path), *extra,
                         *dev]) == 2
        said[pkg] = [r.getMessage() for r in caplog.records
                     if r.levelno >= logging.ERROR]
    assert said["port"] == said["jax"] and len(said["port"]) == 1
    assert "--tenant-config" in said["port"][0]


def test_weights_are_refused_beside_a_tenant_config(tmp_path, caplog):
    path = tmp_path / "tenants.json"
    path.write_text(json.dumps({"schema": "npairloss-tenants-v1",
                                "tenants": [_entry("acme")]}))
    with caplog.at_level(logging.ERROR):
        assert cli.main(["serve", "--tenant-config", str(path), "--weights",
                         "w.npz", "--device", "cpu"]) == 2
    assert "--tenant-config serves embedding queries only (per-tenant " \
        "model snapshots are not a thing yet) — drop " \
        "--snapshot/--watch-snapshots/--weights" in caplog.text
