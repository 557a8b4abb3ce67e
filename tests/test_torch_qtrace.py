"""Query tracing in the port (``obs/qtrace``, ``serve --qtrace*``) held
against the JAX package on the CPU.

  * the tracer, driven by one seeded clock, writes JAX's artifact key
    for key and value for value (stage split, exemplar retention and
    eviction, SLO violations, drops, markers, the fused probe's span);
  * the stage vocabulary and the artifact's keys equal JAX's, and so do
    the window rows' keys with tracing on;
  * a served run's ``qtrace.json`` (two replicas, four client threads,
    the fused IVF probe, a replica crash) passes JAX's validator, carries
    the ``crash_reroute`` marker and ``probe_fused`` spans, and each
    exemplar's stage spans sum to at most its total;
  * ``timeline`` merges the port's artifact into JAX's exemplar lanes;
  * the engine's per-call ``stages`` accumulator and the periodic
    checkpoint of ``qtrace.json``.
"""

import importlib.util
import json
import os
import threading

import numpy as np
import pytest

from npairloss_tpu_torch import cli
from npairloss_tpu_torch.obs.qtrace import QTraceConfig, QueryTracer
from npairloss_tpu_torch.obs.qtrace import report as preport
from npairloss_tpu_torch.resilience import failpoints as pfail
from npairloss_tpu_torch.serve.batcher import BatcherConfig
from npairloss_tpu_torch.serve.engine import EngineConfig, QueryEngine
from npairloss_tpu_torch.serve.index import GalleryIndex
from npairloss_tpu_torch.serve.ivf import IVFIndex
from npairloss_tpu_torch.serve.server import RetrievalServer, ServerConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "_jax_qtrace_v1_t",
    os.path.join(REPO, "npairloss_tpu", "obs", "qtrace", "report.py"))
JT = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(JT)


@pytest.fixture(autouse=True)
def _clean_failpoints():
    pfail.reset()
    yield
    pfail.reset()


class SeededClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _pair(**cfg):
    """The port's tracer and JAX's on one seeded clock."""
    from npairloss_tpu.obs.qtrace import QTraceConfig as JConfig
    from npairloss_tpu.obs.qtrace import QueryTracer as JTracer

    clk = SeededClock()
    wall = lambda: 1000.0 + clk.t  # noqa: E731
    return clk, [QueryTracer(QTraceConfig(**cfg), clock=clk, wall=wall),
                 JTracer(JConfig(**cfg), clock=clk, wall=wall)]


def _query(clk, tracers, qid, dispatch_s=0.010, score_us=4000.0,
           merge_us=1000.0, replica="r0", fused=False, end="finish"):
    qts = [tr.begin(qid) for tr in tracers]
    for step, hook in ((0.001, "admitted"), (0.002, "picked")):
        clk.t += step
        for tr, qt in zip(tracers, qts):
            getattr(tr, hook)(qt)
    clk.t += 0.003
    for tr, qt in zip(tracers, qts):
        tr.dispatch_begin([qt], replica=replica)
    clk.t += dispatch_s
    for tr, qt in zip(tracers, qts):
        tr.dispatch_end([qt], score_us=score_us, merge_us=merge_us,
                        fused=fused)
        if end == "finish":
            tr.finish(qt)
        else:
            tr.drop(qt, error=(end == "error"))


SCENARIOS = {
    "one-query": lambda clk, trs: _query(clk, trs, "q1"),
    "eviction": lambda clk, trs: [
        _query(clk, trs, f"q{i}", dispatch_s=0.001 * ((i * 7) % 11 + 1))
        for i in range(24)],
    "slo-violations": lambda clk, trs: [
        _query(clk, trs, f"q{i}", dispatch_s=0.005 + 0.02 * (i % 3))
        for i in range(9)],
    "drops-and-errors": lambda clk, trs: [
        _query(clk, trs, f"q{i}", end=("finish", "drop", "error")[i % 3])
        for i in range(9)],
    "markers": lambda clk, trs: [
        _query(clk, trs, "q0"),
        [tr.marker("crash_reroute", dead="r0", target="r1", queries=3)
         for tr in trs],
        [tr.marker("hotswap_flip", generation=2) for tr in trs],
        _query(clk, trs, "q1", replica="r1")],
    "fused": lambda clk, trs: [
        _query(clk, trs, f"q{i}", fused=True, score_us=2500.0 + 100 * i)
        for i in range(5)],
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_seeded_tracer_writes_jax_artifact(scenario, tmp_path):
    clk, trs = _pair(exemplars=4, slo_ms=20.0, window=16)
    SCENARIOS[scenario](clk, trs)
    paths = [trs[0].write(str(tmp_path / "port.json")),
             trs[1].write(str(tmp_path / "jax.json"))]
    port, jax_ = (json.load(open(p)) for p in paths)
    assert port == jax_
    assert trs[0].summary_block() == trs[1].summary_block()
    assert trs[0].window_row() == trs[1].window_row()
    assert preport.validate_qtrace_report(port) is None
    assert JT.validate_qtrace_report(port) is None
    assert preport.qtrace_p99_consistency(port) is None


def test_vocabulary_and_keys_equal_jax():
    for name in ("QTRACE_SCHEMA", "STAGES", "MARKER_NAMES", "ROOT_SPAN",
                 "STAGE_SPANS", "PROBE_FUSED_SPAN", "REPORT_KEYS",
                 "TOTAL_KEYS", "BUDGET_KEYS", "EXEMPLAR_KEYS",
                 "EXEMPLAR_REASONS", "NEST_SLACK_US"):
        assert getattr(preport, name) == getattr(JT, name), name


# -- the served path ----------------------------------------------------------


def _gallery(seed=0, n=256, d=16):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    return emb, (np.arange(n) % 16).astype(np.int32)


def _ivf_server(emb, lab, tracer, tel=None, replicas=2, window=0,
                probe_impl="fused"):
    index = IVFIndex.from_gallery(GalleryIndex.build(emb, lab, device="cpu"),
                                  clusters=4, seed=0)
    cfg = EngineConfig(top_k=5, buckets=(1, 8), probes=2,
                       probe_impl=probe_impl)
    engine = QueryEngine(index, cfg, telemetry=tel)
    engine.warmup()
    engines = [engine] + [QueryEngine(index, cfg, share_compiled_with=engine)
                          for _ in range(replicas - 1)]
    return RetrievalServer(
        engines, BatcherConfig(max_batch=8, max_delay_ms=5.0),
        ServerConfig(metrics_window=window), telemetry=tel, qtrace=tracer)


def _clients(server, emb, threads=4, per=6):
    errors = []

    def client(c):
        try:
            answers = server.handle_many(
                [{"id": f"c{c}-{i}", "embedding": emb[c * per + i].tolist()}
                 for i in range(per)])
            assert all("neighbors" in a for a in answers), answers
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    pool = [threading.Thread(target=client, args=(c,)) for c in range(threads)]
    for t in pool:
        t.start()
    for t in pool:
        t.join(timeout=60)
    assert not errors


def test_served_artifact_passes_jax_validator(tmp_path):
    emb, lab = _gallery()
    tracer = QueryTracer(QTraceConfig(exemplars=64, slo_ms=0.0),
                         out_path=str(tmp_path / "qtrace.json"))
    server = _ivf_server(emb, lab, tracer)
    pfail.arm("serve.replica_crash", times=1)
    server.replicaset.start()
    try:
        _clients(server, emb)
    finally:
        server.replicaset.close(drain=True)
    summary = server._drain()
    rep = json.load(open(tmp_path / "qtrace.json"))
    assert JT.validate_qtrace_report(rep) is None
    assert preport.validate_qtrace_report(rep) is None
    assert preport.qtrace_p99_consistency(rep) is None
    assert rep["totals"]["queries"] == 24 and rep["totals"]["errors"] == 0
    # One marker for each batch the dead replica handed on (the crashed
    # one, then any queued behind it).
    assert rep["totals"]["reroutes"] >= 1
    assert [m["name"] for m in rep["markers"]] == \
        ["crash_reroute"] * rep["totals"]["reroutes"]
    assert summary["qtrace"]["queries"] == 24
    assert rep["exemplars"]
    for ex in rep["exemplars"]:
        names = [e["name"] for e in ex["events"]]
        assert set(preport.STAGE_SPANS) <= set(names), names
        assert names.count(preport.PROBE_FUSED_SPAN) == 1
        root = next(e for e in ex["events"] if e["name"] == preport.ROOT_SPAN)
        # The six stages' self times: score and topk_merge nest inside
        # dispatch, so dispatch's own share is its span less theirs.
        dur = {e["name"]: e["dur"] for e in ex["events"]}
        stages = sum(dur[n] for n in preport.STAGE_SPANS) \
            - dur["qtrace/score"] - dur["qtrace/topk_merge"]
        assert stages <= root["dur"] + preport.NEST_SLACK_US
        # Ingest on the client thread, dispatch on a replica's.
        assert len({e["tid"] for e in ex["events"]}) >= 2


def test_scan_probe_emits_no_fused_span():
    emb, lab = _gallery()
    tracer = QueryTracer(QTraceConfig(exemplars=64, slo_ms=0.0))
    server = _ivf_server(emb, lab, tracer, replicas=1, probe_impl="scan")
    server.replicaset.start()
    try:
        _clients(server, emb, threads=1)
    finally:
        server.replicaset.close(drain=True)
    rep = tracer.report()
    assert rep["exemplars"] and not any(
        e["name"] == preport.PROBE_FUSED_SPAN
        for ex in rep["exemplars"] for e in ex["events"])


def _rows(run):
    return [json.loads(ln) for ln in
            (run / "metrics.jsonl").read_text().splitlines()]


def test_window_rows_carry_jax_keys(tmp_path):
    from npairloss_tpu.obs import RunTelemetry as JRunTelemetry
    from npairloss_tpu.obs.qtrace import QTraceConfig as JConfig
    from npairloss_tpu.obs.qtrace import QueryTracer as JTracer
    from npairloss_tpu.serve import EngineConfig as JEngineConfig
    from npairloss_tpu.serve import GalleryIndex as JGalleryIndex
    from npairloss_tpu.serve import QueryEngine as JQueryEngine
    from npairloss_tpu.serve import RetrievalServer as JRetrievalServer
    from npairloss_tpu.serve.batcher import BatcherConfig as JBatcherConfig
    from npairloss_tpu.serve.server import ServerConfig as JServerConfig

    from npairloss_tpu_torch.obs import RunTelemetry

    emb, lab = _gallery()
    records = [{"id": i, "embedding": emb[i].tolist()} for i in range(8)]
    jtel = JRunTelemetry(str(tmp_path / "jax"))
    jengine = JQueryEngine(JGalleryIndex.build(emb, lab),
                           JEngineConfig(top_k=3, buckets=(1, 8)),
                           telemetry=jtel)
    jengine.warmup()
    jserver = JRetrievalServer(
        jengine, JBatcherConfig(max_batch=8, max_delay_ms=2000.0),
        JServerConfig(metrics_window=4), telemetry=jtel,
        qtrace=JTracer(JConfig(exemplars=8, slo_ms=0.0)))
    tel = RunTelemetry(str(tmp_path / "port"))
    engine = QueryEngine(GalleryIndex.build(emb, lab, device="cpu"),
                         EngineConfig(top_k=3, buckets=(1, 8)), telemetry=tel)
    engine.warmup()
    server = RetrievalServer(
        engine, BatcherConfig(max_batch=8, max_delay_ms=2000.0),
        ServerConfig(metrics_window=4), telemetry=tel,
        qtrace=QueryTracer(QTraceConfig(exemplars=8, slo_ms=0.0)))
    for srv, t in ((jserver, jtel), (server, tel)):
        srv.replicaset.start()
        try:
            srv.handle_many([dict(r) for r in records])
        finally:
            srv.replicaset.close(drain=True)
        srv._drain()
        t.close()
    jrows, prows = _rows(tmp_path / "jax"), _rows(tmp_path / "port")
    assert len(prows) == len(jrows) == 3
    for j, p in zip(jrows[:-1], prows[:-1]):
        assert list(p) == list(j)
        assert p["qtrace_dominant"] in preport.STAGES + ("",)
    assert list(prows[-1]["qtrace"]) == list(jrows[-1]["qtrace"])
    assert list(prows[-1]["qtrace"]["budget"]) == \
        list(jrows[-1]["qtrace"]["budget"])


def test_tracing_off_adds_no_key(tmp_path):
    from npairloss_tpu_torch.obs import RunTelemetry

    emb, lab = _gallery()
    tel = RunTelemetry(str(tmp_path / "run"))
    engine = QueryEngine(GalleryIndex.build(emb, lab, device="cpu"),
                         EngineConfig(top_k=3, buckets=(1, 8)), telemetry=tel)
    engine.warmup()
    server = RetrievalServer(engine, BatcherConfig(max_batch=8),
                             ServerConfig(metrics_window=4), telemetry=tel)
    server.replicaset.start()
    try:
        server.handle_many([{"id": i, "embedding": emb[i].tolist()}
                            for i in range(8)])
    finally:
        server.replicaset.close(drain=True)
    server._drain()
    tel.close()
    text = (tmp_path / "run" / "metrics.jsonl").read_text()
    assert "qtrace" not in text and "quality" not in text


def test_timeline_merges_the_ports_artifact_as_jax_does(tmp_path):
    from npairloss_tpu.obs.fleet.merge_traces import (
        merge_timeline as jmerge,
    )

    from npairloss_tpu_torch.obs.fleet.merge_traces import merge_timeline

    emb, lab = _gallery()
    run = tmp_path / "run"
    run.mkdir()
    tracer = QueryTracer(QTraceConfig(exemplars=64, slo_ms=0.0),
                         out_path=str(run / "qtrace.json"))
    server = _ivf_server(emb, lab, tracer)
    pfail.arm("serve.replica_crash", times=1)
    server.replicaset.start()
    try:
        _clients(server, emb)
    finally:
        server.replicaset.close(drain=True)
    server._drain()
    _, port = merge_timeline(str(run), out_path=str(tmp_path / "p.json"))
    _, jax_ = jmerge(str(run), out_path=str(tmp_path / "j.json"))
    assert port["traceEvents"] == jax_["traceEvents"]
    lanes = {e["args"]["name"] for e in port["traceEvents"]
             if e.get("ph") == "M" and e["name"] == "process_name"}
    assert "serve events" in lanes
    assert {f"serve queries {ex['replica']}" for ex in json.load(
        open(run / "qtrace.json"))["exemplars"]} <= lanes
    assert cli.main(["timeline", str(run)]) == 0


def test_engine_stages_accumulate_over_chunks():
    emb, lab = _gallery()
    engine = QueryEngine(GalleryIndex.build(emb, lab, device="cpu"),
                         EngineConfig(top_k=3, buckets=(1, 8)))
    one, two = {}, {}
    engine.query(emb[:8], stages=one)
    engine.query(emb[:16], stages=two)  # two chunks of 8
    assert one["score_us"] > 0 and one["merge_us"] > 0
    assert set(two) == {"score_us", "merge_us"}
    plain = engine.query(emb[:16])
    assert np.array_equal(plain["rows"],
                          engine.query(emb[:16], stages={})["rows"])


def test_qtrace_checkpoint_rewrites_the_artifact(tmp_path):
    path = tmp_path / "qtrace.json"
    tracer = QueryTracer(QTraceConfig(), out_path=str(path))
    ckpt = cli._QTraceCheckpoints(tracer, every_s=0.01).start()
    try:
        qt = tracer.begin("q0")
        tracer.admitted(qt)
        tracer.picked(qt)
        tracer.dispatch_begin([qt])
        tracer.dispatch_end([qt])
        tracer.finish(qt)
        for _ in range(500):
            if path.exists() and json.loads(path.read_text())[
                    "totals"]["queries"] == 1:
                break
            threading.Event().wait(0.01)
    finally:
        ckpt.stop()
    rep = json.loads(path.read_text())
    assert rep["totals"]["queries"] == 1
    assert preport.validate_qtrace_report(rep) is None
    assert not list(tmp_path.glob("qtrace.json.tmp-*"))
