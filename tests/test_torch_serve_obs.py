"""Serving's telemetry in the port (``serve --telemetry-dir|--trace-dir``,
the spans, the window rows, the drain split, ``prof --step serve``)
held against the JAX package's ``RetrievalServer`` on the same tiny flat
and IVF galleries: the same span names, and window rows and drain
summaries with the same keys in the same order (values are timings).

Both servers coalesce the queries of one ``handle_many`` into one batch
(``max_batch`` = the number of queries, a long deadline), so which spans
finish before each window closes is the same in both.  Also: a span
straddling two windows lands in exactly one, and two threads closing
windows at once never count one window's spans twice; warm-up spans
stay out of every split; with telemetry off the answers and the drain
summary are what they were (no split keys, no files)."""

import contextlib
import io
import json
import os
import threading

import numpy as np
import pytest

from npairloss_tpu_torch import cli
from npairloss_tpu_torch.obs import RunTelemetry
from npairloss_tpu_torch.obs.tracing import validate_chrome_trace
from npairloss_tpu_torch.serve.batcher import BatcherConfig
from npairloss_tpu_torch.serve.engine import EngineConfig, QueryEngine
from npairloss_tpu_torch.serve.index import GalleryIndex
from npairloss_tpu_torch.serve.ivf import IVFIndex
from npairloss_tpu_torch.serve.server import RetrievalServer, ServerConfig

N_QUERIES = 8
WINDOW = 4


def _gallery(seed=0, n=96, d=16):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    return emb, (np.arange(n) % 12).astype(np.int32)


def _rows(run):
    return [json.loads(ln) for ln in
            (run / "metrics.jsonl").read_text().splitlines()]


def _drive(server, emb):
    server.replicaset.start()
    try:
        return server.handle_many(
            [{"id": i, "embedding": emb[i].tolist()}
             for i in range(N_QUERIES)])
    finally:
        server.replicaset.close(drain=True)


def _jax_run(run, kind, emb, lab):
    from npairloss_tpu.obs import RunTelemetry as JRunTelemetry
    from npairloss_tpu.serve import EngineConfig as JEngineConfig
    from npairloss_tpu.serve import GalleryIndex as JGalleryIndex
    from npairloss_tpu.serve import QueryEngine as JQueryEngine
    from npairloss_tpu.serve import RetrievalServer as JRetrievalServer
    from npairloss_tpu.serve.batcher import BatcherConfig as JBatcherConfig
    from npairloss_tpu.serve.server import ServerConfig as JServerConfig

    index = JGalleryIndex.build(emb, lab)
    if kind == "ivf":
        from npairloss_tpu.serve.ivf import IVFIndex as JIVFIndex

        index = JIVFIndex.from_gallery(index, clusters=4, seed=0)
    tel = JRunTelemetry(str(run))
    engine = JQueryEngine(index, JEngineConfig(top_k=3, buckets=(1, 8),
                                               probes=2), telemetry=tel)
    engine.warmup()
    server = JRetrievalServer(
        engine, JBatcherConfig(max_batch=N_QUERIES, max_delay_ms=2000.0),
        JServerConfig(metrics_window=WINDOW), telemetry=tel)
    answers = _drive(server, emb)
    server._drain()
    tel.close()
    return answers


def _port_server(emb, lab, kind, tel, replicas=1, window=WINDOW):
    index = GalleryIndex.build(emb, lab, device="cpu")
    if kind == "ivf":
        index = IVFIndex.from_gallery(index, clusters=4, seed=0)
    cfg = EngineConfig(top_k=3, buckets=(1, 8), probes=2)
    engine = QueryEngine(index, cfg, telemetry=tel)
    engine.warmup()
    engines = [engine] + [QueryEngine(index, cfg, share_compiled_with=engine)
                          for _ in range(replicas - 1)]
    return RetrievalServer(
        engines, BatcherConfig(max_batch=N_QUERIES, max_delay_ms=2000.0),
        ServerConfig(metrics_window=window), telemetry=tel)


def _port_run(run, kind, emb, lab):
    tel = RunTelemetry(str(run))
    server = _port_server(emb, lab, kind, tel)
    answers = _drive(server, emb)
    server._drain()
    tel.close()
    return answers


def _names(run):
    trace = json.load(open(run / "trace.json"))
    assert validate_chrome_trace(trace) is None
    return {e["name"] for e in trace["traceEvents"]}


@pytest.mark.parametrize("kind", ["flat", "ivf"])
def test_spans_and_window_rows_match_jax(tmp_path, kind):
    emb, lab = _gallery()
    jans = _jax_run(tmp_path / "jax", kind, emb, lab)
    pans = _port_run(tmp_path / "port", kind, emb, lab)
    assert [a["id"] for a in pans] == [a["id"] for a in jans]
    assert _names(tmp_path / "port") == _names(tmp_path / "jax") == {
        "serve/warmup", "serve/admit", "serve/batch", "serve/dispatch",
        "serve/topk"}
    jrows, prows = _rows(tmp_path / "jax"), _rows(tmp_path / "port")
    assert len(prows) == len(jrows) == N_QUERIES // WINDOW + 1
    for j, p in zip(jrows[:-1], prows[:-1]):
        assert list(p) == list(j)
    # The first window saw every span of the one batch; the second none.
    assert "topk_p99_ms" in prows[0] and "topk_p99_ms" not in prows[1]
    # The drain summary: the whole run's split, warm-up excluded.
    jsum, psum = jrows[-1], prows[-1]
    split = lambda s: [k for k in s if k.split("_")[0] in  # noqa: E731
                       ("admit", "batch", "dispatch", "encode", "topk")
                       and k.endswith(("_p50_ms", "_p99_ms"))]
    assert split(psum) == split(jsum)
    assert psum["event"] == "serve_drain" and psum["answered"] == N_QUERIES


def test_replicas_dispatch_on_their_own_lanes(tmp_path):  # slow-ok: the replicas' trace lanes
    emb, lab = _gallery()
    tel = RunTelemetry(str(tmp_path / "run"))
    server = _port_server(emb, lab, "flat", tel, replicas=2, window=0)
    server.replicaset.start()
    try:
        # One query at a time: the router sends each to the emptier queue,
        # so both replicas dispatch.
        for i in range(6):
            server.handle_many([{"id": i, "embedding": emb[i].tolist()}])
        server.replicaset.replicas[0].alive = False
        server.handle_many([{"id": 6, "embedding": emb[6].tolist()}])
        server.replicaset.replicas[0].alive = True
        server.replicaset.replicas[1].alive = False
        server.handle_many([{"id": 7, "embedding": emb[7].tolist()}])
    finally:
        server.replicaset.replicas[1].alive = True
        server.replicaset.close(drain=True)
    tel.close()
    trace = json.load(open(tmp_path / "run" / "trace.json"))
    lanes = {e["tid"] for e in trace["traceEvents"]
             if e["name"] == "serve/dispatch"}
    assert len(lanes) == 2


def test_window_split_counts_a_straddling_span_once(tmp_path):
    from npairloss_tpu.obs.perf.decompose import (
        serve_latency_decomposition as jsplit,
    )
    from npairloss_tpu_torch.obs.perf.decompose import (
        serve_latency_decomposition as psplit,
    )

    ev = lambda name, ts, dur: {"name": name, "ph": "X", "ts": ts,  # noqa
                                "dur": dur, "pid": 1, "tid": 1}
    events = [ev("serve/dispatch", 900, 5000), ev("serve/dispatch", 0, 500)]
    assert psplit(events, since_us=1000) == jsplit(events, since_us=1000)
    assert psplit(events, since_us=1000)["dispatch"]["count"] == 1

    emb, lab = _gallery()
    tel = RunTelemetry(str(tmp_path / "run"))
    server = _port_server(emb, lab, "flat", tel)
    span = tel.span("serve/dispatch", size=1)
    span.__enter__()
    first = server._window_latency_split()   # in flight: not yet counted
    span.__exit__(None, None, None)
    second = server._window_latency_split()  # finished: counted here
    third = server._window_latency_split()   # and never again
    tel.close()
    assert "dispatch_p50_ms" not in first
    assert "dispatch_p50_ms" in second
    assert third == {}


def test_concurrent_window_closes_never_double_count(tmp_path):
    from npairloss_tpu_torch.obs.perf import decompose

    emb, lab = _gallery()
    tel = RunTelemetry(str(tmp_path / "run"))
    server = _port_server(emb, lab, "flat", tel)
    counts = []
    real = decompose.serve_latency_decomposition

    def counting(events, since_us=0.0):
        out = real(events, since_us)
        counts.append(sum(r["count"] for r in out.values()))
        return out

    decompose.serve_latency_decomposition = counting
    try:
        for _ in range(20):
            for _ in range(50):
                with tel.span("serve/topk"):
                    pass
            barrier = threading.Barrier(4)

            def close():
                barrier.wait()
                server._window_latency_split()

            threads = [threading.Thread(target=close) for _ in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
    finally:
        decompose.serve_latency_decomposition = real
        tel.close()
    assert sum(counts) == 20 * 50


def test_warmup_spans_stay_out_of_every_split(tmp_path):
    from npairloss_tpu.obs import RunTelemetry as JRunTelemetry
    from npairloss_tpu.serve import EngineConfig as JEngineConfig
    from npairloss_tpu.serve import GalleryIndex as JGalleryIndex
    from npairloss_tpu.serve import QueryEngine as JQueryEngine
    from npairloss_tpu.serve import RetrievalServer as JRetrievalServer
    from npairloss_tpu.serve.batcher import BatcherConfig as JBatcherConfig

    emb, lab = _gallery()
    out = {}
    for name, tel_cls, engine_fn, server_fn in (
            ("jax", JRunTelemetry,
             lambda tel: JQueryEngine(JGalleryIndex.build(emb, lab),
                                      JEngineConfig(top_k=3, buckets=(1,)),
                                      telemetry=tel),
             lambda eng, tel: JRetrievalServer(
                 eng, JBatcherConfig(max_batch=1), telemetry=tel)),
            ("port", RunTelemetry,
             lambda tel: QueryEngine(
                 GalleryIndex.build(emb, lab, device="cpu"),
                 EngineConfig(top_k=3, buckets=(1,)), telemetry=tel),
             lambda eng, tel: RetrievalServer(
                 eng, BatcherConfig(max_batch=1), telemetry=tel))):
        tel = tel_cls(str(tmp_path / name))
        with tel.tracer.span("serve/topk"):  # a stray early span
            pass
        engine = engine_fn(tel)
        engine.warmup()  # before the server, as `serve` warms
        server = server_fn(engine, tel)
        s = server.summary()
        out[name] = ([k for k in s if k.startswith("topk_")],
                     server._window_latency_split())
        tel.close()
    assert out["port"] == out["jax"] == ([], {})


def test_telemetry_off_keeps_answers_and_summary(tmp_path):
    emb, lab = _gallery()
    lines = "".join(json.dumps({"id": i, "embedding": emb[i].tolist()})
                    + "\n" for i in range(12))
    outs = {}
    for name, tel in (("off", None), ("on", RunTelemetry(str(tmp_path)))):
        server = _port_server(emb, lab, "flat", tel)
        buf = io.StringIO()
        assert server.run_jsonl(io.StringIO(lines), buf) == 0
        if tel is not None:
            tel.close()
        outs[name] = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    assert outs["on"][:-1] == outs["off"][:-1]
    off = outs["off"][-1]
    assert list(off) == [
        "event", "queries", "answered", "errors", "errors_refused",
        "rejected", "batches", "device", "p50_ms", "p99_ms", "warmed",
        "dispatches"]
    on = outs["on"][-1]
    assert [k for k in on if k not in off] == [
        "admit_p50_ms", "admit_p99_ms", "batch_p50_ms", "batch_p99_ms",
        "dispatch_p50_ms", "dispatch_p99_ms", "topk_p50_ms", "topk_p99_ms"]


def _index_dir(tmp_path):
    emb, lab = _gallery()
    np.save(tmp_path / "g.emb.npy", emb)
    np.save(tmp_path / "g.labels.npy", lab)
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["index", "--prefix", str(tmp_path / "g"),
                         "--device", "cpu"]) == 0
    return emb, str(tmp_path / "g.gidx")


@pytest.mark.parametrize("flag", ["--telemetry-dir", "--trace-dir"])
def test_serve_cli_writes_the_run_dir(tmp_path, monkeypatch, flag):
    emb, gidx = _index_dir(tmp_path)
    lines = "".join(json.dumps({"id": i, "embedding": emb[i].tolist()})
                    + "\n" for i in range(10))
    run = tmp_path / "tel"
    monkeypatch.setattr("sys.stdin", io.StringIO(lines))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["serve", "--index", gidx, "--device", "cpu",
                       "--replicas", "2", "--metrics-window", "4",
                       flag, str(run)])
    assert rc == 0
    answers = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    assert len(answers) == 11 and answers[-1]["event"] == "serve_drain"
    names = _names(run)
    assert {"serve/admit", "serve/batch", "serve/dispatch", "serve/topk",
            "serve/warmup"} <= names
    if flag == "--trace-dir":
        assert sorted(os.listdir(run)) == ["trace.json"]
    else:
        rows = _rows(run)
        assert [r["phase"] for r in rows] == ["serve"] * 3
        assert rows[-1]["event"] == "serve_drain"
        man = json.load(open(run / "manifest.json"))
        assert man["config"]["replicas"] == 2
    with contextlib.redirect_stdout(io.StringIO()) as tl:
        assert cli.main(["timeline", str(run)]) == 0
    merged = json.load(open(json.loads(tl.getvalue())["timeline"]))
    assert validate_chrome_trace(merged) is None


def test_serve_telemetry_flags_are_exclusive(tmp_path):
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(
            ["serve", "--index", "x", "--telemetry-dir", "a",
             "--trace-dir", "b"])


def test_http_request_threads_span_their_admissions(tmp_path):
    import urllib.request

    from npairloss_tpu_torch.resilience.preempt import PreemptionSignal

    emb, lab = _gallery()
    tel = RunTelemetry(str(tmp_path / "run"))
    server = _port_server(emb, lab, "flat", tel, window=2)
    server.preempt = PreemptionSignal()
    server.cfg = ServerConfig(metrics_window=2, poll_s=0.02)
    th = threading.Thread(target=server.run_http, args=(0,), daemon=True)
    th.start()
    for _ in range(500):
        if server.http_port:
            break
        threading.Event().wait(0.01)
    for i in range(4):
        body = json.dumps({"id": i, "embedding": emb[i].tolist()}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.http_port}/query", data=body,
            method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            assert "neighbors" in json.loads(r.read())
    server.preempt.request()
    th.join(timeout=60)
    assert not th.is_alive()
    tel.close()
    rows = _rows(tmp_path / "run")
    assert [r["phase"] for r in rows] == ["serve"] * 3
    trace = json.load(open(tmp_path / "run" / "trace.json"))
    admits = {e["tid"] for e in trace["traceEvents"]
              if e["name"] == "serve/admit"}
    dispatch = {e["tid"] for e in trace["traceEvents"]
                if e["name"] == "serve/dispatch"}
    assert admits and not admits & dispatch


def test_encode_spans_with_a_model(tmp_path):
    from npairloss_tpu_torch.models import get_model

    rng = np.random.default_rng(1)
    model = get_model("mlp", input_shape=(4, 4, 3), device="cpu", seed=0)
    emb = rng.standard_normal((40, 64)).astype(np.float32)
    index = GalleryIndex.build(emb, np.arange(40, dtype=np.int32) % 5,
                               device="cpu")
    tel = RunTelemetry(str(tmp_path / "run"))
    engine = QueryEngine(index, EngineConfig(top_k=3, buckets=(1, 4)),
                         model=model, telemetry=tel)
    engine.warmup(input_shape=(4, 4, 3))
    server = RetrievalServer(engine, BatcherConfig(max_batch=4,
                                                   max_delay_ms=2000.0),
                             ServerConfig(metrics_window=4), telemetry=tel)
    x = rng.standard_normal((4, 4, 4, 3)).astype(np.float32)
    server.replicaset.start()
    try:
        out = server.handle_many([{"id": i, "input": x[i].tolist()}
                                  for i in range(4)])
    finally:
        server.replicaset.close(drain=True)
    tel.close()
    assert all("neighbors" in a for a in out)
    row = _rows(tmp_path / "run")[0]
    assert "encode_p50_ms" in row and "topk_p50_ms" in row
    kinds = {(e["name"], (e.get("args") or {}).get("kind"))
             for e in json.load(open(tmp_path / "run" / "trace.json"))
             ["traceEvents"] if e["name"] == "serve/warmup"}
    assert kinds == {("serve/warmup", "topk"), ("serve/warmup", "encode")}


def test_recompile_instant_on_a_shape_first_met_after_warmup(tmp_path):
    emb, lab = _gallery()
    tel = RunTelemetry(str(tmp_path / "run"))
    index = GalleryIndex.build(emb, lab, device="cpu")
    engine = QueryEngine(index, EngineConfig(top_k=3, buckets=(1, 8)),
                         telemetry=tel)
    engine.warmup()
    engine.query(emb[:3])                    # a warmed bucket
    index.add(emb[:5] * 0.5, lab[:5], ids=np.arange(1000, 1005))
    engine.query(emb[:3])                    # a new gallery shape
    tel.close()
    trace = json.load(open(tmp_path / "run" / "trace.json"))
    marks = [e for e in trace["traceEvents"] if e["name"] ==
             "serve/recompile"]
    assert len(marks) == 1 and "topk" in marks[0]["args"]["sig"]


def test_prof_step_serve_matches_jax_categories(tmp_path):
    from npairloss_tpu import cli as jax_cli
    from npairloss_tpu.obs.perf import validate_report as jvalidate
    from npairloss_tpu_torch.obs.perf import validate_report

    reports = {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        out = tmp_path / name
        with contextlib.redirect_stdout(io.StringIO()):
            assert main(["prof", "--step", "serve", "--gallery", "256",
                         "--dim", "16", "--steps", "6", "--out", str(out),
                         *extra]) == 0
        reports[name] = json.load(open(out / "perf_report.json"))
    got, want = reports["port"], reports["jax"]
    assert validate_report(got) is None and jvalidate(got) is None
    assert got["step"] == want["step"] == "serve"
    assert set(got["decomposition"]["parts"]) == set(
        want["decomposition"]["parts"])
    assert set(got["serve_latency"]) == set(want["serve_latency"]) == {
        "topk"}
    assert got["serve_latency"]["topk"]["count"] == 6
    regions = {r["region"]: r for r in got["regions"]}
    assert set(regions) <= {"serve/topk", "(unscoped)"}
    # The one matmul of the largest bucket against the gallery; the
    # unscoped rest is the query's upload and the answers' copies.
    assert regions["serve/topk"]["flops"] == 2 * 32 * 256 * 16
    assert regions.get("(unscoped)", {"flops": 0})["flops"] == 0
    assert got["timing"]["steps"] == want["timing"]["steps"] == 2
