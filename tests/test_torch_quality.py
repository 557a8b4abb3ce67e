"""The quality observatory in the port (``obs/quality``: the
``npairloss-quality-v1`` contract, the ShadowScorer, ``serve
--shadow-*``, ``prof --quality``, the ``serve.recall_drop`` failpoint)
held against the JAX package on the CPU, from seed-made numpy inputs.

  * the shadow set (``shadow_sampled``) and the per-query recall
    (``recall_against``) equal JAX's;
  * every bad stream of JAX's validator tests, quality logs and qtrace
    artifacts alike, is refused by both packages' validators (JAX's
    loaded by file path: they are stdlib only);
  * one 2,048 x 64 IVF gallery (16 clusters, probes 2) and the same
    queries through JAX's server and the port's (``cli.build_server``
    with ``--shadow-rate 0.5 --shadow-window 8``): the same ids sampled,
    every window's recall@k within 1e-6 of JAX's;
  * ``serve.recall_drop`` collapses recall in both, and only on a
    warmed IVF engine;
  * with shadow and qtrace on, the answers are byte for byte those with
    both off; the oracle follows an in-place ``add``; ``offer`` never
    blocks on a wedged oracle;
  * ``prof --quality`` prints JAX's text for a log JAX wrote.
"""

import contextlib
import importlib.util
import io
import json
import os
import threading
import time

import numpy as np
import pytest

from npairloss_tpu_torch import cli
from npairloss_tpu_torch.obs.quality import report as preport
from npairloss_tpu_torch.obs.quality.shadow import (
    ShadowConfig,
    ShadowScorer,
    recall_against,
    shadow_sampled,
)
from npairloss_tpu_torch.resilience import failpoints as pfail
from npairloss_tpu_torch.serve.engine import EngineConfig, QueryEngine
from npairloss_tpu_torch.serve.index import GalleryIndex, load_index

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_by_path(rel, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JQ = _load_by_path("npairloss_tpu/obs/quality/report.py", "_jax_quality_v1")
JT = _load_by_path("npairloss_tpu/obs/qtrace/report.py", "_jax_qtrace_v1")


@pytest.fixture(autouse=True)
def _clean_failpoints():
    from npairloss_tpu.resilience import failpoints as jfail

    pfail.reset()
    jfail.reset()
    yield
    pfail.reset()
    jfail.reset()


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


# -- sampling and recall math -------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("rate", [0.01, 0.1, 0.5])
def test_shadow_sampled_picks_jax_ids(rate, seed):
    from npairloss_tpu.obs.quality.shadow import shadow_sampled as jsampled

    ids = range(10_000)
    mine = [i for i in ids if shadow_sampled(i, rate, seed)]
    assert mine == [i for i in ids if jsampled(i, rate, seed)]
    assert 0.5 * rate < len(mine) / 10_000 < 1.5 * rate


def test_recall_against_equals_jax_on_hand_fixtures():
    from npairloss_tpu.obs.quality.shadow import recall_against as jrecall

    exact = [10, 20, 30, 40, 50]
    cases = [([10, 20, 30, 40, 50], 5, 1.0), ([10, 20, 99, 98, 97], 5, 0.4),
             ([99, 98, 97, 96, 95], 5, 0.0), ([10, 99], 1, 1.0),
             ([20, 10], 1, 0.0), ([50, 40, 30, 20, 10], 5, 1.0)]
    for served, k, want in cases:
        assert recall_against(served, exact, k) == want
        assert jrecall(served, exact, k) == want


# -- the validators' teeth ----------------------------------------------------


def _config(**over):
    return {"schema": preport.QUALITY_SCHEMA, "kind": "config",
            "shadow_rate": 0.5, "seed": 0, "ks": [1, 5], "window": 4,
            "wall_time": 100.0, "stale_after_s": 30.0, **over}


def _window(t=101.0, total=4, r1=1.0, r5=1.0, **over):
    return {"schema": preport.QUALITY_SCHEMA, "kind": "window",
            "wall_time": t, "samples": 4, "sampled_total": total,
            "recall_at_1": r1, "recall_at_5": r5, "score_gap_mean": 0.0,
            "score_gap_max": 0.01, **over}


def _summary(t=110.0, total=4, windows=1, last=101.0, **over):
    return {"schema": preport.QUALITY_SCHEMA, "kind": "summary",
            "wall_time": t, "sampled_total": total, "windows": windows,
            "dropped": 0, "last_sample_wall_time": last, **over}


# The bad quality streams of tests/test_quality.py (the validator's
# teeth), each with the words its refusal must carry.
QUALITY_BAD = [
    ("empty", lambda: [], "empty"),
    ("window-first", lambda: [_window()], "record 0 must be the config"),
    ("schema", lambda: [_config(schema="npairloss-quality-v0")],
     "schema must be"),
    ("dup-config", lambda: [_config(), _config(wall_time=101.0)],
     "duplicate config"),
    ("rate", lambda: [_config(shadow_rate=0.0)], "shadow_rate"),
    ("ks-order", lambda: [_config(ks=[5, 1])], "ks must be"),
    ("ks-empty", lambda: [_config(ks=[])], "ks must be"),
    ("floor-metric", lambda: [_config(recall_floor=0.9)], "floor_metric"),
    ("floor-range", lambda: [_config(recall_floor=1.5,
                                     floor_metric="serve_recall_at_5")],
     "recall_floor"),
    ("recall-range", lambda: [_config(), _window(r1=1.2)], "recall_at_1"),
    ("recall-missing", lambda: [_config(), {
        k: v for k, v in _window().items() if k != "recall_at_5"}],
     "recall_at_5"),
    ("gap-negative", lambda: [_config(), _window(score_gap_mean=-0.1)],
     "score gaps"),
    ("gap-max", lambda: [_config(), _window(score_gap_mean=0.5,
                                            score_gap_max=0.1)],
     "score_gap_max"),
    ("total-regressed", lambda: [_config(), _window(total=8),
                                 _window(t=102.0, total=4)], "regressed"),
    ("time-back", lambda: [_config(), _window(t=99.0)], "precedes"),
    ("summary-windows", lambda: [_config(), _window(), _summary(windows=2)],
     "window(s)"),
    ("after-summary", lambda: [_config(), _window(), _summary(),
                               _window(t=120.0)], "after the summary"),
    ("summary-last-sample", lambda: [_config(), _window(), {
        k: v for k, v in _summary().items()
        if k != "last_sample_wall_time"}], "last_sample_wall_time"),
    ("bad-line", lambda: [_config(), {"_bad_line": 2}], "unparseable"),
    ("not-object", lambda: ["nope"], "not an object"),
]


def _valid_qtrace():
    """Two seeded queries and a marker through the port's tracer (the
    fixture of tests/test_qtrace.py)."""
    from npairloss_tpu_torch.obs.qtrace import QTraceConfig, QueryTracer

    t = [0.0]
    tr = QueryTracer(QTraceConfig(exemplars=4, slo_ms=0.0),
                     clock=lambda: t[0], wall=lambda: 1000.0 + t[0])
    for qid, dispatch_s in (("q1", 0.010), ("q2", 0.020)):
        qt = tr.begin(qid)
        for step, hook in ((0.001, tr.admitted), (0.002, tr.picked)):
            t[0] += step
            hook(qt)
        t[0] += 0.003
        tr.dispatch_begin([qt], replica="r0")
        t[0] += dispatch_s
        tr.dispatch_end([qt], score_us=4000.0, merge_us=1000.0)
        tr.finish(qt)
    tr.marker("hotswap_flip", generation=1)
    return json.loads(json.dumps(tr.report()))


def _qt_dup_trace_id(rep):
    src, dst = rep["exemplars"][0], rep["exemplars"][1]
    dst["trace_id"] = src["trace_id"]
    for ev in dst["events"]:
        ev["args"]["trace_id"] = src["trace_id"]


def _qt_nesting(rep):
    next(e for e in rep["exemplars"][0]["events"]
         if e["name"] == "qtrace/queue_wait")["dur"] = 1e9


def _set(path, value):
    def doctor(rep):
        obj = rep
        for key in path[:-1]:
            obj = obj[key]
        obj[path[-1]] = value
    return doctor


# The doctored artifacts of tests/test_qtrace.py.
QTRACE_BAD = [
    ("schema", _set(("schema",), "npairloss-qtrace-v2"), "foreign artifact"),
    ("missing-key", lambda rep: rep.pop("budget"), "missing key"),
    ("stage-vocab", _set(("stages", 3), "disptach"),
     "do not match the contract"),
    ("dup-trace-id", _qt_dup_trace_id, "duplicate trace_id"),
    ("event-order", lambda rep: rep["exemplars"][0]["events"].reverse(),
     "out of ts order"),
    ("nesting", _qt_nesting, "broken nesting"),
    ("totals-mismatch", lambda rep: rep["totals"].update(
        exemplars=rep["totals"]["exemplars"] + 1), "retained exemplars"),
    ("marker-name", _set(("markers", 0, "name"), "surprise_party"),
     "instant named one of"),
    ("foreign-span", _set(("exemplars", 0, "events", 0, "name"),
                          "qtrace/gpu_melt"), "outside the qtrace vocabulary"),
    ("reason", _set(("exemplars", 0, "reason"), "vibes"), "reason"),
]


@pytest.mark.parametrize(
    "contract, make, needle",
    [("quality", make, needle) for _, make, needle in QUALITY_BAD]
    + [("qtrace", doctor, needle) for _, doctor, needle in QTRACE_BAD],
    ids=[f"quality-{n}" for n, _, _ in QUALITY_BAD]
    + [f"qtrace-{n}" for n, _, _ in QTRACE_BAD])
def test_validators_refuse_bad_streams_in_both(contract, make, needle):
    from npairloss_tpu_torch.obs.qtrace import report as ptrace

    if contract == "quality":
        recs = make()
        errs = [preport.validate_quality_report(recs),
                JQ.validate_quality_report(recs)]
    else:
        rep = _valid_qtrace()
        assert ptrace.validate_qtrace_report(rep) is None
        assert JT.validate_qtrace_report(rep) is None
        make(rep)
        errs = [ptrace.validate_qtrace_report(rep),
                JT.validate_qtrace_report(rep)]
    assert errs[0] == errs[1]
    assert errs[0] is not None and needle in errs[0], errs


# -- the shadow through both servers -----------------------------------------


@pytest.fixture(scope="module")
def ivf_2048(tmp_path_factory):
    """One JAX-built IVF commit (2,048 x 64 in 64 identities, 16
    clusters) both packages load, and 64 noisy gallery rows as
    queries."""
    from npairloss_tpu.serve.ivf import IVFIndex as JIVF
    from npairloss_tpu.serve.ivf import measure_parity as jparity

    rng = np.random.default_rng(11)
    lab = (np.arange(2048) % 64).astype(np.int32)
    emb = _unit(rng, 64, 64)[lab] + 0.35 * _unit(rng, 2048, 64)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = emb[rng.choice(2048, 64, replace=False)] \
        + 0.1 * rng.standard_normal((64, 64)).astype(np.float32)
    jidx = JIVF.build_ivf(emb, lab, clusters=16, seed=0, normalize=False)
    jidx.parity = jparity(jidx, probes=2, sample=128)
    path = str(tmp_path_factory.mktemp("ivf") / "g.gidx")
    jidx.save(path)
    return path, emb, q.astype(np.float32)


def _records(q, prefix="q"):
    return [{"id": f"{prefix}{i}", "embedding": q[i].tolist()}
            for i in range(q.shape[0])]


def _spy_offers(scorer):
    """The ids the dispatch offered that the scorer kept, in order."""
    kept = []
    real = scorer.offer

    def offer(qid, *a):
        ok = real(qid, *a)
        if ok:
            kept.append(qid)
        return ok

    scorer.offer = offer
    return kept


def _wait_windows(scorer, n, timeout=60.0):
    deadline = time.time() + timeout
    while scorer.windows < n and time.time() < deadline:
        time.sleep(0.02)


def _port_serve_args(path, tel, *extra):
    return cli.build_parser().parse_args([
        "serve", "--index", path, "--index-kind", "ivf", "--probes", "2",
        "--top-k", "10", "--buckets", "1,8,32", "--device", "cpu",
        "--metrics-window", "0", "--deadline-ms", "2000",
        "--telemetry-dir", str(tel), *extra])


def _port_shadow_run(path, tel, q, arm=False):
    server, _ = cli.build_server(_port_serve_args(
        path, tel, "--shadow-rate", "0.5", "--shadow-window", "8"))
    kept = _spy_offers(server.shadow)
    if arm:
        pfail.arm("serve.recall_drop", times=None)
    server.replicaset.start()
    try:
        answers = server.handle_many(_records(q))
    finally:
        server.replicaset.close(drain=True)
    summary = server._drain()
    server.shadow.close()
    server.telemetry.close()
    pfail.reset()
    return answers, kept, summary, preport.load_quality_report(
        os.path.join(tel, "quality.jsonl"))


def _jax_shadow_run(path, tel, q, arm=False):
    from npairloss_tpu.obs.quality.report import load_quality_report
    from npairloss_tpu.obs.quality.shadow import ShadowConfig as JConfig
    from npairloss_tpu.obs.quality.shadow import ShadowScorer as JScorer
    from npairloss_tpu.resilience import failpoints as jfail
    from npairloss_tpu.serve import EngineConfig as JEngineConfig
    from npairloss_tpu.serve import QueryEngine as JQueryEngine
    from npairloss_tpu.serve import RetrievalServer as JServer
    from npairloss_tpu.serve.batcher import BatcherConfig as JBatcherConfig
    from npairloss_tpu.serve.index import load_index as jload
    from npairloss_tpu.serve.index import read_manifest as jmanifest
    from npairloss_tpu.serve.server import ServerConfig as JServerConfig

    engine = JQueryEngine(jload(path), JEngineConfig(
        top_k=10, buckets=(1, 8, 32), probes=2))
    engine.warmup()
    server = JServer(engine, JBatcherConfig(max_batch=32,
                                            max_delay_ms=2000.0),
                     JServerConfig(metrics_window=0))
    os.makedirs(tel, exist_ok=True)
    server.shadow = JScorer(
        lambda: server.engine.index,
        JConfig(rate=0.5, ks=(1, 5, 10), window=8),
        out_path=os.path.join(tel, "quality.jsonl"),
        baseline=jmanifest(path).get("parity")).start()
    kept = _spy_offers(server.shadow)
    if arm:
        jfail.arm("serve.recall_drop", times=None)
    server.replicaset.start()
    try:
        answers = server.handle_many(_records(q))
    finally:
        server.replicaset.close(drain=True)
    server.shadow.close()
    jfail.reset()
    return answers, kept, load_quality_report(
        os.path.join(tel, "quality.jsonl"))


def _windows(recs):
    return [r for r in recs if r["kind"] == "window"]


def test_shadow_windows_equal_jax(ivf_2048, tmp_path):
    path, _, q = ivf_2048
    pans, pkept, psum, precs = _port_shadow_run(path, str(tmp_path / "p"), q)
    jans, jkept, jrecs = _jax_shadow_run(path, str(tmp_path / "j"), q)
    # The same answers (rows) and the same sampled ids, in order.
    assert [[n["row"] for n in a["neighbors"]] for a in pans] == \
        [[n["row"] for n in a["neighbors"]] for a in jans]
    assert pkept == jkept == [f"q{i}" for i in range(64)
                              if shadow_sampled(f"q{i}", 0.5, 0)]
    assert preport.validate_quality_report(precs) is None
    assert JQ.validate_quality_report(precs) is None
    pw, jw = _windows(precs), _windows(jrecs)
    assert len(pw) == len(jw) == -(-len(pkept) // 8)
    for a, b in zip(pw, jw):
        assert a["samples"] == b["samples"]
        assert a["sampled_total"] == b["sampled_total"]
        for k in (1, 5, 10):
            assert abs(a[f"recall_at_{k}"] - b[f"recall_at_{k}"]) <= 1e-6
        assert abs(a["score_gap_mean"] - b["score_gap_mean"]) <= 1e-6
    # The config record: the parity stamp is the baseline, as JAX's.
    assert precs[0]["baseline"] == jrecs[0]["baseline"]
    assert [k for k in precs[0]] == [k for k in jrecs[0]]
    assert precs[-1]["kind"] == "summary"
    # The drain's block is what was scored by then; the log's summary
    # record, written after the queue drained, counts every sample.
    assert psum["quality"]["sampled"] <= len(pkept)
    assert psum["quality"]["baseline"] == precs[0]["baseline"]
    assert precs[-1]["sampled_total"] == len(pkept)
    # The window rows reached the run's metrics stream too.
    rows = [json.loads(ln) for ln in
            open(tmp_path / "p" / "metrics.jsonl").read().splitlines()]
    assert sum("recall_at_10" in r for r in rows) == len(pw)


def test_recall_drop_collapses_recall_in_both(ivf_2048, tmp_path):
    path, _, q = ivf_2048
    _, _, _, clean = _port_shadow_run(path, str(tmp_path / "c"), q)
    _, _, _, prec = _port_shadow_run(path, str(tmp_path / "p"), q, arm=True)
    _, _, jrec = _jax_shadow_run(path, str(tmp_path / "j"), q, arm=True)
    base = np.mean([w["recall_at_10"] for w in _windows(clean)])
    assert base > 0.5
    for pw, jw in zip(_windows(prec), _windows(jrec)):
        assert pw["recall_at_10"] < 0.5 * base
        assert abs(pw["recall_at_10"] - jw["recall_at_10"]) <= 1e-6


def test_recall_drop_needs_a_warmed_ivf_engine(ivf_2048):
    path, emb, _ = ivf_2048
    idx = load_index(path, device="cpu")
    engine = QueryEngine(idx, EngineConfig(top_k=5, buckets=(1,), probes=2))
    pfail.arm("serve.recall_drop", times=1)
    assert engine.query(emb[7:8])["rows"][0, 0] == 7  # unwarmed: kept
    engine.warmup()  # warm-up never consumes it either
    assert pfail.should_fire("serve.recall_drop")
    pfail.arm("serve.recall_drop", times=1)
    out = engine.query(emb[7:8])
    assert out["rows"][0, 0] != 7 and out["rows"].shape == (1, 5)
    assert engine.query(emb[7:8])["rows"][0, 0] == 7  # exhausted
    flat = QueryEngine(GalleryIndex.build(emb, np.zeros(2048), device="cpu"),
                       EngineConfig(top_k=5, buckets=(1,)))
    flat.warmup()
    pfail.arm("serve.recall_drop", times=1)
    assert flat.query(emb[7:8])["rows"][0, 0] == 7
    assert pfail.should_fire("serve.recall_drop")  # a flat engine leaves it


def _jsonl_answers(server, lines):
    out = io.StringIO()
    server.run_jsonl(io.StringIO(lines), out)
    return [json.loads(ln) for ln in out.getvalue().splitlines()]


def test_answers_byte_identical_with_shadow_and_qtrace(ivf_2048, tmp_path):
    path, _, q = ivf_2048
    lines = "".join(json.dumps(r) + "\n" for r in _records(q[:24]))
    # The same batching on both sides (one batch of 24 within the
    # deadline), so each row's arithmetic is the same.
    off, _ = cli.build_server(cli.build_parser().parse_args([
        "serve", "--index", path, "--index-kind", "ivf", "--probes", "2",
        "--device", "cpu", "--poll-s", "0.01", "--metrics-window", "0",
        "--deadline-ms", "2000"]))
    on, _ = cli.build_server(_port_serve_args(
        path, tmp_path / "tel", "--poll-s", "0.01", "--shadow-rate", "1",
        "--shadow-window", "4", "--qtrace"))
    a_off = _jsonl_answers(off, lines)
    a_on = _jsonl_answers(on, lines)
    on.shadow.close()
    on.telemetry.close()
    assert on.shadow.stats()["sampled"] == 24
    strip = lambda a: json.dumps({k: v for k, v in a.items()  # noqa: E731
                                  if not k.endswith("_age_s")})
    assert [strip(a) for a in a_on[:-1]] == [strip(a) for a in a_off[:-1]]
    assert len(a_on) == 25 and "quality" not in a_off[-1]
    assert a_on[-1]["quality"]["shadow_rate"] == 1.0
    assert a_on[-1]["qtrace"]["queries"] == 24


def test_oracle_follows_an_inplace_add():
    rng = np.random.default_rng(3)
    emb = _unit(rng, 32, 8)
    idx = GalleryIndex.build(emb, np.arange(32) % 4, normalize=False,
                             device="cpu")
    scorer = ShadowScorer(lambda: idx, ShadowConfig(
        rate=1.0, ks=(1,), window=1, oracle_batch=1)).start()
    scorer.offer(0, emb[0], np.array([0], np.int32), np.ones(1, np.float32))
    _wait_windows(scorer, 1)
    assert scorer.stats()["last"]["recall_at_1"] == 1.0
    new_row = _unit(rng, 1, 8)
    idx.add(new_row, np.array([9]), normalize=False)
    # The right answer for the new row is the new row (32): a stale
    # oracle would call it a miss.
    scorer.offer(1, new_row[0], np.array([32], np.int32),
                 np.ones(1, np.float32))
    _wait_windows(scorer, 2)
    scorer.close()
    assert scorer.stats()["last"]["recall_at_1"] == 1.0
    assert scorer.oracle_builds == 2


def test_offer_never_blocks_on_a_wedged_oracle():
    rng = np.random.default_rng(4)
    emb = _unit(rng, 64, 16)
    idx = GalleryIndex.build(emb, np.arange(64), device="cpu")
    wedge = threading.Event()
    scoring_threads = []
    scorer = ShadowScorer(lambda: idx, ShadowConfig(
        rate=1.0, ks=(1,), window=2, max_queue=2, oracle_batch=1))
    real = scorer._score_batch

    def wedged(batch):
        scoring_threads.append(threading.get_ident())
        wedge.wait(timeout=30.0)
        real(batch)

    scorer._score_batch = wedged
    scorer.start()
    rows = np.zeros(1, np.int32)
    t0 = time.perf_counter()
    for i in range(1000):
        scorer.offer(i, emb[0], rows, np.zeros(1, np.float32))
    assert time.perf_counter() - t0 < 2.0
    assert scorer.dropped > 900
    wedge.set()
    scorer.close()
    assert scoring_threads and threading.get_ident() not in scoring_threads
    recs = scorer.history
    assert preport.validate_quality_report(recs) is None
    assert recs[-1]["dropped"] == scorer.dropped


# -- prof --quality and the CLI's checks --------------------------------------


def test_prof_quality_prints_jax_text(ivf_2048, tmp_path):
    from npairloss_tpu.cli import main as jmain

    path, _, q = ivf_2048
    run = tmp_path / "run"
    _jax_shadow_run(path, str(run), q)
    outs = []
    for main in (jmain, cli.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["prof", "--quality", str(run)]) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert "committed baseline (probes 2, sample 128)" in outs[1]
    with open(run / "quality.jsonl", "a") as f:
        f.write(json.dumps(_config()) + "\n")  # a second config
    assert cli.main(["prof", "--quality", str(run)]) == 1
    assert cli.main(["prof", "--quality", str(tmp_path / "none")]) == 2


@pytest.mark.parametrize("extra", [
    ["--shadow-rate", "1.5", "--telemetry-dir", "tel"],
    ["--shadow-rate", "0.5"],
    ["--qtrace"],
], ids=["rate-range", "shadow-needs-telemetry", "qtrace-needs-telemetry"])
def test_serve_refuses_bad_observatory_flags(tmp_path, extra):
    args = cli.build_parser().parse_args(
        ["serve", "--index", str(tmp_path / "none.gidx"), "--device", "cpu",
         *extra])
    assert cli.build_server(args) == 2
