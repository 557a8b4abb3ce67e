"""``serve``/``train --live-obs --slo-config --slo-tick``, ``train
--metrics-port``, ``GET /metrics`` and ``watch`` in the port's CLI,
held against the JAX CLI on the CPU (a port of the JAX package's live
smoke).

  * one 256 x 32 flat index (built by the JAX CLI, loaded by both);
  * a clean feed fires no alert; a feed with ``serve.latency`` armed for
    4 firings fires the critical p99 alert and resolves it, with the
    same ``(slo, state)`` sequence as the JAX CLI on the same feed, and
    ``watch`` over the run dir replays that sequence;
  * ``GET /metrics`` over ``--http`` carries the latency histogram, the
    query tracer's stage histograms and the shadow scorer's gauges,
    ``/healthz`` the SLO status; without ``--live-obs`` ``/metrics`` is
    a 404;
  * ``train --live-obs --metrics-port`` (synchronous and ``--pipeline``):
    the scrape shows the loss, ``alerts.jsonl`` validates, ``watch``
    replays its transitions; the train and serve refusals exit 2 in
    both CLIs.
"""

import contextlib
import io
import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from npairloss_tpu import cli as jax_cli
from npairloss_tpu.resilience import failpoints as jfail
from npairloss_tpu_torch import cli
from npairloss_tpu_torch.obs import live as P
from npairloss_tpu_torch.resilience import failpoints as pfail

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = ["train", "--solver", "examples/tiny_solver.prototxt", "--synthetic"]
P99_SLO = {"slos": [{
    "name": "p99", "metric": "serve_p99_ms", "op": "<=", "target": 150.0,
    "window_s": 1.0, "burn_threshold": 0.5, "min_samples": 1,
    "severity": "critical"}]}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.chdir(REPO)
    pfail.reset()
    jfail.reset()
    yield
    pfail.reset()
    jfail.reset()


@pytest.fixture(scope="module")
def gallery(tmp_path_factory):
    d = tmp_path_factory.mktemp("live")
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((256, 32)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    np.save(d / "g.emb.npy", emb)
    np.save(d / "g.labels.npy", (np.arange(256) % 16).astype(np.int32))
    with contextlib.redirect_stdout(io.StringIO()):
        assert jax_cli.main(["index", "--emb", str(d / "g.emb.npy"),
                             "--labels", str(d / "g.labels.npy"),
                             "--no-normalize", "--out",
                             str(d / "g.gidx")]) == 0
    (d / "slo.json").write_text(json.dumps(P99_SLO))
    return d, emb


class _Lines(io.TextIOBase):
    """A stdout that keeps the lines and signals the first one."""

    def __init__(self):
        self.lines = []
        self.first = threading.Event()
        self._buf = ""

    def write(self, s):
        self._buf += s
        *done, self._buf = self._buf.split("\n")
        self.lines.extend(done)
        if done:
            self.first.set()
        return len(s)


def _serve_feed(main, fail, gidx, slo, tel, emb, fault, extra=()):
    """``serve --live-obs`` in process over a stdin pipe: one query,
    then (once it is answered) ``serve.latency`` armed for 4 firings
    when ``fault``, 4 queries at once, then 16 queries 0.1 s apart,
    then EOF.  Returns the exit code and the answer lines."""
    r, w = os.pipe()
    out = _Lines()
    qs = [json.dumps({"id": i, "embedding": emb[i].tolist()}) + "\n"
          for i in range(21)]

    def feed():
        with os.fdopen(w, "w") as f:
            f.write(qs[0])
            f.flush()
            if not out.first.wait(120):
                return
            if fault:
                fail.arm("serve.latency", times=4)
            f.write("".join(qs[1:5]))
            f.flush()
            time.sleep(1.4)
            for q in qs[5:]:
                f.write(q)
                f.flush()
                time.sleep(0.1)

    th = threading.Thread(target=feed, daemon=True)
    stdin = os.fdopen(r, "r")
    th.start()
    try:
        with contextlib.redirect_stdout(out), \
                pytest.MonkeyPatch.context() as mp:
            mp.setattr("sys.stdin", stdin)
            rc = main(["serve", "--index", str(gidx), "--top-k", "3",
                       "--buckets", "1", "--deadline-ms", "1",
                       "--metrics-window", "2", "--poll-s", "0.01",
                       "--telemetry-dir", str(tel), "--live-obs",
                       "--slo-config", str(slo), "--slo-tick", "0.05",
                       *extra])
    finally:
        out.first.set()  # a server that failed early ends the feed too
        th.join(timeout=120)
        stdin.close()
    return rc, out.lines


def _states(path):
    recs = P.load_alert_log(str(path))
    assert P.validate_alert_log(recs) is None
    return [(r["slo"], r["state"]) for r in recs]


def test_serve_latency_feed_fires_and_resolves_as_the_jax_cli(gallery,
                                                              tmp_path):
    d, emb = gallery
    seqs = {}
    for name, main, fail, extra in (
            ("jax", jax_cli.main, jfail, ("--mesh", "1")),
            ("port", cli.main, pfail, ("--device", "cpu"))):
        tel = tmp_path / name
        rc, lines = _serve_feed(main, fail, d / "g.gidx", d / "slo.json",
                                tel, emb, fault=True, extra=extra)
        assert rc == 0
        assert json.loads(lines[-1])["event"] == "serve_drain"
        assert len(lines) == 22
        seqs[name] = _states(tel / "alerts.jsonl")
        # The offline feed replays the same lifecycle from the rows.
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main(["watch", str(tel), "--slo-config",
                             str(d / "slo.json")]) == 0
        summary = json.loads(buf.getvalue().splitlines()[-1])
        assert summary["alerts_active"] == 0
        assert _states(tel / "alerts.watch.jsonl") == seqs[name]
    assert seqs["port"] == seqs["jax"] == [("p99", "firing"),
                                           ("p99", "resolved")]
    fired = P.load_alert_log(str(tmp_path / "port" / "alerts.jsonl"))[0]
    assert fired["severity"] == "critical" and fired["bad_fraction"] >= 0.5
    man = json.load(open(tmp_path / "port" / "manifest.json"))
    assert man["config"]["live_obs"] is True
    assert man["config"]["slo_config"] == str(d / "slo.json")


def test_serve_clean_feed_fires_no_alert(gallery, tmp_path):
    d, emb = gallery
    tel = tmp_path / "clean"
    rc, lines = _serve_feed(cli.main, pfail, d / "g.gidx", d / "slo.json",
                            tel, emb, fault=False, extra=("--device", "cpu"))
    assert rc == 0 and len(lines) == 22
    assert (tel / "alerts.jsonl").read_text() == ""
    rows = [json.loads(ln) for ln in open(tel / "metrics.jsonl")]
    assert all(r["p99_ms"] < 150.0 for r in rows if "event" not in r)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(port, path):
    try:
        resp = urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                      timeout=30)
        return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/query",
                                 data=body.encode(), method="POST")
    return json.loads(urllib.request.urlopen(req, timeout=60).read())


def _http(server):
    res = {}
    th = threading.Thread(target=lambda: res.update(rc=server.run_http(0)),
                          daemon=True)
    th.start()
    deadline = time.monotonic() + 60
    while server.http_port is None and time.monotonic() < deadline:
        time.sleep(0.01)
    return th, res


@pytest.mark.parametrize("live", [True, False])
def test_metrics_over_http(gallery, tmp_path, live):
    d, emb = gallery
    tel = tmp_path / "tel"
    args = cli.build_parser().parse_args([
        "serve", "--index", str(d / "g.gidx"), "--top-k", "10",
        "--buckets", "1,8", "--device", "cpu", "--metrics-window", "4",
        "--telemetry-dir", str(tel), "--shadow-rate", "1.0",
        "--shadow-window", "4", "--qtrace", "--slo-tick", "0.05",
        *(["--live-obs"] if live else [])])
    server, wal = cli.build_server(args)
    assert (server.live is not None) == live
    # The armed serve_p99 watchdog's bar is qtrace's default SLO, and
    # the serve_recall_floor watchdog's floor is the scorer's.
    assert server.qtrace.cfg.slo_ms == 250.0
    assert server.shadow.recall_floor == (0.95 if live else None)
    th, res = _http(server)
    try:
        port = server.http_port
        body = "\n".join(json.dumps({"id": f"q{i}",
                                     "embedding": emb[i].tolist()})
                         for i in range(16))
        assert len(_post(port, body)) == 16
        deadline = time.monotonic() + 30
        while server.shadow.windows < 4 and time.monotonic() < deadline:
            time.sleep(0.02)
        time.sleep(0.2)  # a tick after the last window row
        code, text = _get(port, "/metrics")
        health = json.loads(_get(port, "/healthz")[1])
    finally:
        server.preempt.request()
        th.join(timeout=60)
        cli.close_observers(server)
    assert res.get("rc") == 75
    if not live:
        assert code == 404 and "live observatory not enabled" in text
        assert "slo" not in health
        assert not (tel / "alerts.jsonl").exists()
        return
    assert code == 200
    lines = text.splitlines()
    for family in ("serve_latency_ms", "qtrace_total_ms",
                   "qtrace_dispatch_ms", "qtrace_queue_wait_ms"):
        assert f"# TYPE npairloss_{family} histogram" in lines
        assert any(ln.startswith(f'npairloss_{family}_bucket{{le="+Inf"}}')
                   for ln in lines)
    for gauge in ("serve_recall_at_10", "serve_shadow_score_gap",
                  "serve_shadow_samples", "serve_p99_ms", "serve_index_age_s"):
        assert any(ln.startswith(f"npairloss_{gauge} ") for ln in lines), \
            gauge
    assert "npairloss_serve_rows_total" in text
    assert health["ok"] is True and "alerts_active" in health
    assert set(health["slo"]) == {s.name for s in P.default_watchdogs(
        "serve", max_queue=args.max_queue)}
    assert P.validate_alert_log(P.load_alert_log(
        str(tel / "alerts.jsonl"))) is None
    recs = [json.loads(ln) for ln in open(tel / "quality.jsonl")]
    assert recs[0]["recall_floor"] == 0.95
    assert recs[0]["floor_metric"] == "serve_recall_at_10"


def test_qtrace_bar_comes_from_the_armed_p99_slo(gallery, tmp_path):
    d, _ = gallery
    slo = tmp_path / "slo.json"
    slo.write_text(json.dumps({"watchdogs": ["serve"], "slos": [
        {"name": "serve_p99", "metric": "serve_p99_ms", "op": "<=",
         "target": 80.0},
        {"name": "r5", "metric": "serve_recall_at_5", "op": ">=",
         "target": 0.5}]}))
    args = cli.build_parser().parse_args([
        "serve", "--index", str(d / "g.gidx"), "--top-k", "3",
        "--buckets", "1", "--device", "cpu", "--telemetry-dir",
        str(tmp_path / "tel"), "--live-obs", "--slo-config", str(slo),
        "--shadow-rate", "0.5", "--qtrace"])
    server, _ = cli.build_server(args)
    try:
        assert server.qtrace.cfg.slo_ms == 80.0
        # recall@10 and @5 are never sampled at --top-k 3: no floor.
        assert server.shadow.recall_floor is None
    finally:
        server.replicaset.close(drain=True)
        cli.close_observers(server)


def _actions(parser, cmd):
    sub = next(a for a in parser._actions
               if a.__class__.__name__ == "_SubParsersAction")
    return {a.dest: a for a in sub.choices[cmd]._actions}


@pytest.fixture(scope="module")
def jax_parser():
    import argparse

    got = {}

    class Taken(Exception):
        pass

    def take(self, *a, **kw):
        got["parser"] = self
        raise Taken

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", take)
        with pytest.raises(Taken):
            jax_cli.main(["watch"])
    return got["parser"]


LIVE_FLAGS = ([("serve", d) for d in ("live_obs", "slo_config", "slo_tick")]
              + [("train", d) for d in ("live_obs", "slo_config", "slo_tick",
                                        "metrics_port")]
              + [("watch", d) for d in ("run_dir", "slo_config", "watchdogs",
                                        "follow", "poll_s", "for_s", "out")])


@pytest.mark.parametrize("cmd,dest", LIVE_FLAGS,
                         ids=[f"{c}-{d}" for c, d in LIVE_FLAGS])
def test_live_flags_match_the_jax_cli(cmd, dest, jax_parser):
    mine = _actions(cli.build_parser(), cmd)[dest]
    theirs = _actions(jax_parser, cmd)[dest]
    assert mine.option_strings == theirs.option_strings
    assert mine.default == theirs.default
    assert mine.choices == theirs.choices
    assert mine.type == theirs.type
    assert mine.nargs == theirs.nargs


@pytest.mark.parametrize("argv", [
    ["--live-obs"],
    ["--live-obs", "--slo-config", "missing.json"],
])
def test_serve_live_obs_refusals(gallery, tmp_path, argv):
    d, _ = gallery
    extra = (["--telemetry-dir", str(tmp_path / "t")]
             if "--slo-config" in argv else [])
    assert cli.main(["serve", "--index", str(d / "g.gidx"), "--device",
                     "cpu", *argv, *extra]) == 2


@pytest.mark.parametrize("argv", [
    ["--live-obs"],                       # no --telemetry-dir
    ["--metrics-port", "9"],              # no --live-obs
])
def test_train_refusals_as_the_jax_cli(argv, tmp_path):
    rcs = {}
    for name, main, extra in (("jax", jax_cli.main, ["--mesh", "1"]),
                              ("port", cli.main, ["--device", "cpu"])):
        with contextlib.redirect_stdout(io.StringIO()):
            rcs[name] = main(TRAIN + argv + extra)
    assert rcs == {"jax": 2, "port": 2}


@pytest.mark.parametrize("pipeline", [False, True])
def test_train_live_obs_scrape_alerts_and_watch(tmp_path, monkeypatch,
                                                pipeline):
    slo = tmp_path / "slo.json"
    # A loss bar every step misses: the alert fires and stays open.
    slo.write_text(json.dumps({"watchdogs": ["train"], "slos": [
        {"name": "loss_bar", "metric": "train_loss", "op": "<=",
         "target": -1.0, "window_s": 60.0, "severity": "warning"}]}))
    port = _free_port()
    scraped = {}
    real = P.start_http_exporter

    def exporter(*a, **kw):
        httpd = real(*a, **kw)
        stop = httpd.shutdown

        def shutdown():
            # The last scrape of the run, before the exporter goes.
            scraped["metrics"] = _get(port, "/metrics")
            scraped["health"] = _get(port, "/healthz")
            stop()

        httpd.shutdown = shutdown
        return httpd

    monkeypatch.setattr(P, "start_http_exporter", exporter)
    tel = tmp_path / "tel"
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(TRAIN + ["--device", "cpu", "--telemetry-dir",
                               str(tel), "--live-obs", "--slo-config",
                               str(slo), "--slo-tick", "0.05",
                               "--metrics-port", str(port),
                               *(["--pipeline"] if pipeline else [])])
    assert rc == 0
    code, text = scraped["metrics"]
    assert code == 200
    assert any(ln.startswith("npairloss_train_loss ")
               for ln in text.splitlines())
    assert 'npairloss_train_loss_hist_bucket{le="+Inf"} 10' in text
    health = json.loads(scraped["health"][1])
    assert health["ok"] is True and health["alerts_active"] == 1
    with pytest.raises(OSError):  # the exporter is closed
        urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                               timeout=5)
    states = _states(tel / "alerts.jsonl")
    assert ("loss_bar", "firing") in states
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        assert cli.main(["watch", str(tel), "--slo-config", str(slo)]) == 0
    assert _states(tel / "alerts.watch.jsonl") == states
    summary = json.loads(buf.getvalue().splitlines()[-1])
    assert summary["rows"] == 12 and "loss_bar" in summary["active"]


def test_watch_refusals_and_critical_exit(tmp_path):
    assert cli.main(["watch", str(tmp_path)]) == 2  # no stream
    assert cli.main(["watch", str(tmp_path), "--watchdogs", ","]) == 2
    assert cli.main(["watch", str(tmp_path), "--watchdogs", "pod"]) == 2
    (tmp_path / "metrics.jsonl").write_text("".join(
        json.dumps({"phase": "serve", "step": i, "wall_time": 10.0 + i,
                    "p99_ms": 900.0}) + "\n" for i in range(3)))
    slo = tmp_path / "slo.json"
    slo.write_text(json.dumps(P99_SLO))
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        assert cli.main(["watch", str(tmp_path), "--slo-config",
                         str(slo)]) == 1  # a critical alert still active
    lines = buf.getvalue().splitlines()
    assert json.loads(lines[0])["state"] == "firing"
    assert json.loads(lines[-1])["alerts_active"] == 1
    with contextlib.redirect_stdout(io.StringIO()):
        # The train presets never see a serve metric: all ok.
        assert cli.main(["watch", str(tmp_path), "--watchdogs",
                         "train"]) == 0


def test_serve_probe_publishes_ingest_and_freshness_gauges(tmp_path):
    from npairloss_tpu_torch.serve.index import GalleryIndex

    rng = np.random.default_rng(3)
    base = rng.normal(size=(32, 16)).astype(np.float32)
    idx_dir = tmp_path / "idx"
    idx_dir.mkdir()
    GalleryIndex.build(base, np.arange(32, dtype=np.int32) % 4,
                       device="cpu").save(str(idx_dir / "g_0000.gidx"))
    args = cli.build_parser().parse_args([
        "serve", "--index-prefix", str(idx_dir / "g_"), "--wal-dir",
        str(tmp_path / "wal"), "--top-k", "5", "--buckets", "1,8",
        "--device", "cpu", "--telemetry-dir", str(tmp_path / "tel"),
        "--live-obs", "--slo-tick", "3600"])
    server, wal = cli.build_server(args)
    rec = {"id": "i0", "ingest": {
        "ids": [900, 901], "labels": [1, 1],
        "embeddings": rng.normal(size=(2, 16)).astype(np.float32).tolist()}}
    out = io.StringIO()
    try:
        assert server.run_jsonl(io.StringIO(json.dumps(rec) + "\n"),
                                out) == 0
        assert json.loads(out.getvalue().splitlines()[0])["ingested"]
        server.live.tick()
        reg = server.live.registry
        assert reg.get("serve_ingest_watermark").value == 1.0
        assert reg.get("serve_wal_durable_seq").value == 1.0
        assert reg.get("serve_wal_torn_records").value == 0.0
        assert reg.get("serve_index_age_s").value >= 0.0
        assert reg.get("serve_model_age_s") is None  # no model: absent
    finally:
        wal.close()
        cli.close_observers(server)
    assert _states(tmp_path / "tel" / "alerts.jsonl") == []
