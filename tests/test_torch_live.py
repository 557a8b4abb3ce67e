"""The live observatory's copies in the port (``obs/live``: registry and
sink, SLOs, alerts, watchdogs, Prometheus text, the observatory, watch)
held against the JAX package's on the CPU, from seed-made numpy rows.

  * the same rows through both packages' ``RegistrySink`` give the same
    registry snapshot and the same ``prometheus_text``, byte for byte;
  * the same specs over those rows give the same SLO statuses at every
    tick, and the same ``npairloss-alerts-v1`` records;
  * ``load_slo_config`` refuses the same bad files, ``validate_alert_log``
    gives the same error for the same bad logs, ``default_watchdogs``
    gives the same specs;
  * ``watch_run_dir`` agrees with the in-process observatory on one run
    dir; the sink never changes a byte of ``metrics.jsonl``;
  * the exporter, the probes and the final tick, and what the live
    registry gets from the shadow scorer and the query tracer.
"""

import dataclasses
import json
import math
import urllib.error
import urllib.request

import numpy as np
import pytest

from npairloss_tpu.obs import live as J
from npairloss_tpu_torch.obs import live as P
from npairloss_tpu_torch.obs.live.registry import DEFAULT_BOUNDS

# -- seed-made row streams ----------------------------------------------------


def _serve_rows(seed, n=48, t0=1000.0, tenants=False):
    """Serve window rows with a latency burst in the middle, an event
    row (whose whole-run percentiles must never become samples) and,
    optionally, tenant-stamped rows."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        burst = n // 3 <= i < n // 2
        p99 = float(rng.uniform(300, 900) if burst else rng.uniform(5, 60))
        row = {"phase": "serve", "step": 4 * (i + 1),
               "wall_time": t0 + 0.5 * i, "qps": round(float(
                   rng.uniform(50, 500)), 1),
               "p50_ms": round(p99 / 3, 3), "p99_ms": round(p99, 3),
               "queue_depth": int(rng.integers(0, 300)),
               "batches": i + 1, "rejected": 0, "run_id": "r"}
        if i % 7 == 3:
            row["recall_at_10"] = round(float(rng.uniform(0.5, 1.0)), 4)
            row["shadow_score_gap"] = round(float(rng.uniform(0, 0.1)), 6)
        if tenants and i % 2:
            row["tenant"] = "acme" if i % 4 == 1 else "zed"
        rows.append(row)
    rows.append({"phase": "serve", "step": 4 * n, "wall_time": t0 + 0.5 * n,
                 "event": "serve_drain", "p99_ms": 5000.0, "answered": 4 * n})
    return rows


def _train_rows(seed, n=40, t0=2000.0, ranks=1):
    """Train rows with non-finite losses, health signals and (over
    several ranks) rank stamps, plus eval and perf rows."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        for r in range(ranks):
            loss = float(rng.uniform(0.05, 8.0))
            if i in (11, 12, 13, 25):
                loss = float("nan") if i % 2 else float("inf")
            row = {"phase": "train", "step": i + 1 - (r * (i // 10)),
                   "wall_time": t0 + 0.25 * i + 0.01 * r, "loss": loss,
                   "lr": 0.01, "emb_mag_mean": round(float(
                       rng.uniform(0.5, 2.0)), 4),
                   "emb_mag_max": round(float(rng.uniform(2.0, 4.0)), 4),
                   "an_threshold_mean": round(float(
                       rng.uniform(0.9, 1.0)), 4),
                   "ap_an_margin_mean": round(float(
                       rng.uniform(-0.1, 0.2)), 4),
                   "ok": True}
            if ranks > 1:
                row.update(process_index=r, process_count=ranks)
            rows.append(row)
        if i % 10 == 9:
            rows.append({"phase": "eval", "step": i + 1,
                         "wall_time": t0 + 0.25 * i + 0.1,
                         "retrieve_top1": round(float(rng.uniform()), 4)})
            rows.append({"phase": "perf", "step": i + 1,
                         "wall_time": t0 + 0.25 * i + 0.12,
                         "emb_per_sec": round(float(rng.uniform(50, 90)), 1)})
    rows.append({"phase": "train", "step": n, "wall_time": t0 + 0.25 * n,
                 "event": "rollback", "reason": "x"})
    return rows


STREAMS = {
    "serve": lambda s: _serve_rows(s),
    "serve_tenants": lambda s: _serve_rows(s, tenants=True),
    "train": lambda s: _train_rows(s),
    "train_ranks": lambda s: _train_rows(s, ranks=2),
    "mixed": lambda s: sorted(_serve_rows(s, t0=2000.0) + _train_rows(s + 1),
                              key=lambda r: r["wall_time"]),
}


def _specs(pkg):
    S = pkg.SLOSpec
    return [
        S(name="p99", metric="serve_p99_ms", op="<=", target=150.0,
          window_s=3.0, burn_threshold=0.5, min_samples=2,
          severity="critical"),
        S(name="p99_acme", metric='serve_p99_ms{tenant="acme"}', op="<=",
          target=150.0, window_s=4.0, burn_threshold=0.5),
        S(name="lat_hist", metric="serve_latency_ms", op="<=", target=250.0,
          window_s=2.0, burn_threshold=0.6, clear_threshold=0.1),
        S(name="recall", metric="serve_recall_at_10", op=">=", target=0.8,
          window_s=10.0),
        *pkg.default_watchdogs("train"),
        S(name="loss", metric="train_loss", op="<=", target=6.0,
          window_s=2.0, burn_threshold=0.4, min_samples=3,
          severity="info"),
        S(name="spread", metric="train_emb_mag_spread", op="<=", target=3.0,
          window_s=5.0),
    ]


def _replay(pkg, rows, tmp=None):
    """Feed rows through a fresh observatory, ticking at each row's wall
    time; returns (observatory, per-tick statuses, events)."""
    obs = pkg.LiveObservatory(_specs(pkg), out_dir=tmp)
    statuses, events = [], []
    for rec in rows:
        obs.sink.log(rec)
        events.extend(obs.tick(now=rec["wall_time"]))
        statuses.append(obs.evaluator.status_dict(rec["wall_time"]))
    obs.stop(final_tick=False)
    return obs, statuses, events


# -- the copies, key for key --------------------------------------------------


@pytest.mark.parametrize("stream", sorted(STREAMS))
@pytest.mark.parametrize("seed", [0, 3])
def test_registry_snapshot_and_prometheus_text_match_jax(stream, seed):
    rows = STREAMS[stream](seed)
    sinks = {"jax": J.RegistrySink(), "port": P.RegistrySink()}
    for rec in rows:
        before = json.dumps(rec, sort_keys=True)
        for sink in sinks.values():
            sink.log(rec)
        assert json.dumps(rec, sort_keys=True) == before  # never mutated
    snaps = {k: s.registry.snapshot() for k, s in sinks.items()}
    assert snaps["port"] == snaps["jax"]
    assert snaps["port"]  # the stream reached the registry
    texts = {k: (J if k == "jax" else P).prometheus_text(s.registry)
             for k, s in sinks.items()}
    assert texts["port"] == texts["jax"]
    names = sinks["port"].registry.names()
    for name in names:
        assert (sinks["port"].registry.samples_since(name, 0.0)
                == sinks["jax"].registry.samples_since(name, 0.0))


@pytest.mark.parametrize("stream", sorted(STREAMS))
@pytest.mark.parametrize("seed", [0, 3])
def test_slo_statuses_and_alert_records_match_jax(stream, seed, tmp_path):
    rows = STREAMS[stream](seed)
    out = {}
    for name, pkg in (("jax", J), ("port", P)):
        d = tmp_path / name
        obs, statuses, events = _replay(pkg, rows, str(d))
        log = pkg.load_alert_log(str(d / "alerts.jsonl"))
        assert pkg.validate_alert_log(log) is None
        assert log == events
        out[name] = (statuses, events, obs.health(), obs.alerts.active())
    assert out["port"] == out["jax"]
    # the streams are built to move alerts: the comparison is not vacuous
    if stream in ("serve", "train", "mixed"):
        assert out["port"][1]


def test_alert_engine_resumes_an_appended_log_as_jax(tmp_path):
    rows = _serve_rows(5)
    half = len(rows) // 3 + 4  # inside the burst: an alert is open
    logs = {}
    for name, pkg in (("jax", J), ("port", P)):
        d = tmp_path / name
        for part in (rows[:half], rows[half:]):
            obs = pkg.LiveObservatory(_specs(pkg), out_dir=str(d))
            for rec in part:
                obs.sink.log(rec)
                obs.tick(now=rec["wall_time"])
            obs.stop(final_tick=False)
        logs[name] = (d / "alerts.jsonl").read_text()
        assert pkg.validate_alert_log(
            pkg.load_alert_log(str(d / "alerts.jsonl"))) is None
    assert logs["port"] == logs["jax"]
    assert '"resolved"' in logs["port"]


def _good_alert(pkg):
    return {
        "schema": pkg.ALERTS_SCHEMA, "alert_id": "a-1", "slo": "a",
        "metric": "m", "severity": "critical", "state": "firing",
        "ts": 1.0, "fired_at": 1.0, "bad_fraction": 1.0, "samples": 3,
        "target": 5.0, "op": "<=", "message": "x",
    }


_BAD_LOGS = {
    "ok": lambda g: [g],
    "ok_resolved": lambda g: [g, {**g, "state": "resolved",
                                  "resolved_at": 2.0}],
    "schema": lambda g: [{**g, "schema": "npairloss-alerts-v0"}],
    "missing_key": lambda g: [{k: v for k, v in g.items()
                               if k != "message"}],
    "state": lambda g: [{**g, "state": "open"}],
    "severity": lambda g: [{**g, "severity": "fatal"}],
    "non_numeric": lambda g: [{**g, "ts": "1"}],
    "resolve_first": lambda g: [{**g, "state": "resolved",
                                 "resolved_at": 2.0}],
    "duplicate": lambda g: [g, dict(g)],
    "dedup": lambda g: [g, {**g, "alert_id": "a-2"}],
    "precedes": lambda g: [g, {**g, "state": "resolved",
                               "resolved_at": 0.5}],
    "no_resolved_at": lambda g: [g, {**g, "state": "resolved"}],
    "double_resolve": lambda g: [g] + [{**g, "state": "resolved",
                                        "resolved_at": 2.0}] * 2,
    "not_object": lambda g: [g, "x"],
    "bad_line": lambda g: [g, {"_bad_line": 3}],
}


@pytest.mark.parametrize("case", sorted(_BAD_LOGS))
def test_validate_alert_log_gives_jax_verdicts(case):
    verdicts = {name: pkg.validate_alert_log(_BAD_LOGS[case](
        _good_alert(pkg))) for name, pkg in (("jax", J), ("port", P))}
    assert verdicts["port"] == verdicts["jax"]
    assert (verdicts["port"] is None) == case.startswith("ok")
    if verdicts["port"] is None:
        recs = _BAD_LOGS[case](_good_alert(P))
        assert P.unresolved_alerts(recs) == J.unresolved_alerts(recs)


def test_load_alert_log_tolerates_only_a_torn_tail(tmp_path):
    p = tmp_path / "a.jsonl"
    good = json.dumps(_good_alert(P))
    for text in (good + "\n{\"torn", good + "\n{bad\n" + good + "\n"):
        p.write_text(text)
        assert P.load_alert_log(str(p)) == J.load_alert_log(str(p))


_SLO_CONFIGS = {
    "presets_and_override": ({"watchdogs": ["serve", "train"], "slos": [
        {"name": "serve_p99", "metric": "serve_p99_ms", "op": "<=",
         "target": 42.0, "window_s": 5.0},
        {"name": "mine", "metric": "x", "op": ">=", "target": 1.0}]}, None),
    "explicit_only": ({"slos": [
        {"name": "a", "metric": "m", "op": "<=", "target": 1.0,
         "clear_threshold": 0.1, "severity": "critical",
         "description": "d"}]}, None),
    "missing_keys": ({"slos": [{"name": "x"}]}, ValueError),
    "unknown_key": ({"slos": [{"name": "x", "metric": "m", "op": "<=",
                               "target": 1.0, "typo_key": 2}]}, ValueError),
    "unknown_top": ({"nope": []}, ValueError),
    "empty": ({}, ValueError),
    "unknown_with_presets": ({"watchdogs": ["serve"], "unknown": 1},
                             ValueError),
    "not_object": ([1, 2], ValueError),
    "slos_not_list": ({"slos": {"a": 1}}, ValueError),
    "entry_not_object": ({"slos": [1]}, ValueError),
    "watchdogs_not_list": ({"watchdogs": "serve"}, ValueError),
    "bad_kind": ({"watchdogs": ["pod"]}, ValueError),
    "bad_op": ({"slos": [{"name": "a", "metric": "m", "op": "<",
                          "target": 1.0}]}, ValueError),
    "bad_severity": ({"slos": [{"name": "a", "metric": "m", "op": "<=",
                                "target": 1.0, "severity": "page"}]},
                     ValueError),
    "bad_burn": ({"slos": [{"name": "a", "metric": "m", "op": "<=",
                            "target": 1.0, "burn_threshold": 1.5}]},
                 ValueError),
    "clear_above_burn": ({"slos": [{"name": "a", "metric": "m", "op": "<=",
                                    "target": 1.0, "burn_threshold": 0.5,
                                    "clear_threshold": 0.9}]}, ValueError),
    "bad_window": ({"slos": [{"name": "a", "metric": "m", "op": "<=",
                              "target": 1.0, "window_s": 0}]}, ValueError),
    "bad_min_samples": ({"slos": [{"name": "a", "metric": "m", "op": "<=",
                                   "target": 1.0, "min_samples": 0}]},
                        ValueError),
}


@pytest.mark.parametrize("case", sorted(_SLO_CONFIGS))
def test_load_slo_config_as_jax(case, tmp_path):
    body, err = _SLO_CONFIGS[case]
    path = tmp_path / "slo.json"
    path.write_text(json.dumps(body))
    if err is not None:
        for pkg in (J, P):
            with pytest.raises(err):
                pkg.load_slo_config(str(path))
        return
    specs = {name: [dataclasses.asdict(s) for s in
                    pkg.load_slo_config(str(path))]
             for name, pkg in (("jax", J), ("port", P))}
    assert specs["port"] == specs["jax"]
    toml = tmp_path / "slo.toml"
    toml.write_text("\n".join(
        ["[[slos]]\n" + "\n".join(f"{k} = {json.dumps(v)}"
                                  for k, v in e.items())
         for e in body["slos"]]))
    assert [dataclasses.asdict(s) for s in P.load_slo_config(str(toml))] \
        == [dataclasses.asdict(s) for s in J.load_slo_config(str(toml))]


@pytest.mark.parametrize("kind,kw", [
    ("serve", {}), ("serve", {"max_queue": 64}), ("train", {}),
    ("train", {"bench_floor": 100.0}), ("serve", {"max_queue": 1024})])
def test_default_watchdogs_match_jax(kind, kw):
    assert [dataclasses.asdict(s) for s in P.default_watchdogs(kind, **kw)] \
        == [dataclasses.asdict(s) for s in J.default_watchdogs(kind, **kw)]


def test_watchdog_presets_and_twins():
    with pytest.raises(ValueError):
        P.default_watchdogs("pod")
    from npairloss_tpu_torch.obs.live.alerts import ALERT_SEVERITIES, EVENT_KEYS
    from npairloss_tpu_torch.obs.live.slo import SEVERITIES

    assert ALERT_SEVERITIES == SEVERITIES
    assert EVENT_KEYS == J.alerts.EVENT_KEYS
    assert P.ALERTS_SCHEMA == J.ALERTS_SCHEMA
    assert P.__all__ == J.__all__
    assert DEFAULT_BOUNDS == J.registry.DEFAULT_BOUNDS


def test_bench_floor_reads_only_a_named_file(tmp_path):
    # No default file: the repo's committed bench headline is not the
    # card's, so nothing is read unless a path names one.
    assert P.bench_floor_emb_per_sec() is None
    assert P.bench_floor_emb_per_sec(margin=2.0) is None
    p = tmp_path / "last_good.json"
    p.write_text(json.dumps({"payload": {"value": 80.0}}))
    assert P.bench_floor_emb_per_sec(0.5, str(p)) == 40.0
    assert P.bench_floor_emb_per_sec(0.5, str(p)) == \
        J.bench_floor_emb_per_sec(0.5, str(p))
    for body in ("{", json.dumps({"payload": {"value": -1}}),
                 json.dumps({"payload": None})):
        p.write_text(body)
        assert P.bench_floor_emb_per_sec(0.5, str(p)) is None
    assert P.bench_floor_emb_per_sec(0.5, str(tmp_path / "none")) is None


def test_labeled_registry_and_label_errors_match_jax():
    regs = {"jax": J.MetricRegistry(), "port": P.MetricRegistry()}
    for name, reg in regs.items():
        view = reg.view(tenant="a", zone="z1")
        view.inc("rows", 2)
        view.set("p99_ms", 3.5, t=1.0)
        view.observe("lat", 12.0, t=1.0)
        reg.set("flat", 1.0, t=1.0)
    assert regs["port"].snapshot() == regs["jax"].snapshot()
    assert P.prometheus_text(regs["port"]) == J.prometheus_text(regs["jax"])
    for bad in ({"9x": "v"}, {"k": 'quo"te'}, {}):
        for pkg in (J, P):
            with pytest.raises(ValueError):
                pkg.MetricRegistry().view(**bad)


def test_registry_kind_collisions_are_loud():
    reg = P.MetricRegistry()
    reg.inc("c")
    reg.observe("h", 1.0, bounds=(1.0, 2.0))
    for bad in (lambda: reg.gauge("c"), lambda: reg.counter("h"),
                lambda: reg.histogram("h", bounds=(1.0, 3.0)),
                lambda: reg.counter("c").inc(-1),
                lambda: P.MetricRegistry().histogram("x", bounds=(2.0, 1.0))):
        with pytest.raises(ValueError):
            bad()


# -- watch against in-process -------------------------------------------------


@pytest.mark.parametrize("stream", ["serve", "train_ranks", "mixed"])
def test_watch_run_dir_agrees_with_the_in_process_observatory(stream,
                                                              tmp_path):
    rows = STREAMS[stream](1)
    run = tmp_path / "run"
    run.mkdir()
    # Split over the single-process stream and a rank stream, with a
    # torn tail: watch merges by wall_time and skips the tear.
    with open(run / "metrics.jsonl", "w") as f:
        for r in rows[::2]:
            f.write(json.dumps(r) + "\n")
    with open(run / "telemetry.r1.jsonl", "w") as f:
        for r in rows[1::2]:
            f.write(json.dumps(r) + "\n")
        f.write('{"torn')
    _, _, inproc = _replay(P, sorted(rows, key=lambda r: r["wall_time"]))
    summaries = {}
    for name, pkg in (("jax", J), ("port", P)):
        out = str(tmp_path / f"{name}.watch.jsonl")
        summaries[name] = pkg.watch_run_dir(str(run), _specs(pkg),
                                            out_path=out)
        events = pkg.load_alert_log(out)
        assert [(e["slo"], e["state"], e["ts"]) for e in events] == \
            [(e["slo"], e["state"], e["ts"]) for e in inproc]
        assert summaries[name]["alerts_log"] == out
        summaries[name].pop("alerts_log")
    assert summaries["port"] == summaries["jax"]
    # The tail without its newline is still being written: buffered,
    # never parsed, never counted.
    assert summaries["port"]["torn_lines"] == 0
    assert summaries["port"]["rows"] == len(rows)
    with pytest.raises(FileNotFoundError):
        P.watch_run_dir(str(tmp_path / "empty"), _specs(P))


def test_watch_follow_mode_tails_appended_rows(tmp_path):
    rows = _serve_rows(2)
    run = tmp_path / "run"
    run.mkdir()
    path = run / "metrics.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows[:10]))
    seen = []

    import threading

    def append():
        with open(path, "a") as f:
            for r in rows[10:]:
                f.write(json.dumps(r) + "\n")

    timer = threading.Timer(0.1, append)
    timer.start()
    try:
        summary = P.watch_run_dir(str(run), _specs(P), follow=True,
                                  poll_s=0.05, emit=seen.append,
                                  stop_after_s=0.6)
    finally:
        timer.join()
    assert summary["rows"] == len(rows)
    assert [(e["slo"], e["state"]) for e in seen] == \
        [(e["slo"], e["state"]) for e in _replay(P, rows)[2]]


def test_watch_reads_the_quality_log_beside_the_replay(tmp_path):
    from npairloss_tpu.obs.quality import report as jq

    run = tmp_path / "run"
    run.mkdir()
    (run / "metrics.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in _serve_rows(4)))
    recs = [
        {"schema": jq.QUALITY_SCHEMA, "kind": "config", "shadow_rate": 0.5,
         "seed": 0, "ks": [1, 10], "window": 2, "wall_time": 1000.0,
         "stale_after_s": 60.0, "recall_floor": 0.9,
         "floor_metric": "serve_recall_at_10"},
        {"schema": jq.QUALITY_SCHEMA, "kind": "window", "wall_time": 1001.0,
         "samples": 2, "sampled_total": 2, "recall_at_1": 0.5,
         "recall_at_10": 0.85, "score_gap_mean": 0.01,
         "score_gap_max": 0.02},
    ]
    (run / "quality.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in recs))
    out = {name: pkg.watch_run_dir(str(run), _specs(pkg),
                                   out_path=str(tmp_path / f"{name}.jsonl"))
           for name, pkg in (("jax", J), ("port", P))}
    assert out["port"]["quality"] == out["jax"]["quality"]
    assert out["port"]["quality"]["valid"] is True


def test_reconcile_remediation_matches_jax():
    events = [{"alert_id": "a-1", "slo": "a", "state": "firing"},
              {"alert_id": "a-1", "slo": "a", "state": "resolved"},
              {"alert_id": "b-2", "slo": "b", "state": "firing"},
              {"alert_id": "c-3", "slo": "c", "state": "firing"},
              {"alert_id": "c-3", "slo": "c", "state": "resolved"}]
    rem = [{"alert_id": "a-1", "slo": "a"},
           {"alert_id": "b-2", "slo": "b"},
           {"alert_id": "c-3", "slo": "c", "dry_run": True}]
    assert P.reconcile_remediation(rem, events) == \
        J.reconcile_remediation(rem, events)


# -- telemetry, exporter, observatory -----------------------------------------


def test_sink_keeps_metrics_jsonl_byte_identical(tmp_path, monkeypatch):
    from npairloss_tpu_torch.obs import run as obs_run

    rows = [("train", 1, {"loss": 1.25, "lr": 0.01}),
            ("train", 2, {"loss": float("nan"), "lr": 0.01}),
            ("serve", 0, {"qps": 10.0, "p99_ms": 3.25}),
            ("serve", 4, {"event": "serve_drain", "p99_ms": 9.0}),
            ("eval", 2, {"loss": 0.5})]
    monkeypatch.setattr(obs_run.time, "time", lambda: 1234.5)
    streams = {}
    for variant in ("plain", "with_sink"):
        d = tmp_path / variant
        extra = (P.RegistrySink(),) if variant == "with_sink" else ()
        tel = obs_run.RunTelemetry(str(d), run_id="fixed", trace=False,
                                   ring_capacity=3, extra_sinks=extra)
        for phase, step, metrics in rows:
            tel.log(phase, step, metrics)
        assert len(tel.ring.records()) == 3
        if extra:
            assert extra[0].registry.get("train_rows").value == 2
        tel.close()
        streams[variant] = (d / "metrics.jsonl").read_bytes()
    assert streams["plain"] == streams["with_sink"]
    assert len(streams["plain"].splitlines()) == len(rows)


def test_http_exporter_metrics_healthz_and_404():
    reg = P.MetricRegistry()
    reg.set("g", 1.25, t=1.0)
    reg.observe("h", 3.0, t=1.0)

    def boom():
        raise RuntimeError("no health")

    for health, want in ((lambda: {"ok": True}, {"ok": True}),
                         (boom, {"ok": False, "error": "no health"})):
        httpd = P.start_http_exporter(reg, 0, health_fn=health)
        try:
            base = f"http://127.0.0.1:{httpd.server_address[1]}"
            resp = urllib.request.urlopen(base + "/metrics", timeout=10)
            assert resp.headers["Content-Type"].startswith("text/plain")
            assert resp.read().decode() == P.prometheus_text(reg)
            assert json.loads(urllib.request.urlopen(
                base + "/healthz", timeout=10).read()) == want
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(base + "/nope", timeout=10)
            assert e.value.code == 404
        finally:
            httpd.shutdown()
            httpd.server_close()


def test_observatory_probes_listeners_and_final_tick(tmp_path):
    spec = P.SLOSpec(name="age", metric="age_s", op="<=", target=5.0,
                     window_s=60.0, severity="critical")
    obs = P.LiveObservatory([spec], out_dir=str(tmp_path))
    age = [0.0]
    seen = []
    obs.add_probe(lambda: obs.registry.set("age_s", age[0]))
    obs.add_probe(lambda: 1 / 0)  # a failing probe is logged, not fatal
    obs.add_listener(seen.append)
    obs.add_listener(lambda st: 1 / 0)
    assert obs.tick(now=1.0) == []
    assert obs.health()["alerts_active"] == 0
    assert obs.health()["slo"]["age"]["burning"] is False
    age[0] = 99.0
    obs.start(period_s=3600.0)
    obs.stop()  # the final tick lands the transition
    records = P.load_alert_log(str(tmp_path / "alerts.jsonl"))
    assert P.validate_alert_log(records) is None
    assert [r["state"] for r in records] == ["firing"]
    assert obs.health()["alerts_active"] == 1
    assert len(seen) == 2 and seen[-1][0].burning
    assert obs._thread is None


def test_observatory_ticker_thread_ticks_and_stops(tmp_path):
    spec = P.SLOSpec(name="g", metric="g", op="<=", target=1.0,
                     window_s=60.0)
    obs = P.LiveObservatory([spec], out_dir=str(tmp_path))
    ticks = []
    obs.add_probe(lambda: ticks.append(1))
    obs.add_probe(lambda: obs.registry.set("g", 2.0))
    obs.start(period_s=0.01)
    import time

    deadline = time.time() + 10
    while len(ticks) < 3 and time.time() < deadline:
        time.sleep(0.01)
    obs.stop()
    assert len(ticks) >= 3 and obs._thread is None
    recs = P.load_alert_log(str(tmp_path / "alerts.jsonl"))
    assert [r["state"] for r in recs] == ["firing"]


# -- what the live registry gets from the shadow scorer and the tracer -------


def test_query_tracer_histograms_match_jax():
    from npairloss_tpu.obs.qtrace import QTraceConfig as JCfg
    from npairloss_tpu.obs.qtrace import QueryTracer as JTracer
    from npairloss_tpu_torch.obs.qtrace import QTraceConfig, QueryTracer

    rng = np.random.default_rng(11)
    steps = [float(x) for x in rng.uniform(1e-4, 0.05, size=400)]
    out = {}
    for name, tracer_cls, cfg_cls, reg in (
            ("jax", JTracer, JCfg, J.MetricRegistry()),
            ("port", QueryTracer, QTraceConfig, P.MetricRegistry())):
        clock = iter(np.cumsum(steps).tolist())
        tracer = tracer_cls(cfg_cls(exemplars=4, slo_ms=20.0),
                            registry=reg, clock=lambda: next(clock),
                            wall=lambda: 1000.0)
        for q in range(40):
            qt = tracer.begin(q)
            tracer.admitted(qt)
            tracer.picked(qt)
            tracer.dispatch_begin([qt], replica="r0")
            tracer.dispatch_end([qt], score_us=400.0 + q, merge_us=100.0)
            tracer.finish(qt)
        out[name] = (reg.snapshot(), P.prometheus_text(reg))
    assert out["port"] == out["jax"]
    assert out["port"][0]["qtrace_total_ms"]["count"] == 40
    assert {k for k in out["port"][0] if k.startswith("qtrace_")} >= {
        "qtrace_total_ms", "qtrace_dispatch_ms"}


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_shadow_scorer_registry_mode_and_declared_floor(tmp_path):
    from npairloss_tpu.obs.quality import report as jq
    from npairloss_tpu_torch.obs.quality import report as pq
    from npairloss_tpu_torch.obs.quality.shadow import (
        ShadowConfig,
        ShadowScorer,
    )
    from npairloss_tpu_torch.serve.index import GalleryIndex

    rng = np.random.default_rng(5)
    emb = _unit(rng, 128, 16)
    index = GalleryIndex.build(emb, (np.arange(128) % 8).astype(np.int32),
                               normalize=False, device="cpu")
    reg = P.MetricRegistry()
    shadow = ShadowScorer(
        lambda: index, ShadowConfig(rate=1.0, ks=(1, 10), window=4),
        registry=reg, out_path=str(tmp_path / "quality.jsonl"),
        recall_floor=0.9, floor_metric="serve_recall_at_10").start()
    q = emb[:8]
    top = np.argsort(-(q @ emb.T), axis=1)[:, :10]
    for i in range(8):
        shadow.offer(i, q[i], top[i], (q[i] @ emb[top[i]].T))
    shadow.close()
    recs = pq.load_quality_report(str(tmp_path / "quality.jsonl"))
    assert pq.validate_quality_report(recs) is None
    assert jq.validate_quality_report(recs) is None
    assert recs[0]["recall_floor"] == 0.9
    assert recs[0]["floor_metric"] == "serve_recall_at_10"
    assert reg.get("serve_recall_at_10").value == 1.0
    assert len(reg.samples_since("serve_recall_at_10", 0.0)) == 2
    assert reg.get("serve_shadow_score_gap").value == 0.0
    assert math.isfinite(reg.get("serve_shadow_samples").value)
