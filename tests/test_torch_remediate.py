"""``resilience/remediate.py``, the re-warm action with the post-warmup
compile count, and ``serve``/``train --remediate`` in the port, held
against the JAX package on the CPU.

  * the same scripted alert sequences (fire, resolve, refire past the
    cooldown, a raising action, a dry run, budget exhaustion, a resumed
    id sequence) through both ``RemediationEngine``s give the same audit
    records once ``ts`` is stripped, and the same action calls;
  * both validators (and the unresolved/abandoned helpers) agree on the
    same good and bad logs; the policy tables and loaders agree;
  * a tiny server of each package, built from one gallery, counts the
    same ``compiles_after_warmup`` under ``serve.compile_storm``, with
    and without telemetry, and carries the same window-row key before
    and after ``rewarm``; a re-warm that raises keeps the evidence;
  * the live observatory ticks the engine, ``watch`` reconciles an
    audit log, and the summary and ``/healthz`` carry ``remediation``;
  * the serve and train CLIs refuse the same remediation arguments with
    the same exit codes, and a CPU ``train --remediate`` under
    ``train.collapse`` rolls back to the same iteration as the JAX CLI.
"""

import contextlib
import io
import json
import logging
import os

import numpy as np
import pytest

from npairloss_tpu import cli as jax_cli
from npairloss_tpu.resilience import failpoints as jfail
from npairloss_tpu.resilience import remediate as J
from npairloss_tpu_torch import cli
from npairloss_tpu_torch.resilience import failpoints as pfail
from npairloss_tpu_torch.resilience import remediate as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = ["train", "--solver", "examples/tiny_solver.prototxt", "--synthetic"]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.chdir(REPO)
    pfail.reset()
    jfail.reset()
    yield
    pfail.reset()
    jfail.reset()


def _alert(aid, severity="critical", fired_at=0.0):
    return {"alert_id": aid, "severity": severity, "fired_at": fired_at,
            "bad_fraction": 1.0}


def _pol(mod, **kw):
    return mod.RemediationPolicy(**{"name": "p", "slo": "s", "action": "a",
                                    "cooldown_s": 5.0, "max_attempts": 2,
                                    **kw})


def _boom(alert):
    raise RuntimeError("no newer snapshot")


# Each script: (policy overrides, action kind, dry_run, [(now, active)]).
# ``active`` maps an SLO to an alert id (None: nothing firing).
SCRIPTS = {
    "fire_resolve_undo": ({}, "undo", False,
                          [(10.0, "s-1"), (11.0, None)]),
    "refire_past_cooldown_and_fresh_incident": (
        {}, "plain", False,
        [(10.0, "s-1"), (12.0, "s-1"), (16.0, "s-1"), (22.0, "s-1"),
         (40.0, "s-1"), (50.0, "s-2")]),
    "cooldown_across_incidents": (
        {}, "plain", False,
        [(10.0, "s-1"), (11.0, None), (13.0, "s-2"), (16.0, "s-2")]),
    "raising_action": ({}, "raise", False, [(10.0, "s-1"), (20.0, None)]),
    "dry_run": ({}, "plain", True,
                [(10.0, "s-1"), (16.0, "s-1"), (22.0, "s-1"),
                 (30.0, None)]),
    "budget_exhausted_undo_survives": (
        {"cooldown_s": 2.0, "max_attempts": 1}, "undo", False,
        [(10.0, "s-1"), (13.0, "s-1"), (16.0, "s-1"), (20.0, None)]),
}


def _run_script(mod, name, log_path):
    over, kind, dry, steps = SCRIPTS[name]
    calls = []
    if kind == "undo":
        action = (lambda a: calls.append(("do", a)) or {"k": 1},
                  lambda a: calls.append(("undo", a)))
    elif kind == "raise":
        action = _boom
    else:
        action = lambda a: calls.append(("do", a))  # noqa: E731
    eng = mod.RemediationEngine([_pol(mod, **over)], {"a": action},
                                log_path=log_path, dry_run=dry,
                                clock=lambda: 0.0)
    events = []
    for now, aid in steps:
        active = {"s": _alert(aid)} if aid else {}
        events.append([e["state"] for e in eng.tick(active, now)])
    last = eng.last_by_policy()
    eng.close()
    return events, calls, last, mod.load_remediation_log(log_path)


def _strip(records):
    return [{k: v for k, v in r.items() if k != "ts"} for r in records]


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_scripted_alerts_give_jax_audit_records(name, tmp_path):
    got = _run_script(P, name, str(tmp_path / "port.jsonl"))
    want = _run_script(J, name, str(tmp_path / "jax.jsonl"))
    assert got[0] == want[0]          # states per tick
    assert got[1] == want[1]          # the action (and undo) calls
    assert got[2] == want[2]          # last_by_policy
    assert _strip(got[3]) == _strip(want[3]) and got[3]
    assert P.validate_remediation_log(got[3]) is None
    assert J.validate_remediation_log(got[3]) is None


def test_resumed_id_sequence_matches_jax(tmp_path):
    ids = {}
    for name, mod in (("port", P), ("jax", J)):
        path = str(tmp_path / f"{name}.jsonl")
        for now, aid in ((10.0, "s-1"), (100.0, "s-9")):
            eng = mod.RemediationEngine([_pol(mod)], {"a": lambda a: None},
                                        log_path=path, clock=lambda: 0.0)
            eng.tick({"s": _alert(aid)}, now)
            eng.tick({}, now + 1.0)
            eng.close()
        recs = mod.load_remediation_log(path)
        assert P.validate_remediation_log(recs) is None
        ids[name] = [r["id"] for r in recs]
    assert ids["port"] == ids["jax"] == ["p-1", "p-1", "p-2", "p-2"]


def test_contract_constants_and_policy_tables_match_jax(tmp_path):
    assert P.REMEDIATION_SCHEMA == J.REMEDIATION_SCHEMA
    assert P.EVENT_KEYS == J.EVENT_KEYS
    assert P.REMEDIATION_STATES == J.REMEDIATION_STATES
    assert P.REMEDIATION_SEVERITIES == J.REMEDIATION_SEVERITIES
    from npairloss_tpu_torch.obs.live.alerts import ALERT_SEVERITIES

    assert P.REMEDIATION_SEVERITIES == ALERT_SEVERITIES
    import dataclasses

    for kind in ("serve", "train"):
        assert ([dataclasses.asdict(p) for p in P.default_policies(kind)]
                == [dataclasses.asdict(p) for p in J.default_policies(kind)])
    cfg = tmp_path / "r.json"
    cfg.write_text(json.dumps({"policies": [
        {"name": "x", "slo": "s", "action": "a", "cooldown_s": 1}]}))
    assert (dataclasses.asdict(P.load_policies(str(cfg))[0])
            == dataclasses.asdict(J.load_policies(str(cfg))[0]))


@pytest.mark.parametrize("raw", [
    [], {"policies": []}, {"policies": [{"name": "x", "typo": 1}]},
    {"policies": [{"name": "x", "slo": "s"}]}, {"extra": 1},
    {"policies": [{"name": "x", "slo": "s", "action": "a",
                   "max_attempts": 0}]},
    {"policies": [{"name": "x", "slo": "s", "action": "a"},
                  {"name": "x", "slo": "t", "action": "a"}]},
], ids=["list", "empty", "typo", "missing", "toplevel", "budget", "dup"])
def test_load_policies_refuses_as_jax(raw, tmp_path):
    cfg = tmp_path / "r.json"
    cfg.write_text(json.dumps(raw))
    errs = []
    for mod in (P, J):
        with pytest.raises(ValueError) as e:
            mod.load_policies(str(cfg))
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def _valid_pair(aid="s-1", dry=False):
    base = {"schema": J.REMEDIATION_SCHEMA, "policy": "p", "action": "a",
            "alert_id": aid, "slo": "s", "severity": "critical",
            "attempt": 1, "max_attempts": 2, "dry_run": dry, "message": "m"}
    att = {**base, "id": "p-1", "state": "attempted", "ts": 10.0}
    ok = {**base, "id": "p-1", "state": "succeeded", "ts": 11.0,
          "dry_run": False, "duration_s": 1.0}
    return att, ok


def _logs():
    att, ok = _valid_pair()
    failed = dict(ok, state="failed", error="x")

    def mut(i, **kw):
        recs = [dict(att), dict(ok)]
        recs[i].update(kw)
        return recs

    dropped = [dict(att), dict(ok)]
    dropped[0].pop("attempt")
    return {
        "good": [att, ok], "empty": [], "schema": mut(0, schema="v0"),
        "missing": dropped, "state": mut(0, state="skipped"),
        "severity": mut(0, severity="fatal"), "ts": mut(0, ts="now"),
        "attempt_float": mut(0, attempt=1.5), "outside": mut(0, attempt=3),
        "no_attempted": [ok], "dup_attempted": [att, att],
        "second_outcome": [att, ok, ok], "precedes": mut(1, ts=9.0),
        "no_error": [att, dict(ok, state="failed")],
        "failed_ok": [att, failed],
        "dry_outcome": [dict(att, dry_run=True), ok],
        "bad_line": [{"_bad_line": 3}, att], "not_object": [1],
        "unresolved": [att], "later_attempt": [att, failed,
                                               dict(att, id="p-2",
                                                    attempt=2)],
    }


ALERT_LOGS = {
    "none": None, "fired": [{"state": "firing", "alert_id": "s-1",
                             "ts": 5.0}],
    "never": [], "late": [{"state": "firing", "alert_id": "s-1",
                           "ts": 50.0}],
}


@pytest.mark.parametrize("alerts", sorted(ALERT_LOGS))
@pytest.mark.parametrize("log", sorted(_logs()))
def test_validators_agree_with_jax(log, alerts):
    recs = _logs()[log]
    arecs = ALERT_LOGS[alerts]
    got = P.validate_remediation_log(recs, alert_records=arecs)
    assert got == J.validate_remediation_log(recs, alert_records=arecs)
    if got is None:
        assert (P.unresolved_remediations(recs)
                == J.unresolved_remediations(recs))
        for resolved in (None, ["s-1"]):
            assert (P.abandoned_remediations(recs, resolved)
                    == J.abandoned_remediations(recs, resolved))


def test_torn_tail_loads_as_jax(tmp_path):
    att, ok = _valid_pair()
    path = tmp_path / "remediation.jsonl"
    path.write_text(json.dumps(att) + "\n" + "{torn\n" + json.dumps(ok)
                    + "\n" + '{"schema": "npairloss-rem')
    got = P.load_remediation_log(str(path))
    assert got == J.load_remediation_log(str(path))
    assert got[1] == {"_bad_line": 2} and len(got) == 3


def test_engine_refusals_match_jax():
    for make in (lambda m: m.RemediationEngine([_pol(m)], {}),
                 lambda m: m.RemediationEngine([_pol(m), _pol(m)],
                                               {"a": lambda a: None})):
        errs = []
        for mod in (P, J):
            with pytest.raises(ValueError) as e:
                make(mod)
            errs.append(str(e.value))
        assert errs[0] == errs[1]


def test_live_observatory_ticks_the_engine_as_jax(tmp_path):
    from npairloss_tpu.obs.live import LiveObservatory as JLive
    from npairloss_tpu.obs.live import SLOSpec as JSpec
    from npairloss_tpu_torch.obs.live import LiveObservatory as PLive
    from npairloss_tpu_torch.obs.live import SLOSpec as PSpec
    from npairloss_tpu_torch.obs.live.alerts import load_alert_log

    out = {}
    for name, mod, live_cls, spec_cls in (("port", P, PLive, PSpec),
                                          ("jax", J, JLive, JSpec)):
        d = tmp_path / name
        spec = spec_cls(name="s", metric="m", op="<=", target=1.0,
                        window_s=10.0, burn_threshold=0.5, min_samples=1,
                        severity="critical")
        live = live_cls([spec], out_dir=str(d), clock=lambda: 0.0)
        acted = []
        eng = mod.RemediationEngine(
            [mod.RemediationPolicy(name="fix", slo="s", action="f",
                                   cooldown_s=5.0, max_attempts=3)],
            {"f": lambda a, acted=acted: acted.append(a["alert_id"])},
            log_path=str(d / "remediation.jsonl"), clock=lambda: 0.0)
        live.set_remediation(eng)
        live.registry.set("m", 9.0, t=10.0)
        live.tick(now=10.0)
        live.registry.set("m", 0.5, t=15.0)
        live.tick(now=21.0)
        live.stop(final_tick=False)  # closes the audit log too
        assert eng._f.closed
        arecs = load_alert_log(str(d / "alerts.jsonl"))
        rrecs = P.load_remediation_log(str(d / "remediation.jsonl"))
        assert P.validate_remediation_log(rrecs, alert_records=arecs) is None
        out[name] = (acted, _strip(rrecs))
    assert out["port"] == out["jax"]
    assert [r["state"] for r in out["port"][1]] == ["attempted", "succeeded"]


def test_watch_reconciles_the_audit_log_as_jax(tmp_path):
    from npairloss_tpu.obs.live import SLOSpec as JSpec
    from npairloss_tpu.obs.live import watch_run_dir as jwatch
    from npairloss_tpu_torch.obs.live import SLOSpec as PSpec
    from npairloss_tpu_torch.obs.live import watch_run_dir as pwatch

    rows = [{"phase": "serve", "step": t, "wall_time": float(t),
             "p99_ms": v}
            for t, v in [(0, 500.0), (1, 500.0), (2, 500.0), (20, 10.0),
                         (21, 10.0), (35, 500.0), (36, 500.0), (37, 500.0),
                         (55, 10.0), (56, 10.0)]]
    att, _ = _valid_pair(aid="p99-1")
    att = dict(att, slo="p99")
    ghost = dict(_valid_pair(aid="p99-77")[0], id="p-9", slo="p99")
    blocks = {}
    for name, watch, spec_cls in (("port", pwatch, PSpec),
                                  ("jax", jwatch, JSpec)):
        run = tmp_path / name
        run.mkdir()
        (run / "metrics.jsonl").write_text(
            "".join(json.dumps(r) + "\n" for r in rows))
        spec = spec_cls(name="p99", metric="serve_p99_ms", op="<=",
                        target=150.0, window_s=10.0, burn_threshold=0.5,
                        min_samples=1, severity="critical")
        (run / "remediation.jsonl").write_text(
            json.dumps(att) + "\n" + json.dumps(ghost) + "\n")
        first = watch(str(run), [spec])["remediation"]
        os.remove(run / "alerts.watch.jsonl")
        (run / "remediation.jsonl").write_text(
            json.dumps(dict(att, id="p-2", dry_run=True)) + "\n")
        dry = watch(str(run), [spec])["remediation"]
        os.remove(run / "remediation.jsonl")
        absent = "remediation" not in watch(str(run), [spec])
        blocks[name] = ({k: v for k, v in first.items() if k != "log"},
                        {k: v for k, v in dry.items() if k != "log"},
                        absent)
    assert blocks["port"] == blocks["jax"]
    first, dry, absent = blocks["port"]
    assert first["matched"] == ["p99-1"] and absent
    assert first["action_no_resolution"] == ["p99-77"]
    assert sorted(dry["alert_resolved_no_action"]) == ["p99-1", "p99-2"]


# -- the post-warmup compile count and the re-warm ----------------------------


class _FakeTel:
    """Just enough of RunTelemetry for window-row capture (both
    packages' servers take it)."""

    metrics_enabled = True
    tracer = None

    def __init__(self):
        self.rows = []

    def span(self, name, **args):
        return contextlib.nullcontext()

    def instant(self, name, **args):
        pass

    def log(self, phase, step, row):
        self.rows.append(dict(row))

    def flush(self):
        pass


def _gallery():
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((32, 8)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    return emb, (np.arange(32) % 4).astype(np.int32)


def _jax_server(window, telemetry):
    from npairloss_tpu.serve import (
        BatcherConfig,
        EngineConfig,
        GalleryIndex,
        QueryEngine,
        RetrievalServer,
        ServerConfig,
    )

    emb, lab = _gallery()
    engine = QueryEngine(GalleryIndex.build(emb, lab, normalize=False),
                         EngineConfig(top_k=3, buckets=(1, 4)))
    engine.warmup()
    server = RetrievalServer(engine, BatcherConfig(max_batch=4,
                                                   max_delay_ms=1.0),
                             ServerConfig(metrics_window=window),
                             telemetry=telemetry)
    server.replicaset.start()
    return server


def _port_server(window, telemetry, replicas=1):
    from npairloss_tpu_torch.serve.batcher import BatcherConfig
    from npairloss_tpu_torch.serve.engine import EngineConfig, QueryEngine
    from npairloss_tpu_torch.serve.index import GalleryIndex
    from npairloss_tpu_torch.serve.server import RetrievalServer, ServerConfig

    emb, lab = _gallery()
    index = GalleryIndex.build(emb, lab, normalize=False, device="cpu")
    cfg = EngineConfig(top_k=3, buckets=(1, 4))
    engine = QueryEngine(index, cfg)
    engine.warmup()
    engines = [engine] + [QueryEngine(index, cfg, share_compiled_with=engine)
                          for _ in range(replicas - 1)]
    server = RetrievalServer(engines, BatcherConfig(max_batch=4,
                                                    max_delay_ms=1.0),
                             ServerConfig(metrics_window=window),
                             telemetry=telemetry)
    server.replicaset.start()
    return server


def _storm_sequence(server, fail, tel):
    """JAX's ``test_compile_storm_and_rewarm_reset`` sequence; returns
    the counts and the rows' ``compiles_after_warmup`` at each stage."""
    emb, _ = _gallery()
    ask = (server.handle if hasattr(server, "handle")
           else lambda r: server.handle_many([r])[0])
    seen = []

    def note():
        seen.append((server.engine.compiles_after_warmup,
                     [r.get("compiles_after_warmup")
                      for r in (tel.rows if tel is not None else [])]))

    try:
        note()
        fail.arm("serve.compile_storm", times=2)
        for i in range(4):
            assert "neighbors" in ask({"id": i, "embedding": emb[i].tolist()})
        note()
        assert server.rewarm()["warmup_s"] >= 0.0
        assert server.engine.warmed
        note()
        for i in range(4):
            ask({"id": i, "embedding": emb[i].tolist()})
        note()
        fail.arm("serve.compile_storm", times=1)
        ask({"id": 9, "embedding": emb[9].tolist()})
        note()
    finally:
        server.replicaset.close(drain=True)
    return seen, server.engine.compiles_total


@pytest.mark.parametrize("telemetry", [True, False])
def test_compile_storm_and_rewarm_count_as_jax(telemetry):
    ptel = _FakeTel() if telemetry else None
    jtel = _FakeTel() if telemetry else None
    got = _storm_sequence(_port_server(2, ptel), pfail, ptel)
    want = _storm_sequence(_jax_server(2, jtel), jfail, jtel)
    assert got == want
    counts = [c for c, _ in got[0]]
    assert counts == [0, 2, 0, 0, 1]
    if telemetry:
        # Absent at 0 before the re-warm, explicit at 0 after it.
        assert got[0][1][1] == [2, 2]
        assert got[0][3][1] == [2, 2, 0, 0]


def test_rewarm_failure_keeps_storm_evidence_as_jax():
    out = {}
    for name, server, fail in (("port", _port_server(0, None), pfail),
                               ("jax", _jax_server(0, None), jfail)):
        emb, _ = _gallery()
        engine = server.engine
        ask = (server.handle if hasattr(server, "handle")
               else lambda r: server.handle_many([r])[0])
        try:
            fail.arm("serve.compile_storm", times=1)
            ask({"id": 0, "embedding": emb[0].tolist()})

            def boom(input_shape=None):
                raise RuntimeError("device fell over")

            engine.warmup = boom
            with pytest.raises(RuntimeError, match="fell over"):
                server.rewarm()
            out[name] = (engine.warmed, engine.compiles_after_warmup,
                         server._explicit_compile_key)
        finally:
            server.replicaset.close(drain=True)
    assert out["port"] == out["jax"] == (True, 1, False)


def test_replicas_share_signatures_and_the_rewarm_resets_them():
    server = _port_server(0, None, replicas=2)
    emb, _ = _gallery()
    try:
        pfail.arm("serve.compile_storm", times=1)
        for i in range(6):
            server.handle_many([{"id": i, "embedding": emb[i].tolist()}])
        # Only the phantom: a replica's first dispatch of a warmed bucket
        # is no compile.
        assert server._compiles_after_warmup() == 1
        assert sum(e.compiles_total for e in server.engines) == 3
        server.engines[1].compiles_after_warmup = 1
        server.rewarm()
        assert [e.compiles_after_warmup for e in server.engines] == [0, 0]
        assert server.engine.compile_stats() == {
            "warmed": True, "compiles_total": 3, "compiles_after_warmup": 0}
    finally:
        server.replicaset.close(drain=True)


def test_remediation_block_in_summary_and_healthz():
    server = _port_server(0, None)
    try:
        assert "remediation" not in server.summary()
        eng = P.RemediationEngine([_pol(P)], {"a": lambda a: None},
                                  clock=lambda: 0.0)
        server.remediation = eng
        assert server.summary()["remediation"] == {}
        eng.tick({"s": _alert("s-1")}, 10.0)
        block = server.healthz()["remediation"]
        assert block == {"p": {"action": "a", "outcome": "attempted",
                               "alert_id": "s-1", "wall_time": 10.0}}
    finally:
        server.replicaset.close(drain=True)


# -- the CLIs -----------------------------------------------------------------


@pytest.fixture(scope="module")
def committed(tmp_path_factory):
    """One 64 x 8 flat index, committed by the JAX CLI (both load it)."""
    d = tmp_path_factory.mktemp("rem")
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((64, 8)).astype(np.float32)
    np.save(d / "g.emb.npy", emb)
    np.save(d / "g.labels.npy", (np.arange(64) % 8).astype(np.int32))
    with contextlib.redirect_stdout(io.StringIO()):
        assert jax_cli.main(["index", "--emb", str(d / "g.emb.npy"),
                             "--labels", str(d / "g.labels.npy"), "--out",
                             str(d / "g.gidx")]) == 0
    (d / "bad.json").write_text(json.dumps(
        {"policies": [{"name": "x", "typo": 1}]}))
    (d / "hotswap.json").write_text(json.dumps({"policies": [
        {"name": "hs", "slo": "model_staleness",
         "action": "snapshot_hotswap"}]}))
    (d / "train_bad_action.json").write_text(json.dumps({"policies": [
        {"name": "rw", "slo": "embedding_collapse", "action": "rewarm"}]}))
    return d


def _code(main, argv):
    with contextlib.redirect_stdout(io.StringIO()):
        try:
            return main(argv)
        except SystemExit as e:  # argparse's refusal of an unknown flag
            return e.code


SERVE_CASES = {
    "no_live_obs": ["--remediate"],
    "dry_run_no_live_obs": ["--remediate-dry-run"],
    "watch_snapshots": ["--live-obs", "--telemetry-dir", "TEL",
                        "--remediate", "--watch-snapshots", "/tmp/p_"],
    "bad_config": ["--live-obs", "--telemetry-dir", "TEL", "--remediate",
                   "--remediation-config", "BAD"],
    "bad_config_without_remediate": ["--remediation-config", "BAD"],
    "admission_no_live_obs": ["--admission", "slo"],
    "unregistered_action": ["--live-obs", "--telemetry-dir", "TEL",
                            "--remediate", "--remediation-config",
                            "HOTSWAP", "--no-warmup"],
}


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_serve_remediation_refusals_exit_as_jax(case, committed, tmp_path,
                                                caplog):
    argv = [{"TEL": str(tmp_path / "tel"), "BAD": str(committed /
                                                      "bad.json"),
             "HOTSWAP": str(committed / "hotswap.json")}.get(a, a)
            for a in SERVE_CASES[case]]
    base = ["serve", "--index", str(committed / "g.gidx"), "--top-k", "3"]
    caplog.set_level(logging.ERROR)
    rcs = {"jax": _code(jax_cli.main, base + argv + ["--mesh", "1"])}
    jax_text = caplog.text
    caplog.clear()
    rcs["port"] = _code(cli.main, base + argv + ["--device", "cpu"])
    assert rcs == {"jax": 2, "port": 2}
    if case == "unregistered_action":
        # The engine's own message, with the same registered actions.
        needle = ("policies reference unregistered actions "
                  "['snapshot_hotswap'] (registered: ['rewarm'])")
        assert needle in jax_text and needle in caplog.text


TRAIN_CASES = {
    "no_live_obs": ["--remediate"],
    "dry_run_no_live_obs": ["--remediate-dry-run"],
    "bad_config": ["--remediation-config", "BAD"],
    "unregistered_action": ["--live-obs", "--telemetry-dir", "TEL",
                            "--remediate", "--remediation-config",
                            "TRAIN_BAD"],
}


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_remediation_refusals_exit_as_jax(case, committed, tmp_path):
    argv = [{"TEL": str(tmp_path / "tel"), "BAD": str(committed /
                                                      "bad.json"),
             "TRAIN_BAD": str(committed / "train_bad_action.json")
             }.get(a, a) for a in TRAIN_CASES[case]]
    rcs = {"jax": _code(jax_cli.main, TRAIN + argv + ["--mesh", "1"]),
           "port": _code(cli.main, TRAIN + argv + ["--device", "cpu"])}
    assert rcs == {"jax": 2, "port": 2}


def test_serve_default_table_keeps_the_registered_actions(committed,
                                                          tmp_path):
    args = cli.build_parser().parse_args([
        "serve", "--index", str(committed / "g.gidx"), "--top-k", "3",
        "--device", "cpu", "--telemetry-dir", str(tmp_path / "tel"),
        "--live-obs", "--slo-tick", "3600", "--remediate-dry-run"])
    server, _ = cli.build_server(args)
    try:
        assert args.remediate is True
        assert [p.name for p in server.remediation.policies] == [
            "load_shed", "rewarm"]
        assert server.remediation.dry_run
        # The forced-only controller: no burn listener, nothing shed.
        assert server.admission is not None
        assert server.live.listeners == []
        assert server.healthz()["admission"]["shedding"] is False
    finally:
        server.replicaset.close(drain=True)
        cli.close_observers(server)
    assert os.path.exists(tmp_path / "tel" / "remediation.jsonl")


def _rollback_targets(lines):
    out = []
    for ln in lines:
        if "remediation rollback (" in ln and "rolled back to iteration" in ln:
            out.append(int(ln.split("rolled back to iteration ")[1].split()[0]))
    return out


def test_cpu_train_remediate_rolls_back_as_the_jax_cli(tmp_path, caplog):
    """``train --live-obs --remediate`` on the tiny cut: snapshots every 20
    iterations, ``train.collapse`` on iterations 21–26 (the only snapshot
    before the firing is iteration 20's, and the next is not due before
    the run would end), so the rollback target does not depend on how
    fast either package trains; the collapse rows' alert fires, the
    rollback lands, and the clean replay resolves it."""
    slo = tmp_path / "slo.json"
    slo.write_text(json.dumps({"slos": [{
        "name": "embedding_collapse", "metric": "train_an_threshold_mean",
        "op": "<=", "target": 0.98, "window_s": 0.3, "burn_threshold": 0.5,
        "min_samples": 1, "severity": "warning"}]}))
    rem = tmp_path / "rem.json"
    rem.write_text(json.dumps({"policies": [{
        "name": "trainer_rollback", "slo": "embedding_collapse",
        "action": "trainer_rollback", "cooldown_s": 60.0,
        "max_attempts": 1}]}))
    solver = tmp_path / "solver.prototxt"
    solver.write_text(open("examples/tiny_solver.prototxt").read()
                      .replace("snapshot: 0", "snapshot: 20")
                      .replace('net: "examples/', f'net: "{REPO}/examples/'))
    targets, states = {}, {}
    caplog.set_level(logging.WARNING)
    for name, main, fail, extra in (
            ("jax", jax_cli.main, jfail, ["--mesh", "1"]),
            ("port", cli.main, pfail, ["--device", "cpu"])):
        tel = tmp_path / name
        fail.reset()
        fail.arm("train.collapse", times=6, delay=20)
        caplog.clear()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main([
                "train", "--solver", str(solver), "--synthetic",
                "--max_iter", "39", "--snapshot_prefix",
                str(tmp_path / f"snap_{name}" / "m_"), "--telemetry-dir",
                str(tel), "--live-obs", "--slo-config", str(slo),
                "--slo-tick", "0.02", "--remediate",
                "--remediation-config", str(rem), *extra])
        assert rc == 0, name
        lines = buf.getvalue().splitlines() + caplog.text.splitlines()
        targets[name] = sorted(set(_rollback_targets(lines)))
        recs = P.load_remediation_log(str(tel / "remediation.jsonl"))
        from npairloss_tpu_torch.obs.live.alerts import load_alert_log

        arecs = load_alert_log(str(tel / "alerts.jsonl"))
        assert P.validate_remediation_log(recs, alert_records=arecs) is None
        states[name] = [(r["policy"], r["state"]) for r in recs]
    assert targets["port"] == targets["jax"] == [20]
    assert states["port"][0] == ("trainer_rollback", "attempted")
