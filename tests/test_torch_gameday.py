"""The port's gameday (``npairloss_tpu_torch/gameday``) held against the
JAX package's on the same inputs, on the CPU.

  * traffic: ``plan_lines``/``plan_digest``/``plan_stats`` equal for
    seeds 0–3 under both scenarios' configs (and test_gameday's);
  * schedules: the default and tenant-skew schedules, ``env_spec``,
    ``signals`` and ``load_schedule`` equal, and a bad entry raises the
    same error in both;
  * the verdict: every report fixture of ``tests/test_gameday.py`` (and
    the tenant-skew fixture of ``tests/test_tenants.py``) built by both
    packages' ``build_gameday_report`` into equal dicts, both
    validators giving the same message on it and on its tampered
    copies, and JAX's validator — loaded by file path — accepting the
    port's reports;
  * the runner: each child's argv is JAX's but for the module name and
    ``--device cpu``, and parses with the port's parser; the workspace
    files are JAX's (JSON byte for byte, the ``.gidx`` to equal arrays
    in both packages); ``_count_fires``, the torn-tail ``_jsonl``,
    ``_host_crash_evidence`` and ``_reconcile`` agree over one run
    directory the test writes;
  * the CLI: the ``gameday`` parser equals JAX's (plus ``--device``),
    and both refuse ``--replicas 1``, ``--schedule`` with tenant_skew
    and a missing schedule file with exit 1.

The composed runs themselves are not tier-1: ``python -m
npairloss_tpu_torch gameday --device cpu --out DIR`` (and on the card,
chip_smoke phase 14).
"""

import argparse
import importlib.util
import inspect
import json
import os
import pathlib
import shutil

import numpy as np
import pytest

from npairloss_tpu.gameday import runner as jrun
from npairloss_tpu.gameday import schedule as jchaos
from npairloss_tpu.gameday import traffic as jtg
from npairloss_tpu.gameday import verdict as jv
from npairloss_tpu_torch.gameday import runner as prun
from npairloss_tpu_torch.gameday import schedule as pchaos
from npairloss_tpu_torch.gameday import traffic as ptg
from npairloss_tpu_torch.gameday import verdict as pv

REPO = pathlib.Path(__file__).resolve().parent.parent

# The runner's two TrafficConfigs (run_gameday, run_tenant_skew) and
# tests/test_gameday.py's _cfg.
DAY_CFG = dict(base_qps=6.0, peak_qps=14.0, burst_qps=45.0, bursts=2,
               burst_s=3.0, catalog=256, zipf_s=1.1, ingest_every_s=10.0,
               ingest_rows=16)
SKEW_CFG = dict(base_qps=4.0, peak_qps=8.0, burst_qps=40.0, bursts=1,
                burst_s=6.0, catalog=256, zipf_s=1.1,
                tenants=tuple((t, 1.0) for t in ("acme", "bcorp", "ccorp")),
                hot_tenant="acme", hot_burst_factor=8.0)
TEST_CFG = dict(base_qps=4.0, peak_qps=16.0, burst_qps=60.0, bursts=2,
                burst_s=2.0, catalog=256, zipf_s=1.1, ingest_every_s=10.0,
                ingest_rows=16)
CFGS = {"day": DAY_CFG, "tenant_skew": SKEW_CFG, "test_gameday": TEST_CFG}


def _load_by_path(name, rel):
    spec = importlib.util.spec_from_file_location(name, str(REPO / rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# JAX's validator as a gate loads it: by file path, without the package.
JAX_VERDICT = _load_by_path("_jax_gameday_verdict",
                            "npairloss_tpu/gameday/verdict.py")


# -- traffic ------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("scenario", sorted(CFGS))
def test_traffic_plans_equal(seed, scenario):
    kw = dict(CFGS[scenario], seed=seed, duration_s=75.0)
    mine = ptg.generate(ptg.TrafficConfig(**kw))
    theirs = jtg.generate(jtg.TrafficConfig(**kw))
    assert ptg.plan_lines(mine) == jtg.plan_lines(theirs)
    assert ptg.plan_digest(mine) == jtg.plan_digest(theirs)
    assert ptg.plan_stats(mine) == jtg.plan_stats(theirs)


@pytest.mark.parametrize("bad", [dict(burst_qps=10.0),
                                 dict(bursts=30, burst_s=2.0),
                                 dict(catalog=1), dict(base_qps=0.0)])
def test_traffic_config_refusals_equal(bad):
    kw = dict(TEST_CFG, seed=0, duration_s=60.0, **bad)
    with pytest.raises(ValueError) as mine:
        ptg.TrafficConfig(**kw)
    with pytest.raises(ValueError) as theirs:
        jtg.TrafficConfig(**kw)
    assert str(mine.value) == str(theirs.value)


# -- schedules ----------------------------------------------------------------


@pytest.mark.parametrize("duration", [45.0, 75.0, 120.0])
def test_schedules_equal(duration):
    mine = pchaos.default_schedule(duration)
    theirs = jchaos.default_schedule(duration)
    assert pchaos.entry_dicts(mine) == jchaos.entry_dicts(theirs)
    for target in ("serve", "train"):
        assert pchaos.env_spec(mine, target) == \
            jchaos.env_spec(theirs, target)
        assert [dataclass_dict(e) for e in pchaos.signals(mine, target)] \
            == [dataclass_dict(e) for e in jchaos.signals(theirs, target)]
    for hot in ("acme", "bcorp"):
        assert pchaos.entry_dicts(pchaos.tenant_skew_schedule(
            hot, duration)) == jchaos.entry_dicts(
                jchaos.tenant_skew_schedule(hot, duration))


def dataclass_dict(entry):
    return pchaos.entry_dicts([entry])[0]


def test_load_schedule_round_trips_equal(tmp_path):
    path = tmp_path / "sched.json"
    path.write_text(json.dumps({"entries": jchaos.entry_dicts(
        jchaos.default_schedule(75.0))}))
    mine = pchaos.load_schedule(str(path))
    assert mine == pchaos.default_schedule(75.0)
    assert pchaos.entry_dicts(mine) == jchaos.entry_dicts(
        jchaos.load_schedule(str(path)))


@pytest.mark.parametrize("bad", [
    {"entries": [{"name": "x", "target": "db"}]},
    {"entries": [{"name": "x", "remediation": "p"}]},
    {"entries": [{"name": "x", "expect": ["warp_drive"]}]},
    {"entries": [{"name": "SIGTERM", "kind": "signal", "alert": "a"}]},
    {"entries": [{"name": "x", "colour": "red"}]},
    {"entries": ["x"]},
    {"steps": []},
], ids=["target", "remediation", "expect", "signal", "unknown-key",
        "not-object", "no-entries"])
def test_bad_schedule_entries_raise_the_same_error(bad, tmp_path):
    path = tmp_path / "sched.json"
    path.write_text(json.dumps(bad))
    with pytest.raises(ValueError) as mine:
        pchaos.load_schedule(str(path))
    with pytest.raises(ValueError) as theirs:
        jchaos.load_schedule(str(path))
    assert str(mine.value) == str(theirs.value)


# -- the verdict ----------------------------------------------------------------


class _Captured(Exception):
    pass


def _gameday_fixtures():
    """tests/test_gameday.py's fixture builder, loaded by file path with
    its ``build_gameday_report`` replaced by a recorder: each fixture
    gives the (entries, kwargs) it would have built."""
    mod = _load_by_path("_jax_test_gameday", "tests/test_gameday.py")
    calls = []

    def record(entries, **kw):
        calls.append((entries, kw))
        raise _Captured

    mod.build_gameday_report = record

    def build(**over):
        calls.clear()
        with pytest.raises(_Captured):
            mod._passing_report(**over)
        return calls[0]

    return mod, build


def _alert_pair(aid, slo, t0, t1):
    base = {"schema": "alerts-v1", "alert_id": aid, "slo": slo,
            "metric": "m", "severity": "warning", "ts": t0,
            "fired_at": t0, "bad_fraction": 1.0, "samples": 4,
            "target": 1.0, "op": "<=", "message": "x"}
    return [dict(base, state="firing"),
            dict(base, state="resolved", ts=t1, bad_fraction=0.0)]


def _tenant_row(queries=100, answered=100, errors=0, rejected=0, sheds=0,
                p99=30.0):
    return {"queries": queries, "answered": answered, "errors": errors,
            "rejected": rejected, "p99_ms": p99, "index_kind": "flat",
            "quota": {"qps": 6.0, "burst_s": 1.0, "sheds": sheds,
                      "tokens": 0.0}}


def _skew_kwargs(**over):
    """tests/test_tenants.py's ``_skew_report`` fixture."""
    tenants = {"acme": _tenant_row(queries=300, answered=100, rejected=200,
                                   sheds=200),
               "bcorp": _tenant_row(), "ccorp": _tenant_row()}
    kw = dict(
        traffic={"planned": 500, "fed": 500, "answered": 300,
                 "errors": 0, "rejected": 200, "sha256": "d" * 64},
        serve_alerts=_alert_pair("a1", "tenant_quota@acme", 36.0, 66.0),
        train_alerts=[], serve_remediation=[], train_remediation=[],
        serve_rows=[{"p99_ms": 35.0, "wall_time": float(t)}
                    for t in range(0, 76, 5)],
        quality_windows=[],
        drain={"queries": 500, "answered": 300, "errors": 0,
               "rejected": 200, "queries_dropped": 0, "hot_swaps": 0,
               "tenants": tenants},
        comms={"available": False, "reason": "no trainer"},
        trainer={"segments": 0, "exit_codes": [], "resumed": False},
        observed_fires={}, client_errors=0, window_s=75.0, seed=0,
        p99_target_ms=150.0, recall_floor=0.9, min_hot_swaps=0,
        tenant_hot="acme",
        tenant_quality={tid: [{"recall_at_10": 0.97, "wall_time": float(t)}
                              for t in range(0, 76, 10)]
                        for tid in tenants})
    kw.update(over)
    return jchaos.entry_dicts(jchaos.tenant_skew_schedule("acme", 75.0)), kw


def _rows(extra=()):
    return [{"p99_ms": 40.0, "wall_time": float(t)}
            for t in range(0, 76, 5)] + list(extra)


def _drain(**over):
    d = {"queries": 400, "answered": 390, "errors": 0, "rejected": 10,
         "queries_dropped": 0, "hot_swaps": 4}
    d.update(over)
    return {k: v for k, v in d.items() if v is not None}


def _hc(**over):
    d = {"available": True, "kills": 1, "acked_batches": 3,
         "acked_vectors": 24, "lost": 0, "duplicates": 0,
         "torn_records": 0, "self_recall": 1.0}
    d.update(over)
    return d


# Each fixture of tests/test_gameday.py, as the overrides its test
# passes to _passing_report (the tests' names).
GAMEDAY_FIXTURES = {
    "passing": {},
    "unfired_fault": dict(observed_fires={
        "serve.stale_model": 6, "serve.latency": 40,
        "train.collapse": 160}),
    "breach_inside_window": dict(serve_rows=_rows([{
        "p99_ms": 900.0, "wall_time": 42.0,
        "qtrace_dominant": "queue_wait", "qtrace_dominant_ms": 870.0}])),
    "breach_outside_window": dict(serve_rows=_rows([{
        "p99_ms": 900.0, "wall_time": 74.5}])),
    "drops_missing": dict(drain=_drain(queries_dropped=None)),
    "drops_7": dict(drain=_drain(answered=383, queries_dropped=7)),
    "too_few_hot_swaps": dict(drain=_drain(hot_swaps=2)),
    "unattributed_comms": dict(comms={"available": True,
                                      "unattributed_bytes": 12}),
    "comms_unavailable": dict(comms={"available": False,
                                     "reason": "no fleet_comms.json"}),
    "host_crash_lost": dict(host_crash=_hc(lost=2)),
    "host_crash_duplicates": dict(host_crash=_hc(duplicates=1)),
    "host_crash_none": dict(host_crash=None),
    "host_crash_low_recall": dict(host_crash=_hc(self_recall=0.5)),
    "host_crash_lost_5": dict(host_crash=_hc(lost=5)),
}


def _fixture(name):
    if name.startswith("skew"):
        over = {"skew": {},
                "skew_quiet": dict(drain={
                    "queries": 500, "answered": 500, "errors": 0,
                    "rejected": 0, "queries_dropped": 0, "hot_swaps": 0,
                    "tenants": {t: _tenant_row()
                                for t in ("acme", "bcorp", "ccorp")}}),
                "skew_unpaged": dict(serve_alerts=[]),
                "skew_neighbor_recall": dict(tenant_quality={
                    "acme": [], "ccorp": [],
                    "bcorp": [{"recall_at_10": 0.5, "wall_time": 5.0}]}),
                }[name]
        return _skew_kwargs(**over)
    if name == "unremediated":
        mod, build = _gameday_fixtures()
        return build(serve_remediation=[
            mod._rem("a1", "model_staleness", "hotswap_model", "failed",
                     16.0),
            mod._rem("a2", "serve_p99", "load_shed", "succeeded", 44.0)])
    _, build = _gameday_fixtures()
    return build(**GAMEDAY_FIXTURES[name])


FIXTURES = sorted(GAMEDAY_FIXTURES) + [
    "unremediated", "skew", "skew_quiet", "skew_unpaged",
    "skew_neighbor_recall"]


def _tampered(report):
    """The report's tampered copies: the schema tag at -v0; for a
    failing report, a forged pass over its own failures and every fault
    forged ok; queries_dropped doctored to 7 under the verdict as it
    was; a missing zero_drop key; no faults; and the host_crash block
    without a key."""
    out = {"schema_v0": dict(report, schema="npairloss-gameday-v0")}
    if report["verdict"] != "pass":
        out["forged_pass"] = dict(report, verdict="pass", failures=[])
        out["faults_forged"] = dict(report, verdict="pass", failures=[],
                                    faults=[dict(f, ok=True, checks={
                                        c: True for c in f["checks"]})
                                        for f in report["faults"]])
    zd = dict(report["zero_drop"], queries_dropped=7)
    out["dropped_7"] = dict(report, zero_drop=zd)
    out["zero_drop_key"] = dict(report, zero_drop={
        k: v for k, v in report["zero_drop"].items()
        if k != "queries_dropped"})
    out["no_faults"] = dict(report, faults=[])
    if report["host_crash"].get("available"):
        out["host_crash_key"] = dict(report, host_crash={
            k: v for k, v in report["host_crash"].items()
            if k != "torn_records"})
    return out


@pytest.mark.parametrize("name", FIXTURES)
def test_reports_and_validators_equal(name):
    entries, kw = _fixture(name)
    mine = pv.build_gameday_report(json.loads(json.dumps(entries)),
                                   **json.loads(json.dumps(kw)))
    theirs = jv.build_gameday_report(entries, **kw)
    assert mine == theirs
    assert pv.GAMEDAY_SCHEMA == jv.GAMEDAY_SCHEMA
    err = pv.validate_gameday_report(mine)
    assert err == jv.validate_gameday_report(theirs)
    # JAX's gate, by file path, on the port's report.
    assert JAX_VERDICT.validate_gameday_report(mine) == err
    assert (err is None) == (mine["verdict"] == "pass")
    for what, bad in _tampered(mine).items():
        msg = pv.validate_gameday_report(bad)
        assert msg == jv.validate_gameday_report(bad), what
        # Forged fault rows stand where the evidence they recompute from
        # (host_crash, zero_drop, ...) agrees; the rest are refused.
        assert msg is not None or what == "faults_forged", what


# -- the runner ---------------------------------------------------------------


def _port_parse(argv):
    from npairloss_tpu_torch import cli

    assert argv[:3] == [prun.sys.executable, "-m", "npairloss_tpu_torch"]
    return cli.build_parser().parse_args(argv[3:])


def _as_jax(argv):
    """The port's argv as JAX's would read: the module renamed and the
    trailing ``--device cpu`` taken off."""
    assert argv[-2:] == ["--device", "cpu"]
    return [argv[0], argv[1], "npairloss_tpu"] + argv[3:-2]


def test_child_argvs_are_jax_but_module_and_device(tmp_path):
    out, solver = str(tmp_path), str(tmp_path / "solver.prototxt")
    pairs = [
        (prun._train_cmd(solver, out, "cpu"), jrun._train_cmd(solver, out)),
        (prun._serve_cmd(out, 2, "cpu"), jrun._serve_cmd(out, 2)),
        (prun._tenant_serve_cmd(out, 2, "cpu"),
         jrun._tenant_serve_cmd(out, 2)),
    ]
    for mine, theirs in pairs:
        assert _as_jax(mine) == theirs
        args = _port_parse(mine)
        assert args.device == "cpu"
    args = _port_parse(prun._serve_cmd(out, 2, "cpu"))
    assert args.replicas == 2 and args.remediate and args.qtrace
    assert args.wal_dir == os.path.join(out, "wal")
    args = _port_parse(prun._train_cmd(solver, out, "cpu"))
    assert args.resume == "auto" and args.snapshot_keep == 10
    # The seed train and the watch follower, inline in run_gameday in
    # both packages: the same flags.
    for src in (inspect.getsource(jrun.run_gameday),
                inspect.getsource(prun.run_gameday)):
        assert '"train", "--solver", solver, "--model",' in src
        assert '"mlp", "--synthetic", "--max_iter", "40"]' in src
        assert '"--follow", "--poll-s", "0.5",' in src
    _port_parse([prun.sys.executable, "-m", "npairloss_tpu_torch", "train",
                 "--solver", solver, "--model", "mlp", "--synthetic",
                 "--max_iter", "40", "--device", "cpu"])
    _port_parse([prun.sys.executable, "-m", "npairloss_tpu_torch", "watch",
                 os.path.join(out, "serve_tel"), "--slo-config",
                 os.path.join(out, "slo.json"), "--follow", "--poll-s",
                 "0.5", "--for", "105.0"])


def test_child_env_keeps_the_card_and_rearms_failpoints(monkeypatch):
    monkeypatch.setenv("NPAIRLOSS_FAILPOINTS", "stale:1")
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    env = prun._child_env("serve.latency:40@200")
    assert env["NPAIRLOSS_FAILPOINTS"] == "serve.latency:40@200"
    assert "NPAIRLOSS_FAILPOINTS" not in prun._child_env()
    assert "CUDA_VISIBLE_DEVICES" not in env
    assert env.get("JAX_PLATFORMS") == os.environ.get("JAX_PLATFORMS")
    assert prun._python()[1:] == ["-m", "npairloss_tpu_torch"]


def _load_gidx_both(path):
    from npairloss_tpu.serve.index import load_index as jload

    from npairloss_tpu_torch.serve.index import load_index as pload

    p = pload(path, device="cpu")
    j = jload(path)
    return ((p.host_emb, p.host_labels, p.ids),
            (np.asarray(j._host_emb), np.asarray(j._host_labels),
             np.asarray(j.ids)))


def _same_gidx(a, b):
    for got in (_load_gidx_both(a) + _load_gidx_both(b)):
        ref = _load_gidx_both(a)[0]
        for x, y in zip(got, ref):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_workspaces_equal(tmp_path):
    kw = dict(DAY_CFG, seed=0, duration_s=75.0)
    mine, theirs = tmp_path / "p", tmp_path / "j"
    pe, pl, psolver = prun._setup_workspace(str(mine),
                                            ptg.TrafficConfig(**kw))
    je, jl, jsolver = jrun._setup_workspace(str(theirs),
                                            jtg.TrafficConfig(**kw))
    np.testing.assert_array_equal(pe, je)
    np.testing.assert_array_equal(pl, jl)
    for name in ("slo.json", "rem.json", "train_slo.json",
                 "train_rem.json"):
        assert (mine / name).read_bytes() == (theirs / name).read_bytes()
    assert pathlib.Path(psolver).read_text().replace(str(mine), "OUT") == \
        pathlib.Path(jsolver).read_text().replace(str(theirs), "OUT")
    _same_gidx(str(mine / "idx" / "g_0000.gidx"),
               str(theirs / "idx" / "g_0000.gidx"))

    kw = dict(SKEW_CFG, seed=0, duration_s=75.0)
    pe = prun._tenant_workspace(str(mine / "t"), ptg.TrafficConfig(**kw),
                                "acme")
    je = jrun._tenant_workspace(str(theirs / "t"), jtg.TrafficConfig(**kw),
                                "acme")
    assert sorted(pe) == sorted(je) == ["acme", "bcorp", "ccorp"]
    for tid in pe:
        np.testing.assert_array_equal(pe[tid], je[tid])
        _same_gidx(str(mine / "t" / "idx" / f"{tid}-0000.gidx"),
                   str(theirs / "t" / "idx" / f"{tid}-0000.gidx"))
    assert (mine / "t" / "tenants.json").read_text().replace(
        str(mine), "OUT") == (theirs / "t" / "tenants.json").read_text(
        ).replace(str(theirs), "OUT")


def _jsonl_write(path, rows, torn=False):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
        if torn:
            f.write('{"state": "fir')


def _run_dir(root):
    """A finished day's run directory: logs with failpoint fires, a
    torn alert log, quality windows, metric rows, a qtrace artifact
    beside a preserved pre-kill one, the final index commit holding the
    acked ingest rows (one batch lost), and the drain summary."""
    from npairloss_tpu_torch.serve.index import GalleryIndex

    rng = np.random.default_rng(0)
    emb = rng.standard_normal((40, 64)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    ids = np.concatenate([np.arange(24),
                          10_000_000 + np.arange(8),
                          10_010_000 + np.arange(8)]).astype(np.int64)
    os.makedirs(root / "idx")
    GalleryIndex.build(emb, np.arange(40) % 16, ids=ids, normalize=False,
                       device="cpu").save(str(root / "idx" / "g_0003.gidx"))
    sent = {"ing-0": {"ids": [int(i) for i in ids[24:32]],
                      "emb": emb[24:32]},
            "ing-1": {"ids": [int(i) for i in ids[32:40]],
                      "emb": emb[32:40]},
            "ing-2": {"ids": [10_020_000 + j for j in range(8)],
                      "emb": rng.standard_normal((8, 64)).astype(
                          np.float32)}}
    t0 = 1_000.0
    (root / "serve.log").write_text(
        "x failpoint fired: serve.stale_model\n" * 6
        + "x failpoint fired: serve.latency\n" * 3)
    (root / "serve2.log").write_text("x failpoint fired: serve.latency\n")
    (root / "train1.log").write_text(
        "x failpoint fired: train.collapse\n" * 5 + "noise\n")
    (root / "train2.log").write_text("resuming from iteration 320\n")
    tel = root / "serve_tel"
    _jsonl_write(str(tel / "alerts.jsonl"),
                 _alert_pair("a1", "model_staleness", t0 + 12, t0 + 18),
                 torn=True)
    _jsonl_write(str(tel / "remediation.jsonl"), [
        {"alert_id": "a1", "policy": "hotswap_model", "state": "succeeded",
         "ts": t0 + 16}])
    _jsonl_write(str(tel / "metrics.jsonl"),
                 [{"p99_ms": 30.0 + t, "wall_time": t0 + t}
                  for t in range(0, 75, 5)] + [{"no": "p99"}])
    _jsonl_write(str(tel / "quality.jsonl"),
                 [{"kind": "window", "recall_at_10": 0.95,
                   "wall_time": t0 + t} for t in range(0, 75, 10)]
                 + [{"kind": "summary"}])
    (tel / "qtrace.json").write_text(json.dumps(
        {"totals": {"queries": 10, "reroutes": 1}, "budget": {},
         "slo_ms": 150.0}))
    (tel / "qtrace.pre1.json").write_text(json.dumps(
        {"totals": {"queries": 5, "reroutes": 2, "flag": True}}))
    os.makedirs(root / "train_tel")
    drain = {"event": "serve_drain", "queries": 60, "answered": 60,
             "errors": 0, "rejected": 0, "queries_dropped": 0,
             "hot_swaps": 4, "ingest": {"wal": {"torn_records": 1}}}
    _jsonl_write(str(root / "answers.jsonl"),
                 [{"id": "ing-0", "ingested": 8},
                  {"id": "ing-1", "ingested": 8},
                  {"id": "ing-2", "ingested": 8},
                  {"id": "ing-3", "ingested": 8},
                  {"id": 7, "neighbors": []}, drain], torn=True)
    state = {"fed": 60, "ingest_sent": sent, "kill_walls": [t0 + 41.25]}
    return state, drain


def test_runner_evidence_equal(tmp_path):
    root = tmp_path / "run"
    state, drain = _run_dir(root)
    logs = [str(root / n) for n in ("serve.log", "serve2.log",
                                    "train1.log", "train2.log", "none.log")]
    assert prun._count_fires(logs) == jrun._count_fires(logs) == {
        "serve.stale_model": 6, "serve.latency": 4, "train.collapse": 5}
    for rel in ("answers.jsonl", "serve_tel/alerts.jsonl", "missing.jsonl"):
        assert prun._jsonl(str(root / rel)) == jrun._jsonl(str(root / rel))
    answers = prun._jsonl(str(root / "answers.jsonl"))
    mine = prun._host_crash_evidence(str(root), answers, state, drain)
    theirs = jrun._host_crash_evidence(str(root), answers, state, drain)
    assert mine == theirs
    assert mine["lost"] == 8 and mine["acked_batches"] == 3
    assert mine["torn_records"] == 1
    assert prun._host_crash_evidence(str(root), answers, {}, drain) == \
        jrun._host_crash_evidence(str(root), answers, {}, drain)

    entries = pchaos.default_schedule(75.0)
    plan_kw = dict(DAY_CFG, seed=0, duration_s=75.0)
    reports = []
    for tag, run, chaos, tg in (("p", prun, pchaos, ptg),
                                ("j", jrun, jchaos, jtg)):
        d = tmp_path / tag
        shutil.copytree(root, d)
        reports.append(run._reconcile(
            str(d), chaos.default_schedule(75.0),
            tg.generate(tg.TrafficConfig(**plan_kw)), dict(state),
            [75, 75], {"SIGTERM": 1, "SIGKILL": 1}, duration_s=75.0,
            seed=0))
    mine, theirs = reports
    assert len(entries) == len(mine["faults"])
    # The one host-dependent string: the fleet report's reason names
    # the run directory.
    for r, d in zip(reports, ("p", "j")):
        r["comms"]["reason"] = r["comms"].get("reason", "").replace(
            str(tmp_path / d), "RUN")
    assert mine == theirs
    assert pv.validate_gameday_report(mine) == \
        jv.validate_gameday_report(theirs)
    assert json.loads((tmp_path / "p" / "gameday.json").read_text())[
        "verdict"] == mine["verdict"]


# -- the CLI --------------------------------------------------------------------


def _options(parser):
    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        out[a.dest] = (tuple(a.option_strings),
                       tuple(a.choices) if a.choices else None, a.default,
                       a.type, a.required)
    return out


def _sub(parser, cmd):
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return sub.choices[cmd]


def _jax_parser(monkeypatch):
    from npairloss_tpu import cli as jcli

    got = {}

    def take(self, *a, **kw):
        got["parser"] = self
        raise _Captured

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", take)
    with pytest.raises(_Captured):
        jcli.main(["gameday"])
    monkeypatch.undo()
    return got["parser"]


def test_gameday_parser_equals_jax(monkeypatch):
    from npairloss_tpu_torch import cli

    mine = _options(_sub(cli.build_parser(), "gameday"))
    theirs = _options(_sub(_jax_parser(monkeypatch), "gameday"))
    assert mine.pop("device") == (("--device",), None, None, None, False)
    assert mine == theirs


@pytest.mark.parametrize("argv", [
    ["--replicas", "1"],
    ["--scenario", "tenant_skew", "--schedule", "x.json"],
    ["--schedule", "no-such-schedule.json"],
    ["--duration", "0"],
], ids=["replicas", "schedule-skew", "missing-schedule", "duration"])
def test_gameday_refusals_equal(argv, tmp_path, monkeypatch):
    from npairloss_tpu import cli as jcli

    from npairloss_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    (tmp_path / "x.json").write_text('{"entries": []}')
    base = ["gameday", "--out", str(tmp_path / "out")]
    assert cli.main(base + argv) == 1
    assert jcli.main(base + argv) == 1
    assert not (tmp_path / "out").exists()
