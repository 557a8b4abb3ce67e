"""The port's fleet observatory (``npairloss_tpu_torch/obs/fleet``) held
against the JAX package's on the same inputs: the synthetic 4-rank run
directories of ``tests/test_fleet.py`` (a straggler, a clock offset, a
missing rank, a torn tail line, dropped spans, a step-count
disagreement, malformed trace events) go through both packages'
``build_fleet_report``, ``validate_fleet_report``, ``merge_run_traces``
and ``merge_timeline``; the reports and merged traces are equal key for
key once the run directory's path is removed (nothing else in them is a
path or a timestamp of the run).

The comms pricing: the JAX package prices per HLO opcode, the port per
mesh collective folded into the same kinds, so the rows are equal but
for the ``opcodes`` names; the links are the process group's backends
(``nccl``: the card's NVLink figure; ``gloo``: no published peak).

The solver's fleet path runs on two gloo ranks (``RankPool``): rank
stamps, step-numbered dispatch spans, ``comm/<kind>`` marks and
``fleet_comms.json`` whose gradient all-reduce claim is the parameter
tree's bytes — the same number the JAX solver claims for the same
model — with pricing on a late telemetry attach, re-pricing on a new
batch shape, and the stream and trace unchanged without a fleet."""

import copy
import json
import os

import numpy as np
import pytest

from npairloss_tpu.obs.fleet import aggregate as jagg
from npairloss_tpu.obs.fleet import comms as jcomms
from npairloss_tpu.obs.fleet import merge_traces as jmerge
from npairloss_tpu_torch.obs.fleet import aggregate as pagg
from npairloss_tpu_torch.obs.fleet import comms as pcomms
from npairloss_tpu_torch.obs.fleet import merge_traces as pmerge
from npairloss_tpu_torch.obs.tracing import validate_chrome_trace

T0 = 1_700_000_000.0
STEP_S = 0.100
STRAGGLER = 2
LATE_S = 0.030
OFFSET_RANK = 3
OFFSET_S = 5.0


def _make_fleet_run(root, ranks=4, steps=6):
    """``tests/test_fleet.py``'s fixture: rank STRAGGLER dispatches
    LATE_S late every step; rank OFFSET_RANK's tracer clock is OFFSET_S
    off (its ts values compensate, so absolute times agree)."""
    run = root / "fleet"
    run.mkdir(parents=True, exist_ok=True)
    for k in range(ranks):
        origin = T0 - (OFFSET_S if k == OFFSET_RANK else 0.0)
        late = LATE_S if k == STRAGGLER else 0.0
        events, rows = [], []
        for s in range(1, steps + 1):
            abs_t = T0 + s * STEP_S + late
            events.append({
                "name": "step/dispatch", "ph": "X",
                "ts": (abs_t - origin) * 1e6, "dur": 500.0,
                "pid": 1000 + k, "tid": 1,
                "args": {"batch": 8, "step": s},
            })
            rows.append({
                "loss": 0.5 / s, "run_id": "fix", "step": s,
                "wall_time": abs_t + 0.001, "phase": "train",
                "process_index": k, "process_count": ranks,
                "local_device_ids": [k],
            })
        (run / f"telemetry.r{k}.jsonl").write_text(
            "".join(json.dumps(r) + "\n" for r in rows))
        (run / f"trace.r{k}.json").write_text(json.dumps({
            "traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"wall_time_origin": origin},
        }))
        (run / f"manifest.r{k}.json").write_text(json.dumps({
            "run_id": "fix", "created": origin,
            "fleet": {"process_index": k, "process_count": ranks,
                      "local_device_ids": [k]},
        }))
    return run


def _mutate(run, how):
    if how == "missing_rank":
        for name in os.listdir(run):
            if ".r3." in name:
                os.unlink(run / name)
    elif how == "torn_tail":
        with open(run / "telemetry.r1.jsonl", "a") as f:
            f.write('{"loss": 0.1, "step": 7, "phase": "tr')
    elif how == "dropped_spans":
        trace = json.load(open(run / "trace.r0.json"))
        trace["otherData"]["dropped_events"] = 7
        (run / "trace.r0.json").write_text(json.dumps(trace))
    elif how == "step_disagreement":
        lines = (run / "telemetry.r2.jsonl").read_text().splitlines()
        (run / "telemetry.r2.jsonl").write_text("\n".join(lines[:-2]) + "\n")
    elif how == "missing_trace":
        os.unlink(run / "trace.r2.json")
    elif how == "malformed_events":
        trace = json.load(open(run / "trace.r1.json"))
        trace["traceEvents"].append({"name": "broken", "ph": "X",
                                     "ts": 1.0, "pid": 9, "tid": 1})
        trace["traceEvents"].append({"ph": "i", "ts": 2.0})
        (run / "trace.r1.json").write_text(json.dumps(trace))
    elif how == "single_process":
        for name in os.listdir(run):
            os.unlink(run / name)
        (run / "metrics.jsonl").write_text("".join(
            json.dumps({"loss": 1.0, "run_id": "x", "step": s,
                        "wall_time": T0 + s, "phase": "train"}) + "\n"
            for s in range(1, 4)))
    return run


def _no_paths(report, run):
    out = copy.deepcopy(report)
    out.pop("run_dir")
    out["notes"] = [n.replace(str(run), "<run>") for n in out["notes"]]
    return out


MUTATIONS = ["none", "missing_rank", "torn_tail", "dropped_spans",
             "step_disagreement", "missing_trace", "malformed_events",
             "single_process"]


@pytest.mark.parametrize("how", MUTATIONS)
def test_fleet_report_equals_jax_key_for_key(tmp_path, how):
    run = _mutate(_make_fleet_run(tmp_path), how)
    want = jagg.build_fleet_report(str(run))
    got = pagg.build_fleet_report(str(run))
    assert _no_paths(got, run) == _no_paths(want, run)
    # One contract: each package's validator gives the other's verdict.
    assert pagg.validate_fleet_report(got) == jagg.validate_fleet_report(
        want)
    assert jagg.validate_fleet_report(got) == pagg.validate_fleet_report(
        got)
    assert pagg.render_fleet_table(got) == jagg.render_fleet_table(want)


def test_fleet_report_reads_the_straggler(tmp_path):
    report = pagg.build_fleet_report(str(_make_fleet_run(tmp_path)))
    assert pagg.validate_fleet_report(report) is None
    skew = report["skew"]
    assert skew["source"] == "dispatch_spans"
    assert skew["dispatch_spread_ms_p50"] == pytest.approx(LATE_S * 1e3,
                                                           rel=1e-6)
    assert skew["slowest"] == {"rank": STRAGGLER, "share": 1.0,
                               "persistence": skew["steps_analyzed"]}
    by_rank = {r["rank"]: r for r in report["ranks"]}
    assert by_rank[STRAGGLER]["barrier_wait_share"] == 0.0
    assert by_rank[0]["barrier_wait_share"] > 0.0


def _teeth(good):
    bad = []
    bad.append(dict(good, schema="nope"))
    bad.append(dict(good, ranks=[]))
    bad.append(dict(good, ranks=[{k: v for k, v in good["ranks"][0].items()
                                  if k != "spans_dropped"}]))
    bad.append(dict(good, skew={}))
    no_comms = dict(good)
    no_comms.pop("comms")
    bad.append(no_comms)
    unflagged = copy.deepcopy(good)
    unflagged["ranks"][0]["spans_dropped"] = 3
    unflagged["ranks"][0]["flagged"] = False
    bad.append(unflagged)
    return bad


@pytest.mark.parametrize("i", range(6))
def test_validator_teeth_match_jax(tmp_path, i):
    good = pagg.build_fleet_report(str(_make_fleet_run(tmp_path)))
    bad = _teeth(good)[i]
    err = pagg.validate_fleet_report(bad)
    assert err is not None
    assert err == jagg.validate_fleet_report(bad)


@pytest.mark.parametrize("how", ["none", "missing_trace", "malformed_events",
                                 "single_process"])
def test_merge_run_traces_equals_jax(tmp_path, how):
    run = _mutate(_make_fleet_run(tmp_path), how)
    jpath, want = jmerge.merge_run_traces(str(run),
                                          str(tmp_path / "j.json"))
    ppath, got = pmerge.merge_run_traces(str(run), str(tmp_path / "p.json"))
    assert got == want
    assert (ppath is None) == (jpath is None)
    assert validate_chrome_trace(got) is None
    if how == "none":
        lanes = {e["pid"] for e in got["traceEvents"]}
        assert lanes == {0, 1, 2, 3}
        t_of = {(e["pid"], e["args"]["step"]): e["ts"]
                for e in got["traceEvents"] if e["name"] == "step/dispatch"}
        assert t_of[(3, 1)] == pytest.approx(t_of[(1, 1)], abs=1.0)
        assert t_of[(STRAGGLER, 1)] - t_of[(1, 1)] == pytest.approx(
            LATE_S * 1e6, rel=1e-6)


def _serve_trace(path, origin):
    path.parent.mkdir(parents=True, exist_ok=True)
    events = []
    for i, tid in enumerate((11, 12, 11, 12)):
        events.append({"name": "serve/dispatch", "ph": "X",
                       "ts": 1000.0 * i, "dur": 300.0, "pid": 7, "tid": tid,
                       "args": {"size": 8}})
        events.append({"name": "serve/topk", "ph": "X",
                       "ts": 1000.0 * i + 50, "dur": 200.0, "pid": 7,
                       "tid": tid, "args": {"batch": 8, "bucket": 8}})
    path.write_text(json.dumps({"traceEvents": events,
                                "displayTimeUnit": "ms",
                                "otherData": {"wall_time_origin": origin}}))


@pytest.mark.parametrize("layout", ["train_and_serve", "serve_only",
                                    "with_ops_logs"])
def test_merge_timeline_equals_jax(tmp_path, layout):
    run = tmp_path / "run"
    run.mkdir()
    if layout != "serve_only":
        src = _make_fleet_run(tmp_path)
        (run / "train_tel").mkdir()
        for name in os.listdir(src):
            os.replace(src / name, run / "train_tel" / name)
    _serve_trace(run / "serve_tel" / "trace.json", T0 + 0.25)
    if layout == "with_ops_logs":
        (run / "alerts.jsonl").write_text(json.dumps(
            {"ts": T0 + 0.3, "slo": "p99", "state": "firing",
             "severity": "page", "alert_id": "a1"}) + "\n")
        (run / "gameday.json").write_text(json.dumps(
            {"faults": [{"name": "stall", "at_s": 0.2, "target": "r0",
                         "kind": "serve"}]}))
    jpath, want = jmerge.merge_timeline(str(run), str(tmp_path / "j.json"))
    ppath, got = pmerge.merge_timeline(str(run), str(tmp_path / "p.json"))
    assert got == want
    assert validate_chrome_trace(got) is None
    lanes = {e["tid"] for e in got["traceEvents"]
             if e.get("pid") == pmerge.SERVE_HOST_PID and e["ph"] == "X"}
    assert lanes == {11, 12}


# -- comms --------------------------------------------------------------------


def _per_opcode():
    return {
        "all-gather": {"bytes": 4096.0, "count": 2.0,
                       "regions": {"npair/gather/comm/all_gather": 4096.0}},
        "all-reduce": {"bytes": 1024.0, "count": 1.0,
                       "regions": {"MLPEmbedding/dense0": 1024.0}},
    }


def _per_kind():
    """The same collectives as the port's count declares them: the
    gather in a comm/ region, the all-reduce priced without a kind."""
    return pcomms.per_kind_from_counts({
        "all_gather": {"bytes": 4096, "count": 2,
                       "regions": {"npair/comm/all_gather": 4096}},
        "all_reduce_sum": {"bytes": 1024, "count": 1,
                           "regions": {"dense0": 1024}},
    })


def _no_ops(rows):
    return {**rows, "kinds": [{k: v for k, v in r.items() if k != "opcodes"}
                              for r in rows["kinds"]]}


@pytest.mark.parametrize("claims", [None, "grad_sync"])
def test_comm_rows_equal_jax(claims):
    extra = (jcomms.grad_sync_claim_bytes(1024.0, 2) if claims else None)
    assert extra == pcomms.grad_sync_claim_bytes(1024.0, 2) or not claims
    want = jcomms.comm_rows_from_hlo(_per_opcode(), extra_claims=extra)
    got = pcomms.comm_rows_from_counts(_per_kind(), extra_claims=extra)
    assert _no_ops(got) == _no_ops(want)
    kinds = {k["kind"]: k for k in got["kinds"]}
    assert kinds["all_gather"]["opcodes"] == ["all_gather"]
    assert kinds["allreduce"]["opcodes"] == ["all_reduce_sum"]
    assert got["unattributed_bytes"] == (0.0 if claims else 1024.0)


def test_effective_bandwidth_links():
    rows = pcomms.comm_rows_from_counts(_per_kind(),
                                        extra_claims={"allreduce": 1024.0})
    card = "NVIDIA H100 80GB HBM3"
    nccl = pcomms.effective_bandwidth(rows, 10.0, card, "nccl")
    net = pcomms.effective_bandwidth(rows, 10.0, card, "nccl", hosts=2)
    gloo = pcomms.effective_bandwidth(rows, 10.0, card, "gloo")
    assert nccl["peak_bytes_per_s"] == 450e9 and nccl["peak_known"]
    assert net["peak_bytes_per_s"] == 50e9
    assert gloo["peak_bytes_per_s"] is None
    for out in (nccl, net, gloo):
        k = {r["kind"]: r for r in out["kinds"]}["all_gather"]
        assert k["effective_bytes_per_s"] == pytest.approx(4096.0 / 0.010)
    assert all(r["link_utilization"] is None for r in gloo["kinds"])
    assert {r["kind"]: r for r in nccl["kinds"]}["all_gather"][
        "link_utilization"] == round(4096.0 / 0.010 / 450e9, 4)
    none = pcomms.effective_bandwidth(rows, None, card, "nccl")
    assert all(r["effective_bytes_per_s"] is None for r in none["kinds"])
    with pytest.raises(ValueError):
        pcomms.effective_bandwidth(rows, 10.0, card, "ici")


def test_fleet_report_comms_block_matches_jax(tmp_path):
    """The same step's collectives priced in each package's payload
    form: the comms blocks agree on every byte and rate."""
    jrun = _make_fleet_run(tmp_path / "j")
    prun = _make_fleet_run(tmp_path / "p")
    extra = {"allreduce": 1024.0}
    (jrun / jagg.COMMS_FILENAME).write_text(json.dumps({
        "per_opcode": _per_opcode(), "extra_claims": extra,
        "device_kind": "cpu", "link": "ici"}))
    (prun / pagg.COMMS_FILENAME).write_text(json.dumps({
        "per_kind": _per_kind(), "extra_claims": extra,
        "device_kind": "cpu", "link": "gloo", "hosts": 1}))
    want = jagg.build_fleet_report(str(jrun))["comms"]
    got = pagg.build_fleet_report(str(prun))["comms"]
    assert pagg.validate_fleet_report(
        pagg.build_fleet_report(str(prun))) is None
    assert got["available"] and want["available"]
    same = ("unattributed_bytes", "total_bytes_per_step", "ms_per_step")
    assert {k: got[k] for k in same} == {k: want[k] for k in same}
    strip = ("opcodes", "link_utilization")
    assert [{k: v for k, v in r.items() if k not in strip}
            for r in got["kinds"]] == [
        {k: v for k, v in r.items() if k not in strip}
        for r in want["kinds"]]
    assert got["link"] == "gloo" and got["peak_bytes_per_s"] is None
    assert "no published peak" in pagg.render_fleet_table(
        pagg.build_fleet_report(str(prun)))


# -- the solver's fleet path on two gloo ranks --------------------------------

G = 2


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    from npairloss_tpu_torch.parallel.launch import RankPool

    root = tmp_path_factory.mktemp("pg")
    p = RankPool(G, f"file://{root}/pg", device="cpu", timeout_s=180)
    yield p
    p.close()


def _tiny(mesh, telemetry=None):
    from npairloss_tpu_torch.config.schema import load_net, load_solver
    from npairloss_tpu_torch.models import get_model
    from npairloss_tpu_torch.train.solver import Solver

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg, _ = load_solver(os.path.join(repo, "examples",
                                      "tiny_solver.prototxt"))
    net = load_net(os.path.join(repo, "examples", "tiny_net.prototxt"))
    model = get_model("mlp", device="cpu", input_shape=(8, 8, 3), seed=0)
    return Solver(model, net.loss.loss, cfg, mesh=mesh, telemetry=telemetry)


def _batches(mesh, n=16):
    from npairloss_tpu_torch.data.loader import shard_batches
    from npairloss_tpu_torch.data.synthetic import synthetic_identity_batches

    return shard_batches(synthetic_identity_batches(
        32, n // 2, 2, (8, 8, 3), noise=2.0, seed=0), mesh.rank, mesh.size)


def _fleet_task(mesh, run_dir, mode):
    """One rank's run; returns what the parent checks."""
    from npairloss_tpu_torch.obs import RunTelemetry

    if mode == "no_fleet":
        # Without a fleet only rank 0 writes (the CLI's rule).
        tel = RunTelemetry(run_dir) if mesh.rank == 0 else None
    else:
        tel = RunTelemetry(run_dir, fleet=True)
    out = {}
    if mode == "late_attach":
        s = _tiny(mesh)
        it = _batches(mesh)
        s.step(*next(it))
        s.telemetry = tel
        s.train(it, num_iters=3, log_fn=lambda line: None)
    elif mode == "reprice":
        s = _tiny(mesh, tel)
        s.step(*next(_batches(mesh, 16)))
        out["big"] = list(s._comm_kinds)
        s.step(*next(_batches(mesh, 8)))
        out["small"] = list(s._comm_kinds)
    else:
        s = _tiny(mesh, tel)
        s.train(_batches(mesh), num_iters=3, log_fn=lambda line: None)
    out["param_bytes"] = sum(p.numel() * p.element_size()
                             for p in s.params.values())
    if tel is not None:
        tel.close()
    return out


@pytest.mark.parametrize("mode", ["train", "late_attach"])
def test_solver_fleet_path_on_two_ranks(pool, tmp_path, mode):
    run = tmp_path / "run"
    outs = pool.run(_fleet_task, str(run), mode)
    for k in range(G):
        rows = [json.loads(ln) for ln in
                (run / f"telemetry.r{k}.jsonl").read_text().splitlines()]
        assert rows and all(r["process_index"] == k for r in rows)
        trace = json.load(open(run / f"trace.r{k}.json"))
        steps = sorted(e["args"]["step"] for e in trace["traceEvents"]
                       if e["name"] in ("step/dispatch", "step/compile"))
        assert steps == ([1, 2, 3] if mode == "train" else [2, 3])
        marks = [e for e in trace["traceEvents"]
                 if e["name"].startswith("comm/") and e["ph"] == "i"]
        priced = 3 if mode == "train" else 2
        assert len({e["args"]["step"] for e in marks}) == priced
        assert sum(e["name"] == "comm/price" for e in trace["traceEvents"]) \
            == 1
    payload = json.load(open(run / pagg.COMMS_FILENAME))
    param_bytes = outs[0]["param_bytes"]
    assert payload["extra_claims"] == {"allreduce": float(param_bytes)}
    assert payload["link"] == "gloo" and payload["mesh_devices"] == G
    # The gradient all-reduce carries exactly the parameter tree.
    ar = payload["per_kind"]["allreduce"]
    assert ar["regions"].get("comm/all_reduce_sum", 0) >= param_bytes
    report = pagg.build_fleet_report(str(run))
    assert pagg.validate_fleet_report(report) is None, report
    assert report["ranks_present"] == [0, 1]
    comms = report["comms"]
    assert comms["available"] and comms["unattributed_bytes"] == 0
    assert all(k["claimed"] and k["scope_coverage"] == 1.0
               for k in comms["kinds"])
    assert {k["kind"] for k in comms["kinds"]} >= {"all_gather", "allreduce"}
    _, merged = pmerge.merge_run_traces(str(run))
    assert validate_chrome_trace(merged) is None


def test_grad_sync_claim_equals_jax_for_the_same_model(pool, tmp_path):
    """The claim is the parameter tree's bytes: the JAX solver's
    ``grad_sync_claim_bytes`` of the same mlp's flax tree."""
    import jax

    from npairloss_tpu.models import get_model as jax_get_model

    outs = pool.run(_fleet_task, str(tmp_path / "run"), "train")
    jmodel = jax_get_model("mlp")
    params = jmodel.init(jax.random.PRNGKey(0),
                         np.zeros((1, 8, 8, 3), np.float32))["params"]
    jbytes = float(sum(x.size * x.dtype.itemsize
                       for x in jax.tree_util.tree_leaves(params)))
    payload = json.load(open(tmp_path / "run" / pagg.COMMS_FILENAME))
    assert payload["extra_claims"] == jcomms.grad_sync_claim_bytes(jbytes, G)
    assert outs[0]["param_bytes"] == jbytes


def test_solver_reprices_on_a_new_batch_shape(pool, tmp_path):
    outs = pool.run(_fleet_task, str(tmp_path / "run"), "reprice")
    big = {k: b for k, b, _ in outs[0]["big"]}
    small = {k: b for k, b, _ in outs[0]["small"]}
    assert big.keys() == small.keys()
    # The all-gather of embeddings shrinks with the batch; the gradient
    # all-reduce does not.
    assert small["all_gather"] < big["all_gather"]
    trace = json.load(open(tmp_path / "run" / "trace.r0.json"))
    last = {e["name"]: e["args"]["bytes"] for e in trace["traceEvents"]
            if e["name"].startswith("comm/") and e["ph"] == "i"}
    assert last == {f"comm/{k}": b for k, b in small.items()}


def test_solver_without_fleet_keeps_its_trace_and_stream(pool, tmp_path):
    run = tmp_path / "run"
    pool.run(_fleet_task, str(run), "no_fleet")
    assert not (run / pagg.COMMS_FILENAME).exists()
    assert not any(".r0." in n for n in os.listdir(run))
    trace = json.load(open(run / "trace.json"))
    assert not any(e["name"].startswith("comm/")
                   for e in trace["traceEvents"])
    for e in trace["traceEvents"]:
        if e["name"] in ("step/dispatch", "step/compile"):
            assert "step" not in e.get("args", {})
