"""The port's run telemetry (``npairloss_tpu_torch/obs/{sinks,tracing,run,
manifest}.py``, ``obs/fleet/stamp.py``) against the JAX package's
contracts: the sink, tracer and run-directory behaviour of
``tests/test_obs.py``, the port's ``trace.json`` accepted by JAX's
``validate_chrome_trace`` (loaded by file path: ``obs/tracing.py`` is
stdlib-only) and the same bad shapes refused by both, and the fleet
streams of two ranks over gloo (``parallel.launch.RankPool``).  Exact
comparisons throughout (no floats are computed here)."""

import importlib.util
import json
import os
import sys

import pytest

from npairloss_tpu_torch.obs import (
    FLEET_KEYS,
    REQUIRED_KEYS,
    CsvSink,
    FleetStamp,
    JsonlSink,
    MultiSink,
    RingBufferSink,
    RunTelemetry,
    SpanTracer,
    fleet_stamp,
    validate_chrome_trace,
)
from npairloss_tpu_torch.obs.fleet import stamp as tstamp
from npairloss_tpu_torch.parallel.launch import RankPool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_module(*parts):
    """A stdlib-only module of the JAX package, loaded by file path."""
    path = os.path.join(REPO, "npairloss_tpu", *parts)
    spec = importlib.util.spec_from_file_location(
        "_jax_" + "_".join(parts).replace(".py", ""), path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


jax_tracing = _jax_module("obs", "tracing.py")
jax_sinks = _jax_module("obs", "sinks.py")


# -- sinks ---------------------------------------------------------------


def test_envelope_keys_are_the_jax_packages():
    assert REQUIRED_KEYS == jax_sinks.REQUIRED_KEYS
    assert FLEET_KEYS == jax_sinks.FLEET_KEYS == tstamp.STAMP_KEYS


def test_jsonl_sink_roundtrip(tmp_path):
    path = tmp_path / "m.jsonl"
    sink = JsonlSink(str(path))
    sink.log({"run_id": "r1", "step": 1, "wall_time": 1.5,
              "phase": "train", "loss": 0.25})
    sink.log({"run_id": "r1", "step": 2, "wall_time": 2.5,
              "phase": "train", "loss": 0.125})
    sink.close()
    rows = [json.loads(l) for l in path.read_text().splitlines()]
    assert len(rows) == 2 and rows[1]["loss"] == 0.125
    for row in rows:
        assert all(k in row for k in REQUIRED_KEYS)


def test_jsonl_sink_appends_across_instances(tmp_path):
    path = str(tmp_path / "m.jsonl")
    for i in range(2):
        s = JsonlSink(path)
        s.log({"i": i})
        s.close()
    assert len(open(path).read().splitlines()) == 2


@pytest.mark.parametrize("impl", ["port", "jax"])
def test_csv_sink_fixed_header(tmp_path, impl):
    cls = CsvSink if impl == "port" else jax_sinks.CsvSink
    path = tmp_path / "m.csv"
    sink = cls(str(path))
    sink.log({"step": 1, "loss": 0.5})
    sink.log({"step": 2, "loss": 0.25, "extra": 9})
    sink.log({"step": 3})
    sink.close()
    assert path.read_text().splitlines() == ["step,loss", "1,0.5", "2,0.25",
                                             "3,"]
    # Appending reuses the file's header, not the first record's order.
    again = cls(str(path))
    again.log({"loss": 0.1, "step": 4})
    again.close()
    assert path.read_text().splitlines()[-1] == "4,0.1"


def test_ring_buffer_eviction():
    ring = RingBufferSink(capacity=4)
    for i in range(10):
        ring.log({"step": i})
    assert [r["step"] for r in ring.records()] == [6, 7, 8, 9]
    assert ring.latest()["step"] == 9 and ring.total_logged == 10
    with pytest.raises(ValueError):
        RingBufferSink(capacity=0)


def test_multiplex_fan_out():
    a, b = RingBufferSink(8), RingBufferSink(8)
    multi = MultiSink([a, b])
    multi.log({"step": 1})
    assert a.latest() == b.latest() == {"step": 1}

    class Boom:
        def log(self, rec):
            raise RuntimeError("boom")

        def flush(self):
            raise RuntimeError("flush boom")

        def close(self):
            pass

    # A failing child does not starve its siblings, on log or flush.
    multi = MultiSink([Boom(), a])
    with pytest.raises(RuntimeError):
        multi.log({"step": 2})
    assert a.latest() == {"step": 2}
    with pytest.raises(RuntimeError, match="flush boom"):
        multi.flush()


# -- tracing -------------------------------------------------------------


def test_tracer_chrome_trace_schema_accepted_by_jax(tmp_path):
    tr = SpanTracer()
    with tr.span("outer", kind="test"):
        with tr.span("inner"):
            pass
    tr.instant("marker", note="x")
    obj = json.load(open(tr.write(str(tmp_path / "trace.json"))))
    assert validate_chrome_trace(obj) is None
    assert jax_tracing.validate_chrome_trace(obj) is None
    events = {e["name"]: e for e in obj["traceEvents"]}
    assert set(events) == {"outer", "inner", "marker"}
    outer, inner = events["outer"], events["inner"]
    assert outer["ph"] == inner["ph"] == "X" and events["marker"]["ph"] == "i"
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3
    assert outer["args"] == {"kind": "test"}
    assert "wall_time_origin" in obj["otherData"]


def test_tracer_event_cap_is_recorded():
    tr = SpanTracer(max_events=2)
    for i in range(5):
        tr.instant(f"e{i}")
    obj = tr.to_chrome_trace()
    assert len(obj["traceEvents"]) == 2 and tr.dropped == 3
    assert obj["otherData"]["dropped_events"] == 3
    assert jax_tracing.validate_chrome_trace(obj) is None


BAD_TRACES = [
    [],
    {"traceEvents": {}},
    {"traceEvents": [{}]},
    {"traceEvents": ["x"]},
    {"traceEvents": [{"name": "a", "ph": "X", "ts": 0}]},  # X without dur
    {"traceEvents": [{"name": "a", "ph": "i", "ts": "0"}]},
]


@pytest.mark.parametrize("bad", BAD_TRACES)
def test_bad_trace_shapes_refused_by_both(bad):
    got, want = validate_chrome_trace(bad), jax_tracing.validate_chrome_trace(
        bad)
    assert got is not None and got == want


# -- run telemetry -------------------------------------------------------


def test_run_telemetry_dir_contract(tmp_path):
    run_dir = tmp_path / "run"
    with RunTelemetry(str(run_dir)) as tel:
        tel.write_manifest(config={"model": "mlp"}, extra={"note": "t"})
        with tel.span("step/dispatch", batch=4):
            pass
        tel.instant("step/recompile", batch=2)
        tel.log("train", 1, {"loss": 0.5})
        tel.log("eval", 1, {"loss": 0.4}, eval_batches=2)
    manifest = json.load(open(run_dir / "manifest.json"))
    assert manifest["run_id"] == tel.run_id
    assert manifest["config"] == {"model": "mlp"}
    assert manifest["extra"] == {"note": "t"}
    assert manifest["package_version"] == "0.1.0"
    assert manifest["git_sha"] is None or len(manifest["git_sha"]) == 40
    assert manifest["topology"]["torch"]
    assert manifest["fleet"] is None
    rows = [json.loads(l)
            for l in open(run_dir / "metrics.jsonl").read().splitlines()]
    assert [r["phase"] for r in rows] == ["train", "eval"]
    for row in rows:
        assert all(k in row for k in REQUIRED_KEYS)
        assert row["run_id"] == tel.run_id
        assert not set(FLEET_KEYS) & set(row)
    assert rows[1]["eval_batches"] == 2
    trace = json.load(open(run_dir / "trace.json"))
    assert jax_tracing.validate_chrome_trace(trace) is None
    assert [e["name"] for e in trace["traceEvents"]] == [
        "step/dispatch", "step/recompile"]
    assert tel.ring.latest()["phase"] == "eval"
    assert sorted(os.listdir(run_dir)) == ["manifest.json", "metrics.jsonl",
                                           "trace.json"]


def test_run_telemetry_envelope_wins_over_metric_collision(tmp_path):
    tel = RunTelemetry(str(tmp_path / "r"), metrics=False, trace=False)
    rec = tel.log("train", 7, {"step": 999, "loss": 1.0})
    assert rec["step"] == 7 and rec["loss"] == 1.0
    assert tel.ring.latest()["step"] == 7
    with tel.span("x"):  # no tracer: a no-op context
        pass
    tel.instant("y")
    tel.close()
    assert os.listdir(tmp_path / "r") == []


def test_trace_only_writes_no_metrics(tmp_path):
    tel = RunTelemetry(str(tmp_path / "t"), metrics=False)
    assert not tel.metrics_enabled
    tel.log("train", 1, {"loss": 0.5})  # the ring still keeps it
    with tel.span("data/next_batch"):
        pass
    tel.close()
    tel.close()  # idempotent
    assert os.listdir(tmp_path / "t") == ["trace.json"]
    assert tel.ring.total_logged == 1


# -- fleet ---------------------------------------------------------------


def test_fleet_stamp_resolution(monkeypatch):
    import torch.distributed as dist

    jax_stamp = _jax_module("obs", "fleet", "stamp.py")
    monkeypatch.delenv(tstamp.FLEET_PROCESS_ENV, raising=False)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    assert fleet_stamp() is None  # no process group
    assert tstamp.resolve_fleet(None) is None
    assert tstamp.resolve_fleet(False) is None
    assert tstamp.resolve_fleet(True) == FleetStamp(0, 1)
    monkeypatch.setenv(tstamp.FLEET_PROCESS_ENV, "1/3")
    assert fleet_stamp() == FleetStamp(1, 3)
    assert fleet_stamp().to_dict() == jax_stamp.fleet_stamp().to_dict()
    monkeypatch.setenv(tstamp.FLEET_PROCESS_ENV, "1-3")
    with pytest.raises(ValueError, match="rank"):
        fleet_stamp()
    with pytest.raises(ValueError):
        FleetStamp(3, 3)
    with pytest.raises(TypeError):
        tstamp.resolve_fleet("yes")
    for r in (0, 7):
        assert tstamp.rank_metrics_name(r) == jax_stamp.rank_metrics_name(r)
        assert tstamp.rank_trace_name(r) == jax_stamp.rank_trace_name(r)
        assert tstamp.rank_manifest_name(r) == \
            jax_stamp.rank_manifest_name(r)
    assert tstamp.rank_of_file("telemetry.r12.jsonl") == 12
    assert tstamp.rank_of_file("metrics.jsonl") is None


def test_fleet_run_dir_layout_in_one_process(tmp_path):
    run = tmp_path / "f"
    with RunTelemetry(str(run), fleet=FleetStamp(0, 1, (0,))) as tel:
        tel.write_manifest(config={})
        tel.log("train", 1, {"loss": 0.5})
    assert sorted(os.listdir(run)) == ["manifest.r0.json",
                                       "telemetry.r0.jsonl", "trace.r0.json"]
    row = json.loads(open(run / "telemetry.r0.jsonl").readline())
    assert {k: row[k] for k in FLEET_KEYS} == {
        "process_index": 0, "process_count": 1, "local_device_ids": [0]}
    trace = json.load(open(run / "trace.r0.json"))
    assert trace["otherData"]["fleet"]["process_count"] == 1
    assert json.load(open(run / "manifest.r0.json"))["fleet"][
        "process_index"] == 0
    assert tstamp.discover_ranks(str(run)) == [0]


def _rank_telemetry(mesh, run_dir):
    """On each rank: the ambient stamp (the gloo group's rank and size),
    then a fleet run dir shared by the ranks."""
    stamp = fleet_stamp()
    with RunTelemetry(run_dir, run_id="fleet-run", fleet=True) as tel:
        tel.write_manifest(config={"rank": mesh.rank})
        with tel.span("step/dispatch", step=1):
            pass
        tel.log("train", 1, {"loss": float(mesh.rank)})
    return stamp.to_dict()


def _rank_mesh_train(mesh, run_dir):
    """On each rank: 3 steps of a mesh Solver (dense engine, health on)
    with a fleet-stamped RunTelemetry in the shared run dir."""
    from npairloss_tpu_torch.data.loader import shard_batches
    from npairloss_tpu_torch.data.synthetic import synthetic_identity_batches
    from npairloss_tpu_torch.models import get_model
    from npairloss_tpu_torch.obs import HealthConfig
    from npairloss_tpu_torch.ops.npair_loss import NPairLossConfig
    from npairloss_tpu_torch.train.solver import Solver, SolverConfig

    solver = Solver(
        get_model("mlp", device="cpu", input_shape=(16,), hidden=(16,),
                  embedding_dim=8, seed=0), NPairLossConfig(),
        SolverConfig(base_lr=0.05, lr_policy="fixed", display=1,
                     test_interval=0, snapshot=0),
        mesh=mesh, health=HealthConfig(mining_health=True))
    with RunTelemetry(run_dir, run_id="mesh", fleet=True) as tel:
        solver.telemetry = tel
        solver.train(shard_batches(synthetic_identity_batches(
            16, 8, 2, (16,), seed=2), mesh.rank, mesh.size), 3,
            log_fn=lambda line: None)
    return mesh.rank


def test_fleet_streams_of_two_ranks_over_gloo(tmp_path):  # slow-ok: the fleet streams of two gloo ranks
    run = str(tmp_path / "fleet")
    mesh_run = str(tmp_path / "mesh")
    with RankPool(2, f"file://{tmp_path}/pg", device="cpu",
                  timeout_s=180) as pool:
        stamps = pool.run(_rank_telemetry, run)
        assert pool.run(_rank_mesh_train, mesh_run) == [0, 1]
    # Every rank of a mesh run writes its own stream; the reported
    # metrics (health included) are the ranks' mean, the same on both.
    assert tstamp.discover_ranks(mesh_run) == [0, 1]
    streams = []
    for r in (0, 1):
        rows = [json.loads(l) for l in open(
            os.path.join(mesh_run, tstamp.rank_metrics_name(r)))]
        assert [x["phase"] for x in rows] == ["train"] * 3
        assert all(x["process_index"] == r for x in rows)
        assert {"grad_norm", "update_ratio", "emb_mag_max",
                "ap_an_margin_p10", "an_saturation"} <= set(rows[0])
        streams.append([{k: v for k, v in x.items() if k not in (
            "wall_time", "process_index", "local_device_ids")}
            for x in rows])
    assert streams[0] == streams[1]
    assert [(s["process_index"], s["process_count"]) for s in stamps] == [
        (0, 2), (1, 2)]
    assert tstamp.discover_ranks(run) == [0, 1]
    assert "metrics.jsonl" not in os.listdir(run)
    for r in (0, 1):
        rows = [json.loads(l) for l in open(
            os.path.join(run, tstamp.rank_metrics_name(r)))]
        assert len(rows) == 1 and rows[0]["loss"] == float(r)
        assert rows[0]["process_index"] == r
        assert rows[0]["process_count"] == 2
        assert all(k in rows[0] for k in REQUIRED_KEYS + FLEET_KEYS)
        trace = json.load(open(os.path.join(run, tstamp.rank_trace_name(r))))
        assert jax_tracing.validate_chrome_trace(trace) is None
        assert trace["otherData"]["fleet"]["process_index"] == r
        man = json.load(open(os.path.join(run, tstamp.rank_manifest_name(r))))
        assert man["fleet"]["process_index"] == r
        assert man["topology"]["process_count"] == 2
        assert man["config"] == {"rank": r}
