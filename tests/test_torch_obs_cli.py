"""The port's telemetry flags of ``train`` and the ``time`` record
(``npairloss_tpu_torch/cli.py``) against the JAX CLI's
(``tests/test_obs.py``'s CLI cases, ``tests/test_perf.py``'s perf rows).

``train --solver examples/tiny_solver.prototxt --synthetic
--telemetry-dir --health-metrics`` in both CLIs: the same phases in the
same order with the same row keys and the same trace span names (the JAX
CLI shards over the 8 test devices, so values differ; the streams'
shapes do not).  The flag refusals and the file layouts exactly."""

import io
import json
import os
from contextlib import redirect_stdout

import numpy as np
import pytest

from npairloss_tpu import cli as jax_cli
from npairloss_tpu.obs.tracing import validate_chrome_trace as jvalidate
from npairloss_tpu_torch import cli
from npairloss_tpu_torch.obs import REQUIRED_KEYS, sinks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = ["train", "--solver", "examples/tiny_solver.prototxt", "--synthetic"]


@pytest.fixture(autouse=True)
def _repo_cwd(monkeypatch):
    monkeypatch.chdir(REPO)


def _run(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue().strip().splitlines()


def _rows(path):
    return [json.loads(ln) for ln in open(path).read().splitlines()]


def test_telemetry_dir_rows_and_spans_match_the_jax_cli(tmp_path):
    runs = {}
    for name, main, extra in (("jax", jax_cli.main, ["--mesh", "1"]),
                              ("port", cli.main, ["--device", "cpu"])):
        run = tmp_path / name
        rc, _ = _run(main, TRAIN + ["--telemetry-dir", str(run),
                                    "--health-metrics", *extra])
        assert rc == 0
        runs[name] = run
    shape = {}
    for name, run in runs.items():
        rows = _rows(run / "metrics.jsonl")
        shape[name] = [(r["phase"], r["step"], sorted(r)) for r in rows]
        trace = json.load(open(run / "trace.json"))
        assert jvalidate(trace) is None
        shape[name + "_spans"] = sorted({e["name"] for e in
                                         trace["traceEvents"]})
        man = json.load(open(run / "manifest.json"))
        assert man["config"]["health_metrics"] is True
        assert man["config"]["solver"]["max_iter"] == 10
        assert man["config"]["engine"] in ("dense", None)
    assert shape["port"] == shape["jax"]
    assert [p for p, _, _ in shape["port"]].count("train") == 10
    assert shape["port_spans"] == shape["jax_spans"]
    assert {"data/next_batch", "step/compile", "step/dispatch",
            "eval"} <= set(shape["port_spans"])
    for r in _rows(runs["port"] / "metrics.jsonl"):
        assert all(k in r for k in REQUIRED_KEYS)
        assert all(np.isfinite(v) for v in r.values()
                   if isinstance(v, float))
        if r["phase"] == "train":
            assert {"grad_norm", "update_ratio", "emb_mag_mean",
                    "ap_threshold_mean"} <= set(r)


def test_trace_dir_alone(tmp_path):
    run = tmp_path / "tr"
    rc, out = _run(cli.main, TRAIN + ["--device", "cpu", "--trace-dir",
                                      str(run)])
    assert rc == 0 and json.loads(out[-1])["loss"] >= 0
    assert os.listdir(run) == ["trace.json"]
    assert jvalidate(json.load(open(run / "trace.json"))) is None


def test_telemetry_and_trace_dirs_together_are_refused(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(TRAIN + ["--device", "cpu", "--telemetry-dir",
                          str(tmp_path / "a"), "--trace-dir",
                          str(tmp_path / "b")])
    assert e.value.code == 2
    assert "not allowed with argument" in capsys.readouterr().err
    assert not (tmp_path / "a").exists() and not (tmp_path / "b").exists()


@pytest.mark.parametrize("extra", [[], ["--trace-dir", "TR"]],
                         ids=["no_dir", "trace_dir"])
def test_perf_metrics_without_a_run_dir_is_refused(tmp_path, caplog,
                                                   extra):
    extra = [str(tmp_path / a) if a == "TR" else a for a in extra]
    rc, _ = _run(cli.main, TRAIN + ["--device", "cpu", "--perf-metrics",
                                    *extra])
    assert rc == 2
    assert "--perf-metrics needs --telemetry-dir" in caplog.text


def test_perf_and_mining_rows(tmp_path):
    run = tmp_path / "perf"
    rc, _ = _run(cli.main, TRAIN + ["--device", "cpu", "--telemetry-dir",
                                    str(run), "--mining-health",
                                    "--perf-metrics"])
    assert rc == 0
    rows = _rows(run / "metrics.jsonl")
    perf = [r for r in rows if r["phase"] == "perf"]
    # One row per display window after the first (display 5, 10 steps).
    assert [r["step"] for r in perf] == [10]
    assert perf[0]["step_flops"] > 0 and perf[0]["ms_per_step"] > 0
    assert "mfu" not in perf[0]  # no peak for the CPU
    train = [r for r in rows if r["phase"] == "train"]
    assert {"ap_an_margin_mean", "ap_an_margin_p10", "an_saturation",
            "grad_norm"} <= set(train[0])
    names = {e["name"] for e in json.load(
        open(run / "trace.json"))["traceEvents"]}
    assert "step/cost_analysis" in names


def test_fleet_flag_in_one_process(tmp_path):
    run = tmp_path / "fleet"
    rc, _ = _run(cli.main, TRAIN + ["--device", "cpu", "--telemetry-dir",
                                    str(run), "--fleet", "--max_iter", "2"])
    assert rc == 0
    assert sorted(os.listdir(run)) == ["manifest.r0.json",
                                       "telemetry.r0.jsonl", "trace.r0.json"]
    row = _rows(run / "telemetry.r0.jsonl")[0]
    assert {k: row[k] for k in ("process_index", "process_count")} == {
        "process_index": 0, "process_count": 1}


def test_a_sink_failure_latches_and_training_goes_on(tmp_path, monkeypatch,
                                                     caplog):
    calls = {"n": 0}
    real = sinks.JsonlSink.log

    def flaky(self, record):
        calls["n"] += 1
        if calls["n"] > 2:
            raise OSError("disk full")
        real(self, record)

    monkeypatch.setattr(sinks.JsonlSink, "log", flaky)
    run = tmp_path / "full"
    rc, out = _run(cli.main, TRAIN + ["--device", "cpu", "--telemetry-dir",
                                      str(run)])
    assert rc == 0 and "loss" in json.loads(out[-1])
    assert len(_rows(run / "metrics.jsonl")) == 2
    assert calls["n"] == 3  # latched after the first failure
    assert "telemetry metric emission failed" in caplog.text
    assert jvalidate(json.load(open(run / "trace.json"))) is None


def test_time_record_has_the_step_count():
    rc, out = _run(cli.main, ["time", "--solver",
                              "examples/tiny_solver.prototxt", "--model",
                              "mlp", "--device", "cpu", "--iterations", "2",
                              "--batch", "8"])
    assert rc == 0
    rec = json.loads(out[-1])
    assert rec["step_flops"] > 0 and "mfu" not in rec
    assert rec["device"] == "cpu:cpu"
