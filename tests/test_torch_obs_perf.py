"""The port's perf observatory, training side
(``npairloss_tpu_torch/obs/perf/{count,costs,roofline,decompose,report}.py``)
against the JAX package's ``obs/perf``.

  * the roofline fixtures of ``tests/test_perf.py`` on the H100 SXM's
    peaks; ``mfu_from_timing``;
  * ``decompose_step_time`` equal to JAX's on the same event lists and
    on a trace the port's ``train`` recorded (exact: the same
    arithmetic on the same numbers);
  * ``region_of`` equal to JAX's on the same op-name strings;
  * the step count: matmul and convolution FLOPs equal to the analytic
    formula on a tiny net (exact integers), every region's FLOPs landing
    where its forward ran (backward included), the regions summing to
    the total exactly; the blockwise engine's count with the kernels'
    formulas equal to the count of its plain sweeps' own products; a
    counted step bit-identical to an uncounted one; with ``remat`` the
    recompute counted;
  * the port's count of a ``googlenet_bn`` training step at batch 4,
    64x64 against XLA's ``cost_analysis`` of the JAX step: the port's
    counts every tap of a padded convolution and no elementwise op, so
    the two differ; the ratio is held inside [1.0, 1.25];
  * ``prof --step train --model mlp --device cpu``'s report accepted by
    JAX's ``validate_report``.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.nn as nn

from npairloss_tpu_torch import cli
from npairloss_tpu_torch.data.synthetic import synthetic_identity_batches
from npairloss_tpu_torch.models import get_model
from npairloss_tpu_torch.models.layers import ConvBlock
from npairloss_tpu_torch.obs import RunTelemetry
from npairloss_tpu_torch.obs.perf import count as tcount
from npairloss_tpu_torch.obs.perf import costs, decompose, roofline
from npairloss_tpu_torch.obs.perf.count import StepCounter
from npairloss_tpu_torch.obs.perf.report import validate_report
from npairloss_tpu_torch.ops import blockwise_npair as bw
from npairloss_tpu_torch.ops.npair_loss import (
    MiningMethod,
    MiningRegion,
    NPairLossConfig,
)
from npairloss_tpu_torch.train.solver import Solver, SolverConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = "NVIDIA H100 80GB HBM3"


# -- roofline and MFU --------------------------------------------------------


def test_roofline_classification_fixtures():
    spec = roofline.chip_peaks(H100)
    assert spec.known and spec.flops == 989e12
    assert spec.hbm_bytes_per_s == 3.35e12
    assert roofline.interconnect_peak(spec, "nvlink") == 450e9
    assert roofline.interconnect_peak(spec, "network") == 50e9
    with pytest.raises(ValueError):
        roofline.interconnect_peak(spec, "ici")
    c = roofline.classify(flops=spec.flops, bytes_accessed=1.0, spec=spec)
    assert c["bound"] == "compute"
    assert c["ai"] == pytest.approx(spec.flops)
    assert c["est_ms_at_roofline"] == pytest.approx(1e3)
    assert roofline.classify(flops=1e9, bytes_accessed=1e9,
                             spec=spec)["bound"] == "memory"
    i = roofline.classify(flops=1.0, bytes_accessed=1.0,
                          collective_bytes=spec.ici_bytes_per_s, spec=spec)
    assert i["bound"] == "collective"
    assert i["est_ms_at_roofline"] == pytest.approx(1e3)
    assert roofline.classify(0.0, 0.0, 0.0, spec)["bound"] == "unknown"
    # A tie on the ridge is compute, as in JAX.
    assert roofline.classify(spec.ridge_ai, 1.0, spec=spec)["bound"] == \
        "compute"
    for kind in ("cpu", "", "NVIDIA A100-SXM4-80GB"):
        assert not roofline.chip_peaks(kind).known
        assert roofline.chip_peaks(kind).flops == spec.flops


def test_bound_classes_are_the_jax_schemas():
    from npairloss_tpu.obs.perf import roofline as jroof

    assert roofline.BOUND_CLASSES == jroof.BOUND_CLASSES


def test_mfu_from_timing():
    est = costs.mfu_from_timing(flops=989e12 / 2, seconds=1.0,
                                device_kind=H100)
    assert est == {"step_flops": 989e12 / 2, "mfu": pytest.approx(0.5)}
    assert costs.mfu_from_timing(flops=1e12, seconds=0.5, steps=2,
                                 device_kind=H100)["mfu"] == \
        pytest.approx(4e12 / 989e12)
    for kw in (dict(device_kind="cpu"), dict(device_kind=""),
               dict(device_kind=H100, seconds=0.0),
               dict(device_kind=H100, flops=None)):
        args = {"flops": 1e12, "seconds": 1.0, **kw}
        assert costs.mfu_from_timing(**args)["mfu"] is None
    assert costs.peak_flops("NVIDIA H100 PCIe") == 989e12
    assert costs.peak_flops("cpu") is None


# -- decomposition ---------------------------------------------------------


def _ev(name, ts, dur, tid=1):
    return {"name": name, "ph": "X", "ts": ts, "dur": dur, "tid": tid}


EVENT_LISTS = {
    "nested": [
        _ev("data/next_batch", 0, 1000), _ev("step/dispatch", 1000, 2000),
        _ev("step/device_wait", 3000, 4000), _ev("eval", 7000, 3000),
        _ev("eval/compile", 7500, 1000),
        _ev("pipeline/stage", 0, 9000, tid=2)],
    "pipelined": [
        _ev("data/next_batch", 0, 10), _ev("step/compile", 10, 500),
        _ev("step/cost_analysis", 20, 300),
        _ev("step/dispatch", 600, 50), _ev("step/window_sync", 700, 90),
        _ev("snapshot", 800, 40), _ev("comm/all_gather", 900, 5),
        _ev("step/recompile", 950, 1), _ev("mystery", 960, 7)],
    "empty": [],
}


@pytest.mark.parametrize("case", sorted(EVENT_LISTS))
@pytest.mark.parametrize("wall_ms", [12.0, 0.5])
def test_decompose_equals_jax(case, wall_ms):
    from npairloss_tpu.obs.perf import decompose as jdec

    events = EVENT_LISTS[case]
    got = decompose.decompose_step_time(events, wall_ms)
    assert got == jdec.decompose_step_time(events, wall_ms)
    assert sum(got["parts"].values()) + got["unattributed_ms"] == \
        pytest.approx(got["wall_ms"], abs=1e-6)
    assert decompose.SPAN_CATEGORIES == jdec.SPAN_CATEGORIES
    assert decompose.STEP_CATEGORIES == jdec.STEP_CATEGORIES


def test_decompose_of_a_port_recorded_trace_equals_jax(tmp_path,
                                                      monkeypatch):
    from npairloss_tpu.obs.perf import decompose as jdec

    monkeypatch.chdir(REPO)
    run = tmp_path / "tr"
    assert cli.main(["train", "--solver", "examples/tiny_solver.prototxt",
                     "--model", "mlp", "--synthetic", "--device", "cpu",
                     "--max_iter", "6", "--pipeline",
                     "--trace-dir", str(run)]) == 0
    events = json.load(open(run / "trace.json"))["traceEvents"]
    names = {e["name"] for e in events}
    assert {"data/next_batch", "step/compile", "step/dispatch",
            "step/window_sync", "eval", "pipeline/stage"} <= names
    wall = max(e["ts"] + e.get("dur", 0) for e in events) / 1e3
    got = decompose.decompose_step_time(events, wall)
    assert got == jdec.decompose_step_time(events, wall)
    assert {"data_wait", "compile", "dispatch", "window_sync",
            "eval"} <= set(got["parts"])


def test_region_of_equals_jax():
    from npairloss_tpu.obs.perf.hlo import UNSCOPED, region_of as jregion

    strings = [
        "jit(step)/jit(main)/jvp(npair/sim)/dot_general",
        "jit(step)/transpose(jvp(GoogLeNet))/inception_3a/b1x1/conv",
        "jit(step)/optim/update/add", "jit(step)/mul", "", "jit(step)",
        "step/a/b/c/d", "jit(f)/while/body/npair/loss/exp",
        "jit(step)/_private/x/y", tcount.scope_op_name(None),
        tcount.scope_op_name("inception_4e/b3x3_reduce"),
        tcount.scope_op_name("lrn"),
    ]
    assert tcount.UNSCOPED == UNSCOPED
    for s in strings:
        for depth in (0, 1, 2, 3):
            assert tcount.region_of(s, depth) == jregion(s, depth), (s, depth)


# -- the step count --------------------------------------------------------


def _conv_flops(n, ho, wo, cin, cout, kh, kw):
    return 2 * n * ho * wo * cin * cout * kh * kw


def test_conv_and_matmul_flops_are_the_analytic_formula():
    """ConvBlock "blk" (3x3 SAME, 3 -> 4 channels) then a linear head,
    forward and backward: the conv's forward and weight gradient (its
    input needs none) count in "blk", the head's three gemms unscoped."""
    torch.manual_seed(0)
    blk = ConvBlock(3, 4, (3, 3), path="blk")
    head = nn.Linear(4 * 6 * 6, 5)
    x = torch.randn(2, 6, 6, 3)
    with StepCounter() as c:
        y = head(blk(x).reshape(2, -1))
        y.square().sum().backward()
    conv = _conv_flops(2, 6, 6, 3, 4, 3, 3)
    gemm = 2 * 2 * (4 * 6 * 6) * 5
    regions = c.regions()
    assert regions["blk"]["flops"] == 2 * conv
    assert regions[tcount.UNSCOPED]["flops"] == 3 * gemm
    assert c.flops == 2 * conv + 3 * gemm
    assert sum(r["flops"] for r in regions.values()) == c.flops
    assert sum(r["bytes"] for r in regions.values()) == c.bytes > 0
    assert c.collective_bytes == 0
    # The per-op tally holds the same totals, the conv's forward apart.
    assert c.ops["aten.convolution"][1] == conv
    assert sum(v[1] for v in c.ops.values()) == c.flops
    assert sum(v[2] for v in c.ops.values()) == c.bytes


def _bw_cfg(region):
    return NPairLossConfig(ap_mining_method=MiningMethod.RELATIVE_HARD,
                           an_mining_method=MiningMethod.RELATIVE_HARD,
                           ap_mining_region=region, an_mining_region=region)


@pytest.mark.parametrize("cache", [True, False], ids=["cached", "recompute"])
@pytest.mark.parametrize("precision", [None, "default"])
@pytest.mark.parametrize("region", [MiningRegion.LOCAL, MiningRegion.GLOBAL])
def test_blockwise_formulas_equal_the_plain_sweeps_products(
        monkeypatch, cache, precision, region):
    rng = np.random.default_rng(0)
    f = torch.from_numpy(rng.standard_normal((24, 8)).astype(np.float32))
    lab = torch.arange(24) // 2

    def step():
        x = f.clone().requires_grad_()
        loss, _ = bw.blockwise_npair_loss_with_aux(
            x, lab, _bw_cfg(region), block_size=8, sim_cache=cache,
            pos_topk=0, matmul_precision=precision)
        loss.backward()
        return x.grad

    with StepCounter() as priced:
        g1 = step()
    assert set(priced.kernels) >= {"npair_stats", "npair_hist", "npair_loss",
                                   "npair_gq", "npair_gdb"}
    assert ("round_bf16" in priced.kernels) == (precision == "default")
    assert priced.kernels["npair_hist"][0] == 7  # digits 1..7, both sides
    monkeypatch.setattr(tcount, "kernel", lambda name, cost: tcount._NULL)
    with StepCounter() as plain:
        g2 = step()
    assert plain.kernels == {}
    assert priced.flops == plain.flops > 0
    assert torch.equal(g1, g2)
    n, d = 24, 8
    prods = sum(k[1] for k in priced.kernels.values())
    # stats; 7 hist digits and the loss without the cache; gq and gdb,
    # each with its recompute pass without the cache.
    assert prods == 2 * n * n * d * (3 if cache else 13)


def _solver(engine="dense", model="mlp", perf=False, tmp=None, **kw):
    shape = (16,) if model == "mlp" else (32, 32, 3)
    mkw = (dict(input_shape=shape, hidden=(32,), embedding_dim=8)
           if model == "mlp" else kw.pop("model_kw", {}))
    m = get_model(model, device="cpu", seed=0, **mkw)
    tel = RunTelemetry(str(tmp)) if perf else None
    cfg = SolverConfig(base_lr=0.05, lr_policy="fixed", display=0,
                       test_interval=0, snapshot=0)
    return Solver(m, NPairLossConfig(), cfg, engine=engine, telemetry=tel,
                  perf_metrics=perf, **kw), shape


@pytest.mark.parametrize("engine,model", [
    ("dense", "mlp"), ("blockwise", "mlp"),
    ("dense", "googlenet_pallas")])
def test_counted_step_is_bit_identical(tmp_path, engine, model):
    batches = {}
    states = []
    for perf in (False, True):
        solver, shape = _solver(engine, model, perf, tmp_path / str(perf))
        b = batches.setdefault("b", next(synthetic_identity_batches(
            4, 4, 2, shape, seed=1)))
        m = solver.step(*b)
        states.append(({k: float(v) for k, v in m.items()},
                       solver.state_dict()))
        if perf:
            c = solver.step_count
            assert c is not None and solver._step_flops == c.flops > 0
            regions = c.regions(depth=2)
            assert sum(r["flops"] for r in regions.values()) == c.flops
            assert "npair" in regions and "optim/update" in regions
            if model == "googlenet_pallas":
                assert {"conv1", "lrn", "inception_3a/b3x3"} <= set(regions)
                assert {"lrn_fwd_cached", "lrn_bwd_cached",
                        "fused_bias_relu", "fused_bias_relu_pool"} <= \
                    set(c.kernels)
        else:
            assert solver.step_count is None
    (m0, s0), (m1, s1) = states
    assert m0 == m1
    assert all(torch.equal(s0[k], s1[k]) for k in s0)


def test_remat_recompute_is_counted():
    torch.backends.mkldnn.enabled = False
    try:
        flops = {}
        for remat in (False, True):
            solver, shape = _solver(
                model="googlenet_bn",
                model_kw=dict(remat=remat, dtype=torch.float32))
            x, lab = next(synthetic_identity_batches(4, 4, 2, shape, seed=1))
            with StepCounter() as c:
                solver.step(x, lab)
            flops[remat] = c.flops
    finally:
        torch.backends.mkldnn.enabled = True
    # Each inception block's forward runs again in the backward.
    assert flops[False] < flops[True] < 1.5 * flops[False]


def test_googlenet_bn_count_against_xla_cost_analysis():
    import jax

    from npairloss_tpu.models import get_model as jax_get_model
    from npairloss_tpu.obs.perf.costs import cost_flops
    from npairloss_tpu.train import Solver as JaxSolver
    from npairloss_tpu.train import SolverConfig as JaxSolverConfig

    shape, batch = (64, 64, 3), 4
    x, lab = next(synthetic_identity_batches(2, 2, 2, shape, seed=0))
    js = JaxSolver(jax_get_model("googlenet_bn"), NPairLossConfig(),
                   JaxSolverConfig(display=0, snapshot=0), input_shape=shape)
    js.init(x[:2])
    js._make_step()
    xla = cost_flops(js._step_fn.lower(
        js.state, jax.ShapeDtypeStruct((batch, *shape), np.float32),
        jax.ShapeDtypeStruct((batch,), np.int32)))
    torch.backends.mkldnn.enabled = False
    try:
        solver, _ = _solver(model="googlenet_bn",
                            model_kw=dict(dtype=torch.float32))
        with StepCounter() as c:
            solver.step(x, lab)
    finally:
        torch.backends.mkldnn.enabled = True
    ratio = c.flops / xla
    assert 1.0 <= ratio <= 1.25, (c.flops, xla, ratio)


def test_prof_report_passes_the_jax_validator(tmp_path, capsys):
    from npairloss_tpu.obs.perf.report import validate_report as jvalidate

    out = tmp_path / "prof"
    assert cli.main(["prof", "--step", "train", "--model", "mlp",
                     "--image", "16", "--batch", "8", "--steps", "3",
                     "--device", "cpu", "--out", str(out)]) == 0
    tail = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    report = json.load(open(tail["report"]))
    assert validate_report(report) is None
    assert jvalidate(report) is None
    assert report["schema"] == "npairloss-perf-report-v1"
    assert report["peaks"]["known"] is False
    tot = report["totals"]
    assert tot["flops_counted"] == tot["flops_attributed"] > 0
    assert {r["region"] for r in report["regions"]} >= {
        "npair", "optim/update", "optim/apply", tcount.UNSCOPED}
    dec = report["decomposition"]
    assert {"compile", "dispatch", "device_compute"} <= set(dec["parts"])
    assert "mfu" not in report["timing"]  # no peak for the CPU
    assert os.path.exists(out / "perf_report.txt")
    assert (out / "run" / "trace.json").exists()
    bad = json.loads(json.dumps(report))
    bad["decomposition"]["unattributed_ms"] += 5.0
    assert "reconcile" in validate_report(bad) == jvalidate(bad)
    with pytest.raises(SystemExit):  # the quality observatory is not ported
        cli.main(["prof", "--quality", str(out), "--device", "cpu"])
