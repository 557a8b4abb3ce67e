"""The port's training-health signals (``npairloss_tpu_torch/obs/health.py``
and the Solver's use of them) against the JAX package's
``obs/health.py`` and ``Solver(health=...)``.

Tolerances: the health functions on the same NumPy inputs within 1e-5
relative (fp32 reductions summed in another order); the pair-hardness
stats on thresholds from each package's own dense engine within 1e-5;
a Solver step with ``HealthConfig()`` from the same weights within 1e-5
on ``mlp`` and, with both trunks computing in fp64 (as
``tests/test_torch_bn_solver.py`` does, for the same reason), on
``googlenet_bn`` cut to 32x32 images (its widths are fixed, so the
input is what is cut) — the same key set, every value within
tolerance.  Within the port: health off leaves the record stream and the
parameters exactly as without telemetry; health on changes no
parameter bit; the synchronous and pipelined loops emit the same
records and telemetry rows byte for byte."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npairloss_tpu.data import synthetic_identity_batches as jax_batches
from npairloss_tpu.models import get_model as jax_get_model
from npairloss_tpu.models import precision as jprec
from npairloss_tpu.obs import health as jhealth
from npairloss_tpu.ops.npair_loss import MiningMethod as JMethod
from npairloss_tpu.ops.npair_loss import MiningRegion as JRegion
from npairloss_tpu.ops.npair_loss import NPairLossConfig as JaxLossConfig
from npairloss_tpu.ops.npair_loss import npair_loss_with_aux as jax_loss
from npairloss_tpu.train import Solver as JaxSolver
from npairloss_tpu.train import SolverConfig as JaxSolverConfig
from npairloss_tpu_torch.data.synthetic import synthetic_identity_batches
from npairloss_tpu_torch.models import get_model
from npairloss_tpu_torch.models import precision as tprec
from npairloss_tpu_torch.obs import RunTelemetry
from npairloss_tpu_torch.obs import health as thealth
from npairloss_tpu_torch.ops.npair_loss import (
    MiningMethod,
    MiningRegion,
    NPairLossConfig,
    npair_loss_with_aux,
)
from npairloss_tpu_torch.train.solver import Solver, SolverConfig

TOL = 1e-5
HEALTH_KEYS = {"grad_norm", "param_norm", "update_norm", "update_ratio",
               "emb_mag_mean", "emb_mag_max", "mined_pos_per_query",
               "mined_neg_per_query", "ap_threshold_mean",
               "an_threshold_mean"}
MINING_KEYS = {"ap_an_margin_mean", "ap_an_margin_p10", "an_saturation"}


def _close(got, want, what=""):
    np.testing.assert_allclose(float(got), float(want), rtol=TOL, atol=TOL,
                               err_msg=what)


def _same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], k)


# -- the functions ---------------------------------------------------------


@pytest.mark.parametrize("cfg", [
    dict(), dict(grad_norm=False), dict(param_norm=False),
    dict(update_ratio=False), dict(param_norm=False, update_ratio=False)])
def test_update_health_matches_jax(cfg):
    rng = np.random.default_rng(0)
    shapes = [(16, 8), (8,), (3, 3, 4, 4), (4,)]
    trees = [[rng.standard_normal(s).astype(np.float32) * scale
              for s in shapes] for scale in (1e-2, 1.0, 1e-3)]
    grads, params, updates = trees
    jtree = [{f"p{i}": jnp.asarray(a) for i, a in enumerate(t)}
             for t in trees]
    want = jhealth.update_health(*jtree, jhealth.HealthConfig(**cfg))
    tcfg = thealth.HealthConfig(**cfg)
    tt = [[torch.from_numpy(a) for a in t] for t in trees]
    _same(thealth.update_health(*tt, tcfg), want)
    # The Solver's form: the pre-update norm taken before the update.
    pnorm = thealth.tree_l2_norm(tt[1])
    _same(thealth.update_health(tt[0], None, tt[2], tcfg, param_norm=pnorm),
          want)


def test_tree_l2_norm_in_fp32_matches_jax():
    rng = np.random.default_rng(1)
    arrs = [(rng.standard_normal((64, 32)) * 300).astype(np.float32)]
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]
    want = jhealth.tree_l2_norm([jnp.asarray(a, jnp.bfloat16) for a in arrs])
    _close(thealth.tree_l2_norm(bf), want)
    assert thealth.tree_l2_norm(bf).dtype == torch.float32
    with pytest.raises(ValueError):
        thealth.tree_l2_norm([])


def test_embedding_health_matches_jax():
    rng = np.random.default_rng(2)
    f = rng.standard_normal((12, 16)).astype(np.float32)
    _same(thealth.embedding_health(torch.from_numpy(f)),
          jhealth.embedding_health(jnp.asarray(f)))


MINING = [(m, r) for m in ("HARD", "RELATIVE_HARD")
          for r in ("GLOBAL", "LOCAL")]


def _configs(method, region):
    kw = dict(ap_mining_method=method, an_mining_method=method,
              ap_mining_region=region, an_mining_region=region)
    return (NPairLossConfig(**{k: (MiningMethod[v] if "method" in k
                                   else MiningRegion[v])
                               for k, v in kw.items()}),
            JaxLossConfig(**{k: (JMethod[v] if "method" in k
                                 else JRegion[v]) for k, v in kw.items()}))


def _unit_batch(seed, n=16, d=8):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((n, d)).astype(np.float32)
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    return f, (np.arange(n) // 2).astype(np.int32)


@pytest.mark.parametrize("mining", [False, True], ids=["base", "mining"])
@pytest.mark.parametrize("method,region", MINING)
def test_pair_hardness_on_each_engines_aux_matches_jax(method, region,
                                                       mining):
    tcfg, jcfg = _configs(method, region)
    f, lab = _unit_batch(3)
    _, jaux = jax_loss(jnp.asarray(f), jnp.asarray(lab), jcfg)
    _, taux = npair_loss_with_aux(torch.from_numpy(f),
                                  torch.from_numpy(lab), tcfg)
    want = jhealth.pair_hardness_health(jaux, mining=mining)
    got = thealth.pair_hardness_health(taux, mining=mining)
    _same(got, want)
    assert set(got) == ({k for k in HEALTH_KEYS if "mined" in k
                         or "threshold" in k} | (MINING_KEYS if mining
                                                 else set()))


SENTINEL_AUX = {
    # Every threshold a sentinel: no query had candidates.
    "all_sentinel": dict(pos=[np.inf] * 4 + [3.4e38] * 4,
                         neg=[-np.inf] * 4 + [-3.4e38] * 4),
    # A mix: defined, sentinel, NaN; one saturated AN frontier.
    "mixed": dict(pos=[0.5, 0.9, np.inf, 0.2, 0.7, np.nan, 0.1, 0.4],
                  neg=[0.3, 0.95, 0.1, -np.inf, 0.92, 0.2, 0.0, 0.5]),
}


@pytest.mark.parametrize("case", sorted(SENTINEL_AUX))
def test_pair_hardness_sentinels_match_jax(case):
    """The same aux to both (the same NumPy arrays): sentinel masking,
    the margin p10 index and the saturation share; an all-sentinel
    batch reports finite zeros."""
    c = SENTINEL_AUX[case]
    aux = {"ident_num": np.arange(8, dtype=np.float32),
           "diff_num": np.full(8, 3.0, np.float32),
           "pos_threshold": np.asarray(c["pos"], np.float32),
           "neg_threshold": np.asarray(c["neg"], np.float32)}
    want = jhealth.pair_hardness_health(
        {k: jnp.asarray(v) for k, v in aux.items()}, mining=True)
    got = thealth.pair_hardness_health(
        {k: torch.from_numpy(v) for k, v in aux.items()}, mining=True)
    _same(got, want)
    assert all(np.isfinite(float(v)) for v in got.values())
    if case == "all_sentinel":
        assert all(float(got[k]) == 0.0 for k in (
            "ap_threshold_mean", "an_threshold_mean", "ap_an_margin_mean",
            "ap_an_margin_p10", "an_saturation"))


# -- the Solver ------------------------------------------------------------

KW = dict(base_lr=0.05, lr_policy="fixed", momentum=0.9, weight_decay=0.001,
          display=0, test_interval=0, snapshot=0, average_loss=1)


def _step_pair(jmodel, tmodel, shape, ids, steps, health, **solver_kw):
    js = JaxSolver(jmodel, JaxLossConfig(), JaxSolverConfig(**KW),
                   input_shape=shape, health=jhealth.HealthConfig(**health),
                   **solver_kw.get("jax", {}))
    js.init()
    ts = Solver(tmodel, NPairLossConfig(), SolverConfig(**KW),
                health=thealth.HealthConfig(**health),
                **solver_kw.get("port", {}))
    ts.load_params(jax.tree_util.tree_map(np.asarray, js.state["params"]),
                   jax.tree_util.tree_map(np.asarray,
                                          js.state["batch_stats"]) or None)
    jb = jax_batches(ids * 2, ids, 2, shape, noise=0.6, seed=5)
    tb = synthetic_identity_batches(ids * 2, ids, 2, shape, noise=0.6,
                                    seed=5)
    out = []
    for _ in range(steps):
        jm = js.step(*next(jb))
        tm = ts.step(*next(tb))
        out.append(({k: float(v) for k, v in jm.items()},
                    {k: float(v) for k, v in tm.items()}))
    return out


@pytest.mark.parametrize("mining", [False, True], ids=["health", "mining"])
def test_mlp_solver_health_matches_jax(mining):
    shape = (16,)
    trace = _step_pair(
        jax_get_model("mlp", hidden=(32,), embedding_dim=8),
        get_model("mlp", device="cpu", input_shape=shape, hidden=(32,),
                  embedding_dim=8), shape, 8, 3,
        dict(mining_health=mining))
    for jm, tm in trace:
        assert list(tm) == list(jm)
        assert HEALTH_KEYS <= set(tm)
        assert (MINING_KEYS <= set(tm)) == mining
        _same(tm, jm)
    assert trace[-1][1]["update_norm"] > 0


def test_googlenet_bn_solver_health_matches_jax():  # slow-ok: the BN solver's health rows against JAX's
    tpol = tprec.PrecisionPolicy(name="fp32_parity_f64",
                                 compute_dtype=torch.float64)
    jpol = jprec.PrecisionPolicy(name="fp32_parity_f64",
                                 compute_dtype=jnp.float64)
    torch.backends.mkldnn.enabled = False
    try:
        with jax.enable_x64(True):
            trace = _step_pair(
                jax_get_model("googlenet_bn", policy=jpol),
                get_model("googlenet_bn", device="cpu", policy=tpol),
                (32, 32, 3), 4, 1, dict(),
                jax=dict(precision=jpol), port=dict(precision=tpol))
    finally:
        torch.backends.mkldnn.enabled = True
    jm, tm = trace[0]
    assert list(tm) == list(jm)
    assert HEALTH_KEYS <= set(tm)
    _same(tm, jm)


def _mlp_solver(tmp_path, pipeline, health=None, telemetry=None,
                display=2):
    cfg = SolverConfig(**{**KW, "display": display, "pipeline": pipeline,
                          "snapshot_prefix": str(tmp_path / "s_")})
    return Solver(get_model("mlp", device="cpu", input_shape=(16,),
                            hidden=(32,), embedding_dim=8, seed=0),
                  NPairLossConfig(), cfg, health=health, telemetry=telemetry)


def _train(solver, steps=6):
    recs = []
    solver.train(synthetic_identity_batches(16, 8, 2, (16,), noise=0.6,
                                            seed=7), steps,
                 log_fn=lambda s: None, record_fn=recs.append)
    return recs, {k: v.clone() for k, v in solver.state_dict().items()}


def _rows(run_dir, phases=("train", "eval", "event")):
    """Telemetry rows without the envelope's run id and wall clock."""
    out = []
    for line in open(run_dir / "metrics.jsonl"):
        r = json.loads(line)
        if r["phase"] in phases:
            r.pop("wall_time"), r.pop("run_id")
            out.append(json.dumps(r, sort_keys=True))
    return out


def test_health_off_leaves_the_stream_and_bits_unchanged(tmp_path):
    base_recs, base_state = _train(_mlp_solver(tmp_path / "a", False))
    tel = RunTelemetry(str(tmp_path / "run"))
    recs, state = _train(_mlp_solver(tmp_path / "b", False, telemetry=tel))
    tel.close()
    assert json.dumps(recs) == json.dumps(base_recs)
    assert all(torch.equal(state[k], base_state[k]) for k in base_state)
    assert not HEALTH_KEYS & set(base_recs[0])
    # Health on: the same parameters bit for bit, the base keys equal.
    h_recs, h_state = _train(_mlp_solver(tmp_path / "c", False,
                                         health=thealth.HealthConfig()))
    assert all(torch.equal(h_state[k], base_state[k]) for k in base_state)
    for h, b in zip(h_recs, base_recs):
        assert HEALTH_KEYS <= set(h)
        assert {k: h[k] for k in b} == b


def test_sync_and_pipelined_rows_match_with_health(tmp_path):
    out = {}
    for pipeline in (False, True):
        run = tmp_path / f"run_{pipeline}"
        tel = RunTelemetry(str(run))
        solver = _mlp_solver(tmp_path / f"s_{pipeline}", pipeline,
                             thealth.HealthConfig(mining_health=True), tel)
        recs, state = _train(solver, 8)
        tel.close()
        out[pipeline] = (json.dumps(recs), _rows(run), state)
    assert out[False][0] == out[True][0]
    assert out[False][1] == out[True][1]
    assert len(out[False][1]) == 8
    assert all(torch.equal(out[False][2][k], out[True][2][k])
               for k in out[False][2])
    assert MINING_KEYS <= set(json.loads(out[True][1][0]))
