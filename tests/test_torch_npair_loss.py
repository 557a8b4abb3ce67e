"""The port's dense N-pair loss (npairloss_tpu_torch/ops/npair_loss.py)
against the JAX package's ``npair_loss_with_aux`` and the NumPy oracle
(``npairloss_tpu/testing/oracle.py``), on the same seeded numpy batches.

Tolerances: discrete outputs (masks, pair counts, thresholds fed the
same fp32 sims) exactly; the loss within 1e-6 and feature gradients
within 1e-6 (absolute and relative) — fp32 sums over D and over the pair
grid in another order; thresholds from each side's own similarity matmul
within 1e-6, as the two matmuls may round differently.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from conftest import make_identity_batch
from npairloss_tpu.parallel import (
    DEFAULT_AXIS,
    data_parallel_mesh,
    shard_batch,
    shard_map,
    sharded_npair_loss_fn,
)
from npairloss_tpu.testing import oracle
from npairloss_tpu_torch.ops import npair_loss as tnl

# ``npairloss_tpu.ops`` re-exports a function named npair_loss.
jnl = importlib.import_module("npairloss_tpu.ops.npair_loss")

TOL = 1e-6
R, M = tnl.MiningRegion, tnl.MiningMethod


def jax_cfg(cfg: tnl.NPairLossConfig) -> jnl.NPairLossConfig:
    kw = dataclasses.asdict(cfg)
    for k in ("ap_mining_region", "an_mining_region"):
        kw[k] = jnl.MiningRegion(int(kw[k]))
    for k in ("ap_mining_method", "an_mining_method"):
        kw[k] = jnl.MiningMethod(int(kw[k]))
    return jnl.NPairLossConfig(**kw)


def _sn(method, sign):
    if method not in (M.RELATIVE_HARD, M.RELATIVE_EASY):
        return -1.0
    return 1.0 if sign > 0 else -0.4


# Every region x method on the AP side (AN fixed at LOCAL/HARD) and on
# the AN side (AP fixed at GLOBAL/RELATIVE_HARD), relative methods with
# both signs of their rank parameter, plus margins and REFERENCE_CONFIG.
GRID = []
for region in R:
    for method in M:
        for sign in ((1, -1) if method in (M.RELATIVE_HARD, M.RELATIVE_EASY)
                     else (-1,)):
            GRID.append(tnl.NPairLossConfig(
                ap_mining_region=region, ap_mining_method=method,
                identsn=_sn(method, sign), an_mining_method=M.HARD,
                margin_diff=-0.05))
            GRID.append(tnl.NPairLossConfig(
                an_mining_region=region, an_mining_method=method,
                diffsn=_sn(method, sign), ap_mining_region=R.GLOBAL,
                ap_mining_method=M.RELATIVE_HARD, identsn=-0.0,
                margin_ident=0.02))
GRID.append(tnl.REFERENCE_CONFIG)
GRID.append(tnl.NPairLossConfig())


def _cfg_id(cfg):
    return (f"ap{cfg.ap_mining_region.name[0]}{cfg.ap_mining_method.name}"
            f"{cfg.identsn:+g}-an{cfg.an_mining_region.name[0]}"
            f"{cfg.an_mining_method.name}{cfg.diffsn:+g}"
            f"-m{cfg.margin_ident:g},{cfg.margin_diff:g}")


def _batch(seed=0, ids=4, imgs=3, dim=16):
    f, l = make_identity_batch(np.random.default_rng(seed), ids, imgs, dim)
    return f[0], l[0]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("cfg", GRID, ids=_cfg_id)
def test_mining_grid_matches_jax(cfg):
    f, l = _batch()
    jc = jax_cfg(cfg)
    jloss, jaux = jnl.npair_loss_with_aux(jnp.asarray(f), jnp.asarray(l), jc)
    sims = np.asarray(jaux["sim"])

    # Discrete outputs, fed the JAX package's own sims: exact.
    js, jd = jnl.pair_masks(jnp.asarray(l), jnp.asarray(l), jnp.int32(0),
                            len(l))
    jpt, jnt, jmx = jnl.mining_thresholds(jnp.asarray(sims), js, jd, jc)
    jsel = jnl.selection_mask(jnp.asarray(sims), js, jd, jpt, jnt, jc)
    ts, td = tnl.pair_masks(_t(l), _t(l), 0, len(l))
    tpt, tnt, tmx = tnl.mining_thresholds(_t(sims), ts, td, cfg)
    tsel = tnl.selection_mask(_t(sims), ts, td, tpt, tnt, cfg)
    for got, want in ((ts, js), (td, jd), (tpt, jpt), (tnt, jnt),
                      (tmx, jmx), (tsel, jsel)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    # The whole forward from features.
    tloss, taux = tnl.npair_loss_with_aux(_t(f), _t(l), cfg)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=TOL,
                               atol=TOL)
    for key in ("ident_num", "diff_num"):
        np.testing.assert_array_equal(taux[key].numpy(),
                                      np.asarray(jaux[key]))
    for key in ("pos_threshold", "neg_threshold", "sim"):
        np.testing.assert_allclose(taux[key].numpy(), np.asarray(jaux[key]),
                                   rtol=TOL, atol=TOL)
    want = oracle.forward([f], [l], jc)[0]
    np.testing.assert_allclose(float(tloss), want.loss, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(
        (taux["ident_num"] + taux["diff_num"]).numpy(),
        (want.select & (want.same | want.diff)).sum(1))


@pytest.mark.parametrize("grad_mode", ["reference", "true"])
@pytest.mark.parametrize("cfg", [tnl.REFERENCE_CONFIG, GRID[0], GRID[5],
                                 tnl.NPairLossConfig()], ids=_cfg_id)
def test_gradients_match_jax_and_oracle(cfg, grad_mode):
    cfg = dataclasses.replace(cfg, grad_mode=grad_mode)
    f, l = _batch(seed=1)
    jc = jax_cfg(cfg)
    want = np.asarray(jax.grad(
        lambda x: jnl.npair_loss(x, jnp.asarray(l), jc))(jnp.asarray(f)))
    ft = _t(f).requires_grad_()
    tnl.npair_loss(ft, _t(l), cfg).backward()
    np.testing.assert_allclose(ft.grad.numpy(), want, rtol=TOL, atol=TOL)
    if grad_mode == "reference":
        res = oracle.forward([f], [l], jc)
        np.testing.assert_allclose(ft.grad.numpy(),
                                   oracle.backward([f], res)[0],
                                   rtol=TOL, atol=TOL)


def test_loss_weight_scales_the_reference_gradient():
    f, l = _batch(seed=2)
    res = oracle.forward([f], [l], jax_cfg(tnl.REFERENCE_CONFIG))
    ft = _t(f).requires_grad_()
    (2.5 * tnl.npair_loss(ft, _t(l), tnl.REFERENCE_CONFIG)).backward()
    np.testing.assert_allclose(
        ft.grad.numpy(), oracle.backward([f], res, loss_weight=2.5)[0],
        rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", ["batch_of_1", "all_same_label",
                                  "no_positive"])
@pytest.mark.parametrize("cfg", [tnl.REFERENCE_CONFIG, tnl.NPairLossConfig()],
                         ids=_cfg_id)
def test_edge_batches(case, cfg):
    """Loss 0 (not NaN) with no pairs, finite reference gradients, and
    the JAX package's values in both grad modes (NaN where it has NaN)."""
    rng = np.random.default_rng(3)
    f = rng.standard_normal((6, 8)).astype(np.float32)
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    if case == "batch_of_1":
        f, l = f[:1], np.zeros(1, np.int32)
    elif case == "all_same_label":
        l = np.zeros(6, np.int32)
    else:  # label 9 has no positive: the sampler contract is broken
        l = np.array([0, 0, 1, 1, 2, 9], np.int32)
    for mode in ("reference", "true"):
        c = dataclasses.replace(cfg, grad_mode=mode)
        ft = _t(f).requires_grad_()
        loss = tnl.npair_loss(ft, _t(l), c)
        loss.backward()
        jc = jax_cfg(c)
        jloss, jgrad = jax.value_and_grad(
            lambda x: jnl.npair_loss(x, jnp.asarray(l), jc))(jnp.asarray(f))
        assert np.isfinite(loss.item())
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(ft.grad.numpy(), np.asarray(jgrad),
                                   rtol=TOL, atol=TOL)
        if mode == "reference":
            assert np.isfinite(ft.grad.numpy()).all()
    if case != "no_positive":
        assert loss.item() == 0.0


def test_relative_pos_truncates_in_fp32():
    """``trunc(count - 1 + sn*count)`` in fp32 for int32 counts: where
    fp64 lands on the other side of an integer the port follows JAX."""
    counts = np.arange(0, 400, dtype=np.int32)
    differs = 0
    for sn in (-0.6, -0.3, -0.45, 2.0, -0.0):
        got = tnl._relative_pos(torch.from_numpy(counts), sn).numpy()
        want = np.asarray(jnl._relative_pos(jnp.asarray(counts), sn))
        np.testing.assert_array_equal(got, want)
        fp64 = np.array([oracle._relative_pos(int(c), sn) for c in counts])
        differs += int((got != fp64)[1:].sum())
    assert differs > 0  # e.g. count 25, sn -0.6: fp32 gives 8, fp64 9


def test_relative_threshold_clamps_and_empty_fills():
    """A relative threshold below 0 becomes -FLT_MAX; a query with no
    candidates gets +FLT_MAX (RELATIVE) — exactly as JAX."""
    sims = np.array([[0.5, -0.2, -0.3, 0.1],
                     [-0.2, 0.4, -0.6, -0.1]], np.float32)
    same = np.array([[False, True, True, False],
                     [False, False, False, False]])
    for sn in (-0.0, -0.5, 1.0):
        got = tnl._local_relative_threshold(_t(sims), _t(same), sn)
        want = jnl._local_relative_threshold(jnp.asarray(sims),
                                             jnp.asarray(same), sn)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got[0].item() == -tnl.FLT_MAX
        assert got[1].item() == tnl.FLT_MAX


def test_where_masking_keeps_empty_rows_finite():
    """A query with no pairs has max_all = -FLT_MAX, so its exp row is
    inf; where-based masking keeps the loss and aux sums finite."""
    f = np.eye(3, dtype=np.float32)
    l = np.array([0, 1, 1], np.int32)
    loss, aux = tnl.npair_loss_with_aux(_t(f[:1]), _t(l[:1]))
    assert float(loss) == 0.0
    assert torch.isinf(aux["sim_exp"]).all()
    loss, _ = tnl.npair_loss_with_aux(_t(f), _t(l))
    assert np.isfinite(float(loss))


G = 4


def test_sharded_ranks_match_jax_shard_map():
    """G = 4 ranks: the port's per-rank calls (explicit rank, num_shards,
    the gathered pool, and a summed database-role gradient) against the
    JAX package under shard_map on 4 of the 8 CPU devices."""
    feats, labs = make_identity_batch(np.random.default_rng(4), 3, 2, 8,
                                      num_shards=G)
    gf, gl = np.concatenate(feats), np.concatenate(labs)
    cfg = tnl.REFERENCE_CONFIG
    jc = jax_cfg(cfg)
    mesh = data_parallel_mesh(jax.devices()[:G])
    losses, aux = jax.jit(sharded_npair_loss_fn(mesh, jc))(
        *shard_batch(mesh, (gf, gl)))

    def mean_loss(x, lab):
        return jax.lax.pmean(jnl.npair_loss(x, lab, jc, axis_name=DEFAULT_AXIS),
                             DEFAULT_AXIS)

    jgrad = np.asarray(jax.jit(shard_map(
        jax.grad(mean_loss), mesh=mesh,
        in_specs=(P(DEFAULT_AXIS), P(DEFAULT_AXIS)),
        out_specs=P(DEFAULT_AXIS)))(*shard_batch(mesh, (gf, gl))))

    n = len(labs[0])
    res, gq = [], []
    for r in range(G):
        loss, taux, tres = tnl._forward_core(
            _t(feats[r]), _t(labs[r]), cfg, total_features=_t(gf),
            total_labels=_t(gl), rank=r, num_shards=G)
        np.testing.assert_allclose(float(loss), float(np.asarray(losses)[r]),
                                   rtol=TOL, atol=TOL)
        for key in ("pos_threshold", "neg_threshold"):
            np.testing.assert_allclose(taux[key].numpy(),
                                       np.asarray(aux[key])[r], rtol=TOL,
                                       atol=TOL)
        np.testing.assert_array_equal(taux["ident_num"].numpy(),
                                      np.asarray(aux["ident_num"])[r])
        res.append(tres)
    # mean over ranks: each rank's loss has cotangent 1/G.
    g = torch.tensor(1.0 / G)
    roles = [tnl.grad_roles(r_, g) for r_ in res]
    db_sum = sum(db for _, db in roles)
    for r in range(G):
        got = tnl.merge_roles(roles[r][0], db_sum, r, G).numpy()
        np.testing.assert_allclose(got, jgrad[r * n:(r + 1) * n], rtol=TOL,
                                   atol=TOL)
    # The same through the Function, with the all-reduce hook.
    ft = _t(feats[1]).requires_grad_()
    tnl.npair_loss(ft, _t(labs[1]), cfg, total_features=_t(gf),
                   total_labels=_t(gl), rank=1, num_shards=G,
                   all_reduce=lambda db: db_sum) .mul(1.0 / G).backward()
    np.testing.assert_allclose(ft.grad.numpy(), jgrad[n:2 * n], rtol=TOL,
                               atol=TOL)
