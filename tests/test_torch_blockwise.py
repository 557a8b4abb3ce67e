"""The port's blockwise N-pair engine (npairloss_tpu_torch/ops/blockwise_npair.py)
against the JAX package: its dense ``npair_loss_with_aux`` (which
``tests/test_pallas.py`` holds equal to the JAX blockwise engine), and
``ops/pallas_npair.py`` itself in interpret mode at tiny sizes.

Inputs come from a seed with numpy.  Dyadic features (entries k/8,
|k| <= 8, D = 8) make every dot product exact in fp32 whatever the
summation order, so both packages see the same sims bit for bit — and
many ties: thresholds, pair counts, histograms and the K-slot buffer
must then be exactly equal.  Tolerances otherwise: the loss within 1e-6
and feature gradients within rtol 1e-5 / atol 1e-7 (fp32 sums in
another order, the weight factored per query as the JAX blockwise
engine does); on random unit features thresholds within rtol 1e-6.
"""

import dataclasses
import importlib
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npairloss_tpu.ops import pallas_npair as jpn
from npairloss_tpu_torch.ops import _build
from npairloss_tpu_torch.ops import blockwise_npair as bw
from npairloss_tpu_torch.ops import npair_loss as tnl

# ``npairloss_tpu.ops`` re-exports a function named npair_loss.
jnl = importlib.import_module("npairloss_tpu.ops.npair_loss")

R, M = tnl.MiningRegion, tnl.MiningMethod
LOSS_TOL = 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-7

# tests/test_pallas.py:30-110, in the port's terms.
ABS_CONFIGS = [
    tnl.NPairLossConfig(),
    tnl.NPairLossConfig(ap_mining_method=M.HARD, an_mining_method=M.HARD,
                        margin_ident=0.1, margin_diff=-0.05),
    tnl.NPairLossConfig(ap_mining_method=M.EASY, an_mining_method=M.EASY,
                        margin_ident=-0.02),
    tnl.NPairLossConfig(ap_mining_region=R.GLOBAL, ap_mining_method=M.HARD,
                        an_mining_region=R.GLOBAL, an_mining_method=M.EASY,
                        margin_diff=0.03),
    tnl.NPairLossConfig(ap_mining_method=M.EASY, an_mining_method=M.HARD,
                        grad_mode="true"),
]
REL_CONFIGS = [
    tnl.REFERENCE_CONFIG,
    tnl.NPairLossConfig(ap_mining_method=M.RELATIVE_EASY, identsn=-0.5,
                        an_mining_method=M.RELATIVE_HARD, diffsn=-0.3),
    tnl.NPairLossConfig(ap_mining_method=M.RELATIVE_HARD, identsn=1.0,
                        an_mining_method=M.RELATIVE_EASY, diffsn=2.0,
                        margin_diff=0.02),
    tnl.NPairLossConfig(an_mining_region=R.GLOBAL,
                        an_mining_method=M.RELATIVE_HARD, diffsn=-0.25),
]
CONFIGS = ABS_CONFIGS + REL_CONFIGS
CFG_IDS = [f"abs{i}" for i in range(len(ABS_CONFIGS))] + [
    f"rel{i}" for i in range(len(REL_CONFIGS))]


def jax_cfg(cfg):
    kw = dataclasses.asdict(cfg)
    for k in ("ap_mining_region", "an_mining_region"):
        kw[k] = jnl.MiningRegion(int(kw[k]))
    for k in ("ap_mining_method", "an_mining_method"):
        kw[k] = jnl.MiningMethod(int(kw[k]))
    return jnl.NPairLossConfig(**kw)


def dyadic_batch(seed, num_ids, imgs, dim=8):
    """Identity-balanced, shuffled; entries k/8 with |k| <= 8."""
    rng = np.random.default_rng(seed)
    ids = rng.choice(10 * num_ids, size=num_ids, replace=False)
    lab = np.repeat(ids, imgs).astype(np.int32)
    f = rng.integers(-8, 9, (len(lab), dim)).astype(np.float32) / 8
    perm = rng.permutation(len(lab))
    return f[perm], lab[perm]


def unit_batch(seed, num_ids, imgs, dim=16):
    rng = np.random.default_rng(seed)
    lab = np.repeat(rng.choice(10 * num_ids, num_ids, replace=False), imgs)
    f = rng.standard_normal((len(lab), dim)).astype(np.float32)
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    perm = rng.permutation(len(lab))
    return f[perm], lab[perm].astype(np.int32)


def port(f, l, cfg, **kw):
    """(loss, aux, grad) of the port's blockwise engine on the CPU."""
    x = torch.tensor(f, requires_grad=True)
    loss, aux = bw.blockwise_npair_loss_with_aux(x, torch.from_numpy(l), cfg,
                                                 **kw)
    loss.backward()
    return (loss.detach().numpy(), {k: v.numpy() for k, v in aux.items()},
            x.grad.numpy())


def jax_dense(f, l, cfg):
    jc = jax_cfg(cfg)
    (loss, aux), g = jax.value_and_grad(
        lambda x: jnl.npair_loss_with_aux(x, jnp.asarray(l), jc),
        has_aux=True)(jnp.asarray(f))
    return np.asarray(loss), aux, np.asarray(g)


def assert_monitors_equal(aux, aux_j):
    for k in ("ident_num", "diff_num", "pos_threshold", "neg_threshold"):
        np.testing.assert_array_equal(aux[k], np.asarray(aux_j[k]),
                                      err_msg=k)


@pytest.mark.parametrize("block", [5, 6])
@pytest.mark.parametrize("cfg", CONFIGS, ids=CFG_IDS)
def test_dyadic_matches_jax_dense_in_both_grad_modes(cfg, block):
    """N = 18 at a block that does (6) and does not (5) divide it."""
    f, l = dyadic_batch(block, num_ids=6, imgs=3)
    for mode in ("reference", "true"):
        c = dataclasses.replace(cfg, grad_mode=mode)
        loss, aux, g = port(f, l, c, block_size=block)
        loss_j, aux_j, g_j = jax_dense(f, l, c)
        np.testing.assert_allclose(loss, loss_j, rtol=LOSS_TOL,
                                   atol=LOSS_TOL)
        assert_monitors_equal(aux, aux_j)
        np.testing.assert_allclose(g, g_j, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=mode)


@pytest.mark.parametrize("cfg", CONFIGS, ids=CFG_IDS)
def test_unit_features_match_jax_dense(cfg):
    f, l = unit_batch(1, num_ids=6, imgs=3)
    loss, aux, g = port(f, l, cfg, block_size=5)
    loss_j, aux_j, g_j = jax_dense(f, l, cfg)
    np.testing.assert_allclose(loss, loss_j, rtol=LOSS_TOL, atol=LOSS_TOL)
    for k in ("ident_num", "diff_num"):
        np.testing.assert_array_equal(aux[k], np.asarray(aux_j[k]))
    for k in ("pos_threshold", "neg_threshold"):
        np.testing.assert_allclose(aux[k], np.asarray(aux_j[k]), rtol=1e-6)
    np.testing.assert_allclose(g, g_j, rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("cfg", [REL_CONFIGS[0], REL_CONFIGS[1]],
                         ids=["reference", "rel_both"])
def test_sim_cache_on_and_off_are_bit_identical(cfg):
    f, l = unit_batch(2, num_ids=6, imgs=3)
    on = port(f, l, cfg, block_size=5, sim_cache=True)
    off = port(f, l, cfg, block_size=5, sim_cache=False)
    assert on[0] == off[0]
    for k in on[1]:
        np.testing.assert_array_equal(on[1][k], off[1][k], err_msg=k)
    np.testing.assert_array_equal(on[2], off[2])


def test_pos_topk_fast_path_and_radix_path_are_identical():
    f, l = unit_batch(3, num_ids=8, imgs=2, dim=12)
    fast = port(f, l, tnl.REFERENCE_CONFIG, block_size=4, pos_topk=8)
    radix = port(f, l, tnl.REFERENCE_CONFIG, block_size=4, pos_topk=0)
    assert fast[0] == radix[0]
    for k in fast[1]:
        np.testing.assert_array_equal(fast[1][k], radix[1][k], err_msg=k)
    np.testing.assert_array_equal(fast[2], radix[2])


@pytest.mark.parametrize("imgs", [9, 11])
@pytest.mark.parametrize("region", [R.LOCAL, R.GLOBAL])
def test_pos_topk_fallback_boundary(region, imgs):
    """9 images per identity give 8 positives: the 8-slot buffer holds
    them; 11 overflow it and the device-side flag sends the threshold
    through radix selection.  Both sides of the boundary equal JAX dense
    exactly on dyadic sims, and the pos_topk=0 path bit for bit."""
    cfg = tnl.NPairLossConfig(ap_mining_region=region,
                              ap_mining_method=M.RELATIVE_HARD, identsn=-0.3,
                              an_mining_method=M.HARD, margin_diff=-0.05)
    f, l = dyadic_batch(imgs, num_ids=2, imgs=imgs)
    lab = torch.from_numpy(l)
    st = bw.npair_stats(torch.from_numpy(f), lab, torch.from_numpy(f), lab,
                        hist_same=True, topk=8)
    assert bool(st.cnt_s.max() <= 8) == (imgs == 9)
    loss, aux, g = port(f, l, cfg, block_size=5, pos_topk=8)
    loss_j, aux_j, g_j = jax_dense(f, l, cfg)
    np.testing.assert_allclose(loss, loss_j, rtol=LOSS_TOL, atol=LOSS_TOL)
    assert_monitors_equal(aux, aux_j)
    np.testing.assert_allclose(g, g_j, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    radix = port(f, l, cfg, block_size=5, pos_topk=0)
    assert loss == radix[0]
    np.testing.assert_array_equal(aux["pos_threshold"],
                                  radix[1]["pos_threshold"])


@pytest.mark.parametrize("bn,bm", [(4, 7), (7, 4)])
def test_ragged_tiles_match_jax_dense(bn, bm):
    f, l = dyadic_batch(bn * bm, num_ids=6, imgs=3)
    cfg = tnl.REFERENCE_CONFIG
    loss, aux, g = port(f, l, cfg, block_size=bm, q_block_size=bn,
                        sim_cache=True)
    loss_j, aux_j, g_j = jax_dense(f, l, cfg)
    np.testing.assert_allclose(loss, loss_j, rtol=LOSS_TOL, atol=LOSS_TOL)
    assert_monitors_equal(aux, aux_j)
    np.testing.assert_allclose(g, g_j, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_zero_count_queries():
    """Unique labels: no positives, loss exactly 0; the reference backward
    keeps the diff-type terms (cu:133-146), "true" gives exactly 0."""
    f = np.random.default_rng(4).standard_normal((8, 16)).astype(np.float32)
    l = np.arange(8, dtype=np.int32)
    loss, aux, g = port(f, l, tnl.NPairLossConfig(), block_size=4)
    assert float(loss) == 0.0
    np.testing.assert_array_equal(aux["ident_num"], np.zeros(8))
    _, _, g_j = jax_dense(f, l, tnl.NPairLossConfig())
    np.testing.assert_allclose(g, g_j, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    assert np.abs(g).max() > 0
    _, _, g_true = port(f, l, tnl.NPairLossConfig(grad_mode="true"),
                        block_size=4)
    np.testing.assert_array_equal(g_true, np.zeros_like(f))


def test_float_labels_stay_distinct():
    f = np.random.default_rng(5).standard_normal((6, 8)).astype(np.float32)
    l = np.array([0.2, 0.2, 0.7, 0.7, 1.2, 1.2], np.float32)
    cfg = tnl.NPairLossConfig()
    loss, aux, g = port(f, l, cfg, block_size=4)
    loss_j, aux_j, g_j = jax_dense(f, l, cfg)
    np.testing.assert_allclose(loss, loss_j, rtol=LOSS_TOL)
    np.testing.assert_array_equal(aux["ident_num"], np.asarray(
        aux_j["ident_num"]))
    np.testing.assert_allclose(g, g_j, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    m = bw.blockwise_retrieval_metrics(torch.from_numpy(f),
                                       torch.from_numpy(l), (1,),
                                       block_size=4)
    want = jpn.blockwise_retrieval_metrics(jnp.asarray(f), jnp.asarray(l),
                                           (1,), block_size=4)
    assert float(m["retrieve_top1"]) == float(want["retrieve_top1"])


def test_batch_of_one_has_zero_loss_and_a_finite_gradient():
    f = np.random.default_rng(6).standard_normal((1, 8)).astype(np.float32)
    l = np.array([3], np.int32)
    for cfg in (tnl.NPairLossConfig(), tnl.NPairLossConfig(grad_mode="true")):
        loss, _, g = port(f, l, cfg, block_size=4)
        assert float(loss) == 0.0
        np.testing.assert_array_equal(g, np.zeros_like(g))


@pytest.mark.parametrize("block", [4, 7, 64])
def test_retrieval_metrics_match_jax(block):
    f, l = unit_batch(7, num_ids=8, imgs=3)
    got = bw.blockwise_retrieval_metrics(torch.from_numpy(f),
                                         torch.from_numpy(l), (1, 5, 10),
                                         block_size=block)
    want = jpn.blockwise_retrieval_metrics(jnp.asarray(f), jnp.asarray(l),
                                           (1, 5, 10), block_size=block)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                                   err_msg=k)


def test_negative_pos_topk_is_refused():
    f, l = unit_batch(8, 2, 2)
    with pytest.raises(ValueError, match="pos_topk"):
        bw.blockwise_npair_loss(torch.from_numpy(f), torch.from_numpy(l),
                                pos_topk=-1)


def test_pos_topk_above_the_kernel_limit_is_refused():
    """The kernel's K-slot limit, kMaxTopK, is refused by its wrapper on
    every device; the engine takes any K >= 0, as JAX does, and gives the
    kernel at most that many slots.  40 images per identity give 39
    positives: 64 JAX slots hold them, the port's 32 overflow into radix
    selection, and the loss is the same — equal to the port at K = 0 bit
    for bit, and to the JAX blockwise engine at pos_topk=64 (Pallas in
    interpret mode) within the engine tests' tolerance."""
    src = (Path(bw.__file__).parent.parent / "csrc" /
           "npair_blockwise.cu").read_text()
    assert int(re.search(r"kMaxTopK = (\d+);", src).group(1)) == bw.MAX_TOPK
    f, l = dyadic_batch(12, num_ids=2, imgs=40)
    tf, tl = torch.from_numpy(f), torch.from_numpy(l)
    with pytest.raises(ValueError, match="top-k slots"):
        bw.npair_stats(tf, tl, tf, tl, topk=bw.MAX_TOPK + 8)
    st = bw.npair_stats(tf, tl, tf, tl, hist_same=True, topk=bw.MAX_TOPK)
    assert int(st.cnt_s.max()) == 39 > bw.MAX_TOPK
    cfg = tnl.REFERENCE_CONFIG
    loss, aux, g = port(f, l, cfg, block_size=40, pos_topk=64)
    radix = port(f, l, cfg, block_size=40, pos_topk=0)
    assert loss == radix[0]
    for k in aux:
        np.testing.assert_array_equal(aux[k], radix[1][k], err_msg=k)
    np.testing.assert_array_equal(g, radix[2])
    step = jax.jit(jax.value_and_grad(
        lambda x: jpn.blockwise_npair_loss_with_aux(
            x, jnp.asarray(l), jax_cfg(cfg), block_size=128, pos_topk=64,
            interpret=True),
        has_aux=True))
    (loss_j, aux_j), g_j = step(jnp.asarray(f))
    np.testing.assert_allclose(loss, np.asarray(loss_j), rtol=LOSS_TOL)
    assert_monitors_equal(aux, aux_j)
    np.testing.assert_allclose(g, np.asarray(g_j), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


@pytest.mark.parametrize("cfg", [tnl.REFERENCE_CONFIG, ABS_CONFIGS[1]],
                         ids=["reference", "hard_hard"])
def test_matches_jax_blockwise_engine_under_jit(cfg):
    """The JAX blockwise engine itself (Pallas in interpret mode, jitted)
    on a tiny dyadic case: the same loss, monitors and gradient.  One
    tile per sweep keeps the interpreted trace small."""
    f, l = dyadic_batch(9, num_ids=5, imgs=2)
    jc = jax_cfg(cfg)
    step = jax.jit(jax.value_and_grad(
        lambda x: jpn.blockwise_npair_loss_with_aux(
            x, jnp.asarray(l), jc, block_size=16, interpret=True),
        has_aux=True))
    (loss_j, aux_j), g_j = step(jnp.asarray(f))
    loss, aux, g = port(f, l, cfg, block_size=4)
    np.testing.assert_allclose(loss, np.asarray(loss_j), rtol=LOSS_TOL)
    assert_monitors_equal(aux, aux_j)
    np.testing.assert_allclose(g, np.asarray(g_j), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


def test_plain_sweeps_match_the_jax_tile_kernels():
    """Each plain sweep against the JAX kernel it stands for, run by the
    JAX package's own ``_run_*`` in interpret mode on one tiny dyadic
    case: stats (min/max, counts, digit-0 histograms, K-slot buffer, the
    emitted sims), one digit of the hist sweep, the loss sweep, gq and
    gdb."""
    f, l = dyadic_batch(10, num_ids=5, imgs=2)
    n, b, k = len(l), 4, 8
    cfg = tnl.REFERENCE_CONFIG
    tf, tl = torch.from_numpy(f), torch.from_numpy(l)
    jf = jpn._pad_rows(jnp.asarray(f), b)
    jl = jpn._pad_rows(jnp.asarray(l), b)
    scal = jnp.array([n, 0, n], jnp.int32)

    st = bw.stats_plain(tf, tl, tf, tl, hist_same=True, hist_diff=True,
                        topk=k, emit_sims=True, bn=b, bm=b)
    js = jpn._run_stats(jf, jl, jf, jl, scal, b, b, True, hist_same=True,
                        hist_diff=True, emit_sims=True, topk_same=k)
    for name, got, want in zip(
            ("min_w", "max_b", "max_a", "cnt_s", "cnt_d", "h_s", "h_d",
             "topk"), st[:8], js[:8]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:n],
                                      err_msg=name)
    np.testing.assert_array_equal(st.sims.numpy(), np.asarray(js[8])[:n, :n])

    prefix = torch.tensor(np.arange(n) % 3 + 8, dtype=torch.int64)
    got = bw.hist_plain(tf, tl, tf, tl, [True, False], [prefix, prefix], 1,
                        bn=b, bm=b)
    jp = jpn._pad_rows(jnp.asarray(prefix.numpy().astype(np.uint32)), b)
    want = jpn._run_hist(jf, jl, jf, jl, scal, [True, False], [jp, jp], 1,
                         b, b, True)
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_)[:n])

    thr = (st.max_b * 0.5, st.min_w - 0.25, st.max_a)
    got = bw.loss_plain(tf, tl, tf, tl, *thr, cfg, bn=b)
    jthr = [jpn._pad_rows(jnp.asarray(t.numpy()), b) for t in thr]
    want = jpn._run_loss(jf, jl, jf, jl, scal, *jthr, jax_cfg(cfg), b, b,
                         True)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_)[:n],
                                   rtol=1e-6)

    isum, dsum = got[0], got[1]
    asum = isum + dsum
    valid = torch.ones(n)
    g = torch.tensor(1.5)
    gq = bw.grad_plain(tf, tl, tf, tl, *thr, isum, asum, valid, g, cfg,
                       False, bn=b, bm=b)
    gdb = bw.grad_plain(tf, tl, tf, tl, *thr, isum, asum, valid, g, cfg,
                        True, bn=b, bm=b)
    jv = [jpn._pad_rows(jnp.asarray(t.numpy()), b)
          for t in (isum, asum, valid)]
    jgq, jgdb = jpn._run_bwd(jf, jl, jf, jl, scal, *jthr, *jv, 1.5,
                             jax_cfg(cfg), b, b, True)
    np.testing.assert_allclose(gq.numpy(), np.asarray(jgq)[:n],
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(gdb.numpy(), np.asarray(jgdb)[:n],
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
@pytest.mark.parametrize("cfg", CONFIGS, ids=CFG_IDS)
def test_stats_pool_split_combines_bit_for_bit(cfg, splits):
    """The stats kernel's cluster split, in plain PyTorch: the pool axis
    swept as ``splits`` ranges and the partials combined in range order
    give the unsplit sweep's Stats bit for bit, with the options the
    engine asks for under ``cfg`` (digit-0 histograms, the K-slot buffer)
    and the emitted sims.  18 queries against a pool of 23 rows (the
    queries and 5 more of their identities) at 5-row tiles: ranges end
    mid-tile, and 8 ranges of 23 rows are ragged."""
    f, l = dyadic_batch(30 + splits, num_ids=6, imgs=3)
    rng = np.random.default_rng(splits)
    extra = rng.integers(-8, 9, (5, f.shape[1])).astype(np.float32) / 8
    tf, tl = torch.from_numpy(f), torch.from_numpy(l)
    tp = torch.from_numpy(np.concatenate([f, extra]))
    tpl = torch.from_numpy(np.concatenate([l, rng.choice(l, 5)]))
    ap_rel = cfg.ap_mining_method in bw._RELATIVE
    an_rel = cfg.an_mining_method in bw._RELATIVE
    opts = dict(hist_same=ap_rel, hist_diff=an_rel,
                topk=8 if ap_rel and not an_rel else 0, emit_sims=True,
                bn=5, bm=5)
    want = bw.stats_plain(tf, tl, tp, tpl, **opts)
    got = bw.stats_plain(tf, tl, tp, tpl, splits=splits, **opts)
    assert int(want.cnt_s.sum()) > 0 and int(want.cnt_d.sum()) > 0
    for name, g_, w_ in zip(bw.Stats._fields, got, want):
        if w_ is None:
            assert g_ is None, name
        else:
            assert g_.dtype == w_.dtype and torch.equal(g_, w_), name


def test_wrappers_run_the_plain_sweeps_on_cpu_tensors():
    """On CPU tensors a wrapper returns its plain sweep's result and
    counts no launch."""
    f, l = unit_batch(11, num_ids=4, imgs=2)
    tf, tl = torch.from_numpy(f), torch.from_numpy(l)
    _build.reset_launch_counts()
    st = bw.npair_stats(tf, tl, tf, tl, hist_same=True, topk=8,
                        emit_sims=True)
    want = bw.stats_plain(tf, tl, tf, tl, hist_same=True, topk=8,
                          emit_sims=True)
    # The engine's CPU sweeps at the caller's tiles.
    tiled = bw._sweeps(tf.device, 3, 3).stats(tf, tl, tf, tl,
                                              hist_same=True, topk=8,
                                              emit_sims=True)
    want_tiled = bw.stats_plain(tf, tl, tf, tl, hist_same=True, topk=8,
                                emit_sims=True, bn=3, bm=3)
    for got, w in zip(st + tiled, want + want_tiled):
        if w is None:
            assert got is None
        else:
            assert torch.equal(got, w)
    counts = _build.launch_counts()
    assert all(counts[k] == 0 for k in ("npair_stats", "npair_hist",
                                        "npair_loss", "npair_gq",
                                        "npair_gdb"))


def test_rows16_pads_d_to_a_multiple_of_4_with_zeros():
    """The stats and grad kernels copy rows 16 bytes at a time: the
    wrappers zero-pad D to a multiple of 4 (which changes no sim) and
    leave aligned rows untouched; a self-pool stays one tensor."""
    f = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (5, 30)).astype(np.float32))
    p = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (7, 30)).astype(np.float32))
    ff, pp, d4 = bw._rows16(f, p)
    assert d4 == 32 and ff.shape == (5, 32) and pp.shape == (7, 32)
    assert torch.equal(ff[:, :30], f) and not ff[:, 30:].any()
    assert torch.equal(ff @ pp.T, f @ p.T)
    same = bw._rows16(ff, ff)
    assert same[0] is ff and same[1] is ff and same[2] == 32


def _chain_sums_numpy(vals, splits, tile):
    """The kernels' I/D order spelt out one fp32 add at a time: ranges of
    whole tiles, in each range a chain per chunk parity (the 4-column
    chunks 0, 2, 4, ... and 1, 3, 5, ... of every tile, in order), the
    chains added, the ranges added in order."""
    rows, m = vals.shape
    tiles = -(-m // tile)
    out = np.zeros(rows, np.float32)
    for r in range(rows):
        total = None
        for s in range(splits):
            lo, hi = tile * (tiles * s // splits), tile * (tiles * (s + 1)
                                                          // splits)
            chain = [np.float32(0), np.float32(0)]
            for c in range(lo, min(hi, m)):
                j = (c // 4) % 2
                chain[j] = np.float32(chain[j] + vals[r, c])
            part = np.float32(chain[0] + chain[1])
            total = part if total is None else np.float32(total + part)
        out[r] = total
    return out


@pytest.mark.parametrize("splits,tile", [(1, 128), (1, 8), (2, 8), (3, 8),
                                         (5, 16)])
def test_chain_sums_is_the_kernel_order(splits, tile):
    """``chain_sums`` (the plain loss sweep's I/D sums) adds in exactly
    the order the hist/loss kernels do: bit-equal to the order spelt out
    one fp32 add at a time, on 37 ragged columns of values whose sums
    round differently in other orders."""
    rng = np.random.default_rng(splits * 100 + tile)
    vals = rng.exponential(1.0, (5, 37)).astype(np.float32)
    vals[rng.random(vals.shape) < 0.3] = 0.0   # unselected pairs
    want = _chain_sums_numpy(vals, splits, tile)
    got = bw.chain_sums(torch.from_numpy(vals), splits, tile).numpy()
    np.testing.assert_array_equal(got, want)
    stacked = bw.chain_sums(torch.from_numpy(np.stack([vals, vals[::-1]])),
                            splits, tile).numpy()
    np.testing.assert_array_equal(stacked[0], want)
    np.testing.assert_array_equal(
        stacked[1], _chain_sums_numpy(vals[::-1], splits, tile))


_JAX_LOSS = {}


def _jax_loss_sweep(cfg_id, f, l, cfg, thr, b):
    """JAX's _make_loss_kernel through _run_loss in interpret mode, once
    per config."""
    if cfg_id not in _JAX_LOSS:
        n = len(l)
        jf = jpn._pad_rows(jnp.asarray(f), b)
        jl = jpn._pad_rows(jnp.asarray(l), b)
        jthr = [jpn._pad_rows(jnp.asarray(t.numpy()), b) for t in thr]
        out = jpn._run_loss(jf, jl, jf, jl, jnp.array([n, 0, n], jnp.int32),
                            *jthr, jax_cfg(cfg), b, b, True)
        _JAX_LOSS[cfg_id] = [np.asarray(o)[:n] for o in out]
    return _JAX_LOSS[cfg_id]


@pytest.mark.parametrize("splits,tile", [(1, 128), (1, 8), (2, 8), (3, 8),
                                         (5, 8)])
@pytest.mark.parametrize("cfg", [tnl.REFERENCE_CONFIG, ABS_CONFIGS[0],
                                 ABS_CONFIGS[1]],
                         ids=["reference", "local_rand", "hard_hard"])
def test_loss_plain_kernel_orders_match_jax(cfg, splits, tile):
    """The loss sweep in each mirrored kernel order (the pool split into
    1..5 ranges of 8- or 128-column tiles) on 40 unit features: the
    selected pair counts equal JAX's _make_loss_kernel (interpret mode)
    exactly, and the I/D sums within 4e-6 relative — sums of <= 40
    positive fp32 terms in two orders, each exp within an ulp of the
    other package's."""
    f, l = unit_batch(40, num_ids=10, imgs=4)
    tf, tl = torch.from_numpy(f), torch.from_numpy(l)
    st = bw.stats_plain(tf, tl, tf, tl)
    thr = (st.max_b * 0.5, st.min_w - 0.1, st.max_a)
    got = bw.loss_plain(tf, tl, tf, tl, *thr, cfg, bn=16, splits=splits,
                        tile=tile)
    want = _jax_loss_sweep(cfg.ap_mining_method * 10 + cfg.an_mining_method,
                           f, l, cfg, thr, 8)
    assert float(got[2].sum()) > 0 and float(got[3].sum()) > 0
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    for g_, w_ in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g_.numpy(), w_, rtol=4e-6)


@pytest.mark.parametrize("n,sms,want", [(120, 132, 1), (8192, 132, 4),
                                        (32768, 132, 1), (16384, 132, 2),
                                        (1000, 5, 8)])
def test_pool_splits_fill_the_card(n, sms, want):
    """The hist/loss kernels' cluster split, as ``loss_plain(splits=)``
    needs it to mirror a card's order: two resident blocks per SM."""
    assert bw.pool_splits(n, n, sms) == want


def test_hist_and_loss_operands_pad_only_to_recompute():
    """The recompute hist/loss kernels copy feature rows 16 bytes at a
    time (D padded to a multiple of 4 with zeros); the cached variants
    read only the cache and leave the features as they are."""
    f = torch.from_numpy(np.random.default_rng(14).standard_normal(
        (6, 30)).astype(np.float32))
    ff, pp, d = bw._operands(f, f, None)
    assert d == 32 and ff is pp and torch.equal(ff[:, :30], f)
    assert not ff[:, 30:].any()
    sims = f @ f.T
    assert bw._operands(f, f, sims) == (f, f, 30)
    bw._check_cache(sims, 6, 6, "npair_loss")
    with pytest.raises(ValueError, match="sim cache"):
        bw._check_cache(sims[:5], 6, 6, "npair_loss")
