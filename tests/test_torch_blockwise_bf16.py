"""The blockwise engine's single-pass bf16 mode (``matmul_precision=
"default"``, the Pallas kernels' DEFAULT precision): every product reads
bf16-rounded operands (round to nearest even) and accumulates in fp32,
and gq/gdb round their weight tile too.  On the CPU the plain sweeps run
it; the card's kernels are held to them by chip_smoke.py.

JAX's ``"default"`` on the CPU computes in fp32 and rounds nothing, so
it is no oracle for this mode.  The oracles here:
  * float64 NumPy sums of products of operands rounded to bf16 by bit
    arithmetic (not by torch): the plain sweeps' sims and gq/gdb within
    1e-6 of their largest entry (fp32 sums of exact products);
  * JAX's blockwise engine at ``"highest"`` (Pallas in interpret mode)
    on the features pre-rounded to bf16: the same sims up to fp32
    summation order, so the loss within 1e-5 relative, pair counts
    equal, thresholds within 1e-6; the gradients then differ only by
    the rounding of the weight tile, measured here against the
    gradient's norm and held within 1e-2 (bf16 keeps 8 bits: each weight
    moves by up to 2^-9 of itself, ~2e-3 relative on average);
  * the port's dense engine at ``"default"``: loss within 1e-6, the
    gradient within 1e-5 of its norm (the same rounded operands and
    rounded coefficients, summed in another order).
And the mode's own invariants bit for bit: sim cache on = off,
``pos_topk`` 8 = 0, and ``"highest"``/``None`` unchanged.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npairloss_tpu.ops import pallas_npair as jpn
from npairloss_tpu_torch.ops import _build
from npairloss_tpu_torch.ops import blockwise_npair as bw
from npairloss_tpu_torch.ops import npair_loss as tnl

jnl = importlib.import_module("npairloss_tpu.ops.npair_loss")
M = tnl.MiningMethod
DEFAULT = "default"
CONFIGS = {
    "reference": tnl.REFERENCE_CONFIG,
    "local_rand": tnl.NPairLossConfig(),
    "rel_both": tnl.NPairLossConfig(
        ap_mining_method=M.RELATIVE_EASY, identsn=-0.5,
        an_mining_method=M.RELATIVE_HARD, diffsn=-0.3),
    "hard_true": tnl.NPairLossConfig(
        ap_mining_method=M.HARD, an_mining_method=M.HARD,
        margin_diff=-0.05, grad_mode="true"),
}


def bf16_np(x):
    """fp32 -> bf16 -> fp32 by bit arithmetic: round to nearest even on
    the upper 16 bits (finite inputs)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def unit_batch(seed, num_ids, imgs, dim=24):
    rng = np.random.default_rng(seed)
    lab = np.repeat(rng.choice(10 * num_ids, num_ids, replace=False), imgs)
    f = rng.standard_normal((len(lab), dim)).astype(np.float32)
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    perm = rng.permutation(len(lab))
    return f[perm], lab[perm].astype(np.int32)


def port(f, l, cfg, engine="blockwise", **kw):
    x = torch.tensor(f, requires_grad=True)
    if engine == "blockwise":
        loss, aux = bw.blockwise_npair_loss_with_aux(
            x, torch.from_numpy(l), cfg, **kw)
    else:
        loss, aux = tnl.npair_loss_with_aux(x, torch.from_numpy(l), cfg, **kw)
    loss.backward()
    return (loss.detach().numpy(), {k: v.numpy() for k, v in aux.items()
                                    if k in ("ident_num", "diff_num",
                                             "pos_threshold",
                                             "neg_threshold")},
            x.grad.numpy())


def jax_cfg(cfg):
    kw = dataclasses.asdict(cfg)
    for k in ("ap_mining_region", "an_mining_region"):
        kw[k] = jnl.MiningRegion(int(kw[k]))
    for k in ("ap_mining_method", "an_mining_method"):
        kw[k] = jnl.MiningMethod(int(kw[k]))
    return jnl.NPairLossConfig(**kw)


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_bf16_rounding_is_round_to_nearest_even():
    """torch's cast (the plain sweeps') equals the bit-arithmetic oracle,
    ties to even included."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(4096).astype(np.float32)
    ties = (np.arange(1, 65, dtype=np.uint32) << 16 | 0x8000).view(
        np.float32)
    x = np.concatenate([x, ties, -ties, np.float32([0.0, -0.0, 1e-30])])
    got = tnl.bf16_round(torch.from_numpy(x)).numpy()
    assert np.array_equal(got.view(np.uint32), bf16_np(x).view(np.uint32))


def test_plain_sweeps_in_bf16_mode_match_a_float64_oracle():
    f, l = unit_batch(4, num_ids=6, imgs=3)
    tf, tl = torch.from_numpy(f), torch.from_numpy(l)
    fr = bf16_np(f).astype(np.float64)
    want_sims = fr @ fr.T
    st = bw.stats_plain(tf, tl, tf, tl, emit_sims=True, bn=5, bm=7,
                        matmul_precision=DEFAULT)
    assert _rel(st.sims.numpy(), want_sims) <= 1e-6
    st32 = bw.stats_plain(tf, tl, tf, tl, emit_sims=True, bn=5, bm=7)
    assert _rel(st32.sims.numpy(), f.astype(np.float64) @ f.T) <= 1e-6
    assert not torch.equal(st.sims, st32.sims)  # the mode did round
    cfg = tnl.REFERENCE_CONFIG
    _, _, res = bw._forward(tf, tl, cfg, 5, 7, True, 8, DEFAULT)
    n = len(l)
    g = torch.ones(())
    valid = torch.ones(n)
    args = (tf, tl, tf, tl, res["pos_thr"], res["neg_thr"], res["max_all"],
            res["ident_sum"], res["all_sum"], valid, g, cfg)
    # The weight matrix as the sweeps build it (one whole tile).
    same, diff = bw._tile_masks(tl, tl, (0, n), (0, n), 0)
    pt, nt = bw._margined(res["pos_thr"], res["neg_thr"], cfg)
    a, b = bw._query_terms(res["ident_sum"], res["all_sum"], valid, g, n)
    w = bw._weight_tile(res["sims"], same, diff, pt[:, None], nt[:, None],
                        res["max_all"][:, None], a[:, None], b[:, None], cfg,
                        bf16=True).numpy()
    assert np.array_equal(w, bf16_np(w))  # the tile is rounded
    w = w.astype(np.float64)
    for pm, want in ((False, w @ fr), (True, w.T @ fr)):
        got = bw.grad_plain(*args, pm, sims=res["sims"], bn=5, bm=7,
                            matmul_precision=DEFAULT)
        assert _rel(got.numpy(), want) <= 1e-6, pm
        # Recomputing the sims from the rounded operands: the same bits.
        assert torch.equal(got, bw.grad_plain(*args, pm, bn=5, bm=7,
                                              matmul_precision=DEFAULT))


@pytest.mark.parametrize("name", ["reference", "hard_true"])
def test_default_mode_against_jax_blockwise_on_prerounded_features(name):  # slow-ok: the bf16 mode against JAX's Pallas kernels in interpret mode
    cfg = CONFIGS[name]
    f, l = unit_batch(5, num_ids=5, imgs=2)
    fr = bf16_np(f)
    step = jax.jit(jax.value_and_grad(
        lambda x: jpn.blockwise_npair_loss_with_aux(
            x, jnp.asarray(l), jax_cfg(cfg), block_size=16,
            matmul_precision="highest", interpret=True),
        has_aux=True))
    (loss_j, aux_j), g_j = step(jnp.asarray(fr))
    loss, aux, g = port(f, l, cfg, block_size=4, matmul_precision=DEFAULT)
    np.testing.assert_allclose(loss, np.asarray(loss_j), rtol=1e-5)
    for k in ("ident_num", "diff_num"):
        np.testing.assert_array_equal(aux[k], np.asarray(aux_j[k]))
    for k in ("pos_threshold", "neg_threshold"):
        np.testing.assert_allclose(aux[k], np.asarray(aux_j[k]), rtol=1e-6)
    g_j = np.asarray(g_j)
    err = float(np.linalg.norm(g - g_j) / np.linalg.norm(g_j))
    assert 0 < err <= 1e-2, err


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_blockwise_equals_dense_in_default_mode(name):
    cfg = CONFIGS[name]
    f, l = unit_batch(6, num_ids=6, imgs=3)
    lb, ab, gb = port(f, l, cfg, block_size=5, matmul_precision=DEFAULT)
    ld, ad, gd = port(f, l, cfg, engine="dense", matmul_precision=DEFAULT)
    np.testing.assert_allclose(lb, ld, rtol=1e-6, atol=1e-6)
    for k in ("ident_num", "diff_num"):
        np.testing.assert_array_equal(ab[k], ad[k])
    for k in ("pos_threshold", "neg_threshold"):
        np.testing.assert_allclose(ab[k], ad[k], rtol=1e-6)
    assert np.linalg.norm(gb - gd) <= 1e-5 * np.linalg.norm(gd)
    # The mode changed the result (it is not the fp32 loss).
    l32 = port(f, l, cfg, block_size=5)[0]
    assert lb != l32


@pytest.mark.parametrize("name", ["reference", "rel_both"])
def test_cache_on_equals_off_and_pos_topk_in_default_mode(name):
    cfg = CONFIGS[name]
    f, l = unit_batch(7, num_ids=6, imgs=3)
    on = port(f, l, cfg, block_size=5, sim_cache=True,
              matmul_precision=DEFAULT)
    off = port(f, l, cfg, block_size=5, sim_cache=False,
               matmul_precision=DEFAULT)
    radix = port(f, l, cfg, block_size=5, sim_cache=True, pos_topk=0,
                 matmul_precision=DEFAULT)
    for other in (off, radix):
        assert on[0] == other[0]
        for k in on[1]:
            np.testing.assert_array_equal(on[1][k], other[1][k], err_msg=k)
        np.testing.assert_array_equal(on[2], other[2])


def test_highest_and_none_are_unchanged():
    f, l = unit_batch(8, num_ids=6, imgs=3)
    cfg = tnl.REFERENCE_CONFIG
    base = port(f, l, cfg, block_size=5)
    for engine in ("blockwise", "dense"):
        kw = {"block_size": 5} if engine == "blockwise" else {}
        a = port(f, l, cfg, engine, **kw)
        b = port(f, l, cfg, engine, matmul_precision="highest", **kw)
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[2], b[2])
        for k in a[1]:
            np.testing.assert_array_equal(a[1][k], b[1][k])
    np.testing.assert_array_equal(base[2], port(
        f, l, cfg, block_size=5, matmul_precision=None)[2])
    with pytest.raises(ValueError, match="matmul_precision"):
        port(f, l, cfg, block_size=5, matmul_precision="fast")
    with pytest.raises(ValueError, match="matmul_precision"):
        port(f, l, cfg, engine="dense", matmul_precision="bf16")


def test_wrappers_count_no_launch_on_cpu_in_either_mode():
    f, l = unit_batch(9, num_ids=4, imgs=2)
    _build.reset_launch_counts()
    port(f, l, tnl.REFERENCE_CONFIG, block_size=4, pos_topk=0,
         matmul_precision=DEFAULT)
    counts = _build.launch_counts()
    sweeps = ("npair_stats", "npair_hist", "npair_loss", "npair_gq",
              "npair_gdb")
    assert {k for k in counts if k.endswith(":bf16")} == {
        f"{k}:bf16" for k in sweeps}
    assert "round_bf16" in counts
    assert all(v == 0 for v in counts.values())


def test_round_bf16_on_cpu_is_the_plain_rounding():
    """The operands' rounding wrapper on a CPU tensor is
    ``.to(torch.bfloat16).float()`` bit for bit (ties to even included)
    and counts no launch."""
    x = torch.tensor([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -0.0, 3.0e38,
                      1e-40, -1.0 - 2.0 ** -8])
    x = torch.cat([x, torch.randn(1000, generator=torch.Generator()
                                  .manual_seed(3))])
    _build.reset_launch_counts()
    got, rows16 = bw.round_bf16(x[None])
    got = got[0]
    assert torch.equal(got.view(torch.int32),
                       x.to(torch.bfloat16).float().view(torch.int32))
    assert torch.equal(bw.round_bf16(got[None])[0][0], got)
    # With the bf16 rows the tensor-core gq/gdb read: the same cast,
    # zero-padded to a multiple of 8 columns.
    assert rows16.shape == (1, 1008) and rows16.dtype == torch.bfloat16
    assert torch.equal(rows16[0, :x.numel()].view(torch.int16),
                       x.to(torch.bfloat16).view(torch.int16))
    assert not rows16[0, x.numel():].float().any()
    assert _build.launch_counts()["round_bf16"] == 0
