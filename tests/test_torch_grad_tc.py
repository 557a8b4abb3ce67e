"""The bf16 mode's gq/gdb on Hopper's tensor cores (``npair_grad_tc_kernel``
in ``csrc/npair_blockwise.cu``), checked on the CPU.

The kernel sums bf16(W) @ bf16(X) over 128-row tiles of the other axis,
tiles in increasing order, each ``wgmma.m64n128k16`` taking a 16-deep
block of products into the fp32 accumulator.  ``tile_order`` is that sum
in plain PyTorch: exact products of bf16 values summed per 16-deep block
(in float64, rounded to fp32), the blocks added to an fp32 accumulator in
increasing order.  Held here:

(a) against the plain sweep ``grad_plain`` (one fp32 sum per tile, the
    port's CPU path and chip_smoke's reference for the card) within 1e-4
    of the largest entry, the tolerance chip_smoke holds the card to, in
    both roles, N, M in {120, 200, 300}, D in {68, 256}; and against
    JAX's ``_run_bwd`` (the DEFAULT-precision ``_make_gq_kernel`` /
    ``_make_gdb_kernel``, interpret mode) on pre-rounded features.  JAX
    on the CPU rounds no operand, so its weight tile is unrounded and
    both port orders differ from it by that rounding (~2^-9 a weight);
    the tile order adds at most the card's 1e-4 to that difference;
(b) ``round_bf16``'s bf16 rows on the CPU: ``.to(torch.bfloat16)`` bit
    for bit, zero past D to a multiple of 8 columns, no launch counted;
(c) what the CUDA route refuses: CPU tensors, the bf16 mode without the
    bf16 rows, and bf16 rows of the wrong dtype, width, row count or
    layout.
Inputs come from a numpy seed.
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
# chip_smoke's bound on the card's gq/gdb against the plain sweep.
CARD_TOL = 1e-4
# Positives less similar than the hardest negative, negatives more
# similar than the easiest positive: both sides select a share of pairs.
CFG = tnl.NPairLossConfig(ap_mining_method=M.HARD, an_mining_method=M.HARD,
                          margin_ident=0.05, margin_diff=-0.05)


def tile_order(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """w @ x as the tensor-core kernel sums it: 16-deep blocks of exact
    products (128-row tiles hold 8 of them, the tile past the end zero
    weights), each block rounded to fp32 and added to an fp32
    accumulator, blocks in increasing order."""
    acc = torch.zeros((w.shape[0], x.shape[1]), dtype=torch.float32)
    for k0 in range(0, w.shape[1], 16):
        acc = acc + (w[:, k0:k0 + 16].double()
                     @ x[k0:k0 + 16].double()).float()
    return acc


def _unit(rng, rows, d):
    x = rng.standard_normal((rows, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _batch(seed, n, m, d):
    """n queries and a pool of m rows over n // 3 identities."""
    rng = np.random.default_rng(seed)
    ids = max(n // 3, 2)
    return (torch.from_numpy(_unit(rng, n, d)),
            torch.from_numpy(rng.integers(0, ids, n).astype(np.int32)),
            torch.from_numpy(_unit(rng, m, d)),
            torch.from_numpy(rng.integers(0, ids, m).astype(np.int32)))


def _grad_inputs(f, lf, p, lp):
    """The backward's per-query inputs from the plain sweeps in the bf16
    mode (thresholds from the stats, I and A from the loss sweep), and
    the weight tile over the whole (query x pool) matrix as the kernels
    build it, rounded to bf16."""
    n, m = f.shape[0], p.shape[0]
    kw = dict(bn=128, bm=128, matmul_precision=DEFAULT)
    st = bw.stats_plain(f, lf, p, lp, emit_sims=True, **kw)
    pos_thr, neg_thr = st.max_b, st.min_w
    isum, dsum, _, _ = bw.loss_plain(f, lf, p, lp, pos_thr, neg_thr,
                                     st.max_a, CFG, sims=st.sims, bn=128,
                                     bm=128, matmul_precision=DEFAULT)
    asum = isum + dsum
    valid, g = torch.ones(n), torch.tensor(1.25)
    args = (pos_thr, neg_thr, st.max_a, isum, asum, valid, g, CFG)
    same, diff = bw._tile_masks(lf, lp, (0, n), (0, m), 0)
    pt, nt = bw._margined(pos_thr, neg_thr, CFG)
    a, b = bw._query_terms(isum, asum, valid, g, n)
    w = bw._weight_tile(st.sims, same, diff, pt[:, None], nt[:, None],
                        st.max_a[:, None], a[:, None], b[:, None], CFG,
                        bf16=True)
    return args, st.sims, w


def _err(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("d", [68, 256])
@pytest.mark.parametrize("n,m", [(120, 120), (200, 300), (300, 200)])
def test_tile_order_matches_the_plain_sweep(n, m, d):
    f, lf, p, lp = _batch(n + 7 * m + d, n, m, d)
    args, sims, w = _grad_inputs(f, lf, p, lp)
    assert int((w != 0).sum()) > n  # both sides select pairs
    assert torch.equal(w, tnl.bf16_round(w))
    fr, pr = tnl.bf16_round(f), tnl.bf16_round(p)
    for pool_major, want in ((False, tile_order(w, pr)),
                             (True, tile_order(w.T, fr))):
        got = bw.grad_plain(f, lf, p, lp, *args, pool_major, sims=sims,
                            bn=128, bm=128, matmul_precision=DEFAULT)
        assert got.shape == want.shape
        assert _err(want, got) <= CARD_TOL, pool_major


def _jax_cfg(cfg):
    kw = dataclasses.asdict(cfg)
    for k in ("ap_mining_region", "an_mining_region"):
        kw[k] = jnl.MiningRegion(int(kw[k]))
    for k in ("ap_mining_method", "an_mining_method"):
        kw[k] = jnl.MiningMethod(int(kw[k]))
    return jnl.NPairLossConfig(**kw)


@pytest.mark.parametrize("d", [68, 256])
@pytest.mark.parametrize("n", [120, 300])
def test_tile_order_against_jax_default_precision(n, d):
    f, lf, _, _ = _batch(3 * n + d, n, n, d)
    fr = tnl.bf16_round(f)
    args, sims, w = _grad_inputs(fr, lf, fr, lf)
    b = 128
    pad = lambda t: jpn._pad_rows(jnp.asarray(t.numpy()), b)  # noqa: E731
    scal = jnp.array([n, 0, n], jnp.int32)
    thr = [pad(t) for t in args[:6]]
    g = float(args[6])

    @jax.jit
    def bwd(jf, jl, thr):
        with jnl.matmul_precision_ctx(DEFAULT):
            return jpn._run_bwd(jf, jl, jf, jl, scal, *thr, g,
                                _jax_cfg(CFG), b, b, True)

    jgq, jgdb = (np.array(t)[:n] for t in bwd(pad(fr), pad(lf), thr))
    for pool_major, tile, jax_out in ((False, tile_order(w, fr), jgq),
                                      (True, tile_order(w.T, fr), jgdb)):
        plain = bw.grad_plain(fr, lf, fr, lf, *args, pool_major, sims=sims,
                              bn=b, bm=b, matmul_precision=DEFAULT)
        want = torch.from_numpy(jax_out)
        e_tile, e_plain = _err(tile, want), _err(plain, want)
        # The weight tile's rounding separates both from JAX ...
        assert 0 < e_plain <= 1e-2, pool_major
        # ... and the tile order adds no more than the card's tolerance.
        assert e_tile <= e_plain + CARD_TOL, (pool_major, e_tile, e_plain)


@pytest.mark.parametrize("d", [5, 68, 256])
def test_round_bf16_rows16_on_cpu_is_the_plain_cast(d):
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.standard_normal((37, d)).astype(np.float32))
    x[0, :3] = torch.tensor([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -0.0])
    _build.reset_launch_counts()
    rounded, rows16 = bw.round_bf16(x)
    assert torch.equal(rounded.view(torch.int32),
                       x.to(torch.bfloat16).float().view(torch.int32))
    assert rows16.dtype == torch.bfloat16 and rows16.is_contiguous()
    assert rows16.shape == (37, -(-d // 8) * 8)
    assert torch.equal(rows16[:, :d].view(torch.int16),
                       x.to(torch.bfloat16).view(torch.int16))
    assert not rows16[:, d:].float().any()
    assert torch.equal(bw.round_bf16(rounded)[0], rounded)
    assert _build.launch_counts()["round_bf16"] == 0


def test_the_engine_hands_the_bf16_rows_to_the_backward_and_counts_none():
    f, lf, _, _ = _batch(5, 24, 24, 12)
    _build.reset_launch_counts()
    _, _, res = bw._forward(f, lf, CFG, 8, 8, True, 8, DEFAULT)
    assert torch.equal(res["rows16"][:, :12].float(), res["feats"])
    assert res["rows16"].shape == (24, 16)
    _, _, res32 = bw._forward(f, lf, CFG, 8, 8, True, 8, None)
    assert res32["rows16"] is None
    x = f.clone().requires_grad_()
    bw.blockwise_npair_loss(x, lf, CFG, block_size=8,
                            matmul_precision=DEFAULT).backward()
    assert torch.isfinite(x.grad).all() and x.grad.abs().sum() > 0
    assert all(v == 0 for v in _build.launch_counts().values())


def _grad_args(n=6, d=8):
    f, lf, _, _ = _batch(1, n, n, d)
    z = torch.zeros(n)
    return (f, lf, f, lf, z, z, z, z + 1, z + 1, z + 1, torch.ones(()),
            CFG)


@pytest.mark.parametrize("pool_major", [False, True])
def test_the_cuda_route_refuses_cpu_tensors_and_missing_rows(pool_major):
    args = _grad_args()
    for bf16 in (False, True):
        rows16 = bw._rows16_plain(args[0]) if bf16 else None
        with pytest.raises(ValueError, match="CPU or CUDA"):
            bw._launch_grad("npair_gq", pool_major, *args, 0, None, bf16,
                            rows16)
    with pytest.raises(ValueError, match=r"rows16=round_bf16\(%s\)"
                       % ("feats" if pool_major else "pool")):
        bw._launch_grad("npair_gq", pool_major, *args, 0, None, True, None)
    with pytest.raises(ValueError, match="contiguous float32 CUDA"):
        bw.round_bf16(args[0].to("meta"))
    with pytest.raises(ValueError, match=r"\[rows, D\]"):
        bw.round_bf16(args[0][0])


@pytest.mark.parametrize("bad", ["float32", "width", "rows", "layout",
                                 "narrow"])
def test_bf16_rows_of_the_wrong_form_are_refused(bad):
    x = torch.zeros((10, 68))
    good = bw._rows16_plain(x)
    assert good.shape == (10, 72)
    bw._check_rows16("npair_gdb", good, x)
    rows16 = {"float32": good.float(),
              "width": torch.zeros((10, 68), dtype=torch.bfloat16),
              "rows": torch.zeros((9, 72), dtype=torch.bfloat16),
              "layout": torch.zeros((72, 10), dtype=torch.bfloat16).T,
              "narrow": torch.zeros((10, 64), dtype=torch.bfloat16)}[bad]
    with pytest.raises(ValueError, match="bf16 rows"):
        bw._check_rows16("npair_gdb", rows16, x)

