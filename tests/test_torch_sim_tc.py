"""The bf16 mode's shared sim tile on Hopper's tensor cores
(``sim_tiles_tc`` / ``sim_slice_tc`` in ``csrc/npair_blockwise.cu``: the
sims of stats, the recompute hist and loss sweeps and the recompute
gq/gdb), checked on the CPU.

The card sums each sim of bf16 rows with ``wgmma.m64n128k16``: A the
query rows, B the pool rows, 16-deep blocks of products taken into an
fp32 accumulator that starts at +0 (scale-d 0), blocks in increasing k;
a finished sim is staged as ``v + 0`` (-0 becomes +0).
``sim_tile_order`` is that sum in plain PyTorch: exact products of bf16
values summed per 16-deep block in float64, rounded to fp32, added to an
fp32 accumulator from +0.  Held here:

(a) against the plain sweeps' product (``_sim_tile`` on rounded rows,
    the port's CPU path) within 1e-5, the bound chip_smoke holds the
    card's emitted sims to against cuBLAS's bf16 product of the same
    rows, for N, M in {120, 200, 300} and D in {68, 256, 512}; on zero
    and orthogonal rows it holds no -0;
(b) ``stats_plain`` and ``loss_plain`` fed the model's sims (``sims=``)
    against JAX's ``_run_stats`` and ``_run_loss`` in DEFAULT precision
    (Pallas in interpret mode) on pre-rounded features: counts exactly;
    minima, maxima, the K-slot buffer and the I/D sums within 1e-5 (JAX
    on the CPU rounds no operand, so on pre-rounded features its sims
    are fp32 sums of the same exact products in XLA's order: the two
    differ by the fp32 rounding of D-term sums of unit rows, ~1e-7);
(c) in the bf16 mode the engine hands its bf16 rows to stats, hist and
    loss (spied sweeps), none in the fp32 mode, and counts no launch on
    the CPU;
(d) what the CUDA routes of stats, hist and loss refuse: CPU tensors, a
    missing ``rows16`` in the bf16 mode (the cached hist and loss read
    only the cache and take none), and bf16 rows of the wrong dtype,
    width, row count or alignment, a pair of tensors, and any rows where
    pool is not feats (one tensor of rows serves both operands).
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
# chip_smoke's bound on the card's emitted sims (unit rows) against
# cuBLAS's bf16 product of the same rows.
CARD_TOL = 1e-5
# RAND on both sides selects every pair: the I/D sums then depend on the
# sims alone, not on which side of a threshold a sim falls.
RAND = tnl.NPairLossConfig(ap_mining_method=M.RAND,
                           an_mining_method=M.RAND)


def sim_tile_order(a16: torch.Tensor, b16: torch.Tensor) -> torch.Tensor:
    """a16 @ b16.T as the tensor cores sum it: 16-deep blocks of exact
    products of bf16 values (float64 sums, rounded to fp32), added to an
    fp32 accumulator that starts at +0, blocks in increasing k."""
    acc = torch.zeros((a16.shape[0], b16.shape[0]), dtype=torch.float32)
    for k0 in range(0, a16.shape[1], 16):
        acc = acc + (a16[:, k0:k0 + 16].double()
                     @ b16[:, k0:k0 + 16].double().T).float()
    return acc


def _unit(rng, rows, d):
    x = rng.standard_normal((rows, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _batch(seed, n, m, d):
    """n queries and a pool of m unit rows over n // 3 identities."""
    rng = np.random.default_rng(seed)
    ids = max(n // 3, 2)
    return (torch.from_numpy(_unit(rng, n, d)),
            torch.from_numpy(rng.integers(0, ids, n).astype(np.int32)),
            torch.from_numpy(_unit(rng, m, d)),
            torch.from_numpy(rng.integers(0, ids, m).astype(np.int32)))


def _rows16(x):
    return bw.round_bf16(x)[1]


@pytest.mark.parametrize("d", [68, 256, 512])
@pytest.mark.parametrize("n,m", [(120, 120), (200, 300), (300, 200)])
def test_tile_order_matches_the_plain_product(n, m, d):
    f, _, p, _ = _batch(n + 7 * m + d, n, m, d)
    model = sim_tile_order(_rows16(f), _rows16(p))
    fr, pr = tnl.bf16_round(f), tnl.bf16_round(p)
    plain = bw._sim_tile(fr, pr, None, (0, n), (0, m))
    assert model.shape == plain.shape == (n, m)
    err = float((model - plain).abs().max())
    assert 0 < err <= CARD_TOL, err


def test_tile_order_holds_no_negative_zero():
    """Zero rows of either sign against rows of one sign: every product
    is -0, which a sum that starts from its first product keeps and the
    card's +0 start (or its staging's v + 0) does not."""
    d = 40
    rows = torch.zeros((6, d))
    rows[1] = -0.0
    rows[2] = -(d ** -0.5)
    rows[3] = d ** -0.5
    rows[4, 0] = 1.0
    rows[5, 1] = -1.0
    model = sim_tile_order(_rows16(rows), _rows16(rows))
    zero = model == 0
    assert int(zero.sum()) >= 20
    assert not bool((zero & torch.signbit(model)).any())
    rr = tnl.bf16_round(rows)
    prods = rr[:, None, :] * rr[None, :, :]
    naive = prods[..., 0]
    for k in range(1, d):
        naive = naive + prods[..., k]
    assert bool((naive == 0).logical_and(torch.signbit(naive)).any())
    assert torch.equal(zero, naive == 0)


def _jax_cfg(cfg):
    kw = dataclasses.asdict(cfg)
    for k in ("ap_mining_region", "an_mining_region"):
        kw[k] = jnl.MiningRegion(int(kw[k]))
    for k in ("ap_mining_method", "an_mining_method"):
        kw[k] = jnl.MiningMethod(int(kw[k]))
    return jnl.NPairLossConfig(**kw)


@pytest.mark.parametrize("n,d", [(120, 68), (200, 256)])
def test_plain_sweeps_on_the_model_sims_match_jax_default(n, d):
    f, lf, _, _ = _batch(5 * n + d, n, n, d)
    fr = tnl.bf16_round(f)
    sims = sim_tile_order(_rows16(f), _rows16(f))
    st = bw.stats_plain(fr, lf, fr, lf, topk=8, sims=sims, bn=128, bm=128,
                        matmul_precision=DEFAULT)
    b = 128
    pad = lambda t: jpn._pad_rows(jnp.asarray(t.numpy()), b)  # noqa: E731
    scal = jnp.array([n, 0, n], jnp.int32)
    jcfg = _jax_cfg(RAND)

    @jax.jit
    def run(jf, jl):
        with jnl.matmul_precision_ctx(DEFAULT):
            js = jpn._run_stats(jf, jl, jf, jl, scal, b, b, True,
                                topk_same=8)
            thr = [jnp.zeros_like(js[0]), jnp.zeros_like(js[0]), js[2]]
            return js, jpn._run_loss(jf, jl, jf, jl, scal, *thr, jcfg, b, b,
                                     True)

    js, jl_out = run(pad(fr), pad(lf))
    js = [None if x is None else np.asarray(x)[:n] for x in js]
    # Counts exactly, sims within the card's bound.
    np.testing.assert_array_equal(st.cnt_s.numpy(), js[3])
    np.testing.assert_array_equal(st.cnt_d.numpy(), js[4])
    for got, want in ((st.min_w, js[0]), (st.max_b, js[1]),
                      (st.max_a, js[2]), (st.topk, js[7])):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=CARD_TOL)
    # The loss sweep on the model's sims in the kernels' I/D order, each
    # side's own max_all: every pair selected.
    zero = torch.zeros(n)
    isum, dsum, inum, dnum = bw.loss_plain(
        fr, lf, fr, lf, zero, zero, st.max_a, RAND, sims=sims, bn=128,
        bm=128, matmul_precision=DEFAULT)
    ji, jd, jin, jdn = (np.asarray(x)[:n] for x in jl_out)
    np.testing.assert_array_equal(inum.numpy(), jin)
    np.testing.assert_array_equal(dnum.numpy(), jdn)
    np.testing.assert_array_equal(inum.numpy(), st.cnt_s.numpy())
    for name, got, want in (("isum", isum, ji), ("dsum", dsum, jd)):
        np.testing.assert_allclose(got.numpy(), want, rtol=CARD_TOL,
                                   err_msg=_sum_diff(name, got.numpy(), want))


def _sum_diff(name, got, want, rows=8):
    """The failure's evidence: the first differing rows, then JAX's
    ``want`` and the port's ``got`` whole (the tolerance is the
    assertion's own)."""
    bad = np.nonzero(~np.isclose(got, want, rtol=CARD_TOL, atol=0))[0]
    lines = [f"{name}: {bad.size} row(s) differ beyond rtol={CARD_TOL}"]
    for i in bad[:rows]:
        g, w = float(got[i]), float(want[i])
        rel = abs(g - w) / max(abs(w), 1e-30)
        lines.append(f"  row {i}: got {g!r} want {w!r} rel {rel:.3e}")
    full = dict(threshold=np.inf, precision=9)
    lines.append(f"{name} want (JAX) = {np.array2string(want, **full)}")
    lines.append(f"{name} got (port) = {np.array2string(got, **full)}")
    return "\n".join(lines)


@pytest.mark.parametrize("precision", [DEFAULT, None])
def test_the_engine_hands_its_bf16_rows_to_stats_hist_and_loss(
        precision, monkeypatch):
    f, lf, _, _ = _batch(9, 24, 24, 12)
    seen = []

    def spy(name, fn):
        def run(*args, **kw):
            seen.append((name, kw.get("rows16")))
            return fn(*args, **kw)
        return run

    for name in ("stats_plain", "hist_plain", "loss_plain"):
        monkeypatch.setattr(bw, name, spy(name, getattr(bw, name)))
    # Both sides relative: no K-slot buffer, the hist sweep runs per digit.
    cfg = tnl.NPairLossConfig(ap_mining_method=M.RELATIVE_HARD,
                              an_mining_method=M.RELATIVE_HARD)
    _build.reset_launch_counts()
    for cache in (True, False):
        seen.clear()
        _, _, res = bw._forward(f, lf, cfg, 8, 8, cache, 8, precision)
        names = [s[0] for s in seen]
        assert names == ["stats_plain"] + ["hist_plain"] * 7 + ["loss_plain"]
        if precision is None:
            assert res["rows16"] is None
            assert all(r is None for _, r in seen)
        else:
            assert res["rows16"].dtype == torch.bfloat16
            assert all(r is res["rows16"] for _, r in seen)
    assert all(v == 0 for v in _build.launch_counts().values())


def _sweep_args(n=6, d=8, same=True):
    f, lf, p, lp = _batch(3, n, n + 2, d)
    if same:
        p, lp = f, lf
    return f, lf, p, lp


def _stats(f, lf, p, lp, bf16, rows16):
    return bw._launch_stats(f, lf, p, lp, 0, True, False, 8, True, bf16,
                            rows16)


def _hist(f, lf, p, lp, bf16, rows16, sims=None):
    pre = [torch.zeros(f.shape[0], dtype=torch.int32)]
    return bw._launch_hist(f, lf, p, lp, [True], pre, 1, 0, sims, None,
                           bf16, rows16)


def _loss(f, lf, p, lp, bf16, rows16, sims=None):
    z = torch.zeros(f.shape[0])
    return bw._launch_loss(f, lf, p, lp, z, z, z, RAND, 0, sims, bf16,
                           rows16)


ROUTES = {"npair_stats": _stats, "npair_hist": _hist, "npair_loss": _loss}


@pytest.mark.parametrize("what", sorted(ROUTES))
def test_the_cuda_routes_refuse_cpu_tensors_and_missing_rows(what):
    route = ROUTES[what]
    f, lf, p, lp = _sweep_args()
    for bf16, rows16 in ((False, None), (True, _rows16(f))):
        with pytest.raises(ValueError, match="CPU or CUDA"):
            route(f, lf, p, lp, bf16, rows16)
    with pytest.raises(ValueError, match=r"rows16=round_bf16\(feats\)"):
        route(f, lf, p, lp, True, None)
    # One tensor of rows serves feats and pool: pool must be feats.
    f2, lf2, p2, lp2 = _sweep_args(same=False)
    for rows16 in (_rows16(f2), (_rows16(f2), _rows16(p2))):
        with pytest.raises(ValueError, match="pool must be feats"):
            route(f2, lf2, p2, lp2, True, rows16)
    if what != "npair_stats":
        # The cached variant reads only the cache: no rows needed.
        sims = torch.zeros((f.shape[0], p.shape[0]))
        with pytest.raises(ValueError, match="CPU or CUDA"):
            route(f, lf, p, lp, True, None, sims=sims)


def _misaligned(rows, width):
    buf = torch.zeros(rows * width + 1, dtype=torch.bfloat16)
    out = buf[1:].view(rows, width)
    assert out.is_contiguous() and out.data_ptr() % 16
    return out


@pytest.mark.parametrize("bad", ["float32", "width", "rows", "layout",
                                 "narrow", "alignment", "pair"])
@pytest.mark.parametrize("what", sorted(ROUTES))
def test_bf16_rows_of_the_wrong_form_are_refused(what, bad):
    f, lf, p, lp = _sweep_args(n=10, d=68)
    good = _rows16(f)
    assert good.shape == (10, 72)
    rows16 = {"float32": good.float(),
              "width": torch.zeros((10, 68), dtype=torch.bfloat16),
              "rows": torch.zeros((9, 72), dtype=torch.bfloat16),
              "layout": torch.zeros((72, 10), dtype=torch.bfloat16).T,
              "narrow": torch.zeros((10, 64), dtype=torch.bfloat16),
              "alignment": _misaligned(10, 72),
              "pair": (good, good),
              }[bad]
    with pytest.raises(ValueError, match="bf16 rows"):
        ROUTES[what](f, lf, p, lp, True, rows16)


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("pool_major", [False, True])
def test_the_grad_routes_take_one_tensor_of_rows(pool_major, cached):
    # gq/gdb read the same one tensor of bf16 rows: with a pool that is
    # not feats they refuse it, cached or not.
    f, lf, p, lp = _sweep_args(same=False)
    z = torch.zeros(f.shape[0])
    rest = (z, z, z, z + 1, z + 1, z + 1, torch.ones(()), RAND, 0,
            torch.zeros((f.shape[0], p.shape[0])) if cached else None, True)
    with pytest.raises(ValueError, match="pool must be feats"):
        bw._launch_grad("npair_gq", pool_major, f, lf, p, lp, *rest,
                        _rows16(p if not pool_major else f))
    f, lf, p, lp = _sweep_args()
    with pytest.raises(ValueError, match="CPU or CUDA"):
        bw._launch_grad("npair_gq", pool_major, f, lf, p, lp, *rest,
                        _rows16(f))
