"""The port's radix rank selection (npairloss_tpu_torch/ops/rank_select.py)
against the JAX package's ``ops/rank_select.py`` on the same bits.

Everything here is integer or bit-pattern arithmetic, so every comparison
is exact: keys, digits, histograms, each (k, prefix) state of a radix
walk, and the selected values' bit patterns.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npairloss_tpu.ops import rank_select as jrs
from npairloss_tpu_torch.ops import npair_loss as tnl
from npairloss_tpu_torch.ops import rank_select as trs

# ``npairloss_tpu.ops`` re-exports a function named npair_loss.
jnl = importlib.import_module("npairloss_tpu.ops.npair_loss")

FMAX = np.finfo(np.float32).max
FTINY = np.finfo(np.float32).tiny
SPECIAL = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-40, -1e-40, FTINY, -FTINY,
                    FMAX, -FMAX, 1.0, -1.0, 0.5, -0.5, 3.0, -7.25],
                   dtype=np.float32)


def _values(seed=0, n=512):
    rng = np.random.default_rng(seed)
    rand = rng.standard_normal(n).astype(np.float32) * np.float32(10.0) ** \
        rng.integers(-30, 30, n).astype(np.float32)
    return np.concatenate([SPECIAL, rand.astype(np.float32)])


def test_sortable_key_matches_jax_bit_for_bit_and_round_trips():
    v = _values()
    got = trs.sortable_key(torch.from_numpy(v)).numpy()
    want = np.asarray(jrs.sortable_key(jnp.asarray(v))).astype(np.int64)
    np.testing.assert_array_equal(got, want)
    back = trs.key_to_float(torch.from_numpy(got)).numpy()
    np.testing.assert_array_equal(back.view(np.uint32), v.view(np.uint32))
    np.testing.assert_array_equal(
        back.view(np.uint32),
        np.asarray(jrs.key_to_float(jnp.asarray(want.astype(np.uint32))))
        .view(np.uint32))


def test_sortable_key_order_is_value_order():
    v = _values(seed=1)
    key = trs.sortable_key(torch.from_numpy(v)).numpy()
    order = np.argsort(key, kind="stable")
    assert np.all(np.diff(v[order].astype(np.float64)) >= 0)
    # -0.0 sorts just below +0.0, and the two keys differ.
    k0 = trs.sortable_key(torch.tensor([-0.0, 0.0])).tolist()
    assert k0[0] + 1 == k0[1]


@pytest.mark.parametrize("digit", range(trs.NUM_DIGITS))
def test_digits_prefixes_and_histograms_match_jax(digit):
    rng = np.random.default_rng(digit)
    sims = rng.standard_normal((6, 40)).astype(np.float32)
    sims[:, :8] = sims[:, 8:16]  # duplicates
    mask = rng.random((6, 40)) < 0.7
    key = trs.sortable_key(torch.from_numpy(sims))
    prefix = key[:, 5] >> (32 - 4 * digit) if digit else \
        torch.zeros(6, dtype=torch.int64)
    jkey = jrs.sortable_key(jnp.asarray(sims))
    jprefix = jnp.asarray(prefix.numpy().astype(np.uint32))
    np.testing.assert_array_equal(
        trs.digit_of(key, digit).numpy(),
        np.asarray(jrs.digit_of(jkey, digit)))
    np.testing.assert_array_equal(
        trs.prefix_matches(key, prefix[:, None], digit).numpy(),
        np.asarray(jrs.prefix_matches(jkey, jprefix[:, None], digit)))
    got = trs.masked_digit_hist(torch.from_numpy(sims), torch.from_numpy(mask),
                                prefix, digit)
    want = jrs.masked_digit_hist(jnp.asarray(sims), jnp.asarray(mask),
                                 jprefix, digit)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("ties", [False, True])
def test_radix_walk_matches_jax_radix_select(ties):
    """One whole radix walk, state by state, on the same populations: the
    port's (k, prefix) after every digit and the selected value's bits
    equal JAX's ``radix_select``; the value is the sorted k-th."""
    rng = np.random.default_rng(7)
    sims = rng.standard_normal((5, 64)).astype(np.float32)
    if ties:
        sims = np.round(sims * 4) / 4  # many equal values, and +-0
    mask = rng.random((5, 64)) < 0.6
    mask[4] = False  # an empty row
    count = mask.sum(1).astype(np.int32)
    k = np.minimum(rng.integers(0, 64, 5), np.maximum(count - 1, 0)).astype(
        np.int32)
    ts, tm = torch.from_numpy(sims), torch.from_numpy(mask)
    js, jm = jnp.asarray(sims), jnp.asarray(mask)

    tstate = trs.radix_begin(torch.from_numpy(k))
    jstate = jrs.radix_begin(jnp.asarray(k))
    for digit in range(trs.NUM_DIGITS):
        tstate = trs.radix_update(tstate, trs.masked_digit_hist(
            ts, tm, tstate[1], digit))
        jstate = jrs.radix_update(jstate, jrs.masked_digit_hist(
            js, jm, jstate[1], digit))
        assert tstate[0].dtype == torch.int32
        np.testing.assert_array_equal(tstate[0].numpy(), np.asarray(jstate[0]))
        np.testing.assert_array_equal(tstate[1].numpy(),
                                      np.asarray(jstate[1]).astype(np.int64))
    empty = count == 0
    got = trs.radix_finish(tstate, torch.from_numpy(empty)).numpy()
    want = np.asarray(jrs.radix_select(
        lambda p, d: jrs.masked_digit_hist(js, jm, p, d), jnp.asarray(k),
        jnp.asarray(empty)))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    got_sel = trs.radix_select(
        lambda p, d: trs.masked_digit_hist(ts, tm, p, d),
        torch.from_numpy(k), torch.from_numpy(empty)).numpy()
    np.testing.assert_array_equal(got_sel.view(np.uint32),
                                  want.view(np.uint32))
    for r in range(4):
        assert got[r] == np.sort(sims[r][mask[r]])[k[r]]
    assert got[4] == FMAX


def test_population_count_dtype_width_rule():
    for pop in (0, 120 * 120, 2 ** 31 - 1):
        assert trs.population_count_dtype(pop) == torch.int32
        assert jrs.population_count_dtype(pop) == jnp.int32
    assert trs.population_count_dtype(2 ** 31) == torch.int64
    # Where the JAX package needs x64 (and raises without it), the port
    # counts in int64, as JAX computes with x64 on.
    with pytest.raises(NotImplementedError):
        jrs.population_count_dtype(2 ** 31)


def _fp32_rank_differs(sn: float):
    """A count whose fractional rank truncates differently in fp32 (the
    JAX package's int32 rule) and in fp64."""
    c = np.arange(2_900_000, 3_100_000, dtype=np.int64)
    cf = c.astype(np.float32)
    f32 = np.trunc((cf - np.float32(1.0)) + np.float32(sn) * cf)
    f64 = np.trunc((c - 1.0) + sn * c)
    hits = np.nonzero(f32 != f64)[0]
    assert hits.size, "no such count found"
    return int(c[hits[0]])


def test_int32_sum_trap_keeps_the_rank_arithmetic_in_fp32():
    """torch sums int32 into int64 unless told otherwise, which would move
    a GLOBAL rank into fp64 arithmetic and pick a neighbouring rank for a
    fractional sn.  The port's rank path names the dtype, as JAX does."""
    counts = torch.ones(4, dtype=torch.int32)
    assert counts.sum().dtype == torch.int64  # the trap
    cdt = trs.population_count_dtype(4 * 4)
    assert counts.sum(dtype=cdt).dtype == torch.int32

    sn = -0.3
    c = _fp32_rank_differs(sn)
    want = np.asarray(jnl._relative_pos(jnp.asarray([c], jnp.int32), sn))
    got32 = tnl._relative_pos(torch.tensor([c], dtype=torch.int32), sn)
    got64 = tnl._relative_pos(torch.tensor([c], dtype=torch.int64), sn)
    assert got32.dtype == torch.int32
    np.testing.assert_array_equal(got32.numpy(), want)
    assert int(got64[0]) != int(want[0])

    # The GLOBAL fast path ranks the buffer's population in the given
    # width: equal to JAX's topk_relative_threshold on the same buffer.
    rng = np.random.default_rng(3)
    topk = np.full((6, 8), -FMAX, np.float32)
    cnt = np.array([3, 2, 5, 0, 8, 1], np.int32)
    for r, m in enumerate(cnt):
        topk[r, :m] = -np.sort(-rng.standard_normal(m).astype(np.float32))
    for region in (tnl.MiningRegion.GLOBAL, tnl.MiningRegion.LOCAL):
        for s in (-0.3, -0.0, 1.0, -0.77):
            got = tnl.topk_relative_threshold(
                torch.from_numpy(topk), torch.from_numpy(cnt), s, region,
                count_dtype=cdt)
            want = jnl.topk_relative_threshold(
                jnp.asarray(topk), jnp.asarray(cnt), s,
                jnl.MiningRegion(int(region)), count_dtype=jnp.int32)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
