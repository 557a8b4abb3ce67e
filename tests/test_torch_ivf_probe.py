"""The port's IVF probe (npairloss_tpu_torch/ops/ivf_probe.py and the
scan in serve/engine.py) against the JAX package: ``fused_probe_topk``
of ops/pallas_ivf.py (Pallas interpret mode on the CPU) and the scan
baseline ``engine._ivf_probe_topk``.  On CPU tensors the port's probe
wrapper runs its plain version, which repeats the CUDA kernel's
arithmetic and merge rule.

Covered: fp32/bf16/int8 scoring, ragged cluster tails, an empty cluster,
probes > clusters, kl < k, and duplicated gallery rows that pin the tie
rule (an equal score in the running best beats the new tile; a lower
cap position beats a higher one).  Rows must be identical — in every
slot for the scan, in every slot holding a real candidate for the fused
path (a slot left at -FLT_MAX carries an unspecified row until
``_finalize_topk`` pins it to 0), and in every slot after finalize.
Scores agree within 1e-5 (fp32 dots in another summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npairloss_tpu.ops import pallas_ivf as jivf
from npairloss_tpu.serve.engine import _finalize_topk, _ivf_probe_topk
from npairloss_tpu.serve.ivf import _quantize_int8
from npairloss_tpu_torch.ops import ivf_probe as tivf
from npairloss_tpu_torch.serve.engine import finalize_topk, ivf_scan_topk
from npairloss_tpu_torch.serve.ivf import quantize_int8

ATOL = 1e-5
NEG = tivf.NEG_FILL

# Cluster sizes: ragged tails (7, 13, 3) and an empty cluster (0).
SIZES = (20, 0, 7, 13, 20, 3)


def _fixture(seed=0, d=48):
    rng = np.random.default_rng(seed)
    kc, cap = len(SIZES), max(SIZES)
    n = sum(SIZES)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    # Duplicated rows: 5 == 2 inside one cluster (cap-position tie) and
    # 30 == 1 across clusters (running-best vs tile tie).
    emb[5] = emb[2]
    emb[30] = emb[1]
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    packed = np.zeros((kc, cap, d), np.float32)
    rows = np.full((kc, cap), -1, np.int32)
    cents = rng.standard_normal((kc, d)).astype(np.float32)
    start = 0
    for c, s in enumerate(SIZES):
        packed[c, :s] = emb[start:start + s]
        rows[c, :s] = np.arange(start, start + s)
        if s:
            cents[c] = emb[start:start + s].mean(0)
        start += s
    cvalid = np.array([s > 0 for s in SIZES])
    q = np.concatenate([emb[[2, 1, 40]],
                        rng.standard_normal((3, d)).astype(np.float32)])
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q, packed, rows, cents, cvalid


def _scored(packed, scoring):
    """(jax slab, jax scale, torch slab, torch scale) for a scoring."""
    if scoring == "fp32":
        return jnp.asarray(packed), None, torch.from_numpy(packed), None
    if scoring == "bf16":
        return (jnp.asarray(packed, jnp.bfloat16), None,
                torch.from_numpy(packed).to(torch.bfloat16), None)
    js, jsc = _quantize_int8(jnp.asarray(packed))
    ts, tsc = quantize_int8(torch.from_numpy(packed))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    return js, jsc, ts, tsc


CASES = [
    pytest.param(3, 5, id="probes3-k5"),
    pytest.param(9, 5, id="probes-gt-clusters"),
    pytest.param(1, 25, id="kl-lt-k"),
]


@pytest.mark.parametrize("scoring", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("probes,k", CASES)
def test_probe_matches_jax_fused_and_scan(scoring, probes, k):
    q, packed, rows, cents, cvalid = _fixture()
    js, jsc, ts, tsc = _scored(packed, scoring)
    jargs = (jnp.asarray(q), js, jnp.asarray(rows), jnp.asarray(cents),
             jnp.asarray(cvalid), jsc)
    targs = (torch.from_numpy(q), ts, torch.from_numpy(rows),
             torch.from_numpy(cents), torch.from_numpy(cvalid), tsc)
    kw = dict(k=k, probes=probes, scoring=scoring, g0=0)

    j_fs, j_fr = (np.asarray(a) for a in jivf.fused_probe_topk(*jargs, **kw))
    t_fs, t_fr = tivf.fused_probe_topk(*targs, **kw)
    assert t_fs.shape == j_fs.shape
    real = j_fs > NEG * 0.5
    np.testing.assert_array_equal(t_fs.numpy() > NEG * 0.5, real)
    np.testing.assert_allclose(t_fs.numpy(), j_fs, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(t_fr.numpy()[real], j_fr[real])

    j_ss, j_sr = (np.asarray(a) for a in _ivf_probe_topk(*jargs, **kw))
    t_ss, t_sr = ivf_scan_topk(*targs, **kw)
    np.testing.assert_allclose(t_ss.numpy(), j_ss, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(t_sr.numpy(), j_sr)

    jf_s, jf_r = (np.asarray(a) for a in _finalize_topk(
        jnp.asarray(j_fs), jnp.asarray(j_fr), k))
    tf_s, tf_r = finalize_topk(t_fs, t_fr, k)
    np.testing.assert_array_equal(tf_r.numpy(), jf_r)
    np.testing.assert_allclose(tf_s.numpy(), jf_s, atol=ATOL, rtol=0)
    ts_s, ts_r = finalize_topk(t_ss, t_sr, k)
    np.testing.assert_array_equal(ts_r.numpy(), tf_r.numpy())


def test_duplicate_rows_keep_the_tie_rule():
    """Queries equal to a duplicated row see both copies at one score;
    the lower position wins, the same as lax.top_k."""
    q, packed, rows, cents, cvalid = _fixture()
    s, r = tivf.fused_probe_topk(
        torch.from_numpy(q), torch.from_numpy(packed),
        torch.from_numpy(rows), torch.from_numpy(cents),
        torch.from_numpy(cvalid), k=4, probes=6, scoring="fp32")
    assert r[0, :2].tolist() == [2, 5]   # same cluster: cap order
    # Across clusters the copy in the earlier-probed cluster wins: it is
    # already in the running best when the other tile arrives.
    probe, _, _ = tivf.probe_select(torch.from_numpy(q),
                                    torch.from_numpy(cents),
                                    torch.from_numpy(cvalid), 6, 0, 6)
    order = probe[1].tolist()
    first = 1 if order.index(0) < order.index(3) else 30  # row 1: cluster 0
    assert r[1, :2].tolist() == [first, 31 - first]
    assert s[0, 0] == s[0, 1] and s[1, 0] == s[1, 1]


def test_probe_select_ties_go_to_the_lowest_cluster():
    q = torch.ones((2, 4))
    cents = torch.tensor([[0., 0, 0, 1], [1, 0, 0, 0], [0, 1, 0, 0],
                          [0, 0, 1, 0], [1, 1, 1, 1]])
    cvalid = torch.tensor([True, True, False, True, True])
    probe, lids, owned = tivf.probe_select(q, cents, cvalid, 4, 0, 5)
    want = jnp.where(jnp.asarray(cvalid.numpy())[None],
                     jnp.asarray(q.numpy()) @ jnp.asarray(cents.numpy()).T,
                     NEG)
    import jax

    _, jprobe = jax.lax.top_k(want, 4)
    np.testing.assert_array_equal(probe.numpy(), np.asarray(jprobe))
    assert probe[0].tolist() == [4, 0, 1, 3]
    assert owned.all() and lids.dtype == torch.int32


def test_quantize_int8_rounds_half_to_even_like_jax():
    packed = np.zeros((2, 3, 4), np.float32)
    packed[0, 0] = [127.0, 2.5, -3.5, 0.5]
    packed[1] = np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4)
    js, jsc = _quantize_int8(jnp.asarray(packed))
    ts, tsc = quantize_int8(torch.from_numpy(packed))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    assert ts[0, 0].tolist() == [127, 2, -4, 0]


def test_probe_impl_registry_and_resolution():
    assert set(tivf.PROBE_IMPLS) == set(jivf.PROBE_IMPLS)
    for name in tivf.PROBE_IMPLS:
        assert (tivf.PROBE_IMPLS[name]["dispatch_count"]
                == jivf.PROBE_IMPLS[name]["dispatch_count"])
    assert tivf.resolve_probe_impl("auto", torch.device("cuda")) == "fused"
    assert tivf.resolve_probe_impl("auto", torch.device("cpu")) == "scan"
    assert tivf.resolve_probe_impl("fused", torch.device("cpu")) == "fused"
    with pytest.raises(ValueError):
        tivf.resolve_probe_impl("pallas", torch.device("cpu"))


# -- the kernel's one-shot merge against the sequential one ---------------------
#
# The CUDA kernel computes the Pallas kernel's probe-by-probe merge in its
# closed form: one stable top-kl over [kl fillers ; probe 0's tile ; probe
# 1's ; ...], over the 64-bit keys of ``probe_keys``.  Its plain form,
# ``probe_topk_oneshot_plain``, must give the sequential ``probe_topk_plain``
# bit for bit in every slot, the fillers included, on fixtures full of ties.

# Global cluster sizes: an empty cluster (1) and ragged tails.
TIE_SIZES = (6, 0, 5, 6, 3, 6, 2, 6)


def _tie_fixture(seed, d=8):
    """Entries in {-1/2, 0, 1/2}: every fp32 dot is exact, so equal scores
    abound; row 3 copies row 0 (one cluster) and cluster 3's first row
    copies cluster 2's (two clusters), and half the queries are gallery
    rows."""
    rng = np.random.default_rng(seed)
    kc, cap, n = len(TIE_SIZES), max(TIE_SIZES), sum(TIE_SIZES)
    emb = rng.integers(-1, 2, size=(n, d)).astype(np.float32) * 0.5
    emb[3] = emb[0]
    c2 = sum(TIE_SIZES[:2])
    c3 = sum(TIE_SIZES[:3])
    emb[c3] = emb[c2]
    packed = np.zeros((kc, cap, d), np.float32)
    rows = np.full((kc, cap), -1, np.int32)
    cents = rng.integers(-1, 2, size=(kc, d)).astype(np.float32) * 0.5
    start = 0
    for c, s in enumerate(TIE_SIZES):
        packed[c, :s] = emb[start:start + s]
        rows[c, :s] = np.arange(start, start + s)
        start += s
    cvalid = np.array([s > 0 for s in TIE_SIZES])
    q = np.concatenate([
        emb[rng.choice(n, 4, replace=False)],
        rng.integers(-1, 2, size=(4, d)).astype(np.float32) * 0.5])
    return q, packed, rows, cents, cvalid


TIE_CASES = [
    # probes, k, g0, local clusters
    pytest.param(3, 5, 0, 8, id="owned"),
    pytest.param(4, 6, 2, 4, id="unowned-g0"),
    pytest.param(11, 7, 0, 8, id="probes-gt-clusters"),
    pytest.param(2, 40, 0, 8, id="kl-gt-real"),
]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("scoring", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("probes,k,g0,kc_local", TIE_CASES)
def test_oneshot_merge_equals_sequential_merge_bit_for_bit(
        probes, k, g0, kc_local, scoring, seed):
    q, packed, rows, cents, cvalid = _tie_fixture(seed)
    packed, rows = packed[g0:g0 + kc_local], rows[g0:g0 + kc_local]
    _, _, ts, tsc = _scored(packed, scoring)
    tq = torch.from_numpy(q)
    kl = min(k, min(probes, len(TIE_SIZES)) * packed.shape[1])
    _, lids, owned = tivf.probe_select(tq, torch.from_numpy(cents),
                                       torch.from_numpy(cvalid), probes, g0,
                                       kc_local)
    args = (tq, ts, torch.from_numpy(rows), lids, owned.to(torch.int32),
            tsc)
    o_s, o_r = tivf.probe_topk_oneshot_plain(*args, kl=kl, scoring=scoring)
    s_s, s_r = tivf.probe_topk_plain(*args, kl=kl, scoring=scoring)
    assert torch.equal(o_s, s_s) and torch.equal(o_r, s_r)
    real = o_s > NEG * 0.5
    # Ties really are exercised, and the unfilled slots are the fillers.
    assert (o_s[:, 1:] == o_s[:, :-1])[real[:, 1:]].any()
    assert torch.equal(o_r[~real], torch.zeros_like(o_r[~real]))
    if k == 40:
        assert (~real).any()
    # The CPU wrapper runs the one-shot form.
    w_s, w_r = tivf.probe_topk(*args, kl=kl, scoring=scoring)
    assert torch.equal(w_s, o_s) and torch.equal(w_r, o_r)


@pytest.mark.parametrize("scoring", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("probes,k,g0,kc_local", TIE_CASES)
def test_oneshot_merge_matches_jax_fused(probes, k, g0, kc_local, scoring):
    q, packed, rows, cents, cvalid = _tie_fixture(0)
    packed, rows = packed[g0:g0 + kc_local], rows[g0:g0 + kc_local]
    js, jsc, ts, tsc = _scored(packed, scoring)
    kw = dict(k=k, probes=probes, scoring=scoring, g0=g0)
    j_s, j_r = (np.asarray(a) for a in jivf.fused_probe_topk(
        jnp.asarray(q), js, jnp.asarray(rows), jnp.asarray(cents),
        jnp.asarray(cvalid), jsc, **kw))
    t_s, t_r = tivf.fused_probe_topk(
        torch.from_numpy(q), ts, torch.from_numpy(rows),
        torch.from_numpy(cents), torch.from_numpy(cvalid), tsc, **kw)
    real = j_s > NEG * 0.5
    np.testing.assert_array_equal(t_s.numpy() > NEG * 0.5, real)
    np.testing.assert_allclose(t_s.numpy(), j_s, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(t_r.numpy()[real], j_r[real])


def test_probe_keys_order_is_score_then_lowest_position():
    f32max = float(np.finfo(np.float32).max)
    scores = torch.tensor([0.0, -0.0, 1.5, 1.5, -f32max, -f32max, -1.0,
                           float("-inf"), f32max, 1e-45, -1e-45, 0.0, 1.5],
                          dtype=torch.float32)
    pos = torch.tensor([7, 3, 12, 2, 0, 9, 5, 1, 11, 4, 6, 8, 10])
    keys = tivf.probe_keys(scores, pos).tolist()
    assert len(set(keys)) == len(keys)  # unique
    by_key = sorted(range(len(keys)), key=lambda i: -keys[i])
    # -0.0 ties +0.0 (the merge's '>'), so it orders by position alone.
    want = sorted(range(len(keys)),
                  key=lambda i: (-(scores[i].item() + 0.0), pos[i].item()))
    assert by_key == want
    # The first key is the largest score; among the three 1.5s, the
    # lowest position; -0.0 at position 3 beats +0.0 at 7 and 8.
    assert by_key[0] == 8
    assert [pos[i].item() for i in by_key[1:4]] == [2, 10, 12]
    zeros = [pos[i].item() for i in by_key if scores[i] == 0]
    assert zeros == [3, 7, 8]

