"""The port's retrieval metrics (npairloss_tpu_torch/ops/metrics.py)
against the JAX package's ``ops/metrics.py`` and the NumPy oracle.

Tolerance: recall exactly (it counts queries); feature_asum and the
magnitude monitors within 1e-6 relative (fp32 sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_identity_batch
from npairloss_tpu.ops import metrics as jm
from npairloss_tpu.ops.npair_loss import NPairLossConfig, npair_loss_with_aux
from npairloss_tpu.testing import oracle
from npairloss_tpu_torch.ops import metrics as tm
from npairloss_tpu_torch.ops import npair_loss as tnl


@pytest.mark.parametrize("top_k", [1, 2, 5, 10, 40])
def test_recall_with_ties_at_the_threshold(top_k):
    """Many exact ties (values on a coarse grid): an item tied with the
    threshold does not count — strict ``>`` — exactly as JAX."""
    rng = np.random.default_rng(0)
    n = 12
    sim_exp = (rng.integers(0, 4, (n, n)) / 4.0).astype(np.float32)
    labels = np.repeat(np.arange(n // 2), 2).astype(np.int32)
    got = tm.recall_at_k(torch.from_numpy(sim_exp), torch.from_numpy(labels),
                         torch.from_numpy(labels), 0, top_k)
    want = jm.recall_at_k(jnp.asarray(sim_exp), jnp.asarray(labels),
                          jnp.asarray(labels), jnp.int32(0), top_k)
    assert got.item() == float(want)


def test_recall_tie_rule_by_hand():
    """Row 0: its positive (col 2) ties the top-1 threshold — no hit;
    row 1: its positive (col 3) is strictly above — a hit."""
    sim_exp = torch.tensor([[9.0, 0.5, 0.7, 0.7],
                            [0.1, 9.0, 0.2, 0.6]])
    lab_local = torch.tensor([0, 1])
    lab_total = torch.tensor([0, 1, 0, 1])
    assert tm.recall_at_k(sim_exp, lab_local, lab_total, 0, 1).item() == 0.5


@pytest.mark.parametrize("rank", [0, 2])
def test_retrieval_metrics_match_jax_and_oracle(rank):
    """A rank's block against the gathered pool (self column at
    ``rank*N + q``), from the same loss aux."""
    feats, labs = make_identity_batch(np.random.default_rng(1), 4, 2, 16,
                                      num_shards=3)
    gf, gl = np.concatenate(feats), np.concatenate(labs)
    f, l = feats[rank], labs[rank]
    _, aux = tnl.npair_loss_with_aux(
        torch.from_numpy(f), torch.from_numpy(l),
        total_features=torch.from_numpy(gf), total_labels=torch.from_numpy(gl),
        rank=rank, num_shards=3)
    got = tm.retrieval_metrics(aux, torch.from_numpy(l), torch.from_numpy(f))
    jaux = {"sim_exp": jnp.asarray(aux["sim_exp"].numpy()),
            "total_labels": jnp.asarray(gl), "rank": jnp.int32(rank)}
    want = jm.retrieval_metrics(jaux, jnp.asarray(l), jnp.asarray(f))
    assert list(got) == list(want)
    for k in got:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6)
    res = oracle.forward(feats, labs, NPairLossConfig())[rank]
    for k in (1, 5, 10):
        assert got[f"retrieve_top{k}"].item() == pytest.approx(res.recalls[k])
    assert got["feature_asum"].item() == pytest.approx(res.feature_asum,
                                                       rel=1e-6)


def test_feature_asum_and_magnitude_match_jax():
    rng = np.random.default_rng(2)
    f = (3 * rng.standard_normal((10, 32))).astype(np.float32)
    np.testing.assert_allclose(tm.feature_asum(torch.from_numpy(f)).item(),
                               float(jm.feature_asum(jnp.asarray(f))),
                               rtol=1e-6)
    got = tm.embedding_magnitude(torch.from_numpy(f))
    want = jm.embedding_magnitude(jnp.asarray(f))
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6)
    bf = torch.from_numpy(f).to(torch.bfloat16)
    assert tm.feature_asum(bf).dtype == torch.float32


def test_metrics_from_the_dense_loss_aux_match_jax():
    f, l = make_identity_batch(np.random.default_rng(3), 6, 2, 16)
    f, l = f[0], l[0]
    _, jaux = npair_loss_with_aux(jnp.asarray(f), jnp.asarray(l))
    want = jm.retrieval_metrics(jaux, jnp.asarray(l), jnp.asarray(f))
    _, aux = tnl.npair_loss_with_aux(torch.from_numpy(f), torch.from_numpy(l))
    got = tm.retrieval_metrics(aux, torch.from_numpy(l), torch.from_numpy(f))
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6)
