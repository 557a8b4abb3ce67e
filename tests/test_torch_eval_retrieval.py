"""The port's offline retrieval evaluation
(npairloss_tpu_torch/ops/eval_retrieval.py) against
``npairloss_tpu.ops.eval_retrieval``.

Recall@K is compared exactly (each value is a count times the fp32
reciprocal of N, as JAX's mean of a 0/1 column): on random rows, with N
not a multiple of ``query_block`` and ks above N - 1; on planted
duplicate rows; on rows whose entries are 0 and +-1/2 with four nonzeros
(unit rows, every sim an exact multiple of 1/4, so ties everywhere and
the same ties in both packages); and with float labels.  The top-k order among equal sims is
also held to a stable descending sort.  ``nmi`` is the same numpy code:
within 1e-12.  ``clustering_nmi`` from JAX's first seed point gives the
same value on separated clusters.
"""

import jax
import numpy as np
import pytest
import torch

from npairloss_tpu.ops import eval_retrieval as jax_eval
from npairloss_tpu_torch.ops import eval_retrieval as port_eval


def _ties(rng, n, dim=16, distinct=40):
    """Unit rows with entries in {0, +-1/2} (four nonzeros), drawn from
    ``distinct`` patterns so rows repeat."""
    pats = np.zeros((distinct, dim), np.float32)
    for p in pats:
        p[rng.choice(dim, 4, replace=False)] = rng.choice([-0.5, 0.5], 4)
    return pats[rng.integers(0, distinct, n)]


def _case(name):
    rng = np.random.default_rng(11)
    if name == "random":
        emb = rng.standard_normal((300, 32)).astype(np.float32)
        lab = rng.integers(0, 30, 300).astype(np.int32)
        return emb, lab, (1, 2, 4, 8, 16, 32, 1000), 64
    if name == "ties":
        emb = _ties(rng, 203)
        lab = rng.integers(0, 12, 203).astype(np.int32)
        return emb, lab, (1, 2, 3, 5, 8, 50), 50
    if name == "ties_float_labels":
        emb = _ties(rng, 97, distinct=25)
        lab = rng.integers(0, 8, 97).astype(np.float32) * 0.5
        return emb, lab, (1, 4, 96, 200), 1024
    if name == "duplicates":
        base = rng.standard_normal((40, 24)).astype(np.float32)
        emb = np.concatenate([base, base[::2], base[:7]])
        lab = rng.integers(0, 6, emb.shape[0]).astype(np.int32)
        return emb, lab, (1, 2, 4, 16), 17
    raise KeyError(name)


@pytest.mark.parametrize("name", ["random", "ties", "ties_float_labels",
                                  "duplicates"])
def test_gallery_recall_matches_jax_exactly(name):
    emb, lab, ks, qb = _case(name)
    want = jax_eval.evaluate_embeddings(emb, lab, ks=ks, query_block=qb)
    got = port_eval.evaluate_embeddings(emb, lab, ks=ks, query_block=qb,
                                        device="cpu")
    assert got == want
    assert list(got) == list(dict.fromkeys(
        f"recall_at_{min(k, emb.shape[0] - 1)}" for k in ks))


def test_unnormalized_call_on_unit_rows_matches():
    emb, lab, ks, qb = _case("ties")
    want = jax_eval.gallery_recall_at_k(emb, lab, ks=ks, query_block=qb,
                                        normalize=False)
    got = port_eval.gallery_recall_at_k(torch.as_tensor(emb),
                                        torch.as_tensor(lab), ks=ks,
                                        query_block=qb, normalize=False)
    assert {k: float(v) for k, v in got.items()} == \
        {k: float(v) for k, v in want.items()}


def test_rank_keys_order_ties_by_lowest_index():
    rng = np.random.default_rng(3)
    sims = rng.choice(np.array([-1.0, -0.5, 0.0, 0.25, 0.5], np.float32),
                      (6, 40))
    top = torch.topk(port_eval._rank_keys(torch.as_tensor(sims)), 40,
                     dim=1).values
    idx = ((1 << 32) - 1 - (top & 0xFFFFFFFF)).numpy()
    assert (idx == np.argsort(-sims, axis=1, kind="stable")).all()
    _, jax_idx = jax.lax.top_k(sims, 40)
    assert (idx == np.asarray(jax_idx)).all()
    zeros = port_eval._rank_keys(torch.tensor([[-0.0, 0.0, -1e-30]]))
    assert zeros[0, 0] < zeros[0, 1] and zeros[0, 2] < zeros[0, 0]


def test_first_hit_ranks_of_a_row_subset_match_the_full_sweep():
    emb, lab, _, qb = _case("ties")
    e, lb = torch.as_tensor(emb), torch.as_tensor(lab)
    full = port_eval.first_hit_ranks(e, lb, 50, query_block=qb)
    rows = torch.tensor([0, 5, 17, 100, 202])
    sub = port_eval.first_hit_ranks(e, lb, 50, query_block=2, rows=rows)
    assert torch.equal(sub, full[rows])
    assert int(full.min()) >= 0 and int(full.max()) <= 50


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nmi_matches_jax(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 7, 500)
    b = np.where(rng.random(500) < 0.6, a, rng.integers(0, 9, 500))
    assert abs(port_eval.nmi(a, b) - jax_eval.nmi(a, b)) <= 1e-12
    assert port_eval.nmi(a, a) == jax_eval.nmi(a, a) == 1.0
    assert port_eval.nmi(np.zeros(5), np.zeros(5)) == 1.0


def test_clustering_nmi_matches_jax_from_its_first_point():
    rng = np.random.default_rng(5)
    centres = rng.standard_normal((10, 32)).astype(np.float32) * 4
    lab = np.repeat(np.arange(10), 30)
    emb = centres[lab] + rng.standard_normal((300, 32)).astype(np.float32)
    first = int(jax.random.randint(jax.random.PRNGKey(0), (), 0, 300))
    want = jax_eval.clustering_nmi(emb, lab, iters=10, seed=0)
    got = port_eval.clustering_nmi(emb, lab, iters=10, seed=0, first=first,
                                   device="cpu")
    assert abs(got - want) <= 1e-12
    assert 0.5 < got <= 1.0


def test_evaluation_needs_a_card_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    emb, lab, ks, qb = _case("ties")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_eval.evaluate_embeddings(emb, lab)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_eval.clustering_nmi(emb, lab)
