"""The port's sharded dense engine and its ring engine over G = 2 and 4
gloo ranks on the CPU (``npairloss_tpu_torch/parallel``) against the JAX
package's ``sharded_npair_loss_fn`` and ring over a G-device CPU mesh,
the NumPy oracle, and each other.

Each module-scoped pool spawns G rank processes once (a ``file://``
process group under ``tmp_path_factory``, one torch thread a rank); the
rank tasks below are module functions, and the JAX side is imported
inside the tests only.

Tolerances: loss, sims and thresholds within 1e-5 relative (fp32 sums
in another order), metrics exactly or within one query's share, the
hand-derived gradients within 2e-5 relative + 1e-7 absolute; the ring
against the port's dense engine at the JAX ring test's bounds (loss 2e-5
relative, gradient 3e-5 + 1e-6); cache on against off bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from npairloss_tpu_torch.ops.metrics import retrieval_metrics
from npairloss_tpu_torch.ops.npair_loss import (
    REFERENCE_CONFIG,
    MiningMethod,
    MiningRegion,
    NPairLossConfig,
    npair_loss_with_aux,
)
from npairloss_tpu_torch.parallel import (
    Mesh,
    ring_npair_loss_and_metrics,
    shard_batch,
    sharded_npair_loss_fn,
)
from npairloss_tpu_torch.parallel.launch import RankPool

AXIS = "dp"
LOCAL_HARD = NPairLossConfig(an_mining_method=MiningMethod.HARD,
                             margin_diff=-0.05)

# The configs of tests/test_ring.py, in the port's types.
ABS_CONFIGS = [
    NPairLossConfig(),
    LOCAL_HARD,
    NPairLossConfig(ap_mining_method=MiningMethod.HARD,
                    ap_mining_region=MiningRegion.GLOBAL,
                    an_mining_method=MiningMethod.EASY, margin_ident=0.1),
    NPairLossConfig(ap_mining_method=MiningMethod.EASY,
                    an_mining_region=MiningRegion.GLOBAL,
                    an_mining_method=MiningMethod.HARD),
]
REL_CONFIGS = [
    REFERENCE_CONFIG,
    NPairLossConfig(ap_mining_method=MiningMethod.RELATIVE_EASY, identsn=-0.5,
                    an_mining_method=MiningMethod.RELATIVE_HARD, diffsn=-0.3),
    NPairLossConfig(ap_mining_method=MiningMethod.RELATIVE_HARD, identsn=1.0,
                    an_mining_method=MiningMethod.RELATIVE_EASY, diffsn=2.0,
                    margin_diff=0.02),
    NPairLossConfig(an_mining_region=MiningRegion.GLOBAL,
                    an_mining_method=MiningMethod.RELATIVE_HARD,
                    diffsn=-0.25),
]
BOUNDARY_CFG = NPairLossConfig(
    ap_mining_region=MiningRegion.GLOBAL,
    ap_mining_method=MiningMethod.RELATIVE_HARD, identsn=-0.3,
    an_mining_method=MiningMethod.HARD, margin_diff=-0.05)


def _jax_cfg(cfg: NPairLossConfig):
    import importlib

    # ``npairloss_tpu.ops`` exports a function of the module's name.
    jnl = importlib.import_module("npairloss_tpu.ops.npair_loss")

    d = dataclasses.asdict(cfg)
    for k, enum in (("ap_mining_region", jnl.MiningRegion),
                    ("an_mining_region", jnl.MiningRegion),
                    ("ap_mining_method", jnl.MiningMethod),
                    ("an_mining_method", jnl.MiningMethod)):
        d[k] = enum(int(d[k]))
    return jnl.NPairLossConfig(**d)


def _batch(seed, g, num_ids=4, imgs=2, dim=16):
    """G shards of identity-balanced unit rows (conftest's
    make_identity_batch): the global batch and per-shard lists."""
    rng = np.random.default_rng(seed)
    feats, labs = [], []
    for _ in range(g):
        ids = rng.choice(10 * num_ids, size=num_ids, replace=False)
        lab = np.repeat(ids, imgs).astype(np.int32)
        f = rng.standard_normal((num_ids * imgs, dim)).astype(np.float32)
        f = f / np.linalg.norm(f, axis=1, keepdims=True)
        perm = rng.permutation(len(lab))
        feats.append(f[perm])
        labs.append(lab[perm])
    return np.concatenate(feats), np.concatenate(labs), feats, labs


# -- rank tasks (run in the pool's processes) ---------------------------------


def _dense_task(mesh, f, l, cfg, top_ks=(1, 5, 10)):
    x, lab = shard_batch(mesh, (f, l))
    x = x.clone().requires_grad_(True)
    loss, aux = sharded_npair_loss_fn(mesh, cfg)(x, lab)
    loss.backward()
    m = retrieval_metrics(aux, lab, x.detach(), top_ks)
    return {"loss": float(loss.detach()), "grad": x.grad.numpy(),
            "sim": aux["sim"].numpy(), "sim_exp": aux["sim_exp"].numpy(),
            "pos_thr": aux["pos_threshold"].numpy(),
            "neg_thr": aux["neg_threshold"].numpy(),
            "total_labels": aux["total_labels"].numpy(),
            **{k: float(v) for k, v in m.items()}}


def _ring_task(mesh, f, l, cfg, sim_cache, pos_topk=None, top_ks=(1, 5, 10)):
    x, lab = shard_batch(mesh, (f, l))
    x = x.clone().requires_grad_(True)
    loss, m = ring_npair_loss_and_metrics(x, lab, cfg, mesh, top_ks,
                                          sim_cache=sim_cache,
                                          pos_topk=pos_topk)
    loss.backward()
    return {"loss": float(loss.detach()), "grad": x.grad.numpy(),
            **{k: float(v) for k, v in m.items()}}


def _gather_order_task(mesh, f, l):
    return mesh.all_gather(torch.from_numpy(
        l[mesh.rank * 4:(mesh.rank + 1) * 4])).numpy()


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    root = tmp_path_factory.mktemp("pg")
    made = {}

    def get(g):
        if g not in made:
            made[g] = RankPool(g, f"file://{root}/pg{g}", device="cpu",
                               timeout_s=120)
        return made[g]

    yield get
    for p in made.values():
        p.close()


def _jax_mesh(g):
    import jax

    from npairloss_tpu.parallel import data_parallel_mesh

    return data_parallel_mesh(jax.devices()[:g])


def _jax_dense(g, cfg, f, l, top_ks=(1, 5, 10)):
    """JAX's per-shard loss, aux, metrics and gradient (cotangent 1 a
    shard), jitted over a G-device CPU mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from npairloss_tpu.ops.metrics import retrieval_metrics as jrm
    from npairloss_tpu.ops.npair_loss import npair_loss_with_aux as jnl
    from npairloss_tpu.parallel import shard_map

    jcfg = _jax_cfg(cfg)
    mesh = _jax_mesh(g)

    def value(f_, l_):
        loss, aux = jnl(f_, l_, jcfg, axis_name=AXIS)
        m = jrm(jax.lax.stop_gradient(aux), l_, f_, top_ks)
        out = {"loss": loss, **m, "sim": aux["sim"], "sim_exp": aux["sim_exp"],
               "pos_thr": aux["pos_threshold"],
               "neg_thr": aux["neg_threshold"]}
        return jax.tree_util.tree_map(lambda x: jnp.asarray(x)[None], out)

    def grad(f_, l_):
        return jax.grad(lambda q: jnl(q, l_, jcfg, axis_name=AXIS)[0])(f_)

    spec = (P(AXIS), P(AXIS))
    vals = jax.jit(shard_map(value, mesh=mesh, in_specs=spec,
                             out_specs=P(AXIS)))(f, l)
    grads = jax.jit(shard_map(grad, mesh=mesh, in_specs=spec,
                              out_specs=P(AXIS)))(f, l)
    return ({k: np.asarray(v) for k, v in vals.items()}, np.asarray(grads))


@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("cfg", [REFERENCE_CONFIG, LOCAL_HARD],
                         ids=["global_relative", "local_hard"])
def test_dense_sharded_matches_jax_and_oracle(pools, g, cfg):
    from npairloss_tpu.testing import oracle

    f, l, fs, ls = _batch(10 + g, g)
    out = pools(g).run(_dense_task, f, l, cfg)
    want, jgrad = _jax_dense(g, cfg, f, l)
    res = oracle.forward(fs, ls, _jax_cfg(cfg))
    ograd = oracle.backward(fs, res, loss_weight=1.0)
    n = f.shape[0] // g
    for r, got in enumerate(out):
        np.testing.assert_array_equal(got["total_labels"], l)
        np.testing.assert_allclose(got["loss"], want["loss"][r], rtol=1e-5,
                                   atol=1e-7, err_msg=f"rank {r}")
        np.testing.assert_allclose(got["loss"], res[r].loss, rtol=1e-5,
                                   atol=1e-7)
        for k in ("sim", "sim_exp", "pos_thr", "neg_thr"):
            np.testing.assert_allclose(got[k], want[k][r], rtol=1e-5,
                                       atol=1e-7, err_msg=f"{k} rank {r}")
        np.testing.assert_allclose(got["sim_exp"], res[r].sim_exp, rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(got["pos_thr"], res[r].pos_thr, rtol=1e-6)
        for k in ("retrieve_top1", "retrieve_top5", "retrieve_top10",
                  "feature_asum"):
            np.testing.assert_allclose(got[k], want[k][r], rtol=1e-6,
                                       err_msg=f"{k} rank {r}")
        np.testing.assert_allclose(got["grad"], jgrad[r * n:(r + 1) * n],
                                   rtol=2e-5, atol=1e-7, err_msg=f"rank {r}")
        np.testing.assert_allclose(got["grad"], ograd[r], rtol=2e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("g", [2, 4])
def test_local_mining_pool_rows_equal_single_process(pools, g):
    """LOCAL mining over the gathered pool: each rank's sim rows are the
    single-process matrix's rows, and with every pair selected the mean
    of the rank losses is the single-process loss; GLOBAL mining ranks
    over each rank's own block, so a GLOBAL HARD negative threshold (the
    block's hardest positive) gives another loss."""
    f, l, _, _ = _batch(20 + g, g)
    cfg = NPairLossConfig()
    out = pools(g).run(_dense_task, f, l, cfg)
    ft, lt = torch.from_numpy(f), torch.from_numpy(l)
    loss1, aux1 = npair_loss_with_aux(ft, lt, cfg)
    np.testing.assert_allclose(np.concatenate([o["sim"] for o in out]),
                               aux1["sim"].numpy(), rtol=1e-6)
    np.testing.assert_allclose(np.mean([o["loss"] for o in out]),
                               float(loss1), rtol=1e-5, atol=1e-7)
    gcfg = NPairLossConfig(an_mining_region=MiningRegion.GLOBAL,
                           an_mining_method=MiningMethod.HARD,
                           margin_diff=-0.05)
    glob = pools(g).run(_dense_task, f, l, gcfg)
    single = float(npair_loss_with_aux(ft, lt, gcfg)[0])
    assert abs(np.mean([o["loss"] for o in glob]) - single) > 1e-3


def test_gather_is_rank_major(pools):
    """Rank r's rows land at [r*N, (r+1)*N), MPI_Allgather's order."""
    l = np.arange(16, dtype=np.int32)
    for got in pools(4).run(_gather_order_task, None, l):
        np.testing.assert_array_equal(got, l)


def _jax_ring(g, cfg, f, l, top_ks=(1, 5, 10)):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from npairloss_tpu.parallel import shard_map
    from npairloss_tpu.parallel.ring import ring_npair_loss_and_metrics as jr

    jcfg = _jax_cfg(cfg)
    mesh = _jax_mesh(g)

    def value(f_, l_):
        loss, m = jr(f_, l_, jcfg, AXIS, top_ks)
        return jax.tree_util.tree_map(lambda x: jnp.asarray(x)[None],
                                      {"loss": loss, **m})

    def grad(f_, l_):
        return jax.grad(lambda q: jr(q, l_, jcfg, AXIS, top_ks)[0])(f_)

    spec = (P(AXIS), P(AXIS))
    vals = jax.jit(shard_map(value, mesh=mesh, in_specs=spec,
                             out_specs=P(AXIS)))(f, l)
    grads = jax.jit(shard_map(grad, mesh=mesh, in_specs=spec,
                              out_specs=P(AXIS)))(f, l)
    return {k: np.asarray(v) for k, v in vals.items()}, np.asarray(grads)


@pytest.mark.parametrize("cfg", [LOCAL_HARD, REFERENCE_CONFIG],
                         ids=["absolute", "relative"])
def test_ring_matches_jax_ring(pools, cfg):
    g = 2
    f, l, _, _ = _batch(30, g)
    out = pools(g).run(_ring_task, f, l, cfg, None)
    want, jgrad = _jax_ring(g, cfg, f, l)
    n = f.shape[0] // g
    for r, got in enumerate(out):
        np.testing.assert_allclose(got["loss"], want["loss"][r], rtol=1e-5,
                                   atol=1e-7)
        for k in ("retrieve_top1", "retrieve_top5", "retrieve_top10",
                  "ident_num", "diff_num"):
            assert got[k] == want[k][r], (k, r)
        np.testing.assert_allclose(got["feature_asum"],
                                   want["feature_asum"][r], rtol=1e-6)
        np.testing.assert_allclose(got["grad"], jgrad[r * n:(r + 1) * n],
                                   rtol=2e-5, atol=1e-7)


def _ring_vs_dense(pools, g, cfg, f, l, pos_topk=None):
    dense = pools(g).run(_dense_task, f, l, cfg)
    ring = pools(g).run(_ring_task, f, l, cfg, False, pos_topk)
    for r, (d, q) in enumerate(zip(dense, ring)):
        np.testing.assert_allclose(q["loss"], d["loss"], rtol=2e-5,
                                   atol=1e-6, err_msg=f"rank {r}")
        for k in ("retrieve_top1", "retrieve_top5", "retrieve_top10"):
            np.testing.assert_allclose(q[k], d[k], rtol=2e-5, err_msg=k)
        np.testing.assert_allclose(q["grad"], d["grad"], rtol=3e-5,
                                   atol=1e-6, err_msg=f"rank {r}")


@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("idx", range(len(ABS_CONFIGS) + len(REL_CONFIGS)))
def test_ring_matches_dense_engine(pools, g, idx):
    cfg = (ABS_CONFIGS + REL_CONFIGS)[idx]
    f, l, _, _ = _batch(40 + idx, g)
    _ring_vs_dense(pools, g, cfg, f, l)


@pytest.mark.parametrize("imgs", [8, 16], ids=["fits", "overflows"])
def test_ring_pos_topk_boundary(pools, imgs):
    """9 identities x 8 (7 positives a query: the 8-slot buffer holds
    them) and x 16 (15: every rank falls back to radix selection
    together), 18 and 36 rows a rank over G = 4: label groups span the
    ranks, so the buffer merges positives arriving on different hops."""
    g = 4
    rng = np.random.default_rng(50 + imgs)
    lab = np.repeat(rng.choice(90, 9, replace=False), imgs).astype(np.int32)
    f = rng.standard_normal((lab.size, 16)).astype(np.float32)
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    perm = rng.permutation(lab.size)
    _ring_vs_dense(pools, g, BOUNDARY_CFG, f[perm], lab[perm], pos_topk=8)


@pytest.mark.parametrize("cfg", [REFERENCE_CONFIG, REL_CONFIGS[1]],
                         ids=["reference", "two_sided"])
def test_ring_sim_cache_on_equals_off_bitwise(pools, cfg):
    f, l, _, _ = _batch(60, 2)
    on = pools(2).run(_ring_task, f, l, cfg, True)
    off = pools(2).run(_ring_task, f, l, cfg, False)
    for a, b in zip(on, off):
        assert a["loss"] == b["loss"]
        np.testing.assert_array_equal(a["grad"], b["grad"])
        for k in a:
            if k != "grad":
                assert a[k] == b[k], k


@pytest.mark.parametrize("cfg", [LOCAL_HARD, REFERENCE_CONFIG],
                         ids=["absolute", "relative"])
def test_ring_one_shard_equals_dense(cfg):
    """At G = 1 (a mesh without a process group) the ring runs its
    passes with no hop and gives the dense engine's loss, metrics and
    gradient."""
    f, l, _, _ = _batch(70, 1, num_ids=8)
    mesh = Mesh(rank=0, size=1, device=torch.device("cpu"))
    x = torch.from_numpy(f).requires_grad_(True)
    loss, m = ring_npair_loss_and_metrics(x, torch.from_numpy(l), cfg, mesh)
    loss.backward()
    y = torch.from_numpy(f).requires_grad_(True)
    dloss, aux = npair_loss_with_aux(y, torch.from_numpy(l), cfg)
    dloss.backward()
    dm = retrieval_metrics(aux, torch.from_numpy(l), y.detach())
    np.testing.assert_allclose(float(loss.detach()), float(dloss.detach()),
                               rtol=2e-6)
    for k, v in dm.items():
        np.testing.assert_allclose(float(m[k]), float(v), rtol=1e-6)
    assert float(m["ident_num"]) == float(aux["ident_num"].sum())
    np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(), rtol=2e-5,
                               atol=1e-7)


def test_ring_true_grad_mode_matches_dense(pools):
    cfg = dataclasses.replace(LOCAL_HARD, grad_mode="true")
    f, l, _, _ = _batch(80, 2)
    _ring_vs_dense(pools, 2, cfg, f, l)
