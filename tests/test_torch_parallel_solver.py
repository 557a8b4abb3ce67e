"""The port's Solver and ``train`` CLI over a mesh of G = 2 gloo ranks on
the CPU against the JAX package's Solver on a 2-device CPU mesh, and
against themselves: cross-rank BatchNorm, ``shard_batches``, the
multi-process snapshot commit and ``--resume auto``, the pipelined loop,
and two ``train --coordinator`` processes.

One module-scoped pool of two rank processes (a ``file://`` process
group under ``tmp_path_factory``, one torch thread a rank) runs the rank
tasks below; the JAX side is imported inside the tests only.

Tolerances: 3 steps against the JAX mesh Solver, every reported metric
and every parameter after every step within 1e-5 (the same fp32 update,
sums in another order); the two ranks' parameters, momentum and
running statistics bit for bit after every step; cross-rank BatchNorm
at G = 2 against G = 1 on the concatenated batch, computed in fp64 over
fp32 parameters, buffers and outputs, within 1e-6 of each quantity's
largest entry (fp32 rounding of fp64 values summed in another order);
the snapshot resume, the pipelined loop and the CLI's records against
the in-process Solver exactly.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from npairloss_tpu_torch.config.schema import load_net, load_solver
from npairloss_tpu_torch.data.loader import shard_batches
from npairloss_tpu_torch.data.synthetic import synthetic_identity_batches
from npairloss_tpu_torch.models import convert, get_model
from npairloss_tpu_torch.models.layers import BatchNorm, sync_batch_norm
from npairloss_tpu_torch.parallel import shard_batch
from npairloss_tpu_torch.parallel.launch import RankPool
from npairloss_tpu_torch.train.solver import Solver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_SOLVER = os.path.join(REPO, "examples", "tiny_solver.prototxt")
TINY_NET = os.path.join(REPO, "examples", "tiny_net.prototxt")
G = 2
TOL = 1e-5


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    root = tmp_path_factory.mktemp("pg")
    p = RankPool(G, f"file://{root}/pg", device="cpu", timeout_s=180)
    yield p
    p.close()


def _state(solver):
    return {k: v.detach().clone().numpy()
            for k, v in solver.state_dict().items()}


def _tiny_solver(mesh, engine, cfg=None, seed=0, params=None):
    tcfg, _ = load_solver(TINY_SOLVER)
    net = load_net(TINY_NET)
    model = get_model("mlp", device="cpu", input_shape=(8, 8, 3), seed=seed)
    s = Solver(model, net.loss.loss, cfg or tcfg, engine=engine, mesh=mesh)
    if params is not None:
        s.load_params(params)
    return s


# -- rank tasks (run in the pool's processes) ---------------------------------


def _steps_task(mesh, engine, params, batches):
    s = _tiny_solver(mesh, engine, params=params)
    out = []
    for x, lab in batches:
        m = s.step(*shard_batch(mesh, (x, lab)))
        out.append(({k: float(v) for k, v in m.items()}, _state(s)))
    return out


def _bn_task(mesh, x, probe, seed):
    torch.backends.mkldnn.enabled = False
    tm = get_model("googlenet_bn", device="cpu", dtype=torch.float64,
                   seed=seed).train()
    sync_batch_norm(tm, mesh)
    xr, pr = shard_batch(mesh, (x, probe))
    emb = tm(xr)
    (emb.double() * pr).sum().backward()
    grads = {n: mesh.all_reduce_sum(p.grad).numpy()
             for n, p in tm.named_parameters()}
    stats = {n: b.numpy().copy() for n, b in tm.named_buffers()}
    return emb.detach().numpy(), stats, grads


def _train_task(mesh, engine, cfg, num_iters, resume, seed=0):
    """``Solver.train`` on the tiny net's synthetic stream, sharded; with
    ``resume`` first ``restore_auto``, and the stream then continues
    where the restored iteration left it.  Returns (records, lines,
    final metrics, state)."""
    s = _tiny_solver(mesh, engine, cfg=cfg, seed=seed)
    if resume:
        s.restore_auto()
    ids, imgs = 8, 2
    stream = synthetic_identity_batches(ids * 4, ids, imgs, (8, 8, 3),
                                        noise=2.0, seed=0)
    for _ in range(s.iteration):
        next(stream)
    train = shard_batches(stream, mesh.rank, mesh.size)
    test = shard_batches(synthetic_identity_batches(
        ids * 4, ids, imgs, (8, 8, 3), noise=2.0, seed=1),
        mesh.rank, mesh.size)
    recs, lines = [], []
    final = s.train(train, num_iters, test_batches=test, log_fn=lines.append,
                    record_fn=recs.append)
    return recs, lines, final, _state(s)


def _cli_twin_task(mesh):
    """What ``train --solver tiny --synthetic --device cpu --mesh 2`` runs,
    through the Solver API: the CLI's model, seeds and batch streams."""
    tcfg, _ = load_solver(TINY_SOLVER)
    net = load_net(TINY_NET)
    model = get_model("mlp", device="cpu", seed=tcfg.random_seed,
                      input_shape=(8, 8, 3), dtype=torch.float32)
    s = Solver(model, net.loss.loss, tcfg, param_mults=net.param_mults,
               mesh=mesh)
    d = net.data["TRAIN"]
    ids, imgs = d.identity_num_per_batch, d.img_num_per_identity
    streams = [shard_batches(synthetic_identity_batches(
        ids * 4, ids, imgs, (8, 8, 3), seed=seed), mesh.rank, mesh.size)
        for seed in (0, 1)]
    recs = []
    s.train(streams[0], test_batches=streams[1], log_fn=lambda _: None,
            record_fn=recs.append)
    return recs


# -- tests ----------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["dense", "ring"])
def test_mesh_solver_matches_jax_mesh_solver(pool, engine):  # slow-ok: the mesh solver against JAX's mesh
    import jax

    from npairloss_tpu.config import load_net as jax_load_net
    from npairloss_tpu.config import load_solver as jax_load_solver
    from npairloss_tpu.models import get_model as jax_get_model
    from npairloss_tpu.parallel import data_parallel_mesh
    from npairloss_tpu.train import Solver as JaxSolver

    jcfg, _ = jax_load_solver(TINY_SOLVER)
    jnet = jax_load_net(TINY_NET)
    js = JaxSolver(jax_get_model("mlp"), jnet.loss.loss, jcfg,
                   input_shape=(8, 8, 3), engine=engine,
                   mesh=data_parallel_mesh(jax.devices()[:G]))
    js.init()
    params = jax.tree_util.tree_map(np.asarray, js.state["params"])
    stream = synthetic_identity_batches(32, 8, 2, (8, 8, 3), noise=2.0,
                                        seed=3)
    batches = [next(stream) for _ in range(3)]
    ranks = pool.run(_steps_task, engine, params, batches)
    for step, (x, lab) in enumerate(batches):
        jm = js.step(x, lab)
        want = convert.from_jax_params(
            jax.tree_util.tree_map(np.asarray, js.state["params"]))
        (m0, s0), (m1, s1) = ranks[0][step], ranks[1][step]
        assert list(m0) == list(jm)
        assert m0 == m1
        for k in jm:
            np.testing.assert_allclose(m0[k], float(jm[k]), rtol=TOL,
                                       atol=TOL, err_msg=f"{k} step {step}")
        assert s0.keys() == s1.keys()
        for k in s0:
            np.testing.assert_array_equal(s0[k], s1[k], err_msg=k)
        for name, w in want.items():
            np.testing.assert_allclose(s0[f"model/{name}"], w.numpy(),
                                       rtol=TOL, atol=TOL,
                                       err_msg=f"{name} step {step}")
    assert ranks[0][-1][1]["iteration"] == 3


def test_cross_rank_batch_norm_equals_one_rank_on_the_whole_batch(pool):  # slow-ok: cross-rank BatchNorm over gloo
    """googlenet_bn at 64 x 64 in fp64: the two ranks' synced forward,
    running statistics and (all-reduced) parameter gradients of a probe
    objective equal one rank's on the concatenated batch, and both ranks
    hold the same running statistics bit for bit."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 64, 64, 3)).astype(np.float64)
    probe = rng.standard_normal((4, 1024))
    (e0, st0, g0), (e1, st1, g1) = pool.run(_bn_task, x, probe, 3)
    torch.backends.mkldnn.enabled = False
    try:
        tm = get_model("googlenet_bn", device="cpu", dtype=torch.float64,
                       seed=3).train()
        emb = tm(torch.from_numpy(x))
        (emb.double() * torch.from_numpy(probe)).sum().backward()
    finally:
        torch.backends.mkldnn.enabled = True

    def close(got, want, what):
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= 1e-6 * scale, what

    close(np.concatenate([e0, e1]), emb.detach().numpy(), "embeddings")
    bufs = dict(tm.named_buffers())
    assert st0.keys() == bufs.keys() and len(bufs) == 2 * sum(
        isinstance(m, BatchNorm) for m in tm.modules())
    for k, v in bufs.items():
        np.testing.assert_array_equal(st0[k], st1[k], err_msg=k)
        close(st0[k], v.numpy(), k)
    for n, p in tm.named_parameters():
        np.testing.assert_array_equal(g0[n], g1[n], err_msg=n)
        close(g0[n], p.grad.numpy(), n)


def test_shard_batches_matches_jax():
    from npairloss_tpu.data import shard_batches as jax_shard

    def stream():
        return synthetic_identity_batches(24, 6, 2, (4,), seed=2)

    for rank in range(3):
        got = shard_batches(stream(), rank, 3)
        want = jax_shard(stream(), rank, 3)
        for _ in range(3):
            (gx, gl), (wx, wl) = next(got), next(want)
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gl, wl)
    tensors = shard_batches(iter([(torch.arange(12.0).reshape(6, 2),
                                   torch.arange(6))]), 1, 2)
    x, lab = next(tensors)
    assert lab.tolist() == [3, 4, 5] and x[0].tolist() == [6.0, 7.0]
    with pytest.raises(ValueError, match="does not divide"):
        next(shard_batches(stream(), 0, 5))
    with pytest.raises(ValueError, match="outside"):
        shard_batches(stream(), 2, 2)


def _cfg(tmp_path, **kw):
    tcfg, _ = load_solver(TINY_SOLVER)
    over = dict(display=1, test_interval=0, snapshot=2, max_iter=6,
                snapshot_prefix=str(tmp_path / "snap" / "tiny_"))
    return dataclasses.replace(tcfg, **{**over, **kw})


def test_multi_process_snapshot_and_resume_auto(pool, tmp_path):
    """Rank 0 commits each snapshot (the JAX package's validator accepts
    it); a fresh pair of ranks resumes the newest with ``restore_auto``
    and ends on the uninterrupted run's state bit for bit."""
    from npairloss_tpu.resilience.snapshot import (
        validate_snapshot as jax_validate,
    )

    cfg = _cfg(tmp_path)
    full = pool.run(_train_task, "dense", cfg, 6, False)
    snaps = sorted(os.listdir(tmp_path / "snap"))
    assert snaps == ["tiny_iter_2.ckpt", "tiny_iter_4.ckpt",
                     "tiny_iter_6.ckpt"]
    for d in snaps:
        assert jax_validate(str(tmp_path / "snap" / d))["step"] == int(
            d.split("_")[-1].split(".")[0])
    for d in snaps[1:]:
        shutil.rmtree(tmp_path / "snap" / d)
    resumed = pool.run(_train_task, "dense", cfg, 6, True)
    for r in range(G):
        assert resumed[r][1][0] == "resuming from iteration 2"
        for k, v in full[r][3].items():
            np.testing.assert_array_equal(resumed[r][3][k], v, err_msg=k)
    # The loss window restarts with the run, as in JAX: all else equal.
    strip = lambda recs: [{k: v for k, v in r.items()  # noqa: E731
                           if k != "loss_avg"} for r in recs[-3:]]
    assert strip(resumed[0][0]) == strip(full[0][0])


@pytest.mark.parametrize("engine", ["dense", "ring"])
def test_pipelined_loop_equals_sync_loop_at_two_ranks(pool, tmp_path,
                                                      engine):
    kw = dict(snapshot=0, display=3, test_interval=3)
    sync = pool.run(_train_task, engine, _cfg(tmp_path / "a", **kw), 6,
                    False)
    piped = pool.run(_train_task, engine,
                     _cfg(tmp_path / "b", pipeline=True, **kw), 6, False)
    for r in range(G):
        assert piped[r][0] == sync[r][0]
        assert piped[r][1] == sync[r][1]
        assert piped[r][2] == sync[r][2]
        for k, v in sync[r][3].items():
            np.testing.assert_array_equal(piped[r][3][k], v, err_msg=k)
    np.testing.assert_array_equal(sync[0][3]["model/head.weight"],
                                  sync[1][3]["model/head.weight"])


def test_two_cli_processes_match_the_in_process_solver(pool, tmp_path):  # slow-ok: two CLI processes in one group
    """``train --coordinator file://... --num-processes 2 --process-id i``
    in two processes: both exit 0, rank 0 alone writes ``--log-json``
    (the engine plan, then the Solver's records), equal to the
    in-process G = 2 Solver's records."""
    init = f"file://{tmp_path}/cli_pg"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    for i in range(G):
        argv = [sys.executable, "-m", "npairloss_tpu_torch", "train",
                "--solver", "examples/tiny_solver.prototxt", "--synthetic",
                "--device", "cpu", "--coordinator", init,
                "--num-processes", str(G), "--process-id", str(i),
                "--mesh", str(G), "--log-json",
                str(tmp_path / f"events{i}.jsonl")]
        procs.append(subprocess.Popen(argv, cwd=REPO, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    assert not (tmp_path / "events1.jsonl").exists()
    recs = [json.loads(ln) for ln in
            (tmp_path / "events0.jsonl").read_text().splitlines()]
    assert recs[0]["event"] == "engine_plan"
    assert recs[0]["engine"] == "dense" and recs[0]["devices"] == G
    want = pool.run(_cli_twin_task)[0]
    assert recs[1:] == json.loads(json.dumps(want))
    assert outs[0][0].splitlines()[-1] == outs[1][0].splitlines()[-1]
