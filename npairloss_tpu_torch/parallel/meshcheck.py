"""The mesh over G ranks, one card each: a check of the distribution path
that one card cannot make.

    torchrun --standalone --nproc-per-node G \\
        -m npairloss_tpu_torch.parallel.meshcheck [--steps 4] [--out F]

    # on the CPU (gloo), a small trunk:
    torchrun --standalone --nproc-per-node 4 \\
        -m npairloss_tpu_torch.parallel.meshcheck --device cpu --size 64 \\
        --ids 8

Every rank joins the group from torchrun's environment with
``--device`` (default ``cuda``: each rank binds ``cuda:{LOCAL_RANK}``)
and builds the mesh; then

1. the collectives: ``all_gather``, ``all_reduce_sum``,
   ``all_reduce_max``, ``shift`` (one ring hop), ``agree``/``any`` and
   ``barrier`` against what they must give, the sum's bits the same on
   every rank;
2. their times at the flagship's sizes: the flattened gradient's
   all-reduce, the embeddings' gather, one ring hop, and the synced
   BatchNorm's sums (one layer's, and a step's worth back to back);
3. ``--steps`` steps of googlenet_bn under ``mxu`` on the CUB net's
   loss, global batch ``2 * --ids`` rows at ``--size``², dense and ring
   on the same batches: the ranks' parameters bit for bit after every
   step, ring against dense, and the first step's loss against one
   process on the whole batch (rank 0);
4. ``train --device <device> --mesh G --engine auto`` through the CLI,
   with a snapshot at its end (the multi-rank commit's barrier).

Rank 0 prints one JSON object (and writes it to ``--out``); the exit
code is 0 when every check held on every rank.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import statistics
import sys
import time
from typing import Callable, Dict, List

import torch

# Ring vs dense: the ring adds its G blocks in hop order where dense
# forms each row at once (loss relative; parameters against the
# parameter vector's norm after the steps).  The first step's loss at G
# ranks against one process: the synced BatchNorm's fp32 sums are added
# in another order under the policy's bf16 activations.
TOL = {"ring_loss_rel": 1e-4, "ring_param_rel": 1e-3,
       "one_process_loss_rel": 1e-3, "sum_rel": 1e-6}

POLICY, SEED = "mxu", 0
CUB_NET = os.path.join("examples", "googlenet_cub.prototxt")
CUB_SOLVER = os.path.join("examples", "googlenet_cub_solver.prototxt")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _median_ms(fn: Callable[[], object], dev: torch.device,
               reps: int = 10) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _part(p: int, shape, dev: torch.device) -> torch.Tensor:
    """Ring position ``p``'s test tensor, the same bits on every rank."""
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.float64, device=dev)
    return torch.sin(idx * 1e-3 * (p + 1) + p).float().reshape(shape)


def check_collectives(mesh, fails: List[str]) -> Dict[str, object]:
    g, r, dev = mesh.size, mesh.rank, mesh.device
    shape = (8, 64)
    parts = [_part(p, shape, dev) for p in range(g)]
    mine = parts[r]
    got: Dict[str, object] = {}
    got["all_gather"] = torch.equal(mesh.all_gather(mine),
                                    torch.cat(parts))
    total = mesh.all_reduce_sum(mine)
    want = torch.stack(parts).double().sum(0)
    got["all_reduce_sum_rel"] = float(
        (total.double() - want).norm() / want.norm())
    digests = mesh.all_gather(total[None])
    got["all_reduce_sum_same_bits"] = all(
        torch.equal(digests[p], total) for p in range(g))
    got["all_reduce_max"] = torch.equal(mesh.all_reduce_max(mine),
                                        torch.stack(parts).amax(0))
    got["shift"] = torch.equal(mesh.shift([mine])[0], parts[(r - 1) % g])
    got["agree"] = (mesh.agree(True) and mesh.agree(r == 0) == (g == 1)
                    and mesh.any(r == 0))
    mesh.barrier()
    for k, v in got.items():
        bad = (v > TOL["sum_rel"]) if isinstance(v, float) else not v
        if bad:
            fails.append(f"collective {k}: {v}")
    return got


def time_collectives(mesh, grad_numel: int, rows: int, dim: int,
                     bn_features: List[int]) -> Dict[str, float]:
    dev = mesh.device
    grad = torch.ones(grad_numel, device=dev)
    emb = torch.ones(rows, dim, device=dev)
    # A synced BatchNorm all-reduces its (2, C) fp32 sums in the forward
    # and their gradient in the backward: two sums a layer and step.
    bn = [torch.ones(2, c, device=dev) for c in bn_features]
    one = sorted(bn, key=torch.Tensor.numel)[len(bn) // 2]

    def bn_sums():
        for t in bn + bn:
            mesh.all_reduce_sum(t)

    return {
        "grad_all_reduce_ms": _median_ms(lambda: mesh.all_reduce_sum(grad),
                                         dev),
        "grad_bytes": grad_numel * 4,
        "emb_all_gather_ms": _median_ms(lambda: mesh.all_gather(emb), dev),
        "emb_bytes": rows * dim * 4,
        "ring_hop_ms": _median_ms(lambda: mesh.shift([emb]), dev),
        "bn_all_reduce_ms": _median_ms(lambda: mesh.all_reduce_sum(one),
                                       dev),
        "bn_all_reduce_bytes": one.numel() * 4,
        "bn_sums_ms": _median_ms(bn_sums, dev),
        "bn_sums": 2 * len(bn),
        "bn_sums_bytes": 2 * sum(t.numel() for t in bn) * 4,
    }


def _digest(params) -> str:
    h = hashlib.sha256()
    for p in params.values():
        h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _param_rel(a, b) -> float:
    num = sum(float(((a[k].double() - b[k].double()) ** 2).sum()) for k in b)
    den = sum(float((b[k].double() ** 2).sum()) for k in b)
    return (num / max(den, 1e-300)) ** 0.5


def _solver(args, mesh, engine: str, device):
    from npairloss_tpu_torch.config.schema import load_net, load_solver
    from npairloss_tpu_torch.models import get_model
    from npairloss_tpu_torch.train.solver import Solver

    solver_cfg, _ = load_solver(CUB_SOLVER)
    net_cfg = load_net(CUB_NET)
    model = get_model("googlenet_bn", device=device, seed=SEED,
                      policy=POLICY, input_shape=(args.size, args.size, 3))
    return Solver(model, net_cfg.loss.loss, solver_cfg,
                  param_mults=net_cfg.param_mults, precision=POLICY,
                  engine=engine, mesh=mesh)


def check_training(args, mesh, fails: List[str]) -> Dict[str, object]:
    import torch.distributed as dist

    from npairloss_tpu_torch.data.synthetic import synthetic_identity_batches
    from npairloss_tpu_torch.models.layers import BatchNorm
    from npairloss_tpu_torch.parallel import shard_batch

    gen = synthetic_identity_batches(4 * args.ids, args.ids, 2,
                                     (args.size, args.size, 3),
                                     seed=SEED)
    batches = [next(gen) for _ in range(args.steps)]
    out: Dict[str, object] = {}
    final = {}
    for engine in ("dense", "ring"):
        solver = _solver(args, mesh, engine, mesh.device)
        losses, ms, same = [], [], []
        for x, lab in batches:
            xs, ls = shard_batch(mesh, (x, lab))
            _sync(mesh.device)
            t0 = time.perf_counter()
            m = solver.step(xs, ls)
            _sync(mesh.device)
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
            digests: List[str] = [""] * mesh.size
            dist.all_gather_object(digests, _digest(solver.params))
            same.append(len(set(digests)) == 1)
        if not all(same):
            fails.append(f"{engine}: ranks' parameters differ after steps "
                         f"{[i + 1 for i, s in enumerate(same) if not s]}")
        final[engine] = {n: p.detach().float().cpu().clone()
                         for n, p in solver.params.items()}
        out[engine] = {"losses": losses, "step_ms": ms,
                       "median_step_ms": statistics.median(ms[1:] or ms),
                       "ranks_bit_equal_every_step": all(same)}
        if engine == "dense":
            out["grad_numel"] = sum(p.numel()
                                    for p in solver.params.values())
            out["bn_features"] = [m.scale.numel()
                                  for m in solver.model.modules()
                                  if isinstance(m, BatchNorm)]
        del solver
    loss_rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(
        out["ring"]["losses"], out["dense"]["losses"]))
    prel = _param_rel(final["ring"], final["dense"])
    out["ring_vs_dense"] = {"loss_rel": loss_rel, "param_rel": prel}
    if loss_rel > TOL["ring_loss_rel"] or prel > TOL["ring_param_rel"]:
        fails.append(f"ring vs dense: {out['ring_vs_dense']}")
    if mesh.rank == 0:
        # One process on the whole first batch, no mesh.
        solver = _solver(args, None, "dense", mesh.device)
        one = float(solver.step(*batches[0])["loss"])
        del solver
        rel = abs(out["dense"]["losses"][0] - one) / max(abs(one), 1e-30)
        out["first_loss_vs_one_process"] = {"one_process": one,
                                            "loss_rel": rel}
        if rel > TOL["one_process_loss_rel"]:
            fails.append(f"first loss vs one process: "
                         f"{out['first_loss_vs_one_process']}")
    mesh.barrier()
    return out


def check_cli(args, mesh, work: str, fails: List[str]) -> Dict[str, object]:
    """``train --device <device> --mesh G --engine auto`` with a snapshot
    at its last step; the plan record and the snapshot's manifest."""
    import shutil

    from npairloss_tpu_torch import cli

    os.makedirs(work, exist_ok=True)
    if mesh.rank == 0:
        shutil.rmtree(os.path.join(work, "snap"), ignore_errors=True)
    mesh.barrier()
    # The CUB net at --size with --ids identities in both phases (its
    # TEST batch of 15 does not divide over 4 ranks).
    net = open(CUB_NET).read()
    net = re.sub(r"crop_size: \d+", f"crop_size: {args.size}", net)
    net = re.sub(r"identity_num_per_batch: \d+",
                 f"identity_num_per_batch: {args.ids}", net)
    net_path = os.path.join(work, f"net_rank{mesh.rank}.prototxt")
    with open(net_path, "w") as f:
        f.write(net)
    text = open(CUB_SOLVER).read()
    for key, val in (("max_iter", args.steps), ("test_iter", 1),
                     ("display", 1), ("snapshot", args.steps),
                     ("snapshot_prefix", f'"{work}/snap/cub_"')):
        text = re.sub(rf"(?m)^{key}:.*$", f"{key}: {val}", text)
    solver_path = os.path.join(work, f"solver_rank{mesh.rank}.prototxt")
    with open(solver_path, "w") as f:
        f.write(text)
    events = os.path.join(work, "events.jsonl")
    argv = ["train", "--solver", solver_path, "--net", net_path,
            "--model", "googlenet_bn", "--precision", POLICY,
            "--synthetic", "--device", args.device, "--mesh",
            str(mesh.size), "--engine", "auto", "--log-json", events,
            "--seed", str(SEED)]
    rc = cli.main(argv)
    mesh.barrier()
    out: Dict[str, object] = {"rc": rc}
    if rc != 0:
        fails.append(f"train --mesh {mesh.size} gave rc {rc}")
    if mesh.rank == 0 and rc == 0:
        recs = [json.loads(ln) for ln in open(events)]
        plan = next((r for r in recs if r.get("event") == "engine_plan"),
                    None)
        snaps = sorted(os.listdir(os.path.join(work, "snap")))
        out.update({"plan": plan, "records": len(recs), "snapshots": snaps})
        if plan is None or plan["devices"] != mesh.size or not snaps:
            fails.append(f"train --mesh {mesh.size}: plan {plan}, "
                         f"snapshots {snaps}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--ids", type=int, default=60,
                    help="identities a global batch (2 images each)")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--work", default=os.path.join("build", "meshcheck"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from npairloss_tpu_torch.parallel import (
        build_mesh,
        initialize_distributed,
        mesh_topology,
        shutdown_distributed,
    )

    t_start = time.perf_counter()
    if not initialize_distributed(device=args.device):
        print("meshcheck runs under torchrun (RANK, WORLD_SIZE, "
              "MASTER_ADDR, MASTER_PORT)", file=sys.stderr)
        return 2
    if args.device == "cuda":
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    fails: List[str] = []
    try:
        mesh = build_mesh()
        rec: Dict[str, object] = {
            "world": mesh.size, "backend": mesh.backend,
            "device": str(mesh.device), "topology": mesh_topology(mesh),
            "card": (torch.cuda.get_device_name(mesh.device)
                     if mesh.device.type == "cuda" else "cpu")}
        rec["collectives"] = check_collectives(mesh, fails)
        train = check_training(args, mesh, fails)
        rec["training"] = train
        rec["collective_ms"] = time_collectives(
            mesh, train["grad_numel"], 2 * args.ids // mesh.size, 1024,
            train["bn_features"])
        rec["cli"] = check_cli(args, mesh, args.work, fails)
        ok = mesh.agree(not fails)
        rec.update({"fails": fails, "ok": ok,
                    "wall_s": time.perf_counter() - t_start})
        if mesh.rank == 0:
            line = json.dumps(rec, default=str)
            if args.out:
                os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
                with open(args.out, "w") as f:
                    f.write(line + "\n")
            print(line)
        elif fails:
            print(json.dumps({"rank": mesh.rank, "fails": fails}),
                  file=sys.stderr)
    finally:
        shutdown_distributed()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
