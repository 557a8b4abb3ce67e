"""``python -m npairloss_tpu_torch index|serve|train`` — the port's CLI.

Flag names follow ``npairloss_tpu``'s CLI for the ported subset; the
port adds ``--device`` (default: the card; ``cpu`` to run without one),
``--weights`` (a flattened flax param tree as ``.npz``, see
``models/convert.py``) and ``--seed`` (the k-means seed, and the trunk's
initialization when no weights are given).  A flag of the JAX CLI that
is not ported is refused by argparse, never accepted and ignored.

  index: build a flat or IVF ``PREFIX.gidx`` from ``PREFIX.emb.npy`` +
         ``PREFIX.labels.npy``;
  serve: load a ``.gidx`` and answer JSONL queries on stdin until EOF,
         ending with a ``serve_drain`` summary line;
  train: the Caffe solver loop from a solver prototxt on synthetic
         identity batches (``--synthetic``), with the JAX CLI's display
         lines, ``--log-json`` events and final JSON line; ``--engine
         blockwise`` streams the loss through the blockwise kernels.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import Optional

from npairloss_tpu_torch.ops.ivf_probe import PROBE_IMPLS

log = logging.getLogger("npairloss_tpu_torch")


def _unported_model(name: str) -> Optional[str]:
    """The refusal for a trunk the port's registry lacks, else None."""
    from npairloss_tpu_torch.models import available_models

    if name.lower() in available_models():
        return None
    return (f"model {name!r} is not ported yet (have "
            f"{available_models()}): the ResNet and ViT trunks are ROADMAP "
            "Queue 1 item 2")


def cmd_index(args) -> int:
    import numpy as np

    from npairloss_tpu_torch.serve.index import GalleryIndex
    from npairloss_tpu_torch.serve.ivf import IVFIndex

    emb_path, lab_path = args.prefix + ".emb.npy", args.prefix + ".labels.npy"
    for p in (emb_path, lab_path):
        if not os.path.exists(p):
            log.error("missing %s", p)
            return 2
    emb = np.load(emb_path)
    lab = np.load(lab_path)
    if args.kind == "ivf":
        idx = IVFIndex.build_ivf(emb, lab, clusters=args.clusters,
                                 seed=args.seed, device=args.device)
    else:
        idx = GalleryIndex.build(emb, lab, device=args.device)
    summary = {"out": idx.save(args.prefix + ".gidx"), "kind": idx.KIND,
               "rows": idx.size, "dim": idx.dim,
               "classes": int(np.unique(idx.host_labels).shape[0])}
    if isinstance(idx, IVFIndex):
        summary["clusters"] = idx.n_clusters
        summary["cap"] = idx.layout.cap
    print(json.dumps(summary))
    return 0


def cmd_serve(args) -> int:
    from npairloss_tpu_torch.device import resolve_device
    from npairloss_tpu_torch.serve.batcher import BatcherConfig
    from npairloss_tpu_torch.serve.engine import EngineConfig, QueryEngine
    from npairloss_tpu_torch.serve.index import load_index
    from npairloss_tpu_torch.serve.server import Freshness, RetrievalServer

    refusal = _unported_model(args.model) if args.model else None
    if refusal:
        log.error("%s", refusal)
        return 2
    device = resolve_device(args.device)
    index = load_index(args.index, device=device)
    kind = "ivf" if index.KIND == "ivf-index" else "flat"
    if kind != args.index_kind:
        log.error("%s is a %s index; --index-kind %s needs one built with "
                  "'index --kind %s'", args.index, kind, args.index_kind,
                  args.index_kind)
        return 2
    model = None
    input_shape = None
    if args.model or args.weights:
        from npairloss_tpu_torch.models import get_model
        from npairloss_tpu_torch.models.convert import load_weights_npz

        model = get_model(args.model or "googlenet", device=device,
                          seed=args.seed)
        if args.weights:
            load_weights_npz(model, args.weights)
        input_shape = (args.input_size, args.input_size, 3)
    buckets = tuple(int(b) for b in args.buckets.split(","))
    engine = QueryEngine(
        index,
        EngineConfig(top_k=args.top_k, buckets=buckets,
                     gallery_block=args.gallery_block, probes=args.probes,
                     scoring=args.scoring, probe_impl=args.probe_impl),
        model=model)
    engine.warmup(input_shape)
    server = RetrievalServer(
        engine,
        BatcherConfig(max_batch=buckets[-1], max_delay_ms=args.deadline_ms,
                      max_queue=args.max_queue),
        freshness=Freshness.collect(index=index,
                                    index_path=os.path.abspath(args.index),
                                    weights_path=args.weights))
    return server.run_jsonl(sys.stdin, sys.stdout)


def _resolve_net_path(args, net_path: Optional[str]) -> Optional[str]:
    """``--net``, else the solver's ``net:`` — relative to the CWD as
    Caffe resolves it, then relative to the solver file."""
    if args.net:
        return args.net
    if net_path and not os.path.isabs(net_path) \
            and not os.path.exists(net_path):
        cand = os.path.join(os.path.dirname(args.solver), net_path)
        if os.path.exists(cand):
            return cand
    return net_path


def cmd_train(args) -> int:
    import dataclasses

    import torch

    from npairloss_tpu_torch.config.schema import load_net, load_solver
    from npairloss_tpu_torch.data.synthetic import synthetic_identity_batches
    from npairloss_tpu_torch.device import resolve_device
    from npairloss_tpu_torch.models import get_model, model_for_net
    from npairloss_tpu_torch.ops.npair_loss import NPairLossConfig
    from npairloss_tpu_torch.train.solver import Solver, snapshot_refusal

    solver_cfg, net_path = load_solver(args.solver)
    net_path = _resolve_net_path(args, net_path)
    if not net_path or not os.path.exists(net_path):
        log.error("net prototxt not found (tried %r); pass --net", net_path)
        return 2
    net_cfg = load_net(net_path)
    model_name = args.model or model_for_net(net_cfg)
    refusal = _unported_model(model_name)
    if refusal:
        log.error("%s", refusal)
        return 2
    if args.max_iter is not None:
        solver_cfg = dataclasses.replace(solver_cfg, max_iter=args.max_iter)
    refusal = snapshot_refusal(solver_cfg, solver_cfg.max_iter)
    if refusal:
        log.error("%s", refusal)
        return 2
    if net_cfg.param_mults_conflict:
        log.error("%s", net_cfg.param_mults_conflict)
        return 2
    if not args.synthetic:
        log.error("only --synthetic data is ported so far: the list-file "
                  "loader is ROADMAP Queue 1 item 4")
        return 2
    d_train = net_cfg.data.get("TRAIN")
    if d_train is None:
        log.error("net %s has no TRAIN MultibatchData layer", net_path)
        return 2

    # Input side from the TRAIN layer's crop, else the TEST layer's.
    crop = 0
    for phase in ("TRAIN", "TEST"):
        d = net_cfg.data.get(phase)
        if d is not None and d.transform.crop_size:
            crop = d.transform.crop_size
            break
    input_shape = (crop or 224,) * 2 + (3,)

    device = resolve_device(args.device)
    seed = solver_cfg.random_seed if args.seed is None else args.seed
    model = get_model(model_name, device=device,
                      seed=seed, input_shape=input_shape,
                      dtype=torch.bfloat16 if args.bf16 else torch.float32)
    solver = Solver(
        model, net_cfg.loss.loss if net_cfg.loss else NPairLossConfig(),
        solver_cfg, param_mults=net_cfg.param_mults,
        loss_weight=(net_cfg.loss.loss_weights[0]
                     if net_cfg.loss and net_cfg.loss.loss_weights else 1.0),
        engine=args.engine or "dense",
        sim_cache={"auto": None, "on": True, "off": False}[args.sim_cache],
        pos_topk=None if args.pos_topk == "auto" else int(args.pos_topk))

    def batches(d, seed):
        if d is None:
            return None
        ids = d.identity_num_per_batch or max(2, (d.batch_size or 8) // 2)
        imgs = d.img_num_per_identity or 2
        return synthetic_identity_batches(ids * 4, ids, imgs, input_shape,
                                          seed=seed)

    record_fn, log_file = None, None
    if args.log_json:
        parent = os.path.dirname(os.path.abspath(args.log_json))
        os.makedirs(parent, exist_ok=True)
        log_file = open(args.log_json, "a", buffering=1)

        def record_fn(rec):
            log_file.write(json.dumps(rec, default=str) + "\n")

    try:
        final = solver.train(batches(d_train, 0),
                             test_batches=batches(net_cfg.data.get("TEST"), 1),
                             log_fn=lambda s: print(s, flush=True),
                             record_fn=record_fn)
    finally:
        if log_file is not None:
            log_file.close()
    print(json.dumps({k: float(v) for k, v in final.items()}))
    return 0


def _pos_topk_arg(v: str):
    """argparse type for --pos-topk: 'auto' or any K >= 0, as in JAX."""
    if v == "auto":
        return "auto"
    try:
        k = int(v)
    except ValueError:
        k = -1
    if k < 0:
        raise argparse.ArgumentTypeError(
            f"expected 'auto' or a non-negative integer, got {v!r}")
    return k


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="npairloss_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--device", default=None,
                        help="torch device (default: cuda; raises without "
                        "a card unless 'cpu' is asked for)")
        sp.add_argument("--seed", type=int, default=0,
                        help="k-means seed / trunk init seed (default 0)")

    ix = sub.add_parser("index", help="build a committed gallery index")
    ix.add_argument("--prefix", default="./features",
                    help="reads PREFIX.emb.npy + PREFIX.labels.npy, "
                    "commits PREFIX.gidx")
    ix.add_argument("--kind", choices=["flat", "ivf"], default="flat")
    ix.add_argument("--clusters", type=int, default=0,
                    help="ivf cluster count (0 = ~sqrt(N))")
    common(ix)
    ix.set_defaults(fn=cmd_index)

    sv = sub.add_parser("serve", help="answer JSONL queries on stdin")
    sv.add_argument("--index", required=True,
                    help="committed index dir (.gidx)")
    sv.add_argument("--index-kind", dest="index_kind",
                    choices=["flat", "ivf"], default="flat")
    sv.add_argument("--probes", type=int, default=8)
    sv.add_argument("--scoring", choices=["fp32", "bf16", "int8"],
                    default="fp32")
    sv.add_argument("--probe-impl", dest="probe_impl",
                    choices=sorted(PROBE_IMPLS), default="scan")
    sv.add_argument("--top-k", dest="top_k", type=int, default=10)
    sv.add_argument("--buckets", default="1,8,32")
    sv.add_argument("--gallery-block", dest="gallery_block", type=int,
                    default=4096)
    sv.add_argument("--model", help="model registry name for raw-'input' "
                    "queries (default googlenet when --weights is given)")
    sv.add_argument("--weights", help="flattened flax param tree (.npz)")
    sv.add_argument("--input-size", dest="input_size", type=int,
                    default=224)
    sv.add_argument("--deadline-ms", dest="deadline_ms", type=float,
                    default=5.0)
    sv.add_argument("--max-queue", dest="max_queue", type=int, default=256)
    common(sv)
    sv.set_defaults(fn=cmd_serve)

    tr = sub.add_parser("train", help="train from a solver prototxt")
    tr.add_argument("--solver", required=True)
    tr.add_argument("--net", help="override the solver's net path")
    tr.add_argument("--model", help="model registry name (default: from "
                    "the net's name)")
    tr.add_argument("--max_iter", type=int, help="override solver max_iter")
    # auto and ring wait for distribution (ROADMAP Queue 1 item 7).
    tr.add_argument("--engine", choices=["dense", "blockwise"],
                    help="loss engine (default: dense; blockwise streams "
                    "the pair tiles through the blockwise kernels)")
    tr.add_argument("--pos-topk", dest="pos_topk", default="auto",
                    metavar="K", type=_pos_topk_arg,
                    help="blockwise engine's sparse-positive buffer slots "
                    "for RELATIVE AP mining (auto = 8; 0 forces radix "
                    "selection; the kernel keeps at most 32, and a query "
                    "with more positives takes radix selection)")
    tr.add_argument("--sim-cache", dest="sim_cache",
                    choices=["auto", "on", "off"], default="auto",
                    help="blockwise engine's fp32 similarity cache (auto = "
                    "by size)")
    tr.add_argument("--bf16", action="store_true",
                    help="bf16 compute over fp32 params (default fp32)")
    tr.add_argument("--synthetic", action="store_true",
                    help="synthetic identity-balanced batches (required: "
                    "the list-file loader is not ported yet)")
    tr.add_argument("--log-json", dest="log_json", metavar="PATH",
                    help="append one JSON record per display/test event")
    tr.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a "
                    "card unless 'cpu' is asked for)")
    tr.add_argument("--seed", type=int, default=None,
                    help="trunk init seed (default: the solver's "
                    "random_seed)")
    tr.set_defaults(fn=cmd_train)
    return p


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr,
                        format="%(asctime)s %(name)s %(levelname)s "
                        "%(message)s")
    return int(args.fn(args))
