"""``python -m npairloss_tpu_torch index|serve`` — the port's CLI.

Flag names follow ``npairloss_tpu``'s CLI for the ported subset; the
port adds ``--device`` (default: the card; ``cpu`` to run without one),
``--weights`` (a flattened flax param tree as ``.npz``, see
``models/convert.py``) and ``--seed`` (the k-means seed, and the trunk's
initialization when no weights are given).

  index: build a flat or IVF ``PREFIX.gidx`` from ``PREFIX.emb.npy`` +
         ``PREFIX.labels.npy``;
  serve: load a ``.gidx`` and answer JSONL queries on stdin until EOF,
         ending with a ``serve_drain`` summary line.
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
    return p


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr,
                        format="%(asctime)s %(name)s %(levelname)s "
                        "%(message)s")
    return int(args.fn(args))
