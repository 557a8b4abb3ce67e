"""Time the serving engine's steady state on the serving path's gallery.

Run on a machine with one H100, as a file (so that ``--tree`` decides
which ``npairloss_tpu_torch`` is imported):

    python3 npairloss_tpu_torch/tools/serve_bench.py [--tree DIR] [--rounds 5] [--seed 0] [--profile N]

The engine is chip_smoke.py phase 4's: 60,502 unit rows x 1024 in
11,316 identities (``probe_bench.synthetic_gallery``), an IVF index of
~246 clusters, the fused probe (probes 8, k 10, buckets 1, 8, 32), no
trunk.  Each round times ``QueryEngine.query`` on the host's clock, each
dispatch ending with its answers on the host: 100 dispatches of a
bucket of 32 embedding queries (queries/s) and 200 of one query (ms a
dispatch).  Where the tree has replicas (``share_compiled_with``), a
replica engine, which dispatches on a CUDA stream of its own, is timed
in the same rounds beside the primary (the current stream), the order
alternating.  ``--profile N`` then runs N bucket-32 dispatches of the
primary under ``cProfile`` and prints the 15 functions with the most
own time.

``--tree`` (default: this checkout) names the checkout whose package is
timed, for example a parent commit unpacked with ``git archive`` into a
gitignored directory.  Processes on one card differ by tens of percent
in host-bound rates, so compare two trees in turns (parent, change,
change, parent) within one machine.  Prints one JSON line per round and
side, and a last line with the tree and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _round(torch, engine, q32, q1) -> dict:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        engine.query(q32)
    qps = 100 * 32 / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    for _ in range(200):
        engine.query(q1)
    return {"qps32": qps, "ms1": (time.perf_counter() - t0) / 200 * 1e3}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))

    import torch

    if not torch.cuda.is_available():
        print("serve_bench: no CUDA device is available")
        return 1
    import inspect

    from npairloss_tpu_torch.device import resolve_device
    from npairloss_tpu_torch.ops import _build
    from npairloss_tpu_torch.serve.engine import EngineConfig, QueryEngine
    from npairloss_tpu_torch.serve.ivf import IVFIndex
    from npairloss_tpu_torch.tools.probe_bench import synthetic_gallery

    resolve_device("cuda")
    _build.library()
    emb, labels = synthetic_gallery(args.seed)
    index = IVFIndex.build_ivf(emb, labels, normalize=False, iters=10,
                               seed=args.seed, device="cuda")
    cfg = EngineConfig(top_k=10, buckets=(1, 8, 32), probes=8,
                       probe_impl="fused")
    engines = {"primary": QueryEngine(index, cfg)}
    engines["primary"].warmup()
    if "share_compiled_with" in inspect.signature(QueryEngine).parameters:
        engines["replica"] = QueryEngine(
            index, cfg, share_compiled_with=engines["primary"])
        engines["replica"].warmup()
    q32, q1 = emb[:32], emb[:1]
    for rnd in range(args.rounds):
        names = list(engines) if rnd % 2 == 0 else list(engines)[::-1]
        for name in names:
            row = _round(torch, engines[name], q32, q1)
            print(json.dumps({"side": name, "round": rnd, **row}),
                  flush=True)
    if args.profile:
        import cProfile
        import io
        import pstats

        prof = cProfile.Profile()
        prof.enable()
        for _ in range(args.profile):
            engines["primary"].query(q32)
        prof.disable()
        text = io.StringIO()
        pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(15)
        print(text.getvalue(), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"tree": args.tree, "card": card}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
