"""Device time per launch of the blockwise kernels at a small pool, where
one launch is shorter than its host dispatch.

Run on a machine with one H100, as a file (so that ``--tree`` decides
which ``npairloss_tpu_torch`` is imported):

    python3 npairloss_tpu_torch/tools/graph_latency.py [--n 120] [--d 1024] [--tree DIR]

Captures 20 calls of each kernel wrapper into a CUDA graph and replays
it between two CUDA events, so no host gap enters the time: the median
of 15 replays, divided by 20.  The calls are the blockwise training
step's at this size: the cached variants on REFERENCE_CONFIG thresholds
of seeded unit features, one hist side, the hist kernel's early
return, and the bf16 mode's once-per-loss rounding of the features;
then the bf16 mode's stats, hist and loss (cached and recompute) on the
rounded features with their bf16 rows (``rows16``, which a tree from
before the tensor-core sim tile does not take: it is then not passed).
Inputs stay in L2 between launches, as they do on the path.
``--tree`` (default: this checkout) names the checkout whose
``npairloss_tpu_torch`` is timed — for example a parent commit unpacked
with ``git archive`` — so two versions can be compared on one card.
Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def graph_us(torch, fn, reps: int = 20, iters: int = 15) -> float:
    """Median device microseconds of one fn() from a graph of reps."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(statistics.median(times)) * 1e3 / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=120)
    ap.add_argument("--d", type=int, default=1024)
    ap.add_argument("--tree", default=str(ROOT),
                    help="checkout whose npairloss_tpu_torch to time")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))

    import torch

    from npairloss_tpu_torch.device import resolve_device
    from npairloss_tpu_torch.ops import blockwise_npair as bw
    from npairloss_tpu_torch.ops import npair_loss as nl
    from npairloss_tpu_torch.ops.rank_select import sortable_key

    if not torch.cuda.is_available():
        print("graph_latency: no CUDA device is available")
        return 1
    resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    n, d = args.n, args.d
    gen = torch.Generator(device="cuda").manual_seed(args.seed + n)
    f = torch.randn((n, d), generator=gen, device="cuda")
    f = (f / f.norm(dim=1, keepdim=True)).contiguous()
    lab = (torch.randperm(n, generator=gen, device="cuda") // 2).to(
        torch.int32)
    cfg = nl.REFERENCE_CONFIG
    _, _, res = bw._forward(f, lab, cfg, 512, 512, True, 8)
    sims = res["sims"]
    thr = (res["pos_thr"], res["neg_thr"], res["max_all"])
    gargs = (f, lab, f, lab, *thr, res["ident_sum"], res["all_sum"],
             torch.ones(n, device="cuda"), torch.ones((), device="cuda"), cfg)
    pre = [sortable_key(sims[:, 1]) >> 28]
    skip = torch.ones((), dtype=torch.bool, device="cuda")
    calls = {
        "npair_stats": lambda: bw.npair_stats(
            f, lab, f, lab, hist_same=True, topk=8, emit_sims=True),
        "npair_hist": lambda: bw.npair_hist(f, lab, f, lab, [True], pre, 1,
                                            sims=sims),
        "npair_hist_early_return": lambda: bw.npair_hist(
            f, lab, f, lab, [True], pre, 1, sims=sims, skip=skip),
        "npair_loss": lambda: bw.npair_loss(f, lab, f, lab, *thr, cfg,
                                            sims=sims),
        "npair_gq": lambda: bw.npair_gq(*gargs, sims=sims),
        "npair_gdb": lambda: bw.npair_gdb(*gargs, sims=sims),
        "round_bf16": lambda: bw.round_bf16(f),
    }
    # The bf16 mode on its own forward's sims.
    _, _, r16 = bw._forward(f, lab, cfg, 512, 512, True, 8, "default")
    kw = {"matmul_precision": "default"}
    if "rows16" in inspect.signature(bw.npair_stats).parameters:
        kw["rows16"] = r16["rows16"]
    fk, s16 = r16["feats"], r16["sims"]
    thr16 = (r16["pos_thr"], r16["neg_thr"], r16["max_all"])
    pre16 = [sortable_key(s16[:, 1]) >> 28]
    calls.update({
        "npair_stats_bf16": lambda: bw.npair_stats(
            fk, lab, fk, lab, hist_same=True, topk=8, emit_sims=True, **kw),
        "npair_hist_bf16": lambda: bw.npair_hist(
            fk, lab, fk, lab, [True], pre16, 1, sims=s16, **kw),
        "npair_hist_bf16_recompute": lambda: bw.npair_hist(
            fk, lab, fk, lab, [True], pre16, 1, **kw),
        "npair_loss_bf16": lambda: bw.npair_loss(
            fk, lab, fk, lab, *thr16, cfg, sims=s16, **kw),
        "npair_loss_bf16_recompute": lambda: bw.npair_loss(
            fk, lab, fk, lab, *thr16, cfg, **kw),
    })
    row = {"card": card, "tree": args.tree, "n": n, "d": d}
    for name, fn in calls.items():
        row[f"{name}_us"] = graph_us(torch, fn)
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
