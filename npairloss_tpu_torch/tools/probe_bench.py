"""Time the fused IVF probe kernel at the serving path's buckets.

Run on a machine with one H100, from the repository root:

    python -m npairloss_tpu_torch.tools.probe_bench [--parent DIR] [--variants full,no_merge,stream_only,ring_only] [--flush write|read] [--probes 8,16] [--iters 15]

The gallery is the serving path's: 60,502 unit rows x 1024 (the SOP test
split's size) in 11,316 identities, each row its identity's random
centre plus noise, built into an IVF index (~246 clusters) on the card;
the queries are gallery rows.  Cases: B = 1, 8 and 32 queries (the
serving buckets) x fp32, bf16 and int8 scoring, at each ``--probes``
(k 10), each beside two bounds: the probed rows' bytes, per (query,
probe), over 3.35 TB/s, and the same with each probed cluster read once
(what queries sharing a cluster in the L2 could reach).

``csrc/ivf_probe.cu`` is built once per named variant of
``kernel_breakdown.VARIANTS["ivf_probe.cu"]`` (``full``: as it is;
``no_merge`` keeps no candidate, ``stream_only`` also folds each vector
of the ring in by one add instead of its FMAs, ``ring_only`` reads no
vector of the ring: their outputs are wrong and only their time means
anything), and with ``--parent DIR`` once more
from ``DIR/npairloss_tpu_torch/csrc/ivf_probe.cu`` (a parent commit
unpacked with ``git archive``; its C interface must be this one's), each
linked with ``csrc/stem.cu`` for the error strings.  Every case is timed
under every library in turn, in one process: the median of ``--iters``
launches from CUDA events, the L2 flushed before each by writing a 128
MB buffer (``--flush write``, as chip_smoke.py's Timer) or by reading it
(``--flush read``), then the stream held by a device sleep while the
host dispatches the call (``kernel_breakdown.median_ms``: the events
time the device, not the wrapper's Python).  The correctness checks of
the kernel are chip_smoke.py's phase 3.  Then the serving path's steady state,
``QueryEngine.query`` on one bucket of 32 embedding queries (probes 8),
queries/s under each library, three rounds in turns.  Prints one JSON
line per case, one with the steady states, and a last one with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12


def synthetic_gallery(seed: int, n: int = 60502, ids: int = 11316,
                      dim: int = 1024):
    """Unit rows, each its identity's random centre plus noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sizes = 5 + (np.arange(ids) < n - 5 * ids)
    labels = np.repeat(np.arange(ids, dtype=np.int32), sizes)
    rng.shuffle(labels)
    centres = rng.standard_normal((ids, dim), dtype=np.float32)
    centres /= np.linalg.norm(centres, axis=1, keepdims=True)
    noise = rng.standard_normal((n, dim), dtype=np.float32)
    noise *= 0.5 / np.sqrt(dim)
    emb = centres[labels] + noise
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    return emb.astype(np.float32), labels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None,
                    help="checkout whose csrc/ivf_probe.cu to time in turns")
    ap.add_argument("--variants", default="full",
                    help="comma-separated variants of csrc/ivf_probe.cu")
    ap.add_argument("--flush", choices=["write", "read"], default="write",
                    help="how the L2 is flushed before each launch")
    ap.add_argument("--probes", default="8",
                    help="comma-separated probe counts")
    ap.add_argument("--iters", type=int, default=15)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("probe_bench: no CUDA device is available")
        return 1
    import numpy as np

    from npairloss_tpu_torch.device import resolve_device
    from npairloss_tpu_torch.ops import _build
    from npairloss_tpu_torch.ops.ivf_probe import probe_select, probe_topk
    from npairloss_tpu_torch.serve.engine import EngineConfig, QueryEngine
    from npairloss_tpu_torch.serve.ivf import IVFIndex
    from npairloss_tpu_torch.tools.kernel_breakdown import (build, edited,
                                                            median_ms)

    resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    sources = {name: edited("ivf_probe.cu", name)
               for name in args.variants.split(",")}
    if args.parent:
        csrc = Path(args.parent).resolve() / "npairloss_tpu_torch" / "csrc"
        sources["parent"] = ((csrc / "ivf_probe.cu").read_text(), csrc)
    libs = build("ivf_probe.cu", sources, others=("stem.cu",))
    buf = torch.zeros(32 << 20, dtype=torch.float32, device="cuda")
    sink = torch.empty((), dtype=torch.float32, device="cuda")
    flush = (buf.zero_ if args.flush == "write"
             else lambda: torch.amax(buf, out=sink))

    def use(lib):
        def setup():
            _build._lib = lib
        return setup

    emb, labels = synthetic_gallery(args.seed)
    index = IVFIndex.build_ivf(emb, labels, normalize=False, iters=10,
                               seed=args.seed, device="cuda")
    layout = index.layout
    cap, d, k = layout.cap, index.dim, 10
    pick = np.random.default_rng(args.seed + 1).choice(
        emb.shape[0], size=32, replace=False)
    queries = torch.as_tensor(emb[pick], device="cuda")
    try:
        for probes in (int(p) for p in args.probes.split(",")):
            for bq in (1, 8, 32):
                q = queries[:bq].contiguous()
                _, lids, owned = probe_select(
                    q, layout.centroids, layout.cluster_valid, probes, 0,
                    layout.packed.shape[0])
                owned = owned.to(torch.int32).contiguous()
                kl = min(k, probes * cap)
                rows = int((layout.rows[lids.long()] >= 0).sum().item())
                uniq = int((layout.rows[torch.unique(lids.long())] >= 0)
                           .sum().item())
                for scoring in ("fp32", "bf16", "int8"):
                    slab, scale = index.scored_arrays(scoring)
                    el = slab.element_size()
                    call = (lambda a=(q, slab, layout.rows, lids, owned,
                                      scale), s=scoring:
                            probe_topk(*a, kl=kl, scoring=s))
                    meds = median_ms(torch, call, flush, args.iters,
                                     [use(lib) for lib in libs.values()])
                    row = {"kernel": "ivf_probe", "batch": bq,
                           "probes": probes, "cap": cap, "dim": d,
                           "scoring": scoring, "probed_rows": rows,
                           "probed_unique_rows": uniq,
                           "bound_ms": rows * d * el / HBM_BYTES_PER_S * 1e3,
                           "bound_unique_ms":
                               uniq * d * el / HBM_BYTES_PER_S * 1e3,
                           **{f"ms_{name}": t
                              for name, t in zip(libs, meds)}}
                    print(json.dumps(row), flush=True)
        # The serving path end to end: QueryEngine.query on one bucket of
        # 32 embedding queries (probes 8), its steady state under each
        # library, in turns (the host's share varies between rounds).
        engine = QueryEngine(index, EngineConfig(
            top_k=k, buckets=(1, 8, 32), probes=8, probe_impl="fused"))
        q32 = emb[pick]
        qps = {name: [] for name in libs}
        for _ in range(3):
            for name, lib in libs.items():
                _build._lib = lib
                for _ in range(5):
                    engine.query(q32)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(50):
                    engine.query(q32)
                qps[name].append(50 * 32 / (time.perf_counter() - t0))
        print(json.dumps({"serving_steady_qps_bucket32": qps}), flush=True)
        torch.cuda.synchronize()
    finally:
        _build._lib = None
    print(json.dumps({"card": card, "flush": args.flush,
                      "libraries": list(libs)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
