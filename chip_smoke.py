#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``npairloss_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--seed 0]

Phases (any failure raises, exits nonzero and prints no result line):

1. the card: ``nvidia-smi`` name and power limit, torch version and
   compute capability (must be 9.0); TF32 off for fp32 parity;
2. build the four CUDA kernels from ``npairloss_tpu_torch/csrc/`` with
   nvcc (one process per source, started together);
3. hold each kernel against its plain PyTorch version on the card at
   the serving path's shapes — LRN and bias+ReLU at (32,56,56,64) and
   (32,56,56,192), bias+ReLU+pool at (32,112,112,64), in fp32 and bf16;
   the IVF probe at B=32 against the phase-4 index, probes 8, k 10, in
   fp32/bf16/int8 (and once at D = 100, the kernel's element-wise
   path) — with the error against a stated tolerance and the
   median time from CUDA events (L2 flushed before every timed launch)
   beside the least time the card could take;
4. the serving path: a synthetic 60,502-row x 1024 gallery in 11,316
   identities (the SOP test split's size), an IVF index (~246 clusters),
   a ``googlenet_pallas`` engine at 224x224 (bf16, seeded trunk) with
   ``probe_impl="fused"``, and ~40 JSONL records (raw images, gallery
   rows, one bad line) through ``RetrievalServer.run_jsonl``; every
   answer, the top-1 self-match, the drain invariant, all four launch
   counters > 0, an exhaustive-probe recall of 1.0 against the flat
   engine, and the trunk on the card against the trunk on the CPU;
5. a ``{"kernels": [...]}`` line; then the card line; then the last
   line ``{"ok": true, "device": {...}}``.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS = {"fp32": 67e12, "bf16": 989e12, "int8": 1979e12}

TOL = {
    # fp32: same operation order as the plain version; rsqrt/exp/log may
    # differ by an ulp between the kernel and torch's own kernels.
    "stem_fp32": 1e-5,
    # bf16 storage: one bf16 ulp (2^-8 relative) at values up to ~4.
    "stem_bf16": 3e-2,
    # probe scores: fp32 sums over D=1024 in another order.
    "probe": 1e-5,
}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    if not lines:
        fail("nvidia-smi printed no card")
    return lines[0]


class Timer:
    """Median device time of one call, L2 flushed before each launch."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(32 << 20, dtype=torch.float32,
                                 device="cuda")  # 128 MB > 50 MB L2

    def ms(self, fn, iters: int = 15, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(statistics.median(times))


def library_ms(timer, fn):
    """Time of the one PyTorch call that computes the same function (a
    yardstick, used nowhere in the port); None where there is none or
    PyTorch has no kernel for the dtype."""
    if fn is None:
        return None
    try:
        return timer.ms(fn)
    except (RuntimeError, NotImplementedError) as e:
        log(f"[kernel] library call unavailable: {e}")
        return None


def bound_ms(nbytes: float, ops: float, kind: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


# -- phase 3: stem kernels ----------------------------------------------------


def check_stem(torch, timer, detail):
    import torch.nn.functional as F

    from npairloss_tpu_torch.ops import stem

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {"lrn": [], "bias_relu": [], "bias_relu_pool": []}
    for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        tol = TOL[f"stem_{tag}"]
        size = 4 if tag == "fp32" else 2
        for c in (64, 192):
            shape = (32, 56, 56, c)
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            b = torch.randn((c,), generator=gen, device="cuda") * 0.1
            n = x.numel()
            for name, kern, plain, args, lib in (
                    ("lrn", stem.fused_lrn, stem.lrn_plain, (x,),
                     lambda: F.local_response_norm(
                         x.permute(0, 3, 1, 2), 5, 1e-4, 0.75, 1.0)),
                    ("bias_relu", stem.fused_bias_relu,
                     stem.bias_relu_plain, (x, b), None)):
                got = kern(*args)
                want = plain(*args)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                if not err <= tol:
                    fail(f"{name} {tag} {shape}: max_abs_err {err} > {tol}")
                nbytes = 2 * n * size + (4 * c if name == "bias_relu" else 0)
                ops = n * (14 if name == "lrn" else 2)
                bms, by = bound_ms(nbytes, ops, "fp32")
                row = {"shape": list(shape), "dtype": tag,
                       "max_abs_err": err, "tol": tol,
                       "ms": timer.ms(lambda: kern(*args)),
                       "plain_ms": timer.ms(lambda: plain(*args)),
                       "bound_ms": bms, "bound_by": by,
                       "library_ms": library_ms(timer, lib)}
                rows[name].append(row)
                log(f"[kernel] {name} {tag} {shape}: {json.dumps(row)}")
        shape = (32, 112, 112, 64)
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        b = torch.randn((64,), generator=gen, device="cuda") * 0.1
        got = stem.fused_bias_relu_pool(x, b)
        want = stem.bias_relu_pool_plain(x, b)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if not err <= tol:
            fail(f"bias_relu_pool {tag}: max_abs_err {err} > {tol}")
        nbytes = (x.numel() + got.numel()) * size + 4 * 64
        bms, by = bound_ms(nbytes, 9 * 2 * got.numel(), "fp32")
        row = {"shape": list(shape), "dtype": tag, "max_abs_err": err,
               "tol": tol,
               "ms": timer.ms(lambda: stem.fused_bias_relu_pool(x, b)),
               "plain_ms": timer.ms(
                   lambda: stem.bias_relu_pool_plain(x, b)),
               "bound_ms": bms, "bound_by": by, "library_ms": None}
        rows["bias_relu_pool"].append(row)
        log(f"[kernel] bias_relu_pool {tag} {shape}: {json.dumps(row)}")
    detail["stem"] = rows
    return rows


# -- phase 3: probe kernel ----------------------------------------------------


def check_probe_odd_dim(torch, detail):
    """The probe kernel's element-wise path: D = 100 is no multiple of a
    16-byte vector in any scoring dtype.  Ragged clusters, one empty."""
    from npairloss_tpu_torch.ops.ivf_probe import (
        NEG_FILL,
        probe_select,
        probe_topk,
        probe_topk_plain,
    )
    from npairloss_tpu_torch.serve.ivf import quantize_int8

    gen = torch.Generator(device="cuda").manual_seed(2)
    kc, cap, d, b = 5, 37, 100, 7
    packed = torch.randn((kc, cap, d), generator=gen, device="cuda")
    rows = torch.arange(kc * cap, dtype=torch.int32,
                        device="cuda").reshape(kc, cap)
    rows[1] = -1
    rows[3, 20:] = -1
    q = torch.randn((b, d), generator=gen, device="cuda")
    _, lids, owned = probe_select(q, torch.randn((kc, d), generator=gen,
                                                 device="cuda"),
                                  rows.max(1).values >= 0, 4, 0, kc)
    owned = owned.to(torch.int32).contiguous()
    errs = {}
    for scoring, (slab, scale) in (
            ("fp32", (packed, None)),
            ("bf16", (packed.to(torch.bfloat16), None)),
            ("int8", quantize_int8(packed))):
        args = (q, slab, rows, lids, owned, scale)
        s_k, r_k = probe_topk(*args, kl=10, scoring=scoring)
        s_p, r_p = probe_topk_plain(*args, kl=10, scoring=scoring)
        torch.cuda.synchronize()
        real = s_p > NEG_FILL * 0.5
        err = (s_k - s_p).abs()[real].max().item()
        if not err <= TOL["probe"] or not torch.equal(r_k[real], r_p[real]):
            fail(f"probe D=100 {scoring}: err {err}, rows differ: "
                 f"{not torch.equal(r_k[real], r_p[real])}")
        errs[scoring] = err
    log(f"[kernel] ivf_probe element-wise path (D=100): {json.dumps(errs)}")
    detail["probe_odd_dim"] = errs


def check_probe(torch, timer, index, queries, detail):
    import numpy as np

    from npairloss_tpu_torch.ops.ivf_probe import (
        NEG_FILL,
        probe_select,
        probe_topk,
        probe_topk_plain,
    )

    layout = index.layout
    q = torch.as_tensor(queries, device="cuda")
    probes, k = 8, 10
    _, lids, owned = probe_select(q, layout.centroids, layout.cluster_valid,
                                  probes, 0, layout.packed.shape[0])
    owned = owned.to(torch.int32).contiguous()
    cap, d = layout.cap, index.dim
    kl = min(k, probes * cap)
    lids_np = lids.cpu().numpy()
    valid_rows = int((layout.rows[lids.long()] >= 0).sum().item())
    out = {}
    for scoring in ("fp32", "bf16", "int8"):
        slab, scale = index.scored_arrays(scoring)
        args = (q, slab, layout.rows, lids, owned, scale)
        s_k, r_k = probe_topk(*args, kl=kl, scoring=scoring)
        s_p, r_p = probe_topk_plain(*args, kl=kl, scoring=scoring)
        torch.cuda.synchronize()
        real = s_p > NEG_FILL * 0.5
        err = (s_k - s_p).abs()[real].max().item()
        if not err <= TOL["probe"]:
            fail(f"probe {scoring}: max_abs_err {err} > {TOL['probe']}")
        # Rows must agree except inside a score tie (within 2 tol).
        sp = s_p.cpu().numpy()
        mism = (r_k != r_p).cpu().numpy() & real.cpu().numpy()
        gap = np.full(sp.shape, np.inf, np.float32)
        gap[:, 1:] = np.minimum(gap[:, 1:], np.abs(np.diff(sp, axis=1)))
        gap[:, :-1] = np.minimum(gap[:, :-1], np.abs(np.diff(sp, axis=1)))
        if (mism & (gap > 2 * TOL["probe"])).any():
            fail(f"probe {scoring}: rows differ outside score ties")
        el = slab.element_size()
        nbytes = (valid_rows * d * el + lids_np.size * cap * 4
                  + q.numel() * 4 + 2 * lids_np.size * 4
                  + q.shape[0] * kl * 8
                  + (lids_np.size * 4 if scale is not None else 0))
        bms, by = bound_ms(nbytes, 2.0 * valid_rows * d, scoring)
        row = {"batch": int(q.shape[0]), "probes": probes, "k": k,
               "cap": cap, "dim": d, "scoring": scoring,
               "probed_rows": valid_rows, "max_abs_err": err,
               "tol": TOL["probe"], "row_mismatches_in_ties": int(mism.sum()),
               "ms": timer.ms(lambda: probe_topk(*args, kl=kl,
                                                 scoring=scoring)),
               "plain_ms": timer.ms(lambda: probe_topk_plain(
                   *args, kl=kl, scoring=scoring)),
               "bound_ms": bms, "bound_by": by, "library_ms": None}
        out[scoring] = row
        log(f"[kernel] ivf_probe {scoring}: {json.dumps(row)}")
    detail["probe"] = out
    return out


# -- phase 4: the serving path ------------------------------------------------


def drive_path(torch, seed, index, emb, detail):
    import numpy as np

    from npairloss_tpu_torch.models import get_model
    from npairloss_tpu_torch.ops import _build
    from npairloss_tpu_torch.serve.batcher import BatcherConfig
    from npairloss_tpu_torch.serve.engine import EngineConfig, QueryEngine
    from npairloss_tpu_torch.serve.index import GalleryIndex
    from npairloss_tpu_torch.serve.ivf import topk_recall
    from npairloss_tpu_torch.serve.server import (
        Freshness,
        RetrievalServer,
        ServerConfig,
    )

    rng = np.random.default_rng(seed + 1)
    model = get_model("googlenet_pallas", device="cuda", seed=seed)
    cfg = EngineConfig(top_k=10, buckets=(1, 8, 32), probes=8,
                       probe_impl="fused")
    engine = QueryEngine(index, cfg, model=model)
    t0 = time.perf_counter()
    engine.warmup((224, 224, 3))
    log(f"[path] warmup {time.perf_counter() - t0:.3f} s")

    images = rng.standard_normal((8, 224, 224, 3), dtype=np.float32)
    gal_rows = rng.choice(emb.shape[0], size=30, replace=False)
    records = []
    for i, r in enumerate(gal_rows):
        records.append({"id": f"g{i}", "embedding": emb[r].tolist()})
        if i % 4 == 0 and i // 4 < len(images):
            records.append({"id": f"x{i // 4}",
                            "input": images[i // 4].tolist()})
    lines = [json.dumps(r) for r in records]
    lines.insert(17, "{this is not json")
    server = RetrievalServer(
        engine,
        BatcherConfig(max_batch=32, max_delay_ms=5.0, max_queue=256),
        ServerConfig(poll_s=0.01),
        freshness=Freshness.collect(index=index, index_path="synthetic"))
    out = io.StringIO()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    rc = server.run_jsonl(io.StringIO("\n".join(lines) + "\n"), out)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _build.launch_counts()
    log(f"[path] launches {json.dumps(launches)}")
    if rc != 0:
        fail(f"run_jsonl returned {rc}")
    answers = [json.loads(ln) for ln in out.getvalue().splitlines()]
    summary = answers[-1]
    by_id = {a.get("id"): a for a in answers[:-1]}
    if summary.get("event") != "serve_drain":
        fail("the last JSONL line is not the drain summary")
    bad = [a for a in answers[:-1] if a.get("id") is None]
    if len(bad) != 1 or "error" not in bad[0]:
        fail(f"the bad line must answer one error, got {bad}")
    for rec in records:
        a = by_id.get(rec["id"])
        if a is None or "error" in a or len(a["neighbors"]) != 10:
            fail(f"record {rec['id']} not answered: {a}")
        scores = [n["score"] for n in a["neighbors"]]
        if not all(np.isfinite(scores)) or scores != sorted(scores,
                                                            reverse=True):
            fail(f"record {rec['id']}: bad scores {scores}")
    for i, r in enumerate(gal_rows):
        top = by_id[f"g{i}"]["neighbors"][0]
        if top["row"] != int(r) or not top["score"] > 0.99:
            fail(f"gallery row {r}: top-1 is {top}")
    n_q = len(records)
    if not (summary["queries"] == n_q and summary["answered"] == n_q
            and summary["errors"] == 1 and summary["errors_refused"] == 1
            and summary["rejected"] == 0
            and summary["queries_dropped"] == 0
            and summary["queries"] == summary["answered"]
            + summary["errors"] - summary["errors_refused"]
            + summary["rejected"]):
        fail(f"drain invariant broken: {summary}")
    for name in ("fused_lrn", "fused_bias_relu", "fused_bias_relu_pool",
                 "probe_topk"):
        if launches.get(name, 0) < 1:
            fail(f"kernel {name} was not launched on the path")
    log(f"[path] answered {summary['answered']} of {n_q} queries + 1 bad "
        f"line in {wall:.3f} s: p50 {summary['p50_ms']} ms, p99 "
        f"{summary['p99_ms']} ms, {n_q / wall:.1f} queries/s through "
        f"run_jsonl")

    # Steady-state IVF query throughput at the largest bucket.
    q32 = emb[gal_rows[:30]]
    q32 = np.concatenate([q32, emb[gal_rows[:2]]])
    for _ in range(3):
        engine.query(q32)
    torch.cuda.synchronize()
    reps = 50
    t0 = time.perf_counter()
    for _ in range(reps):
        engine.query(q32)
    qps = reps * 32 / (time.perf_counter() - t0)
    t_enc = time.perf_counter()
    engine.encode(images)
    enc_ms = (time.perf_counter() - t_enc) * 1e3
    log(f"[path] steady state: {qps:.1f} queries/s (fused IVF, bucket 32, "
        f"embedding queries); encode of 8 images {enc_ms:.3f} ms")

    # Exhaustive probing must reproduce the flat engine exactly.
    queries = np.concatenate([emb[gal_rows], engine.encode(images)])
    full = QueryEngine(index, EngineConfig(
        top_k=10, buckets=(1, 8, 32), probes=index.n_clusters,
        probe_impl="fused"))
    flat = QueryEngine(GalleryIndex.build(
        index.host_emb, index.host_labels, ids=index.ids, normalize=False,
        device="cuda"), EngineConfig(top_k=10, buckets=(1, 8, 32)))
    recall = topk_recall(full.query(queries)["rows"],
                         flat.query(queries)["rows"])
    log(f"[path] probes=clusters ({index.n_clusters}) vs flat: "
        f"topk_recall {recall}")
    if recall != 1.0:
        fail(f"exhaustive IVF recall {recall} != 1.0")

    # The trunk on the card (kernels, fp32) against the trunk on the CPU
    # (plain versions, fp32) on the same weights and two images.
    m_gpu = get_model("googlenet_pallas", device="cuda", seed=seed,
                      dtype=torch.float32)
    m_cpu = get_model("googlenet_pallas", device="cpu", seed=seed,
                      dtype=torch.float32)
    m_cpu.load_state_dict(m_gpu.state_dict())
    x2 = torch.as_tensor(images[:2])
    with torch.inference_mode():
        e_gpu = m_gpu(x2.cuda()).cpu()
        e_cpu = m_cpu(x2)
        e_bf16 = model(x2.cuda()).float().cpu()
    enc_err = (e_gpu - e_cpu).abs().max().item()
    cos_bf16 = (e_bf16 * e_cpu).sum(1).min().item()
    log(f"[path] trunk fp32 card vs CPU: max_abs_err {enc_err}; bf16 card "
        f"vs fp32 CPU: min cosine {cos_bf16}")
    if not enc_err <= 1e-4 or not cos_bf16 > 0.99:
        fail("trunk on the card disagrees with the CPU reference")
    detail["path"] = {"summary": summary, "launches": launches,
                      "wall_s": wall, "steady_qps": qps,
                      "encode8_ms": enc_ms, "recall_full": recall,
                      "trunk_fp32_err": enc_err, "trunk_bf16_cos": cos_bf16}
    return launches, summary, qps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = card_line()
    cc = torch.cuda.get_device_capability(0)
    log(f"[card] {card}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"capability {cc[0]}.{cc[1]} devices {torch.cuda.device_count()}")
    if cc != (9, 0):
        fail(f"need compute capability 9.0 (sm_90a), got {cc}")

    from npairloss_tpu_torch.device import resolve_device
    from npairloss_tpu_torch.ops import _build
    from npairloss_tpu_torch.serve.ivf import IVFIndex

    resolve_device("cuda")  # TF32 off for fp32 parity
    t0 = time.perf_counter()
    _build.library()
    info = _build.build_info
    log(f"[build] {info['path']} in {time.perf_counter() - t0:.2f} s "
        f"(cached: {info['cached']})")
    for ln in str(info.get("log", "")).splitlines():
        if "registers" in ln or "spill" in ln or "rc " in ln:
            log(f"[build] {ln.strip()}")

    detail: dict = {"card": card}
    emb, labels = synthetic_gallery(args.seed)
    t0 = time.perf_counter()
    index = IVFIndex.build_ivf(emb, labels, normalize=False, iters=10,
                               seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    log(f"[index] {index.size} rows x {index.dim} -> {index.n_clusters} "
        f"clusters, cap {index.layout.cap}, built in "
        f"{time.perf_counter() - t0:.3f} s")

    timer = Timer(torch)
    stem_rows = check_stem(torch, timer, detail)
    rng_rows = torch.Generator().manual_seed(args.seed)
    pick = torch.randperm(emb.shape[0], generator=rng_rows)[:32].numpy()
    check_probe_odd_dim(torch, detail)
    probe_rows = check_probe(torch, timer, index, emb[pick], detail)
    del timer
    launches, summary, qps = drive_path(torch, args.seed, index, emb, detail)

    def entry(name, source, replaces, rows, counter):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[counter],
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": sum(r["ms"] for r in rows),
                "plain_ms": sum(r["plain_ms"] for r in rows),
                "bound_ms": sum(r["bound_ms"] for r in rows),
                "bound_by": rows[0]["bound_by"],
                "library_ms": (sum(r["library_ms"] for r in rows)
                               if all(r["library_ms"] is not None
                                      for r in rows) else None)}

    # One entry per kernel at the path's own calls: bf16 stem shapes for
    # one 32-image encode (LRN and bias+ReLU run twice each), the fp32
    # probe for one 32-query bucket.
    path_bf16 = lambda rows: [r for r in rows if r["dtype"] == "bf16"]  # noqa: E731
    kernels = [
        entry("lrn_fwd", "npairloss_tpu_torch/csrc/stem.cu",
              "npairloss_tpu/ops/pallas_stem.py:121",
              path_bf16(stem_rows["lrn"]), "fused_lrn"),
        entry("bias_relu", "npairloss_tpu_torch/csrc/stem.cu",
              "npairloss_tpu/ops/pallas_stem.py:308",
              path_bf16(stem_rows["bias_relu"]), "fused_bias_relu"),
        entry("bias_relu_pool", "npairloss_tpu_torch/csrc/stem.cu",
              "npairloss_tpu/ops/pallas_stem.py:383",
              path_bf16(stem_rows["bias_relu_pool"]),
              "fused_bias_relu_pool"),
        entry("ivf_probe", "npairloss_tpu_torch/csrc/ivf_probe.cu",
              "npairloss_tpu/ops/pallas_ivf.py:110",
              [probe_rows["fp32"]], "probe_topk"),
    ]
    detail["kernels"] = kernels
    detail["seconds"] = time.perf_counter() - t_start
    try:
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "chip_smoke_detail.json"),
                  "w") as f:
            json.dump(detail, f, indent=1, default=str)
    except OSError as e:
        log(f"[detail] not written: {e}")
    log(f"[done] {detail['seconds']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
