"""Where the time of the blockwise kernels goes.

Run on a machine with one H100, from the repository root:

    python -m npairloss_tpu_torch.tools.kernel_breakdown [--sizes 32768x512,8192x1024]

Builds ``csrc/npair_blockwise.cu`` once as it is and once per variant
with one part of the work taken out (a text edit of the source, checked
to apply once), each into its own library under
``build/kernels/variants/``, all nvcc processes started together; then
times, per size and variant, ``npair_stats`` (digit-0 histogram, 8
slots, sims emitted), the cached ``npair_gq``/``npair_gdb``, and
``npair_hist`` (digit 1, two sides) and ``npair_loss``, cached and
recompute, on REFERENCE_CONFIG thresholds of seeded unit features,
beside cuBLAS's fp32 ``f @ f.T`` and ``torch.amax`` over the cache (one
PyTorch read of the same bytes).  A variant's outputs are wrong by construction; only
its time means anything: full minus variant is what the removed part
costs where it does not overlap the rest.  Prints one JSON line per
size with the card's name and power limit.

``build`` and ``median_ms`` are this tool's and ``stem_bench.py``'s:
``VARIANTS`` holds the edits of each source by its file name.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import time

# source file -> variant name -> (what it changes, [(text, replacement)])
VARIANTS = {"npair_blockwise.cu": {
    "full": ("nothing", []),
    "no_weights": ("the grad's weight epilogue (cached)", [(
        "        for (int e = 0; e < kGroups; ++e) {",
        "        for (int e = 0; e < 0; ++e) {")]),
    "no_cluster_sync": ("the grad's per-tile cluster barrier", [(
        "      cluster.sync();  // every rank's rows of tile tc are in wt",
        "")]),
    "no_fma": ("the grad product's FMAs (its loads and syncs stay)", [(
        "            for (int a = 0; a < 8; ++a) {\n"
        "              const float w = comp(wv[a], e);",
        "            for (int a = 0; a < 0; ++a) {\n"
        "              const float w = comp(wv[a], e);")]),
    "no_stats_epilogue": ("the stats kernel's row-wise epilogue", [(
        "#pragma unroll 1\n    for (int u = 0; u < kBT / 8; ++u) {",
        "#pragma unroll 1\n    for (int u = 0; u < 0; ++u) {")]),
    # The cached sweeps then stream the cache and nothing else (the
    # recompute sweeps run the bare sim loop).
    "no_hist_epilogue": ("the hist kernel's per-key epilogue", [(
        "    for (int e = 0; e < 4; ++e) {\n"
        "      const Pair p = pair_of(q, i + e, lq, label_as<L>(comp(l, e)), "
        "n, m,\n                             self_offset);\n"
        "      const unsigned key",
        "    for (int e = 0; e < 0; ++e) {\n"
        "      const Pair p = pair_of(q, i + e, lq, label_as<L>(comp(l, e)), "
        "n, m,\n                             self_offset);\n"
        "      const unsigned key")]),
    "no_loss_epilogue": ("the loss kernel's per-pair epilogue", [(
        "    for (int e = 0; e < 4; ++e) {\n      const float s = comp(v, e);",
        "    for (int e = 0; e < 0; ++e) {\n      const float s = comp(v, e);"
    )]),
}, "stem.cu": {
    "full": ("nothing", []),
    "pool_cols1": ("one output column a thread on the 3 x 3 / s2 path", [
        ("constexpr int kPoolCols = 2;", "constexpr int kPoolCols = 1;")]),
    "pool_cols4": ("four output columns a thread on the 3 x 3 / s2 path", [
        ("constexpr int kPoolCols = 2;", "constexpr int kPoolCols = 4;")]),
    "lrn_no_window": ("the LRN backward's transposed-window sum", [
        ("          t = __fadd_rn(t, wv[P + j + oo]);", "          t = 0.f;")]),
    "lrn_no_denominator": ("the recompute LRN backward's window sum of x^2",
                           [("          dv[j] = lrn_denominator_staged<LO, "
                             "HI>(xw + P + j, a, k);",
                             "          dv[j] = k;")]),
}}


def edited(src_name, name):
    """(csrc/<src_name> with variant ``name``'s edits, each checked to
    apply once; the directory of its headers)."""
    from npairloss_tpu_torch.ops import _build

    text = (_build.CSRC / src_name).read_text()
    for old, new in VARIANTS[src_name][name][1]:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: edit does not apply")
        text = text.replace(old, new)
    return text, _build.CSRC


def build(src_name, sources, others=True):
    """One library per entry of ``sources`` ({name: (text of
    ``src_name``, its header directory)}, e.g. from ``edited``), under
    build/kernels/variants/<src_name>/<name>/, with the other sources of
    csrc/ linked in unless ``others`` is false, all nvcc processes started
    together; returns {name: ctypes.CDLL}, each entry of _SIGNATURES that
    the library defines bound."""
    from npairloss_tpu_torch.ops import _build

    rest = ([str(p) for p in _build._sources() if p.name != src_name]
            if others else [])
    root = _build.BUILD_DIR / "variants" / src_name
    procs = {}
    for name, (text, include) in sources.items():
        d = root / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        (d / src_name).write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
             str(include), "-o", str(d / "lib.so"), str(d / src_name),
             *rest],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name}: nvcc failed\n{out}")
        lib = ctypes.CDLL(str(root / name / "lib.so"))
        for fn_name, argtypes in _build._SIGNATURES.items():
            fn = getattr(lib, fn_name, None)
            if fn is not None:
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        lib.npl_error_string.argtypes = [ctypes.c_int]
        lib.npl_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def median_ms(torch, fn, flush, iters=5, setups=None):
    """Median CUDA-event time of fn, ``flush()`` (an L2 flush) before each
    launch.  With ``setups`` (callables), one median per setup: the setups
    are taken in turn before every launch, so that the card's drift falls
    on all alike."""
    turns = setups or [lambda: None]
    for setup in turns:
        setup()
        fn()
    times = [[] for _ in turns]
    for _ in range(iters):
        for i, setup in enumerate(turns):
            setup()
            flush()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times[i].append(a.elapsed_time(b))
    meds = [float(statistics.median(t)) for t in times]
    return meds if setups else meds[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default="32768x512,8192x1024")
    ap.add_argument("--variants",
                    default=",".join(VARIANTS["npair_blockwise.cu"]))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    from npairloss_tpu_torch.device import resolve_device
    from npairloss_tpu_torch.ops import _build
    from npairloss_tpu_torch.ops import blockwise_npair as bw
    from npairloss_tpu_torch.ops import npair_loss as nl
    from npairloss_tpu_torch.ops.rank_select import sortable_key

    if not torch.cuda.is_available():
        print("kernel_breakdown: no CUDA device is available")
        return 1
    resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    names = args.variants.split(",")
    t0 = time.perf_counter()
    libs = build("npair_blockwise.cu",
                 {name: edited("npair_blockwise.cu", name) for name in names})
    print(f"[breakdown] {card}; built {len(libs)} variants in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    flush = torch.empty(32 << 20, device="cuda").zero_  # 128 MB > 50 MB L2
    for size in args.sizes.split(","):
        n, d = (int(v) for v in size.split("x"))
        gen = torch.Generator(device="cuda").manual_seed(args.seed + n)
        f = torch.randn((n, d), generator=gen, device="cuda")
        f = (f / f.norm(dim=1, keepdim=True)).contiguous()
        lab = (torch.randperm(n, generator=gen, device="cuda") // 2).to(
            torch.int32)
        cfg = nl.REFERENCE_CONFIG
        _build._lib = libs[names[0]]
        _, _, res = bw._forward(f, lab, cfg, 512, 512, True, 8)
        sims = res["sims"]
        thr = (res["pos_thr"], res["neg_thr"], res["max_all"])
        gargs = (f, lab, f, lab, *thr, res["ident_sum"], res["all_sum"],
                 torch.ones(n, device="cuda"), torch.ones((), device="cuda"),
                 cfg)
        # Digit-1 prefixes of real pairs, both sides.
        hargs = (f, lab, f, lab, [True, False],
                 [sortable_key(sims[:, 1]) >> 28] * 2, 1)
        row = {"card": card, "n": n, "d": d,
               "cublas_ms": median_ms(torch, lambda: f @ f.T, flush),
               "amax_cache_ms": median_ms(
                   torch, lambda: torch.amax(sims, dim=1), flush)}
        for name in names:
            _build._lib = libs[name]
            row[name] = {
                "stats_emit_ms": median_ms(torch, lambda: bw.npair_stats(
                    f, lab, f, lab, hist_same=True, topk=8,
                    emit_sims=True), flush),
                "gq_cached_ms": median_ms(torch, lambda: bw.npair_gq(
                    *gargs, sims=res["sims"]), flush),
                "gdb_cached_ms": median_ms(torch, lambda: bw.npair_gdb(
                    *gargs, sims=res["sims"]), flush),
                "hist_cached_ms": median_ms(torch, lambda: bw.npair_hist(
                    *hargs, sims=sims), flush),
                "hist_recompute_ms": median_ms(
                    torch, lambda: bw.npair_hist(*hargs), flush),
                "loss_cached_ms": median_ms(torch, lambda: bw.npair_loss(
                    f, lab, f, lab, *thr, cfg, sims=sims), flush),
                "loss_recompute_ms": median_ms(
                    torch, lambda: bw.npair_loss(f, lab, f, lab, *thr, cfg),
                    flush)}
        print(json.dumps(row), flush=True)
        del res, gargs, sims
    _build._lib = None
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
