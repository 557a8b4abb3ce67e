"""Where the time of the blockwise kernels goes.

Run on a machine with one H100, from the repository root:

    python -m npairloss_tpu_torch.tools.kernel_breakdown [--sizes 32768x512,8192x1024] [--precision highest|default] [--parent DIR] [--variants full,...]

Builds ``csrc/npair_blockwise.cu`` once as it is and once per variant
with one part of the work taken out (a text edit of the source, checked
to apply once), each into its own library under
``build/kernels/variants/``, and with ``--parent DIR`` once more from
``DIR/npairloss_tpu_torch/csrc/npair_blockwise.cu`` (a parent commit
unpacked with ``git archive``; a parent from before the tensor-core sim
tile, whose stats/hist/loss entries take no bf16 rows and whose grad
entry takes the product's rows alone, is bound behind this tree's calls),
all nvcc processes started together.  Then times, per size, every case
under every library in turn, in one process (builds move by 30-100 %
between processes): ``npair_stats`` (digit-0 histogram, 8 slots, sims
emitted), ``npair_hist`` (digit 1, two sides) and ``npair_loss``, cached
and recompute, and the cached ``npair_gq``/``npair_gdb`` — in
``--precision highest`` (the fp32 mode), or ``--precision default`` (the
bf16 mode: on ``round_bf16`` rows with their bf16 copy, and the
recompute gq/gdb too) — on REFERENCE_CONFIG thresholds of seeded unit
features, beside cuBLAS's fp32 ``f @ f.T``, its bf16 ``rows16 @
rows16.T`` and ``torch.amax`` over the cache (one PyTorch read of the
same bytes).  With ``--parent``, each case also reports whether this
tree's outputs equal the parent's bit for bit (``same_bits``).  The
default variants are the precision's own (``tc_*`` for the bf16 mode's
tensor-core sim tile and gq/gdb).  A variant's outputs are wrong by
construction; only its time means anything: full minus variant is what
the removed part costs where it does not overlap the rest.  The checks
of these kernels are chip_smoke.py's phases 6 and 6c.  Prints one JSON
line per size with the card's name and power limit.

``build`` and ``median_ms`` are this tool's, ``stem_bench.py``'s and
``probe_bench.py``'s: ``VARIANTS`` holds the edits of each source by its
file name.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import time
from functools import partial

_NO_MERGE = ("  cand = cand && key > w.thr;",
             "  cand = cand && key > ~0ull - 1;")

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
    # The bf16 mode on tensor cores (--precision default): the sim tile
    # of stats and the recompute sweeps, and gq/gdb.
    "tc_no_sim_wgmma": ("the bf16 sim tile's wgmma instructions (stats and "
                        "every recompute sweep; fences, waits and barriers "
                        "stay)", [(
                            "  for (int k = 0; k < kK16 / 16; ++k)\n"
                            "    wgmma_m64n128k16<0>(",
                            "  for (int k = 0; k < 0; ++k)\n"
                            "    wgmma_m64n128k16<0>(")]),
    "tc_no_epilogue": ("the bf16 sim tile's epilogues (stats, recompute "
                       "hist and loss read no staged tile; stats writes no "
                       "cache)", [
                           ("    if (staged >= 0)\n"
                            "      epi(staged, kBT / 8 * kk / nk, "
                            "kBT / 8 * (kk + 1) / nk);\n", ""),
                           ("    epi(staged, 0, kBT / 8);\n", "")]),
    "tc_no_weights": ("the tensor-core grad's weight epilogue (cached and "
                      "recompute)", [(
                          "    for (int e = 0; e < kQuads; ++e) {",
                          "    for (int e = 0; e < 0; ++e) {")]),
    "tc_no_wgmma": ("the tensor-core grad's wgmma instructions (their "
                    "fences, waits and barriers stay)", [(
                        "    for (int k = 0; k < kBT / 16; ++k)\n"
                        "      wgmma_m64n128k16(",
                        "    for (int k = 0; k < 0; ++k)\n"
                        "      wgmma_m64n128k16(")]),
    "tc_no_cluster_sync": ("the tensor-core grad's per-tile cluster "
                           "barrier", [(
                               "    cluster.sync();  // tile tc's weights "
                               "everywhere; tile tc - 1's buffers free",
                               "")]),
    "no_stats_epilogue": ("the stats kernel's row-wise epilogue", [(
        "#pragma unroll 1\n    for (int u = kTC ? u0 : 0; u < (kTC ? u1 : "
        "kBT / 8); ++u) {",
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
}, "ivf_probe.cu": {
    "full": ("nothing", []),
    # Scores are still computed (a real key never reaches ~0 - 1: that is
    # a NaN score, which is no candidate), so nothing is optimised away;
    # no candidate reaches a warp's buffer.
    "no_merge": ("the warp buffers and merges (every score dropped)", [
        _NO_MERGE]),
    "stream_only": ("the merges and the scoring FMAs (each vector from the "
                    "ring folded in by one add)", [_NO_MERGE, (
                        "              if (ci < rv) acc = dot16(qr + i * kv, "
                        "row[ci], acc, TG());",
                        "              if (ci < rv) acc += __uint_as_float("
                        "row[ci].x ^ row[ci].y ^ row[ci].z ^ row[ci].w);")]),
    "span4k": ("4 KB spans a slot (twice the slots)", [(
        "static constexpr size_t kSpanBytes = 8 * 1024;",
        "static constexpr size_t kSpanBytes = 4 * 1024;")]),
    "span16k": ("16 KB spans a slot (half the slots)", [(
        "static constexpr size_t kSpanBytes = 8 * 1024;",
        "static constexpr size_t kSpanBytes = 16 * 1024;")]),
    "ring_only": ("the merges and every read of the ring: the bulk copies "
                  "and the slot handshakes alone", [_NO_MERGE, (
                      "            for (int i = 0; i < kVecs; ++i) {",
                      "            for (int i = 0; i < 0; ++i) {")]),
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
    csrc/ linked in (``others``: True for all, False for none, or a tuple
    of file names), all nvcc processes started together; returns {name:
    ctypes.CDLL}, each entry of _SIGNATURES that the library defines
    bound."""
    from npairloss_tpu_torch.ops import _build

    rest = [str(p) for p in _build._sources() if p.name != src_name
            and (others is True or (others and p.name in others))]
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


# Device cycles the stream sleeps before each timed launch (~0.1 ms at
# the H100's 1.98 GHz): the host dispatches the timed call meanwhile, so
# the events measure the device, not the wrapper's Python.
GUARD_CYCLES = 200_000


def median_ms(torch, fn, flush, iters=5, setups=None):
    """Median CUDA-event time of fn, ``flush()`` (an L2 flush) and a
    device sleep of GUARD_CYCLES before each launch.  With ``setups``
    (callables), one median per setup: the setups are taken in turn
    before every launch, so that the card's drift falls on all alike."""
    turns = setups or [lambda: None]
    for setup in turns:
        setup()
        fn()
    times = [[] for _ in turns]
    for _ in range(iters):
        for i, setup in enumerate(turns):
            setup()
            flush()
            torch.cuda._sleep(GUARD_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times[i].append(a.elapsed_time(b))
    meds = [float(statistics.median(t)) for t in times]
    return meds if setups else meds[0]


# A parent from before the tensor-core sim tile: its stats, hist and loss
# entries end in ..., stream (no bf16 rows), its grad entry in ...,
# pool_major, out, x16, ld16, stream (the product's rows alone).
_PARENT_SWEEP_CALL = "void* sims_out,\n                    void* stream)"


def _sweeps_behind(lib):
    """Bind such a parent's entries behind this tree's calls, which end
    in feats16, pool16, ld16, stream: stats, hist and loss drop the rows
    (the parent's kernels sum the rounded fp32 rows on the FMA pipes),
    grad takes pool16 (gq) or feats16 (gdb)."""
    from npairloss_tpu_torch.ops import _build

    def bind(name, argtypes):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return fn

    def drop(name):
        sig = _build._SIGNATURES[name]
        fn = bind(name, sig[:-4] + sig[-1:])

        def call(*args):
            *head, _f16, _p16, _ld16, stream = args
            return fn(*head, stream)

        setattr(lib, name, call)

    for name in ("npl_npair_stats", "npl_npair_hist", "npl_npair_loss"):
        drop(name)
    sig = _build._SIGNATURES["npl_npair_grad"]
    grad = bind("npl_npair_grad",
                sig[:-4] + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])

    def grad_call(*args):
        *head, f16, p16, ld16, stream = args
        pool_major = head[-2]
        return grad(*head, f16 if pool_major else p16, ld16, stream)

    lib.npl_npair_grad = grad_call


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default="32768x512,8192x1024")
    ap.add_argument("--precision", choices=["highest", "default"],
                    default="highest",
                    help="the kernels' fp32 mode or their bf16 mode")
    ap.add_argument("--variants", default=None,
                    help="comma-separated variants of npair_blockwise.cu "
                         "(default: every variant of the precision's "
                         "kernels)")
    ap.add_argument("--parent", default=None,
                    help="checkout whose csrc/npair_blockwise.cu to time "
                         "in turns")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.variants is None:
        bf16 = args.precision == "default"
        args.variants = ",".join(
            v for v in VARIANTS["npair_blockwise.cu"]
            if v == "full" or v.startswith("tc_") == bf16)
    for size in args.sizes.split(","):
        if len(size.split("x")) != 2 or not all(
                v.isdigit() for v in size.split("x")):
            ap.error(f"--sizes: expected NxD, got {size!r}")
    return args


def sources(args):
    """{library name: (text of npair_blockwise.cu, its header directory)}
    for the run: the named variants, and ``parent`` from ``--parent``."""
    from pathlib import Path

    out = {name: edited("npair_blockwise.cu", name)
           for name in args.variants.split(",")}
    if args.parent:
        csrc = Path(args.parent).resolve() / "npairloss_tpu_torch" / "csrc"
        if not (csrc / "npair_blockwise.cu").is_file():
            raise SystemExit(f"kernel_breakdown: no npair_blockwise.cu "
                             f"under {csrc}")
        out["parent"] = ((csrc / "npair_blockwise.cu").read_text(), csrc)
    return out


def cases(bw, f, lab, res, cfg, precision):
    """{case name: call} at one size: stats, hist and loss cached and
    recompute, and the cached gq/gdb; in the bf16 mode on ``round_bf16``
    rows, their bf16 copy handed to every kernel that multiplies rows,
    and the recompute gq/gdb too."""
    import torch

    from npairloss_tpu_torch.ops.rank_select import sortable_key

    n = f.shape[0]
    sims = res["sims"]
    thr = (res["pos_thr"], res["neg_thr"], res["max_all"])
    bf16 = precision == "default"
    fk = res["feats"] if bf16 else f
    kw = dict(matmul_precision="default", rows16=res["rows16"]) if bf16 \
        else {}
    gargs = (fk, lab, fk, lab, *thr, res["ident_sum"], res["all_sum"],
             torch.ones(n, device="cuda"), torch.ones((), device="cuda"),
             cfg)
    # Digit-1 prefixes of real pairs, both sides.
    hargs = (fk, lab, fk, lab, [True, False],
             [sortable_key(sims[:, 1]) >> 28] * 2, 1)
    out = {
        "stats_emit_ms": lambda: bw.npair_stats(
            fk, lab, fk, lab, hist_same=True, topk=8, emit_sims=True, **kw),
        "hist_cached_ms": lambda: bw.npair_hist(*hargs, sims=sims, **kw),
        "hist_recompute_ms": lambda: bw.npair_hist(*hargs, **kw),
        "loss_cached_ms": lambda: bw.npair_loss(fk, lab, fk, lab, *thr, cfg,
                                                sims=sims, **kw),
        "loss_recompute_ms": lambda: bw.npair_loss(fk, lab, fk, lab, *thr,
                                                   cfg, **kw)}
    for name, kern in (("gq", bw.npair_gq), ("gdb", bw.npair_gdb)):
        out[f"{name}_cached_ms"] = partial(kern, *gargs, sims=sims, **kw)
        if bf16:
            out[f"{name}_recompute_ms"] = partial(kern, *gargs, **kw)
    return out


def same_bits(torch, a, b) -> bool:
    """Whether two calls' outputs (tensors, or tuples of tensors and
    Nones) hold the same bits."""
    if isinstance(a, torch.Tensor):
        a, b = (a,), (b,)
    return all((x is None) == (y is None) and (
        x is None or torch.equal(x.view(torch.int32)
                                 if x.dtype == torch.float32 else x,
                                 y.view(torch.int32)
                                 if y.dtype == torch.float32 else y))
        for x, y in zip(a, b))


def bf16_gemm(torch, a16):
    """cuBLAS's bf16 ``a16 @ a16.T`` with fp32 output (``torch.mm(...,
    out_dtype=torch.float32)``), as a call."""
    return lambda: torch.mm(a16, a16.T, out_dtype=torch.float32)


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch

    from npairloss_tpu_torch.device import resolve_device
    from npairloss_tpu_torch.ops import _build
    from npairloss_tpu_torch.ops import blockwise_npair as bw
    from npairloss_tpu_torch.ops import npair_loss as nl

    if not torch.cuda.is_available():
        print("kernel_breakdown: no CUDA device is available")
        return 1
    resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    srcs = sources(args)
    t0 = time.perf_counter()
    libs = build("npair_blockwise.cu", srcs)
    if "parent" in srcs and _PARENT_SWEEP_CALL in srcs["parent"][0]:
        _sweeps_behind(libs["parent"])
    names = list(libs)
    print(f"[breakdown] {card}; built {len(libs)} libraries "
          f"({', '.join(names)}) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    flush = torch.empty(32 << 20, device="cuda").zero_  # 128 MB > 50 MB L2
    # Every case under every library in turn.
    turns = [partial(setattr, _build, "_lib", libs[name]) for name in names]
    for size in args.sizes.split(","):
        n, d = (int(v) for v in size.split("x"))
        gen = torch.Generator(device="cuda").manual_seed(args.seed + n)
        f = torch.randn((n, d), generator=gen, device="cuda")
        f = (f / f.norm(dim=1, keepdim=True)).contiguous()
        lab = (torch.randperm(n, generator=gen, device="cuda") // 2).to(
            torch.int32)
        cfg = nl.REFERENCE_CONFIG
        # Inputs from this tree's library.
        _build._lib = libs.get("full")
        mp = "default" if args.precision == "default" else None
        _, _, res = bw._forward(f, lab, cfg, 512, 512, True, 8, mp)
        rows16 = bw.round_bf16(f)[1]
        gemm = bf16_gemm(torch, rows16)
        row = {"card": card, "n": n, "d": d, "precision": args.precision,
               "cublas_ms": median_ms(torch, lambda: f @ f.T, flush),
               "cublas_bf16_ms": median_ms(torch, gemm, flush),
               "amax_cache_ms": median_ms(
                   torch, lambda: torch.amax(res["sims"], dim=1), flush),
               **{name: {} for name in names}}
        compare = "parent" in libs and "full" in libs
        if compare:
            row["same_bits"] = {}
        for case, fn in cases(bw, f, lab, res, cfg,
                              args.precision).items():
            for name, ms in zip(names, median_ms(torch, fn, flush,
                                                 setups=turns)):
                row[name][case] = ms
            if compare:
                outs = []
                for name in ("full", "parent"):
                    _build._lib = libs[name]
                    outs.append(fn())
                row["same_bits"][case] = same_bits(torch, *outs)
                del outs
        print(json.dumps(row), flush=True)
        del res
    _build._lib = None
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
