"""Time the LRN backward and bias+ReLU+pool stem kernels at the GoogLeNet
path's shapes.

Run on a machine with one H100, from the repository root:

    python -m npairloss_tpu_torch.tools.stem_bench [--parent DIR] [--variants full,pool_cols1,...] [--flush write|read] [--iters 15]

Cases: ``lrn_bwd_cached`` and ``lrn_bwd`` at (120,56,56,C), C = 64 and
192 (the two LRN sites of a batch-120 training step), and the forward
kernel of ``fused_bias_relu_pool`` at (120,112,112,64) (training) and
(32,112,112,64) (one serving bucket), each in fp32 and bf16, beside the
bound (the bytes each call must move over 3.35 TB/s) and, for the pool,
``F.max_pool2d`` over a ``channels_last`` tensor of the same shape (the
same bytes read and written: a read-rate yardstick, not the same
function).

``csrc/stem.cu`` is built once per named variant of
``kernel_breakdown.VARIANTS["stem.cu"]`` (``full``: as it is; the others
change or take out one part by a text edit, so their outputs may be
wrong and only their time means anything), and with ``--parent DIR``
once more from ``DIR/npairloss_tpu_torch/csrc/stem.cu`` (a parent commit
unpacked with ``git archive``; its C interface must be this one's).
Every case is timed under every library in turn, in one process: the
median of ``--iters`` launches from CUDA events, the L2 flushed before
each by writing a 128 MB buffer (``--flush write``, as chip_smoke.py's
Timer) or by reading it (``--flush read``: no dirty lines left for the
timed kernel to evict).  The correctness checks of these kernels are
chip_smoke.py's phases 3 and 3b.  Prints one JSON line per case and a
last one with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None,
                    help="checkout whose csrc/stem.cu to time in turns")
    ap.add_argument("--variants", default="full",
                    help="comma-separated variants of csrc/stem.cu")
    ap.add_argument("--flush", choices=["write", "read"], default="write",
                    help="how the L2 is flushed before each launch")
    ap.add_argument("--iters", type=int, default=15)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("stem_bench: no CUDA device is available")
        return 1
    from npairloss_tpu_torch.device import resolve_device
    from npairloss_tpu_torch.ops import _build, stem
    from npairloss_tpu_torch.tools.kernel_breakdown import (build, edited,
                                                            median_ms)

    resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    sources = {name: edited("stem.cu", name)
               for name in args.variants.split(",")}
    if args.parent:
        csrc = Path(args.parent).resolve() / "npairloss_tpu_torch" / "csrc"
        sources["parent"] = ((csrc / "stem.cu").read_text(), csrc)
    libs = build("stem.cu", sources, others=False)
    buf = torch.zeros(32 << 20, dtype=torch.float32, device="cuda")
    sink = torch.empty((), dtype=torch.float32, device="cuda")
    flush = (buf.zero_ if args.flush == "write"
             else lambda: torch.amax(buf, out=sink))

    def use(lib):
        def setup():
            _build._lib = lib
        return setup

    def timed(fn) -> dict:
        meds = median_ms(torch, fn, flush, args.iters,
                         [use(lib) for lib in libs.values()])
        return {f"ms_{name}": t for name, t in zip(libs, meds)}

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    _build._lib = next(iter(libs.values()))  # for the inputs' set-up
    try:
        for dtype, tag in ((torch.float32, "fp32"),
                           (torch.bfloat16, "bf16")):
            size = 4 if tag == "fp32" else 2
            for c in (64, 192):
                shape = (120, 56, 56, c)
                x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
                g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
                _, d = stem.lrn_fwd_cached(x)
                n = x.numel()
                for name, fn, nbytes in (
                        ("lrn_bwd_cached",
                         lambda: stem.lrn_bwd_cached(x, g, d),
                         n * (3 * size + 4)),
                        ("lrn_bwd", lambda: stem.lrn_bwd(x, g),
                         n * 3 * size)):
                    row = {"kernel": name, "shape": list(shape),
                           "dtype": tag,
                           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                           **timed(fn)}
                    print(json.dumps(row), flush=True)
            for batch in (120, 32):
                shape = (batch, 112, 112, 64)
                x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
                b = torch.randn((64,), generator=gen, device="cuda") * 0.1
                out_n = batch * 56 * 56 * 64
                xcl = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory
                row = {"kernel": "bias_relu_pool", "shape": list(shape),
                       "dtype": tag,
                       "bound_ms": ((x.numel() + out_n) * size + 4 * 64)
                       / HBM_BYTES_PER_S * 1e3,
                       **timed(lambda: stem.fused_bias_relu_pool(x, b)),
                       "max_pool2d_yardstick_ms": median_ms(
                           torch, lambda: F.max_pool2d(xcl, 3, 2, padding=1),
                           flush, args.iters)}
                print(json.dumps(row), flush=True)
        torch.cuda.synchronize()
    finally:
        _build._lib = None
    print(json.dumps({"card": card, "flush": args.flush,
                      "libraries": list(libs)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
