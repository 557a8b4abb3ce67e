"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Route: every ``csrc/*.cu`` compiles to an object with its own ``nvcc``
process, all started together, and one more ``nvcc -shared`` links
them into ONE shared library with a plain C interface.  Nothing here
includes PyTorch's headers, so a cold build takes seconds.  The library
lands in ``build/kernels/`` at the repository root, named by a hash of
the sources and flags, so an edited kernel never loads a stale build.

Nothing is compiled or loaded when this module is imported: the first
kernel launch calls :func:`library`, which builds on demand.  Every C
entry returns ``cudaGetLastError()`` after its launch and
:func:`check` raises on a nonzero code — a launch the driver refused
(too many threads, too much shared memory) never passes silently.

Each kernel wrapper carries a plain integer ``launches`` attribute,
incremented where it launches its kernel and nowhere else; a run reads
them with :func:`launch_counts` to show which kernels the path used.  A
wrapper that also carries ``bf16_launches`` (the blockwise sweeps, in
their bf16 mode) is read there as ``<name>:bf16`` too.  A wrapper's
Python runs once when a CUDA graph captures it and never when the graph
replays: the capturing code takes the counters' change across the
capture (:func:`counter_state`), takes it back out, and adds it once per
replay (:func:`add_counters`), so a counter still counts launches on the
card.  Every change to a counter goes through :func:`bump` (or
:func:`add_counters`) under one lock: replica dispatcher threads launch
the same kernels at once, and a bare ``+= 1`` from two threads can lose
a count.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    # Registers, shared memory and spills per kernel, kept in the log.
    "-Xptxas", "-v",
)

_VP = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

# C entry points: name -> argtypes (every pointer and the stream as
# c_void_p, so ctypes never truncates a 64-bit address).
_SIGNATURES = {
    "npl_lrn_fwd": [_VP, _VP, _LL, _I, _I, _F, _F, _F, _I, _VP],
    "npl_lrn_fwd_cached": [_VP, _VP, _VP, _LL, _I, _I, _F, _F, _F, _I, _VP],
    "npl_lrn_bwd": [_VP, _VP, _VP, _VP, _LL, _I, _I, _F, _F, _F, _F, _I,
                    _VP],
    "npl_bias_relu": [_VP, _VP, _VP, _LL, _I, _I, _VP],
    "npl_bias_relu_path": [_VP, _VP, _LL, _I, _I, ctypes.POINTER(_I)],
    "npl_bias_relu_pool": [_VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I,
                           _I, _I, _I, _I, _VP],
    "npl_ivf_probe": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                      _I, _I, _I, _I, _I, _I, _VP],
    # The blockwise entries end in feats16, pool16, ld16 (the bf16 mode's
    # rows; null in the fp32 mode), stream.
    # feats, labels, pool, pool_labels, n, m, d, self_offset, label_f32,
    # min_w, max_b, max_a, cnt_s, cnt_d, hist_s, hist_d, topk, k, sims,
    # feats16, pool16, ld16, stream
    "npl_npair_stats": [_VP] * 4 + [_I] * 5 + [_VP] * 8 + [_I, _VP]
                       + [_VP, _VP, _I, _VP],
    # ..., sims, n, m, d, self_offset, label_f32, sides, same0, same1,
    # prefix0, prefix1, digit, skip, out0, out1, feats16, pool16, ld16,
    # stream
    "npl_npair_hist": [_VP] * 5 + [_I] * 8 + [_VP, _VP, _I] + [_VP] * 3
                      + [_VP, _VP, _I, _VP],
    # ..., sims, n, m, d, self_offset, label_f32, ap, an, margin_ident,
    # margin_diff, pos_thr, neg_thr, max_all, isum, dsum, inum, dnum,
    # feats16, pool16, ld16, stream
    "npl_npair_loss": [_VP] * 5 + [_I] * 7 + [_F, _F] + [_VP] * 7
                      + [_VP, _VP, _I, _VP],
    # ..., margin_diff, pos_thr, neg_thr, max_all, isum, asum, valid, g,
    # pool_major, out, feats16, pool16, ld16, stream
    "npl_npair_grad": [_VP] * 5 + [_I] * 7 + [_F, _F] + [_VP] * 7
                      + [_I, _VP] + [_VP, _VP, _I, _VP],
    # src, dst, dst16, rows, d, ld16, stream
    "npl_round_bf16": [_VP, _VP, _VP, _LL, _I, _I, _VP],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# What the last build (or cache hit) did: path, seconds, nvcc output.
build_info: Dict[str, object] = {}

_counted: List[Callable] = []
_count_lock = threading.Lock()


def counted(fn: Callable) -> Callable:
    """Give a kernel wrapper its ``launches`` counter and register it."""
    fn.launches = 0
    _counted.append(fn)
    return fn


def launch_counts() -> Dict[str, int]:
    counts = {fn.__name__: fn.launches for fn in _counted}
    counts.update({f"{fn.__name__}:bf16": fn.bf16_launches
                   for fn in _counted if hasattr(fn, "bf16_launches")})
    return counts


def reset_launch_counts() -> None:
    with _count_lock:
        for fn in _counted:
            fn.launches = 0
            if hasattr(fn, "bf16_launches"):
                fn.bf16_launches = 0


def bump(fn: Callable, attr: str = "launches", n: int = 1) -> None:
    """Add ``n`` to one counter of a kernel wrapper (thread-safe)."""
    with _count_lock:
        setattr(fn, attr, getattr(fn, attr) + n)


# Every counter attribute a wrapper may carry.
_COUNTER_ATTRS = ("launches", "bf16_launches", "scalar_launches")


def counter_state() -> Dict[tuple, int]:
    """Every counter of every wrapper, keyed by (wrapper, attribute)."""
    return {(fn, a): getattr(fn, a) for fn in _counted
            for a in _COUNTER_ATTRS if hasattr(fn, a)}


def add_counters(delta: Dict[tuple, int], times: int = 1) -> None:
    """Add ``times`` x ``delta`` (a difference of two
    :func:`counter_state` readings) to the counters."""
    with _count_lock:
        for (fn, a), n in delta.items():
            setattr(fn, a, getattr(fn, a) + times * n)


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources() -> List[Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile and link the kernel library unless this exact build
    exists already; returns its path."""
    so = BUILD_DIR / f"libnpairloss_kernels-{_digest()}.so"
    if so.exists():
        build_info.update(path=str(so), seconds=0.0, cached=True)
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    log_lines: List[str] = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = os.path.join(tmp, src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, proc in procs:
            out, _ = proc.communicate()
            log_lines.append(f"== {src.name} (rc {proc.returncode})\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(
                f"nvcc failed on {failed}:\n" + "\n".join(log_lines))
        tmp_so = os.path.join(tmp, "lib.so")
        link = subprocess.run([nvcc, "-shared", "-o", tmp_so, *objs],
                              capture_output=True, text=True)
        log_lines.append(f"== link (rc {link.returncode})\n"
                         f"{link.stdout}{link.stderr}")
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(log_lines))
        os.replace(tmp_so, so)
    log = "\n".join(log_lines)
    so.with_suffix(".log").write_text(log)
    build_info.update(path=str(so), seconds=time.perf_counter() - t0,
                      cached=False, log=log)
    return so


def library() -> ctypes.CDLL:
    """The bound kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.npl_error_string.argtypes = [ctypes.c_int]
            lib.npl_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry."""
    if err != 0:
        msg = library().npl_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(device) -> int:
    """The current PyTorch stream on ``device`` as an integer handle."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
