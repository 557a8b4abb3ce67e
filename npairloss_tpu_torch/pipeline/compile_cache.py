"""Persistent build cache for the port's compiled programs — compile
once per program, ever (port of
``npairloss_tpu/pipeline/compile_cache.py``).

The port's compiled programs are the nvcc-built kernel library
(``ops/_build.py``) and the native data runtime (``data/native.py``),
both named by a hash of their sources and flags.  By default they land
in ``build/kernels/`` and ``build/native_torch/`` of the checkout.
:func:`enable_compile_cache` (``--compile-cache DIR`` /
``SolverConfig.compile_cache``) points both at ``DIR/kernels`` and
``DIR/native``, so a sibling process — another checkout, a relaunch
from a clean tree — loads the library another process built instead of
running nvcc again.  It takes effect for libraries not yet loaded in
this process.

The cache is an optimization, never a requirement: a directory that
cannot be created or written is logged and ignored, and the builds keep
their defaults.
"""

from __future__ import annotations

import logging
import os
import tempfile
from pathlib import Path
from typing import Optional

log = logging.getLogger("npairloss_tpu_torch.pipeline")

_ENABLED_DIR: Optional[str] = None
_DEFAULTS: dict = {}


def _targets():
    from npairloss_tpu_torch.data import native
    from npairloss_tpu_torch.ops import _build

    return ((_build, "kernels"), (native, "native"))


def compile_cache_dir() -> Optional[str]:
    """The directory the cache was enabled at in this process, or None."""
    return _ENABLED_DIR


def enable_compile_cache(cache_dir: str) -> Optional[str]:
    """Point the kernel library's and the native runtime's build
    directories under ``cache_dir``.  Process-global and idempotent;
    returns the absolute path on success, None when the directory
    cannot be used."""
    global _ENABLED_DIR
    path = os.path.abspath(cache_dir)
    if _ENABLED_DIR == path:
        return path
    try:
        for _, sub in _targets():
            d = os.path.join(path, sub)
            os.makedirs(d, exist_ok=True)
            # Writable, or a build would fail later, mid-run.
            with tempfile.TemporaryFile(dir=d):
                pass
    except Exception as e:  # the cache is an optimization, never required
        log.warning("compile cache unavailable at %s: %s", cache_dir, e)
        return None
    for mod, sub in _targets():
        _DEFAULTS.setdefault(mod.__name__, mod.BUILD_DIR)
        mod.BUILD_DIR = Path(path) / sub
    _ENABLED_DIR = path
    log.info("compile cache: %s", path)
    return path


def disable_compile_cache() -> None:
    """Restore the default build directories (tests / embedders)."""
    global _ENABLED_DIR
    for mod, _ in _targets():
        if mod.__name__ in _DEFAULTS:
            mod.BUILD_DIR = _DEFAULTS[mod.__name__]
    _ENABLED_DIR = None
