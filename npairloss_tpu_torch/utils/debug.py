"""Numerical debug guards — port of ``npairloss_tpu/utils/debug.py``.

The reference's div/log zero-guards (npair_multi_class_loss.cu:162-169,
cu:412-417) have no runtime checks at all.  This module provides:

  * ``assert_all_finite(tree)`` — a host-side assertion for step
    outputs, cheap for scalars/metrics;
  * ``checked(fn)`` — ``fn`` with every floating-point output checked
    on the host (see its docstring for what it cannot catch);
  * a process-wide debug flag the Solver consults to validate each
    step's loss/metrics without callers threading a flag through
    (``NPAIRLOSS_DEBUG_CHECKS=1`` sets it from the environment,
    ``train --debug-checks`` and :func:`enable_debug_checks` override
    it).
"""

from __future__ import annotations

import functools
import os
from typing import Any, Iterator, Tuple

import numpy as np
import torch

_debug_checks = os.environ.get(
    "NPAIRLOSS_DEBUG_CHECKS", ""
).lower() in ("1", "true", "yes", "on")


def enable_debug_checks(enabled: bool = True) -> None:
    """Process-wide switch: when on, the Solver asserts every step's
    loss/metric scalars are finite (raising with the offending name)."""
    global _debug_checks
    _debug_checks = bool(enabled)


def debug_checks_enabled() -> bool:
    return _debug_checks


def _leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """``(keystr, leaf)`` in ``jax.tree_util.tree_leaves_with_path``'s
    order and spelling: dict keys sorted (``['loss']``), sequence items
    by index (``[0]``)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def _host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(leaf)


def assert_all_finite(tree: Any, name: str = "value") -> None:
    """Host-side: raise ``FloatingPointError`` naming the first
    non-finite leaf, with the JAX package's message.  Reads every leaf
    on the host (a sync on the card) — use on scalars/metrics, not
    parameters."""
    for path, leaf in _leaves(tree):
        arr = _host(leaf)
        if arr.dtype.kind in "fc" and not np.isfinite(arr).all():
            raise FloatingPointError(
                f"non-finite {name}{path}: "
                f"{arr if arr.size <= 8 else 'array with NaN/Inf'}"
            )


def checked(fn):
    """``fn`` with every floating-point output checked on the host:
    a NaN/Inf in any tensor or number it returns raises
    ``FloatingPointError`` naming the output (``assert_all_finite``).

    The JAX package's ``checked`` is a ``checkify`` wrapper that
    instruments every op inside the compiled function and reports the
    op and source line that first produced a NaN/Inf or divided by
    zero.  This one checks outputs only: it cannot name the op, it
    misses a non-finite value that an op inside masks before the output
    (a ``where``, a ``max``), it does not check integer division or
    out-of-bounds indexing, and each call reads its outputs on the host
    (a sync on the card)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        assert_all_finite(out, f"{getattr(fn, '__name__', 'fn')} output")
        return out

    return wrapper
