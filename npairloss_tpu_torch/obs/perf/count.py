"""One training step's FLOPs, bytes and collective bytes, total and per
region — the port's counterpart of the JAX package's HLO cost model
(``npairloss_tpu/obs/perf/hlo.py`` and XLA's ``cost_analysis()``).

There is no compiled program to price, so the step is counted while it
runs: :class:`StepCounter` is a dispatch mode that sees every aten op
below autograd, on the CPU and on the card alike.

  * FLOPs of matmuls and convolutions, forward and backward, come from
    ``torch.utils.flop_counter``'s formulas (2MNK for a gemm); every
    other op counts zero FLOPs.
  * Bytes are each op's tensor inputs plus outputs (views and
    allocations move none).  Like XLA's estimate, an approximation of
    the memory traffic, not a measurement.
  * The hand-written kernels are called through ctypes and are
    invisible to a dispatch mode.  Each kernel wrapper declares its own
    FLOP and byte formula from its shapes (:func:`kernel`), and the ops
    inside it — its plain version on the CPU — are not counted, so one
    configuration counts the same on the CPU and on the card.
  * ``parallel.mesh``'s collectives declare their payload
    (:func:`collective`) as ``collective_bytes``.
  * With ``--remat`` the recompute is counted, as XLA counts it.

Regions are the module path that produced an op: the flax-style
``path`` a ``ConvBlock`` carries (``inception_3a/b1x1``), pushed by
forward hooks, and the explicit :func:`scope` s at the JAX package's
``named_scope`` sites (``npair``, ``lrn``, ``optim/update``,
``optim/apply``, ``health``).  A backward op counts in its forward
region: a region's output gradients enter it, its input gradients leave
it (``register_multi_grad_hook``, as ``torch.utils.module_tracker``
does).  Names fold to a depth with :func:`region_of`, a copy of the
JAX package's, on ``jit(step)/<scope>/<op>`` strings; the regions and
the ``(unscoped)`` remainder sum to the step's total exactly.

Counting must never run inside a CUDA-graph capture: the solver counts
the first eager step of a step key.  A counted step computes the same
bits as an uncounted one (the mode only forwards each op).
"""

from __future__ import annotations

import re
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# Region key for ops outside any scope or module path.
UNSCOPED = "(unscoped)"

# The counter of the step being counted (None: counting is off and every
# hook below is a no-op).
_ACTIVE: Optional["StepCounter"] = None

_aten = torch.ops.aten
# Allocations move no bytes.
_NO_BYTES = frozenset(getattr(_aten, n) for n in (
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "_local_scalar_dense"))


# -- op_name -> region (copied from npairloss_tpu/obs/perf/hlo.py) ------------

def _split_scopes(op_name: str) -> List[str]:
    """Split an op_name path on depth-0 slashes (scope names like
    ``npair/sim`` appear INSIDE ``jvp(...)`` wrappers, where the slash
    must not split the wrapper)."""
    parts, depth, cur = [], 0, []
    for c in op_name:
        if c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
        if c == "/" and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(c)
    if cur:
        parts.append("".join(cur))
    return parts


_WRAPPER_RE = re.compile(r"^(jit|jvp|vjp|transpose|vmap|pmap|remat|"
                         r"custom_jvp|custom_vjp|checkpoint)\((.*)\)$")


def _unwrap(segment: str) -> str:
    """Peel tracer wrappers: ``transpose(jvp(GoogLeNet))`` ->
    ``GoogLeNet``."""
    while True:
        m = _WRAPPER_RE.match(segment)
        if not m:
            return segment
        segment = m.group(2)


def region_of(op_name: str, depth: int = 2) -> str:
    """``jit(step)/jit(main)/jvp(npair/sim)/dot_general`` ->
    ``npair/sim``; the trailing primitive name drops, wrappers unwrap,
    ``jit(main)``/outer-jit segments and empty leftovers vanish, and
    the result truncates to ``depth`` path segments (0 = unlimited)."""
    raw = _split_scopes(op_name)
    if not raw:
        return UNSCOPED
    segs: List[str] = []
    structural = ("main", "while", "body", "cond", "branch")
    for seg in raw[:-1]:  # the last segment is the primitive name
        seg = _unwrap(seg)
        if not seg or seg in structural or seg.startswith("_"):
            continue
        segs.extend(s for s in seg.split("/") if s)
    # The outermost segment is the jitted function's own name.
    if len(segs) > 1:
        segs = segs[1:]
    elif segs and raw[0].startswith("jit("):
        segs = []
    if not segs:
        return UNSCOPED
    if depth and depth > 0:
        segs = segs[:depth]
    return "/".join(segs)


def scope_op_name(scope: Optional[str]) -> str:
    """The ``op_name`` string of an op counted in ``scope``, in the JAX
    form :func:`region_of` reads."""
    return f"jit(step)/{scope}/op" if scope else "jit(step)/op"


# -- the counter -------------------------------------------------------------

def _in_backward() -> bool:
    return torch._C._current_graph_task_id() != -1


def _nbytes(xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs
               if isinstance(x, torch.Tensor))


class _Mode(TorchDispatchMode):
    def __init__(self, counter: "StepCounter"):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        c = self.counter
        if not c._suppress:
            c._op(func, args, kwargs, out)
        return out


class StepCounter:
    """Count everything that runs inside ``with StepCounter() as c:``.

    ``c.flops``, ``c.bytes``, ``c.collective_bytes`` are the totals;
    ``c.scopes`` maps each scope (None: unscoped) to ``[flops, bytes,
    collective_bytes, ops]``; ``c.kernels`` maps each priced kernel and
    ``c.ops`` each counted aten op (``aten.convolution``, ...) to
    ``[calls, flops, bytes]``.  One counter at a time."""

    def __init__(self):
        from torch.utils.flop_counter import flop_registry

        self._flops = flop_registry
        self.scopes: Dict[Optional[str], List[int]] = {}
        self.kernels: Dict[str, List[int]] = {}
        self.ops: Dict[str, List[int]] = {}
        self._fw: List[str] = []
        self._bw: List[str] = []
        self._suppress = 0
        self._lock = threading.Lock()
        self._hooks: list = []
        self._mode = _Mode(self)

    # -- totals -------------------------------------------------------------

    def _total(self, i: int) -> int:
        return sum(v[i] for v in self.scopes.values())

    @property
    def flops(self) -> int:
        return self._total(0)

    @property
    def bytes(self) -> int:
        return self._total(1)

    @property
    def collective_bytes(self) -> int:
        return self._total(2)

    def regions(self, depth: int = 2) -> Dict[str, Dict[str, int]]:
        """Per-region ``{flops, bytes, collective_bytes, ops}`` with the
        scopes folded by :func:`region_of` to ``depth``."""
        out: Dict[str, Dict[str, int]] = {}
        for scope, (f, b, cb, n) in self.scopes.items():
            r = out.setdefault(region_of(scope_op_name(scope), depth),
                               {"flops": 0, "bytes": 0,
                                "collective_bytes": 0, "ops": 0})
            r["flops"] += f
            r["bytes"] += b
            r["collective_bytes"] += cb
            r["ops"] += n
        return out

    # -- attribution --------------------------------------------------------

    def current(self) -> Optional[str]:
        """The innermost active scope: the forward's, or in a backward
        the region whose gradients are being computed."""
        if self._fw:
            return self._fw[-1]
        if self._bw and _in_backward():
            return self._bw[-1]
        return None

    def _add(self, flops: int, nbytes: int, coll: int = 0,
             ops: int = 1) -> None:
        with self._lock:
            row = self.scopes.setdefault(self.current(), [0, 0, 0, 0])
            row[0] += int(flops)
            row[1] += int(nbytes)
            row[2] += int(coll)
            row[3] += ops

    def _op(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        fn = self._flops.get(packet)
        flops = fn(*args, **kwargs, out_val=out) if fn is not None else 0
        if getattr(func, "is_view", False) or packet in _NO_BYTES:
            nbytes = 0
        else:
            nbytes = (_nbytes(tree_flatten((args, kwargs))[0])
                      + _nbytes(tree_flatten(out)[0]))
        self._add(flops, nbytes)
        with self._lock:
            row = self.ops.setdefault(str(packet), [0, 0, 0])
            row[0] += 1
            row[1] += int(flops)
            row[2] += int(nbytes)

    def _kernel(self, name: str, flops: int, nbytes: int):
        k = self.kernels.setdefault(name, [0, 0, 0])
        k[0] += 1
        k[1] += int(flops)
        k[2] += int(nbytes)
        self._add(flops, nbytes)
        return _Suppressed(self)

    # -- regions ------------------------------------------------------------

    def _enter(self, name: str, inputs: Sequence) -> None:
        self._fw.append(name)
        leaves = [t for t in tree_flatten(list(inputs))[0]
                  if isinstance(t, torch.Tensor) and t.requires_grad]
        if leaves and torch.is_grad_enabled():
            # The backward leaves the region once its input grads exist.
            self._hooks.append(torch.autograd.graph.register_multi_grad_hook(
                leaves, lambda _g: self._bw_leave(name)))

    def _exit_outputs(self, name: str, outputs: Sequence) -> None:
        leaves = [t for t in tree_flatten(list(outputs))[0]
                  if isinstance(t, torch.Tensor) and t.requires_grad]
        if leaves and torch.is_grad_enabled():
            # The backward enters the region once its output grads exist.
            self._hooks.append(torch.autograd.graph.register_multi_grad_hook(
                leaves, lambda _g: self._bw.append(name)))

    def _bw_leave(self, name: str) -> None:
        for i in range(len(self._bw) - 1, -1, -1):
            if self._bw[i] == name:
                del self._bw[i]
                return

    def _pre_hook(self, mod, inputs) -> None:
        path = getattr(mod, "path", None)
        if isinstance(path, str) and path:
            self._enter(path, inputs)

    def _post_hook(self, mod, inputs, output) -> None:
        path = getattr(mod, "path", None)
        if isinstance(path, str) and path:
            self._fw.pop()
            self._exit_outputs(path, [output])

    # -- lifecycle ----------------------------------------------------------

    def __enter__(self) -> "StepCounter":
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("a step is already being counted")
        from torch.nn.modules.module import (
            register_module_forward_hook,
            register_module_forward_pre_hook,
        )

        _ACTIVE = self
        self._hooks += [register_module_forward_pre_hook(self._pre_hook),
                        register_module_forward_hook(self._post_hook)]
        self._mode.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        try:
            self._mode.__exit__(*exc)
        finally:
            for h in self._hooks:
                h.remove()
            self._hooks.clear()
            self._fw.clear()
            self._bw.clear()
            _ACTIVE = None


class _Suppressed:
    """Inside a priced kernel or a collective: its own ops are not
    counted (the formula stands for them)."""

    def __init__(self, counter: StepCounter):
        self.counter = counter

    def __enter__(self):
        self.counter._suppress += 1
        return self

    def __exit__(self, *exc):
        self.counter._suppress -= 1


class _Scope:
    def __init__(self, counter: StepCounter, name: str, inputs: Sequence):
        self.counter, self.name, self.inputs = counter, name, inputs

    def __enter__(self):
        self.counter._enter(self.name, self.inputs)
        return self

    def outputs(self, *tensors) -> None:
        """Declare the scope's differentiable outputs, so its backward
        counts in it."""
        self.counter._exit_outputs(self.name, tensors)

    def __exit__(self, *exc):
        self.counter._fw.pop()


class _Null:
    """The hooks' stand-in while nothing is counted."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def outputs(self, *tensors) -> None:
        return None


_NULL = _Null()


# -- the hooks the rest of the port calls ------------------------------------

def scope(name: str, inputs: Sequence = ()):
    """``with scope("npair", (emb,)) as s: ...; s.outputs(loss)`` — the
    ops inside count in region ``name``; with ``inputs`` and
    :meth:`_Scope.outputs` declared, its backward ops do too."""
    c = _ACTIVE
    return _NULL if c is None else _Scope(c, name, inputs)


def kernel(name: str, cost: Callable[[], Tuple[int, int]]):
    """Around a hand-written kernel's call (its plain version on the
    CPU): ``cost()`` gives its ``(flops, bytes)`` from its shapes; the
    ops inside are not counted."""
    c = _ACTIVE
    if c is None:
        return _NULL
    flops, nbytes = cost()
    return c._kernel(name, flops, nbytes)


def collective(nbytes: Callable[[], int]):
    """Around a collective of ``parallel.mesh``: ``nbytes()`` is the
    payload this rank receives; the ops inside are not counted."""
    c = _ACTIVE
    if c is None:
        return _NULL
    c._add(0, 0, coll=nbytes())
    return _Suppressed(c)


def priced(name: str, cost: Callable[..., Tuple[int, int]]):
    """Decorate a kernel wrapper: each call runs under :func:`kernel`
    with ``cost(*args, **kwargs)`` as its ``(flops, bytes)``.  The
    wrapper keeps its name (``functools.wraps``), so ``counted``'s
    launch counters and their keys are unchanged."""
    import functools

    def deco(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if _ACTIVE is None:
                return fn(*args, **kwargs)
            with kernel(name, lambda: cost(*args, **kwargs)):
                return fn(*args, **kwargs)
        return run
    return deco
