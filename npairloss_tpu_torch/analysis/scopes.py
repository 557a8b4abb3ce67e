"""Pass ``scopes`` — every collective call site carries a comm count.

The port of ``npairloss_tpu/analysis/scopes.py``.  The fleet
observatory's comms reconciliation (``fleet_comms.json``,
``prof --fleet``) prices each exchange by the ``comm/<kind>`` claim
its ``obs.perf.count.collective(nbytes, op=...)`` block makes; a
``torch.distributed`` call outside such a block moves bytes nobody
counts, and a kind that carries an analytic claim can absorb them
without any runtime gate noticing.  This pass is the static twin of
JAX's ``jax.named_scope("comm/<kind>")`` rule: every
``torch.distributed`` collective that moves a payload must be
*lexically* enclosed in a ``with count.collective(...)`` block, so an
uncounted new exchange path fails on a CPU box in milliseconds.

``dist.barrier`` moves no payload and is left out, as JAX leaves out
``axis_index``.  Escape hatch: a ``# comm-scope-ok: <reason>`` comment
on the call line tolerates a site the rule genuinely cannot serve
(document why).

Stdlib-only and self-contained: the suite runs, and loads by file
path, in a process without torch (docs/STATICCHECK.md).
"""

from __future__ import annotations

import ast
from typing import List, Set

from npairloss_tpu_torch.analysis.findings import Finding
from npairloss_tpu_torch.analysis.tree import PACKAGE, SourceTree, dotted_name

PASS_NAME = "scopes"

# The torch.distributed calls that move bytes between ranks.
COLLECTIVES = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "reduce_scatter", "reduce_scatter_tensor", "broadcast",
    "all_to_all", "all_to_all_single", "batch_isend_irecv",
    "isend", "irecv", "send", "recv",
})

ANNOTATION = "comm-scope-ok"

# ``obs.perf.count.collective`` — the port's comm/<kind> claim.
_SCOPE_FN = "collective"
_DIST = "torch.distributed"


def _dist_aliases(mod: ast.Module) -> Set[str]:
    """Names the module binds to ``torch.distributed``: ``import
    torch.distributed as dist``, ``from torch import distributed``, and
    the dotted name itself."""
    out: Set[str] = {_DIST}
    for node in ast.walk(mod):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == _DIST:
                    out.add(alias.asname or _DIST)
        elif isinstance(node, ast.ImportFrom) and node.module == "torch":
            for alias in node.names:
                if alias.name == "distributed":
                    out.add(alias.asname or "distributed")
    return out


def _bare_imports(mod: ast.Module) -> Set[str]:
    """Names bound by ``from torch.distributed import all_reduce, ...``
    — bare-name collective calls."""
    out: Set[str] = set()
    for node in ast.walk(mod):
        if isinstance(node, ast.ImportFrom) and node.module == _DIST:
            for alias in node.names:
                if alias.name in COLLECTIVES:
                    out.add(alias.asname or alias.name)
    return out


def _collective_name(node: ast.Call, aliases: Set[str],
                     bare: Set[str]) -> str:
    """The collective's name when ``node`` calls one, else ''."""
    fn = node.func
    if isinstance(fn, ast.Attribute) and fn.attr in COLLECTIVES:
        base = dotted_name(fn.value)
        if base is not None and base in aliases:
            return fn.attr
    if isinstance(fn, ast.Name) and fn.id in bare:
        return fn.id
    return ""


def _opens_comm_scope(item: ast.withitem) -> bool:
    ctx = item.context_expr
    if not isinstance(ctx, ast.Call):
        return False
    fn = ctx.func
    name = fn.attr if isinstance(fn, ast.Attribute) else (
        fn.id if isinstance(fn, ast.Name) else None)
    return name == _SCOPE_FN


def run(tree: SourceTree) -> List[Finding]:
    findings: List[Finding] = []
    for rel in tree.py_files(subdirs=(PACKAGE,)):
        mod = tree.parse(rel)
        if mod is None:
            continue
        aliases = _dist_aliases(mod)
        bare = _bare_imports(mod)
        comments = tree.comments(rel)

        def visit(node: ast.AST, in_comm: bool, rel=rel, aliases=aliases,
                  bare=bare, comments=comments) -> None:
            if isinstance(node, ast.With):
                entered = in_comm or any(
                    _opens_comm_scope(i) for i in node.items)
                for item in node.items:
                    visit(item, in_comm)
                for child in node.body:
                    visit(child, entered)
                return
            if isinstance(node, ast.Call):
                name = _collective_name(node, aliases, bare)
                if name and not in_comm:
                    note = comments.get(node.lineno, "")
                    if not note.startswith(ANNOTATION):
                        findings.append(Finding(
                            PASS_NAME, rel, node.lineno, name,
                            f"torch.distributed.{name} call not "
                            "lexically enclosed in a "
                            "'with count.collective(...)' block — its "
                            "bytes would be unattributed (or silently "
                            "absorbed by an analytic claim) in the fleet "
                            "comms reconciliation; wrap the exchange or "
                            f"annotate '# {ANNOTATION}: <reason>'"))
            for child in ast.iter_child_nodes(node):
                visit(child, in_comm)

        visit(mod, False)
    return findings
