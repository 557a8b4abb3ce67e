"""Pass ``locks`` — ``# guarded-by:`` discipline on shared mutable state.

The threaded registries (MetricRegistry fed by request threads,
SLOEvaluator ticked by the observatory while /healthz scrapes read,
RemediationEngine, RetrievalServer's hot-swap state) rely on every
mutation happening under one lock — a discipline previously enforced
only by review and by the races that slipped past it (the PR-10
read-only /healthz evaluate fix was exactly such a slip).

Convention (docs/STATICCHECK.md §Annotations):

  * declare: ``self.attr = ...  # guarded-by: _lock`` — usually in
    ``__init__``; the lock is named by its own attribute name;
  * the checker flags any mutation of a declared attribute (assign,
    augassign, del, subscript-store, or a mutating method call like
    ``.append``/``.update``) in any method that is not lexically
    inside ``with self._lock:``;
  * ``__init__``/``__new__``/``__post_init__`` are exempt
    (construction happens-before sharing);
  * a method whose ``def`` line carries ``# holds-lock: _lock``
    declares its callers hold the lock (checked as if enclosed);
  * one mutation line may carry ``# unguarded-ok: <reason>`` for a
    documented deliberate exception;
  * a nested function body does NOT inherit the enclosing ``with`` —
    it runs when called, not where defined (callbacks escape locks).

Stdlib-only and self-contained: the suite runs, and loads by file
path, in a process without torch (docs/STATICCHECK.md).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Set

from npairloss_tpu_torch.analysis.findings import Finding
from npairloss_tpu_torch.analysis.tree import PACKAGE, SourceTree

PASS_NAME = "locks"

GUARDED_RE = re.compile(r"guarded-by:\s*([A-Za-z_][A-Za-z_0-9]*)")
HOLDS_RE = re.compile(r"holds-lock:\s*([A-Za-z_][A-Za-z_0-9]*)")
UNGUARDED_OK = "unguarded-ok"

EXEMPT_METHODS = {"__init__", "__new__", "__post_init__", "__del__"}

MUTATING_METHODS = frozenset({
    "append", "extend", "insert", "add", "update", "pop", "popitem",
    "clear", "remove", "discard", "setdefault", "appendleft",
    "extendleft", "sort", "reverse",
})


def _self_attr(node: ast.AST) -> str:
    """'attr' for a ``self.attr`` Attribute node, else ''."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return ""


def _self_attr_base(node: ast.AST) -> str:
    """The self-attribute at the base of a Subscript/Attribute chain:
    ``self._last[p][k]`` -> '_last' (``self.x.y`` deliberately not —
    the owned object's own attribute is its own class's discipline)."""
    while isinstance(node, ast.Subscript):
        node = node.value
    return _self_attr(node)


def _mutated_attrs(stmt: ast.AST) -> List[str]:
    """Declared-attr mutation targets of one statement node.  Mutating
    METHOD calls (``self._d.pop(...)``) are handled separately in the
    walker — they mutate in any expression context, not only as bare
    statements."""
    out: List[str] = []

    def target_attrs(t: ast.AST):
        if isinstance(t, (ast.Tuple, ast.List)):
            for elt in t.elts:
                target_attrs(elt)
            return
        a = _self_attr(t) or _self_attr_base(t)
        if a:
            out.append(a)

    if isinstance(stmt, ast.Assign):
        for t in stmt.targets:
            target_attrs(t)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        target_attrs(stmt.target)
    elif isinstance(stmt, ast.Delete):
        for t in stmt.targets:
            target_attrs(t)
    return out


def _mutating_call_attr(node: ast.AST) -> str:
    """The self-attribute a Call node mutates (``self._d.pop(k)`` in
    ANY expression context — ``x = self._d.pop(k)`` counts exactly
    like the bare-statement form), else ''."""
    if isinstance(node, ast.Call):
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr in MUTATING_METHODS:
            return _self_attr_base(fn.value)
    return ""


def _with_locks(node: ast.With) -> Set[str]:
    """Lock attribute names this ``with`` acquires (``self.X`` items)."""
    out: Set[str] = set()
    for item in node.items:
        a = _self_attr(item.context_expr)
        if a:
            out.add(a)
    return out


def guarded_attrs(cls: ast.ClassDef, comments: Dict[int, str]
                  ) -> Dict[str, str]:
    """{attr -> lock} declared via ``# guarded-by:`` in this class —
    the registration half, exposed so tests can pin that a real
    annotation actually arms the checker."""
    guarded: Dict[str, str] = {}
    for node in ast.walk(cls):
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            # The annotation may trail any line the (possibly
            # backslash-continued) assignment spans.
            note = "".join(
                comments.get(ln, "")
                for ln in range(node.lineno,
                                (node.end_lineno or node.lineno) + 1))
            m = GUARDED_RE.search(note)
            if m:
                for attr in _mutated_attrs(node):
                    guarded[attr] = m.group(1)
    return guarded


def _check_class(rel: str, cls: ast.ClassDef, comments: Dict[int, str],
                 findings: List[Finding]) -> None:
    guarded = guarded_attrs(cls, comments)
    if not guarded:
        return
    assigned_attrs: Set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            assigned_attrs.update(_mutated_attrs(node))
    for attr, lock in sorted(guarded.items()):
        if lock not in assigned_attrs:
            findings.append(Finding(
                PASS_NAME, rel, cls.lineno, f"{cls.name}.{attr}",
                f"{cls.name}.{attr} is '# guarded-by: {lock}' but no "
                f"'self.{lock}' is ever assigned in the class — the "
                "named lock does not exist"))

    def visit(node: ast.AST, held: Set[str], method: str) -> None:
        if isinstance(node, ast.With):
            inner = held | _with_locks(node)
            for item in node.items:
                visit(item, held, method)
            for child in node.body:
                visit(child, inner, method)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            # A nested function runs when CALLED — it escapes the
            # enclosing with unless its def line declares holds-lock.
            inner: Set[str] = set()
            m = HOLDS_RE.search(comments.get(node.lineno, ""))
            if m:
                inner.add(m.group(1))
            body = node.body if isinstance(node.body, list) else [node.body]
            for child in body:
                visit(child, inner, method)
            return
        mutated = _mutated_attrs(node)
        call_attr = _mutating_call_attr(node)
        if call_attr:
            mutated.append(call_attr)
        for attr in mutated:
            lock = guarded.get(attr)
            if lock and lock not in held:
                # The annotation may trail any line the mutation
                # spans, or sit directly above it (long lines).
                note = comments.get(node.lineno - 1, "") + "".join(
                    comments.get(ln, "")
                    for ln in range(
                        node.lineno,
                        (getattr(node, "end_lineno", None)
                         or node.lineno) + 1))
                if UNGUARDED_OK not in note:
                    findings.append(Finding(
                        PASS_NAME, rel, node.lineno,
                        f"{cls.name}.{method}.{attr}",
                        f"{cls.name}.{method} mutates self.{attr} "
                        f"(guarded-by: {lock}) outside 'with "
                        f"self.{lock}:' — annotate the def with "
                        f"'# holds-lock: {lock}' if callers hold it, "
                        f"or '# {UNGUARDED_OK}: <reason>' on the line"))
        for child in ast.iter_child_nodes(node):
            visit(child, held, method)

    for stmt in cls.body:
        if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if stmt.name in EXEMPT_METHODS:
            continue
        held: Set[str] = set()
        m = HOLDS_RE.search(comments.get(stmt.lineno, ""))
        if m:
            held.add(m.group(1))
        for child in stmt.body:
            visit(child, held, stmt.name)


def run(tree: SourceTree) -> List[Finding]:
    findings: List[Finding] = []
    for rel in tree.py_files(subdirs=(PACKAGE,)):
        mod = tree.parse(rel)
        if mod is None:
            continue
        comments = tree.comments(rel)
        for node in ast.walk(mod):
            if isinstance(node, ast.ClassDef):
                _check_class(rel, node, comments, findings)
    return findings
