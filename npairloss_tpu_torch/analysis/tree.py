"""Source-tree access shared by every staticcheck pass.

One parse per file per run: ``SourceTree`` caches AST parses, raw
text, and per-line comment maps (tokenize-based, so a ``#`` inside a
string never reads as a comment).  The tree is rooted anywhere — the
real repo, or a seeded tree a test writes — and passes degrade
gracefully when a root is partial (a fixture tree
carries only the files its violation needs).

Stdlib-only and self-contained: the suite runs, and loads by file
path, in a process without torch (docs/STATICCHECK.md).
"""

from __future__ import annotations

import ast
import io
import os
import tokenize
from typing import Dict, List, Optional, Sequence, Tuple

# Directory names never descended into.  "fixtures" keeps the seeded
# violation trees under tests/fixtures/staticcheck from failing the
# real repo's own gate (each fixture is scanned as its OWN root).
SKIP_DIRS = {"__pycache__", ".git", "fixtures", "node_modules", ".claude"}

# The package the suite checks: the PyTorch port (the JAX package beside
# it has its own suite, ``npairloss_tpu/analysis``).  Tests are scanned
# only by the marker pass (its own root list).
PACKAGE = "npairloss_tpu_torch"
CODE_DIRS = (PACKAGE,)


class SourceTree:
    """A rooted view of the files the passes read."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self._ast: Dict[str, Optional[ast.Module]] = {}
        self._text: Dict[str, Optional[str]] = {}
        self._comments: Dict[str, Dict[int, str]] = {}
        self.parse_errors: List[Tuple[str, str]] = []
        # Files read since the last ``begin_pass()`` — cache hits
        # included, so a pass's files_scanned reports what it actually
        # LOOKED AT, not what it happened to parse first.
        self.touched: set = set()

    def begin_pass(self) -> None:
        self.touched = set()

    # -- discovery ---------------------------------------------------------

    def _walk(self, subdir: str, suffix: str) -> List[str]:
        base = os.path.join(self.root, subdir)
        out: List[str] = []
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = sorted(
                d for d in dirnames if d not in SKIP_DIRS)
            for name in sorted(filenames):
                if name.endswith(suffix):
                    rel = os.path.relpath(
                        os.path.join(dirpath, name), self.root)
                    out.append(rel.replace(os.sep, "/"))
        return out

    def py_files(self, subdirs: Sequence[str] = CODE_DIRS) -> List[str]:
        """Root-relative .py paths under ``subdirs``, sorted."""
        out: List[str] = []
        for sub in subdirs:
            out.extend(self._walk(sub, ".py"))
        return out

    def md_files(self, subdirs: Sequence[str] = ("docs", "")) -> List[str]:
        """Root-relative .md paths: docs/ recursively plus the root's
        own *.md (README.md and friends); "" means the root itself,
        non-recursive."""
        out: List[str] = []
        for sub in subdirs:
            if sub:
                out.extend(self._walk(sub, ".md"))
            else:
                try:
                    names = sorted(os.listdir(self.root))
                except OSError:
                    continue
                out.extend(n for n in names if n.endswith(".md")
                           and os.path.isfile(self.abspath(n)))
        return out

    # -- access ------------------------------------------------------------

    def abspath(self, rel: str) -> str:
        return os.path.join(self.root, rel.replace("/", os.sep))

    def exists(self, rel: str) -> bool:
        return os.path.isfile(self.abspath(rel))

    def text(self, rel: str) -> Optional[str]:
        self.touched.add(rel)
        if rel not in self._text:
            try:
                with open(self.abspath(rel), encoding="utf-8") as f:
                    self._text[rel] = f.read()
            except (OSError, UnicodeDecodeError):
                self._text[rel] = None
        return self._text[rel]

    def parse(self, rel: str) -> Optional[ast.Module]:
        """The file's AST, or None (recorded in ``parse_errors``) when
        it does not parse — a syntax error is reported once by the
        runner, not once per pass."""
        self.touched.add(rel)
        if rel not in self._ast:
            text = self.text(rel)
            if text is None:
                self._ast[rel] = None
                self.parse_errors.append((rel, "unreadable"))
            else:
                try:
                    self._ast[rel] = ast.parse(text, filename=rel)
                except SyntaxError as e:
                    self._ast[rel] = None
                    self.parse_errors.append((rel, f"syntax error: {e}"))
        return self._ast[rel]

    def comments(self, rel: str) -> Dict[int, str]:
        """{line -> comment text (without '#')} via tokenize; empty on
        unreadable/untokenizable files."""
        self.touched.add(rel)
        if rel not in self._comments:
            out: Dict[int, str] = {}
            text = self.text(rel)
            if text is not None:
                try:
                    for tok in tokenize.generate_tokens(
                            io.StringIO(text).readline):
                        if tok.type == tokenize.COMMENT:
                            out[tok.start[0]] = tok.string.lstrip("#").strip()
                except (tokenize.TokenError, IndentationError,
                        SyntaxError):
                    pass
            self._comments[rel] = out
        return self._comments[rel]


# -- small AST helpers shared by passes ---------------------------------------


def const_str(node: ast.AST) -> Optional[str]:
    """The literal string of a Constant node, else None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def str_tuple(node: ast.AST) -> Optional[Tuple[str, ...]]:
    """A tuple/list literal of string constants, else None."""
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for elt in node.elts:
            s = const_str(elt)
            if s is None:
                return None
            out.append(s)
        return tuple(out)
    return None


def dotted_name(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def module_level_constants(tree: ast.Module) -> Dict[str, ast.AST]:
    """{NAME -> value node} for simple module-level ``NAME = <expr>``
    assignments (including inside top-level try/if bodies)."""
    out: Dict[str, ast.AST] = {}

    def visit(stmts):
        for stmt in stmts:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                out[stmt.targets[0].id] = stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None \
                    and isinstance(stmt.target, ast.Name):
                out[stmt.target.id] = stmt.value
            elif isinstance(stmt, ast.If):
                visit(stmt.body)
                visit(stmt.orelse)
            elif isinstance(stmt, ast.Try):
                visit(stmt.body)
                for h in stmt.handlers:
                    visit(h.body)
                visit(stmt.orelse)
                visit(stmt.finalbody)

    visit(tree.body)
    return out
