"""Pass ``purity`` — transitive proof that the port's contract modules
import no torch.

A handful of the port's modules are stdlib copies of JAX's contract
modules (validators, the WAL, the gameday's traffic, schedule and
verdict): their contract is that executing them imports NO heavy
dependency — not torch, not numpy, not directly, not transitively — so
a process without the accelerator stack can load them by file path.
This pass proves it at lint time by walking the module-level import
graph.

Semantics mirror the file-path-load mechanics (``sys.modules``
pre-seeding): an intra-repo import edge goes to the named module FILE,
never through parent-package ``__init__``s, and only *module-level*
imports count — an import inside a function body is lazy by
construction and deliberately tolerated (the ``aggregate.percentile``
pattern).  ``if TYPE_CHECKING:`` blocks never execute and are skipped.

The declared contract list is the allowlist: a file-path-load call
site (``spec_from_file_location("npairloss_tpu_torch....")``) naming a
module NOT declared here is itself a finding — a new contract module
must opt in loudly, in this table, where the purity proof will cover
it.

Stdlib-only and self-contained (the very contract it checks).
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterator, List, Optional, Set, Tuple

from npairloss_tpu_torch.analysis.findings import Finding
from npairloss_tpu_torch.analysis.tree import PACKAGE, SourceTree, const_str

PASS_NAME = "purity"

# Top-level import names that end the proof (JAX's set, which already
# holds torch).  numpy is heavy here: the contract modules are
# *stdlib-only* (their docstrings say so), and a gate that can hang on
# BLAS thread-pool init is a gate that can hang.
HEAVY_DEPS = frozenset({
    "jax", "jaxlib", "flax", "numpy", "scipy", "optax", "orbax",
    "tensorflow", "torch", "pandas", "ml_dtypes", "etils", "chex",
})

# The declared contract modules: root-relative path -> why it must stay
# free of torch.  Adding a file-path-load site for a module absent from this
# table is a finding (opt in HERE, loudly).
CONTRACT_MODULES: Dict[str, str] = {
    "npairloss_tpu_torch/obs/sinks.py":
        "the run directory's record sinks; the stdlib copies of JAX's "
        "fleet keys ride it",
    "npairloss_tpu_torch/obs/fleet/stamp.py":
        "the fleet stamp's keys, the twin of obs/sinks.py FLEET_KEYS",
    "npairloss_tpu_torch/obs/fleet/aggregate.py":
        "the npairloss-fleet-report-v1 validator; the gameday's "
        "reconcile reads the trainer's fleet report through it",
    "npairloss_tpu_torch/obs/live/alerts.py":
        "the npairloss-alerts-v1 validator, loaded by file path",
    "npairloss_tpu_torch/obs/quality/report.py":
        "the npairloss-quality-v1 validator, loaded by file path",
    "npairloss_tpu_torch/obs/qtrace/report.py":
        "the npairloss-qtrace-v1 validator, loaded by file path",
    "npairloss_tpu_torch/resilience/remediate.py":
        "the npairloss-remediation-v1 validator and policies, loaded by "
        "file path",
    "npairloss_tpu_torch/resilience/wal.py":
        "the npairloss-wal-v1 log, read by file path to audit a WAL "
        "directory",
    "npairloss_tpu_torch/resilience/failpoints.py":
        "wal.py's fault-injection seam; rides along in its loader chain",
    "npairloss_tpu_torch/resilience/retrying.py":
        "wal.py's replay/segment-open retry policies; rides along in "
        "its loader chain",
    "npairloss_tpu_torch/gameday/traffic.py":
        "the gameday's plan and digest, recomputed without the serving "
        "stack",
    "npairloss_tpu_torch/gameday/schedule.py":
        "the gameday's chaos schedules, loaded without the package",
    "npairloss_tpu_torch/gameday/verdict.py":
        "the npairloss-gameday-v1 validator, loaded by file path",
    "npairloss_tpu_torch/serve/tenants.py":
        "the npairloss-tenants-v1 manifest validator, read without the "
        "serving stack",
}

# The analysis suite itself is contract code (``staticcheck`` runs it
# without torch); every analysis/*.py is implicitly declared.
ANALYSIS_DIR = PACKAGE + "/analysis"

_DOTTED_RE = re.compile(r"^npairloss_tpu_torch(\.[A-Za-z_][A-Za-z_0-9]*)+$")


def _is_type_checking_if(node: ast.If) -> bool:
    t = node.test
    if isinstance(t, ast.Name) and t.id == "TYPE_CHECKING":
        return True
    return (isinstance(t, ast.Attribute) and t.attr == "TYPE_CHECKING")


def _module_level_imports(tree: ast.Module) -> Iterator[ast.stmt]:
    """Import statements that execute at import time: module body,
    top-level try/if bodies (minus TYPE_CHECKING), and class bodies."""

    def visit(stmts) -> Iterator[ast.stmt]:
        for stmt in stmts:
            if isinstance(stmt, (ast.Import, ast.ImportFrom)):
                yield stmt
            elif isinstance(stmt, ast.If):
                if _is_type_checking_if(stmt):
                    yield from visit(stmt.orelse)
                else:
                    yield from visit(stmt.body)
                    yield from visit(stmt.orelse)
            elif isinstance(stmt, ast.Try):
                yield from visit(stmt.body)
                for h in stmt.handlers:
                    yield from visit(h.body)
                yield from visit(stmt.orelse)
                yield from visit(stmt.finalbody)
            elif isinstance(stmt, ast.ClassDef):
                yield from visit(stmt.body)

    yield from visit(tree.body)


def _rel_module_path(tree: SourceTree, dotted: str) -> Optional[str]:
    """Root-relative file for an intra-repo dotted module name."""
    base = dotted.replace(".", "/")
    for cand in (base + ".py", base + "/__init__.py"):
        if tree.exists(cand):
            return cand
    return None


def _package_of(rel: str) -> str:
    """Dotted package containing the module at ``rel``."""
    parts = rel.rsplit("/", 1)[0].split("/")
    return ".".join(parts)


def _edges(tree: SourceTree, rel: str) -> Iterator[Tuple[str, int, object]]:
    """(top_level_name_or_None, line, resolved_rel_or_None) per
    module-level import edge of ``rel``."""
    mod = tree.parse(rel)
    if mod is None:
        return
    for stmt in _module_level_imports(mod):
        if isinstance(stmt, ast.Import):
            for alias in stmt.names:
                name = alias.name
                resolved = _rel_module_path(tree, name) \
                    if name.split(".")[0] == PACKAGE else None
                yield name.split(".")[0], stmt.lineno, resolved
        else:  # ImportFrom
            if stmt.level:  # relative import
                pkg_parts = _package_of(rel).split(".")
                if stmt.level > len(pkg_parts):
                    continue
                base = pkg_parts[:len(pkg_parts) - (stmt.level - 1)]
                name = ".".join(base + ([stmt.module]
                                        if stmt.module else []))
            else:
                name = stmt.module or ""
            top = name.split(".")[0] if name else None
            if top != PACKAGE:
                if top:
                    yield top, stmt.lineno, None
                continue
            # from A.B import C: C may itself be a submodule
            for alias in stmt.names:
                sub = _rel_module_path(tree, f"{name}.{alias.name}")
                if sub is not None:
                    yield top, stmt.lineno, sub
                    continue
                resolved = _rel_module_path(tree, name)
                yield top, stmt.lineno, resolved


def _prove_pure(tree: SourceTree, start: str) -> Optional[Tuple[List[str], str, int]]:
    """BFS the import graph from ``start``; returns (chain, heavy_dep,
    line) on the first heavy reach, None when pure."""
    seen: Set[str] = {start}
    queue: List[Tuple[str, List[str]]] = [(start, [start])]
    while queue:
        rel, chain = queue.pop(0)
        for top, line, resolved in _edges(tree, rel):
            if top in HEAVY_DEPS:
                return chain, top, line
            if resolved is not None and resolved not in seen:
                seen.add(resolved)
                queue.append((resolved, chain + [resolved]))
    return None


def _file_path_load_sites(tree: SourceTree, rel: str
                          ) -> Iterator[Tuple[str, int]]:
    """(dotted_module, line) for every
    ``spec_from_file_location("npairloss_tpu_torch....", ...)`` literal in
    ``rel`` — the loud-opt-in cross-check."""
    mod = tree.parse(rel)
    if mod is None:
        return
    for node in ast.walk(mod):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        name = fn.attr if isinstance(fn, ast.Attribute) else (
            fn.id if isinstance(fn, ast.Name) else None)
        if name != "spec_from_file_location" or not node.args:
            continue
        lit = const_str(node.args[0])
        if lit and _DOTTED_RE.match(lit):
            yield lit, node.lineno


# The chained-loader idiom passes ("npairloss_tpu_torch....",
# "file.py") tuples to a loop, so the dotted name never reaches
# spec_from_file_location as a literal — this textual scan catches
# those declarations too.
_TUPLE_SITE_RE = re.compile(
    r"[\"'](npairloss_tpu_torch(?:\.[A-Za-z_][A-Za-z_0-9]*)+)[\"']\s*,\s*"
    r"[\"']([A-Za-z_0-9]+\.py)[\"']")


def run(tree: SourceTree) -> List[Finding]:
    findings: List[Finding] = []
    declared = dict(CONTRACT_MODULES)
    for rel in tree.py_files():
        if rel.startswith(ANALYSIS_DIR + "/"):
            declared.setdefault(rel, "the staticcheck suite itself")

    # 1) every declared module present in this tree proves pure.
    for rel, why in sorted(declared.items()):
        if not tree.exists(rel):
            continue  # partial tree (a seeded test tree)
        hit = _prove_pure(tree, rel)
        if hit is not None:
            chain, dep, line = hit
            via = " -> ".join(chain)
            findings.append(Finding(
                PASS_NAME, rel, line if len(chain) == 1 else 0,
                f"reaches-{dep}",
                f"contract module ({why}) transitively imports "
                f"{dep!r} at module level via {via} "
                f"(:{line} in {chain[-1]}) — the contract module's "
                "stdlib-only file-path-load contract is broken"))

    # 2) every file-path-load site names a declared module.
    declared_dotted = {
        rel[:-3].replace("/", ".") for rel in declared}
    declared_paths = set(declared)
    for rel in tree.py_files():
        seen_lits: Set[Tuple[str, int]] = set(
            _file_path_load_sites(tree, rel))
        text = tree.text(rel) or ""
        for m in _TUPLE_SITE_RE.finditer(text):
            line = text[:m.start()].count("\n") + 1
            seen_lits.add((m.group(1), line))
        for dotted, line in sorted(seen_lits):
            target = dotted.replace(".", "/") + ".py"
            if target in declared_paths or dotted in declared_dotted:
                continue
            if target.startswith(ANALYSIS_DIR + "/"):
                continue
            findings.append(Finding(
                PASS_NAME, rel, line, f"undeclared-{dotted}",
                f"file-path-loads {dotted!r} which is not declared in "
                "the purity contract table "
                "(analysis/purity.py CONTRACT_MODULES) — a new "
                "contract module must opt in loudly so the purity "
                "proof covers it"))
    return findings
