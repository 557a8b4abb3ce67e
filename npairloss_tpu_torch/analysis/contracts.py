"""Pass ``contracts`` — writer/validator drift on the versioned schemas.

Every artifact the gates trust is a versioned contract
(``npairloss-*-v1``) with exactly one validator module; the emitter
key sets have literal "twins" pinned across stdlib module pairs
(``obs.sinks.FLEET_KEYS`` restates ``obs.fleet.stamp.STAMP_KEYS``
because a loader without torch must not drag the package in).  Runtime
tests pin some of these; this pass proves ALL of them at lint time:

  * every module-level constant holding a ``npairloss-*-v<N>`` string
    is defined in exactly one module, and that module ships a
    ``validate_*`` function (no orphan writers, no orphan validators);
  * no other module restates the version literal in code (dict
    writes / comparisons) — import the constant or stay out;
  * declared KEY-TWIN literal pairs are element-for-element equal;
  * declared WRITER-PIN dict literals (e.g. ``FleetStamp.to_dict``)
    emit exactly the keys their ``*_KEYS`` constant promises.

Stdlib-only and self-contained: the suite runs, and loads by file
path, in a process without torch (docs/STATICCHECK.md).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Tuple

from npairloss_tpu_torch.analysis.findings import Finding
from npairloss_tpu_torch.analysis.tree import (
    SourceTree,
    const_str,
    module_level_constants,
    str_tuple,
)

PASS_NAME = "contracts"

SCHEMA_RE = re.compile(r"^npairloss-[a-z0-9][a-z0-9-]*-v\d+$")

# Literal tuples that must stay element-for-element identical across
# modules (the stdlib restatement contract).  Pairs where either
# side is absent from the tree are skipped (partial fixture trees).
KEY_TWINS: List[Tuple[Tuple[str, str], Tuple[str, str]]] = [
    (("npairloss_tpu_torch/obs/sinks.py", "FLEET_KEYS"),
     ("npairloss_tpu_torch/obs/fleet/stamp.py", "STAMP_KEYS")),
]

# (module, dotted function/method, keys-constant in the same module):
# the function's returned dict literal must emit exactly those keys.
WRITER_PINS: List[Tuple[str, str, str]] = [
    ("npairloss_tpu_torch/obs/fleet/stamp.py", "FleetStamp.to_dict",
     "STAMP_KEYS"),
    # The suite holds itself to its own contract.
    ("npairloss_tpu_torch/analysis/report.py", "build_report",
     "REPORT_KEYS"),
]


def _find_func(mod: ast.Module, dotted: str) -> Optional[ast.FunctionDef]:
    parts = dotted.split(".")
    body = mod.body
    node: Optional[ast.AST] = None
    for i, part in enumerate(parts):
        node = None
        for stmt in body:
            if isinstance(stmt, (ast.ClassDef, ast.FunctionDef)) and \
                    stmt.name == part:
                node = stmt
                break
        if node is None:
            return None
        body = getattr(node, "body", [])
    return node if isinstance(node, ast.FunctionDef) else None


def _returned_dict_keys(fn: ast.FunctionDef) -> Optional[Tuple[str, ...]]:
    """Constant keys of the function's ``return {...}`` dict literal
    (first such return); None when there is none or keys are dynamic."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Dict):
            keys = []
            for k in node.value.keys:
                s = const_str(k) if k is not None else None
                if s is None:
                    return None
                keys.append(s)
            return tuple(keys)
    return None


def _schema_constants(tree: SourceTree, rel: str) -> Dict[str, Tuple[str, int]]:
    """{version-string -> (const name, line)} for module-level
    constants of ``rel`` holding a versioned schema literal."""
    mod = tree.parse(rel)
    if mod is None:
        return {}
    out: Dict[str, Tuple[str, int]] = {}
    for name, value in module_level_constants(mod).items():
        s = const_str(value)
        if s and SCHEMA_RE.match(s):
            out[s] = (name, value.lineno)
    return out


def _restated_literals(mod: ast.Module) -> List[Tuple[str, int]]:
    """Versioned literals appearing in CODE context — dict writes and
    comparisons — where the constant should have been used instead.
    Docstrings and help text never match these contexts."""
    out: List[Tuple[str, int]] = []
    for node in ast.walk(mod):
        exprs: List[ast.AST] = []
        if isinstance(node, ast.Dict):
            exprs.extend(k for k in node.keys if k is not None)
            exprs.extend(node.values)
        elif isinstance(node, ast.Compare):
            exprs.append(node.left)
            exprs.extend(node.comparators)
        for e in exprs:
            s = const_str(e)
            if s and SCHEMA_RE.match(s):
                out.append((s, e.lineno))
    return out


def run(tree: SourceTree) -> List[Finding]:
    findings: List[Finding] = []
    files = tree.py_files()

    # -- schema registry: one defining module per version, each with a
    # validator --
    defined: Dict[str, List[Tuple[str, str, int]]] = {}
    for rel in files:
        for schema, (name, line) in _schema_constants(tree, rel).items():
            defined.setdefault(schema, []).append((rel, name, line))
    for schema, sites in sorted(defined.items()):
        if len(sites) > 1:
            where = ", ".join(f"{r}:{ln} ({n})" for r, n, ln in sites)
            for rel, name, line in sites:
                findings.append(Finding(
                    PASS_NAME, rel, line, schema,
                    f"version string {schema!r} is defined in "
                    f"{len(sites)} modules ({where}) — one contract, "
                    "one defining module"))
            continue
        rel, name, line = sites[0]
        mod = tree.parse(rel)
        has_validator = mod is not None and any(
            isinstance(stmt, ast.FunctionDef)
            and stmt.name.startswith("validate_")
            for stmt in mod.body)
        if not has_validator:
            findings.append(Finding(
                PASS_NAME, rel, line, schema,
                f"{name} = {schema!r} has no module-level "
                "validate_* function in its defining module — a "
                "versioned contract without a validator is an orphan "
                "writer (the gates have nothing to hold it to)"))

    # -- no restated literals outside the defining module --
    for rel in files:
        mod = tree.parse(rel)
        if mod is None:
            continue
        for schema, line in _restated_literals(mod):
            sites = defined.get(schema)
            if sites and sites[0][0] != rel:
                findings.append(Finding(
                    PASS_NAME, rel, line, f"restated-{schema}",
                    f"{schema!r} restated as a raw literal outside its "
                    f"defining module ({sites[0][0]}) — import the "
                    "constant so a version bump cannot fork the "
                    "contract"))

    # -- key twins --
    for (rel_a, name_a), (rel_b, name_b) in KEY_TWINS:
        if not (tree.exists(rel_a) and tree.exists(rel_b)):
            continue
        mod_a, mod_b = tree.parse(rel_a), tree.parse(rel_b)
        if mod_a is None or mod_b is None:
            continue
        val_a = module_level_constants(mod_a).get(name_a)
        val_b = module_level_constants(mod_b).get(name_b)
        tup_a = str_tuple(val_a) if val_a is not None else None
        tup_b = str_tuple(val_b) if val_b is not None else None
        for rel, name, tup in ((rel_a, name_a, tup_a),
                               (rel_b, name_b, tup_b)):
            if tup is None:
                findings.append(Finding(
                    PASS_NAME, rel, 0, f"twin-{name}",
                    f"{name} in {rel} is missing or not a literal "
                    "string tuple — the key-twin pin cannot be "
                    "proven"))
        if tup_a is not None and tup_b is not None and tup_a != tup_b:
            findings.append(Finding(
                PASS_NAME, rel_a, val_a.lineno, f"twin-{name_a}",
                f"{name_a} {tup_a} != {rel_b}:{name_b} {tup_b} — the "
                "stdlib restatement drifted from its twin"))

    # -- writer pins --
    for rel, dotted, keys_name in WRITER_PINS:
        if not tree.exists(rel):
            continue
        mod = tree.parse(rel)
        if mod is None:
            continue
        fn = _find_func(mod, dotted)
        keys_val = module_level_constants(mod).get(keys_name)
        keys = str_tuple(keys_val) if keys_val is not None else None
        if fn is None or keys is None:
            findings.append(Finding(
                PASS_NAME, rel, 0, f"pin-{dotted}",
                f"writer pin {dotted} <-> {keys_name} cannot be "
                "resolved (function or literal keys constant missing)"))
            continue
        emitted = _returned_dict_keys(fn)
        if emitted is None:
            findings.append(Finding(
                PASS_NAME, rel, fn.lineno, f"pin-{dotted}",
                f"{dotted} does not return a literal dict — the "
                f"writer pin against {keys_name} cannot be proven"))
        elif set(emitted) != set(keys):
            findings.append(Finding(
                PASS_NAME, rel, fn.lineno, f"pin-{dotted}",
                f"{dotted} emits keys {sorted(emitted)} but "
                f"{keys_name} promises {sorted(keys)} — writer and "
                "contract drifted"))
    return findings
