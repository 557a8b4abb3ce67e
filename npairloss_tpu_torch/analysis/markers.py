"""Pass ``markers`` — tier-1 stays under budget mechanically.

Tier-1 (``pytest -m 'not slow'``) runs under a time limit (ROADMAP.md)
kept by hand: when a test grows past a few seconds somebody notices in
review — or nobody does, and the suite grazes the limit.  This pass
makes it mechanical: the port's committed timing history
(``npairloss_tpu_torch/analysis/timing_history.json``, regenerated from
a tier-1 run of ``tests/test_torch_*.py`` with ``--durations=0`` via
``staticcheck --update-timings``)
says what each test actually costs; any test at or over the threshold
must either carry ``@pytest.mark.slow`` (module-level ``pytestmark``
counts) or a ``# slow-ok: <reason>`` comment on its ``def`` line (a
deliberately-kept tier-1 heavyweight, e.g. one that holds a path
against the JAX package that no other test covers).

No history file -> the pass is skipped with a note (a fresh clone
must not fail on data it cannot have).  A history entry whose test no
longer exists is ignored (renames are not findings).

Stdlib-only and self-contained: the suite runs, and loads by file
path, in a process without torch (docs/STATICCHECK.md).
"""

from __future__ import annotations

import ast
import json
import re
from typing import Dict, List, Optional, Tuple

from npairloss_tpu_torch.analysis.findings import Finding
from npairloss_tpu_torch.analysis.tree import SourceTree

PASS_NAME = "markers"

HISTORY_PATH = "npairloss_tpu_torch/analysis/timing_history.json"
DEFAULT_THRESHOLD_S = 10.0
SLOW_OK = "slow-ok"

_DURATION_LINE_RE = re.compile(
    r"^\s*(\d+(?:\.\d+)?)s\s+(?:call|setup|teardown)\s+(\S+)")


def parse_durations_log(text: str) -> Dict[str, float]:
    """{nodeid -> seconds} from ``pytest --durations=0`` output (call
    phase dominates; phases of one nodeid are summed)."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        m = _DURATION_LINE_RE.match(line)
        if m:
            nodeid = m.group(2)
            out[nodeid] = out.get(nodeid, 0.0) + float(m.group(1))
    return out


def load_history(tree: SourceTree) -> Optional[Dict]:
    text = tree.text(HISTORY_PATH)
    if text is None:
        return None
    try:
        obj = json.loads(text)
    except ValueError:
        return {"_error": f"{HISTORY_PATH} is not valid JSON"}
    if not isinstance(obj, dict) or \
            not isinstance(obj.get("durations"), dict):
        return {"_error": f"{HISTORY_PATH} lacks a 'durations' object"}
    return obj


def _split_nodeid(nodeid: str) -> Optional[Tuple[str, str]]:
    """(file, function) from ``tests/test_x.py::Class::test_y[param]``."""
    parts = nodeid.split("::")
    if len(parts) < 2 or not parts[0].endswith(".py"):
        return None
    func = parts[-1].split("[", 1)[0]
    return parts[0].replace("\\", "/"), func


def _marks_slow(dec: ast.AST) -> bool:
    """True for ``pytest.mark.slow`` / ``pytest.mark.slow(...)``."""
    if isinstance(dec, ast.Call):
        dec = dec.func
    return isinstance(dec, ast.Attribute) and dec.attr == "slow"


def _module_marks_slow(mod: ast.Module) -> bool:
    for stmt in mod.body:
        if isinstance(stmt, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "pytestmark"
                for t in stmt.targets):
            vals = stmt.value.elts if isinstance(
                stmt.value, (ast.List, ast.Tuple)) else [stmt.value]
            if any(_marks_slow(v) for v in vals):
                return True
    return False


def _find_test_fn(mod: ast.Module, name: str) -> Optional[ast.FunctionDef]:
    for node in ast.walk(mod):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name == name:
            return node
    return None


def run(tree: SourceTree) -> List[Finding]:
    findings: List[Finding] = []
    history = load_history(tree)
    if history is None:
        return findings  # no data: skipped (runner notes it)
    if "_error" in history:
        findings.append(Finding(
            PASS_NAME, HISTORY_PATH, 0, "history",
            history["_error"]))
        return findings
    threshold = float(history.get("threshold_s", DEFAULT_THRESHOLD_S))

    # Aggregate parametrized nodeids to their function's worst case.
    worst: Dict[Tuple[str, str], float] = {}
    for nodeid, secs in history["durations"].items():
        if not isinstance(secs, (int, float)):
            continue
        loc = _split_nodeid(str(nodeid))
        if loc is None:
            continue
        worst[loc] = max(worst.get(loc, 0.0), float(secs))

    for (rel, func), secs in sorted(worst.items()):
        if secs < threshold or not tree.exists(rel):
            continue
        mod = tree.parse(rel)
        if mod is None:
            continue
        fn = _find_test_fn(mod, func)
        if fn is None:
            continue  # renamed/removed since the history was taken
        if _module_marks_slow(mod) or any(
                _marks_slow(d) for d in fn.decorator_list):
            continue
        note = tree.comments(rel).get(fn.lineno, "")
        if note.startswith(SLOW_OK):
            continue
        findings.append(Finding(
            PASS_NAME, rel, fn.lineno, func,
            f"{func} took {secs:.1f}s in the recorded tier-1 run "
            f"(threshold {threshold:g}s) without @pytest.mark.slow — "
            "mark it slow (+ a smoke run if it guards a path), or "
            f"annotate '# {SLOW_OK}: <reason>' on the def line to "
            "keep it in tier-1 deliberately"))
    return findings
