"""Pass ``vocab`` — the port's vocabularies match their documented tables.

Hand-maintained name sets drift silently: a failpoint the port fires
but absent from the RESILIENCE.md table is undriveable by anyone
reading the runbook (the failpoint names are shared with the JAX
package, whose docs the port reads and never edits); a CLI flag shown
in a doc's command line but renamed in argparse turns the runbook into
a trap; the literal ``_PRECISION_CHOICES`` and ``_PROBE_IMPL_CHOICES``
in cli.py exist because the parser imports no torch, so only a pin
keeps them honest against their registries.  This pass mechanizes
each:

  * every failpoint name the port fires appears in the RESILIENCE.md
    failpoint table, and every row of it is fired somewhere in the
    port (a row the port never fires is a port gap);
  * every ``--flag`` in a documented ``python -m npairloss_tpu_torch``
    command line exists in the port's argparse (and the subcommand
    itself exists): fenced lines in every doc, and inline code spans
    too in ``COMMAND_DOCS`` (the README's port section, the verify
    recipe);
  * declared literal choice pins (cli ``_PRECISION_CHOICES`` vs the
    precision policy registry keys, ``_PROBE_IMPL_CHOICES`` vs the
    probe's ``PROBE_IMPLS``) are equal;
  * every watchdog preset ``name=`` in obs/live/watchdogs.py appears
    (backticked) in docs/OBSERVABILITY.md's runbook prose.

Checks whose inputs are absent from the tree (partial fixture trees)
are skipped, not failed.

Stdlib-only and self-contained: the suite runs, and loads by file
path, in a process without torch (docs/STATICCHECK.md).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from npairloss_tpu_torch.analysis.findings import Finding
from npairloss_tpu_torch.analysis.tree import (
    PACKAGE,
    SourceTree,
    const_str,
    module_level_constants,
    str_tuple,
)

PASS_NAME = "vocab"

RESILIENCE_DOC = "docs/RESILIENCE.md"
OBSERVABILITY_DOC = "docs/OBSERVABILITY.md"
WATCHDOGS_PY = "npairloss_tpu_torch/obs/live/watchdogs.py"
CLI_PY = "npairloss_tpu_torch/cli.py"
# Docs whose inline code spans are read for command lines too (fenced
# lines are read in every doc).
COMMAND_DOCS = ("README.md", ".claude/skills/verify/SKILL.md")

# (module holding a literal choices tuple, its name) pinned equal to
# (module holding the registry dict literal, its name).
CHOICE_PINS: List[Tuple[Tuple[str, str], Tuple[str, str]]] = [
    (("npairloss_tpu_torch/cli.py", "_PRECISION_CHOICES"),
     ("npairloss_tpu_torch/models/precision.py", "_POLICIES")),
    (("npairloss_tpu_torch/cli.py", "_PROBE_IMPL_CHOICES"),
     ("npairloss_tpu_torch/ops/ivf_probe.py", "PROBE_IMPLS")),
    # The tenant manifest validator is stdlib-only (the purity
    # contract), so its choice tuples restate the registries they admit
    # specs into — pinned here so a new probe impl or index kind cannot
    # land without the manifest accepting it.
    (("npairloss_tpu_torch/serve/tenants.py", "_PROBE_IMPL_CHOICES"),
     ("npairloss_tpu_torch/ops/ivf_probe.py", "PROBE_IMPLS")),
    (("npairloss_tpu_torch/serve/tenants.py", "_INDEX_KIND_CHOICES"),
     ("npairloss_tpu_torch/serve/tenants.py", "INDEX_KINDS")),
]

# Entry-point spellings in documented command lines -> which argparse
# vocabulary governs their flags.
_ENTRYPOINTS: List[Tuple[re.Pattern, str]] = [
    (re.compile(r"python(?:3)?\s+-m\s+npairloss_tpu_torch\s+(\S+)"),
     CLI_PY),
]
_INLINE_SPAN_RE = re.compile(r"`([^`]+)`")

_BACKTICK_ROW_RE = re.compile(r"^\|\s*`([^`]+)`")
_FLAG_RE = re.compile(r"^--[A-Za-z][A-Za-z_0-9-]*")


def _failpoint_fires(tree: SourceTree) -> Dict[str, Tuple[str, int]]:
    """{name -> (path, line)} for every ``failpoints.fire``/
    ``failpoints.should_fire`` literal in the package."""
    out: Dict[str, Tuple[str, int]] = {}
    for rel in tree.py_files(subdirs=(PACKAGE,)):
        mod = tree.parse(rel)
        if mod is None:
            continue
        for node in ast.walk(mod):
            if not (isinstance(node, ast.Call) and node.args):
                continue
            fn = node.func
            if not (isinstance(fn, ast.Attribute)
                    and fn.attr in ("fire", "should_fire")
                    and isinstance(fn.value, ast.Name)
                    and fn.value.id == "failpoints"):
                continue
            lit = const_str(node.args[0])
            if lit:
                out.setdefault(lit, (rel, node.lineno))
    return out


def _doc_table_names(text: str, header_word: str) -> Optional[Set[str]]:
    """First-column backticked names of the markdown table whose header
    row contains ``header_word``; None when no such table exists."""
    lines = text.splitlines()
    names: Set[str] = set()
    found = False
    i = 0
    while i < len(lines):
        line = lines[i]
        if line.lstrip().startswith("|") and header_word in line.lower() \
                and i + 1 < len(lines) \
                and set(lines[i + 1].replace("|", "").strip()) <= set("-: "):
            found = True
            i += 2
            while i < len(lines) and lines[i].lstrip().startswith("|"):
                m = _BACKTICK_ROW_RE.match(lines[i].lstrip())
                if m:
                    names.add(m.group(1).strip())
                i += 1
            continue
        i += 1
    return names if found else None


def _argparse_vocab(tree: SourceTree, rel: str
                    ) -> Tuple[Set[str], Set[str]]:
    """(option strings, subcommand names) defined in ``rel`` — every
    ``add_argument('--x', ...)`` and ``add_parser('name', ...)``."""
    flags: Set[str] = set()
    subs: Set[str] = set()
    mod = tree.parse(rel)
    if mod is None:
        return flags, subs
    for node in ast.walk(mod):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        name = fn.attr if isinstance(fn, ast.Attribute) else None
        if name == "add_argument":
            for arg in node.args:
                s = const_str(arg)
                if s and s.startswith("-"):
                    flags.add(s)
            flags.update(("-h", "--help"))  # argparse adds these itself
        elif name == "add_parser" and node.args:
            s = const_str(node.args[0])
            if s:
                subs.add(s)
    return flags, subs


def _doc_command_lines(text: str) -> List[Tuple[int, str]]:
    """(first line number, joined command) for each fenced-code line
    mentioning one of our entry points; backslash continuations are
    joined."""
    out: List[Tuple[int, str]] = []
    lines = text.splitlines()
    in_fence = False
    i = 0
    while i < len(lines):
        stripped = lines[i].strip()
        if stripped.startswith("```"):
            in_fence = not in_fence
            i += 1
            continue
        if in_fence and PACKAGE in stripped:
            start = i + 1
            cmd = stripped
            while cmd.endswith("\\") and i + 1 < len(lines):
                i += 1
                cmd = cmd[:-1] + " " + lines[i].strip()
            out.append((start, cmd))
        i += 1
    return out


def _inline_command_spans(text: str) -> List[Tuple[int, str]]:
    """(line number, joined span) for each inline code span mentioning
    the package outside fenced blocks; a span may wrap lines."""
    out: List[Tuple[int, str]] = []
    lines = text.splitlines()
    in_fence = False
    for i, line in enumerate(lines):
        if line.strip().startswith("```"):
            in_fence = not in_fence
            lines[i] = ""
        elif in_fence:
            lines[i] = ""  # fenced lines are _doc_command_lines' own
    text = "\n".join(lines)
    for m in _INLINE_SPAN_RE.finditer(text):
        span = m.group(1)
        if PACKAGE in span:
            out.append((text.count("\n", 0, m.start()) + 1,
                        " ".join(span.split())))
    return out


def _flags_of(cmd: str) -> List[str]:
    out = []
    for tok in cmd.split():
        m = _FLAG_RE.match(tok)
        if m:
            out.append(m.group(0))
    return out


def run(tree: SourceTree) -> List[Finding]:
    findings: List[Finding] = []

    # -- failpoints vs the RESILIENCE.md table --
    fires = _failpoint_fires(tree)
    res_text = tree.text(RESILIENCE_DOC)
    documented = _doc_table_names(res_text, "failpoint") \
        if res_text is not None else None
    if fires and documented is not None:
        for name, (rel, line) in sorted(fires.items()):
            if name not in documented:
                findings.append(Finding(
                    PASS_NAME, rel, line, f"failpoint-{name}",
                    f"failpoint {name!r} is fired here but missing "
                    f"from the {RESILIENCE_DOC} failpoint table — an "
                    "undocumented fault injection nobody can drive "
                    "from the runbook"))
        for name in sorted(documented - set(fires)):
            findings.append(Finding(
                PASS_NAME, RESILIENCE_DOC, 0, f"failpoint-{name}",
                f"failpoint {name!r} is documented in the "
                f"{RESILIENCE_DOC} table but never fired anywhere in "
                "the port — a port gap, or a stale row"))

    # -- documented command lines use real flags/subcommands --
    vocab_cache: Dict[str, Tuple[Set[str], Set[str]]] = {}
    docs = tree.md_files()
    docs += [d for d in COMMAND_DOCS if d not in docs and tree.exists(d)]
    for doc in docs:
        text = tree.text(doc)
        if text is None:
            continue
        commands = _doc_command_lines(text)
        if doc in COMMAND_DOCS:
            commands += _inline_command_spans(text)
        for line_no, cmd in commands:
            for pat, vocab_rel in _ENTRYPOINTS:
                m = pat.search(cmd)
                if not m:
                    continue
                if not tree.exists(vocab_rel):
                    break
                if vocab_rel not in vocab_cache:
                    vocab_cache[vocab_rel] = _argparse_vocab(
                        tree, vocab_rel)
                flags, subs = vocab_cache[vocab_rel]
                if m.groups():
                    sub = m.group(1)
                    if subs and not sub.startswith("-") \
                            and sub not in subs:
                        findings.append(Finding(
                            PASS_NAME, doc, line_no, f"subcommand-{sub}",
                            f"documented command uses subcommand "
                            f"{sub!r} which {vocab_rel} does not "
                            f"define (known: {sorted(subs)})"))
                        break
                tail = cmd[m.end():]
                for flag in _flags_of(tail):
                    if flag not in flags:
                        findings.append(Finding(
                            PASS_NAME, doc, line_no, f"flag-{flag}",
                            f"documented command passes {flag} which "
                            f"{vocab_rel} does not define — runbook "
                            "drifted from argparse"))
                break

    # -- literal choice pins --
    for (rel_a, name_a), (rel_b, name_b) in CHOICE_PINS:
        if not (tree.exists(rel_a) and tree.exists(rel_b)):
            continue
        mod_a, mod_b = tree.parse(rel_a), tree.parse(rel_b)
        if mod_a is None or mod_b is None:
            continue
        val_a = module_level_constants(mod_a).get(name_a)
        choices = str_tuple(val_a) if val_a is not None else None
        val_b = module_level_constants(mod_b).get(name_b)
        registry: Optional[Set[str]] = None
        if isinstance(val_b, ast.Dict):
            keys = [const_str(k) for k in val_b.keys if k is not None]
            if all(k is not None for k in keys):
                registry = set(keys)
        if choices is None or registry is None:
            findings.append(Finding(
                PASS_NAME, rel_a, 0, f"pin-{name_a}",
                f"choice pin {name_a} ({rel_a}) vs {name_b} ({rel_b}) "
                "cannot be resolved to literals"))
        elif set(choices) != registry:
            findings.append(Finding(
                PASS_NAME, rel_a, val_a.lineno, f"pin-{name_a}",
                f"{name_a} {sorted(choices)} != {name_b} registry "
                f"keys {sorted(registry)} — the torch-free argparse "
                "vocabulary drifted from the registry"))

    # -- watchdog preset names documented --
    wd_mod = tree.parse(WATCHDOGS_PY) if tree.exists(WATCHDOGS_PY) \
        else None
    obs_text = tree.text(OBSERVABILITY_DOC)
    if wd_mod is not None and obs_text is not None:
        names: List[Tuple[str, int]] = []
        for node in ast.walk(wd_mod):
            if isinstance(node, ast.Call):
                for kw in node.keywords:
                    if kw.arg == "name":
                        s = const_str(kw.value)
                        if s:
                            names.append((s, node.lineno))
        for name, line in sorted(set(names)):
            if f"`{name}`" not in obs_text:
                findings.append(Finding(
                    PASS_NAME, WATCHDOGS_PY, line, f"watchdog-{name}",
                    f"watchdog preset {name!r} is not mentioned "
                    f"(backticked) anywhere in {OBSERVABILITY_DOC} — "
                    "the runbook cannot explain an alert it never "
                    "names"))
    return findings
