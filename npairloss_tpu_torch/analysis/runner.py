"""The staticcheck suite driver: passes -> findings -> report -> gate.

The port of ``npairloss_tpu/analysis/runner.py``, over the port's tree.
``run_suite(root)`` runs every pass over one tree, applies the
committed allowlist (``npairloss_tpu_torch/analysis/
staticcheck_allow.json`` under the root — finding *keys*, which are
line-number-free, so tolerated findings survive unrelated edits),
optionally restricts findings to files changed since a git ref
(``--diff BASE``, the fast incremental check), and emits the versioned
``npairloss-staticcheck-v1`` report through ``analysis.report``.

Exposed three ways, all the same code path:

  * ``python -m npairloss_tpu_torch staticcheck`` (cli.py subcommand —
    free of torch end to end, runnable without the accelerator stack);
  * ``python -m npairloss_tpu_torch.analysis.runner``;
  * ``npairloss_tpu_torch.analysis.run_suite`` (tests).

Stdlib-only and self-contained (the contract the purity pass proves
about this very package).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from npairloss_tpu_torch.analysis import (
    contracts,
    locks,
    markers,
    purity,
    scopes,
    vocab,
)
from npairloss_tpu_torch.analysis.findings import Finding
from npairloss_tpu_torch.analysis.report import (
    build_report,
    validate_staticcheck_report,
    write_report,
)
from npairloss_tpu_torch.analysis.tree import SourceTree

ALLOWLIST_PATH = "npairloss_tpu_torch/analysis/staticcheck_allow.json"

# Execution order: cheap vocabulary/contract scans first, the graph
# walks last — irrelevant for correctness, pleasant for humans.
PASSES: List[Tuple[str, Callable[[SourceTree], List[Finding]]]] = [
    (purity.PASS_NAME, purity.run),
    (scopes.PASS_NAME, scopes.run),
    (locks.PASS_NAME, locks.run),
    (contracts.PASS_NAME, contracts.run),
    (vocab.PASS_NAME, vocab.run),
    (markers.PASS_NAME, markers.run),
]

PASS_NAMES = tuple(name for name, _ in PASSES)


def load_allowlist(path: str) -> List[str]:
    """The committed allowlist: ``{"allow": [{"key": ..., "why": ...}
    | "<key>", ...]}``; a missing file is an empty allowlist."""
    try:
        with open(path) as f:
            obj = json.load(f)
    except FileNotFoundError:
        return []
    except (OSError, ValueError) as e:
        raise ValueError(f"allowlist {path} unreadable: {e}")
    entries = obj.get("allow", []) if isinstance(obj, dict) else None
    if entries is None or not isinstance(entries, list):
        raise ValueError(
            f"allowlist {path} must be an object with an 'allow' list")
    keys: List[str] = []
    for i, entry in enumerate(entries):
        if isinstance(entry, str):
            keys.append(entry)
        elif isinstance(entry, dict) and isinstance(entry.get("key"), str):
            keys.append(entry["key"])
        else:
            raise ValueError(
                f"allowlist {path} entry {i} must be a key string or "
                "an object with a 'key'")
    return keys


def changed_files(root: str, base: str) -> Optional[List[str]]:
    """Root-relative files changed since ``base`` (worktree vs ref,
    plus untracked); None when git cannot answer (not a repo, bad
    ref) — the caller degrades to a full run, loudly."""
    out: List[str] = []
    # --relative keeps diff paths cwd-relative like ls-files' already
    # are — without it, running on a SUBTREE root (a seeded tree)
    # yields repo-root-relative diff paths that never match the
    # tree-relative finding paths, silently dropping findings.
    for args in (["git", "diff", "--name-only", "--relative", base],
                 ["git", "ls-files", "--others", "--exclude-standard"]):
        try:
            proc = subprocess.run(
                args, cwd=root, capture_output=True, text=True,
                timeout=30)
        except (OSError, subprocess.TimeoutExpired):
            return None
        if proc.returncode != 0:
            return None
        out.extend(line.strip() for line in proc.stdout.splitlines()
                   if line.strip())
    return sorted(set(out))


def run_suite(
    root: str,
    passes: Optional[Sequence[str]] = None,
    diff_base: Optional[str] = None,
    allowlist_path: Optional[str] = None,
) -> Dict[str, Any]:
    """Run the suite; returns the ``npairloss-staticcheck-v1`` report
    (already validator-clean — asserted here, the suite holds itself
    to its own contract)."""
    tree = SourceTree(root)
    selected = set(passes) if passes else set(PASS_NAMES)
    unknown = selected - set(PASS_NAMES)
    if unknown:
        raise ValueError(f"unknown pass(es) {sorted(unknown)} "
                         f"(known: {list(PASS_NAMES)})")

    if allowlist_path is None:
        allowlist_path = os.path.join(tree.root, ALLOWLIST_PATH)
    allow = set(load_allowlist(allowlist_path))

    changed: Optional[set] = None
    if diff_base is not None:
        files = changed_files(tree.root, diff_base)
        if files is None:
            raise ValueError(
                f"--diff {diff_base}: git could not enumerate changes "
                f"under {tree.root} — run without --diff")
        changed = set(files)

    pass_rows: List[Dict[str, Any]] = []
    findings: List[Finding] = []
    for name, fn in PASSES:
        if name not in selected:
            continue
        tree.begin_pass()
        note = ""
        if name == markers.PASS_NAME and \
                not tree.exists(markers.HISTORY_PATH):
            pass_rows.append({
                "name": name, "files_scanned": 0, "findings": 0,
                "skipped": True,
                "note": f"no {markers.HISTORY_PATH} in this tree "
                        "(regenerate with --update-timings)"})
            continue
        got = fn(tree)
        if changed is not None:
            got = [f for f in got if f.path in changed]
            note = f"restricted to {len(changed)} changed file(s)"
        findings.extend(got)
        pass_rows.append({
            "name": name,
            "files_scanned": len(tree.touched),
            "findings": len(got),
            "skipped": False,
            "note": note,
        })

    anchor = next((row for row in pass_rows if not row["skipped"]), None)
    if anchor is not None:
        for rel, err in tree.parse_errors:
            if changed is not None and rel not in changed:
                continue  # the --diff contract: unrelated files stay out
            findings.append(Finding(
                anchor["name"], rel, 0, "parse-error",
                f"file does not parse ({err}) — no pass can vouch "
                "for it"))
            anchor["findings"] += 1

    hard = [f for f in findings if f.key not in allow]
    allowed = [f for f in findings if f.key in allow]
    report = build_report(
        tree.root,
        pass_rows,
        [f.to_dict() for f in hard],
        [f.to_dict() for f in allowed],
    )
    err = validate_staticcheck_report(report)
    if err is not None:  # the suite's own bug, never the tree's
        raise AssertionError(f"staticcheck emitted an invalid report: "
                             f"{err}")
    return report


def render(report: Dict[str, Any], stream=None) -> None:
    stream = stream or sys.stdout
    for p in report["passes"]:
        state = "skipped" if p["skipped"] else (
            f"{p['findings']} finding(s)")
        note = f" — {p['note']}" if p["note"] else ""
        print(f"[staticcheck] {p['name']}: {state}{note}", file=stream)
    for rec in report["findings"]:
        loc = f"{rec['path']}:{rec['line']}" if rec["line"] \
            else rec["path"]
        print(f"FINDING [{rec['pass']}] {loc}: {rec['message']}",
              file=stream)
    n_allow = report["summary"]["allowlisted"]
    if n_allow:
        print(f"[staticcheck] {n_allow} allowlisted finding(s) "
              "tolerated", file=stream)


def update_timings(root: str, log_path: str,
                   threshold_s: float) -> str:
    """Regenerate the timing history (``markers.HISTORY_PATH``) from a
    pytest ``--durations=0`` log; returns the path written."""
    with open(log_path) as f:
        durations = markers.parse_durations_log(f.read())
    if not durations:
        raise ValueError(
            f"{log_path} holds no pytest duration lines — run tier-1 "
            "with --durations=0 and pass that log")
    out = os.path.join(root, markers.HISTORY_PATH)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    payload = {
        "threshold_s": threshold_s,
        "source": os.path.basename(log_path),
        "durations": {k: round(v, 3)
                      for k, v in sorted(durations.items())},
    }
    tmp = out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, out)
    return out


def run_from_args(args, default_root: str) -> int:
    """The one driver body behind both entry points (``python -m
    npairloss_tpu_torch staticcheck`` and ``python -m
    npairloss_tpu_torch.analysis.runner``): expects the argparse
    namespace shape both parsers produce (root / passes / diff /
    allowlist / out / update_timings / threshold_s — the option sets are
    pinned equal by tests/test_torch_staticcheck.py)."""
    root = args.root or default_root

    if args.update_timings:
        try:
            out = update_timings(root, args.update_timings,
                                 args.threshold_s)
        except (OSError, ValueError) as e:
            print(f"staticcheck: {e}", file=sys.stderr)
            return 2
        print(f"[staticcheck] wrote {out}")
        return 0

    try:
        report = run_suite(root, passes=args.passes,
                           diff_base=args.diff,
                           allowlist_path=args.allowlist)
    except ValueError as e:
        print(f"staticcheck: {e}", file=sys.stderr)
        return 2
    render(report)
    if args.out and args.out != "-":
        write_report(report, args.out)
        print(f"[staticcheck] report: {args.out}")
    n = report["summary"]["findings"]
    if n:
        print(f"staticcheck: {n} finding(s)")
        return 1
    print("staticcheck OK (no findings)")
    return 0


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="staticcheck",
        description="repo-wide invariant linter (docs/STATICCHECK.md)")
    ap.add_argument("root", nargs="?", default=None,
                    help="tree to scan (default: the repo this module "
                    "lives in)")
    ap.add_argument("--pass", dest="passes", action="append",
                    choices=list(PASS_NAMES), metavar="NAME",
                    help="run only the named pass(es); repeatable "
                    f"(default: all of {list(PASS_NAMES)})")
    ap.add_argument("--diff", metavar="BASE",
                    help="restrict findings to files changed since the "
                    "git ref (the fast incremental check)")
    ap.add_argument("--allowlist", metavar="PATH",
                    help=f"allowlist JSON (default: <root>/"
                    f"{ALLOWLIST_PATH})")
    ap.add_argument("--out", metavar="PATH",
                    default="staticcheck_report.json",
                    help="where the npairloss-staticcheck-v1 report "
                    "lands (default: ./staticcheck_report.json; '-' "
                    "disables the artifact)")
    ap.add_argument("--update-timings", metavar="PYTEST_LOG",
                    help=f"regenerate {markers.HISTORY_PATH} from a "
                    "pytest --durations=0 log, then exit")
    ap.add_argument("--threshold-s", type=float,
                    default=markers.DEFAULT_THRESHOLD_S,
                    help="slow-marker threshold recorded by "
                    "--update-timings (default %(default)s)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = _build_parser().parse_args(argv)
    return run_from_args(args, os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))


if __name__ == "__main__":
    sys.exit(main())
