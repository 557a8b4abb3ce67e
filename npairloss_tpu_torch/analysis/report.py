"""The versioned ``npairloss-staticcheck-v1`` contract: the lint report.

One JSON object per suite run, written through the same
validate-contract pattern as every other gate artifact
(``validate_staticcheck_report`` IS the contract; consumers rely on
exactly the keys it checks).  A copy of
``npairloss_tpu/analysis/report.py``: the same schema and keys, so each
package's validator accepts the other's reports.  Stdlib only, with no
intra-package import.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence

STATICCHECK_SCHEMA = "npairloss-staticcheck-v1"

# Keys every report carries (the writer pin in analysis/contracts.py
# holds build_report to this literal).
REPORT_KEYS = ("schema", "root", "passes", "findings", "allowlisted",
               "summary")
PASS_KEYS = ("name", "files_scanned", "findings", "skipped", "note")
FINDING_KEYS = ("pass", "path", "line", "key", "message")
SUMMARY_KEYS = ("passes", "files_scanned", "findings", "allowlisted")


def build_report(root: str, passes: Sequence[Dict[str, Any]],
                 findings: Sequence[Dict[str, Any]],
                 allowlisted: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    return {
        "schema": STATICCHECK_SCHEMA,
        "root": os.path.abspath(root),
        "passes": list(passes),
        "findings": list(findings),
        "allowlisted": list(allowlisted),
        "summary": {
            "passes": len(passes),
            "files_scanned": sum(p.get("files_scanned", 0)
                                 for p in passes),
            "findings": len(findings),
            "allowlisted": len(allowlisted),
        },
    }


def _check_finding(i: int, rec: Any, kind: str,
                   pass_names: Sequence[str]) -> Optional[str]:
    if not isinstance(rec, dict):
        return f"{kind}[{i}] is not an object"
    for key in FINDING_KEYS:
        if key not in rec:
            return f"{kind}[{i}] missing {key!r}"
    if rec["pass"] not in pass_names:
        return (f"{kind}[{i}]: pass {rec['pass']!r} not in the "
                f"report's pass list {sorted(pass_names)}")
    if not isinstance(rec["line"], int) or rec["line"] < 0:
        return f"{kind}[{i}]: line must be an integer >= 0"
    if not isinstance(rec["path"], str) or not rec["path"]:
        return f"{kind}[{i}]: path must be a non-empty string"
    expect = f"{rec['pass']}:{rec['path']}:"
    if not isinstance(rec["key"], str) or \
            not rec["key"].startswith(expect):
        return (f"{kind}[{i}]: key {rec.get('key')!r} does not follow "
                f"'<pass>:<path>:<detail>' ({expect}...)")
    if not isinstance(rec["message"], str) or not rec["message"]:
        return f"{kind}[{i}]: message must be a non-empty string"
    return None


def validate_staticcheck_report(report: Any) -> Optional[str]:
    """Schema check; returns an error string or None.

    The contract: the schema tag; a non-empty ``passes`` list whose
    entries carry name/files_scanned/findings/skipped/note with a
    per-pass findings count that equals the findings+allowlisted
    records claiming that pass; finding records keyed
    ``<pass>:<path>:<detail>``; and a summary whose counts restate
    the lists (a consumer may trust either).
    """
    if not isinstance(report, dict):
        return "report is not an object"
    if report.get("schema") != STATICCHECK_SCHEMA:
        return (f"schema must be {STATICCHECK_SCHEMA!r}, got "
                f"{report.get('schema')!r}")
    for key in REPORT_KEYS:
        if key not in report:
            return f"report missing {key!r}"
    if not isinstance(report["root"], str) or not report["root"]:
        return "root must be a non-empty string"
    passes = report["passes"]
    if not isinstance(passes, list) or not passes:
        return "passes must be a non-empty list (a suite that ran "\
            "nothing checked nothing)"
    names: List[str] = []
    for i, p in enumerate(passes):
        if not isinstance(p, dict):
            return f"passes[{i}] is not an object"
        for key in PASS_KEYS:
            if key not in p:
                return f"passes[{i}] missing {key!r}"
        if not isinstance(p["name"], str) or not p["name"]:
            return f"passes[{i}]: name must be a non-empty string"
        if p["name"] in names:
            return f"passes[{i}]: duplicate pass {p['name']!r}"
        names.append(p["name"])
        for key in ("files_scanned", "findings"):
            if not isinstance(p[key], int) or p[key] < 0:
                return f"passes[{i}]: {key} must be an integer >= 0"
        if not isinstance(p["skipped"], bool):
            return f"passes[{i}]: skipped must be a bool"
        if p["skipped"] and p["findings"]:
            return (f"passes[{i}]: a skipped pass cannot claim "
                    "findings")
    for kind in ("findings", "allowlisted"):
        recs = report[kind]
        if not isinstance(recs, list):
            return f"{kind} must be a list"
        for i, rec in enumerate(recs):
            err = _check_finding(i, rec, kind, names)
            if err:
                return err
    per_pass: Dict[str, int] = {n: 0 for n in names}
    for kind in ("findings", "allowlisted"):
        for rec in report[kind]:
            per_pass[rec["pass"]] += 1
    for p in passes:
        if p["findings"] != per_pass[p["name"]]:
            return (f"pass {p['name']!r} claims {p['findings']} "
                    f"finding(s) but the record lists hold "
                    f"{per_pass[p['name']]}")
    summary = report["summary"]
    if not isinstance(summary, dict):
        return "summary is not an object"
    for key in SUMMARY_KEYS:
        if key not in summary:
            return f"summary missing {key!r}"
    if summary["passes"] != len(passes):
        return (f"summary.passes {summary['passes']} != "
                f"{len(passes)} pass entries")
    if summary["findings"] != len(report["findings"]):
        return (f"summary.findings {summary['findings']} != "
                f"{len(report['findings'])} finding records")
    if summary["allowlisted"] != len(report["allowlisted"]):
        return (f"summary.allowlisted {summary['allowlisted']} != "
                f"{len(report['allowlisted'])} allowlisted records")
    return None


def write_report(report: Dict[str, Any], path: str) -> None:
    parent = os.path.dirname(os.path.abspath(path))
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def load_report(path: str) -> Any:
    with open(path) as f:
        return json.load(f)
