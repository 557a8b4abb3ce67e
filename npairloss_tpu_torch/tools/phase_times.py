"""Wall seconds per phase of ``chip_smoke.py``, for one tree or several
run in turns (a parent checkout beside the working tree):

    python3 -m npairloss_tpu_torch.tools.phase_times [--tree DIR ...]
        [--out F] [--logs DIR]

Each tree's ``python3 chip_smoke.py`` runs from that tree's root, one
after the other.  Every line of its standard output is stamped with the
seconds since its start, and the gap before a line is charged to the
line's phase.  A line's phase comes from its leading ``[tag]``
(:data:`PHASE_OF`); tags shared by several phases (``[profile]``,
``[kernel]``, ...) and unknown tags stay in the current phase, and the
phase never moves back (a late ``[5h]`` line in phase 6c stays in 6c),
so the phases follow ``chip_smoke.main``'s order.  The stamped logs go
to ``--logs``; one JSON object per tree, with each phase's seconds and
the run's exit code, goes to ``--out`` and to standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

# chip_smoke.main's order.
ORDER = ["start", "3", "4", "5", "5b", "5c", "5d", "5e", "4b", "5f", "5g",
         "5h", "5i", "5j", "6", "6b", "6c", "7", "8", "done"]
PHASE_OF = {
    "card": "start", "build": "start", "index": "3", "kernel": "3",
    "path": "4", "train": "5", "upload": "5", "step": "5b", "mining": "5c",
    "data": "5d", "list-train": "5d", "drill": "5e", "drill-resume": "5e",
    "resume": "5e", "extract": "5e", "eval": "5e", "time": "5e", "5e": "5e",
    "4b": "4b", "bn-train": "5f", "5f": "5f", "bn-learn": "5g", "5g": "5g",
    "5h": "5h", "5i": "5i", "rank0": "5i", "rank1": "5i", "5j": "5j",
    "blockwise": "6", "blockwise-train": "6b", "stretch": "6c",
    "stretch-bf16": "6c", "7": "7", "8": "8", "done": "done",
}
TAG = re.compile(r"^\[([^\]\s]+)")


def phase_of(tag: str) -> Optional[str]:
    """The phase a ``[tag]`` opens, or None for a shared or unknown tag
    (``7a``..``7f`` are phase 7, ``8a``..``8e`` phase 8)."""
    if tag in PHASE_OF:
        return PHASE_OF[tag]
    m = re.fullmatch(r"([78])[a-z]", tag)
    return m.group(1) if m else None


def split(stamped: List[Tuple[float, str]]) -> Dict[str, float]:
    """Seconds per phase of ``(seconds since start, line)`` pairs."""
    out: Dict[str, float] = {}
    cur, last = 0, 0.0
    for t, line in stamped:
        m = TAG.match(line)
        p = phase_of(m.group(1)) if m else None
        if p is not None:
            cur = max(cur, ORDER.index(p))
        out[ORDER[cur]] = out.get(ORDER[cur], 0.0) + t - last
        last = t
    return out


def run_tree(tree: str, log_path: Optional[str]) -> Dict[str, object]:
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "chip_smoke.py"], cwd=tree,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, bufsize=1)
    stamped: List[Tuple[float, str]] = []
    log = open(log_path, "w") if log_path else None
    try:
        for line in proc.stdout:
            t = time.perf_counter() - t0
            stamped.append((t, line.rstrip("\n")))
            if log:
                log.write(f"{t:9.3f} {line}")
    finally:
        rc = proc.wait()
        if log:
            log.close()
    phases = split(stamped)
    return {"tree": tree, "rc": rc,
            "seconds": time.perf_counter() - t0,
            "phases": {p: round(phases[p], 3) for p in ORDER if p in phases},
            "last_line": stamped[-1][1] if stamped else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=None,
                    help="a tree holding chip_smoke.py (repeatable; "
                    "default: the current directory)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--logs", default=None,
                    help="directory for each run's stamped log")
    args = ap.parse_args(argv)
    trees = args.tree or ["."]
    if args.logs:
        os.makedirs(args.logs, exist_ok=True)
    recs = []
    for i, tree in enumerate(trees):
        name = os.path.basename(os.path.abspath(tree))
        log = (os.path.join(args.logs, f"run{i}_{name}.log")
               if args.logs else None)
        rec = run_tree(os.path.abspath(tree), log)
        recs.append(rec)
        print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for rec in recs:
                f.write(json.dumps(rec) + "\n")
    return 0 if all(r["rc"] == 0 for r in recs) else 1


if __name__ == "__main__":
    sys.exit(main())
