"""Step-time decomposition from the host span streams (obs.tracing);
port of ``npairloss_tpu/obs/perf/decompose.py`` (a copy: the category
vocabulary is the JAX package's, so the two decompose one event list
the same way).

The span tracer already records where the loop thread's wall clock goes
(``data/next_batch``, ``step/dispatch``, ``step/compile``, ``eval``,
``snapshot``, ``step/window_sync``, the ``serve/*`` request path).  This
module turns one run's Chrome-trace events into the per-category
breakdown the reports publish, with two hard rules:

  * **self-time attribution** — a nested span's time belongs to the
    DEEPEST span covering it (``eval`` containing ``eval/compile``
    must not double-count), computed per thread by timestamp
    containment, the same convention Perfetto renders;
  * **explicit reconciliation** — categorized time never silently
    absorbs the remainder: ``unattributed_ms`` is defined as
    ``wall_ms - sum(parts)`` so the invariant
    ``sum(parts) + unattributed == wall`` holds EXACTLY by
    construction, and a large unattributed share is itself a finding
    (host work between spans), not a rounding artifact.

Stdlib-only.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

# span-name (longest prefix wins) -> step-time category.  The category
# vocabulary is part of the report schema (tests pin it).
SPAN_CATEGORIES = [
    ("data/next_batch", "data_wait"),
    ("pipeline/stage", "h2d"),
    ("comm/", "comms"),
    # comm/price is the fleet observatory's AOT collective-pricing
    # compile — obs overhead, NOT interconnect time; the longer prefix
    # outranks the comm/ rule above so seconds of XLA compile can't
    # masquerade as a comms share.
    ("comm/price", "compile"),
    ("step/compile", "compile"),
    ("eval/compile", "compile"),
    ("step/recompile", "compile"),
    ("step/dispatch", "dispatch"),
    ("step/device_wait", "device_compute"),
    ("step/window_sync", "window_sync"),
    ("eval", "eval"),
    ("snapshot", "snapshot"),
    ("serve/admit", "admit"),
    ("serve/batch", "batch"),
    ("serve/dispatch", "dispatch"),
    ("serve/encode", "encode"),
    ("serve/topk", "topk"),
    ("serve/warmup", "warmup"),
]

STEP_CATEGORIES = (
    "data_wait", "h2d", "comms", "compile", "dispatch", "device_compute",
    "window_sync", "eval", "snapshot", "other_span",
)

SERVE_CATEGORIES = ("admit", "batch", "dispatch", "encode", "topk")


def category_of(name: str) -> Optional[str]:
    """Longest-prefix category for a span name; None = unmapped (its
    time lands in ``other_span``, never dropped silently)."""
    best, best_len = None, -1
    for prefix, cat in SPAN_CATEGORIES:
        if name.startswith(prefix) and len(prefix) > best_len:
            best, best_len = cat, len(prefix)
    return best


def _complete_events(
    events: Sequence[Dict[str, Any]], tid: Optional[int]
) -> List[Dict[str, Any]]:
    out = [e for e in events
           if e.get("ph") == "X" and isinstance(e.get("dur"), (int, float))]
    if tid is not None:
        out = [e for e in out if e.get("tid") == tid]
    return out


def loop_thread(events: Sequence[Dict[str, Any]]) -> Optional[int]:
    """The tid owning the most step/data spans — the train-loop thread
    (staging/reader threads emit other names)."""
    counts: Dict[int, int] = {}
    for e in _complete_events(events, None):
        if str(e.get("name", "")).startswith(("step/", "data/")):
            counts[e.get("tid")] = counts.get(e.get("tid"), 0) + 1
    if not counts:
        return None
    return max(counts, key=counts.get)


def self_times(events: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Per-event self time (dur minus directly-nested children) for ONE
    thread's complete events, by timestamp containment."""
    evs = sorted(events, key=lambda e: (e["ts"], -e["dur"]))
    out = []
    stack: List[Dict[str, Any]] = []
    for e in evs:
        rec = {"name": e["name"], "ts": e["ts"], "dur": e["dur"],
               "self": float(e["dur"])}
        while stack and stack[-1]["ts"] + stack[-1]["dur"] <= e["ts"]:
            stack.pop()
        if stack and e["ts"] + e["dur"] <= stack[-1]["ts"] + stack[-1]["dur"]:
            stack[-1]["self"] -= float(e["dur"])
        stack.append(rec)
        out.append(rec)
    return out


def decompose_step_time(
    events: Sequence[Dict[str, Any]],
    wall_ms: float,
    tid: Optional[int] = None,
    serve: bool = False,
) -> Dict[str, Any]:
    """Span events + the measured wall interval -> the step-time
    breakdown ``{"parts": {category: ms}, "unattributed_ms", "wall_ms"}``
    with the exact reconciliation invariant.  ``tid`` defaults to the
    detected loop thread (other threads' spans OVERLAP the loop wall
    clock and must not be summed into it).  ``serve=True`` admits the
    serving stage categories (encode/batch/dispatch/topk/admit) as
    first-class parts — a serve-step decomposition that other_span'ed
    them would bury the entire measured loop in one opaque bucket."""
    if tid is None:
        tid = loop_thread(events)
    evs = _complete_events(events, tid)
    parts: Dict[str, float] = {}
    for rec in self_times(evs):
        cat = category_of(str(rec["name"])) or "other_span"
        if not serve and cat in SERVE_CATEGORIES \
                and cat not in STEP_CATEGORIES:
            cat = "other_span"
        parts[cat] = parts.get(cat, 0.0) + max(rec["self"], 0.0) / 1e3
    rounded = {k: round(v, 3) for k, v in sorted(parts.items())}
    wall_r = round(wall_ms, 3)
    return {
        "parts": rounded,
        # Defined as the remainder, so sum(parts) + unattributed ==
        # wall holds (to fp/rounding noise) by construction; a NEGATIVE
        # value means spans overran the measured wall interval.
        "unattributed_ms": round(wall_r - sum(rounded.values()), 3),
        "attributed_ms": round(sum(rounded.values()), 3),
        "wall_ms": wall_r,
    }


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile on a pre-sorted list (no numpy — this
    module stays stdlib-only)."""
    if not sorted_vals:
        return 0.0
    idx = min(int(round(q / 100.0 * (len(sorted_vals) - 1))),
              len(sorted_vals) - 1)
    return sorted_vals[idx]


def serve_latency_decomposition(
    events: Sequence[Dict[str, Any]],
    since_us: float = 0.0,
) -> Dict[str, Dict[str, float]]:
    """p50/p99/count per serving stage (encode / batch / dispatch /
    topk / admit) from the ``serve/*`` spans — the per-request latency
    split the Gemma-serving comparison (PAPERS.md) uses to justify
    precision/layout work.  ``since_us`` restricts to spans that
    *ended* at or after the cursor (tracer-relative timestamps): a span
    straddling the window boundary counts in the window it finished in
    — filtering on start time would drop exactly the longest (tail)
    spans and bias p99 low."""
    durs: Dict[str, List[float]] = {}
    for e in _complete_events(events, None):
        if e["ts"] + e["dur"] < since_us:
            continue
        name = str(e.get("name", ""))
        if not name.startswith("serve/"):
            # A step/dispatch span also maps to "dispatch" — only the
            # serving path's own spans belong in this split.
            continue
        cat = category_of(name)
        if cat in SERVE_CATEGORIES:
            durs.setdefault(cat, []).append(float(e["dur"]) / 1e3)
    out = {}
    for cat, vals in sorted(durs.items()):
        vals.sort()
        out[cat] = {
            "p50_ms": round(_percentile(vals, 50), 3),
            "p99_ms": round(_percentile(vals, 99), 3),
            "count": len(vals),
        }
    return out
