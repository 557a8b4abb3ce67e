"""Perf-report artifact: its schema, assembly, validation and rendering;
port of ``npairloss_tpu/obs/perf/report.py`` (the same
``npairloss-perf-report-v1`` schema, so the JAX package's
``validate_report`` accepts the port's).

One on-disk artifact per ``prof`` run (JSON + human table): per-region
FLOPs / bytes / arithmetic intensity / bound class / share of the step
/ est-ms-at-roofline from the step's count (``obs.perf.count``; the JAX
package reads compiled HLO), plus the step-time decomposition of the
host spans reconciled against wall time.  Stdlib only.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence

REPORT_SCHEMA = "npairloss-perf-report-v1"

# Keys every region row carries (the JAX package's schema).
REGION_KEYS = (
    "region", "flops", "bytes", "collective_bytes", "ai", "bound",
    "pct_flops", "est_ms_at_roofline",
)


def build_report(
    *,
    step: str,
    device_kind: str,
    batch: Optional[int] = None,
    count=None,
    span_events: Optional[Sequence[Dict[str, Any]]] = None,
    wall_ms: Optional[float] = None,
    steps: Optional[int] = None,
    ms_per_step: Optional[float] = None,
    serve_spans: bool = False,
    region_depth: int = 2,
    extra: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Assemble one report dict from whatever layers are available:
    the step's count (``count``, an ``obs.perf.count.StepCounter``),
    the dynamic decomposition (``span_events`` + ``wall_ms``) and
    timing (``ms_per_step`` for the MFU line).  Layers degrade
    independently — a report with only one layer is still schema-valid."""
    from npairloss_tpu_torch.obs.perf import costs, decompose, roofline

    spec = roofline.chip_peaks(device_kind)
    report: Dict[str, Any] = {
        "schema": REPORT_SCHEMA,
        "step": step,
        "device_kind": device_kind,
        "batch": batch,
        "peaks": {
            "device": spec.device_kind,
            "flops": spec.flops,
            "hbm_bytes_per_s": spec.hbm_bytes_per_s,
            "ici_bytes_per_s": spec.ici_bytes_per_s,
            "ridge_ai": round(spec.ridge_ai, 2),
            "known": spec.known,
        },
        "regions": [],
        "totals": {},
        "notes": [],
    }
    if extra:
        report.update(extra)

    if count is not None:
        regions = count.regions(region_depth)
        total_flops = sum(r["flops"] for r in regions.values()) or 1.0
        rows: List[Dict[str, Any]] = []
        for name, r in regions.items():
            cls = roofline.classify(
                r["flops"], r["bytes"], r["collective_bytes"], spec)
            rows.append({
                "region": name,
                "flops": r["flops"],
                "bytes": r["bytes"],
                "collective_bytes": r["collective_bytes"],
                "ops": int(r["ops"]),
                "ai": (round(cls["ai"], 3)
                       if cls["ai"] is not None else None),
                "bound": cls["bound"],
                "pct_flops": round(100.0 * r["flops"] / total_flops, 2),
                "est_ms_at_roofline": round(cls["est_ms_at_roofline"], 4),
            })
        rows.sort(key=lambda r: (-r["flops"], r["region"]))
        report["regions"] = rows
        report["totals"].update(
            flops_counted=count.flops,
            bytes_counted=count.bytes,
            collective_bytes_counted=count.collective_bytes,
            flops_attributed=sum(r["flops"] for r in rows),
            bytes_attributed=sum(r["bytes"] for r in rows),
            collective_bytes_attributed=sum(
                r["collective_bytes"] for r in rows),
            kernels={k: {"calls": v[0], "flops": v[1], "bytes": v[2]}
                     for k, v in sorted(count.kernels.items())},
            # Every counted aten op, most bytes first: what the regions'
            # bytes are made of.
            ops=[{"op": k, "calls": v[0], "flops": v[1], "bytes": v[2]}
                 for k, v in sorted(count.ops.items(),
                                    key=lambda kv: (-kv[1][2], kv[0]))],
        )
        report["notes"].append(
            "FLOPs: matmuls and convolutions (torch.utils.flop_counter) "
            "plus the hand-written kernels' own formulas; bytes: each op's "
            "inputs + outputs")

    if ms_per_step is not None:
        report["timing"] = {
            "ms_per_step": round(ms_per_step, 4),
            "steps": steps,
        }
        est = costs.mfu_from_timing(
            seconds=ms_per_step * 1e-3, steps=1, device_kind=device_kind,
            flops=report["totals"].get("flops_counted"),
        )
        if est["mfu"] is not None:
            report["timing"]["mfu"] = round(est["mfu"], 4)
        if batch:
            report["timing"]["emb_per_sec"] = round(
                batch / (ms_per_step * 1e-3), 1)

    if span_events is not None and wall_ms is not None:
        report["decomposition"] = decompose.decompose_step_time(
            span_events, wall_ms, serve=(step == "serve"))
    if span_events is not None and serve_spans:
        report["serve_latency"] = decompose.serve_latency_decomposition(
            span_events)
    return report


def validate_report(obj: Any) -> Optional[str]:
    """Schema check; returns an error string or None.  This IS the
    schema contract (the JAX package's, copied)."""
    from npairloss_tpu_torch.obs.perf.roofline import BOUND_CLASSES

    if not isinstance(obj, dict):
        return "report must be a JSON object"
    if obj.get("schema") != REPORT_SCHEMA:
        return f"schema must be {REPORT_SCHEMA!r}, got {obj.get('schema')!r}"
    if obj.get("step") not in ("train", "serve"):
        return f"step must be train|serve, got {obj.get('step')!r}"
    if not isinstance(obj.get("regions"), list):
        return "missing regions list"
    for i, row in enumerate(obj["regions"]):
        for key in REGION_KEYS:
            if key not in row:
                return f"region {i} missing {key!r}"
        if row["bound"] not in BOUND_CLASSES:
            return (f"region {i} bound {row['bound']!r} not in "
                    f"{BOUND_CLASSES}")
        if row["ai"] is not None and not isinstance(
                row["ai"], (int, float)):
            return f"region {i} ai is not numeric"
    dec = obj.get("decomposition")
    if dec is not None:
        for key in ("parts", "unattributed_ms", "wall_ms"):
            if key not in dec:
                return f"decomposition missing {key!r}"
        gap = (sum(dec["parts"].values()) + dec["unattributed_ms"]
               - dec["wall_ms"])
        if abs(gap) > 0.01:
            return (f"decomposition does not reconcile: parts + "
                    f"unattributed - wall = {gap:.4f} ms")
    return None


def render_table(report: Dict[str, Any]) -> str:
    """The human-readable counterpart of the JSON: region table +
    decomposition + timing, plain text."""
    lines = [
        f"perf report [{report['step']}] on {report['device_kind']!r}"
        + (f" batch={report['batch']}" if report.get("batch") else ""),
    ]
    peaks = report.get("peaks", {})
    if peaks:
        lines.append(
            f"roofline: peak {peaks['flops'] / 1e12:.0f} TF/s, HBM "
            f"{peaks['hbm_bytes_per_s'] / 1e9:.0f} GB/s, ridge AI "
            f"{peaks['ridge_ai']}"
            + ("" if peaks.get("known") else "  [fallback spec]"))
    t = report.get("timing")
    if t:
        lines.append(
            "timing: "
            + " ".join(f"{k}={v}" for k, v in sorted(t.items())))
    if report.get("regions"):
        lines.append("")
        hdr = (f"{'region':34s} {'flops':>12s} {'bytes':>12s} "
               f"{'AI':>8s} {'bound':>10s} {'%flops':>7s} "
               f"{'roofline_ms':>11s}")
        lines += [hdr, "-" * len(hdr)]
        for r in report["regions"]:
            ai = f"{r['ai']:.1f}" if r["ai"] is not None else "-"
            lines.append(
                f"{r['region'][:34]:34s} {r['flops']:12.3e} "
                f"{r['bytes']:12.3e} {ai:>8s} {r['bound']:>10s} "
                f"{r['pct_flops']:7.2f} {r['est_ms_at_roofline']:11.4f}")
    dec = report.get("decomposition")
    if dec:
        lines += ["", f"step-time decomposition (wall "
                  f"{dec['wall_ms']:.1f} ms):"]
        for cat, ms in dec["parts"].items():
            lines.append(f"  {cat:16s} {ms:10.3f} ms")
        lines.append(f"  {'unattributed':16s} "
                     f"{dec['unattributed_ms']:10.3f} ms")
    sl = report.get("serve_latency")
    if sl:
        lines += ["", "serve latency split (per span):"]
        for cat, row in sl.items():
            lines.append(
                f"  {cat:10s} p50={row['p50_ms']:8.3f} ms  "
                f"p99={row['p99_ms']:8.3f} ms  n={row['count']}")
    for note in report.get("notes", []):
        lines.append(f"note: {note}")
    return "\n".join(lines) + "\n"


def write_report(report: Dict[str, Any], out_dir: str,
                 name: str = "perf_report") -> Dict[str, str]:
    """Write ``<out_dir>/<name>.json`` + ``.txt`` (atomic tmp+rename);
    returns the paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for ext, payload in (
        ("json", json.dumps(report, indent=1, default=str) + "\n"),
        ("txt", render_table(report)),
    ):
        path = os.path.join(out_dir, f"{name}.{ext}")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(payload)
        os.replace(tmp, path)
        paths[ext] = path
    return paths
