"""Collective/comms attribution — what does the interconnect carry per
step?  Port of ``npairloss_tpu/obs/fleet/comms.py``.

The source paper's step is two collectives (MPI_Allgather of embeddings,
MPI_Allreduce of gradients).  This module joins three sources into
per-step comms rows:

  * **declared claims** — every collective of ``parallel.mesh``
    (``all_gather``, ``all_reduce_sum``, ``all_reduce_max``, ``shift``)
    declares its payload and its op to the step counter
    (``obs.perf.count.collective``), which files the bytes under a
    ``comm/<op>`` region: the port's counterpart of the JAX package's
    ``jax.named_scope("comm/<kind>")`` markers; :data:`KIND_OF_OP` maps
    the ops to the kinds the report speaks in;
  * **pricing** — the counted step's per-op collective bytes
    (``StepCounter.collectives``: the output's bytes, the JAX package's
    HLO convention), folded per kind; the JAX package parses the
    compiled HLO instead, which also sees the all-reduces XLA inserts on
    its own.  The count sees only collectives that go through the mesh,
    so a collective priced without its op is unclaimed;
  * **measured step time** — the per-rank step cadence from the fleet
    telemetry streams, giving each kind an *effective bandwidth
    demand* ``bytes_per_step / step_time``: the rate the link would
    sustain if the collective took the whole step.  No per-collective
    latency is measured.

Links are the process group's backend: ``nccl`` (NVLink between the
cards of one host, the network across hosts: the H100 SXM's published
figures, ``obs.perf.roofline``) and ``gloo`` (staged through host
memory: no published figure, so its peak is ``None`` and only the
demand is reported).

Reconciliation contract, as in JAX: every priced byte must belong to a
*claimed kind* — one some ``comm/<op>`` declaration (or the solver's
gradient all-reduce claim) vouches for; ``unattributed_bytes`` sums the
kinds nobody claims.  ``scope_coverage`` is the share of a kind's bytes
inside a declared ``comm/`` region.

Stdlib only (dicts in, dicts out).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

# Mesh collective op -> the comm kind the fleet report speaks in (the
# JAX package's KIND_OF_OPCODE, keyed by the port's collectives).
KIND_OF_OP = {
    "all_gather": "all_gather",
    "all_reduce_sum": "allreduce",
    "all_reduce_max": "allreduce",
    "shift": "ppermute",
}

# The region marker a declared collective carries.
COMM_SCOPE_MARKER = "comm/"

# Process-group backends a collective can ride.
LINKS = ("nccl", "gloo")


def per_kind_from_counts(collectives: Dict[str, Dict[str, Any]]
                         ) -> Dict[str, Dict[str, Any]]:
    """``StepCounter.collectives`` (per op) -> per comm KIND
    ``{"bytes", "count", "regions", "ops"}``: the payload's
    ``per_kind``.  An op outside :data:`KIND_OF_OP` keeps its own name
    as its kind."""
    out: Dict[str, Dict[str, Any]] = {}
    for op, row in sorted(collectives.items()):
        kind = KIND_OF_OP.get(op, op)
        k = out.setdefault(kind, {"bytes": 0.0, "count": 0.0,
                                  "regions": {}, "ops": []})
        k["bytes"] += float(row.get("bytes", 0))
        k["count"] += float(row.get("count", 0))
        for region, b in (row.get("regions") or {}).items():
            k["regions"][region] = k["regions"].get(region, 0.0) + float(b)
        k["ops"].append(op)
    return out


def _scoped_bytes(regions: Dict[str, float]) -> float:
    """Bytes of a kind whose region carries the ``comm/`` marker."""
    return float(sum(
        b for region, b in regions.items() if COMM_SCOPE_MARKER in region
    ))


def comm_rows_from_counts(
    per_kind: Dict[str, Dict[str, Any]],
    extra_claims: Optional[Dict[str, float]] = None,
) -> Dict[str, Any]:
    """Fold the payload's ``per_kind`` into per-KIND rows plus the
    reconciliation verdict (the JAX package's ``comm_rows_from_hlo``,
    key for key; ``opcodes`` lists the mesh ops behind a kind).

    ``extra_claims``: kind -> bytes claimed by instrumentation outside
    the count (the solver's gradient all-reduce claim, priced from the
    parameter tree).  A kind counts as claimed when it has declared
    bytes OR an extra claim."""
    extra_claims = dict(extra_claims or {})
    kinds: Dict[str, Dict[str, Any]] = {}
    for kind, row in per_kind.items():
        k = kinds.setdefault(kind, {
            "kind": kind, "bytes_per_step": 0.0, "count_per_step": 0.0,
            "scope_bytes": 0.0, "opcodes": [],
        })
        k["bytes_per_step"] += float(row.get("bytes", 0.0))
        k["count_per_step"] += float(row.get("count", 0.0))
        k["scope_bytes"] += _scoped_bytes(row.get("regions", {}))
        k["opcodes"].extend(row.get("ops") or [kind])
    unattributed = 0.0
    for kind, k in sorted(kinds.items()):
        claimed_extra = float(extra_claims.get(kind, 0.0))
        k["claimed"] = bool(k["scope_bytes"] > 0.0 or claimed_extra > 0.0)
        k["claim_bytes"] = k["scope_bytes"] + claimed_extra
        k["scope_coverage"] = (
            round(k["scope_bytes"] / k["bytes_per_step"], 4)
            if k["bytes_per_step"] > 0 else None
        )
        k["opcodes"] = sorted(set(k["opcodes"]))
        if not k["claimed"]:
            unattributed += k["bytes_per_step"]
    return {
        "kinds": [kinds[k] for k in sorted(kinds)],
        "unattributed_bytes": unattributed,
        "total_bytes_per_step": float(
            sum(k["bytes_per_step"] for k in kinds.values())),
    }


def grad_sync_claim_bytes(param_bytes: float,
                          process_count: int) -> Dict[str, float]:
    """The solver's claim for the gradient all-reduce: one gradient
    tree per step, output bytes = the parameter tree's own size (the
    output-shape convention of the pricing).  The solver claims it only
    over a mesh of more than one shard."""
    if process_count <= 0:
        raise ValueError(f"process_count must be positive: {process_count}")
    return {"allreduce": float(param_bytes)} if param_bytes > 0 else {}


def link_peak(device_kind: str, link: str,
              hosts: int = 1) -> Dict[str, Any]:
    """``{"peak_bytes_per_s", "peak_known", "peak_source"}`` of a link:
    ``nccl`` rides NVLink within one host and the network across hosts
    (the card's published figures; another card gets the H100 SXM's,
    ``peak_known`` False); ``gloo`` stages through host memory and has
    no published figure (``None``)."""
    from npairloss_tpu_torch.obs.perf.roofline import (
        chip_peaks,
        interconnect_peak,
    )

    if link not in LINKS:
        raise ValueError(f"link must be one of {LINKS}, got {link!r}")
    if link == "gloo":
        return {"peak_bytes_per_s": None, "peak_known": None,
                "peak_source": "gloo through host memory: no published "
                               "peak"}
    spec = chip_peaks(device_kind)
    wire = "nvlink" if hosts <= 1 else "network"
    return {"peak_bytes_per_s": interconnect_peak(spec, wire),
            "peak_known": spec.known,
            "peak_source": f"{spec.device_kind} {wire}"}


def effective_bandwidth(
    comm: Dict[str, Any],
    ms_per_step: Optional[float],
    device_kind: str,
    link: str,
    hosts: int = 1,
) -> Dict[str, Any]:
    """Attach the per-kind effective-bandwidth-demand columns and the
    link's peak to a :func:`comm_rows_from_counts` result (a copy; the
    input is not changed).  ``link_utilization`` is None where the link
    has no peak."""
    peak = link_peak(device_kind, link, hosts)
    out = {
        **{k: v for k, v in comm.items() if k != "kinds"},
        "link": link,
        **peak,
        "ms_per_step": ms_per_step,
        "kinds": [],
    }
    p = peak["peak_bytes_per_s"]
    for k in comm["kinds"]:
        row = dict(k)
        if ms_per_step and ms_per_step > 0:
            bps = row["bytes_per_step"] / (ms_per_step * 1e-3)
            row["effective_bytes_per_s"] = bps
            row["link_utilization"] = round(bps / p, 4) if p else None
        else:
            row["effective_bytes_per_s"] = None
            row["link_utilization"] = None
        out["kinds"].append(row)
    return out
