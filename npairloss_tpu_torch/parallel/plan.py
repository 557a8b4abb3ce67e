"""Which exchange pattern should this mesh run? — port of
``npairloss_tpu/parallel/plan.py``, the same decision rule over the
card's own peaks.

  * **dense** all-gathers the whole pool before the similarity matmul:
    lowest latency on a fast link, but the gather gates the matmul;
  * **ring** streams the pool over point-to-point hops, one block
    matmul per hop: a hop that fits under the previous hop's compute
    costs (almost) nothing, which pays across hosts.

``plan_engine`` is pure arithmetic over the mesh's host topology and
the card's peaks; its :class:`EnginePlan` says why, and ``train``
stamps it into the run's record.  ``ring_device_order`` keeps ranks host-major,
so one rotation crosses the network once per host boundary.

The peaks are ``obs.perf.roofline``'s (the one table the roofline and
the planner share): the H100 SXM's data-sheet figures, dense bf16 989
TFLOP/s; NVLink 4 at 450 GB/s a direction between the cards of a host;
50 GB/s a card across hosts (one 400 Gb/s NIC per card).  Any other
kind is planned with those figures and flagged ``peak_known=False``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence

from npairloss_tpu_torch.obs.perf.roofline import (  # noqa: F401
    H100_SXM,
    ChipSpec,
    chip_peaks,
    interconnect_peak,
)

# A dense per-shard similarity block bigger than this routes to the
# streaming engine even on a single host (memory, not bandwidth).
DENSE_SIM_BUDGET_BYTES = 2 << 30
# Bytes of one embedding element on the wire (fp32 features).
ITEMSIZE = 4


def ring_device_order(devices: Sequence) -> List:
    """Host-major order: all of host 0's ranks, then host 1's, ...; a
    ring over it crosses the network once per host boundary.  Within a
    host, id (rank) order."""
    return sorted(devices,
                  key=lambda d: (getattr(d, "process_index", 0), d.id))


def host_counts(devices: Sequence) -> Dict[int, int]:
    """Rank count per host."""
    counts: Dict[int, int] = {}
    for d in devices:
        p = int(getattr(d, "process_index", 0))
        counts[p] = counts.get(p, 0) + 1
    return counts


@dataclasses.dataclass(frozen=True)
class EnginePlan:
    """One auditable engine decision (the JAX package's fields)."""

    engine: str                  # the choice: "dense" | "ring"
    requested: str               # what the caller asked ("auto" or explicit)
    link: str                    # slowest link a collective crosses
    devices: int
    hosts: int
    shard_rows: int              # batch rows per mesh shard
    emb_dim: int
    hop_bytes: float             # one ring hop's payload per device
    gather_bytes: float          # dense all_gather receive per device
    dense_sim_bytes: float       # per-shard similarity block, fp32
    peak_bytes_per_s: float      # the link's peak
    peak_known: bool
    t_hop_comm_us: float         # hop transfer at link peak
    t_hop_compute_us: float      # per-hop sim block matmul at chip peak
    comm_hidden: bool            # hop transfer fits under hop compute
    cross_host_hops: int         # network crossings per ring rotation
    device_kind: str
    reason: str

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def plan_engine(n_devices: int, n_hosts: int, shard_rows: int, emb_dim: int,
                device_kind: str = "", requested: str = "auto"
                ) -> EnginePlan:
    """The JAX package's rule (``plan.py:88-183``): one hop's transfer at
    the slowest link's peak against the hop's sim-block matmul at the
    chip's peak; across hosts the ring wins when the transfer hides,
    else dense; on one host dense wins unless its per-shard similarity
    block passes ``DENSE_SIM_BUDGET_BYTES``; an explicit ``requested`` engine
    is honored, the plan recording what auto would have said."""
    if n_devices < 1 or n_hosts < 1 or n_hosts > n_devices:
        raise ValueError(
            f"bad topology: {n_devices} devices / {n_hosts} hosts")
    if requested not in ("auto", "dense", "ring", "blockwise"):
        raise ValueError(f"unknown engine {requested!r}")
    spec = chip_peaks(device_kind)
    link = "network" if n_hosts > 1 else "nvlink"
    peak = interconnect_peak(spec, link)
    hop_bytes = float(shard_rows) * emb_dim * ITEMSIZE
    gather_bytes = hop_bytes * max(n_devices - 1, 0)
    pool_rows = shard_rows * n_devices
    dense_sim_bytes = float(shard_rows) * pool_rows * 4  # fp32 sim block
    t_hop_comm = hop_bytes / peak if peak else float("inf")
    t_hop_compute = (2.0 * shard_rows * shard_rows * emb_dim) / spec.flops
    comm_hidden = t_hop_comm <= t_hop_compute
    cross_host_hops = n_hosts if n_hosts > 1 else 0

    if n_devices == 1:
        auto, why = "dense", "single shard: nothing to exchange"
    elif dense_sim_bytes > DENSE_SIM_BUDGET_BYTES:
        auto, why = "ring", (
            f"the dense per-shard similarity block is "
            f"{dense_sim_bytes / 1e9:.2f} GB (> "
            f"{DENSE_SIM_BUDGET_BYTES / 1e9:.2f} GB budget) over {link}: "
            "stream it")
    elif n_hosts > 1:
        if comm_hidden:
            auto, why = "ring", (
                f"cross-host ({n_hosts} hosts over {link}): a "
                f"{hop_bytes / 1e6:.2f} MB hop "
                f"({t_hop_comm * 1e6:.0f} us at {peak / 1e9:.0f} GB/s) "
                f"hides under the {t_hop_compute * 1e6:.0f} us per-hop "
                "sim matmul — streamed hops cost ~nothing")
        else:
            auto, why = "dense", (
                f"cross-host but a {hop_bytes / 1e6:.2f} MB hop "
                f"({t_hop_comm * 1e6:.0f} us at {peak / 1e9:.0f} GB/s) "
                f"does NOT hide under {t_hop_compute * 1e6:.0f} us of "
                f"per-hop compute: {n_devices - 1} exposed hops would "
                "cost more than one fused all_gather")
    else:
        auto, why = "dense", (
            f"single host over {link}: one fused all_gather "
            f"({gather_bytes / 1e6:.2f} MB/device at "
            f"{peak / 1e9:.0f} GB/s) beats {max(n_devices - 1, 0)} "
            "serialized hops")
    if not spec.known:
        why += (f" (no peaks for {spec.device_kind!r}: planned with the "
                "H100 SXM's)")

    if requested != "auto":
        engine = requested
        reason = (f"explicit --engine {requested} "
                  f"(auto would pick {auto}: {why})")
    else:
        engine, reason = auto, why
    return EnginePlan(
        engine=engine, requested=requested, link=link,
        devices=int(n_devices), hosts=int(n_hosts),
        shard_rows=int(shard_rows), emb_dim=int(emb_dim),
        hop_bytes=hop_bytes, gather_bytes=gather_bytes,
        dense_sim_bytes=dense_sim_bytes,
        peak_bytes_per_s=peak, peak_known=spec.known,
        t_hop_comm_us=t_hop_comm * 1e6,
        t_hop_compute_us=t_hop_compute * 1e6,
        comm_hidden=comm_hidden, cross_host_hops=cross_host_hops,
        device_kind=device_kind or spec.device_kind, reason=reason,
    )


def plan_for_mesh(mesh, global_batch: int, emb_dim: int,
                  requested: str = "auto") -> EnginePlan:
    """``plan_engine`` over a live mesh: hosts from its ranks' host
    names, shard rows from the global batch over the mesh."""
    devices = mesh.devices()
    hosts = len(host_counts(devices))
    shard_rows = max(int(global_batch) // max(mesh.size, 1), 1)
    return plan_engine(
        n_devices=len(devices), n_hosts=hosts, shard_rows=shard_rows,
        emb_dim=emb_dim, device_kind=mesh.device_kind, requested=requested,
    )
