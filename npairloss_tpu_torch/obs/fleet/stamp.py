"""Rank identity for fleet telemetry — who wrote this row/span/file?
Port of ``npairloss_tpu/obs/fleet/stamp.py`` (a copy of its stamp,
its path scheme and its tolerant JSON reader).

``FleetStamp`` is the identity every fleet-aware artifact carries:
``{process_index, process_count, local_device_ids}`` stamped on metric
rows, into trace metadata and into the manifest — and the rank-aware
path scheme (``telemetry.r<k>.jsonl``) that keeps concurrent ranks from
interleaving one stream.

Resolution order for the ambient stamp:

  1. ``NPAIRLOSS_FLEET_PROCESS="<rank>/<count>"`` — the explicit
     override for harnesses that run N cooperating processes without a
     process group;
  2. the ``torch.distributed`` group's rank and world size — but only
     when a group is ALREADY initialized (telemetry never initializes a
     backend), with the device this process bound
     (``parallel.distributed``) as its local device;
  3. None — no fleet identity; telemetry behaves exactly as without.

Stdlib only at import time.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import sys
from typing import Any, Dict, List, Optional


def load_json(path: str) -> Optional[Dict[str, Any]]:
    """Tolerant JSON-object load for fleet artifacts: unreadable,
    unparseable or non-object content is None, never fatal — the
    aggregation and merge readers report what is missing instead of
    dying on one rank's torn file."""
    try:
        with open(path) as f:
            obj = json.load(f)
        return obj if isinstance(obj, dict) else None
    except (OSError, ValueError):
        return None


# Env override: "<rank>/<count>", e.g. "1/2".
FLEET_PROCESS_ENV = "NPAIRLOSS_FLEET_PROCESS"

# The keys a fleet stamp contributes to every metric row (see
# obs.sinks.FLEET_KEYS for the stdlib-only re-export).
STAMP_KEYS = ("process_index", "process_count", "local_device_ids")


@dataclasses.dataclass(frozen=True)
class FleetStamp:
    """One process's identity in the fleet."""

    process_index: int
    process_count: int
    local_device_ids: tuple = ()

    def __post_init__(self):
        if not (0 <= self.process_index < self.process_count):
            raise ValueError(
                f"process_index {self.process_index} outside "
                f"[0, {self.process_count})"
            )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "process_index": self.process_index,
            "process_count": self.process_count,
            "local_device_ids": list(self.local_device_ids),
        }


def _group_stamp() -> Optional[FleetStamp]:
    """The initialized ``torch.distributed`` group's identity, or None
    (no torch loaded, no group, or any error asking)."""
    dist = sys.modules.get("torch.distributed")
    if dist is None:
        return None
    try:
        if not (dist.is_available() and dist.is_initialized()):
            return None
        ids: tuple = ()
        mod = sys.modules.get("npairloss_tpu_torch.parallel.distributed")
        bound = mod.bound_device() if mod is not None else None
        if bound is not None and bound.index is not None:
            ids = (int(bound.index),)
        return FleetStamp(dist.get_rank(), dist.get_world_size(), ids)
    except Exception:
        return None


def fleet_stamp() -> Optional[FleetStamp]:
    """The ambient stamp per the resolution order above (None when no
    fleet identity is declared or derivable)."""
    override = os.environ.get(FLEET_PROCESS_ENV, "").strip()
    if override:
        m = re.fullmatch(r"(\d+)/(\d+)", override)
        if not m:
            raise ValueError(
                f"{FLEET_PROCESS_ENV}={override!r} is not '<rank>/<count>'"
            )
        return FleetStamp(int(m.group(1)), int(m.group(2)))
    return _group_stamp()


def resolve_fleet(fleet) -> Optional[FleetStamp]:
    """Normalize a ``fleet=`` argument: None/False = off, True = the
    ambient stamp (rank 0 of 1 when nothing else is declared — an
    explicitly-requested single-process fleet still stamps), a
    FleetStamp passes through."""
    if fleet is None or fleet is False:
        return None
    if fleet is True:
        return fleet_stamp() or FleetStamp(0, 1)
    if isinstance(fleet, FleetStamp):
        return fleet
    raise TypeError(f"fleet must be None/bool/FleetStamp, got {fleet!r}")


# -- the rank-aware path scheme ----------------------------------------------

# Per-rank file names inside a fleet run directory.  The METRICS stream
# deliberately changes base name (metrics.jsonl -> telemetry.r<k>.jsonl)
# so a single-process consumer reading ``metrics.jsonl`` can never
# half-read one rank of a fleet run and mistake it for the whole run.
TELEMETRY_PATTERN = "telemetry.r{rank}.jsonl"
TRACE_PATTERN = "trace.r{rank}.json"
MANIFEST_PATTERN = "manifest.r{rank}.json"

_RANK_FILE_RE = re.compile(
    r"^(?:telemetry|trace|manifest)\.r(\d+)\.(?:jsonl|json)$")


def rank_metrics_name(rank: int) -> str:
    return TELEMETRY_PATTERN.format(rank=int(rank))


def rank_trace_name(rank: int) -> str:
    return TRACE_PATTERN.format(rank=int(rank))


def rank_manifest_name(rank: int) -> str:
    return MANIFEST_PATTERN.format(rank=int(rank))


def rank_of_file(name: str) -> Optional[int]:
    """The rank a fleet file name belongs to, or None for non-fleet
    names (``metrics.jsonl``, ``trace.json``, ...)."""
    m = _RANK_FILE_RE.match(os.path.basename(name))
    return int(m.group(1)) if m else None


def discover_ranks(run_dir: str) -> List[int]:
    """Sorted ranks that left ANY per-rank file in ``run_dir``."""
    ranks = set()
    try:
        names = os.listdir(run_dir)
    except OSError:
        return []
    for name in names:
        r = rank_of_file(name)
        if r is not None:
            ranks.add(r)
    return sorted(ranks)
