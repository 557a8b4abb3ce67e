"""Roofline model: the card's peaks + bound-class classification; port
of ``npairloss_tpu/obs/perf/roofline.py`` and the one home of the
port's peaks (``parallel.plan`` reads them too).

Every region of a step is limited by whichever peak it saturates first:
the tensor cores (compute), HBM (memory) or the interconnect
(collective).  Given a region's FLOPs, bytes and collective bytes
(``obs.perf.count``):

    t_compute    = flops            / peak_flops
    t_memory     = bytes            / peak_hbm_bytes_per_s
    t_collective = collective_bytes / peak_nvlink_bytes_per_s
    bound        = argmax(t_*)
    est_s        = max(t_*)          # the roofline-optimal time

The peaks are the H100 SXM's data-sheet figures: dense bf16 989
TFLOP/s, HBM3 3.35 TB/s, NVLink 4 at 450 GB/s a direction between the
cards of a host, and 50 GB/s a card across hosts (one 400 Gb/s NIC per
card).  Any other kind is classified with those figures and flagged
``known=False``.  Stdlib only.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from npairloss_tpu_torch.obs.perf.costs import peak_flops

# Bound classes a region can carry (the report schema promises exactly
# these values, as the JAX package's does).
BOUND_CLASSES = ("compute", "memory", "collective", "unknown")

# Link kinds a collective can ride: within a host, across hosts.
LINK_KINDS = ("nvlink", "network")


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Per-card peaks: dense bf16 FLOP/s, HBM bytes/s, and bytes/s a
    direction per link kind (``LINK_KINDS``)."""

    device_kind: str
    flops: float
    hbm_bytes_per_s: float
    links: Dict[str, float]
    known: bool = True

    @property
    def ridge_ai(self) -> float:
        """FLOPs/byte at which compute and memory time are equal."""
        return self.flops / self.hbm_bytes_per_s

    @property
    def ici_bytes_per_s(self) -> float:
        """The within-host link (the JAX spec's ``ici``)."""
        return self.links["nvlink"]


H100_SXM = ChipSpec("NVIDIA H100 SXM", 989e12, 3.35e12,
                    {"nvlink": 450e9, "network": 50e9}, True)


def chip_peaks(device_kind: str = "") -> ChipSpec:
    """The peaks of ``device_kind`` (``torch.cuda.get_device_name``);
    another kind gets the H100 SXM's figures, ``known=False``."""
    if peak_flops(device_kind or "") == H100_SXM.flops:
        return H100_SXM
    return dataclasses.replace(H100_SXM, device_kind=device_kind or "unknown",
                               known=False)


def interconnect_peak(spec: ChipSpec, link: str) -> float:
    """Peak bytes/s a direction of the named link kind."""
    if link not in LINK_KINDS:
        raise ValueError(f"link must be one of {LINK_KINDS}, got {link!r}")
    return float(spec.links[link])


def classify(
    flops: float,
    bytes_accessed: float,
    collective_bytes: float = 0.0,
    spec: Optional[ChipSpec] = None,
) -> Dict[str, object]:
    """Roofline classification of one region; returns a dict with
    ``ai`` (flops/byte, None when bytes==0), ``bound`` (one of
    :data:`BOUND_CLASSES`), ``est_ms_at_roofline`` and the three time
    components (ms) behind the argmax.  A region with no cost at all
    classifies ``unknown``."""
    spec = spec if spec is not None else H100_SXM
    t_c = max(flops, 0.0) / spec.flops
    t_m = max(bytes_accessed, 0.0) / spec.hbm_bytes_per_s
    t_i = max(collective_bytes, 0.0) / spec.ici_bytes_per_s
    times = {"compute": t_c, "memory": t_m, "collective": t_i}
    if t_c == t_m == t_i == 0.0:
        bound = "unknown"
    else:
        # Deterministic tie-break in BOUND_CLASSES order (compute wins
        # an exact compute/memory tie — it sits ON the ridge).
        bound = max(BOUND_CLASSES[:3], key=lambda k: times[k])
    ai = (flops / bytes_accessed) if bytes_accessed > 0 else None
    return {
        "ai": ai,
        "bound": bound,
        "est_ms_at_roofline": max(t_c, t_m, t_i) * 1e3,
        "compute_ms": t_c * 1e3,
        "memory_ms": t_m * 1e3,
        "collective_ms": t_i * 1e3,
    }
