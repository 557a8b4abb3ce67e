"""The ONE MFU helper — port of ``npairloss_tpu/obs/perf/costs.py``.

Every ``mfu`` number the port prints goes through
:func:`mfu_from_timing`.  The step's FLOPs come from the port's counter
(``obs.perf.count``): matmul and convolution FLOPs plus the hand-written
kernels' own formulas — where the JAX package reads XLA's
``cost_analysis()`` of the lowered program.

Stdlib only.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

# Peak dense bf16 FLOP/s per card by ``torch.cuda.get_device_name``
# substring (data-sheet figures); used only for MFU and roofline
# estimates.  First match wins.
PEAK_FLOPS = [
    ("H100", 989e12),
]


def peak_flops(device_kind: str) -> Optional[float]:
    """Peak dense bf16 FLOP/s for a device kind, or None if unknown."""
    kind = (device_kind or "").lower()
    for key, peak in PEAK_FLOPS:
        if key.lower() in kind:
            return peak
    return None


def mfu_from_timing(
    *,
    flops: Optional[float],
    seconds: float,
    steps: int = 1,
    device_kind: str = "",
) -> Dict[str, Any]:
    """``flops * steps / seconds`` against the card's peak.

    ``flops`` is one step's count; ``seconds`` the wall time of
    ``steps`` steps.  Returns ``{"step_flops": float|None, "mfu":
    float|None}`` — keys always present, values None when the estimate
    is unavailable (no count, unknown card, non-positive timing)."""
    mfu = None
    peak = peak_flops(device_kind) if device_kind else None
    if flops and peak and seconds > 0 and steps > 0:
        mfu = (flops * steps / seconds) / peak
    return {"step_flops": flops, "mfu": mfu}
