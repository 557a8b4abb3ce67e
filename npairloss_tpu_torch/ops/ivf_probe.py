"""Fused IVF probe: gather + score + top-k in one kernel launch.

Port of ``npairloss_tpu/ops/pallas_ivf.py``.  The probe set comes from
stage 1 — one small centroid matmul in fp32, invalid clusters masked to
-FLT_MAX, and a top-C pick with the lowest index winning ties (a stable
descending sort, because ``torch.topk`` promises no tie order).  Stage 2
is :func:`probe_topk`, the wrapper of the hand-written kernel in
``csrc/ivf_probe.cu``: on a CPU tensor it runs
:func:`probe_topk_oneshot_plain`, on a CUDA tensor it launches the
kernel or raises.

The Pallas kernel merges each probe's tile into a running top-kl, one
probe after another.  That merge equals one stable top-kl over the
concatenation ``[kl fillers (-FLT_MAX, row 0); probe 0's cap slots;
probe 1's; ...]`` (each slot of the running best precedes each slot of
the next tile, and a dropped slot stays beaten), which the kernel
computes in parallel over the 64-bit keys of :func:`probe_keys`: one
thread-block cluster per query, each CTA streaming one row chunk of
every probed cluster through a ring of bulk copies, the CTAs' top-kl
merged through distributed shared memory.  Its shared memory no longer
grows with the cluster capacity, so any cap runs; kl is capped at
``MAX_KL``.  The bound is the probed rows' bytes, per (query, probe),
over the card's 3.35 TB/s.
:func:`probe_topk_oneshot_plain` is that closed form in plain torch,
:func:`probe_topk_plain` the sequential merge; both give the same bits.

Slots of the ``(B, kl)`` result that hold no real candidate carry
-FLT_MAX and row 0.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from npairloss_tpu_torch.obs.perf.count import priced
from npairloss_tpu_torch.ops._build import (
    bump,
    check,
    counted,
    library,
    stream_ptr,
)

# The probe-impl registry: the CLI's --probe-impl vocabulary.
# ``dispatch_count`` is the declared number of stages on the probe path
# (centroid pick / gather / score / merge for the scan; centroid pick /
# one fused kernel for ``fused``).
PROBE_IMPLS = {
    "scan": {"dispatch_count": 4, "kernel": False},
    "fused": {"dispatch_count": 2, "kernel": True},
    "auto": {"dispatch_count": 0, "kernel": False},
}

NEG_FILL = float(-np.finfo(np.float32).max)

_SCORING_CODES = {"fp32": 0, "bf16": 1, "int8": 2}
_SLAB_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16,
                "int8": torch.int8}
# The kernel's largest kl (its per-warp key lists live in shared memory).
MAX_KL = 256
_U32 = 0xFFFFFFFF


def resolve_probe_impl(impl: str, device: torch.device) -> str:
    """``auto`` -> ``fused`` on CUDA (the kernel), ``scan`` on the CPU."""
    if impl not in PROBE_IMPLS:
        raise ValueError(
            f"probe_impl must be one of {sorted(PROBE_IMPLS)}, got {impl!r}")
    if impl != "auto":
        return impl
    return "fused" if torch.device(device).type == "cuda" else "scan"


def probe_select(q: torch.Tensor, centroids: torch.Tensor,
                 cvalid: torch.Tensor, probes: int, g0: int,
                 kc_local: int) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Stage 1: ``(probe, lids, owned)``, each (B, C) — the probed global
    cluster ids (highest centroid score first, lowest id on ties), the
    local slab index of each, and whether this slab owns it."""
    c = min(int(probes), int(centroids.shape[0]))
    cs = q @ centroids.T
    cs = torch.where(cvalid[None, :], cs,
                     torch.tensor(NEG_FILL, dtype=cs.dtype, device=cs.device))
    probe = torch.sort(cs, dim=1, descending=True, stable=True).indices[:, :c]
    owned = (probe >= g0) & (probe < g0 + kc_local)
    lids = torch.where(owned, probe - g0, 0).to(torch.int32)
    return probe, lids, owned


def score_query(scoring: str, q: torch.Tensor) -> torch.Tensor:
    """The query as the scoring mode sees it: fp32 as is, bf16 and int8
    rounded to bf16 (held in fp32)."""
    return q if scoring == "fp32" else q.to(torch.bfloat16).float()


def _probe_tile(qs, packed, rows, lids, owned, scale, j):
    """Probe j's (B, cap) scores, masked to -FLT_MAX, and rows."""
    lid = lids[:, j].long()
    g = packed[lid].float()           # (B, cap, D), exact upcast
    r = rows[lid]                     # (B, cap)
    sims = torch.bmm(g, qs[:, :, None])[:, :, 0]
    if scale is not None:
        sims = sims * scale[lid][:, None]
    ok = (r >= 0) & owned[:, j:j + 1].bool()
    return torch.where(ok, sims, torch.full_like(sims, NEG_FILL)), r


def probe_keys(scores: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The kernel's 64-bit candidate keys, as int64: the order-preserving
    bits of the fp32 score (-0.0 taken as +0.0, which the merge's ``>``
    ties with it) in the high word, ``0xFFFFFFFF - pos`` in the low one.
    A larger key is a higher score, then a lower position."""
    s = torch.where(scores == 0, torch.zeros_like(scores), scores)
    u = s.float().contiguous().view(torch.int32).long() & _U32
    hi = torch.where(u >= 1 << 31, _U32 - u, u | (1 << 31))
    return ((hi - (1 << 31)) << 32) | (_U32 - pos.long())


def probe_topk_oneshot_plain(q, packed, rows, lids, owned, scale, *,
                             kl: int, scoring: str
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in plain torch: score every probed slot in
    fp32 (per probe, as :func:`probe_topk_plain`), put the kl fillers
    (-FLT_MAX, row 0) in front, and keep the kl largest
    :func:`probe_keys` of the concatenation at once.  A slot whose score
    is not above -FLT_MAX loses to every filler, as in the kernel."""
    bq, c = lids.shape
    qs = score_query(scoring, q)
    tiles = [_probe_tile(qs, packed, rows, lids, owned, scale, j)
             for j in range(c)]
    vals = torch.cat([torch.full((bq, kl), NEG_FILL, dtype=torch.float32,
                                 device=q.device)]
                     + [v for v, _ in tiles], dim=1)
    work_r = torch.cat([torch.zeros((bq, kl), dtype=torch.int32,
                                    device=q.device)]
                       + [r for _, r in tiles], dim=1)
    vals = torch.where(vals > NEG_FILL, vals, torch.full_like(vals,
                                                              NEG_FILL))
    pos = torch.arange(vals.shape[1], device=q.device)
    sel = torch.topk(probe_keys(vals, pos[None, :]), kl, dim=1).indices
    return torch.gather(vals, 1, sel), torch.gather(work_r, 1, sel)


def probe_topk_plain(q, packed, rows, lids, owned, scale, *, kl: int,
                     scoring: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Pallas kernel's sequential merge in plain torch: per probe,
    score the gathered cluster in fp32, mask, and keep the top-kl of
    [running best ; tile] by a stable descending sort (lowest position
    wins ties)."""
    bq, c = lids.shape
    qs = score_query(scoring, q)
    best_s = torch.full((bq, kl), NEG_FILL, dtype=torch.float32,
                        device=q.device)
    best_r = torch.zeros((bq, kl), dtype=torch.int32, device=q.device)
    for j in range(c):
        vals, r = _probe_tile(qs, packed, rows, lids, owned, scale, j)
        work_v = torch.cat([best_s, vals], dim=1)
        work_r = torch.cat([best_r, r], dim=1)
        sel = torch.sort(work_v, dim=1, descending=True,
                         stable=True).indices[:, :kl]
        best_s = torch.gather(work_v, 1, sel)
        best_r = torch.gather(work_r, 1, sel)
    return best_s, best_r


def _probe_cost(q, packed, rows, lids, owned, scale=None, *, kl, scoring):
    """FLOPs and bytes of one probe (``obs.perf.count``): a 2·D score
    for every slot of every probed cluster of every query; the queries,
    those slabs (each query's probes read once), their row ids and the
    (B, kl) outputs."""
    bq, d = (int(v) for v in q.shape)
    cap = int(packed.shape[1])
    probed = bq * int(lids.shape[1]) * cap
    return (2 * probed * d,
            q.numel() * 4 + probed * (d * packed.element_size() + 4)
            + bq * kl * 8)


@counted
@priced("probe_topk", _probe_cost)
def probe_topk(q, packed, rows, lids, owned, scale=None, *, kl: int,
               scoring: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage 2 — score the probed clusters and keep a running top-kl.

    ``q`` (B, D) fp32; ``packed`` (KC, cap, D) in the scoring dtype;
    ``rows`` (KC, cap) int32 global row ids (-1 = pad); ``lids``/``owned``
    (B, C) from :func:`probe_select`; ``scale`` (KC,) fp32 for int8.
    Returns (B, kl) scores and global rows."""
    if scoring not in _SCORING_CODES:
        raise ValueError(f"scoring must be one of {sorted(_SCORING_CODES)}")
    if q.device.type == "cpu":
        return probe_topk_oneshot_plain(q, packed, rows, lids, owned, scale,
                                        kl=kl, scoring=scoring)
    if q.device.type != "cuda":
        raise ValueError(f"probe_topk: unsupported device {q.device}")
    bq, d = (int(s) for s in q.shape)
    kc, cap, d2 = (int(s) for s in packed.shape)
    c = int(lids.shape[1])
    want = [
        ("q", q, torch.float32, (bq, d)),
        ("packed", packed, _SLAB_DTYPES[scoring], (kc, cap, d)),
        ("rows", rows, torch.int32, (kc, cap)),
        ("lids", lids, torch.int32, (bq, c)),
        ("owned", owned, torch.int32, (bq, c)),
    ]
    if scale is not None:
        want.append(("scale", scale, torch.float32, (kc,)))
    for name, t, dtype, shape in want:
        if t.device != q.device or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"probe_topk: {name} must be a contiguous {dtype} tensor of "
                f"shape {shape} on {q.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if d2 != d:
        raise ValueError(f"probe_topk: slab dim {d2} != query dim {d}")
    if scale is not None and scoring != "int8":
        raise ValueError("probe_topk: a scale goes with int8 scoring only")
    if not 1 <= kl <= MAX_KL:
        raise ValueError(f"probe_topk: kl {kl} outside the kernel's "
                         f"1..{MAX_KL}")
    out_s = torch.empty((bq, kl), dtype=torch.float32, device=q.device)
    out_r = torch.empty((bq, kl), dtype=torch.int32, device=q.device)
    err = library().npl_ivf_probe(
        q.data_ptr(), packed.data_ptr(), rows.data_ptr(), lids.data_ptr(),
        owned.data_ptr(), scale.data_ptr() if scale is not None else None,
        out_s.data_ptr(), out_r.data_ptr(), bq, c, cap, d, int(kl),
        _SCORING_CODES[scoring], stream_ptr(q.device))
    check(err, "probe_topk")
    bump(probe_topk)
    return out_s, out_r


def fused_probe_topk(q, packed, rows, centroids, cvalid,
                     scale: Optional[torch.Tensor] = None, *, k: int,
                     probes: int, scoring: str, g0: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in fused twin of the engine's scan: same operands, same
    ``(B, kl)`` scores + global rows, kl = min(k, C * cap)."""
    kc_local, cap, _ = packed.shape
    c = min(int(probes), int(centroids.shape[0]))
    kl = min(int(k), c * int(cap))
    _, lids, owned = probe_select(q, centroids, cvalid, probes, g0,
                                  int(kc_local))
    return probe_topk(q.contiguous(), packed, rows, lids,
                      owned.to(torch.int32).contiguous(),
                      scale, kl=kl, scoring=scoring)
