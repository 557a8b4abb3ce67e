"""Multi-class N-pair loss with the reference's full mining grid — the
dense engine.  Port of ``npairloss_tpu/ops/npair_loss.py:110-762``.

The JAX package computes this loss with XLA, not Pallas, so the port is
plain torch: the similarity matrix is one matmul (cuBLAS on the card,
fp32 with TF32 off — ``device.set_parity_precision``), mining statistics
are masked reductions and one sort, the loss a stabilized masked softmax.

Semantics are the JAX package's, quirk for quirk:
  * RAND selects ALL pairs (reference cu:88-89, cu:109-110);
  * RELATIVE thresholds index an ascending-sorted list at
    ``_relative_pos`` (fp32 truncation for int32 counts) and clamp a
    value below 0 to -FLT_MAX; an empty list gives +FLT_MAX;
  * the self pair (row q vs gathered column ``rank*N + q``) is excluded;
  * zero-count queries contribute exactly 0 loss, with ``where``-based
    masking (a query with no pairs has max_all = -FLT_MAX and an inf
    exponential that a multiplicative mask would turn into NaN);
  * the reference backward (cu:420-499): 0-guarded p1/p2/p3, ``w``
    scaled by g/N, the database-role grad all-reduced and divided by G,
    then ``0.5 * own rows + 0.5 * query role``.

``matmul_precision`` (the JAX engine's knob): ``None``/``"highest"``
compute the sim product and both backward products in full fp32;
``"default"`` is the single-pass bf16 mode — every operand of those
three products, the backward's coefficient matrix included, rounded to
bf16 (round to nearest even), the products accumulated in fp32.  A
product of two bf16 values is exact in fp32, so this is an fp32 product
of the rounded operands.  It is a throughput mode, not a parity mode.

The relative thresholds need only the k-th smallest masked value; an
exact sort returns the same element the JAX package's MSD radix
selection does, so the dense engine needs no ``rank_select`` module.

Sharding: the JAX ``axis_name`` becomes explicit arguments.  A rank
passes its local ``features``/``labels``, the gathered pool
``total_features``/``total_labels`` (rank-major, as MPI_Allgather orders
it), its ``rank`` and ``num_shards``, and an ``all_reduce`` that sums the
database-role gradient over the ranks (``None`` for one shard);
``parallel.mesh.sharded_npair_loss_fn`` supplies them from a mesh (the
gather outside autograd: the backward is hand-derived).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

FLT_MAX = float(np.finfo(np.float32).max)

AllReduce = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _f32(v: float) -> float:
    return float(np.float32(v))


class MiningRegion(enum.IntEnum):
    """Where a threshold is computed (caffe.proto:8-11)."""

    GLOBAL = 0  # one threshold from this rank's whole N x N*G block
    LOCAL = 1   # a per-query threshold


class MiningMethod(enum.IntEnum):
    """How pairs are selected against the threshold (caffe.proto:12-18)."""

    HARD = 0
    EASY = 1
    RAND = 2  # reference quirk: selects ALL pairs, no randomness
    RELATIVE_HARD = 3
    RELATIVE_EASY = 4


_RELATIVE = (MiningMethod.RELATIVE_HARD, MiningMethod.RELATIVE_EASY)


@dataclasses.dataclass(frozen=True)
class NPairLossConfig:
    """Static loss configuration — NPairLossParameter (caffe.proto:3-23),
    proto defaults.  ``grad_mode="reference"`` is the reference's
    hand-derived backward; ``"true"`` is autograd through the forward."""

    margin_ident: float = 0.0
    margin_diff: float = 0.0
    identsn: float = -1.0
    diffsn: float = -1.0
    ap_mining_region: MiningRegion = MiningRegion.LOCAL
    ap_mining_method: MiningMethod = MiningMethod.RAND
    an_mining_region: MiningRegion = MiningRegion.LOCAL
    an_mining_method: MiningMethod = MiningMethod.RAND
    grad_mode: str = "reference"

    def __post_init__(self):
        if self.grad_mode not in ("reference", "true"):
            raise ValueError(
                f"grad_mode must be 'reference' or 'true', got {self.grad_mode!r}"
            )


# The mining configuration the reference ships (usage/def.prototxt:
# 137-146): every positive at or below the block-wide top similarity,
# negatives harder than the per-query hardest positive minus 0.05.
REFERENCE_CONFIG = NPairLossConfig(
    margin_ident=0.0,
    margin_diff=-0.05,
    identsn=-0.0,
    diffsn=-0.3,
    ap_mining_region=MiningRegion.GLOBAL,
    ap_mining_method=MiningMethod.RELATIVE_HARD,
    an_mining_region=MiningRegion.LOCAL,
    an_mining_method=MiningMethod.HARD,
)


# -- masks (GetLabelDiffMtx, cu:44-66) -------------------------------------------


def pair_masks(local_labels: torch.Tensor, total_labels: torch.Tensor,
               rank: int, n_local: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same-label / different-label masks over the N x (N*G) pair grid,
    the self pair (row q, column ``rank*n_local + q``) in neither."""
    same_lbl = local_labels[:, None] == total_labels[None, :]
    dev = same_lbl.device
    col = torch.arange(total_labels.shape[0], device=dev)[None, :]
    row_global = torch.arange(n_local, device=dev)[:, None] + rank * n_local
    not_self = col != row_global
    return same_lbl & not_self, (~same_lbl) & not_self


# -- thresholds (cu:222-337) -----------------------------------------------------


def _count(mask: torch.Tensor, dim=None) -> torch.Tensor:
    """Pair counts in the JAX package's width: int32, or int64 where the
    population could pass 2^31 (then ``_relative_pos`` works in fp64)."""
    population = mask.numel() if dim is None else mask.shape[dim]
    dt = torch.int64 if population >= 2 ** 31 else torch.int32
    n = mask.sum() if dim is None else mask.sum(dim=dim)
    return n.to(dt)


def _relative_pos(count: torch.Tensor, sn: float) -> torch.Tensor:
    """Sorted-list index for RELATIVE_{HARD,EASY} mining (cu:285-287):
    ``size - 1 - int(sn)`` for sn >= 0, else ``trunc(size - 1 + sn *
    size)`` — in fp32 for int32 counts, where fp64 could land on the
    other side of an integer — clipped to [0, size - 1]."""
    if sn >= 0:
        pos = count - 1 - int(sn)
    else:
        big = count.dtype == torch.int64
        cf = count.to(torch.float64 if big else torch.float32)
        # A Python scalar multiplies in the tensor's type: sn rounded to
        # fp32 for fp32 counts, as jnp.float32(sn) * count.
        sn_f = float(sn) if big else float(np.float32(sn))
        pos = torch.trunc(cf - 1.0 + sn_f * cf).to(count.dtype)
    return torch.minimum(torch.clamp_min(pos, 0), torch.clamp_min(count - 1, 0))


def _clamp_negative(value: torch.Tensor) -> torch.Tensor:
    """Reference quirk: a relative threshold < 0 becomes -FLT_MAX."""
    return torch.where(value >= 0, value, -FLT_MAX)


def _kth_smallest(rows: torch.Tensor, mask: torch.Tensor, count: torch.Tensor,
                  k: torch.Tensor) -> torch.Tensor:
    """The k-th smallest masked entry of each row (0-based, exact);
    +FLT_MAX for a row with no entries."""
    vals = torch.where(mask, rows, float("inf")).sort(dim=1).values
    got = vals.gather(1, k.long()[:, None])[:, 0]
    return torch.where(count == 0, FLT_MAX, got)


def _local_relative_threshold(sims, mask, sn: float) -> torch.Tensor:
    count = _count(mask, dim=1)
    return _clamp_negative(
        _kth_smallest(sims, mask, count, _relative_pos(count, sn)))


def _global_relative_threshold(sims, mask, sn: float) -> torch.Tensor:
    count = _count(mask)[None]
    val = _kth_smallest(sims.reshape(1, -1), mask.reshape(1, -1), count,
                        _relative_pos(count, sn))
    return _clamp_negative(val[0])


def mining_thresholds(sims: torch.Tensor, same: torch.Tensor,
                      diff: torch.Tensor, cfg: NPairLossConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(pos_thr[N], neg_thr[N], max_all[N]) per the reference's grid:
    absolute AP thresholds are the hardest negative (LOCAL: per query,
    GLOBAL: block-wide), absolute AN the hardest positive; RELATIVE ones
    index the ascending-sorted lists; max_all stabilizes the exp."""
    n = sims.shape[0]
    max_between = torch.where(diff, sims, -FLT_MAX).amax(dim=1)
    min_within = torch.where(same, sims, FLT_MAX).amin(dim=1)
    max_all = torch.where(same | diff, sims, -FLT_MAX).amax(dim=1)

    if cfg.ap_mining_region == MiningRegion.LOCAL:
        if cfg.ap_mining_method in _RELATIVE:
            pos_thr = _local_relative_threshold(sims, same, cfg.identsn)
        else:
            pos_thr = max_between
    elif cfg.ap_mining_method in _RELATIVE:
        pos_thr = _global_relative_threshold(sims, same,
                                             cfg.identsn).expand(n)
    else:
        pos_thr = torch.where(diff, sims, -FLT_MAX).amax().expand(n)

    if cfg.an_mining_region == MiningRegion.LOCAL:
        if cfg.an_mining_method in _RELATIVE:
            neg_thr = _local_relative_threshold(sims, diff, cfg.diffsn)
        else:
            neg_thr = min_within
    elif cfg.an_mining_method in _RELATIVE:
        neg_thr = _global_relative_threshold(sims, diff,
                                             cfg.diffsn).expand(n)
    else:
        neg_thr = torch.where(same, sims, FLT_MAX).amin().expand(n)
    return pos_thr, neg_thr, max_all


# -- helpers of the streaming engines --------------------------------------------


def absolute_thresholds(min_within: torch.Tensor, max_between: torch.Tensor,
                        cfg: NPairLossConfig
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pos_thr, neg_thr) from streamed per-query stats, absolute methods
    (cu:279, 296, 310, 327); GLOBAL reduces over the query axis."""
    if cfg.ap_mining_region == MiningRegion.LOCAL:
        pos_thr = max_between
    else:
        pos_thr = max_between.amax().expand(max_between.shape)
    if cfg.an_mining_region == MiningRegion.LOCAL:
        neg_thr = min_within
    else:
        neg_thr = min_within.amin().expand(min_within.shape)
    return pos_thr, neg_thr


def topk_relative_threshold(topk: torch.Tensor, counts: torch.Tensor,
                            sn: float, region: MiningRegion,
                            count_dtype: torch.dtype = torch.int32
                            ) -> torch.Tensor:
    """RELATIVE_{HARD,EASY} threshold from per-query K-largest candidate
    buffers ([N, K], padded with -FLT_MAX), valid when every ``counts``
    fits K: the buffer then IS each query's whole candidate list, and the
    reference's ascending sorted-list index is a sort of N x K values.

    ``count_dtype`` is the dtype the radix path ranks the same population
    in (``population_count_dtype`` of the full pair population), so both
    paths run GLOBAL rank arithmetic in the same widths.  Empty lists
    give +FLT_MAX, values below 0 clamp to -FLT_MAX."""
    n, kcap = topk.shape
    if region == MiningRegion.GLOBAL:
        total = counts.to(count_dtype).sum(dtype=count_dtype)
        k = _relative_pos(total[None], sn)[0].to(torch.int32)
        total32 = total.to(torch.int32)  # <= n*K, always representable
        flat = torch.sort(topk.reshape(-1)).values  # ascending, padding first
        pos = torch.clamp(flat.shape[0] - total32 + k, 0, flat.shape[0] - 1)
        # gather, not flat[pos]: indexing by a 0-dim tensor reads it on
        # the host, a sync inside the training step.
        val = flat.gather(0, pos.long().reshape(1))[0]
        val = torch.where(total32 == 0, FLT_MAX, val)
        return _clamp_negative(val.expand(n))
    counts = counts.to(torch.int32)
    k = _relative_pos(counts, sn)
    asc = torch.sort(topk, dim=1).values
    pos = torch.clamp(kcap - counts + k, 0, kcap - 1)
    val = asc.gather(1, pos.long()[:, None])[:, 0]
    return _clamp_negative(torch.where(counts == 0, FLT_MAX, val))


# Auto-enable a streaming engine's fp32 similarity cache when it needs at
# most this many bytes — and at most a fifth of the card's memory, so the
# cache, which lives through the whole model backward, leaves the trunk
# room.  Where the device reports no memory (the CPU), 2 GiB.
SIM_CACHE_AUTO_BYTES = 6 << 30

_SIM_CACHE_LOGGED: set = set()
_CARD_BYTES: Dict[int, int] = {}


def resolve_sim_cache_auto(cache_bytes: int, engine: str,
                           device: Optional[torch.device] = None) -> bool:
    """Whether a streaming engine's sim cache auto-enables for
    ``cache_bytes`` on ``device``; every auto-enable is logged once per
    (engine, size)."""
    budget = 2 << 30
    if device is not None and torch.device(device).type == "cuda":
        index = torch.device(device).index
        index = torch.cuda.current_device() if index is None else index
        if index not in _CARD_BYTES:
            _CARD_BYTES[index] = torch.cuda.mem_get_info(index)[1]
        budget = _CARD_BYTES[index] // 5
    budget = min(SIM_CACHE_AUTO_BYTES, budget)
    enable = cache_bytes <= budget
    key = (engine, cache_bytes, enable)
    if enable and key not in _SIM_CACHE_LOGGED:
        _SIM_CACHE_LOGGED.add(key)
        import logging

        logging.getLogger("npairloss_tpu_torch").info(
            "%s: auto-enabling fp32 similarity cache (%.0f MiB <= budget "
            "%.0f MiB); pass sim_cache=False if memory is tight",
            engine, cache_bytes / 2**20, budget / 2**20)
    return enable


# -- selection (GetSampledPairMtx, cu:69-122) ------------------------------------


def selection_predicates(sims: torch.Tensor, pt: torch.Tensor,
                         nt: torch.Tensor, cfg: NPairLossConfig
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pos_sel, neg_sel) against the margin-adjusted thresholds — the
    reference's exact comparison directions."""
    m = cfg.ap_mining_method
    if m == MiningMethod.HARD:
        pos_sel = sims < pt
    elif m == MiningMethod.EASY:
        pos_sel = sims >= pt
    elif m == MiningMethod.RAND:
        pos_sel = torch.ones_like(sims, dtype=torch.bool)
    elif m == MiningMethod.RELATIVE_HARD:
        pos_sel = sims <= pt
    else:  # RELATIVE_EASY
        pos_sel = sims >= pt

    m = cfg.an_mining_method
    if m == MiningMethod.HARD:
        neg_sel = sims > nt
    elif m == MiningMethod.EASY:
        neg_sel = sims <= nt
    elif m == MiningMethod.RAND:
        neg_sel = torch.ones_like(sims, dtype=torch.bool)
    elif m == MiningMethod.RELATIVE_HARD:
        neg_sel = sims >= nt
    else:  # RELATIVE_EASY
        neg_sel = sims <= nt
    return pos_sel, neg_sel


def selection_mask(sims, same, diff, pos_thr, neg_thr,
                   cfg: NPairLossConfig) -> torch.Tensor:
    """Boolean per-pair selection mask."""
    pt = (pos_thr + _f32(cfg.margin_ident))[:, None]
    nt = (neg_thr + _f32(cfg.margin_diff))[:, None]
    pos_sel, neg_sel = selection_predicates(sims, pt, nt, cfg)
    return torch.where(same, pos_sel, diff & neg_sel)


# -- gemm precision ----------------------------------------------------------------


def resolve_matmul_precision(precision: Optional[str]) -> bool:
    """True for the single-pass bf16 mode (``"default"``), False for full
    fp32 (``None`` or ``"highest"``); anything else raises, as
    ``npairloss_tpu.ops.npair_loss.resolve_matmul_precision`` does."""
    if precision is None or precision == "highest":
        return False
    if precision == "default":
        return True
    raise ValueError(f"matmul_precision must be 'highest' or 'default', "
                     f"got {precision!r}")


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to bf16 (round to nearest even) and widened
    back: the operand a single-pass bf16 product reads."""
    return x.to(torch.bfloat16).float()


class _Bf16Matmul(torch.autograd.Function):
    """``a @ b`` in the single-pass bf16 mode, and its transposes in the
    same mode (the incoming gradient rounded too), as XLA differentiates
    a DEFAULT-precision dot."""

    @staticmethod
    def forward(ctx, a, b):
        ar, br = bf16_round(a), bf16_round(b)
        ctx.save_for_backward(ar, br)
        return ar @ br

    @staticmethod
    def backward(ctx, g):
        ar, br = ctx.saved_tensors
        gr = bf16_round(g)
        return gr @ br.T, ar.T @ gr


def _matmul(a: torch.Tensor, b: torch.Tensor, bf16: bool) -> torch.Tensor:
    return _Bf16Matmul.apply(a, b) if bf16 else a @ b


# -- forward core ------------------------------------------------------------------


def _forward_core(
    features: torch.Tensor,
    labels: torch.Tensor,
    cfg: NPairLossConfig,
    total_features: Optional[torch.Tensor] = None,
    total_labels: Optional[torch.Tensor] = None,
    rank: int = 0,
    num_shards: int = 1,
    matmul_precision: Optional[str] = None,
) -> Tuple[torch.Tensor, Dict[str, Any], Dict[str, Any]]:
    """Shared forward; returns (loss, aux for the metrics, residuals for
    the reference backward)."""
    bf16 = resolve_matmul_precision(matmul_precision)
    features = features.float()
    n_local = features.shape[0]
    if total_features is None:
        total_features, total_labels = features, labels
    else:
        total_features = total_features.float()

    sims = _matmul(features, total_features.T, bf16)  # cu:218, normalizer 1
    same, diff = pair_masks(labels, total_labels, rank, n_local)
    pos_thr, neg_thr, max_all = mining_thresholds(sims, same, diff, cfg)
    sel = selection_mask(sims, same, diff, pos_thr, neg_thr, cfg)

    sel_pos = same & sel
    sel_neg = diff & sel
    ident_num = sel_pos.sum(dim=1).float()
    diff_num = sel_neg.sum(dim=1).float()

    # Stabilized exponentials (cu:124-156); where-based masking.
    sim_exp = torch.exp(sims - max_all[:, None])
    exp_pos = torch.where(sel_pos, sim_exp, 0.0)
    exp_neg = torch.where(sel_neg, sim_exp, 0.0)
    ident_sum = exp_pos.sum(dim=1)
    all_sum = ident_sum + exp_neg.sum(dim=1)
    valid = (ident_sum != 0) & (all_sum != 0)
    log_q = torch.where(
        valid, torch.log(torch.where(valid, ident_sum / all_sum, 1.0)), 0.0)
    loss = -log_q.sum() / _f32(n_local)

    aux = {
        "sim": sims,
        "sim_exp": sim_exp,
        "total_labels": total_labels,
        "rank": rank,
        "ident_num": ident_num,
        "diff_num": diff_num,
        "pos_threshold": pos_thr,
        "neg_threshold": neg_thr,
    }
    residuals = {
        "features": features,
        "total_features": total_features,
        "exp_pos": exp_pos,
        "exp_neg": exp_neg,
        "ident_sum": ident_sum,
        "all_sum": all_sum,
        "rank": rank,
        "num_shards": num_shards,
        "bf16": bf16,
    }
    return loss, aux, residuals


# -- reference backward (cu:420-499) ------------------------------------------------


def grad_roles(res: Dict[str, Any], g: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(query-role grad [N, D], database-role grad [N*G, D]) of one rank:
    ``w = (-p1 + p2 + p3) * g/N`` with p1 = exp_pos/I, p2 = exp_pos/(I+D),
    p3 = exp_neg/(I+D), each 0 where its denominator is 0; then
    ``w @ F_total`` and ``w^T @ F_local``."""
    def safe_div(num, den):
        ok = den != 0
        return torch.where(ok[:, None], num / torch.where(ok, den, 1.0)[:, None],
                           0.0)

    n_local = res["features"].shape[0]
    p1 = safe_div(res["exp_pos"], res["ident_sum"])
    p2 = safe_div(res["exp_pos"], res["all_sum"])
    p3 = safe_div(res["exp_neg"], res["all_sum"])
    w = (-p1 + p2 + p3) * (g / _f32(n_local))
    bf16 = res.get("bf16", False)
    return (_matmul(w, res["total_features"], bf16),
            _matmul(w.T, res["features"], bf16))


def merge_roles(grad_query: torch.Tensor, grad_db_summed: torch.Tensor,
                rank: int, num_shards: int) -> torch.Tensor:
    """``0.5 * (all-reduced db grad / G)[own rows] + 0.5 * query grad``."""
    n_local = grad_query.shape[0]
    grad_db = grad_db_summed / _f32(num_shards)
    own = grad_db[rank * n_local:(rank + 1) * n_local]
    return 0.5 * own + 0.5 * grad_query


def _reference_backward(res: Dict[str, Any], g: torch.Tensor,
                        all_reduce: AllReduce = None) -> torch.Tensor:
    grad_query, grad_db = grad_roles(res, g)
    if all_reduce is not None:
        grad_db = all_reduce(grad_db)
    return merge_roles(grad_query, grad_db, res["rank"], res["num_shards"])


class _ReferenceNPair(torch.autograd.Function):
    """The loss with the reference's backward.  ``aux_out`` (a dict) is
    filled with the forward's monitors; they carry no gradient, as in the
    reference, where thresholds, masks and counts are constants."""

    @staticmethod
    def forward(ctx, features, labels, cfg, total_features, total_labels,
                rank, num_shards, all_reduce, aux_out, matmul_precision):
        loss, aux, res = _forward_core(features, labels, cfg, total_features,
                                       total_labels, rank, num_shards,
                                       matmul_precision)
        aux_out.update(aux)
        ctx.res = res
        ctx.all_reduce = all_reduce
        ctx.feature_dtype = features.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        d = _reference_backward(ctx.res, g, ctx.all_reduce)
        return (d.to(ctx.feature_dtype),) + (None,) * 9


def npair_loss_with_aux(
    features: torch.Tensor,
    labels: torch.Tensor,
    cfg: NPairLossConfig = NPairLossConfig(),
    *,
    total_features: Optional[torch.Tensor] = None,
    total_labels: Optional[torch.Tensor] = None,
    rank: int = 0,
    num_shards: int = 1,
    all_reduce: AllReduce = None,
    matmul_precision: Optional[str] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Multi-class N-pair loss with mining; returns (loss, aux).

    ``features`` [N, D] (L2-normalized upstream) and ``labels`` [N] of
    this shard; for G > 1 shards also the gathered pool, this shard's
    ``rank``, ``num_shards`` and the ``all_reduce`` of the database-role
    gradient.  ``matmul_precision``: ``None``/``"highest"`` or the
    single-pass bf16 ``"default"``.  ``aux`` feeds ``ops.metrics`` and
    carries no gradient."""
    if cfg.grad_mode == "reference":
        aux: Dict[str, Any] = {}
        loss = _ReferenceNPair.apply(features, labels, cfg, total_features,
                                     total_labels, rank, num_shards,
                                     all_reduce, aux, matmul_precision)
        return loss, aux
    loss, aux, _ = _forward_core(features, labels.detach(), cfg,
                                 total_features, total_labels, rank,
                                 num_shards, matmul_precision)
    return loss, {k: v.detach() if torch.is_tensor(v) else v
                  for k, v in aux.items()}


def npair_loss(features: torch.Tensor, labels: torch.Tensor,
               cfg: NPairLossConfig = NPairLossConfig(),
               **kwargs) -> torch.Tensor:
    """Scalar multi-class N-pair loss (see ``npair_loss_with_aux``)."""
    return npair_loss_with_aux(features, labels, cfg, **kwargs)[0]
