"""Ring N-pair loss: the pool streams over the mesh, never gathered —
port of ``npairloss_tpu/parallel/ring.py``.

Each shard's feature block circulates around the ring while every shard
computes its N x N_block similarity tile and reduces online, so memory
is O(N x N_block) and each block crosses G - 1 hops per pass.  The JAX
ring's tile is a plain dot outside any Pallas kernel (``ring.py:113-
122``); here it is ``torch.matmul`` under the port's precision switch
(full fp32, or the single-pass bf16 mode's rounded operands).

Hop order is the JAX ring's: shard r sends its block to shard r + 1, so
at step s it holds block (r - s) mod G (``ring.py:150-175``), and every
running sum adds the blocks in that order.  Passes:

  1. **stats**: per-query min-within / max-between / max-all, pair
     counts, running top-(k+1) lists for Recall@k, the digit-0 radix
     histograms of the RELATIVE_* sides and the K-slot positive buffer;
  2. **loss**, after the radix digit passes when a side is relative
     (exact MSD radix selection, ``ops.rank_select``): selection against
     the thresholds, stabilized exp, running I/D sums;
  3. **backward**: the weight tile recomputed per block; the query-role
     gradient accumulates locally, the database-role gradient rides the
     ring with its block and reaches the block's owner after G hops as
     the sum over all shards (the reference's MPI_Allreduce, cu:462-489),
     then the 0.5/0.5 merge (cu:492-497).

The sparse-positive fast path (AP the only relative side) falls back to
radix selection when a label group overflows the buffer; every rank
takes the same branch from one ``all_reduce(MAX)`` of the positive
count (JAX's ``pmax``, ``ring.py:367-400``), read on the host.  With
``sim_cache`` the stats pass keeps this shard's G tiles and the later
passes replay them: the digit and loss passes with no hop and no
matmul, bit for bit the recompute path's result.  At G = 1 every pass
runs its one block with no hop.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from npairloss_tpu_torch.ops.npair_loss import (
    FLT_MAX,
    MiningMethod,
    MiningRegion,
    NPairLossConfig,
    _clamp_negative,
    _relative_pos,
    absolute_thresholds,
    bf16_round,
    resolve_matmul_precision,
    resolve_sim_cache_auto,
    selection_mask,
    topk_relative_threshold,
)
from npairloss_tpu_torch.ops.rank_select import (
    NUM_DIGITS,
    RADIX_BINS,
    masked_digit_hist,
    population_count_dtype,
    radix_begin,
    radix_finish,
    radix_update,
)

_RELATIVE = (MiningMethod.RELATIVE_HARD, MiningMethod.RELATIVE_EASY)

# (sims, block labels, block rank) of each hop, in hop order.
Cache = List[Tuple[torch.Tensor, torch.Tensor, int]]


def ring_supported(cfg: NPairLossConfig) -> bool:
    """Every mining configuration streams (RELATIVE_* via radix select)."""
    return True


def _f32(v: float) -> float:
    return float(np.float32(v))


def _tile(feats: torch.Tensor, block_f: torch.Tensor) -> torch.Tensor:
    """One N x N_block similarity tile (operands already rounded in the
    bf16 mode)."""
    return feats @ block_f.T


def _block_masks(labels, block_labels, my_rank: int, block_rank: int):
    """same/diff masks of one tile; the self pair excluded when the tile
    is this shard's own block (cu:54)."""
    same_lbl = labels[:, None] == block_labels[None, :]
    if my_rank == block_rank:
        n = labels.shape[0]
        not_self = ~torch.eye(n, dtype=torch.bool, device=labels.device)
        return same_lbl & not_self, (~same_lbl) & not_self
    return same_lbl, ~same_lbl


def _blocks(mesh, feats, labels, cache: Optional[Cache]):
    """(sims, block labels, block rank) of the G blocks in hop order:
    replayed from the cache, or computed while the blocks go round the
    ring (G - 1 hops: the last block is not sent home)."""
    if cache is not None:
        yield from cache
        return
    g, r = mesh.size, mesh.rank
    rot_f, rot_l = feats, labels
    for step in range(g):
        yield _tile(feats, rot_f), rot_l, (r - step) % g
        if step < g - 1:
            rot_f, rot_l = mesh.shift([rot_f, rot_l])


# -- pass 1: mining statistics + retrieval top-k --------------------------------


def _stats_pass(feats, labels, mesh, top_k_max: int, hist0_same=False,
                hist0_diff=False, emit_sims=False, topk_same_k=0):
    n = feats.shape[0]
    dev = feats.device
    neg, pos = -FLT_MAX, FLT_MAX
    zero_prefix = torch.zeros((n,), dtype=torch.int64, device=dev)
    c = {
        "min_within": torch.full((n,), pos, device=dev),
        "max_between": torch.full((n,), neg, device=dev),
        "max_all": torch.full((n,), neg, device=dev),
        "count_same": torch.zeros((n,), dtype=torch.int32, device=dev),
        "count_diff": torch.zeros((n,), dtype=torch.int32, device=dev),
        "top_sims": torch.full((n, top_k_max + 1), neg, device=dev),
        "top_same": torch.zeros((n, top_k_max + 1), dtype=torch.bool,
                                device=dev),
    }
    if hist0_same:
        c["hist0_same"] = torch.zeros((n, RADIX_BINS), dtype=torch.int32,
                                      device=dev)
    if hist0_diff:
        c["hist0_diff"] = torch.zeros((n, RADIX_BINS), dtype=torch.int32,
                                      device=dev)
    if topk_same_k:
        c["topk_same"] = torch.full((n, topk_same_k), neg, device=dev)
    cache: Cache = []

    for sims, block_l, block_rank in _blocks(mesh, feats, labels, None):
        same, diff = _block_masks(labels, block_l, mesh.rank, block_rank)
        if emit_sims:
            cache.append((sims, block_l, block_rank))
        c["min_within"] = torch.minimum(
            c["min_within"], torch.where(same, sims, pos).amin(dim=1))
        c["max_between"] = torch.maximum(
            c["max_between"], torch.where(diff, sims, neg).amax(dim=1))
        nonself = same | diff
        c["max_all"] = torch.maximum(
            c["max_all"], torch.where(nonself, sims, neg).amax(dim=1))
        c["count_same"] += same.sum(dim=1, dtype=torch.int32)
        c["count_diff"] += diff.sum(dim=1, dtype=torch.int32)
        if hist0_same:
            c["hist0_same"] += masked_digit_hist(sims, same, zero_prefix, 0)
        if hist0_diff:
            c["hist0_diff"] += masked_digit_hist(sims, diff, zero_prefix, 0)
        if topk_same_k:
            c["topk_same"] = torch.cat(
                [c["topk_same"], torch.where(same, sims, neg)], dim=1
            ).topk(topk_same_k, dim=1).values
        top, idx = torch.cat(
            [c["top_sims"], torch.where(nonself, sims, neg)], dim=1
        ).topk(top_k_max + 1, dim=1)
        c["top_same"] = torch.cat([c["top_same"], same], dim=1).gather(1, idx)
        c["top_sims"] = top
    if emit_sims:
        c["cache"] = cache
    return c


# -- streamed RELATIVE thresholds: exact MSD radix selection over the ring -------


def _multi_digit_hist_pass(feats, labels, mesh, sides, digit: int,
                           cache: Optional[Cache] = None):
    """Digit histograms of every active RELATIVE side from one pass: the
    tile computed once feeds both masks.  ``sides``: name -> (use_same,
    prefix); returns name -> int32 [N, RADIX_BINS]."""
    n = feats.shape[0]
    out = {s: torch.zeros((n, RADIX_BINS), dtype=torch.int32,
                          device=feats.device) for s in sides}
    for sims, block_l, block_rank in _blocks(mesh, feats, labels, cache):
        same, diff = _block_masks(labels, block_l, mesh.rank, block_rank)
        for s, (use_same, prefix) in sides.items():
            out[s] += masked_digit_hist(sims, same if use_same else diff,
                                        prefix, digit)
    return out


def _ring_thresholds(feats, labels, mesh, cfg: NPairLossConfig, stats,
                     cache: Optional[Cache] = None):
    """(pos_thr, neg_thr) for any mining config: absolute from the
    streamed stats, RELATIVE_* by radix selection (the digit-0
    histograms from the stats pass, one pass a further digit shared by
    both sides), or from the K-slot buffer when every rank's positives
    fit it."""
    pos_thr, neg_thr = absolute_thresholds(stats["min_within"],
                                           stats["max_between"], cfg)
    ap_rel = cfg.ap_mining_method in _RELATIVE
    an_rel = cfg.an_mining_method in _RELATIVE
    if not (ap_rel or an_rel):
        return pos_thr, neg_thr
    if ap_rel and not an_rel and "topk_same" in stats:
        kcap = stats["topk_same"].shape[1]
        most = mesh.all_reduce_max(stats["count_same"].max().reshape(1))
        if int(most.item()) <= kcap:  # the same on every rank
            n, g = feats.shape[0], mesh.size
            p = topk_relative_threshold(
                stats["topk_same"], stats["count_same"], cfg.identsn,
                cfg.ap_mining_region,
                count_dtype=population_count_dtype(n * n * g))
            return p, neg_thr
    return _ring_radix_thresholds(feats, labels, mesh, cfg, stats, cache,
                                  pos_thr, neg_thr, ap_rel, an_rel)


def _ring_radix_thresholds(feats, labels, mesh, cfg, stats, cache, pos_thr,
                           neg_thr, include_ap: bool, include_an: bool):
    sides = {}
    if include_ap:
        sides["ap"] = (True, cfg.identsn, cfg.ap_mining_region,
                       stats["count_same"], stats["hist0_same"])
    if include_an:
        sides["an"] = (False, cfg.diffsn, cfg.an_mining_region,
                       stats["count_diff"], stats["hist0_diff"])
    n, g = feats.shape[0], mesh.size
    cdt = population_count_dtype(n * n * g)

    def prep(side, hist):
        if sides[side][2] == MiningRegion.GLOBAL:
            return hist.sum(dim=0, keepdim=True, dtype=cdt).expand(
                n, RADIX_BINS)
        return hist

    states, empties = {}, {}
    for s, (_, sn, region, counts, hist0) in sides.items():
        if region == MiningRegion.GLOBAL:
            total = counts.to(cdt).sum(dtype=cdt)
            k = _relative_pos(total[None], sn)[0].expand(n)
            empties[s] = (total == 0).expand(n)
        else:
            k = _relative_pos(counts, sn)
            empties[s] = counts == 0
        states[s] = radix_update(radix_begin(k), prep(s, hist0))
    for digit in range(1, NUM_DIGITS):
        hists = _multi_digit_hist_pass(
            feats, labels, mesh,
            {s: (sides[s][0], states[s][1]) for s in sides}, digit, cache)
        for s in sides:
            states[s] = radix_update(states[s], prep(s, hists[s]))
    vals = {s: _clamp_negative(radix_finish(states[s], empties[s]))
            for s in sides}
    return vals.get("ap", pos_thr), vals.get("an", neg_thr)


# -- pass 2: selection + stabilized exp sums (+ counts) --------------------------


def _loss_pass(feats, labels, mesh, pos_thr, neg_thr, max_all,
               cfg: NPairLossConfig, cache: Optional[Cache] = None):
    n = feats.shape[0]
    c = {k: torch.zeros((n,), device=feats.device)
         for k in ("ident_sum", "diff_sum", "ident_num", "diff_num")}
    for sims, block_l, block_rank in _blocks(mesh, feats, labels, cache):
        same, diff = _block_masks(labels, block_l, mesh.rank, block_rank)
        sel = selection_mask(sims, same, diff, pos_thr, neg_thr, cfg)
        sel_pos, sel_neg = same & sel, diff & sel
        sim_exp = torch.exp(sims - max_all[:, None])
        c["ident_sum"] = c["ident_sum"] + torch.where(
            sel_pos, sim_exp, 0.0).sum(dim=1)
        c["diff_sum"] = c["diff_sum"] + torch.where(
            sel_neg, sim_exp, 0.0).sum(dim=1)
        c["ident_num"] = c["ident_num"] + sel_pos.sum(dim=1).float()
        c["diff_num"] = c["diff_num"] + sel_neg.sum(dim=1).float()
    return c


# -- pass 3 (backward): the database-role gradient rides the ring ----------------


def _backward_pass(res, g_loss: torch.Tensor, cfg: NPairLossConfig, mesh,
                   bf16: bool) -> torch.Tensor:
    feats, labels = res["features"], res["labels"]
    pos_thr, neg_thr = res["pos_thr"], res["neg_thr"]
    max_all, ident_sum, all_sum = (res["max_all"], res["ident_sum"],
                                   res["all_sum"])
    cache = res["cache"]
    n, g = feats.shape[0], mesh.size
    scale = g_loss / _f32(n)

    def safe(num, den):
        ok = den != 0
        return torch.where(ok[:, None], num / torch.where(ok, den, 1.0)[:, None],
                           0.0)

    def weight_tile(sims, same, diff):
        sel = selection_mask(sims, same, diff, pos_thr, neg_thr, cfg)
        sim_exp = torch.exp(sims - max_all[:, None])
        exp_pos = torch.where(same & sel, sim_exp, 0.0)
        exp_neg = torch.where(diff & sel, sim_exp, 0.0)
        w = (-safe(exp_pos, ident_sum) + safe(exp_pos, all_sum)
             + safe(exp_neg, all_sum)) * scale
        if cfg.grad_mode != "reference":
            valid = (ident_sum != 0) & (all_sum != 0)
            w = torch.where(valid[:, None], w, 0.0)
        return bf16_round(w) if bf16 else w

    grad_query = torch.zeros_like(feats)
    grad_db = torch.zeros_like(feats)
    rot_f, rot_l = feats, labels
    for step in range(g):
        if cache is not None:
            sims, rot_l, block_rank = cache[step]
        else:
            sims, block_rank = _tile(feats, rot_f), (mesh.rank - step) % g
        same, diff = _block_masks(labels, rot_l, mesh.rank, block_rank)
        w = weight_tile(sims, same, diff)
        grad_query = grad_query + w @ rot_f
        grad_db = grad_db + w.T @ feats
        if g > 1:
            # The block's database-role gradient travels with it; after
            # G hops it is home, summed over every shard.
            if step < g - 1:
                sent = [rot_f, grad_db] if cache is not None \
                    else [rot_f, rot_l, grad_db]
                got = mesh.shift(sent)
                rot_f, grad_db = got[0], got[-1]
                if cache is None:
                    rot_l = got[1]
            else:
                grad_db = mesh.shift([grad_db])[0]
    if cfg.grad_mode == "reference":
        # 1/G allreduce scale (cu:474) + 0.5/0.5 role merge (cu:492-497).
        return 0.5 * grad_db / _f32(g) + 0.5 * grad_query
    return grad_query + grad_db


# -- forward ----------------------------------------------------------------------


def _forward(features, labels, cfg: NPairLossConfig, mesh, top_ks,
             sim_cache: bool, pos_topk: int, bf16: bool):
    feats = features.float().contiguous()
    if bf16:
        feats = bf16_round(feats)
    labels = labels.contiguous()
    n, g = feats.shape[0], mesh.size
    ap_rel = cfg.ap_mining_method in _RELATIVE
    an_rel = cfg.an_mining_method in _RELATIVE
    top_k_max = max(top_ks) if top_ks else 1
    stats = _stats_pass(
        feats, labels, mesh, top_k_max, hist0_same=ap_rel, hist0_diff=an_rel,
        emit_sims=sim_cache,
        # The buffer only pays when AP is the sole relative side.
        topk_same_k=pos_topk if ap_rel and not an_rel else 0)
    cache = stats.get("cache")
    pos_thr, neg_thr = _ring_thresholds(feats, labels, mesh, cfg, stats,
                                        cache)
    sums = _loss_pass(feats, labels, mesh, pos_thr, neg_thr,
                      stats["max_all"], cfg, cache)
    ident_sum = sums["ident_sum"]
    all_sum = ident_sum + sums["diff_sum"]
    valid = (ident_sum != 0) & (all_sum != 0)
    log_q = torch.where(
        valid, torch.log(torch.where(valid, ident_sum / all_sum, 1.0)), 0.0)
    loss = -log_q.sum() / _f32(n)

    # Recall@k from the streamed top-(k+1) lists (cu:190: the descending
    # value at min(k, size - 1) of the non-self row; exp is monotone).
    n_total_minus1 = n * g - 1
    metrics: Dict[str, torch.Tensor] = {}
    for k in top_ks:
        thr = stats["top_sims"][:, min(k, n_total_minus1 - 1)]
        hit = ((stats["top_sims"] > thr[:, None]) & stats["top_same"]).any(
            dim=1)
        metrics[f"retrieve_top{k}"] = hit.sum().float() / _f32(n)
    metrics["feature_asum"] = features.float().abs().sum() / _f32(n)
    metrics["ident_num"] = sums["ident_num"].sum()
    metrics["diff_num"] = sums["diff_num"].sum()
    res = {"features": feats, "labels": labels, "pos_thr": pos_thr,
           "neg_thr": neg_thr, "max_all": stats["max_all"],
           "ident_sum": ident_sum, "all_sum": all_sum, "cache": cache}
    return loss, metrics, res


class _Ring(torch.autograd.Function):
    """The ring loss with the JAX ring's hand-derived backward
    (``ring.py:610-743``); ``metrics_out`` gets the monitors, which
    carry no gradient."""

    @staticmethod
    def forward(ctx, features, labels, cfg, mesh, top_ks, sim_cache,
                pos_topk, bf16, metrics_out):
        loss, metrics, res = _forward(features, labels, cfg, mesh, top_ks,
                                      sim_cache, pos_topk, bf16)
        metrics_out.update(metrics)
        ctx.res, ctx.args = res, (cfg, mesh, bf16)
        ctx.feature_dtype = features.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        cfg, mesh, bf16 = ctx.args
        d = _backward_pass(ctx.res, g.float(), cfg, mesh, bf16)
        return (d.to(ctx.feature_dtype),) + (None,) * 8


def ring_npair_loss_and_metrics(
    features: torch.Tensor,
    labels: torch.Tensor,
    cfg: NPairLossConfig = NPairLossConfig(),
    mesh=None,
    top_ks: Sequence[int] = (1, 5, 10),
    sim_cache: Optional[bool] = None,
    pos_topk: Optional[int] = None,
    matmul_precision: Optional[str] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """This shard's ring N-pair loss and retrieval metrics over the
    mesh's pool; every rank of ``mesh`` calls it with its own rows.

    The same loss, metrics and gradient as the dense engine over the
    gathered pool, for every mining configuration; ``cfg.grad_mode`` as
    there.  ``sim_cache``: keep this shard's G tiles (G x N x N fp32)
    from the stats pass for the later passes (bit for bit the recompute
    path); ``None`` enables it when ``resolve_sim_cache_auto`` admits the
    bytes.  ``pos_topk``: the sparse-positive buffer's slots for
    RELATIVE_* AP mining (``None`` = 8, 0 = radix selection only).
    ``matmul_precision``: ``None``/``"highest"`` or the single-pass bf16
    ``"default"``.  ``mesh`` None is a one-shard mesh on the features'
    device."""
    if mesh is None:
        from npairloss_tpu_torch.parallel.mesh import Mesh

        mesh = Mesh(rank=0, size=1, device=features.device)
    if sim_cache is None:
        n = features.shape[0]
        sim_cache = resolve_sim_cache_auto(mesh.size * n * n * 4, "ring",
                                           features.device)
    pos_topk = 8 if pos_topk is None else int(pos_topk)
    if pos_topk < 0:
        raise ValueError(f"pos_topk must be >= 0, got {pos_topk}")
    bf16 = resolve_matmul_precision(matmul_precision)
    metrics: Dict[str, torch.Tensor] = {}
    loss = _Ring.apply(features, labels, cfg, mesh, tuple(top_ks),
                       bool(sim_cache), pos_topk, bf16, metrics)
    return loss, metrics
