"""Training-health signals inside the step — port of
``npairloss_tpu/obs/health.py``.

The reference monitored training health with an in-training Recall@k
and a feature-magnitude probe (GetRetrivePerformance + asum,
npair_multi_class_loss.cu:173-206, cu:400-401).  This module adds the
signals large-scale training triages with:

  * global gradient norm (exploding/vanishing gradients),
  * parameter norm and update/param ratio (the "is the lr sane" signal
    — healthy runs sit around 1e-3),
  * embedding-magnitude mean/max (1.0 after an intact L2 normalize),
  * mined-pair hardness summaries (selected pair counts and the mining
    thresholds — a collapsing embedding shows here before the loss).

Every signal is a fixed-shape fp32 reduction of device tensors with no
host read, so a step with health on stays sync-free and is captured in
the pipelined loop's CUDA graph like the rest of the step.  With
``health=None`` (the Solver default) no op is added.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

import torch

from npairloss_tpu_torch.ops.metrics import embedding_magnitude


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Which health signals to fold into the step's metric dict."""

    grad_norm: bool = True
    param_norm: bool = True
    update_ratio: bool = True
    embedding_magnitude: bool = True
    pair_hardness: bool = True
    # AP/AN margin-distribution and hard-negative-saturation stats from
    # the same loss aux pair_hardness reads; off keeps the key set of a
    # run without them.
    mining_health: bool = False
    eps: float = 1e-12


def tree_l2_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """Global L2 norm over every tensor, accumulated in fp32 (a bf16
    squared sum would overflow in its own dtype).  fp32 tensors take the
    multi-tensor norm (a few kernels for a whole tree, as
    ``clip_grad_norm_`` does: the norm of the per-tensor norms); other
    dtypes are widened one by one."""
    ts = [t.detach() for t in tensors]
    if not ts:
        raise ValueError("tree_l2_norm of no tensors")
    if all(t.dtype == torch.float32 for t in ts):
        return torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(ts, 2)))
    sq = None
    for t in ts:
        s = torch.sum(torch.square(t.float()))
        sq = s if sq is None else sq + s
    return torch.sqrt(sq)


def update_health(grads: Iterable[torch.Tensor],
                  params: Optional[Iterable[torch.Tensor]],
                  updates: Iterable[torch.Tensor],
                  cfg: HealthConfig,
                  param_norm: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
    """Optimizer-side signals from one step's (grads, params, updates),
    ``params`` PRE-update; ``param_norm`` stands for ``params`` when the
    caller took their norm before an in-place update (the Solver does).

    ``update_ratio`` is ||update|| / ||param|| — the per-step relative
    parameter motion; sane near 1e-3, diverging near 1e-1, frozen near
    1e-7."""
    out: Dict[str, torch.Tensor] = {}
    if cfg.grad_norm:
        out["grad_norm"] = tree_l2_norm(grads)
    if (cfg.param_norm or cfg.update_ratio) and param_norm is None:
        param_norm = tree_l2_norm(params)
    if cfg.param_norm:
        out["param_norm"] = param_norm
    if cfg.update_ratio:
        out["update_norm"] = tree_l2_norm(updates)
        out["update_ratio"] = out["update_norm"] / (
            param_norm + float(cfg.eps))
    return out


def embedding_health(features: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Embedding-magnitude mean/max — the reference's feature monitor
    generalized from asum to row L2 norms (one home:
    ``ops.metrics.embedding_magnitude``)."""
    return embedding_magnitude(features.detach())


# Mining thresholds use ±inf/±FLT_MAX sentinels for "no candidates /
# select everything" queries; any |threshold| past this cutoff is a
# sentinel, not a similarity (post-L2Normalize sims live in [-1, 1]).
_THRESHOLD_SENTINEL = 1e30

# The AN-frontier cosine past which a query's mined negatives count as
# SATURATED (everything looks like a hard negative).
SATURATION_COSINE = 0.9


def _defined(x: torch.Tensor) -> torch.Tensor:
    return torch.isfinite(x) & (x.abs() < _THRESHOLD_SENTINEL)


def _where0(cond: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.where(cond, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def _finite_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over non-sentinel entries; 0 when every entry is a
    sentinel (an all-sentinel batch reports a FINITE row)."""
    x = x.detach().float()
    ok = _defined(x)
    cnt = ok.sum()
    total = _where0(ok, x).sum()
    return _where0(cnt > 0, total / cnt.clamp_min(1))


def pair_hardness_health(aux: Dict[str, torch.Tensor],
                         mining: bool = False) -> Dict[str, torch.Tensor]:
    """Mined-pair hardness summary from the dense engine's loss aux.

    ``mined_pos/neg_per_query`` are the reference's identNum/diffNum
    (cu:357/360) averaged over queries; ``ap/an_threshold_mean`` the
    mining thresholds averaged over the queries that had candidates.

    ``mining=True`` (HealthConfig.mining_health) adds, from the same
    per-query thresholds:

      * ``ap_an_margin_mean``: mean AP−AN threshold margin over queries
        with both frontiers defined;
      * ``ap_an_margin_p10``: the 10th-percentile margin (the weakest
        queries collapse first);
      * ``an_saturation``: the fraction of defined AN frontiers past
        :data:`SATURATION_COSINE`.

    Every stat is finite (sentinel-masked, zero-filled when undefined)
    and computed on the device: the p10 index is a device tensor."""
    out = {
        "mined_pos_per_query": aux["ident_num"].detach().float().mean(),
        "mined_neg_per_query": aux["diff_num"].detach().float().mean(),
        "ap_threshold_mean": _finite_mean(aux["pos_threshold"]),
        "an_threshold_mean": _finite_mean(aux["neg_threshold"]),
    }
    if not mining:
        return out
    pos = aux["pos_threshold"].detach().float()
    neg = aux["neg_threshold"].detach().float()
    ok_n = _defined(neg)
    ok = _defined(pos) & ok_n
    cnt = ok.sum()
    margin = _where0(ok, pos - neg)
    out["ap_an_margin_mean"] = _where0(cnt > 0,
                                       margin.sum() / cnt.clamp_min(1))
    # p10 without a masked quantile: undefined queries sort to +inf, and
    # the 10th percentile of the DEFINED count is a device-side index.
    filled = torch.where(ok, pos - neg,
                         torch.full((), float("inf"), device=pos.device))
    ranked = torch.sort(filled).values
    i10 = ((cnt - 1) // 10).clamp(0, ranked.shape[0] - 1)
    p10 = ranked.gather(0, i10.reshape(1))[0]
    out["ap_an_margin_p10"] = _where0((cnt > 0) & torch.isfinite(p10), p10)
    cnt_n = ok_n.sum()
    saturated = (ok_n & (neg > SATURATION_COSINE)).sum()
    out["an_saturation"] = _where0(
        cnt_n > 0, saturated.float() / cnt_n.clamp_min(1).float())
    return out
