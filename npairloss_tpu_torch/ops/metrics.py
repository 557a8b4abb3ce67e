"""In-training retrieval metrics (port of ``npairloss_tpu/ops/metrics.py``).

Reference semantics (GetRetrivePerformance, cu:173-206):
  * the self column (gathered index ``rank*N + q``) is excluded;
  * the threshold is the sorted-descending value at index
    ``min(top_k, n_total - 2)`` of the non-self row;
  * a query counts iff some non-self same-label item lies STRICTLY above
    the threshold — ties at the threshold do not count;
  * it runs on the exp'd similarity matrix (rank-preserving per row).
Only the threshold's value is taken from ``topk``, so its tie order does
not matter.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch

_NEG_FILL = float(-np.finfo(np.float32).max)


def recall_at_k(sim_exp: torch.Tensor, local_labels: torch.Tensor,
                total_labels: torch.Tensor, rank: int,
                top_k: int) -> torch.Tensor:
    """Fraction of queries with a same-label item above the top-k
    threshold."""
    n_local, n_total = sim_exp.shape
    dev = sim_exp.device
    col = torch.arange(n_total, device=dev)[None, :]
    row_global = torch.arange(n_local, device=dev)[:, None] + rank * n_local
    not_self = col != row_global
    masked = torch.where(not_self, sim_exp, _NEG_FILL)
    thr_idx = min(top_k, n_total - 2)
    threshold = masked.topk(thr_idx + 1, dim=1).values[:, thr_idx]
    same_lbl = local_labels[:, None] == total_labels[None, :]
    hit = ((masked > threshold[:, None]) & same_lbl & not_self).any(dim=1)
    return hit.sum().float() / float(np.float32(n_local))


def feature_asum(features: torch.Tensor) -> torch.Tensor:
    """Mean absolute feature sum: asum(features)/N (cu:400-401)."""
    n = features.shape[0]
    return features.float().abs().sum() / float(np.float32(n))


def embedding_magnitude(features: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Row-L2-norm mean and max; 1.0 after an intact L2Normalize."""
    norms = torch.linalg.norm(features.float(), dim=-1)
    return {"emb_mag_mean": norms.mean(), "emb_mag_max": norms.max()}


def retrieval_metrics(aux: Dict[str, Any], local_labels: torch.Tensor,
                      features: torch.Tensor,
                      top_ks: Sequence[int] = (1, 5, 10)
                      ) -> Dict[str, torch.Tensor]:
    """The reference's metric tops: ``retrieve_top{k}`` per ``top_ks``
    and ``feature_asum``, from the second output of
    ``npair_loss_with_aux``."""
    out = {}
    for k in top_ks:
        out[f"retrieve_top{k}"] = recall_at_k(
            aux["sim_exp"], local_labels, aux["total_labels"], aux["rank"], k)
    out["feature_asum"] = feature_asum(features)
    return out
