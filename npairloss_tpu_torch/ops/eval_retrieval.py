"""Offline full-gallery retrieval evaluation — port of
``npairloss_tpu/ops/eval_retrieval.py`` (XLA ops there, no Pallas
kernel, so plain torch here).

    Recall@K = fraction of queries whose K nearest gallery neighbors
    (cosine similarity, self excluded) contain a same-class item.

Queries stream in blocks of ``query_block`` rows: each block is one
(B x N) fp32 ``torch.matmul`` (TF32 off) and a top-k, so the N x N
similarity matrix is never materialized.

``lax.top_k`` puts the lower index first among equal values, and
``torch.topk`` promises no order among ties.  The port ranks a
composite int64 key instead — the sim's order-preserving integer image
in the high 32 bits, the complement of the column index in the low 32 —
so every key is distinct and the top-k is JAX's, ties included.

Unlike ``ops.metrics.recall_at_k`` (the reference's in-training
quirks), this is the standard membership-in-top-K protocol.  NMI runs
the port's ``ops.kmeans`` on the embeddings (k = number of classes).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from npairloss_tpu_torch.device import DeviceLike, resolve_device
from npairloss_tpu_torch.ops.kmeans import kmeans_assign

_NEG_FILL = float(-np.finfo(np.float32).max)


def _rank_keys(sims: torch.Tensor) -> torch.Tensor:
    """(B, N) fp32 -> int64 keys whose descending order is ``lax.top_k``'s
    order: larger sim first, the lower column first among equal sims."""
    bits = sims.contiguous().view(torch.int32).to(torch.int64)
    # Flip the magnitude bits of negative floats: the int order becomes
    # the float order (-0.0 just below +0.0).
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    cols = torch.arange(sims.shape[1], dtype=torch.int64, device=sims.device)
    return ordered * (1 << 32) + ((1 << 32) - 1 - cols)


def _unit_rows(embeddings: torch.Tensor, normalize: bool) -> torch.Tensor:
    emb = embeddings.float()
    if normalize:
        emb = emb / torch.clamp_min(
            torch.linalg.vector_norm(emb, dim=1, keepdim=True), 1e-12)
    return emb


def first_hit_ranks(
    embeddings: torch.Tensor,
    labels: torch.Tensor,
    max_k: int,
    query_block: int = 1024,
    normalize: bool = True,
    rows: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """For each query row (every row, or ``rows``), the rank within its
    ``max_k`` nearest gallery rows (self excluded, ``lax.top_k``'s order)
    of its first same-label neighbor; ``max_k`` when there is none.  A
    query is a hit at K exactly when its rank is below K."""
    emb = _unit_rows(embeddings, normalize)
    n = emb.shape[0]
    rows = (torch.arange(n, device=emb.device) if rows is None
            else rows.to(emb.device))
    out = torch.empty((rows.shape[0],), dtype=torch.int64, device=emb.device)
    ranks = torch.arange(max_k, device=emb.device)
    b = int(min(query_block, rows.shape[0]))
    for start in range(0, rows.shape[0], b):
        r = rows[start:start + b]
        sims = torch.matmul(emb[r], emb.T)
        sims[torch.arange(r.shape[0], device=emb.device), r] = _NEG_FILL
        top = torch.topk(_rank_keys(sims), max_k, dim=1).values
        top_idx = (1 << 32) - 1 - (top & 0xFFFFFFFF)
        same = labels[top_idx] == labels[r][:, None]
        out[start:start + b] = torch.where(same, ranks, max_k).amin(dim=1)
    return out


def gallery_recall_at_k(
    embeddings: torch.Tensor,
    labels: torch.Tensor,
    ks: Sequence[int] = (1, 2, 4, 8, 16, 32),
    query_block: int = 1024,
    normalize: bool = True,
) -> Dict[str, torch.Tensor]:
    """Full-gallery Recall@K over one embedding set (queries == gallery),
    on the tensors' device.

    ``embeddings``: (N, D) float (cosine similarity in fp32);
    ``labels``: (N,) int or float class ids.  ``normalize=False`` skips
    the L2 normalization of rows already of unit norm.  Returns
    ``{"recall_at_{k}": 0-d fp32 tensor}``; ks above N - 1 are clamped
    to N - 1 (with the self excluded a query has N - 1 neighbors).
    """
    n = embeddings.shape[0]
    ks = tuple(int(min(k, n - 1)) for k in ks)
    first = first_hit_ranks(embeddings, labels, max(ks), query_block,
                            normalize)
    out = {}
    for k in ks:
        hits = int((first < k).sum())
        # JAX's fp32 mean of a 0/1 column: the exact count times the
        # fp32 reciprocal of n (XLA turns the division by a constant
        # into that product).
        out[f"recall_at_{k}"] = torch.tensor(
            np.float32(hits) * (np.float32(1) / np.float32(n)))
    return out


def evaluate_embeddings(
    embeddings: np.ndarray,
    labels: np.ndarray,
    ks: Sequence[int] = (1, 2, 4, 8, 16, 32),
    query_block: int = 1024,
    device: DeviceLike = None,
) -> Dict[str, float]:
    """Host-side wrapper: numpy in, python floats out, computed on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    out = gallery_recall_at_k(
        torch.as_tensor(np.asarray(embeddings), device=dev),
        torch.as_tensor(np.asarray(labels), device=dev),
        ks=tuple(ks), query_block=query_block)
    return {k: float(v) for k, v in out.items()}


def nmi(labels_a: np.ndarray, labels_b: np.ndarray) -> float:
    """Normalized mutual information, arithmetic normalization
    2*I/(H_a + H_b) (sklearn's default ``average_method='arithmetic'``);
    host-side numpy, as in JAX."""
    a = np.unique(np.asarray(labels_a), return_inverse=True)[1]
    b = np.unique(np.asarray(labels_b), return_inverse=True)[1]
    n = a.shape[0]
    ka, kb = a.max() + 1, b.max() + 1
    cont = np.zeros((ka, kb), np.float64)
    np.add.at(cont, (a, b), 1.0)
    pij = cont / n
    pa = pij.sum(1)
    pb = pij.sum(0)
    nz = pij > 0
    mi = float(np.sum(
        pij[nz] * np.log(pij[nz] / np.outer(pa, pb)[nz])
    ))

    def ent(p):
        return float(-np.sum(p[p > 0] * np.log(p[p > 0])))

    denom = ent(pa) + ent(pb)
    if denom == 0.0:
        return 1.0  # both partitions trivial (single cluster == single class)
    return max(0.0, min(1.0, 2.0 * mi / denom))


def clustering_nmi(
    embeddings: np.ndarray,
    labels: np.ndarray,
    k: int = 0,
    iters: int = 20,
    seed: int = 0,
    first: Optional[int] = None,
    device: DeviceLike = None,
) -> float:
    """NMI(k-means(embeddings), labels); k defaults to #classes.  The
    k-means (farthest-point seeding, ``iters`` Lloyd steps, the final
    assignment over every row) runs on ``device``; ``first`` is the
    first seed point (JAX draws it with ``jax.random``, the port from
    ``np.random.default_rng(seed)``)."""
    emb = np.asarray(embeddings, np.float32)
    emb = emb / np.maximum(
        np.linalg.norm(emb, axis=1, keepdims=True), 1e-12
    )
    k = int(k) or int(np.unique(labels).shape[0])
    x = torch.as_tensor(emb, device=resolve_device(device))
    assign = kmeans_assign(x, k, iters, seed, first=first)
    return nmi(assign.cpu().numpy(), labels)
