"""k-means for the IVF index: farthest-point seeding + Lloyd's.

Port of ``npairloss_tpu/ops/kmeans.py`` in plain torch (these are XLA
ops in the JAX package, not Pallas kernels).  Same math: farthest-point
seeding from one random first point (ties to the lowest index), Lloyd
steps where an empty cluster keeps its centroid, and a streamed
nearest-centroid assignment in fixed row blocks.

One deliberate difference: JAX draws the first seed point with
``jax.random.randint(PRNGKey(seed))``, whose bits the port cannot
reproduce.  The port draws it from ``np.random.default_rng(seed)`` and
takes an explicit ``first=`` index, which the parity tests fill with the
index JAX drew.  Indexes built by the two packages from one seed differ
in their first centroid; a committed ``.gidx`` loads in either.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from npairloss_tpu_torch.device import DeviceLike, resolve_device


def _sq_dists(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(N, k) squared distances by the expansion trick."""
    return ((x * x).sum(1, keepdim=True) - 2.0 * (x @ centroids.T)
            + (centroids * centroids).sum(1)[None, :])


def first_index(n: int, seed: int) -> int:
    """The port's draw of the first seed point."""
    return int(np.random.default_rng(seed).integers(n))


def farthest_point_init(x: torch.Tensor, k: int, seed: int = 0,
                        first: Optional[int] = None) -> torch.Tensor:
    """Deterministic farthest-point seeding on ``x``'s device; (k, d)."""
    x = x.float()
    n, d = x.shape
    if first is None:
        first = first_index(n, seed)
    centroids = torch.zeros((k, d), dtype=torch.float32, device=x.device)
    centroids[0] = x[int(first)]
    min_sq = torch.full((n,), float("inf"), device=x.device)
    for i in range(1, k):
        sq = ((x - centroids[i - 1]) ** 2).sum(1)
        min_sq = torch.minimum(min_sq, sq)
        centroids[i] = x[torch.argmax(min_sq)]  # first maximum wins
    return centroids


def _lloyd_step(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    k = centroids.shape[0]
    assign = torch.argmin(_sq_dists(x, centroids), dim=1)
    # One-hot matmul as in JAX: a deterministic sum order (index_add_
    # would take atomics on the card).
    one_hot = torch.nn.functional.one_hot(assign, k).float()
    counts = one_hot.sum(0)
    sums = one_hot.T @ x
    return torch.where(counts[:, None] > 0,
                       sums / torch.clamp_min(counts[:, None], 1.0),
                       centroids)


def lloyd_iterate(x: torch.Tensor, centroids: torch.Tensor,
                  iters: int = 20) -> torch.Tensor:
    x = x.float()
    for _ in range(int(iters)):
        centroids = _lloyd_step(x, centroids)
    return centroids


def kmeans_assign(x: torch.Tensor, k: int, iters: int = 20, seed: int = 0,
                  first: Optional[int] = None) -> torch.Tensor:
    """Lloyd's k-means over the whole set on ``x``'s device; the (N,)
    cluster assignment (the NMI protocol's entry, as in JAX: seeding,
    ``iters`` Lloyd steps and the final argmin over every row)."""
    x = x.float()
    centroids = farthest_point_init(x, k, seed, first=first)
    centroids = lloyd_iterate(x, centroids, iters)
    return torch.argmin(_sq_dists(x, centroids), dim=1)


def assign_to_centroids(embeddings: np.ndarray, centroids: np.ndarray,
                        block: int = 65536,
                        device: DeviceLike = None) -> np.ndarray:
    """Full-set nearest-centroid assignment in ``block``-row slabs;
    numpy in, (N,) int32 out."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(embeddings, np.float32), device=dev)
    c = torch.as_tensor(np.asarray(centroids, np.float32), device=dev)
    out = torch.empty((x.shape[0],), dtype=torch.int32, device=dev)
    for start in range(0, x.shape[0], int(block)):
        q = x[start:start + int(block)]
        out[start:start + q.shape[0]] = torch.argmin(
            _sq_dists(q, c), dim=1).to(torch.int32)
    return out.cpu().numpy()


def kmeans_fit(embeddings: np.ndarray, k: int, iters: int = 20,
               seed: int = 0, train_size: Optional[int] = None,
               first: Optional[int] = None,
               device: DeviceLike = None) -> np.ndarray:
    """Fit centroids at gallery scale on a seeded ``train_size``-row
    subsample (numpy's generator, as in JAX); returns host (k, d) fp32.
    ``first`` indexes the training set."""
    dev = resolve_device(device)
    x = np.asarray(embeddings, np.float32)
    n = x.shape[0]
    if n == 0:
        raise ValueError("cannot fit k-means on an empty set")
    train = x
    if train_size is not None and n > int(train_size):
        sel = np.random.default_rng(seed).choice(
            n, size=int(train_size), replace=False)
        sel.sort()
        train = x[sel]
    k = int(min(k, train.shape[0]))
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    xd = torch.as_tensor(train, device=dev)
    centroids = farthest_point_init(xd, k, seed, first=first)
    centroids = lloyd_iterate(xd, centroids, iters)
    return centroids.cpu().numpy()
