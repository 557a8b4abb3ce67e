"""Synthetic identity-balanced data — for tests, smoke runs and benchmarks
(a copy of ``npairloss_tpu/data/synthetic.py``; numpy only, so both
packages draw the same batches from one seed).

Honors the MultibatchData batch contract (identity_num_per_batch x
img_num_per_identity, def.prototxt:25-27): every query has exactly
img_num_per_identity - 1 in-batch positives, the invariant the mining
statistics rely on (SURVEY.md §3.5).
"""

from __future__ import annotations

from typing import Iterator, Sequence, Tuple

import numpy as np


def synthetic_identity_batches(
    num_identities: int,
    identity_num_per_batch: int,
    img_num_per_identity: int,
    input_shape: Sequence[int],
    noise: float = 0.5,
    seed: int = 0,
    num_classes_total: int | None = None,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yields (inputs, labels): inputs are per-identity Gaussian clusters."""
    rng = np.random.default_rng(seed)
    total = num_classes_total or num_identities
    dim = int(np.prod(input_shape))
    centers = rng.standard_normal((total, dim)).astype(np.float32)
    while True:
        ids = rng.choice(total, size=identity_num_per_batch, replace=False)
        labels = np.repeat(ids, img_num_per_identity).astype(np.int32)
        x = centers[labels] + noise * rng.standard_normal(
            (len(labels), dim)
        ).astype(np.float32)
        yield x.reshape(len(labels), *input_shape), labels
