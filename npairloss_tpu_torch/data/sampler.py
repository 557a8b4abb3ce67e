"""Identity-balanced batch sampling — the MultibatchData contract (a
copy of ``npairloss_tpu/data/sampler.py``; numpy only, so both packages
draw the same index stream from one seed).

The reference's data layer builds every batch as ``identity_num_per_batch``
identities x ``img_num_per_identity`` images (usage/def.prototxt:25-27,
SURVEY.md §3.5).  This is load-bearing for the loss: it guarantees every
query has img_num_per_identity - 1 in-batch positives locally (and
2G - 1 globally), which the mining statistics assume (reference:
npair_multi_class_loss.cu:243-250 expects non-empty ident lists).

``rand_identity`` picks identities uniformly at random each batch;
otherwise identities cycle in (shuffled) order.  Images within an identity
are drawn without replacement until the identity's pool is exhausted, then
reshuffled — with replacement only when an identity has fewer images than
``img_num_per_identity``.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence

import numpy as np


class IdentityBalancedSampler:
    """Yields index batches of shape [ids_per_batch * imgs_per_id]."""

    def __init__(
        self,
        labels: Sequence[int],
        identity_num_per_batch: int,
        img_num_per_identity: int,
        rand_identity: bool = True,
        shuffle: bool = True,
        seed: int = 0,
    ):
        labels = np.asarray(labels)
        self.by_identity: Dict[int, np.ndarray] = {}
        for lbl in np.unique(labels):
            self.by_identity[int(lbl)] = np.flatnonzero(labels == lbl)
        self.identities = np.array(sorted(self.by_identity), dtype=np.int64)
        if len(self.identities) < identity_num_per_batch:
            raise ValueError(
                f"need >= {identity_num_per_batch} identities, have "
                f"{len(self.identities)}"
            )
        self.ids_per_batch = int(identity_num_per_batch)
        self.imgs_per_id = int(img_num_per_identity)
        self.rand_identity = bool(rand_identity)
        self.shuffle = bool(shuffle)
        self.rng = np.random.default_rng(seed)
        # Per-identity draw-without-replacement cursors.
        self._pools: Dict[int, List[int]] = {}
        # Sequential identity cursor for rand_identity=false.
        self._id_order = self.identities.copy()
        if self.shuffle:
            self.rng.shuffle(self._id_order)
        self._id_pos = 0

    def _draw_images(self, identity: int) -> List[int]:
        pool = self.by_identity[identity]
        if len(pool) < self.imgs_per_id:
            # Degenerate identity: sample with replacement (the batch
            # contract must hold for the mining statistics).
            return list(self.rng.choice(pool, size=self.imgs_per_id))
        out: List[int] = []
        while len(out) < self.imgs_per_id:
            cached = self._pools.get(identity)
            if not cached:
                # Refill, excluding this batch's picks so a group never
                # contains the same image twice (the loss would see a
                # zero-distance positive and skew the mining statistics).
                cached = [int(i) for i in pool if int(i) not in out]
                if self.shuffle:
                    self.rng.shuffle(cached)
                self._pools[identity] = cached
            out.append(int(cached.pop()))
        return out

    def _next_identities(self) -> np.ndarray:
        if self.rand_identity:
            return self.rng.choice(
                self.identities, size=self.ids_per_batch, replace=False
            )
        chosen: List[int] = []
        while len(chosen) < self.ids_per_batch:
            if self._id_pos >= len(self._id_order):
                self._id_pos = 0
                if self.shuffle:
                    self.rng.shuffle(self._id_order)
            cand = int(self._id_order[self._id_pos])
            self._id_pos += 1
            # A mid-batch wrap + reshuffle may resurface an identity this
            # batch already holds; skip it to keep batch identities
            # distinct (the contract the mining statistics assume).
            if cand not in chosen:
                chosen.append(cand)
        return np.array(chosen)

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        idx: List[int] = []
        for identity in self._next_identities():
            idx.extend(self._draw_images(int(identity)))
        return np.array(idx, dtype=np.int64)
