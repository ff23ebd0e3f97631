"""Deterministic per-partition batch pipeline.

Each decentralized node k draws minibatches from its own partition P_k
(shuffled per-epoch with a node-specific seed).  ``stacked_batches`` yields
(K, B, ...) arrays — the layout the vmap'd simulation backend consumes.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


class PartitionLoader:
    def __init__(self, x: np.ndarray, y: np.ndarray, batch: int, seed: int):
        assert len(x) == len(y) and len(x) >= batch, (len(x), batch)
        self.x, self.y, self.batch = x, y, batch
        self.rng = np.random.default_rng(seed)
        self._order = self.rng.permutation(len(x))
        self._ptr = 0

    def next(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._ptr + self.batch > len(self.x):
            self._order = self.rng.permutation(len(self.x))
            self._ptr = 0
        idx = self._order[self._ptr:self._ptr + self.batch]
        self._ptr += self.batch
        return self.x[idx], self.y[idx]


class DecentralizedLoader:
    """K per-partition loaders with a single stacked-batch interface."""

    def __init__(self, parts: Sequence[Tuple[np.ndarray, np.ndarray]],
                 batch: int, seed: int = 0):
        self.loaders = [PartitionLoader(x, y, batch, seed + 17 * k)
                        for k, (x, y) in enumerate(parts)]
        self.n_nodes = len(parts)
        self.samples_per_epoch = min(len(x) for x, _ in parts)
        self.steps_per_epoch = max(1, self.samples_per_epoch // batch)

    def next_stacked(self) -> Tuple[np.ndarray, np.ndarray]:
        xs, ys = zip(*(ld.next() for ld in self.loaders))
        return np.stack(xs), np.stack(ys)

    def sample_train_subset(self, node: int, n: int, seed: int = 0
                            ) -> Tuple[np.ndarray, np.ndarray]:
        """Random subset of node's training data — used by SkewScout's
        model-traveling accuracy probe."""
        ld = self.loaders[node]
        rng = np.random.default_rng(seed)
        idx = rng.choice(len(ld.x), size=min(n, len(ld.x)), replace=False)
        return ld.x[idx], ld.y[idx]
