"""Label-skew partitioning (paper §3, "Non-IID Data Partitions").

``skew`` controls the fraction of the dataset partitioned *by label*; the
rest is spread uniformly at random.  skew=1.0 reproduces §4-5's exclusive
label partitioning (each label lives in exactly one partition, labels dealt
round-robin); skew=0.0 is the IID setting; intermediate values reproduce §6.

Also: ``partition_80_20`` (Appendix F's K=10 setting: 80% of one class +
20% of another per node) and ``partition_by_region`` (Flickr-Mammal's
real-world geo partitioning).
"""
from __future__ import annotations

from typing import List

import numpy as np


def partition_label_skew(y: np.ndarray, n_nodes: int, skew: float,
                         seed: int = 0) -> List[np.ndarray]:
    """Returns per-node index arrays.  ``skew`` in [0, 1]."""
    assert 0.0 <= skew <= 1.0, skew
    rng = np.random.default_rng(seed)
    n = len(y)
    n_classes = int(y.max()) + 1
    perm = rng.permutation(n)
    n_skewed = int(round(skew * n))
    skewed, iid = perm[:n_skewed], perm[n_skewed:]

    parts: List[List[int]] = [[] for _ in range(n_nodes)]
    # skewed portion: labels dealt to nodes round-robin (class c -> node
    # c % K), giving each node a disjoint label set when K divides classes
    node_of_class = np.array([c % n_nodes for c in range(n_classes)])
    for i in skewed:
        parts[node_of_class[y[i]]].append(i)
    # iid portion: uniform
    for j, i in enumerate(iid):
        parts[j % n_nodes].append(i)
    out = [np.asarray(sorted(p), dtype=np.int64) for p in parts]
    # guard: every node needs data
    for k, p in enumerate(out):
        assert len(p) > 0, f"node {k} received no data (K={n_nodes})"
    return out


def partition_80_20(y: np.ndarray, n_nodes: int, major: float = 0.8,
                    seed: int = 0) -> List[np.ndarray]:
    """Appendix F: each node has ``major`` of one class and the rest of
    another (requires n_classes == n_nodes)."""
    rng = np.random.default_rng(seed)
    n_classes = int(y.max()) + 1
    assert n_classes == n_nodes, (n_classes, n_nodes)
    by_class = [rng.permutation(np.where(y == c)[0]) for c in range(n_classes)]
    parts = [[] for _ in range(n_nodes)]
    for c in range(n_classes):
        idx = by_class[c]
        cut = int(round(major * len(idx)))
        parts[c].extend(idx[:cut])
        parts[(c + 1) % n_nodes].extend(idx[cut:])
    return [np.asarray(sorted(p), dtype=np.int64) for p in parts]


def partition_by_region(region: np.ndarray, n_nodes: int
                        ) -> List[np.ndarray]:
    """Real-world geo partitioning: node k = region k (Flickr-Mammal)."""
    return [np.where(region == k)[0].astype(np.int64)
            for k in range(n_nodes)]


def label_distribution(y: np.ndarray, parts: List[np.ndarray]
                       ) -> np.ndarray:
    """(K, n_classes) empirical label distribution per partition."""
    n_classes = int(y.max()) + 1
    dist = np.zeros((len(parts), n_classes))
    for k, p in enumerate(parts):
        cnt = np.bincount(y[p], minlength=n_classes)
        dist[k] = cnt / max(cnt.sum(), 1)
    return dist


def skew_index(y: np.ndarray, parts: List[np.ndarray]) -> float:
    """Mean total-variation distance between per-partition label
    distributions and the global one — a scalar 'degree of skew'."""
    dist = label_distribution(y, parts)
    glob = np.bincount(y, minlength=dist.shape[1]) / len(y)
    return float(np.mean(np.abs(dist - glob).sum(axis=1) / 2.0))
