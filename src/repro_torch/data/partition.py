"""Dirichlet non-IID partition (a numpy copy of
``repro.data.partition.dirichlet_partition``)."""
from __future__ import annotations

from typing import List

import numpy as np


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float,
                        seed: int = 0, min_per_client: int = 1
                        ) -> List[np.ndarray]:
    """Split sample indices among clients with Dir(alpha) class proportions.
    Returns disjoint index arrays covering all samples, each holding at
    least ``min_per_client``. Smaller alpha = more heterogeneity."""
    rng = np.random.default_rng(seed)
    buckets: List[List[int]] = [[] for _ in range(n_clients)]
    for c in np.unique(labels):
        idx = np.where(labels == c)[0]
        rng.shuffle(idx)
        p = rng.dirichlet(np.full(n_clients, alpha))
        cuts = (np.cumsum(p) * len(idx)).astype(int)[:-1]
        for m, part in enumerate(np.split(idx, cuts)):
            buckets[m].extend(part.tolist())
    for m in range(n_clients):           # rebalance empties
        while len(buckets[m]) < min_per_client:
            donor = int(np.argmax([len(b) for b in buckets]))
            buckets[m].append(buckets[donor].pop())
    return [np.asarray(sorted(b), np.int64) for b in buckets]
