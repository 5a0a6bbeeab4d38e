"""Federated host loader (a numpy copy of ``repro.data.loader`` without
the JAX mesh placement). Batch contents are a pure function of (seed,
round, client), so the port sees the reference's batches bit for bit, and
materialising only the K clients that start a sparse version
(``subset_batch``) draws the rows they get in the fleet-width batch."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.obs.trace import span


def client_pools(client_indices: List[np.ndarray]) -> List[np.ndarray]:
    """Per-client index pools; an empty pool samples from the union of
    all pools (raises if every pool is empty)."""
    pools = [np.asarray(p) for p in client_indices]
    nonempty = [p for p in pools if p.size]
    if not nonempty:
        raise ValueError("client_pools: all client index pools are "
                         "empty — no data to sample")
    if len(nonempty) < len(pools):
        global_pool = np.concatenate(nonempty)
        pools = [p if p.size else global_pool for p in pools]
    return pools


def make_client_batches(dataset, client_indices: List[np.ndarray],
                        round_idx: int, batch_per_client: int,
                        seed: int = 0, *,
                        client_ids: Optional[Sequence[int]] = None,
                        pools: Optional[List[np.ndarray]] = None,
                        ) -> Dict[str, np.ndarray]:
    """Stack per-client batches -> leaves with a leading client dim.
    ``client_ids`` selects a subset, in the given order: (K, ...) rows, row
    j equal to the fleet-width stack's row client_ids[j] (each client's
    rng is keyed on (seed, round, client id)). ``pools`` are pre-resolved
    ``client_pools``."""
    if pools is None:
        pools = client_pools(client_indices)
    ids = range(len(pools)) if client_ids is None else client_ids
    outs = []
    for m in ids:
        m = int(m)
        rng = np.random.default_rng((seed, round_idx, m))
        pool = pools[m]
        take = rng.choice(pool.size, size=batch_per_client,
                          replace=pool.size < batch_per_client)
        outs.append(dataset.batch(pool[take]))
    return {k: np.stack([o[k] for o in outs]) for k in outs[0]}


@dataclasses.dataclass
class FederatedLoader:
    dataset: object
    client_indices: List[np.ndarray]
    batch_per_client: int
    seed: int = 0

    def __post_init__(self):
        self.pools = client_pools(self.client_indices)

    def round_batch(self, round_idx: int) -> Dict[str, np.ndarray]:
        """Host (M, B, ...) arrays for round ``round_idx``."""
        return make_client_batches(self.dataset, self.client_indices,
                                   round_idx, self.batch_per_client,
                                   self.seed, pools=self.pools)

    def subset_batch(self, round_idx: int,
                     client_ids: Sequence[int]) -> Dict[str, np.ndarray]:
        """(K, ...) host rows for exactly ``client_ids``, bit-exact with
        ``round_batch(round_idx)[client_ids]``: the sparse engine's O(K)
        staging path."""
        with span("loader.subset_batch", round=round_idx,
                  k=len(client_ids)):
            return make_client_batches(self.dataset, self.client_indices,
                                       round_idx, self.batch_per_client,
                                       self.seed, client_ids=client_ids,
                                       pools=self.pools)
