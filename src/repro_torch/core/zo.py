"""Zeroth-order (SPSA) estimation with seed replay, counter noise
(counterpart of ``repro.core.zo``).

A ZO update is the pair (key, coeff): replaying it regenerates
u(key) inside the kernels, so no parameter-sized noise is ever stored.
Element e of leaf i draws ``counter_gauss2(base ^ i·φ, e // 1024, e % 1024)``
with ``base = record_seeds(key)``, the stream of the reference's
``tree_noise(dist='counter')``, its Pallas kernels and its oracles.

Keys and seeds are host values (``core/prng.py``); SPSA coefficients stay
on the device and the kernels read them there, so a round never waits for
the device to learn a loss.

Only ``dist='counter'`` is ported. 'gaussian' and 'sphere' (threefry noise
through jax.random.normal) are queued in ROADMAP.md, queue 1, item 4.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.kernels import ops
from repro_torch.kernels.ops import leaf_seed as _leaf_seed
from repro_torch.utils import tree

Params = Any


def _require_counter(dist: str) -> None:
    if dist != "counter":
        raise NotImplementedError(
            f"perturbation_dist={dist!r} is not ported: repro_torch has the "
            f"'counter' noise only; 'gaussian'/'sphere' are queued in "
            f"ROADMAP.md, queue 1, item 4")


def record_seeds(keys) -> np.ndarray:
    """uint32 counter seed(s) from raw key(s): first ^ last key word."""
    raw = np.asarray(keys, np.uint32)
    return raw[..., 0] ^ raw[..., -1]


def tree_noise(key, params: Params, dist: str = "counter") -> Params:
    """u with the structure and shapes of ``params`` (f32 leaves):
    0 + 1·u through the same update path as ``perturb``."""
    _require_counter(dist)
    zeros = tree.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params)
    return ops.zo_update_tree(zeros, record_seeds(key), 1.0)


def perturb(params: Params, key, scale, dist: str = "counter") -> Params:
    """x + scale·u(key), computed in f32 and cast to each leaf's type."""
    _require_counter(dist)
    return ops.zo_update_tree(params, record_seeds(key), scale)


def apply_update(params: Params, key, coeff, dist: str = "counter"
                 ) -> Params:
    """x - coeff·u(key): replay one record."""
    return perturb(params, key, -coeff, dist)


def fused_replay_updates(params: Params, keys, coeffs: torch.Tensor,
                         dist: str = "counter") -> Params:
    """x - Σᵢ cᵢ·u(keyᵢ) in one read and one write of each leaf.
    keys: (N, 2) raw keys; coeffs: (N,) tensor."""
    _require_counter(dist)
    seeds = record_seeds(keys).reshape(-1)
    neg = -coeffs.to(torch.float32).reshape(-1)
    leaves, spec = tree.flatten(params)
    return tree.unflatten(spec, [
        ops.zo_replay_leaf(x, _leaf_seed(seeds, i), neg)
        for i, x in enumerate(leaves)])


def replay_weighted_records(params: Params, keys, coeffs: torch.Tensor,
                            weights: torch.Tensor,
                            dist: str = "counter") -> Params:
    """Replay per-client record stacks under aggregation weights.
    keys: (M, ..., 2); coeffs: (M, ...); weights: (M,). The N = M·(...)
    records get coeff cᵢ·w_m and go through ``fused_replay_updates``."""
    keys = np.asarray(keys, np.uint32)
    coeffs = coeffs.to(torch.float32)
    w = weights.to(torch.float32).reshape((-1,) + (1,) * (coeffs.dim() - 1))
    return fused_replay_updates(params, keys.reshape(-1, keys.shape[-1]),
                                (coeffs * w).reshape(-1), dist)


def spsa_delta(loss_of: Callable[[Params], torch.Tensor], params: Params,
               key, eps: float, dist: str = "counter") -> torch.Tensor:
    """δ = f(x+λu) − f(x−λu) for one perturbation. Two forwards."""
    lp = loss_of(perturb(params, key, +eps, dist))
    lm = loss_of(perturb(params, key, -eps, dist))
    return (lp - lm).to(torch.float32)


def spsa_step(loss_of: Callable[[Params], torch.Tensor], params: Params,
              key, eps: float, lr: float, n_perturbations: int = 1,
              dist: str = "counter"
              ) -> Tuple[Params, torch.Tensor, Tuple[np.ndarray, torch.Tensor]]:
    """One ZO-SGD step with P-perturbation averaging. Returns (new_params,
    mean_delta, (keys (P, 2), coeffs (P,)))."""
    P = n_perturbations
    pkeys = np.stack([prng.fold_in(key, i) for i in range(P)])
    deltas = torch.stack([spsa_delta(loss_of, params, pkeys[i], eps, dist)
                          for i in range(P)])
    coeffs = lr * deltas / (2.0 * eps * P)
    new_params = fused_replay_updates(params, pkeys, coeffs, dist)
    return new_params, deltas.mean(), (pkeys, coeffs)
