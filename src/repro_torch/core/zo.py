"""Zeroth-order (SPSA) estimation with seed replay (counterpart of
``repro.core.zo``).

A ZO update is the pair (key, coeff): replaying it regenerates u(key)
inside the kernels, so no parameter-sized noise is ever stored. Three
noise distributions, as in the reference:

  'gaussian'  jax.random.normal at each leaf, under the leaf's key
              fold_in(key, i) (i the leaf's index in jax.tree.flatten
              order), through the threefry kernel (``kernels/threefry.py``);
  'sphere'    that gaussian scaled to ‖u‖ = √d over the whole tree (the
              paper's √d·S^{d-1}): one sum-of-squares pass over every leaf,
              then the update with the scale √d/‖z‖ read on the device;
  'counter'   element e of leaf i draws ``counter_gauss2(base ^ i·φ,
              e // 1024, e % 1024)`` with ``base = record_seeds(key)``,
              through the counter kernels (``kernels/zo_update.py``).

Only 'counter' noise replays many records in one sweep
(``fused_replay_updates``); threefry noise replays record by record
(``replay_updates``), each record cast to the leaf's type before the next,
as the reference's scan does.

Keys and seeds are host values (``core/prng.py``); SPSA coefficients stay
on the device and the kernels read them there, so a round never waits for
the device to learn a loss.
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
DISTS = ("gaussian", "sphere", "counter")


def _check_dist(dist: str) -> None:
    if dist not in DISTS:
        raise ValueError(f"perturbation_dist must be one of {DISTS}, got "
                         f"{dist!r}")


def record_seeds(keys) -> np.ndarray:
    """uint32 counter seed(s) from raw key(s): first ^ last key word."""
    raw = np.asarray(keys, np.uint32)
    return raw[..., 0] ^ raw[..., -1]


def _leaf_keys(key, n_leaves: int) -> np.ndarray:
    """(n_leaves, 2): fold_in(key, i) for each leaf i, the reference's
    ``_leaf_keys`` (split's counter layout is fold_in's)."""
    return prng.split(key, n_leaves)


def _sphere_scale(leaves, keys) -> torch.Tensor:
    """√d / ‖z‖ over all leaves, a one-element float32 device tensor: the
    sum of squares leaf by leaf in leaf order, as the reference sums it."""
    acc = torch.zeros(1, dtype=torch.float32, device=leaves[0].device)
    for x, k in zip(leaves, keys):
        ops.threefry_sumsq_leaf(x, k, acc)
    d = sum(x.numel() for x in leaves)
    return float(np.sqrt(np.float32(d))) / torch.sqrt(acc)


def _threefry_tree(params: Params, key, coeff, dist: str) -> Params:
    """x + coeff·u over a tree, u gaussian or sphere."""
    leaves, spec = tree.flatten(params)
    keys = _leaf_keys(key, len(leaves))
    scale = _sphere_scale(leaves, keys) if dist == "sphere" else None
    return tree.unflatten(spec, [
        ops.threefry_update_leaf(x, k, coeff, scale=scale)
        for x, k in zip(leaves, keys)])


def tree_noise(key, params: Params, dist: str = "gaussian") -> Params:
    """u with the structure and shapes of ``params`` (f32 leaves): 0 + 1·u
    through the same update path as ``perturb`` (tests and ``zo_gradient``
    only; training never materialises u)."""
    _check_dist(dist)
    zeros = tree.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params)
    if dist == "counter":
        return ops.zo_update_tree(zeros, record_seeds(key), 1.0)
    return _threefry_tree(zeros, key, 1.0, dist)


def perturb(params: Params, key, scale, dist: str = "gaussian") -> Params:
    """x + scale·u(key), computed in f32 and cast to each leaf's type."""
    _check_dist(dist)
    if dist == "counter":
        return ops.zo_update_tree(params, record_seeds(key), scale)
    return _threefry_tree(params, key, scale, dist)


def apply_update(params: Params, key, coeff, dist: str = "gaussian"
                 ) -> Params:
    """x - coeff·u(key): replay one record."""
    return perturb(params, key, -coeff, dist)


def replay_updates(params: Params, keys, coeffs: torch.Tensor,
                   dist: str = "gaussian") -> Params:
    """Apply N records one after another, each a full sweep of the tree
    cast to the leaves' types (the reference's scan). keys: (N, 2) raw
    keys; coeffs: (N,) tensor."""
    keys = np.asarray(keys, np.uint32).reshape(-1, 2)
    neg = -coeffs.to(torch.float32).reshape(-1)
    for i in range(keys.shape[0]):
        params = perturb(params, keys[i], neg[i], dist)
    return params


def fused_replay_updates(params: Params, keys, coeffs: torch.Tensor,
                         dist: str = "gaussian", impl: str = "auto"
                         ) -> Params:
    """x - Σᵢ cᵢ·u(keyᵢ). For 'counter' noise, one read and one write of
    each leaf whatever N is; threefry noise (and ``impl='scan'``) takes
    ``replay_updates``. impl: 'auto' | 'fused' | 'scan'; 'fused' asserts
    the one-sweep path. keys: (N, 2) raw keys; coeffs: (N,) tensor."""
    _check_dist(dist)
    if impl not in ("auto", "fused", "scan"):
        raise ValueError(f"impl must be auto|fused|scan, got {impl!r}")
    if impl == "scan" or (impl == "auto" and dist != "counter"):
        return replay_updates(params, keys, coeffs, dist)
    if dist != "counter":
        raise ValueError(f"fused replay requires dist='counter', got "
                         f"{dist!r}")
    seeds = record_seeds(keys).reshape(-1)
    neg = -coeffs.to(torch.float32).reshape(-1)
    leaves, spec = tree.flatten(params)
    return tree.unflatten(spec, [
        ops.zo_replay_leaf(x, _leaf_seed(seeds, i), neg)
        for i, x in enumerate(leaves)])


def replay_weighted_records(params: Params, keys, coeffs: torch.Tensor,
                            weights: torch.Tensor, dist: str = "gaussian",
                            impl: str = "auto") -> Params:
    """Replay per-client record stacks under aggregation weights.
    keys: (M, ..., 2); coeffs: (M, ...); weights: (M,). The N = M·(...)
    records get coeff cᵢ·w_m and go through ``fused_replay_updates``."""
    keys = np.asarray(keys, np.uint32)
    coeffs = coeffs.to(torch.float32)
    w = weights.to(torch.float32).reshape((-1,) + (1,) * (coeffs.dim() - 1))
    return fused_replay_updates(params, keys.reshape(-1, keys.shape[-1]),
                                (coeffs * w).reshape(-1), dist, impl)


def spsa_delta(loss_of: Callable[[Params], torch.Tensor], params: Params,
               key, eps: float, dist: str = "gaussian") -> torch.Tensor:
    """δ = f(x+λu) − f(x−λu) for one perturbation. Two forwards."""
    lp = loss_of(perturb(params, key, +eps, dist))
    lm = loss_of(perturb(params, key, -eps, dist))
    return (lp - lm).to(torch.float32)


def spsa_step(loss_of: Callable[[Params], torch.Tensor], params: Params,
              key, eps: float, lr: float, n_perturbations: int = 1,
              dist: str = "gaussian", replay: str = "auto"
              ) -> Tuple[Params, torch.Tensor, Tuple[np.ndarray, torch.Tensor]]:
    """One ZO-SGD step with P-perturbation averaging. Returns (new_params,
    mean_delta, (keys (P, 2), coeffs (P,))); ``replay`` picks the record
    path (see ``fused_replay_updates``)."""
    P = n_perturbations
    pkeys = np.stack([prng.fold_in(key, i) for i in range(P)])
    deltas = torch.stack([spsa_delta(loss_of, params, pkeys[i], eps, dist)
                          for i in range(P)])
    coeffs = lr * deltas / (2.0 * eps * P)
    new_params = fused_replay_updates(params, pkeys, coeffs, dist, replay)
    return new_params, deltas.mean(), (pkeys, coeffs)


def zo_gradient(loss_of: Callable[[Params], torch.Tensor], params: Params,
                key, eps: float, n_perturbations: int = 1,
                dist: str = "gaussian") -> Params:
    """The ZO gradient estimate as a tree (tests and analysis only:
    training replays records and never builds it)."""
    P = n_perturbations
    g = tree.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params)
    for i in range(P):
        k = prng.fold_in(key, i)
        d = spsa_delta(loss_of, params, k, eps, dist)
        u = tree_noise(k, params, dist)
        g = tree.tree_map(lambda a, n: a + (d / (2 * eps * P)) * n, g, u)
    return g
