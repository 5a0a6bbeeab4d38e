"""Leaf and tree level entry points to the kernels (counterpart of
``repro.kernels.ops``).

Each leaf of a tree draws from its own salted seed (seed ^ i·φ, i the leaf's
index in ``jax.tree.flatten`` order) at row offset 0: the stream of
``zo.tree_noise(dist='counter')``. Threefry noise takes the leaf's own
key instead (fold_in(key, i), ``zo.py``). Which version runs follows the
tensor's device (see ``kernels/zo_update.py``).

Unlike the reference, a replay is one kernel call whatever the number of
records: the TPU kernel kept the records in SMEM and the reference ops layer
split lists past 2048 records into several sweeps, re-casting the leaf
between them. The port is therefore held against the one-cast
``ref.zo_replay_ref``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_pair
from repro_torch.kernels.threefry import threefry_sumsq, threefry_update
from repro_torch.kernels.zo_update import zo_replay_flat, zo_update_flat
from repro_torch.utils import tree

# per-leaf seed decorrelation; the same constant as zo._LEAF_SALT
_LEAF_SALT = 0x9E3779B9


def leaf_seed(seed, leaf_idx: int):
    """Salted counter seed of leaf ``leaf_idx`` (uint32 scalar or array)."""
    return (np.asarray(seed, np.uint32)
            ^ np.uint32((leaf_idx * _LEAF_SALT) & 0xFFFFFFFF))


def zo_update_leaf(x: torch.Tensor, seed, coeff, *, row_offset: int = 0
                   ) -> torch.Tensor:
    """y = x + coeff·u(seed) for a leaf of any shape."""
    return zo_update_flat(x.contiguous(), int(seed), coeff, offset=row_offset)


def zo_update_tree(params: Any, seed, coeff) -> Any:
    """x + coeff·u over a whole tree: ``zo_update_tree(p, record_seeds(key),
    -c)`` equals ``zo.apply_update(p, key, c)``."""
    leaves, spec = tree.flatten(params)
    return tree.unflatten(spec, [zo_update_leaf(x, leaf_seed(seed, i), coeff)
                                 for i, x in enumerate(leaves)])


def zo_perturb_tree(params: Any, seed, eps) -> Any:
    """x + eps·u: the perturbation side of SPSA (same noise stream)."""
    return zo_update_tree(params, seed, eps)


def zo_replay_leaf(x: torch.Tensor, seeds, coeffs: torch.Tensor, *,
                   row_offset: int = 0) -> torch.Tensor:
    """y = x + Σᵢ coeffs[i]·u(seeds[i]) for a leaf of any shape, in one
    read and one write of x whatever N is."""
    return zo_replay_flat(x.contiguous(), seeds, coeffs, offset=row_offset)


def threefry_update_leaf(x: torch.Tensor, key, coeff, *, scale=None
                         ) -> torch.Tensor:
    """y = x + coeff·z(key) (or coeff·z·scale) for a leaf of any shape;
    ``key`` is the leaf's own raw key."""
    return threefry_update(x.contiguous(), key, coeff, scale=scale)


def threefry_sumsq_leaf(x: torch.Tensor, key, acc: torch.Tensor
                        ) -> torch.Tensor:
    """acc += Σ z(key)² over a leaf shaped like x (x itself is not read)."""
    return threefry_sumsq(x.numel(), key, acc)


def flash_attention_op(q, k, v, *, causal: bool = True, window: int = 0):
    return flash_attention(q, k, v, causal=causal, window=window)


def rmsnorm_op(x, scale, *, eps: float = 1e-5):
    return rmsnorm(x, scale, eps=eps)


def rmsnorm_pair_op(xq, sq, xk, sk, *, eps: float = 1e-5):
    return rmsnorm_pair(xq, sq, xk, sk, eps=eps)
