"""Carry parameter trees between the JAX package's layout and the port's.

Both packages keep nested dicts of stacked arrays with the same keys and
shapes, so conversion is leaf by leaf. bf16 crosses through a 16-bit
integer view, as ``repro/ckpt/checkpoint.py`` stores it, which keeps every
bit and needs no bf16 type in numpy on the way in.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.utils import tree


def from_jax_params(params: Any, device="cpu") -> Any:
    """Tree of numpy arrays (or anything ``np.asarray`` takes, such as jax
    arrays) -> tree of tensors on ``device``."""
    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a.copy())
        return t.to(device)
    return tree.tree_map(leaf, params)


def to_jax_params(params: Any) -> Any:
    """Tree of tensors -> tree of numpy arrays (bf16 as ml_dtypes.bfloat16,
    the type jax arrays are made from)."""
    def leaf(t):
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            import ml_dtypes
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()
    return tree.tree_map(leaf, params)
