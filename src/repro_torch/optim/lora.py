"""LoRA adapters for the FedLoRA baseline (counterpart of
``repro.optim.lora``; the paper's Fig. 4 memory comparison).

Adapters target the attention projections (wq, wv) of every unit. The
adapter tree mirrors the parameter tree sparsely: {"units": {unit_key:
{"core": {"wq": {"A": A, "B": B}, "wv": {...}}}}} with A (n_units, in, r)
and B (n_units, r, out). ``apply_lora`` materialises W + (α/r)·A@B before
the forward, so gradients with respect to (A, B) flow through
``torch.autograd`` on the composed function.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng
from repro_torch.kernels import ref
from repro_torch.utils import tree

TARGETS = ("wq", "wv")


def init_lora(cfg: ModelConfig, params, rank: int, key) -> Dict:
    """A drawn as the reference draws it: for each unit key of
    ``params["units"]`` in its order and each target in TARGETS, split the
    key and take jax.random.normal(k, (n_units, in, rank)) · 0.01 (the
    port's threefry normal, computed on the host), cast to the target's
    type; B zeros. ``key`` is a raw (2,) uint32 key."""
    key = np.asarray(key, np.uint32)
    out_units: Dict = {}
    for bkey, block in params["units"].items():
        core = block.get("core", {})
        hit = {t: core[t] for t in TARGETS
               if isinstance(core, dict) and t in core}
        if not hit:
            continue
        entry = {}
        for t, w in hit.items():
            n_units, d_in, d_out = w.shape
            key, k1 = prng.split(key)
            z = ref.threefry_normal_ref(k1, n_units * d_in * rank)
            A = (z.reshape(n_units, d_in, rank) * 0.01).to(w.dtype)
            entry[t] = {"A": A.to(w.device),
                        "B": torch.zeros(n_units, rank, d_out,
                                         dtype=w.dtype, device=w.device)}
        out_units[bkey] = {"core": entry}
    return {"units": out_units}


def apply_lora(params, lora, alpha: float = 16.0):
    """W' = W + (α/r)·A@B for the adapted leaves, in f32 and cast to W's
    type; a new tree that shares every other leaf with ``params``."""
    new = dict(params)
    new_units = dict(params["units"])
    for bkey, entry in lora["units"].items():
        blk = dict(new_units[bkey])
        core = dict(blk["core"])
        for t, ab in entry["core"].items():
            r = ab["A"].shape[-1]
            delta = torch.einsum("uir,uro->uio", ab["A"].to(torch.float32),
                                 ab["B"].to(torch.float32)) * (alpha / r)
            core[t] = (core[t].to(torch.float32) + delta).to(core[t].dtype)
        blk["core"] = core
        new_units[bkey] = blk
    new["units"] = new_units
    return new


def lora_param_count(lora) -> int:
    return sum(x.numel() for x in tree.leaves(lora))
