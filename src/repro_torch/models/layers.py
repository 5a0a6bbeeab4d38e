"""Primitive layers: norms, RoPE, MLPs, init (counterpart of
``repro.models.layers``).

Plain functions over dicts of tensors. Norm math runs in f32 and casts back
to the input type; RMSNorm runs through ``kernels.ops.rmsnorm_op``. Init
draws from a ``torch.Generator`` with the reference's shapes, dtypes and
scales (not its numbers).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape: Tuple[int, ...], dtype, *,
               lead: Tuple[int, ...] = ()) -> torch.Tensor:
    """Truncated-normal (±2σ) fan-in init of a ``shape`` weight, stacked
    over ``lead`` (the unit dim); fan-in is ``shape[0]``."""
    scale = 1.0 / math.sqrt(max(shape[0], 1))
    w = torch.empty(lead + tuple(shape), dtype=torch.float32,
                    device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, shape: Tuple[int, ...], dtype
               ) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * 0.02).to(dtype)


def init_norm(cfg: ModelConfig, d: int, device, lead: Tuple[int, ...] = ()):
    if cfg.norm_type == "rmsnorm":
        return {"scale": torch.ones(lead + (d,), device=device)}
    if cfg.norm_type == "layernorm":
        return {"scale": torch.ones(lead + (d,), device=device),
                "bias": torch.zeros(lead + (d,), device=device)}
    if cfg.norm_type == "nonparam_ln":      # OLMo: no learned affine
        return {}
    raise ValueError(cfg.norm_type)


def init_mlp(cfg: ModelConfig, gen: torch.Generator, d_model: int, d_ff: int,
             lead: Tuple[int, ...] = ()):
    dtype = torch_dtype(cfg)
    p = {"wi": dense_init(gen, (d_model, d_ff), dtype, lead=lead)}
    if cfg.mlp_type == "swiglu":
        p["wg"] = dense_init(gen, (d_model, d_ff), dtype, lead=lead)
    p["wo"] = dense_init(gen, (d_ff, d_model), dtype, lead=lead)
    return p


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def apply_norm(cfg: ModelConfig, p, x: torch.Tensor, eps: float = 1e-5
               ) -> torch.Tensor:
    """RMSNorm goes through the rmsnorm kernel; the LayerNorms (no Pallas
    kernel in the reference) stay plain PyTorch."""
    if cfg.norm_type == "rmsnorm":
        return ops.rmsnorm_op(x, p["scale"], eps=eps)
    xf = x.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    if cfg.norm_type == "layernorm":
        out = out * p["scale"] + p["bias"]
    return out.to(x.dtype)


def rms_norm_simple(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
                    ) -> torch.Tensor:
    """Standalone RMSNorm (qk-norm), through the rmsnorm kernel."""
    return ops.rmsnorm_op(x, scale, eps=eps)


def rms_norm_pair(q: torch.Tensor, q_scale: torch.Tensor, k: torch.Tensor,
                  k_scale: torch.Tensor, eps: float = 1e-5):
    """``rms_norm_simple`` of q and of k (the qk-norm) in one launch of the
    pair kernel."""
    return ops.rmsnorm_pair_op(q, q_scale, k, k_scale, eps=eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, d_head); positions broadcastable to (..., S). Rotates
    interleaved pairs (x[..., 0::2], x[..., 1::2]) over the whole head."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    ang = positions[..., None].to(torch.float32) * inv     # (..., S, d/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def apply_mlp(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_type == "swiglu":
        h = F.silu(x @ p["wi"]) * (x @ p["wg"])
    else:  # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ p["wi"], approximate="tanh")
    return h @ p["wo"]
