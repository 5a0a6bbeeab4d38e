"""GQA attention for training (counterpart of
``repro.models.attention.gqa_attention``).

Projections are plain matrix products; the attention itself goes through
``kernels.ops.flash_attention_op`` on both devices: the CUDA kernel on the
card, its plain version on the CPU. The reference model computes attention
in jnp instead, casting the probabilities to the model type before P·V;
the flash function keeps them in f32, so bf16 results differ at bf16
precision (the f32 results agree to rounding).

Under autograd (an input of the attention requires a gradient) the flash
function's backward kernel computes the attention's gradient.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (apply_rope, dense_init, rms_norm_pair,
                                       torch_dtype)


def init_attn(cfg: ModelConfig, gen: torch.Generator, lead=()):
    dtype = torch_dtype(cfg)
    d, dh = cfg.d_model, cfg.d_head
    p = {"wq": dense_init(gen, (d, cfg.n_heads * dh), dtype, lead=lead),
         "wk": dense_init(gen, (d, cfg.n_kv_heads * dh), dtype, lead=lead),
         "wv": dense_init(gen, (d, cfg.n_kv_heads * dh), dtype, lead=lead),
         "wo": dense_init(gen, (cfg.n_heads * dh, d), dtype, lead=lead)}
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(lead + (dh,), device=gen.device)
        p["k_norm"] = torch.ones(lead + (dh,), device=gen.device)
    return p


def gqa_attention(cfg: ModelConfig, p, x: torch.Tensor,
                  positions: torch.Tensor, *, causal: bool = True
                  ) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D)."""
    if cfg.attn_impl != "gqa":
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r} is not ported (ROADMAP.md, queue 1, "
            f"item 6)")
    B, S, _ = x.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = (x @ p["wq"]).reshape(B, S, H, dh)
    k = (x @ p["wk"]).reshape(B, S, Hkv, dh)
    v = (x @ p["wv"]).reshape(B, S, Hkv, dh)
    if cfg.qk_norm:
        q, k = rms_norm_pair(q, p["q_norm"], k, p["k_norm"])
    pos = positions[:, None, :]
    q = apply_rope(q.transpose(1, 2), pos, cfg.rope_theta)   # (B, H, S, dh)
    k = apply_rope(k.transpose(1, 2), pos, cfg.rope_theta)   # (B, Hkv, S, dh)
    # v and o stay in the projections' (B, S, heads, dh) layout: the
    # kernel takes v as a strided (B, Hkv, S, dh) view, with no copy, and
    # returns o as a (B, H, S, dh) view of a (B, S, H, dh) buffer
    o = ops.flash_attention_op(q, k, v.transpose(1, 2), causal=causal,
                               window=cfg.sliding_window).transpose(1, 2)
    return o.reshape(B, S, H * dh) @ p["wo"]
