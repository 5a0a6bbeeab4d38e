"""GQA attention for training, prefill and decode (counterpart of
``repro.models.attention``'s GQA half: ``gqa_attention``,
``gqa_cache_len``, ``gqa_init_cache``, ``gqa_decode``).

Projections are plain matrix products; the attention itself goes through
``kernels.ops.flash_attention_op`` on both devices: the CUDA kernel on the
card, its plain version on the CPU. The reference model computes attention
in jnp instead, casting the probabilities to the model type before P·V;
the flash function keeps them in f32, so bf16 results differ at bf16
precision (the f32 results agree to rounding).

Under autograd (an input of the attention requires a gradient) the flash
function's backward kernel computes the attention's gradient.

Decode attends one query to the cache in plain PyTorch, as the reference
does in einsums (no Pallas kernel there); a hand-written decode kernel is
queued (ROADMAP.md, queue 2). MLA is not ported (queue 1, item 6).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (apply_rope, dense_init, rms_norm_pair,
                                       torch_dtype)

NEG_INF = -1e30


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


def require_gqa(cfg: ModelConfig) -> None:
    if cfg.attn_impl != "gqa":
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r} is not ported (ROADMAP.md, queue 1, "
            f"item 6)")


def qkv(cfg: ModelConfig, p, x: torch.Tensor, positions: torch.Tensor):
    """The projections of x (B, S, D), qk-normed and rotated: q (B, H, S,
    dh), k (B, Hkv, S, dh), and v as a (B, Hkv, S, dh) view of the
    projection's (B, S, Hkv, dh) layout."""
    require_gqa(cfg)
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
    return q, k, v.transpose(1, 2)


def attend(cfg: ModelConfig, p, q, k, v, *, causal: bool = True
           ) -> torch.Tensor:
    """The flash attention of ``qkv``'s outputs, then the output product:
    (B, S, D)."""
    B, H, S, dh = q.shape
    # v and o stay in the projections' (B, S, heads, dh) layout: the
    # kernel takes v as a strided (B, Hkv, S, dh) view, with no copy, and
    # returns o as a (B, H, S, dh) view of a (B, S, H, dh) buffer
    o = ops.flash_attention_op(q, k, v, causal=causal,
                               window=cfg.sliding_window).transpose(1, 2)
    return o.reshape(B, S, H * dh) @ p["wo"]


def gqa_attention(cfg: ModelConfig, p, x: torch.Tensor,
                  positions: torch.Tensor, *, causal: bool = True
                  ) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D)."""
    q, k, v = qkv(cfg, p, x, positions)
    return attend(cfg, p, q, k, v, causal=causal)


# ---------------------------------------------------------------------------
# decode (one token, ring-buffered KV cache for a sliding window)
# ---------------------------------------------------------------------------

def gqa_cache_len(cfg: ModelConfig, seq_len: int) -> int:
    return (min(seq_len, cfg.sliding_window) if cfg.sliding_window > 0
            else seq_len)


def gqa_init_cache(cfg: ModelConfig, batch: int, seq_len: int, lead=(),
                   device="cuda"):
    """{"k", "v"}: zeros (*lead, B, Hkv, Sc, dh) in the model type."""
    shape = tuple(lead) + (batch, cfg.n_kv_heads, gqa_cache_len(cfg, seq_len),
                           cfg.d_head)
    dtype = torch_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_decode(cfg: ModelConfig, p, x: torch.Tensor, cache, pos: int):
    """x: (B, 1, D); pos: the token's absolute position. Writes its k and v
    into the cache's slot (pos mod Sc with a window: a ring) in place, and
    returns (out (B, 1, D), cache).

    Plain PyTorch, as the reference's einsums: the scores of the model-type
    q and k summed in f32, masked to the slots written so far, and the
    probabilities cast to the model type before P·V."""
    require_gqa(cfg)
    B = x.shape[0]
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    G = H // Hkv
    ck, cv = cache["k"], cache["v"]
    Sc = ck.shape[2]
    q = (x @ p["wq"]).reshape(B, H, 1, dh)
    k = (x @ p["wk"]).reshape(B, Hkv, 1, dh)
    v = (x @ p["wv"]).reshape(B, Hkv, 1, dh)
    if cfg.qk_norm:
        q, k = rms_norm_pair(q, p["q_norm"], k, p["k_norm"])
    posb = torch.full((B, 1, 1), pos, dtype=torch.int64, device=x.device)
    q = apply_rope(q, posb, cfg.rope_theta).reshape(B, Hkv, G, dh)
    k = apply_rope(k, posb, cfg.rope_theta)
    slot = pos % Sc if cfg.sliding_window > 0 else pos
    ck[:, :, slot] = k[:, :, 0]
    cv[:, :, slot] = v[:, :, 0]
    scale = 1.0 / math.sqrt(dh)
    scores = (q.to(torch.float32) @ ck.to(torch.float32).transpose(-1, -2)
              ) * scale                                       # (B,Hkv,G,Sc)
    valid = torch.arange(Sc, device=x.device) <= pos
    scores = scores.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = (probs @ cv).reshape(B, 1, H * dh)
    return out @ p["wo"], cache
