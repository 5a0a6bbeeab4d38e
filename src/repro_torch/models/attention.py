"""GQA and MLA attention for training, prefill and decode (counterpart of
``repro.models.attention``'s GQA half: ``gqa_attention``,
``gqa_cache_len``, ``gqa_init_cache``, ``gqa_decode``; and its MLA half:
``_mla_q``, ``mla_attention``, ``mla_init_cache``, ``mla_decode``).

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
queued (ROADMAP.md, queue 2).

MLA (multi-head latent attention, DeepSeek-V2): each position keeps a
kv_lora_rank latent c_kv (RMSNormed) and one qk_rope_dim rope key shared
by the heads; each head's nope key and value are rebuilt from c_kv by
``wkv_b``. Training and prefill attend through the flash kernel at
(d_qk, d_v) = (nope + rope, v_head_dim), (192, 128) for deepseek-v2, with
no window; under autograd (FedAvg) its backward kernel at the same pair
computes the attention's gradient, and the latent's and q's norms take
the RMSNorm backward kernel at widths kv_lora_rank and q_lora_rank.
Decode attends over the compressed cache with the absorbed weights, in
plain PyTorch as the reference's einsums.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (apply_rope, dense_init, rms_norm_pair,
                                       rms_norm_simple, torch_dtype)

NEG_INF = -1e30


def init_attn(cfg: ModelConfig, gen: torch.Generator, lead=()):
    if cfg.attn_impl == "mla":
        return init_mla(cfg, gen, lead)
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


def init_mla(cfg: ModelConfig, gen: torch.Generator, lead=()):
    """MLA's weights with the reference's keys, shapes and dtypes: the
    query through 'wq_a' (D, q_lora_rank), 'q_norm' and 'wq_b' where
    q_lora_rank > 0 (else one 'wq'); the latent and the shared rope key
    through 'wkv_a' (D, r + rope) and 'kv_norm'; each head's nope key and
    value through 'wkv_b' (r, H·(nope + v)); and 'wo'. Norm scales f32."""
    dtype = torch_dtype(cfg)
    d, H, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    p = {"wkv_a": dense_init(gen, (d, r + cfg.qk_rope_dim), dtype, lead=lead),
         "kv_norm": torch.ones(lead + (r,), device=gen.device),
         "wkv_b": dense_init(gen, (r, H * (cfg.qk_nope_dim + cfg.v_head_dim)),
                             dtype, lead=lead),
         "wo": dense_init(gen, (H * cfg.v_head_dim, d), dtype, lead=lead)}
    if cfg.q_lora_rank > 0:
        p["wq_a"] = dense_init(gen, (d, cfg.q_lora_rank), dtype, lead=lead)
        p["q_norm"] = torch.ones(lead + (cfg.q_lora_rank,), device=gen.device)
        p["wq_b"] = dense_init(gen, (cfg.q_lora_rank, H * qk), dtype,
                               lead=lead)
    else:
        p["wq"] = dense_init(gen, (d, H * qk), dtype, lead=lead)
    return p


def require_gqa(cfg: ModelConfig) -> None:
    if cfg.attn_impl != "gqa":
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r} has no GQA projections: use the "
            f"mla_* functions (ROADMAP.md, queue 1, item 6)")


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
    """The flash attention of ``qkv``'s (or ``mla_qkv``'s) outputs, over
    the config's window, then the output product: (B, S, D)."""
    B, H, S, _ = q.shape
    # v and o stay in the projections' (B, S, heads, d) layout: the
    # kernel takes v as a strided (B, Hkv, S, d_v) view, with no copy, and
    # returns o as a (B, H, S, d_v) view of a (B, S, H, d_v) buffer
    o = ops.flash_attention_op(q, k, v, causal=causal,
                               window=cfg.sliding_window)
    return o.transpose(1, 2).reshape(B, S, H * v.shape[-1]) @ p["wo"]


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


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------

def _mla_q(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) -> q (B, S, H, nope + rope), before rope."""
    B, S = x.shape[:2]
    if cfg.q_lora_rank > 0:
        q = rms_norm_simple(x @ p["wq_a"], p["q_norm"]) @ p["wq_b"]
    else:
        q = x @ p["wq"]
    return q.reshape(B, S, cfg.n_heads, cfg.qk_nope_dim + cfg.qk_rope_dim)


def mla_qkv(cfg: ModelConfig, p, x: torch.Tensor, positions: torch.Tensor):
    """MLA's operands for the flash kernel, and what the decode cache keeps
    of the positions: x (B, S, D) -> (q, k, v, {"c_kv", "k_rope"}).

    q (B, H, S, nope + rope) with its rope half rotated; k (B, H, S, nope +
    rope), each head's nope key beside the rope key the heads share; v a
    strided (B, H, S, v_head_dim) view of c_kv @ wkv_b's (B, S, H, nope +
    v) layout, read in place by the kernel; c_kv (B, S, r) the normed
    latent and k_rope (B, S, rope) the rotated shared key."""
    B, S, _ = x.shape
    H, nope, r = cfg.n_heads, cfg.qk_nope_dim, cfg.kv_lora_rank
    pos = positions[:, None, :]
    q = _mla_q(cfg, p, x).transpose(1, 2)                # (B, H, S, qk)
    q = torch.cat([q[..., :nope], apply_rope(q[..., nope:], pos,
                                             cfg.rope_theta)], -1)
    kv_a = x @ p["wkv_a"]                                # (B, S, r + rope)
    # the latent is a slice of kv_a's rows: the norm kernel reads rows
    # that lie contiguously
    c_kv = rms_norm_simple(kv_a[..., :r].contiguous(), p["kv_norm"])
    k_rope = apply_rope(kv_a[:, None, :, r:], pos, cfg.rope_theta)[:, 0]
    kv = (c_kv @ p["wkv_b"]).reshape(B, S, H, nope + cfg.v_head_dim)
    k = torch.cat([kv[..., :nope],
                   k_rope[:, :, None, :].expand(B, S, H, cfg.qk_rope_dim)],
                  -1).transpose(1, 2)
    v = kv[..., nope:].transpose(1, 2)
    return q, k, v, {"c_kv": c_kv, "k_rope": k_rope}


def mla_attention(cfg: ModelConfig, p, x: torch.Tensor,
                  positions: torch.Tensor, *, causal: bool = True
                  ) -> torch.Tensor:
    """Full-sequence MLA, x: (B, S, D) -> (B, S, D): scores over nope +
    rope dims scaled by 1/√(nope + rope). The reference's MLA takes no
    window; the MLA configs have none (sliding_window 0)."""
    q, k, v, _ = mla_qkv(cfg, p, x, positions)
    return attend(cfg, p, q, k, v, causal=causal)


def mla_init_cache(cfg: ModelConfig, batch: int, seq_len: int, lead=(),
                   device="cuda"):
    """{"c_kv": (*lead, B, S, r), "k_rope": (*lead, B, S, rope)}: zeros in
    the model type, seq_len positions (no window)."""
    dtype = torch_dtype(cfg)
    lead = tuple(lead) + (batch, seq_len)
    return {"c_kv": torch.zeros(lead + (cfg.kv_lora_rank,), dtype=dtype,
                                device=device),
            "k_rope": torch.zeros(lead + (cfg.qk_rope_dim,), dtype=dtype,
                                  device=device)}


def mla_decode(cfg: ModelConfig, p, x: torch.Tensor, cache, pos: int):
    """Absorbed-weight MLA decode over the compressed cache. x: (B, 1, D);
    pos: the token's absolute position. Writes its c_kv and k_rope into
    the cache's slot pos in place, and returns (out (B, 1, D), cache).

        score_h = (q_nope_h · W_kb_h) · c_kv + q_rope_h · k_rope
        out_h   = (probs · c_kv) · W_vb_h

    Plain PyTorch in the reference's order: the absorbed products in the
    model type, the two score products summed in f32, the probabilities
    cast to the model type."""
    B = x.shape[0]
    H, nope, vd, r = (cfg.n_heads, cfg.qk_nope_dim, cfg.v_head_dim,
                      cfg.kv_lora_rank)
    cc, rc = cache["c_kv"], cache["k_rope"]
    posb = torch.full((B, 1, 1), pos, dtype=torch.int64, device=x.device)
    q = _mla_q(cfg, p, x)[:, 0]                          # (B, H, qk)
    q_rope = apply_rope(q[:, :, None, nope:], posb, cfg.rope_theta)[:, :, 0]
    kv_a = (x @ p["wkv_a"])[:, 0]                        # (B, r + rope)
    cc[:, pos] = rms_norm_simple(kv_a[:, :r].contiguous(), p["kv_norm"])
    rc[:, pos] = apply_rope(kv_a[:, None, None, r:], posb,
                            cfg.rope_theta)[:, 0, 0]
    wkv_b = p["wkv_b"].reshape(r, H, nope + vd)
    q_abs = torch.einsum("bhn,rhn->bhr", q[..., :nope], wkv_b[..., :nope])
    f32 = torch.float32
    scale = 1.0 / math.sqrt(nope + cfg.qk_rope_dim)
    scores = (torch.einsum("bhr,btr->bht", q_abs.to(f32), cc.to(f32))
              + torch.einsum("bhn,btn->bht", q_rope.to(f32), rc.to(f32))
              ) * scale
    valid = torch.arange(cc.shape[1], device=x.device) <= pos
    probs = torch.softmax(scores.masked_fill(~valid, NEG_INF),
                          dim=-1).to(x.dtype)
    o_lat = torch.einsum("bht,btr->bhr", probs, cc)
    out = torch.einsum("bhr,rhv->bhv", o_lat, wkv_b[..., nope:])
    return out.reshape(B, 1, H * vd) @ p["wo"], cache
