"""Mixture-of-Experts block (counterpart of ``repro.models.moe``): top-k
routing with static-shape, sort-based capacity dispatch, optional shared
always-on experts, and the Switch load-balancing aux loss.

Dispatch is grouped per batch row, as the reference's ``vmap`` of
``_moe_one_group``: each row routes, sorts and scatters its own tokens
with a per-row capacity C (a multiple of 8), and a token past an expert's
capacity goes to the trash slot C, which is dropped. The rows run side by
side here as a leading batch dim.

What keeps the port's routing equal to the reference's:
- the router product runs in full f32 (``full_f32``: no TF32 on the card);
- the top-k takes the lower expert index on ties, as ``jax.lax.top_k``
  does (a stable descending sort, where ``torch.topk`` promises no order);
- the dispatch order is a stable argsort;
- a token's k contributions are added in k order in the model type, as the
  reference's ``.at[tok].add`` does on the CPU (no ``index_add_``, which
  takes atomics on CUDA).
The expert products are batched matrix products (``apply_mlp_expert``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (apply_mlp, apply_mlp_expert,
                                       dense_init, full_f32, init_mlp,
                                       torch_dtype)


def moe_dims(cfg: ModelConfig):
    m = cfg.moe
    d_expert = m.d_expert if m.d_expert > 0 else cfg.d_ff
    return m.n_experts, m.top_k, m.n_shared, d_expert


def init_moe(cfg: ModelConfig, gen: torch.Generator, lead=()):
    """Router (D, E) f32 at scale 0.02, experts (E, D, F) / (E, F, D) in
    the model type, stacked over ``lead``."""
    dtype = torch_dtype(cfg)
    E, _, n_shared, d_e = moe_dims(cfg)
    d = cfg.d_model
    p = {"router": dense_init(gen, (d, E), torch.float32, lead=lead,
                              scale=0.02),
         "wi": dense_init(gen, (E, d, d_e), dtype, lead=lead),
         "wo": dense_init(gen, (E, d_e, d), dtype, lead=lead)}
    if cfg.mlp_type == "swiglu":
        p["wg"] = dense_init(gen, (E, d, d_e), dtype, lead=lead)
    if n_shared > 0:
        p["shared"] = init_mlp(cfg, gen, d, n_shared * d_e, lead)
    return p


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    m = cfg.moe
    c = int(n_tokens * m.top_k * m.capacity_factor / m.n_experts)
    return max(8, (c + 7) // 8 * 8)


def route(cfg: ModelConfig, p, x: torch.Tensor):
    """x: (B, N, D) -> (gates (B, N, k) renormalised, experts (B, N, k),
    aux (B,) f32). The top-k is a stable descending sort: on ties the
    lower expert index comes first."""
    E, k, _, _ = moe_dims(cfg)
    with full_f32():
        logits = x.to(torch.float32) @ p["router"]              # (B, N, E)
    probs = torch.softmax(logits, dim=-1)
    gate_k, idx_k = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_k, idx_k = gate_k[..., :k], idx_k[..., :k]
    gate_k = gate_k / gate_k.sum(-1, keepdim=True)
    # Switch-style load balancing: E · Σ_e f_e · P_e, per group
    me = probs.mean(1)                                          # (B, E)
    ce = _one_hot(idx_k[..., 0], E).to(torch.float32).mean(1)
    aux = E * (me * ce).sum(-1)
    return gate_k, idx_k, aux


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot`` without its range check, which reads the indices back
    to the host on the card."""
    return idx[..., None] == torch.arange(n, device=idx.device)


def dispatch_slots(idx_k: torch.Tensor, n_experts: int, cap: int):
    """Each (token, choice)'s rank among its expert's entries in token-major
    order (the reference's stable argsort): (slot (B, N·k), kept (B, N·k)),
    slot = cap (the trash slot) where the rank reaches the capacity."""
    B = idx_k.shape[0]
    e_flat = idx_k.reshape(B, -1)
    n = e_flat.shape[1]
    counts = _one_hot(e_flat, n_experts).sum(1)                 # (B, E)
    starts = counts.cumsum(-1) - counts
    order = torch.argsort(e_flat, dim=-1, stable=True)
    rank_sorted = (torch.arange(n, device=e_flat.device)
                   - starts.gather(1, e_flat.gather(1, order)))
    rank = torch.empty_like(rank_sorted).scatter_(1, order, rank_sorted)
    kept = rank < cap
    return torch.where(kept, rank, cap), kept


def apply_moe(cfg: ModelConfig, p, x: torch.Tensor):
    """x: (B, S, D) -> (out (B, S, D), aux scalar f32, the mean of the
    rows' aux)."""
    B, N, D = x.shape
    E, k, n_shared, _ = moe_dims(cfg)
    C = capacity(cfg, N)
    gate_k, idx_k, aux = route(cfg, p, x)
    slot, kept = dispatch_slots(idx_k, E, C)
    e_flat = idx_k.reshape(B, N * k)
    rows = torch.arange(B, device=x.device)[:, None]
    tok = torch.arange(N, device=x.device).repeat_interleave(k)   # (N·k,)
    buf = x.new_zeros((B, E, C + 1, D))
    buf[rows, e_flat, slot] = x[:, tok]
    expert_out = apply_mlp_expert(cfg, p, buf[:, :, :C])        # (B,E,C,D)
    gathered = expert_out[rows, e_flat, slot.clamp(max=C - 1)]  # (B,N·k,D)
    w = torch.where(kept, gate_k.reshape(B, N * k), 0.0).to(x.dtype)
    parts = (gathered * w[..., None]).reshape(B, N, k, D)
    out = parts[:, :, 0]
    for j in range(1, k):                   # k order, in the model type
        out = out + parts[:, :, j]
    if n_shared > 0:
        out = out + apply_mlp(cfg, p["shared"], x)
    return out, aux.mean()
