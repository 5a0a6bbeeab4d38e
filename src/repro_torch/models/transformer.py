"""Dense decoder LM and the split-point machinery (counterpart of
``repro.models.transformer``, dense ``attn`` path).

Parameters are a nested dict of tensors whose per-layer leaves are stacked
along a leading ``n_units`` dim, as in the reference: the ZO noise is laid
out over each leaf's elements, so per-layer modules would change the noise.
The reference's ``lax.scan`` over units is a Python loop over that dim.

Everything here is differentiable with ``torch.autograd`` (the first-order
baselines take gradients of ``loss_fn``): attention and RMSNorm through
their kernels' autograd Functions, the bf16 head product on the card
through ``_LogitsF32``.

Batch: {"tokens": (B, S) int, "labels": (B, S) int}.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (apply_mlp, apply_norm, dense_init,
                                       embed_init, init_mlp, init_norm,
                                       torch_dtype)
from repro_torch.utils import tree

Params = Dict[str, Any]


def _require_dense(cfg: ModelConfig) -> None:
    if (cfg.block_pattern != ("attn",) or cfg.moe is not None
            or cfg.is_encoder_decoder or cfg.n_image_tokens):
        raise NotImplementedError(
            f"{cfg.name}: only the dense attn decoder is ported (ROADMAP.md, "
            f"queue 1, item 6)")


# ===========================================================================
# init
# ===========================================================================

def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random parameters on ``gen.device``, with the reference's shapes,
    dtypes and init scales."""
    _require_dense(cfg)
    dtype = torch_dtype(cfg)
    lead = (cfg.n_units,)
    block = {"norm1": init_norm(cfg, cfg.d_model, gen.device, lead),
             "core": attn.init_attn(cfg, gen, lead)}
    if cfg.d_ff > 0:
        block["norm2"] = init_norm(cfg, cfg.d_model, gen.device, lead)
        block["ffn"] = init_mlp(cfg, gen, cfg.d_model, cfg.d_ff, lead)
    params: Params = {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype),
        "units": {"b0": block},
        "final_norm": init_norm(cfg, cfg.d_model, gen.device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                       dtype)
    return params


def param_count(params: Params) -> int:
    return sum(x.numel() for x in tree.leaves(params))


class _MetaGenerator(torch.Generator):
    """A CPU generator whose ``device`` reads 'meta': ``init_params`` with
    it builds every leaf on the meta device (shapes, no storage)."""
    device = torch.device("meta")


def split_dims(cfg: ModelConfig, cut_units: int) -> Tuple[int, int]:
    """(d_c, d_s) parameter counts for a cut (used by theory and the cut
    planner), counted as ``repro.models.split_dims`` counts them: the tree
    is built on the meta device, so nothing is allocated; a tied model
    counts the server's untied head copy on the server side."""
    shapes = init_params(cfg, _MetaGenerator())
    total = param_count(shapes)
    per_unit = param_count(shapes["units"]) // cfg.n_units
    d_c = shapes["embed"].numel() + cut_units * per_unit
    extra_head = 0 if "lm_head" in shapes else shapes["embed"].numel()
    return d_c, total - d_c + extra_head


# ===========================================================================
# blocks
# ===========================================================================

def _apply_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 positions: torch.Tensor, *, causal: bool) -> torch.Tensor:
    h = apply_norm(cfg, p["norm1"], x)
    x = x + attn.gqa_attention(cfg, p["core"], h, positions, causal=causal)
    if "ffn" in p:
        x = x + apply_mlp(cfg, p["ffn"], apply_norm(cfg, p["norm2"], x))
    return x


def _unbind_units(units: Params):
    """The stacked units as a list of per-unit trees. Each leaf is unbound
    once, so a backward stacks the units' gradients of a leaf in one copy
    (an index or a slice of a leaf would give its gradient a zero-filled
    leaf of its own)."""
    leaves, spec = tree.flatten(units)
    return [tree.unflatten(spec, parts)
            for parts in zip(*(a.unbind(0) for a in leaves))]


def _unit_scan(cfg: ModelConfig, units, x: torch.Tensor,
               positions: torch.Tensor, *, causal: bool = True
               ) -> torch.Tensor:
    """Apply the units in order: a stacked tree or a list of unit trees."""
    if isinstance(units, dict):
        units = _unbind_units(units)
    for unit in units:
        x = _apply_block(cfg, unit["b0"], x, positions, causal=causal)
    return x


# ===========================================================================
# split / merge and the two halves of the forward
# ===========================================================================

def split_params(cfg: ModelConfig, params: Params, cut_units: int):
    """client = embed + units[:cut]; server = units[cut:] + final norm +
    head. A tied model is untied at the cut (the server owns a head)."""
    _check_cut(cfg, cut_units)
    head = _head(params)                          # (D, V) head layout
    client = {"embed": params["embed"],
              "units": tree.tree_map(lambda a: a[:cut_units],
                                     params["units"])}
    server = {"final_norm": params["final_norm"], "lm_head": head,
              "units": tree.tree_map(lambda a: a[cut_units:],
                                     params["units"])}
    return client, server


def merge_params(cfg: ModelConfig, client: Params, server: Params) -> Params:
    """Inverse of split_params."""
    return {"embed": client["embed"],
            "final_norm": server["final_norm"],
            "lm_head": server["lm_head"],
            "units": tree.tree_map(lambda a, b: torch.cat([a, b], 0),
                                   client["units"], server["units"])}


def untie_params(cfg: ModelConfig, params: Params) -> Params:
    """Give a tied model its own head copy (once, at training setup), so
    split/merge keep one tree structure."""
    if "lm_head" in params:
        return params
    out = dict(params)
    out["lm_head"] = params["embed"].T.contiguous()
    return out


def _positions(batch_size: int, seq: int, device) -> torch.Tensor:
    return torch.arange(seq, device=device).expand(batch_size, seq)


def client_forward(cfg: ModelConfig, client: Params, batch) -> Dict:
    """Client prefix -> the cut-layer activation {"h": (B, S, D)}."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = client["embed"][tokens]
    x = _unit_scan(cfg, client["units"], x,
                   _positions(B, S, tokens.device), causal=True)
    return {"h": x}


def server_forward(cfg: ModelConfig, server: Params, h: Dict, batch
                   ) -> torch.Tensor:
    """Server suffix from the cut activation -> scalar loss (f32)."""
    x = h["h"]
    B, S, _ = x.shape
    x = _unit_scan(cfg, server["units"], x, _positions(B, S, x.device),
                   causal=True)
    x = apply_norm(cfg, server["final_norm"], x)
    return _chunked_ce(x, server["lm_head"], batch["labels"])


def _check_cut(cfg: ModelConfig, cut_units: int) -> None:
    _require_dense(cfg)
    if not 1 <= cut_units <= cfg.n_units:
        raise ValueError(f"cut_units={cut_units} outside [1, {cfg.n_units}]")


def _final_hidden(cfg: ModelConfig, params: Params, batch, cut_units: int
                  ) -> torch.Tensor:
    """The final norm's output (B, S, D): the client's units [:cut], then
    the server's [cut:], as ``split_params`` would give them, but from
    one unbind of each leaf, so a backward stacks each leaf's gradient
    once (``split_params``' two slices would each fill a zero gradient
    of the whole leaf)."""
    _check_cut(cfg, cut_units)
    units = _unbind_units(params["units"])
    tokens = batch["tokens"]
    B, S = tokens.shape
    pos = _positions(B, S, tokens.device)
    x = params["embed"][tokens]
    x = _unit_scan(cfg, units[:cut_units], x, pos, causal=True)
    x = _unit_scan(cfg, units[cut_units:], x, pos, causal=True)
    return apply_norm(cfg, params["final_norm"], x)


def _head(params: Params) -> torch.Tensor:
    head = params.get("lm_head")
    return params["embed"].T if head is None else head


def forward_from_cut(cfg: ModelConfig, params: Params, batch, cut_units: int
                     ) -> torch.Tensor:
    """Full loss via client/server composition (cut-invariant)."""
    return _chunked_ce(_final_hidden(cfg, params, batch, cut_units),
                       _head(params), batch["labels"])


def loss_fn(cfg: ModelConfig, params: Params, batch) -> torch.Tensor:
    return forward_from_cut(cfg, params, batch, cfg.default_cut_units)


def logits_fn(cfg: ModelConfig, params: Params, batch) -> torch.Tensor:
    """Full-sequence logits (B, S, V) in the model's type (small configs and
    the sentiment accuracy's last-position logits)."""
    x = _final_hidden(cfg, params, batch, cfg.default_cut_units)
    return x @ _head(params)


class _LogitsF32(torch.autograd.Function):
    """(N, D) @ (D, V) of bf16 operands into f32 logits in one cuBLAS
    product on the card; the backward is two bf16 products of the incoming
    gradient, cast to bf16 (the gradients are bf16 in any case)."""

    @staticmethod
    def forward(ctx, x, head):
        ctx.save_for_backward(x, head)
        return torch.mm(x, head, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, head = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = g @ head.t() if ctx.needs_input_grad[0] else None
        dhead = x.t() @ g if ctx.needs_input_grad[1] else None
        return dx, dhead


def _logits_f32(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """(B, c, D) @ (D, V) -> f32 logits from exact products of the
    model-type operands summed in f32: the reference's
    ``preferred_element_type=f32``. On the card a bf16 product writes f32
    directly (``_LogitsF32``); elsewhere the operands are cast to f32
    first."""
    if x.is_cuda and x.dtype == torch.bfloat16:
        B, c, D = x.shape
        return _LogitsF32.apply(x.reshape(B * c, D), head).reshape(B, c, -1)
    return x.to(torch.float32) @ head.to(torch.float32)


def _chunked_ce(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                chunk: int = 2048) -> torch.Tensor:
    """Mean cross-entropy over sequence chunks (bounds the (B, c, V)
    logits buffer); labels < 0 are ignored."""
    S = x.shape[1]
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for s0 in range(0, S, chunk):
        logits = _logits_f32(x[:, s0:s0 + chunk], head)
        lc = labels[:, s0:s0 + chunk]
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, lc.clamp(min=0)[..., None])[..., 0]
        mask = (lc >= 0).to(torch.float32)
        tot = tot + ((logz - gold) * mask).sum()
        cnt = cnt + mask.sum()
    return tot / cnt.clamp(min=1.0)
