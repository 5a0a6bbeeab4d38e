"""Decoder LM, the split-point machinery and the serving paths
(counterpart of ``repro.models.transformer`` for decoders whose
``block_pattern`` is made of ``attn`` blocks (GQA or MLA), ``mamba``
blocks and xLSTM's ``mlstm`` and ``slstm`` blocks, dense or
mixture-of-experts: the attention decoders' ``("attn",)``, jamba's 8-block
hybrid and xlstm-350m's mlstm ×3, slstm). An xLSTM block has no
feed-forward, whatever ``d_ff`` says.

Parameters are a nested dict of tensors whose per-layer leaves are stacked
along a leading ``n_units`` dim, as in the reference: the ZO noise is laid
out over each leaf's elements, so per-layer modules would change the noise.
A unit is one repetition of the pattern, its blocks ``units["b0"]`` ...
``units["b{L-1}"]``, block j an MoE block where ``cfg.layer_uses_moe(j)``
holds; the SFL cut lands on unit boundaries. The reference's ``lax.scan``
over units is a Python loop over that dim, each unit's blocks in order.

Everything in the training half is differentiable with ``torch.autograd``
(the first-order baselines take gradients of ``loss_fn``): attention and
RMSNorm through their kernels' autograd Functions, the bf16 head product
on the card through ``_LogitsF32``; MLA's attention through the flash
backward at its head dims (192, 128); a Mamba block's selective scan
through its backward kernel (``kernels/selective_scan.py``). An MoE
block returns its
load-balancing aux loss beside x; the client's sum rides the cut in
``h["aux"]`` and the server adds ``MOE_AUX_COEF`` times the whole sum to
its loss.

Serving (``init_cache``, ``prefill``, ``decode_step``) keeps one cache a
block position, stacked over the units, as the reference does:
- GQA: {"k", "v"} (n_units, B, Hkv, Sc, dh), Sc the sequence length or,
  with a sliding window shorter than it, the window (a ring: position t
  lives in slot t mod Sc);
- MLA: the compressed {"c_kv" (n_units, B, S, kv_lora_rank), "k_rope"
  (n_units, B, S, qk_rope_dim)}, no window; decode rebuilds the heads'
  keys and values through the absorbed weights;
- Mamba: the recurrent state {"h" (n_units, B, d_inner, d_state) f32,
  "conv" (n_units, B, d_conv - 1, d_inner)};
- mLSTM: {"C" (n_units, B, H, dh, dh), "n" (n_units, B, H, dh), "m"
  (n_units, B, H)}, f32;
- sLSTM: {"c", "n", "m", "h"} (n_units, B, H, dh), f32;
every "m" stabiliser starting at -1e30, as the reference's ``init_cache``
patches it.
``decode_step`` writes the new token's entries (a Mamba, mLSTM or sLSTM
block's new state) into the cache in place.
Prefill attends through the flash kernel (GQA with the window where the
prompt exceeds it; the reference's banded form ``_banded_swa`` computes
the same and is not ported; MLA at its (192, 128) head dims), and keeps
what it computed for the cache, right-padded to the cache's length.

Batch: {"tokens": (B, S) int, "labels": (B, S) int}; decode: a (B, 1)
token.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm
from repro_torch.models.layers import (apply_mlp, apply_norm, dense_init,
                                       embed_init, init_mlp, init_norm,
                                       torch_dtype)
from repro_torch.utils import tree

Params = Dict[str, Any]

MOE_AUX_COEF = 0.01


_PORTED_BLOCKS = {"attn", "mamba", "mlstm", "slstm"}
_XLSTM_BLOCKS = ("mlstm", "slstm")


def _require_ported(cfg: ModelConfig) -> None:
    """Admit patterns of GQA or MLA ``attn`` blocks, ``mamba`` blocks and
    xLSTM's ``mlstm`` and ``slstm`` blocks, dense or MoE."""
    if (not set(cfg.block_pattern) <= _PORTED_BLOCKS
            or cfg.attn_impl not in ("gqa", "mla")
            or cfg.is_encoder_decoder or cfg.n_image_tokens):
        raise NotImplementedError(
            f"{cfg.name}: only decoders of GQA or MLA attn blocks, Mamba "
            f"blocks and xLSTM blocks (dense or MoE) are ported; "
            f"cross-attention and encoder-decoder models follow (ROADMAP.md, "
            f"queue 1, item 6)")


# ===========================================================================
# init
# ===========================================================================

def _has_ffn(cfg: ModelConfig, btype: str) -> bool:
    """An attention or Mamba block has its feed-forward where the config
    has one; an xLSTM block is self-contained and has none."""
    if btype in _XLSTM_BLOCKS:
        return False
    return cfg.d_ff > 0 or cfg.moe is not None


_INIT_CORE = {"mamba": ssm.init_mamba, "mlstm": ssm.init_mlstm,
              "slstm": ssm.init_slstm, "attn": attn.init_attn}


def _init_block(cfg: ModelConfig, gen: torch.Generator, btype: str,
                pos_in_unit: int, lead) -> Params:
    """Block ``pos_in_unit`` of the pattern, stacked over ``lead``: norm1
    and its core (attention, Mamba, mLSTM or sLSTM), then, where
    ``_has_ffn`` holds, norm2 and its feed-forward, an MoE where
    ``cfg.layer_uses_moe(pos_in_unit)`` holds."""
    block = {"norm1": init_norm(cfg, cfg.d_model, gen.device, lead),
             "core": _INIT_CORE[btype](cfg, gen, lead)}
    if _has_ffn(cfg, btype):
        block["norm2"] = init_norm(cfg, cfg.d_model, gen.device, lead)
        block["ffn"] = (moe_lib.init_moe(cfg, gen, lead)
                        if cfg.layer_uses_moe(pos_in_unit)
                        else init_mlp(cfg, gen, cfg.d_model, cfg.d_ff, lead))
    return block


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random parameters on ``gen.device``, with the reference's shapes,
    dtypes and init scales."""
    _require_ported(cfg)
    dtype = torch_dtype(cfg)
    lead = (cfg.n_units,)
    units = {f"b{j}": _init_block(cfg, gen, bt, j, lead)
             for j, bt in enumerate(cfg.block_pattern)}
    params: Params = {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype),
        "units": units,
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

def _ffn(cfg: ModelConfig, p: Params, x: torch.Tensor):
    """The block's feed-forward on norm2(x): (y, aux) for an MoE block,
    (y, None) for an MLP."""
    h = apply_norm(cfg, p["norm2"], x)
    if "router" in p["ffn"]:
        return moe_lib.apply_moe(cfg, p["ffn"], h)
    return apply_mlp(cfg, p["ffn"], h), None


# the recurrent blocks' full-sequence forwards: (y, final state)
_FORWARD = {"mamba": ssm.mamba_forward, "mlstm": ssm.mlstm_forward,
            "slstm": ssm.slstm_forward}


def _apply_block(cfg: ModelConfig, p: Params, btype: str, x: torch.Tensor,
                 positions: torch.Tensor, *, causal: bool):
    """One block, full sequence: (x, aux or None)."""
    h = apply_norm(cfg, p["norm1"], x)
    if btype in _FORWARD:
        x = x + _FORWARD[btype](cfg, p["core"], h)[0]
    else:
        core = (attn.mla_attention if cfg.attn_impl == "mla"
                else attn.gqa_attention)
        x = x + core(cfg, p["core"], h, positions, causal=causal)
    if "ffn" not in p:
        return x, None
    y, aux = _ffn(cfg, p, x)
    return x + y, aux


def _add(a: Optional[torch.Tensor], b: Optional[torch.Tensor]):
    return b if a is None else a if b is None else a + b


def _unbind_units(units: Params):
    """The stacked units as a list of per-unit trees. Each leaf is unbound
    once, so a backward stacks the units' gradients of a leaf in one copy
    (an index or a slice of a leaf would give its gradient a zero-filled
    leaf of its own)."""
    leaves, spec = tree.flatten(units)
    return [tree.unflatten(spec, parts)
            for parts in zip(*(a.unbind(0) for a in leaves))]


def _unit_scan(cfg: ModelConfig, units, x: torch.Tensor,
               positions: torch.Tensor, *, causal: bool = True):
    """Apply the units in order (a stacked tree or a list of unit trees):
    (x, the summed aux of the MoE blocks, None if there is none)."""
    if isinstance(units, dict):
        units = _unbind_units(units)
    aux = None
    for unit in units:
        for j, bt in enumerate(cfg.block_pattern):
            x, a = _apply_block(cfg, unit[f"b{j}"], bt, x, positions,
                                causal=causal)
            aux = _add(aux, a)
    return x, aux


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
    """Client prefix -> the cut-layer activation {"h": (B, S, D), "aux":
    the client's MoE aux loss, f32 (0.0 for a dense model)}."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = client["embed"][tokens]
    x, aux = _unit_scan(cfg, client["units"], x,
                        _positions(B, S, tokens.device), causal=True)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return {"h": x, "aux": aux}


def server_forward(cfg: ModelConfig, server: Params, h: Dict, batch
                   ) -> torch.Tensor:
    """Server suffix from the cut activation -> scalar loss (f32), plus
    ``MOE_AUX_COEF`` times the client's and the server's aux for an MoE
    model."""
    x = h["h"]
    B, S, _ = x.shape
    x, aux = _unit_scan(cfg, server["units"], x, _positions(B, S, x.device),
                        causal=True)
    x = apply_norm(cfg, server["final_norm"], x)
    loss = _chunked_ce(x, server["lm_head"], batch["labels"])
    return _with_aux(cfg, loss, _add(h.get("aux"), aux))


def _with_aux(cfg: ModelConfig, loss: torch.Tensor, aux) -> torch.Tensor:
    """loss + MOE_AUX_COEF·aux for an MoE model; a dense model's aux is
    0.0 and its loss is returned as it is."""
    if cfg.moe is None or aux is None:
        return loss
    return loss + MOE_AUX_COEF * aux


def _check_cut(cfg: ModelConfig, cut_units: int) -> None:
    _require_ported(cfg)
    if not 1 <= cut_units <= cfg.n_units:
        raise ValueError(f"cut_units={cut_units} outside [1, {cfg.n_units}]")


def _final_hidden(cfg: ModelConfig, params: Params, batch, cut_units: int):
    """(the final norm's output (B, S, D), the summed aux or None): the
    client's units [:cut], then the server's [cut:], as ``split_params``
    would give them, but from one unbind of each leaf, so a backward stacks
    each leaf's gradient once (``split_params``' two slices would each fill
    a zero gradient of the whole leaf)."""
    _check_cut(cfg, cut_units)
    units = _unbind_units(params["units"])
    tokens = batch["tokens"]
    B, S = tokens.shape
    pos = _positions(B, S, tokens.device)
    x = params["embed"][tokens]
    x, aux_c = _unit_scan(cfg, units[:cut_units], x, pos, causal=True)
    x, aux_s = _unit_scan(cfg, units[cut_units:], x, pos, causal=True)
    return apply_norm(cfg, params["final_norm"], x), _add(aux_c, aux_s)


def _head(params: Params) -> torch.Tensor:
    head = params.get("lm_head")
    return params["embed"].T if head is None else head


def forward_from_cut(cfg: ModelConfig, params: Params, batch, cut_units: int
                     ) -> torch.Tensor:
    """Full loss via client/server composition (cut-invariant)."""
    x, aux = _final_hidden(cfg, params, batch, cut_units)
    return _with_aux(cfg, _chunked_ce(x, _head(params), batch["labels"]),
                     aux)


def loss_fn(cfg: ModelConfig, params: Params, batch) -> torch.Tensor:
    return forward_from_cut(cfg, params, batch, cfg.default_cut_units)


def logits_fn(cfg: ModelConfig, params: Params, batch) -> torch.Tensor:
    """Full-sequence logits (B, S, V) in the model's type (small configs,
    the sentiment accuracy's last-position logits, and serving's check)."""
    x, _ = _final_hidden(cfg, params, batch, cfg.default_cut_units)
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


# ===========================================================================
# serving: cache init / prefill / decode
# ===========================================================================

_STATE_INIT = {"mamba": ssm.mamba_init_state, "mlstm": ssm.mlstm_init_state,
               "slstm": ssm.slstm_init_state}


def _block_cache_init(cfg: ModelConfig, btype: str, batch: int,
                      seq_len: int, lead, device) -> Params:
    """A recurrent block's initial state (its "m" at -1e30: the
    reference's ``init_cache`` stacks zeros and then patches every "m"
    leaf to -1e30, which gives the same tree), or an attention block's
    zero cache."""
    if btype in _STATE_INIT:
        return _STATE_INIT[btype](cfg, batch, lead, device)
    init = (attn.mla_init_cache if cfg.attn_impl == "mla"
            else attn.gqa_init_cache)
    return init(cfg, batch, seq_len, lead, device)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *,
               device="cuda") -> Params:
    """{"b{j}": block j's cache} stacked over the units, zeros on
    ``device``: GQA {"k", "v"} (n_units, B, Hkv, Sc, dh), Sc =
    ``attention.gqa_cache_len``; MLA {"c_kv", "k_rope"} (n_units, B,
    seq_len, r) and (n_units, B, seq_len, rope), in the model type; Mamba
    {"h" (n_units, B, d_inner, d_state) f32, "conv" (n_units, B, d_conv -
    1, d_inner) in the model type}; mLSTM {"C", "n", "m"} and sLSTM {"c",
    "n", "m", "h"}, f32, "m" at -1e30."""
    _require_ported(cfg)
    return {f"b{j}": _block_cache_init(cfg, bt, batch, seq_len,
                                       (cfg.n_units,), device)
            for j, bt in enumerate(cfg.block_pattern)}


# the recurrent blocks' one-token steps, each writing its state in place
_DECODE = {"mamba": ssm.mamba_decode, "mlstm": ssm.mlstm_decode,
           "slstm": ssm.slstm_decode}


def _decode_block(cfg: ModelConfig, p: Params, btype: str, x: torch.Tensor,
                  cache: Params, pos: int) -> torch.Tensor:
    """One block at one token: x after it. Its cache entries (this unit's
    views) are written in place."""
    h = apply_norm(cfg, p["norm1"], x)
    if btype in _DECODE:
        y, _ = _DECODE[btype](cfg, p["core"], h, cache)
    else:
        decode = (attn.mla_decode if cfg.attn_impl == "mla"
                  else attn.gqa_decode)
        y, _ = decode(cfg, p["core"], h, cache, pos)
    x = x + y
    if "ffn" in p:
        x = x + _ffn(cfg, p, x)[0]
    return x


def decode_step(cfg: ModelConfig, params: Params, token: torch.Tensor,
                cache: Params, pos: int):
    """One-token decode. token: (B, 1) int; pos: the token's absolute
    position. Writes the token's cache entries (k and v, MLA's c_kv and
    k_rope, a Mamba block's h and conv, an xLSTM block's state) into
    ``cache`` (in place) and
    returns (logits (B, 1, V) in the model type, cache)."""
    _require_ported(cfg)
    x = params["embed"][token]
    for u, unit in enumerate(_unbind_units(params["units"])):
        for j, bt in enumerate(cfg.block_pattern):
            b = f"b{j}"
            x = _decode_block(cfg, unit[b], bt, x,
                              {k: c[u] for k, c in cache[b].items()}, pos)
    x = apply_norm(cfg, params["final_norm"], x)
    return x @ _head(params), cache


def _right_pad(a: torch.Tensor, target: int, axis: int) -> torch.Tensor:
    pad = target - a.shape[axis]
    if pad <= 0:
        return a
    shape = list(a.shape)
    shape[axis] = pad
    return torch.cat([a, a.new_zeros(shape)], dim=axis)


def _gqa_prompt_cache(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor,
                      seq_len: int):
    """{"k", "v"} (B, Hkv, Sc, dh) of a prompt's k and v (B, Hkv, S, dh):
    right-padded to Sc or, with Sc < S (a window shorter than the prompt),
    the last Sc positions, each in its ring slot."""
    B, _, S, _ = k.shape
    Sc = attn.gqa_cache_len(cfg, max(seq_len, S))
    if Sc >= S:
        return {"k": _right_pad(k, Sc, 2), "v": _right_pad(v, Sc, 2)}
    keep = torch.arange(S - Sc, S, device=k.device)
    slots = keep % Sc
    ck = k.new_zeros((B, cfg.n_kv_heads, Sc, cfg.d_head))
    cv = torch.zeros_like(ck)
    ck[:, :, slots] = k[:, :, keep]
    cv[:, :, slots] = v[:, :, keep]
    return {"k": ck, "v": cv}


def _prefill_block(cfg: ModelConfig, p: Params, btype: str,
                   x: torch.Tensor, positions: torch.Tensor, seq_len: int):
    """One block over the prompt that also fills its decode cache: (x,
    the block's cache). GQA: the k and v the attention used
    (``_gqa_prompt_cache``); MLA: {"c_kv", "k_rope"} (B, seq_len, ·), the
    latent and the rope key the attention rebuilt its keys and values
    from, right-padded; Mamba: the state after the prompt ({"h", "conv"};
    a prompt shorter than d_conv - 1 keeps the zero conv state, as the
    reference does); mLSTM and sLSTM: the state after the prompt."""
    h = apply_norm(cfg, p["norm1"], x)
    if btype in _FORWARD:
        y, cache = _FORWARD[btype](cfg, p["core"], h)
        x = x + y
    elif cfg.attn_impl == "mla":
        q, k, v, cache = attn.mla_qkv(cfg, p["core"], h, positions)
        x = x + attn.attend(cfg, p["core"], q, k, v, causal=True)
        cache = {n: _right_pad(a, seq_len, 1) for n, a in cache.items()}
    else:
        q, k, v = attn.qkv(cfg, p["core"], h, positions)
        x = x + attn.attend(cfg, p["core"], q, k, v, causal=True)
        cache = _gqa_prompt_cache(cfg, k, v, seq_len)
    if "ffn" in p:
        x = x + _ffn(cfg, p, x)[0]
    return x, cache


def prefill(cfg: ModelConfig, params: Params, batch, *, cache_len: int = 0):
    """Run the prompt, building the decode cache for ``max(cache_len, S)``
    positions. Returns (logits of the last position (B, 1, V), cache)."""
    _require_ported(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    seq_len = max(cache_len, S)
    x = params["embed"][tokens]
    pos = _positions(B, S, tokens.device)
    caches = {f"b{j}": [] for j in range(len(cfg.block_pattern))}
    for unit in _unbind_units(params["units"]):
        for j, bt in enumerate(cfg.block_pattern):
            x, c = _prefill_block(cfg, unit[f"b{j}"], bt, x, pos, seq_len)
            caches[f"b{j}"].append(c)
    x = apply_norm(cfg, params["final_norm"], x[:, -1:].contiguous())
    return x @ _head(params), {
        b: {n: torch.stack([c[n] for c in cs]) for n in cs[0]}
        for b, cs in caches.items()}
