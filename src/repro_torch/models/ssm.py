"""The Mamba block (counterpart of the Mamba half of ``repro.models.ssm``).

    init_mamba         parameters
    mamba_forward      full sequence (train, prefill): (y, final state)
    mamba_decode       one token on a carried state (serve decode)
    mamba_init_state   the zero state {"h", "conv"}

Projections are matrix products (cuBLAS on the card), the causal conv is
plain PyTorch, and everything from the softplus of dt to the silu(z) gate
is the selective-scan kernel (``kernels/selective_scan.py``), which runs
the whole sequence in one launch: the reference's chunked associative
scan (``cfg.mamba.chunk``, its TPU form) computes the same recurrence in
another order, so the port has no chunk. The dt_proj product runs in full
f32 (TF32 off), as the reference's f32 product does. Under autograd (the
first-order rounds) the scan's gradient is its backward kernel
(``csrc/selective_scan_bwd.cu``; on the CPU ``ref.selective_scan_bwd_ref``),
and the projections, the conv and the slices around it are PyTorch's
autograd.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, full_f32, torch_dtype


def mamba_dims(cfg: ModelConfig):
    """(d_inner, d_state, d_conv, dt_rank, chunk)."""
    m = cfg.mamba
    d_inner = m.expand * cfg.d_model
    dt_rank = m.dt_rank if m.dt_rank > 0 else int(math.ceil(cfg.d_model / 16))
    return d_inner, m.d_state, m.d_conv, dt_rank, m.chunk


def init_mamba(cfg: ModelConfig, gen: torch.Generator, lead=()):
    """The reference's shapes, dtypes and scales, stacked over ``lead``:
    projections and the conv in the model type; dt_bias (softplus⁻¹ of
    0.01), A_log (log 1..N per channel) and D (ones) in f32."""
    dtype = torch_dtype(cfg)
    d = cfg.d_model
    d_in, N, d_conv, dt_rank, _ = mamba_dims(cfg)
    lead = tuple(lead)
    dev = gen.device
    A = torch.arange(1, N + 1, dtype=torch.float32, device=dev).expand(
        lead + (d_in, N)).contiguous()
    return {
        "in_proj": dense_init(gen, (d, 2 * d_in), dtype, lead=lead),
        "conv_w": dense_init(gen, (d_conv, d_in), dtype, lead=lead,
                             scale=1.0 / math.sqrt(d_conv)),
        "conv_b": torch.zeros(lead + (d_in,), dtype=dtype, device=dev),
        "x_proj": dense_init(gen, (d_in, dt_rank + 2 * N), dtype, lead=lead),
        "dt_proj": dense_init(gen, (dt_rank, d_in), dtype, lead=lead),
        "dt_bias": torch.log(torch.expm1(torch.full(
            lead + (d_in,), 0.01, dtype=torch.float32, device=dev))),
        "A_log": torch.log(A),
        "D": torch.ones(lead + (d_in,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, (d_in, d), dtype, lead=lead),
    }


def mamba_init_state(cfg: ModelConfig, batch: int, lead=(), device="cpu"):
    """{"h": zeros (*lead, B, d_in, N) f32, "conv": zeros (*lead, B,
    d_conv - 1, d_in) in the model type}."""
    d_in, N, d_conv, _, _ = mamba_dims(cfg)
    lead = tuple(lead) + (batch,)
    return {"h": torch.zeros(lead + (d_in, N), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros(lead + (d_conv - 1, d_in),
                                dtype=torch_dtype(cfg), device=device)}


def _mamba_conv_full(p, x: torch.Tensor, d_conv: int) -> torch.Tensor:
    """Causal depthwise conv over (B, S, d_in): d_conv shifted f32
    multiply-adds in the reference's order, plus the bias, cast to x's
    type."""
    S = x.shape[1]
    xp = F.pad(x, (0, 0, d_conv - 1, 0))
    w = p["conv_w"].to(torch.float32)
    out = xp[:, 0:S].to(torch.float32) * w[0]
    for i in range(1, d_conv):
        out = out + xp[:, i:i + S].to(torch.float32) * w[i]
    return (out + p["conv_b"].to(torch.float32)).to(x.dtype)


def _scan(cfg: ModelConfig, p, xs: torch.Tensor, z: torch.Tensor,
          h0: torch.Tensor, h_out=None):
    """The selective scan of the post-conv activation xs (B, S, d_in):
    x_proj in the model type (then f32, as the reference's ``:87``), the
    dt_proj product in full f32, then the kernel, which reads z (a half of
    in_proj's output) and B and C (slices of x_dbl) in place. Returns (y,
    h_last)."""
    _, N, _, dt_rank, _ = mamba_dims(cfg)
    x_dbl = (xs @ p["x_proj"]).to(torch.float32)
    with full_f32():
        dt = x_dbl[..., :dt_rank] @ p["dt_proj"].to(torch.float32)
    return ops.selective_scan_op(xs, dt, z, x_dbl[..., dt_rank:dt_rank + N],
                                 x_dbl[..., dt_rank + N:], p["A_log"],
                                 p["D"], p["dt_bias"], h0, h_out=h_out)


def mamba_forward(cfg: ModelConfig, p, x: torch.Tensor, state=None):
    """x: (B, S, D) -> (y (B, S, D), final state {"h", "conv"}). A prompt
    shorter than d_conv - 1 keeps the initial conv state, as the
    reference does (``ssm.py:124``)."""
    B, S, _ = x.shape
    d_in, _, d_conv, _, _ = mamba_dims(cfg)
    if state is None:
        state = mamba_init_state(cfg, B, device=x.device)
    xz = x @ p["in_proj"]
    xs_raw, z = xz[..., :d_in], xz[..., d_in:]
    xs = F.silu(_mamba_conv_full(p, xs_raw, d_conv))
    y, h_last = _scan(cfg, p, xs, z, state["h"])
    conv = (xs_raw[:, S - (d_conv - 1):].contiguous() if S >= d_conv - 1
            else state["conv"])
    return y @ p["out_proj"], {"h": h_last, "conv": conv}


def mamba_decode(cfg: ModelConfig, p, x: torch.Tensor, state):
    """x: (B, 1, D) -> (y (B, 1, D), state). The new h and conv are
    written into ``state``'s tensors in place (the scan's h_last into h,
    one launch at S = 1)."""
    d_in, _, d_conv, _, _ = mamba_dims(cfg)
    xz = x @ p["in_proj"]                                   # (B, 1, 2·d_in)
    xs_raw, z = xz[..., :d_in], xz[..., d_in:]
    conv_buf = torch.cat([state["conv"], xs_raw], dim=1)    # (B, d_conv, d_in)
    w = p["conv_w"].to(torch.float32)
    acc = conv_buf[:, 0].to(torch.float32) * w[0]
    for i in range(1, d_conv):
        acc = acc + conv_buf[:, i].to(torch.float32) * w[i]
    acc = acc + p["conv_b"].to(torch.float32)
    xs = F.silu(acc.to(x.dtype))[:, None]                   # (B, 1, d_in)
    y, _ = _scan(cfg, p, xs, z, state["h"], h_out=state["h"])
    state["conv"].copy_(conv_buf[:, 1:])
    return y @ p["out_proj"], state
