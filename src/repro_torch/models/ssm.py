"""The Mamba and xLSTM blocks (counterpart of ``repro.models.ssm``).

    init_mamba         parameters
    mamba_forward      full sequence (train, prefill): (y, final state)
    mamba_decode       one token on a carried state (serve decode)
    mamba_init_state   the zero state {"h", "conv"}
    init_mlstm, mlstm_forward, mlstm_decode, mlstm_init_state
    init_slstm, slstm_forward, slstm_decode, slstm_init_state

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

The mLSTM (matrix memory) runs the reference's chunkwise-parallel form in
PyTorch with the same chunk length and tail chunk (``cfg.xlstm.chunk``; S
need not be a multiple of it), each chunk's arithmetic in the reference's
order: what depends only on a chunk is computed for all whole chunks in
one batch, and the carried stabiliser and memory in short loops over the
chunks (a loop of the whole body, as ``lax.scan`` runs it, would launch
about 30 kernels a chunk and left path 11's round host-bound). Its
products are einsums (cuBLAS on the card), as the reference leaves them
to XLA, and every f32 product runs in full f32 (TF32 off). The sLSTM (scalar memory)
runs its ``w_x`` product, then its recurrence over all S tokens in one
launch of the sLSTM kernel (``kernels/slstm.py``; on the CPU
``ref.slstm_ref``), then the GeGLU out-projection. Both decodes write the
new state into the given state's tensors in place, as ``mamba_decode``
does. Under autograd (the first-order rounds) the mLSTM's gradient is
PyTorch's autograd of its chunks, and the sLSTM recurrence's is its
backward kernel (``csrc/slstm_bwd.cu``; on the CPU ``ref.slstm_bwd_ref``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.models.layers import dense_init, full_f32, torch_dtype

_NEG = -1e30        # the m stabilisers' start, as the reference's


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


# ===========================================================================
# mLSTM (xLSTM matrix memory, chunkwise-parallel)
# ===========================================================================

def mlstm_dims(cfg: ModelConfig):
    """(d_up, n_heads, head dim, chunk)."""
    xc = cfg.xlstm
    d_up = int(xc.proj_factor * cfg.d_model)
    H = xc.n_heads
    d_up = (d_up // H) * H
    return d_up, H, d_up // H, xc.chunk


def init_mlstm(cfg: ModelConfig, gen: torch.Generator, lead=()):
    """The reference's shapes, dtypes and scales, stacked over ``lead``:
    the projections in the model type, the gate projections w_i and w_f
    (scale 0.02) and their biases in f32, b_f at 3.0 (forget gate open)."""
    dtype = torch_dtype(cfg)
    d = cfg.d_model
    d_up, H, _, _ = mlstm_dims(cfg)
    lead = tuple(lead)
    dev = gen.device
    return {
        "w_up": dense_init(gen, (d, 2 * d_up), dtype, lead=lead),
        "wq": dense_init(gen, (d_up, d_up), dtype, lead=lead),
        "wk": dense_init(gen, (d_up, d_up), dtype, lead=lead),
        "wv": dense_init(gen, (d_up, d_up), dtype, lead=lead),
        "w_i": dense_init(gen, (d_up, H), torch.float32, lead=lead,
                          scale=0.02),
        "b_i": torch.zeros(lead + (H,), dtype=torch.float32, device=dev),
        "w_f": dense_init(gen, (d_up, H), torch.float32, lead=lead,
                          scale=0.02),
        "b_f": torch.full(lead + (H,), 3.0, dtype=torch.float32, device=dev),
        "w_down": dense_init(gen, (d_up, d), dtype, lead=lead),
    }


def mlstm_init_state(cfg: ModelConfig, batch: int, lead=(), device="cpu"):
    """{"C" (*lead, B, H, dh, dh), "n" (*lead, B, H, dh) zeros, "m"
    (*lead, B, H) at -1e30}, f32."""
    _, H, dh, _ = mlstm_dims(cfg)
    lead = tuple(lead) + (batch, H)
    f32 = torch.float32
    return {"C": torch.zeros(lead + (dh, dh), dtype=f32, device=device),
            "n": torch.zeros(lead + (dh,), dtype=f32, device=device),
            "m": torch.full(lead, _NEG, dtype=f32, device=device)}


def _mlstm_qkv_gates(cfg: ModelConfig, p, x: torch.Tensor):
    """q and v (B, S, H, dh) in the model type; k the same in f32 (the
    reference divides the model-type product by a NumPy f32 scalar, which
    promotes it to f32); the log gates li, lf (B, S, H) f32 from full-f32
    products; z the gate half of w_up's output."""
    B, S, _ = x.shape
    d_up, H, dh, _ = mlstm_dims(cfg)
    up = x @ p["w_up"]
    u, z = up[..., :d_up], up[..., d_up:]
    q = (u @ p["wq"]).reshape(B, S, H, dh)
    # a true division by f32(sqrt(dh)), as the reference's: a divisor made
    # on the device (a host scalar would be a reciprocal product on the
    # card, and a host tensor a synchronising copy)
    k = ((u @ p["wk"]).to(torch.float32)
         / torch.full((), math.sqrt(dh), dtype=torch.float32,
                      device=x.device)).reshape(B, S, H, dh)
    v = (u @ p["wv"]).reshape(B, S, H, dh)
    uf = u.to(torch.float32)
    with full_f32():
        li = uf @ p["w_i"] + p["b_i"]
        lf = ref.log_sigmoid(uf @ p["w_f"] + p["b_f"])
    return q, k, v, li, lf, z


def _mlstm_chunks(q, k, v, li, lf, C0, n0, m0):
    """nc chunks of L tokens of the reference's chunkwise form
    (``ssm.py:212-248``) at once: q, v (B, nc, L, H, dh) in the model
    type, k f32, li, lf (B, nc, L, H); the carried (C0, n0, m0) at the
    first chunk's start. Each chunk's arithmetic is the reference's body,
    in its order; what depends only on the chunk is computed for all
    chunks together, and the carry runs over the chunks in two short
    loops: the stabiliser m (two ops a chunk), then C and n (four), from
    which each chunk's inter-chunk part follows. Returns (h (B, nc, L, H,
    dh) f32, C, n, m at the end)."""
    f32 = torch.float32
    nc, L = q.shape[1], q.shape[2]
    csum = torch.cumsum(lf, dim=2)                              # (B,nc,L,H)
    # intra-chunk decay: D[t,s] = csum_t - csum_s + li_s  (s <= t)
    Dm = (csum[:, :, :, None, :] - csum[:, :, None, :, :]
          + li[:, :, None, :, :])                               # (B,nc,L,L,H)
    above = torch.ones((L, L), dtype=torch.bool, device=q.device).triu(1)
    Dm = Dm.masked_fill(above[None, None, :, :, None], float("-inf"))
    m_intra = Dm.amax(dim=3)                                    # (B,nc,L,H)
    tot = csum[:, :, -1, :]                                     # (B,nc,H)
    dec_s = tot[:, :, None, :] - csum + li                      # (B,nc,L,H)
    dec_max = dec_s.amax(dim=2)
    ms = [m0]                       # each chunk's m_C = max(m0 + tot, ...)
    for c in range(nc):
        ms.append(torch.maximum(ms[-1] + tot[:, c], dec_max[:, c]))
    m_in, m_out = torch.stack(ms[:-1], 1), torch.stack(ms[1:], 1)
    qf, vf = q.to(f32), v.to(f32)
    wC = torch.exp(dec_s - m_out[:, :, None, :])                # (B,nc,L,H)
    kw = k * wC[..., None]
    kv = torch.einsum("bclhd,bclhe->bchde", kw, vf)
    kn = kw.sum(dim=2)                                          # (B,nc,H,dh)
    g = torch.exp(m_in + tot - m_out)                           # (B,nc,H)
    Cs, ns = [C0], [n0]
    for c in range(nc):
        Cs.append(g[:, c, :, None, None] * Cs[-1] + kv[:, c])
        ns.append(g[:, c, :, None] * ns[-1] + kn[:, c])
    C_in, n_in = torch.stack(Cs[:-1], 1), torch.stack(ns[:-1], 1)
    m_inter = csum + m_in[:, :, None, :]
    m_t = torch.maximum(m_intra, m_inter)
    sc_inter = torch.exp(m_inter - m_t)
    h_inter = (torch.einsum("bclhd,bchde->bclhe", qf, C_in)
               * sc_inter[..., None])
    d_inter = torch.einsum("bclhd,bchd->bclh", qf, n_in) * sc_inter
    w = torch.exp(Dm - m_t[:, :, :, None, :])                   # (B,nc,L,L,H)
    scores = torch.einsum("bclhd,bcshd->bclsh", qf, k) * w
    h_intra = torch.einsum("bclsh,bcshe->bclhe", scores, vf)
    d_intra = scores.sum(dim=3)
    denom = torch.maximum((d_inter + d_intra).abs(), torch.exp(-m_t))
    h = (h_inter + h_intra) / denom[..., None]
    return h, Cs[-1], ns[-1], ms[-1]


def mlstm_forward(cfg: ModelConfig, p, x: torch.Tensor, state=None):
    """Chunkwise-parallel mLSTM. x: (B, S, D) -> (y (B, S, D), final
    state {"C", "n", "m"}): the whole chunks of ``cfg.xlstm.chunk`` tokens
    (of S where S is shorter) together, then the tail chunk of S mod chunk
    tokens, as the reference runs them; every f32 product in full f32."""
    B, S, _ = x.shape
    d_up, H, dh, chunk = mlstm_dims(cfg)
    if state is None:
        state = mlstm_init_state(cfg, B, device=x.device)
    q, k, v, li, lf, z = _mlstm_qkv_gates(cfg, p, x)
    L = min(chunk, S)
    nc = S // L
    Sm = nc * L
    C, n, m = state["C"], state["n"], state["m"]
    hs = []
    with full_f32():
        for s0, s1, c in ((0, Sm, L), (Sm, S, S - Sm)):
            if s1 > s0:                 # whole chunks, then the tail
                def cut(t):
                    return t[:, s0:s1].reshape(
                        (B, (s1 - s0) // c, c) + t.shape[2:])
                h, C, n, m = _mlstm_chunks(cut(q), cut(k), cut(v), cut(li),
                                           cut(lf), C, n, m)
                hs.append(h.reshape(B, s1 - s0, d_up))
    h = torch.cat(hs, dim=1).to(x.dtype)
    y = (h * F.silu(z)) @ p["w_down"]
    return y, {"C": C, "n": n, "m": m}


def mlstm_decode(cfg: ModelConfig, p, x: torch.Tensor, state):
    """x: (B, 1, D) -> (y (B, 1, D), state): one recurrent step; the new
    C, n and m are written into ``state``'s tensors in place."""
    B = x.shape[0]
    d_up, H, dh, _ = mlstm_dims(cfg)
    q, k, v, li, lf, z = _mlstm_qkv_gates(cfg, p, x)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]
    li, lf, z = li[:, 0], lf[:, 0], z[:, 0]
    m0 = state["m"]
    m_new = torch.maximum(lf + m0, li)
    fs = torch.exp(lf + m0 - m_new)
    is_ = torch.exp(li - m_new)
    qf, vf = q.to(torch.float32), v.to(torch.float32)
    C = fs[..., None, None] * state["C"] + is_[..., None, None] * (
        k[..., :, None] * vf[..., None, :])
    n = fs[..., None] * state["n"] + is_[..., None] * k
    with full_f32():
        num = torch.einsum("bhd,bhde->bhe", qf, C)
        den = torch.maximum(torch.einsum("bhd,bhd->bh", qf, n).abs(),
                            torch.exp(-m_new))
    h = (num / den[..., None]).reshape(B, d_up).to(x.dtype)
    y = (h * F.silu(z)) @ p["w_down"]
    state["C"].copy_(C)
    state["n"].copy_(n)
    state["m"].copy_(m_new)
    return y[:, None], state


# ===========================================================================
# sLSTM (scalar memory, strictly sequential)
# ===========================================================================

def slstm_dims(cfg: ModelConfig):
    """(n_heads, head dim)."""
    H = cfg.xlstm.n_heads
    return H, cfg.d_model // H


def init_slstm(cfg: ModelConfig, gen: torch.Generator, lead=()):
    """The reference's shapes, dtypes and scales, stacked over ``lead``:
    w_x (the z, i, f, o pre-activations) and the GeGLU projections in the
    model type; the block-diagonal recurrent r (4, H, dh, dh) (scale
    1/sqrt(dh)) and the bias b in f32, b's forget quarter at 3.0."""
    dtype = torch_dtype(cfg)
    d = cfg.d_model
    H, dh = slstm_dims(cfg)
    lead = tuple(lead)
    d_ff = int(cfg.xlstm.slstm_proj_factor * d)
    b = torch.zeros(lead + (4 * d,), dtype=torch.float32, device=gen.device)
    b[..., 2 * d:3 * d] = 3.0
    return {
        "w_x": dense_init(gen, (d, 4 * d), dtype, lead=lead),
        "r": dense_init(gen, (4, H, dh, dh), torch.float32, lead=lead,
                        scale=1.0 / math.sqrt(dh)),
        "b": b,
        "w_up": dense_init(gen, (d, 2 * d_ff), dtype, lead=lead),
        "w_down": dense_init(gen, (d_ff, d), dtype, lead=lead),
    }


def slstm_init_state(cfg: ModelConfig, batch: int, lead=(), device="cpu"):
    """{"c", "n", "h" zeros, "m" at -1e30}, each (*lead, B, H, dh) f32."""
    H, dh = slstm_dims(cfg)
    shape = tuple(lead) + (batch, H, dh)
    f32 = torch.float32
    return {"c": torch.zeros(shape, dtype=f32, device=device),
            "n": torch.zeros(shape, dtype=f32, device=device),
            "m": torch.full(shape, _NEG, dtype=f32, device=device),
            "h": torch.zeros(shape, dtype=f32, device=device)}


def _slstm_out(p, h: torch.Tensor) -> torch.Tensor:
    """The GeGLU out-projection of the block's hidden states (tanh GELU,
    as jax.nn.gelu's default)."""
    up = h @ p["w_up"]
    d_ff = up.shape[-1] // 2
    return (F.gelu(up[..., :d_ff], approximate="tanh")
            * up[..., d_ff:]) @ p["w_down"]


def slstm_forward(cfg: ModelConfig, p, x: torch.Tensor, state=None):
    """x: (B, S, D) -> (y (B, S, D), final state {"c", "n", "m", "h"}):
    the w_x product, one sLSTM launch over the S tokens, the GeGLU."""
    B, S, _ = x.shape
    if state is None:
        state = slstm_init_state(cfg, B, device=x.device)
    hs, (c, n, m, h) = ops.slstm_op(x @ p["w_x"], p["b"], p["r"],
                                    state["c"], state["n"], state["m"],
                                    state["h"])
    return _slstm_out(p, hs), {"c": c, "n": n, "m": m, "h": h}


def slstm_decode(cfg: ModelConfig, p, x: torch.Tensor, state):
    """x: (B, 1, D) -> (y (B, 1, D), state): one launch at S = 1 that
    writes the new state into ``state``'s tensors in place."""
    names = ("c", "n", "m", "h")
    hs, _ = ops.slstm_op(x @ p["w_x"], p["b"], p["r"],
                         *(state[k] for k in names),
                         out=tuple(state[k] for k in names))
    return _slstm_out(p, hs), state
