"""The bf16 flash backward kernels' rounding (``csrc/flash_attention_bwd.cu``),
emulated in plain torch. No jax here: ``tests/test_torch_flash_bwd.py``
holds the emulation against the reference on the CPU, and
``tests/test_torch_gpu.py`` holds it against the kernels on the card.

The kernels sum every product in f32 from bf16 operands; only P (the A
operand of dV += Pᵀ·dO) and dS (of dK += dSᵀ·Q and dQ += dS·K) are rounded
to bf16 to enter the tensor cores, each cast once, or split into bf16
hi + lo: the kernels cast P and dK's dS once and split dQ's dS
(``KERNEL_SPLIT``). ``emulate_bf16_flash_bwd_kernel`` does the same over
the kernels' own loop bounds and column steps: 64-row key tiles walking
their query tiles for dK and dV, ``qn(d_qk)`` query columns at a time,
one f32 partial a query head summed over the group in head order; 64-row
query tiles walking their key tiles for dQ, ``kn(d_qk, d_v)`` keys at a
time; masked pairs 0. Within a step it sums in f32 in torch's order,
where the tensor cores sum 16 products at a time in theirs.
"""
import math

import numpy as np
import torch

from repro_torch.kernels import ref

TILE = 64        # csrc/flash_attention_bwd.cu: kTile (and kB)
BF16_REL = 2.0 ** -7
# csrc/flash_attention_bwd.cu: a_operand<SPLIT> of dV's P, and of dK's and
# dQ's dS
KERNEL_SPLIT = dict(split_p=False, split_ds=(False, True))


def qn(d_qk: int) -> int:
    """The query columns a dK/dV warp takes a step:
    flash_bwd_dkdv_bf16_kernel's QN."""
    return 64 if d_qk == 64 else 32


def kn(d_qk: int, d_v: int) -> int:
    """The keys a dQ warp takes a step: flash_bwd_dq_bf16_kernel's KN."""
    return 64 if d_qk == 64 else 32 if d_qk == d_v else 16


def dkdv_walk(S: int, causal: bool, window: int):
    """The dK/dV kernel's loop bounds: each 64-row key tile with the query
    tiles it walks (flash_bwd_dkdv_bf16_kernel's q_begin .. q_end)."""
    for k_lo in range(0, S, TILE):
        q_begin = k_lo if causal else 0
        q_end = min(S, k_lo + TILE - 1 + window) if window > 0 else S
        yield k_lo, range(q_begin, q_end, TILE)


def dq_walk(S: int, causal: bool, window: int):
    """The dQ kernel's loop bounds: each 64-row query tile with the key
    tiles it walks (flash_bwd_dq_bf16_kernel's k_begin .. k_end)."""
    for q_lo in range(0, S, TILE):
        k_end = min(S, q_lo + TILE) if causal else S
        k_begin = (max(q_lo - window + 1, 0) // TILE * TILE
                   if window > 0 else 0)
        yield q_lo, range(k_begin, k_end, TILE)


def _bf16(x: torch.Tensor, split: bool) -> torch.Tensor:
    """x as the kernels feed it to the tensor cores: one bf16 cast, or
    bf16 hi + bf16(x - hi)."""
    hi = x.bfloat16().float()
    return hi + (x - hi).bfloat16().float() if split else hi


def emulate_bf16_flash_bwd_kernel(q, k, v, o, lse, do, causal, window,
                                  split_p=False, split_ds=False,
                                  coverage=None, out=torch.bfloat16):
    """(dq, dk, dv) in bf16 as the bf16 kernels round them (``out``
    float32: before the final rounding), with P split into hi + lo or not
    (``split_p``), and dS for dK and for dQ (``split_ds``: one bool for
    both, or a pair). q and k are d_qk wide, v, o and do d_v wide.
    ``coverage``, if a dict, receives for each walk ('dkdv', 'dq') the
    number of times it met each unmasked (query, key) pair, (B, H, S, S).
    CPU tensors."""
    split_dk, split_dq = (split_ds if isinstance(split_ds, tuple)
                          else (split_ds, split_ds))
    B, H, S, d = q.shape
    Hkv, dv_ = k.shape[1], v.shape[-1]
    G = H // Hkv
    n_q, n_k = qn(d), kn(d, dv_)
    scale = 1.0 / math.sqrt(d)
    pad = -S % TILE                     # the copies zero-fill rows >= S

    def rows(t, heads=1):
        t = torch.nn.functional.pad(t.float(), (0, 0, 0, pad))
        return t.repeat_interleave(heads, 1)
    qf, of, dof = rows(q), rows(o), rows(do)
    kf, vf = rows(k, G), rows(v, G)     # a query head's kv head
    lse_f = torch.nn.functional.pad(lse.float(), (0, pad))
    delta = (dof * of).sum(-1)          # Δ = rowsum(dO ∘ o), f32
    pos = torch.arange(S + pad)

    def tile(q_lo, k_lo):
        """P and dS of a (query tile, key tile), [query][key], masked 0."""
        qr, kr = pos[q_lo:q_lo + TILE, None], pos[None, k_lo:k_lo + TILE]
        ok = (qr < S) & (kr < S)
        if causal:
            ok = ok & (kr <= qr)
        if window > 0:
            ok = ok & (qr - kr < window)
        qs, ks = slice(q_lo, q_lo + TILE), slice(k_lo, k_lo + TILE)
        s = qf[:, :, qs] @ kf[:, :, ks].transpose(-1, -2) * scale
        p = torch.where(ok, torch.exp(s - lse_f[:, :, qs, None]),
                        torch.zeros(()))
        dp = dof[:, :, qs] @ vf[:, :, ks].transpose(-1, -2)
        return p, p * (dp - delta[:, :, qs, None]), ok

    if coverage is not None:
        coverage["dkdv"] = torch.zeros(B, H, S + pad, S + pad, dtype=int)
        coverage["dq"] = torch.zeros(B, H, S + pad, S + pad, dtype=int)
    dk_part = torch.zeros(B, H, S + pad, d)   # one partial a query head
    dv_part = torch.zeros(B, H, S + pad, dv_)
    for k_lo, q_tiles in dkdv_walk(S, causal, window):
        ks = slice(k_lo, k_lo + TILE)
        for q_lo in q_tiles:
            p, ds, ok = tile(q_lo, k_lo)
            pt = _bf16(p, split_p).transpose(-1, -2)
            dst = _bf16(ds, split_dk).transpose(-1, -2)
            for c in range(0, TILE, n_q):     # the warps' query steps
                cs = slice(q_lo + c, q_lo + c + n_q)
                dv_part[:, :, ks] += pt[..., c:c + n_q] @ dof[:, :, cs]
                dk_part[:, :, ks] += dst[..., c:c + n_q] @ qf[:, :, cs]
            if coverage is not None:
                coverage["dkdv"][:, :, q_lo:q_lo + TILE, ks] += ok
    dk_g = dk_part.reshape(B, Hkv, G, S + pad, d)
    dv_g = dv_part.reshape(B, Hkv, G, S + pad, dv_)
    dk, dv = dk_g[:, :, 0], dv_g[:, :, 0]
    for g in range(1, G):                     # the sum launch, head order
        dk, dv = dk + dk_g[:, :, g], dv + dv_g[:, :, g]
    dq = torch.zeros(B, H, S + pad, d)
    for q_lo, k_tiles in dq_walk(S, causal, window):
        qs = slice(q_lo, q_lo + TILE)
        for k_lo in k_tiles:
            _, ds, ok = tile(q_lo, k_lo)
            dsr = _bf16(ds, split_dq)
            for c in range(0, TILE, n_k):     # the warps' key steps
                dq[:, :, qs] += dsr[..., c:c + n_k] @ \
                    kf[:, :, k_lo + c:k_lo + c + n_k]
            if coverage is not None:
                coverage["dq"][:, :, qs, k_lo:k_lo + TILE] += ok
    if coverage is not None:
        for walk in coverage:
            coverage[walk] = coverage[walk][:, :, :S, :S]
    return ((dq[:, :, :S] * scale).to(out), (dk[:, :, :S] * scale).to(out),
            dv[:, :, :S].to(out))


def inputs(case, seed=0):
    """bf16 q, k, v, dO from a seed with numpy; o and lse from the plain
    forward, as the card's checks take them. case: (B, H, Hkv, S, d,
    causal, window) with v d wide, or (B, H, Hkv, S, (d_qk, d_v), causal,
    window). CPU tensors."""
    B, H, Hkv, S, d, causal, window = case
    d, dv = d if isinstance(d, tuple) else (d, d)
    rng = np.random.default_rng(seed + S + d + H)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(B, h, S, w)).astype(
        np.float32)).bfloat16() for h, w in ((H, d), (Hkv, d), (Hkv, dv),
                                             (H, dv)))
    o, lse = ref.flash_attention_ref(q, k, v, causal, window,
                                     return_lse=True)
    return q, k, v, o, lse, do


def worst(got, want) -> float:
    """max |Δ| over the tolerance 2^-7·max|want|, for each gradient."""
    out = []
    for g, w in zip(got, want):
        w = torch.from_numpy(np.array(w, np.float32)) if not isinstance(
            w, torch.Tensor) else w.float()
        out.append(float((g.float() - w).abs().max()) /
                   (BF16_REL * float(w.abs().max())))
    return max(out)
