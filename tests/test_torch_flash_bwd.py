"""The bf16 flash backward kernels' rounding (``csrc/flash_attention_bwd.cu``),
emulated in plain torch on the CPU, where the kernels cannot run.

The kernels sum every product in f32 from bf16 operands; only P (the A
operand of dV += Pᵀ·dO) and dS (of dK += dSᵀ·Q and dQ += dS·K) are rounded
to bf16 to enter the tensor cores, each cast once, or split into bf16
hi + lo: the kernels cast P and dK's dS once and split dQ's dS
(``KERNEL_SPLIT``), the cheapest choice that keeps every case here within
the tolerance. ``_emulate_bf16_flash_bwd_kernel`` does the same tile by tile over
the kernels' own loop bounds (64-row key tiles walking their query tiles
for dK and dV, one f32 partial a query head summed over the group in head
order; 64-row query tiles walking their key tiles for dQ), with masked
pairs 0. It is held against the port's plain backward
(``ref.flash_attention_bwd_ref``) and ``jax.vjp`` of the reference's einsum
attention (``repro.models.attention.gqa_attention``, with identity
projections at position 0, where RoPE is the identity) at small shapes.

Tolerance: the card's (chip_smoke.check_grad, tests/test_torch_gpu.py), each
bf16 gradient within 2^-7·max|g| of the reference's.

    python tests/test_torch_flash_bwd.py [N]

prints the emulation's margins at the card's shapes (chip_smoke.py's
phase_flash_bwd cases) for one cast and for the split, and the worst of N
random small cases (default 200).
"""
import importlib.util
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import attention as j_attention
from repro_torch.kernels import ref

TILE = 64        # csrc/flash_attention_bwd.cu: kTile (and kB)
BF16_REL = 2.0 ** -7
# csrc/flash_attention_bwd.cu: a_operand<SPLIT> of dV's P, and of dK's and
# dQ's dS
KERNEL_SPLIT = dict(split_p=False, split_ds=(False, True))


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


def _emulate_bf16_flash_bwd_kernel(q, k, v, o, lse, do, causal, window,
                                   split_p=False, split_ds=False,
                                   coverage=None, out=torch.bfloat16):
    """(dq, dk, dv) in bf16 as the bf16 kernels round them (``out``
    float32: before the final rounding), with P split into hi + lo or not
    (``split_p``), and dS for dK and for dQ (``split_ds``: one bool for
    both, or a pair). ``coverage``, if a dict, receives for each walk
    ('dkdv', 'dq') the number of times it met each unmasked (query, key)
    pair, (B, H, S, S)."""
    split_dk, split_dq = (split_ds if isinstance(split_ds, tuple)
                          else (split_ds, split_ds))
    B, H, S, d = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
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
    dv_part = torch.zeros(B, H, S + pad, d)
    for k_lo, q_tiles in dkdv_walk(S, causal, window):
        ks = slice(k_lo, k_lo + TILE)
        for q_lo in q_tiles:
            qs = slice(q_lo, q_lo + TILE)
            p, ds, ok = tile(q_lo, k_lo)
            dv_part[:, :, ks] += _bf16(p, split_p).transpose(-1, -2) @ \
                dof[:, :, qs]
            dk_part[:, :, ks] += _bf16(ds, split_dk).transpose(-1, -2) @ \
                qf[:, :, qs]
            if coverage is not None:
                coverage["dkdv"][:, :, qs, ks] += ok
    dk_g = dk_part.reshape(B, Hkv, G, S + pad, d)
    dv_g = dv_part.reshape(B, Hkv, G, S + pad, d)
    dk, dv = dk_g[:, :, 0], dv_g[:, :, 0]
    for g in range(1, G):                     # the sum launch, head order
        dk, dv = dk + dk_g[:, :, g], dv + dv_g[:, :, g]
    dq = torch.zeros(B, H, S + pad, d)
    for q_lo, k_tiles in dq_walk(S, causal, window):
        qs = slice(q_lo, q_lo + TILE)
        for k_lo in k_tiles:
            _, ds, ok = tile(q_lo, k_lo)
            dq[:, :, qs] += _bf16(ds, split_dq) @ kf[:, :, k_lo:k_lo + TILE]
            if coverage is not None:
                coverage["dq"][:, :, qs, k_lo:k_lo + TILE] += ok
    if coverage is not None:
        for walk in coverage:
            coverage[walk] = coverage[walk][:, :, :S, :S]
    return ((dq[:, :, :S] * scale).to(out), (dk[:, :, :S] * scale).to(out),
            dv[:, :, :S].to(out))


def _einsum_vjp(q, k, v, do, causal, window):
    """dq, dk, dv (f32 numpy) by jax.vjp of the reference's gqa_attention
    on x = [q | k | v] with identity projections, at position 0."""
    B, H, S, d = q.shape
    Hkv = k.shape[1]
    cfg = j_get_config("olmo-1b", smoke=True).replace(
        d_model=(H + 2 * Hkv) * d, n_heads=H, n_kv_heads=Hkv, d_head=d,
        dtype="float32", sliding_window=window, qk_norm=False)
    D = cfg.d_model
    eye = np.eye(D, dtype=np.float32)
    cut = np.cumsum([0, H * d, Hkv * d, Hkv * d])
    p = {"wq": eye[:, cut[0]:cut[1]], "wk": eye[:, cut[1]:cut[2]],
         "wv": eye[:, cut[2]:cut[3]], "wo": np.eye(H * d, dtype=np.float32)}
    p = {n: jnp.asarray(w) for n, w in p.items()}

    def bsd(t):   # (B, heads, S, d) -> (B, S, heads·d)
        t = t.float().numpy()
        return t.transpose(0, 2, 1, 3).reshape(B, S, -1)
    x = jnp.asarray(np.concatenate([bsd(q), bsd(k), bsd(v)], -1))
    pos = jnp.zeros((B, S), jnp.int32)
    _, vjp = jax.vjp(lambda xx: j_attention.gqa_attention(
        cfg, p, xx, pos, causal=causal), x)
    (dx,) = vjp(jnp.asarray(bsd(do)))
    dx = np.asarray(dx)

    def heads(a, n):
        return a.reshape(B, S, n, d).transpose(0, 2, 1, 3)
    return (heads(dx[..., cut[0]:cut[1]], H),
            heads(dx[..., cut[1]:cut[2]], Hkv),
            heads(dx[..., cut[2]:cut[3]], Hkv))


def _inputs(case, seed=0):
    """bf16 q, k, v, dO from a seed with numpy; o and lse from the plain
    forward, as the card's checks take them."""
    B, H, Hkv, S, d, causal, window = case
    rng = np.random.default_rng(seed + S + d + H)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(B, h, S, d)).astype(
        np.float32)).bfloat16() for h in (H, Hkv, Hkv, H))
    o, lse = ref.flash_attention_ref(q, k, v, causal, window,
                                     return_lse=True)
    return q, k, v, o, lse, do


def _worst(got, want) -> float:
    """max |Δ| over the tolerance 2^-7·max|want|, for each gradient."""
    out = []
    for g, w in zip(got, want):
        w = torch.from_numpy(np.array(w, np.float32)) if not isinstance(
            w, torch.Tensor) else w.float()
        out.append(float((g.float() - w).abs().max()) /
                   (BF16_REL * float(w.abs().max())))
    return max(out)


def _flash_pairs(S, causal, window):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.flash_pairs(S, causal, window)


# (B, H, Hkv, S, d, causal, window): G 1, 4 and 5, d 64 and 128, causal,
# causal with a window, a window alone, S ragged and below one tile
CASES = [(1, 2, 2, 128, 64, True, 0),
         (1, 4, 1, 100, 128, True, 0),
         (1, 5, 1, 130, 128, True, 40),
         (2, 5, 1, 64, 64, True, 0),
         (1, 4, 1, 150, 64, False, 50),
         (1, 2, 2, 40, 128, True, 0)]
IDS = [f"G{c[1] // c[2]}-d{c[4]}-S{c[3]}-"
       f"{'causal' if c[5] else 'noncausal'}-w{c[6]}" for c in CASES]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_flash_bwd_kernel_rounding_is_within_the_tolerance(case):
    """The bf16 kernels' rounding (emulated, split as the kernels split)
    against the plain backward and jax.vjp of the reference's einsum
    attention: each gradient within 2^-7·max|g|."""
    causal, window = case[5], case[6]
    q, k, v, o, lse, do = _inputs(case)
    got = _emulate_bf16_flash_bwd_kernel(q, k, v, o, lse, do, causal,
                                         window, **KERNEL_SPLIT)
    assert all(g.dtype == torch.bfloat16 for g in got)
    plain = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal, window)
    einsum = _einsum_vjp(q, k, v, do, causal, window)
    assert _worst(got, plain) <= 1.0
    assert _worst(got, einsum) <= 1.0
    # every operand split into hi + lo meets the plain version too
    split = _emulate_bf16_flash_bwd_kernel(q, k, v, o, lse, do, causal,
                                           window, True, True)
    assert _worst(split, plain) <= 1.0


def test_flash_bwd_dq_rounding_needs_the_ds_split():
    """Why the dQ kernel splits dS: on these fixed inputs (the one of 12,000
    random small cases of ``margins`` where it happens) dS cast to bf16
    once moves dQ by more than 2^-7·max|dQ| from the plain backward, which
    the hi + lo split does not; P and dK's dS cast once stay within."""
    case = (1, 4, 2, 100, 64, True, 30)
    q, k, v, o, lse, do = _inputs(case, seed=3790)
    plain = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, True, 30)
    one_cast = _emulate_bf16_flash_bwd_kernel(q, k, v, o, lse, do, True, 30)
    kernel = _emulate_bf16_flash_bwd_kernel(q, k, v, o, lse, do, True, 30,
                                            **KERNEL_SPLIT)
    assert _worst(one_cast[:1], plain[:1]) > 1.0
    assert _worst(kernel[:1], plain[:1]) <= 1.0
    assert _worst(one_cast[1:], plain[1:]) <= 1.0
    assert all(torch.equal(a, b) for a, b in zip(one_cast[1:], kernel[1:]))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_flash_bwd_kernel_walks_cover_every_pair_once(case):
    """The dK/dV and dQ kernels' loop bounds (the tiles the emulation walks)
    meet every unmasked (query, key) pair exactly once and no masked one:
    as many as chip_smoke.flash_pairs counts."""
    B, H, Hkv, S, d, causal, window = case
    cov = {}
    _emulate_bf16_flash_bwd_kernel(*_inputs(case), causal, window,
                                   coverage=cov)
    i = torch.arange(S)[:, None]
    j = torch.arange(S)[None, :]
    ok = torch.ones(S, S, dtype=torch.bool)
    if causal:
        ok &= j <= i
    if window > 0:
        ok &= i - j < window
    for walk in ("dkdv", "dq"):
        assert torch.equal(cov[walk], ok.long().expand(B, H, S, S))
        assert int(cov[walk].sum()) == B * H * _flash_pairs(S, causal,
                                                            window)


def margins(n_random: int = 200) -> None:
    """Print the emulation's margins over the tolerance (max|Δ| over
    2^-7·max|g|, for dq, dk and dv): at the card's shapes, one cast's f32
    error before the final rounding (against the split, f32 to within its
    sum order), and after it against the plain backward for one cast, the
    kernels' choice and the split; then the worst of each over n_random
    random small cases (seeds 1000 + i)."""
    variants = {"one cast": dict(split_p=False, split_ds=False),
                "kernels' choice": KERNEL_SPLIT,
                "hi + lo": dict(split_p=True, split_ds=True)}
    card = [(1, 32, 32, 512, 64, True, 0), (1, 40, 8, 512, 128, True, 0),
            (1, 40, 8, 512, 128, True, 128), (1, 4, 4, 300, 64, False, 70)]
    for case in card:
        q, k, v, o, lse, do = _inputs(case)
        causal, window = case[5], case[6]
        plain = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal,
                                            window)
        f32 = [_emulate_bf16_flash_bwd_kernel(
            q, k, v, o, lse, do, causal, window, split, split,
            out=torch.float32) for split in (False, True)]
        print(f"{case} one cast, before rounding: " + " ".join(
            f"{_worst([g], [w]):.3f}" for g, w in zip(*f32)))
        for name, kw in variants.items():
            got = _emulate_bf16_flash_bwd_kernel(q, k, v, o, lse, do, causal,
                                                 window, **kw)
            print(f"{case} {name}, after rounding: " + " ".join(
                f"{_worst([g], [w]):.3f}" for g, w in zip(got, plain)))
    worst = {name: [0.0] * 3 for name in variants}
    shapes = [(1, 4, 4, 64, 64, True, 0), (1, 5, 1, 64, 128, True, 0),
              (1, 4, 2, 100, 64, True, 30), (1, 2, 2, 70, 64, False, 20)]
    for seed in range(n_random):
        case = shapes[seed % len(shapes)]
        q, k, v, o, lse, do = _inputs(case, seed=1000 + seed)
        plain = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, case[5],
                                            case[6])
        for name, kw in variants.items():
            got = _emulate_bf16_flash_bwd_kernel(q, k, v, o, lse, do,
                                                 case[5], case[6], **kw)
            worst[name] = [max(a, _worst([g], [w])) for a, g, w in
                           zip(worst[name], got, plain)]
    for name, w in worst.items():
        print(f"{n_random} random cases, {name}: worst dq dk dv " +
              " ".join(f"{x:.3f}" for x in w))


if __name__ == "__main__":
    margins(int(sys.argv[1]) if len(sys.argv) > 1 else 200)
