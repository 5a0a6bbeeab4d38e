"""Plain PyTorch versions of the kernels (counterpart of ``repro.kernels.ref``).

These are what a kernel wrapper runs for a tensor on the CPU, what the CPU
tests hold against the JAX package, and what ``chip_smoke.py`` holds each
CUDA kernel against on the card. Nothing on the main path calls them for a
CUDA tensor.

uint32 arithmetic runs in int64: a product of two values below 2**32 wraps
mod 2**64, which keeps its low 32 bits right, and every product is masked
with ``& 0xFFFFFFFF`` before the next shift, so shifts see the uint32 value.

On the CPU the float part of the counter gaussian (Box-Muller) runs in
numpy, on the calling thread. PyTorch splits a CPU float op over its OpenMP
worker threads (log, sqrt and cos from 4096 elements up, arithmetic from
65536), and each worker keeps a floating-point state of its own: under
pytest-xdist the suite once drew noise off by up to 3.8e-5 in exactly the
rows of an (8, 1024) block that workers computed, with the calling thread's
rows exact; and workers started under another rounding mode put noise
thousands of ulps off (tests/test_torch_kernels.py). Integer hashing is
exact on any thread and stays in PyTorch. On the card the plain version
runs PyTorch's CUDA ops, which the kernel matches bit for bit.

The threefry gaussian (jax.random.normal's noise) is the same on both
sides of that line: on the CPU the cipher and the float part run in numpy
on the calling thread; on the card in PyTorch ops, the cipher in int64.
XLA's erfinv contracts its polynomial into fused multiply-adds; the plain
version takes each in float64, where the product of two float32 values is
exact and the sum rounds once, then rounds to float32. That is the fused
result unless the float64 rounding puts the sum exactly on a float32
rounding tie; over the 2^23 uniforms the noise can take, every sum that
sits on a tie is the exact sum (tests/test_torch_threefry.py checks it).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import prng

_MASK = 0xFFFFFFFF
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_GOLD = 0x9E3779B9
_SALT2 = 0xA5A5A5A5
_INV_2_32 = 1.0 / 4294967296.0
# 2·π rounded as the reference does it: 2.0 * float32(pi), exact in f32
_TWO_PI = 2.0 * float(np.float32(np.pi))

LANE = 1024


def _hash_u32(seed, idx: torch.Tensor) -> torch.Tensor:
    """Murmur3 finalizer over (seed + idx·golden); int64 tensors holding
    uint32 values in, the same out."""
    x = (idx * _GOLD + seed) & _MASK
    x = x ^ (x >> 16)
    x = (x * _M1) & _MASK
    x = x ^ (x >> 13)
    x = (x * _M2) & _MASK
    return x ^ (x >> 16)


def _box_muller_cpu(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """counter_gauss's float part for CPU tensors, in numpy f32 on the
    calling thread (see the module note)."""
    u1 = (h1.numpy().astype(np.float32) + np.float32(1.0)) \
        * np.float32(_INV_2_32)
    u2 = h2.numpy().astype(np.float32) * np.float32(_INV_2_32)
    return torch.from_numpy(np.sqrt(np.float32(-2.0) * np.log(u1))
                            * np.cos(np.float32(_TWO_PI) * u2))


def radial(h1: torch.Tensor) -> torch.Tensor:
    """Box-Muller's radial factor sqrt(-2·log(u1)) of hashes h1 (int64
    tensors holding uint32 values), as counter_gauss computes it off the
    CPU."""
    u1 = (h1.to(torch.float32) + 1.0) * _INV_2_32       # (0, 1]
    return torch.sqrt(-2.0 * torch.log(u1))


def angular(h2: torch.Tensor) -> torch.Tensor:
    """Box-Muller's angular factor cos(2π·u2) of hashes h2, as
    counter_gauss computes it off the CPU."""
    u2 = h2.to(torch.float32) * _INV_2_32               # [0, 1)
    return torch.cos(_TWO_PI * u2)


def counter_gauss(seed, idx: torch.Tensor) -> torch.Tensor:
    """Standard normal from two hashes via Box-Muller (f32)."""
    h1 = _hash_u32(seed, idx)
    h2 = _hash_u32(seed ^ _SALT2, idx)
    if h1.device.type == "cpu":
        return _box_muller_cpu(h1, h2)
    return radial(h1) * angular(h2)


def counter_gauss2(seed, hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """2-D counter gaussian over broadcast (hi, lo) uint32 index tensors."""
    mixed = (hi * _M1 + seed) & _MASK
    return counter_gauss(mixed, lo)


def _counters(row0: int, n_rows: int, device):
    hi = ((torch.arange(n_rows, dtype=torch.int64, device=device) + row0)
          & _MASK)[:, None]
    lo = torch.arange(LANE, dtype=torch.int64, device=device)[None, :]
    return hi, lo


def noise_rows(seed: int, row0: int, n_rows: int, device="cpu"
               ) -> torch.Tensor:
    """(n_rows, LANE) standard normals; row r uses counter row0 + r."""
    hi, lo = _counters(row0, n_rows, device)
    return counter_gauss2(int(seed), hi, lo)


def zo_update_ref(x: torch.Tensor, seed: int, coeff, row_offset: int = 0
                  ) -> torch.Tensor:
    """y = x + coeff·u(seed) over the (row, LANE) counter layout."""
    n = x.numel()
    u = noise_rows(seed, row_offset, -(-n // LANE), x.device)
    u = u.reshape(-1)[:n].reshape(x.shape)
    coeff = torch.as_tensor(coeff, dtype=torch.float32, device=x.device)
    return (x.to(torch.float32) + coeff.reshape(()) * u).to(x.dtype)


def zo_replay_ref(x: torch.Tensor, seeds, coeffs: torch.Tensor,
                  row_offset: int = 0) -> torch.Tensor:
    """y = x + Σᵢ coeffs[i]·u(seeds[i]), accumulated in f32 in record
    order and cast to the leaf's type once, at the end."""
    seeds = np.asarray(seeds, np.uint32).reshape(-1)
    coeffs = torch.as_tensor(coeffs, dtype=torch.float32,
                             device=x.device).reshape(-1)
    n = x.numel()
    rows = -(-n // LANE)
    hi, lo = _counters(row_offset, rows, x.device)
    acc = torch.zeros((rows, LANE), dtype=torch.float32, device=x.device)
    for i, s in enumerate(seeds.tolist()):
        acc = acc + coeffs[i] * counter_gauss2(s, hi, lo)
    acc = acc.reshape(-1)[:n].reshape(x.shape)
    return (x.to(torch.float32) + acc).to(x.dtype)


def _attention_mask(S: int, causal: bool, window: int, device
                    ) -> torch.Tensor:
    """(S, S) bool: True where query i sees key j."""
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(S, device=device)[None, :]
    ok = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        ok &= j <= i
    if window > 0:
        ok &= (i - j) < window
    return ok


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0, *,
                        return_lse: bool = False):
    """q: (B, H, S, d); k, v: (B, Hkv, S, d). Returns (B, H, S, d), and with
    ``return_lse`` also each row's log-sum-exp of the scaled, masked scores
    ((B, H, S) f32, what the backward recomputes the probabilities from).
    f32 math; masked scores are -1e30; output in q's type."""
    B, H, S, d = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, S, d).to(torch.float32)
    scores = torch.einsum("bkgsd,bktd->bkgst", qg,
                          k.to(torch.float32)) / math.sqrt(d)
    ok = _attention_mask(S, causal, window, q.device)
    scores = torch.where(ok, scores, torch.full_like(scores, -1e30))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", p, v.to(torch.float32))
    out = out.reshape(B, H, S, d).to(q.dtype)
    if not return_lse:
        return out
    return out, torch.logsumexp(scores, dim=-1).reshape(B, H, S)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor,
                            causal: bool = True, window: int = 0):
    """The gradient of ``flash_attention_ref`` by its explicit formulas, in
    f32: P = exp(q·kᵀ/√d - lse) (0 where masked), dV = Pᵀ·dO, dP = dO·vᵀ,
    dS = P ∘ (dP - rowsum(dO ∘ o)), dQ = dS·k/√d, dK = dSᵀ·q/√d, with dK and
    dV summed over each kv head's group of query heads. Returns (dq, dk,
    dv) in the types of q, k and v."""
    B, H, S, d = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    scale = 1.0 / math.sqrt(d)
    f32 = torch.float32
    qg = q.reshape(B, Hkv, G, S, d).to(f32)
    og = o.reshape(B, Hkv, G, S, d).to(f32)
    dog = do.reshape(B, Hkv, G, S, d).to(f32)
    kf, vf = k.to(f32), v.to(f32)
    s = torch.einsum("bkgsd,bktd->bkgst", qg, kf) * scale
    ok = _attention_mask(S, causal, window, q.device)
    p = torch.where(ok, torch.exp(s - lse.reshape(B, Hkv, G, S, 1)),
                    torch.zeros_like(s))
    dv = torch.einsum("bkgst,bkgsd->bktd", p, dog)
    dp = torch.einsum("bkgsd,bktd->bkgst", dog, vf)
    delta = (dog * og).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("bkgst,bktd->bkgsd", ds, kf) * scale
    dk = torch.einsum("bkgst,bkgsd->bktd", ds, qg) * scale
    return (dq.reshape(B, H, S, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
                ) -> torch.Tensor:
    """x·rsqrt(mean(x²) + eps)·scale over the last dim, f32 math, output in
    x's type: the formula of the reference norms (``apply_norm`` for
    'rmsnorm', ``rms_norm_simple``) and of the Pallas ``_rmsnorm_kernel``."""
    xf = x.to(torch.float32)
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def rmsnorm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                    eps: float = 1e-5):
    """The gradient of ``rmsnorm_ref`` in f32, with r = rsqrt(mean(x²) +
    eps), x̂ = x·r and g = dy·scale: dx = r·(g - x̂·mean(g·x̂)) in x's type,
    and dscale = Σ over rows of dy·x̂, (D,) f32."""
    xf = x.to(torch.float32)
    r = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    xh = xf * r
    g = dy.to(torch.float32) * scale
    dx = r * (g - xh * (g * xh).mean(-1, keepdim=True))
    dscale = (dy.to(torch.float32) * xh).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dscale


def rmsnorm_pair_ref(xq: torch.Tensor, sq: torch.Tensor, xk: torch.Tensor,
                     sk: torch.Tensor, eps: float = 1e-5):
    """The pair norm: two RMSNorms, each with its own scale."""
    return rmsnorm_ref(xq, sq, eps), rmsnorm_ref(xk, sk, eps)


# ---------------------------------------------------------------------------
# threefry gaussian noise (jax.random.normal at one leaf)
# ---------------------------------------------------------------------------

# XLA's float32 erfinv (Giles): the constants of p(t), highest power first,
# for w < 5 and for w >= 5
ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
              -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941)
ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
              -0.00367342844, 0.00573950773, -0.0076224613, 0.00943887047,
              1.00167406, 2.83297682)
# the uniform's lower end, nextafter(-1, 0), and float32(sqrt(2))
UNIFORM_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
SQRT2_F32 = float(np.float32(np.sqrt(2.0)))


def threefry_bits_ref(key, n: int, offset: int = 0, device="cpu"
                      ) -> torch.Tensor:
    """bits = b1 ^ b2 of threefry2x32(key, (e >> 32, e & 0xFFFFFFFF)) for
    the linear indices e = offset .. offset + n - 1: (n,) int64 holding
    uint32 values."""
    key = np.asarray(key, np.uint32).reshape(2)
    if torch.device(device).type != "cpu":
        return threefry_bits_torch(key, n, offset, device)
    e = np.arange(offset, offset + n, dtype=np.uint64)
    b1, b2 = prng.threefry2x32(key, (e >> np.uint64(32)).astype(np.uint32),
                               e.astype(np.uint32))
    return torch.from_numpy((b1 ^ b2).astype(np.int64))


def threefry_bits_torch(key, n: int, offset: int = 0, device="cpu"
                        ) -> torch.Tensor:
    """threefry_bits_ref in PyTorch int64 ops on ``device``: what the card
    runs (the CPU tests run it too)."""
    key = np.asarray(key, np.uint32).reshape(2)
    e = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = ((e >> 32) + ks[0]) & _MASK
    x1 = ((e & _MASK) + ks[1]) & _MASK
    for i in range(5):
        for r in prng.ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = (((x1 << r) & _MASK) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0 ^ x1


def _normal_of_bits_cpu(bits: torch.Tensor) -> torch.Tensor:
    """normal_of_bits in numpy on the calling thread (see the note at the
    top)."""
    f32, f64 = np.float32, np.float64
    b = bits.numpy().astype(np.uint32)
    with np.errstate(all="ignore"):
        f = ((b >> 9) | np.uint32(0x3F800000)).view(f32) - f32(1.0)
        x = np.maximum(f32(UNIFORM_LO), f * f32(2.0) + f32(UNIFORM_LO))
        w = -np.log1p(x * -x)
        lt = w < f32(5.0)
        t = np.where(lt, w + f32(-2.5), np.sqrt(w) + f32(-3.0))
        p = np.where(lt, f32(ERFINV_LT5[0]), f32(ERFINV_GE5[0]))
        for a, c in zip(ERFINV_LT5[1:], ERFINV_GE5[1:]):
            cf = np.where(lt, f32(a), f32(c)).astype(f64)
            p = (p.astype(f64) * t.astype(f64) + cf).astype(f32)
        r = np.where(np.abs(x) == f32(1.0), x * f32(np.inf), p * x)
        return torch.from_numpy(f32(SQRT2_F32) * r)


def normal_of_bits(bits: torch.Tensor) -> torch.Tensor:
    """jax.random.normal's float32 gaussian from the cipher's bits (int64
    tensors holding uint32 values): the uniform on [nextafter(-1, 0), 1)
    from bits >> 9, then sqrt(2)·erfinv with XLA's float32 erfinv."""
    if bits.device.type == "cpu":
        return _normal_of_bits_cpu(bits)
    return normal_of_bits_torch(bits)


def normal_of_bits_torch(bits: torch.Tensor) -> torch.Tensor:
    """normal_of_bits in PyTorch ops on the tensor's device: what the card
    runs (the CPU tests run it too, beside the numpy form)."""
    f = (((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
         - 1.0)
    x = torch.clamp_min(f * 2.0 + UNIFORM_LO, UNIFORM_LO)
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    t = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = torch.where(lt, ERFINV_LT5[0], ERFINV_GE5[0]).to(torch.float32)
    for a, c in zip(ERFINV_LT5[1:], ERFINV_GE5[1:]):
        cf = torch.where(lt, float(np.float32(a)), float(np.float32(c)))
        p = (p.double() * t + cf.double()).to(torch.float32)
    r = torch.where(x.abs() == 1.0, x * math.inf, p * x)
    return SQRT2_F32 * r


def threefry_normal_ref(key, n: int, offset: int = 0, device="cpu"
                        ) -> torch.Tensor:
    """(n,) float32: jax.random.normal(key, shape) flattened, elements
    offset .. offset + n - 1 of the leaf."""
    return normal_of_bits(threefry_bits_ref(key, n, offset, device))


def threefry_update_ref(x: torch.Tensor, key, coeff, scale=None,
                        offset: int = 0) -> torch.Tensor:
    """y = x + coeff·z' over the flattened leaf, z' = z or z·scale (the
    sphere), in float32 and cast to x's type once."""
    z = threefry_normal_ref(key, x.numel(), offset, x.device).reshape(x.shape)
    if scale is not None:
        z = z * torch.as_tensor(scale, dtype=torch.float32,
                                device=x.device).reshape(())
    coeff = torch.as_tensor(coeff, dtype=torch.float32, device=x.device)
    return (x.to(torch.float32) + coeff.reshape(()) * z).to(x.dtype)


def threefry_sumsq_ref(key, n: int, offset: int = 0, device="cpu"
                       ) -> torch.Tensor:
    """Σ z² over the leaf's n elements, float32 (summed in another order
    than the kernel's)."""
    z = threefry_normal_ref(key, n, offset, device)
    return (z * z).sum()
