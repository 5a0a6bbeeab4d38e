"""The selective-scan kernel's order of arithmetic, modelled in plain
PyTorch f32 on the CPU, against the reference's Mamba chain and against
the port's plain version.

The kernel (``kernels/csrc/selective_scan.cu``) splits each channel's N
states over G lanes (``kernels/selective_scan.py:LANES``, the kernel's
kLanesN16 and kLanesN4): softplus runs once per (token, channel), each lane
sums h·C over its N/G states in n order, and the G partials are added in
g order before x·D and the silu(z) gate. ``scan_model`` computes exactly
that order (without the kernel's fused multiply-adds), at the kernel's G
and at G = 1 (the plain n order), for N 4 and 16, on d_in 100 (ragged
against the kernel's 32 and 64 channels a block) and S 33 (a 32-token
chunk and one token).

Against the reference's ``repro.models.ssm._mamba_ssm_params``,
``_ssm_scan_chunk`` over the whole sequence, the C contraction and the D
and silu(z) gate (one jit a (N, dtype) case) and against
``ref.selective_scan_ref``, on the same x_proj and dt_proj products: f32
y and h_last within 1e-5 of their largest magnitude; bf16 y within two
bf16 ulps of each element plus 1e-5 of max|y| (chip_smoke.py's
``check_scan`` and tests/test_torch_gpu.py's ``assert_scan_close``), h_last
as in f32. The bf16 y comes within about 0.95 of that tolerance of the
reference's, whose bf16 silu(z) rounds the sigmoid and then the product
(the kernel and the plain version round silu(z) once); the order of the
sum over n moves f32 y by less than a tenth of it.
"""
import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from one_torch_thread import one_torch_thread  # noqa: F401
from repro.configs import get_config as j_get_config
from repro.models import ssm as j_ssm
from repro_torch.kernels import build, ref
from repro_torch.kernels.selective_scan import LANES, STATES

B, S, D_IN, DT_RANK = 2, 33, 100, 4
CASES = [(N, dtype, G) for N in STATES for dtype in ("float32", "bfloat16")
         for G in sorted({1, LANES[N]})]


def scan_model(x, dt, z, Bc, Cc, A_log, D, dt_bias, h0, G: int):
    """The kernel's arithmetic in f32 with its lanes' order of the sum over
    n: (y in x's type, h_last)."""
    f32 = torch.float32
    v = dt + dt_bias
    delta = v.clamp(min=0.0) + torch.log1p(torch.exp(-v.abs()))
    A = -torch.exp(A_log)
    xf = x.to(f32)
    dx = delta * xf
    nb, ns, d_in = x.shape
    N = A.shape[-1]
    h = h0.to(f32)
    ys = torch.empty(nb, ns, d_in)
    for t in range(ns):
        h = (torch.exp(delta[:, t, :, None] * A) * h
             + dx[:, t, :, None] * Bc[:, t, None, :])
        hc = (h * Cc[:, t, None, :]).reshape(nb, d_in, G, N // G)
        part = hc[..., 0]                     # each lane's states, n order
        for n in range(1, N // G):
            part = part + hc[..., n]
        o = part[..., 0]                      # the lanes' partials, g order
        for g in range(1, G):
            o = o + part[..., g]
        ys[:, t] = o
    o = (ys + xf * D).to(x.dtype).to(f32)
    zf = z.to(f32)
    gate = (zf / (1.0 + torch.exp(-zf))).to(x.dtype).to(f32)
    return (o * gate).to(x.dtype), h


@functools.lru_cache(maxsize=None)
def _case(N: int, dtype: str):
    """The inputs in numpy (x and z bf16-valued for bf16), the reference
    config and parameters."""
    rng = np.random.default_rng(29 + N)
    tdt = getattr(torch, dtype)

    def cast(a):                      # values the model type can hold
        return torch.from_numpy(a).to(tdt).float().numpy()

    xs = cast(rng.standard_normal((B, S, D_IN)).astype(np.float32) * 2.0)
    xs = cast(xs / (1.0 + np.exp(-xs)))                   # a silu output
    z = cast(rng.standard_normal((B, S, D_IN)).astype(np.float32))
    p = {"x_proj": (rng.standard_normal((D_IN, DT_RANK + 2 * N))
                    / np.sqrt(D_IN)).astype(np.float32),
         "dt_proj": (rng.standard_normal((DT_RANK, D_IN))
                     / np.sqrt(DT_RANK)).astype(np.float32),
         "dt_bias": (np.log(np.expm1(0.01)) + 0.5 * rng.standard_normal(
             D_IN)).astype(np.float32),
         "A_log": (np.log(np.arange(1, N + 1, dtype=np.float32))
                   + 0.1 * rng.standard_normal((D_IN, N))).astype(
             np.float32),
         "D": (1.0 + 0.1 * rng.standard_normal(D_IN)).astype(np.float32)}
    h0 = (0.5 * rng.standard_normal((B, D_IN, N))).astype(np.float32)
    jcfg = j_get_config("jamba-1.5-large-398b", smoke=True)
    jcfg = jcfg.replace(d_model=D_IN // jcfg.mamba.expand,
                        mamba=dataclasses.replace(jcfg.mamba, d_state=N,
                                                  dt_rank=DT_RANK))
    assert j_ssm.mamba_dims(jcfg)[:2] == (D_IN, N)
    return xs, z, p, h0, jcfg


@functools.lru_cache(maxsize=None)
def _reference(N: int, dtype: str):
    """The reference's chain, jitted once a case: (y, h_last) in numpy."""
    xs, z, p, h0, jcfg = _case(N, dtype)
    jp = {k: jnp.asarray(v) for k, v in p.items()}

    @jax.jit
    def chain(xs, z, h0):
        dA, dBx, Cc = j_ssm._mamba_ssm_params(jcfg, jp, xs)
        h_all, h_last = j_ssm._ssm_scan_chunk(dA.swapaxes(0, 1),
                                              dBx.swapaxes(0, 1), h0)
        y = jnp.einsum("lbdn,bln->bld", h_all, Cc)
        y = (y + xs * jp["D"]).astype(jnp.dtype(dtype))
        return y * jax.nn.silu(z.astype(jnp.dtype(dtype))), h_last

    y, h = chain(jnp.asarray(xs), jnp.asarray(z), jnp.asarray(h0))
    return np.array(y.astype(jnp.float32)), np.array(h)


def _inputs(N: int, dtype: str):
    """The port's scan inputs: x and z in the model type, the x_proj and
    dt_proj products in f32, B and C as slices of x_dbl (the Mamba block
    passes them so)."""
    xs, z, p, h0, _ = _case(N, dtype)
    tdt = getattr(torch, dtype)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    x_dbl = torch.from_numpy(xs) @ t["x_proj"]
    dt = x_dbl[..., :DT_RANK] @ t["dt_proj"]
    return (torch.from_numpy(xs).to(tdt), dt, torch.from_numpy(z).to(tdt),
            x_dbl[..., DT_RANK:DT_RANK + N], x_dbl[..., DT_RANK + N:],
            t["A_log"], t["D"], t["dt_bias"], torch.from_numpy(h0))


def _assert_scan_close(got, want):
    """chip_smoke.py's check_scan: f32 y within 1e-5 of max|y|, bf16 y
    within two bf16 ulps of each element plus 1e-5 of max|y|; h_last
    within 1e-5 of max|h|."""
    (y, h), (wy, wh) = got, want
    wy, wh = torch.as_tensor(wy).float(), torch.as_tensor(wh)
    scale = float(wy.abs().max())
    d = (y.float() - wy).abs()
    if y.dtype == torch.bfloat16:
        assert bool((d <= 2.0 ** -6 * wy.abs() + 1e-5 * scale).all()), \
            float(d.max())
    else:
        assert float(d.max()) <= 1e-5 * scale, float(d.max())
    assert float((h - wh).abs().max()) <= 1e-5 * float(wh.abs().max())


@pytest.mark.parametrize("N,dtype,G", CASES,
                         ids=[f"N{n}-{d}-G{g}" for n, d, g in CASES])
def test_scan_model_matches_the_reference_chain(N, dtype, G):
    """The kernel's order against the reference's chunked associative scan
    (one chunk of 33 tokens), its C contraction and its gate."""
    _assert_scan_close(scan_model(*_inputs(N, dtype), G=G),
                       _reference(N, dtype))


@pytest.mark.parametrize("N,dtype,G", CASES,
                         ids=[f"N{n}-{d}-G{g}" for n, d, g in CASES])
def test_scan_model_matches_the_plain_version(N, dtype, G):
    """The kernel's order against ref.selective_scan_ref (the n sum of
    torch's ``sum``), on B and C read as the strided slices of x_dbl."""
    args = _inputs(N, dtype)
    assert not args[3].is_contiguous() and not args[4].is_contiguous()
    _assert_scan_close(scan_model(*args, G=G), ref.selective_scan_ref(*args))


def test_lanes_are_the_kernel_source_s():
    """The wrapper's LANES are the kernel's kLanesN4 and kLanesN16, and
    each divides its N."""
    src = (build.CSRC / "selective_scan.cu").read_text()
    for N in STATES:
        m = re.search(rf"constexpr int kLanesN{N} = (\d+);", src)
        assert m and int(m.group(1)) == LANES[N] and N % LANES[N] == 0
    assert set(LANES) == set(STATES)
