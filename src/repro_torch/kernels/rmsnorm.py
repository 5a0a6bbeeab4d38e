"""RMSNorm: wrappers of the CUDA kernels in ``csrc/rmsnorm.cu``
(counterpart of ``repro.kernels.rmsnorm``).

    y = x·rsqrt(mean(x²) + eps)·scale    over the last dim of x

f32 math, output in x's type; ``scale`` is the (D,) f32 weight. Any number
of rows runs with no padding (the TPU kernel padded rows to a block of
128). ``rmsnorm_pair`` norms two tensors of one row width (an attention
layer's q and k) in one launch. A CUDA tensor launches the kernel (or
raises); a CPU tensor takes the plain version in ``kernels/ref.py``.

Under autograd, when x or the scale requires a gradient, the norms run as
``torch.autograd.Function``s whose forward is the same launch (the pair
still one) and whose backward is ``rmsnorm_bwd`` (``rmsnorm_bwd_launch``:
dx, and dscale summed over the rows in f32; the pair's backward is two of
them). Under ``inference_mode``/``no_grad`` nothing changes.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# widest row of the pair kernel, which gives a row at most one warp
_PAIR_MAX_D = 1024


def _checked(x: torch.Tensor, scale: torch.Tensor, what: str) -> int:
    """Raise unless x is a contiguous f32/bf16 CUDA tensor and scale its
    contiguous (D,) f32 weight on the same device; returns D."""
    if not x.is_cuda:
        raise ValueError(f"{what}: expected a CPU or CUDA tensor, got "
                         f"{x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {x.dtype} is not float32/bfloat16")
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous")
    D = x.shape[-1]
    if (scale.device != x.device or scale.dtype != torch.float32
            or scale.shape != (D,) or not scale.is_contiguous()):
        raise ValueError(f"{what}: scale must be a contiguous ({D},) "
                         f"float32 tensor on {x.device}, got "
                         f"{tuple(scale.shape)} {scale.dtype} on "
                         f"{scale.device}")
    return D


def _wants_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5
            ) -> torch.Tensor:
    """x: (..., D) contiguous f32 or bf16; scale: (D,) f32 on x's device."""
    if _wants_grad(x, scale):
        return _RMSNorm.apply(x, scale, eps)
    return _rmsnorm(x, scale, eps)


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    if x.device.type == "cpu":
        return _ref.rmsnorm_ref(x, scale, eps)
    D = _checked(x, scale, "rmsnorm")
    y = torch.empty_like(x)
    rows = x.numel() // D if D else 0
    if rows == 0:
        return y
    err = build.library().rmsnorm_launch(
        x.data_ptr(), scale.data_ptr(), y.data_ptr(), rows, D,
        _DTYPES[x.dtype], float(eps),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "rmsnorm")
    build.LAUNCHES["rmsnorm"] += 1
    return y


def rmsnorm_pair(xq: torch.Tensor, sq: torch.Tensor, xk: torch.Tensor,
                 sk: torch.Tensor, *, eps: float = 1e-5):
    """(rmsnorm(xq, sq), rmsnorm(xk, sk)) in one launch. xq and xk share a
    dtype, a device and a row width D <= 1024 (the qk-norm's d_head)."""
    if _wants_grad(xq, sq, xk, sk):
        return _RMSNormPair.apply(xq, sq, xk, sk, eps)
    return _rmsnorm_pair(xq, sq, xk, sk, eps)


def _rmsnorm_pair(xq, sq, xk, sk, eps: float):
    if xq.device.type == "cpu":
        return _ref.rmsnorm_pair_ref(xq, sq, xk, sk, eps)
    D = _checked(xq, sq, "rmsnorm_pair")
    if _checked(xk, sk, "rmsnorm_pair") != D or xk.dtype != xq.dtype \
            or xk.device != xq.device:
        raise ValueError(f"rmsnorm_pair: q {tuple(xq.shape)} {xq.dtype} on "
                         f"{xq.device} and k {tuple(xk.shape)} {xk.dtype} on "
                         f"{xk.device} must share a dtype, a device and the "
                         f"row width")
    if not 0 < D <= _PAIR_MAX_D:
        raise ValueError(f"rmsnorm_pair: row width {D} outside (0, "
                         f"{_PAIR_MAX_D}]")
    yq, yk = torch.empty_like(xq), torch.empty_like(xk)
    rows_q, rows_k = xq.numel() // D, xk.numel() // D
    if rows_q + rows_k == 0:
        return yq, yk
    err = build.library().rmsnorm_pair_launch(
        xq.data_ptr(), sq.data_ptr(), yq.data_ptr(), rows_q, xk.data_ptr(),
        sk.data_ptr(), yk.data_ptr(), rows_k, D, _DTYPES[xq.dtype],
        float(eps), torch.cuda.current_stream(xq.device).cuda_stream)
    build.check(err, "rmsnorm_pair")
    build.LAUNCHES["rmsnorm"] += 1
    return yq, yk


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, *,
                eps: float = 1e-5):
    """(dx, dscale) of ``rmsnorm`` at x with incoming gradient dy (copied
    first unless contiguous): dx in x's type, dscale (D,) f32. A CUDA
    tensor launches the backward kernels (or raises); a CPU tensor takes
    ``ref.rmsnorm_bwd_ref``."""
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"rmsnorm_bwd: dy {tuple(dy.shape)} {dy.dtype} for "
                         f"x {tuple(x.shape)} {x.dtype}")
    if x.device.type == "cpu":
        return _ref.rmsnorm_bwd_ref(x, scale, dy, eps)
    D = _checked(x, scale, "rmsnorm_bwd")
    dy = dy.contiguous()
    rows = x.numel() // D if D else 0
    dx = torch.empty_like(x)
    dscale = torch.zeros(D, dtype=torch.float32, device=x.device)
    if rows == 0:
        return dx, dscale
    lib = build.library()
    chunks = -(-rows // lib.rmsnorm_bwd_chunk_rows())
    rstd = torch.empty(rows, dtype=torch.float32, device=x.device)
    partial = torch.empty(chunks, D, dtype=torch.float32, device=x.device)
    err = lib.rmsnorm_bwd_launch(
        x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        dscale.data_ptr(), rstd.data_ptr(), partial.data_ptr(), rows, D,
        _DTYPES[x.dtype], float(eps),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "rmsnorm_bwd")
    build.LAUNCHES["rmsnorm_bwd"] += 1
    return dx, dscale


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps: float):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _rmsnorm(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x, scale, dy, eps=ctx.eps)
        return dx, dscale, None


class _RMSNormPair(torch.autograd.Function):
    """The pair norm: one forward launch, a backward of two."""

    @staticmethod
    def forward(ctx, xq, sq, xk, sk, eps: float):
        ctx.save_for_backward(xq, sq, xk, sk)
        ctx.eps = eps
        return _rmsnorm_pair(xq, sq, xk, sk, eps)

    @staticmethod
    def backward(ctx, dyq, dyk):
        xq, sq, xk, sk = ctx.saved_tensors
        dxq, dsq = rmsnorm_bwd(xq, sq, dyq, eps=ctx.eps)
        dxk, dsk = rmsnorm_bwd(xk, sk, dyk, eps=ctx.eps)
        return dxq, dsq, dxk, dsk, None
