"""RMSNorm: wrappers of the CUDA kernels in ``csrc/rmsnorm.cu``
(counterpart of ``repro.kernels.rmsnorm``).

    y = x·rsqrt(mean(x²) + eps)·scale    over the last dim of x

f32 math, output in x's type; ``scale`` is the (D,) f32 weight. Any number
of rows runs with no padding (the TPU kernel padded rows to a block of
128). ``rmsnorm_pair`` norms two tensors of one row width (an attention
layer's q and k) in one launch. A CUDA tensor launches the kernel (or
raises); a CPU tensor takes the plain version in ``kernels/ref.py``.
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


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5
            ) -> torch.Tensor:
    """x: (..., D) contiguous f32 or bf16; scale: (D,) f32 on x's device."""
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
