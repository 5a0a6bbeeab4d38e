"""RMSNorm: wrapper of the CUDA kernel in ``csrc/rmsnorm.cu`` (counterpart
of ``repro.kernels.rmsnorm``).

    y = x·rsqrt(mean(x²) + eps)·scale    over the last dim of x

f32 math, output in x's type; ``scale`` is the (D,) f32 weight. Any number
of rows runs with no padding (the TPU kernel padded rows to a block of
128). A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
plain version in ``kernels/ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5
            ) -> torch.Tensor:
    """x: (..., D) contiguous f32 or bf16; scale: (D,) f32 on x's device."""
    if x.device.type == "cpu":
        return _ref.rmsnorm_ref(x, scale, eps)
    if not x.is_cuda:
        raise ValueError(f"rmsnorm: expected a CPU or CUDA tensor, got "
                         f"{x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm: dtype {x.dtype} is not float32/bfloat16")
    if not x.is_contiguous():
        raise ValueError("rmsnorm: x must be contiguous")
    D = x.shape[-1]
    if (scale.device != x.device or scale.dtype != torch.float32
            or scale.shape != (D,) or not scale.is_contiguous()):
        raise ValueError(f"rmsnorm: scale must be a contiguous ({D},) "
                         f"float32 tensor on {x.device}, got "
                         f"{tuple(scale.shape)} {scale.dtype} on "
                         f"{scale.device}")
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
