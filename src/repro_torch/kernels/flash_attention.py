"""Flash-attention forward: wrapper of the CUDA kernel in
``csrc/flash_attention.cu`` (counterpart of
``repro.kernels.flash_attention``).

Causal and/or sliding-window attention with GQA, forward only (zeroth-order
training has no backward pass). A CUDA tensor launches the kernel (or
raises); a CPU tensor takes ``kernels/ref.flash_attention_ref``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, H, S, d); k, v: (B, Hkv, S, d) -> (B, H, S, d) in q's type."""
    if q.device.type == "cpu":
        return _ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    if not q.is_cuda:
        raise ValueError(f"flash_attention: expected a CPU or CUDA tensor, "
                         f"got {q.device}")
    B, H, S, d = q.shape
    Hkv = k.shape[1]
    if k.shape != (B, Hkv, S, d) or v.shape != k.shape or H % Hkv:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; the kernel takes one of float32/bfloat16")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    err = build.library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, Hkv, S,
        d, _DTYPES[q.dtype], 1.0 / math.sqrt(d), int(causal), int(window),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention")
    build.LAUNCHES["flash_attention"] += 1
    return o
