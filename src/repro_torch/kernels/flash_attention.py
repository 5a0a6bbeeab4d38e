"""Flash-attention forward: wrapper of the CUDA kernel in
``csrc/flash_attention.cu`` (counterpart of
``repro.kernels.flash_attention``).

Causal and/or sliding-window attention with GQA, forward only (zeroth-order
training has no backward pass). A CUDA tensor launches the kernel (or
raises): bf16 runs the tensor-core kernel, f32 the scalar one. A CPU tensor
takes ``kernels/ref.flash_attention_ref``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _strides(t: torch.Tensor):
    """(batch, head, row) element strides; 0 along a dim of size 1, which
    the kernel never steps along."""
    return tuple(t.stride(i) if t.shape[i] > 1 else 0 for i in range(3))


def _fits(t: torch.Tensor) -> bool:
    """Whether the kernel reads ``t`` as it lies: unit stride along d and,
    for bf16 (16-byte copies), rows that start on 16 bytes."""
    if t.stride(-1) != 1:
        return False
    if t.dtype != torch.bfloat16:
        return True
    return t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in _strides(t))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """q: (B, H, S, d); k, v: (B, Hkv, S, d) -> (B, H, S, d) in q's type.

    Views with a unit stride along d are read in place (the model passes v
    as a transpose of its projection); others are copied first. ``out``,
    if given, is a (B, H, S, d) tensor of q's type, possibly a strided view
    (a transpose of a (B, S, H, d) buffer), that the result is written
    into and returned as."""
    B, H, S, d = q.shape
    Hkv = k.shape[1]
    if k.shape != (B, Hkv, S, d) or v.shape != k.shape or H % Hkv:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if out is not None and (out.shape != q.shape or out.dtype != q.dtype
                            or out.device != q.device):
        raise ValueError(f"flash_attention: out must be a {tuple(q.shape)} "
                         f"{q.dtype} tensor on {q.device}, got "
                         f"{tuple(out.shape)} {out.dtype} on {out.device}")
    if q.device.type == "cpu":
        o = _ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        return o if out is None else out.copy_(o)
    if not q.is_cuda:
        raise ValueError(f"flash_attention: expected a CPU or CUDA tensor, "
                         f"got {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; the kernel takes one of float32/bfloat16")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    q, k, v = (t if _fits(t) else t.contiguous() for t in (q, k, v))
    o = torch.empty_like(q, memory_format=torch.contiguous_format) \
        if out is None else out
    if not _fits(o):
        raise ValueError("flash_attention: out needs a unit stride along d "
                         "and, in bf16, rows on 16 bytes")
    err = build.library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        *_strides(q), *_strides(k), *_strides(v), *_strides(o), B, H, Hkv, S,
        d, _DTYPES[q.dtype], 1.0 / math.sqrt(d), int(causal), int(window),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention")
    build.LAUNCHES["flash_attention"] += 1
    return o
