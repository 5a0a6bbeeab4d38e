"""Flash attention: wrappers of the CUDA kernels in ``csrc/flash_attention.cu``
(counterpart of ``repro.kernels.flash_attention``) and of its backward in
``csrc/flash_attention_bwd.cu``.

Causal and/or sliding-window attention with GQA. A CUDA tensor launches
the kernel (or raises): bf16 runs the tensor-core forward and backward,
f32 the scalar ones. A CPU tensor takes the plain versions in
``kernels/ref.py``. Both directions take the head-dim pairs (d_qk, d_v) in
``HEAD_DIMS``: q and k d_qk wide, v and o d_v wide, scaled by 1/√d_qk;
(192, 128) is MLA's (deepseek-v2).

Two routes, chosen by autograd's state and never by what the kernels take:
- forward only (``torch.inference_mode()``, ``no_grad``, or no input that
  requires a gradient): one launch, which writes no log-sum-exp. The
  zeroth-order rounds run this route.
- under autograd with an input that requires a gradient:
  ``_FlashAttention``, a ``torch.autograd.Function``. Its forward launches
  the same kernel with the row log-sum-exp as a second output and saves
  q, k, v, o and the lse; its backward launches
  ``flash_attention_bwd``. What the kernels do not take (a head-dim pair,
  a dtype) raises on both routes; no plain version stands in for them.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

# (d_qk, d_v) pairs of the forward and backward kernels
HEAD_DIMS = ((64, 64), (128, 128), (192, 128))
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


def _readable(t: torch.Tensor) -> torch.Tensor:
    """``t`` if the kernels read it as it lies, else a contiguous copy (a
    new allocation, so on 16 bytes even where ``t`` was contiguous at a
    misaligned offset)."""
    return t if _fits(t) else t.clone(memory_format=torch.contiguous_format)


def _check_shapes(q, k, v) -> None:
    B, H, S, d = q.shape
    Hkv = k.shape[1]
    if k.shape != (B, Hkv, S, d) or v.shape[:3] != k.shape[:3] or H % Hkv:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")


def _check_cuda(what: str, *ts: torch.Tensor) -> None:
    """Raise unless the tensors are CUDA tensors of one kernel dtype with a
    (d_qk, d_v) head-dim pair the kernels take (q first, v third)."""
    q = ts[0]
    if not q.is_cuda:
        raise ValueError(f"{what}: expected a CPU or CUDA tensor, got "
                         f"{q.device}")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"{what}: dtypes {[t.dtype for t in ts]}; the "
                        f"kernel takes one of float32/bfloat16")
    dims = (q.shape[-1], ts[2].shape[-1])
    if dims not in HEAD_DIMS:
        raise ValueError(f"{what}: head dims (d_qk, d_v) {dims} not in "
                         f"{HEAD_DIMS}")


def _launch_forward(q, k, v, o, lse, causal: bool, window: int) -> None:
    B, H, S, d = q.shape
    err = build.library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(),
        *_strides(q), *_strides(k), *_strides(v), *_strides(o), B, H,
        k.shape[1], S, d, v.shape[-1], _DTYPES[q.dtype], 1.0 / math.sqrt(d),
        int(causal), int(window),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention")
    build.LAUNCHES["flash_attention"] += 1
    build.LAUNCHES[f"flash_attention ({d}, {v.shape[-1]})"] += 1


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0):
    """(dq, dk, dv) of attention at (q, k, v) with output o, row
    log-sum-exp lse ((B, H, S) f32) and incoming gradient do. Views the
    kernels read as they lie (``_fits``) are read in place, others are
    copied first; the gradients come back contiguous, in the inputs' type.
    A CUDA tensor launches the backward kernel (or raises); a CPU tensor takes
    ``ref.flash_attention_bwd_ref``. o and do are (B, H, S, d_v), v's
    width; dv comes back d_v wide."""
    _check_shapes(q, k, v)
    o_shape = q.shape[:3] + v.shape[-1:]
    if o.shape != o_shape or do.shape != o_shape \
            or lse.shape != q.shape[:3]:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)}, do "
                         f"{tuple(do.shape)}, lse {tuple(lse.shape)} for q "
                         f"{tuple(q.shape)}")
    if q.device.type == "cpu":
        return _ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal,
                                            window)
    _check_cuda("flash_attention_bwd", q, k, v, o, do)
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("flash_attention_bwd: lse must be contiguous f32")
    q, k, v, o, do = (_readable(t) for t in (q, k, v, o, do))
    B, H, S, d = q.shape
    Hkv = k.shape[1]
    lib = build.library()
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    # Δ, and the bf16 dK/dV kernel's per-head partials where it has them
    scratch = torch.empty(lib.flash_attention_bwd_scratch_floats(
        B, H, Hkv, S, d, v.shape[-1], _DTYPES[q.dtype]),
        dtype=torch.float32, device=q.device)
    err = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        scratch.data_ptr(), *_strides(q), *_strides(k), *_strides(v),
        *_strides(o), *_strides(do), B, H, Hkv, S, d, v.shape[-1],
        _DTYPES[q.dtype], 1.0 / math.sqrt(d), int(causal), int(window),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention_bwd")
    build.LAUNCHES["flash_attention_bwd"] += 1
    build.LAUNCHES[f"flash_attention_bwd ({d}, {v.shape[-1]})"] += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Attention with its gradient through the kernels (or, on the CPU,
    their plain versions). o is returned as a (B, H, S, d) view of a
    (B, S, H, d) buffer, the layout the model's output projection reads."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        B, H, S, d = q.shape
        if q.device.type == "cpu":
            o, lse = _ref.flash_attention_ref(q, k, v, causal, window,
                                              return_lse=True)
        else:
            _check_cuda("flash_attention", q, k, v)
            q, k, v = (_readable(t) for t in (q, k, v))
            o = _out_buffer(q, v.shape[-1])
            lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
            _launch_forward(q, k, v, o, lse, causal, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do,
                                         causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def _out_buffer(q: torch.Tensor, dv: int) -> torch.Tensor:
    """A (B, H, S, dv) view of a new (B, S, H, dv) buffer: the layout the
    model's output projection reads, with no copy."""
    B, H, S, _ = q.shape
    return torch.empty(B, S, H, dv, dtype=q.dtype,
                       device=q.device).transpose(1, 2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, H, S, d); k: (B, Hkv, S, d); v: (B, Hkv, S, d_v) -> (B, H,
    S, d_v) in q's type, on the card a view of a (B, S, H, d_v) buffer on
    both routes; (d, d_v) one of ``HEAD_DIMS`` on the card, under autograd
    too.

    Views with a unit stride along d are read in place (the model passes v
    as a transpose of its projection, MLA as a slice of one); others are
    copied first."""
    _check_shapes(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window)
    if q.device.type == "cpu":
        return _ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    _check_cuda("flash_attention", q, k, v)
    q, k, v = (_readable(t) for t in (q, k, v))
    o = _out_buffer(q, v.shape[-1])
    _launch_forward(q, k, v, o, None, causal, window)
    return o
