"""Mamba's selective scan: the wrappers of the CUDA kernels in
``csrc/selective_scan.cu`` and its backward ``csrc/selective_scan_bwd.cu``
(no Pallas counterpart: the reference's scan is jnp, ``repro.models.ssm``'s
``_mamba_ssm_params``, ``_ssm_scan_chunk`` and the gate of
``mamba_forward``, and its gradient XLA's autodiff of them).

    y, h_last = selective_scan(x, dt, z, Bc, Cc, A_log, D, dt_bias, h0)

with δ = softplus(dt + dt_bias), h_t = exp(δ·A)·h_{t-1} + (δ·x)·B_t
(A = -exp(A_log)), y = ((Σ_n h·C + x·D) in x's type)·silu(z), over the
whole sequence in one launch. x and z are (B, S, d_in) in the model type
(f32 or bf16); dt (the dt_proj product before its bias) (B, S, d_in) f32;
Bc and Cc (B, S, N) f32; A_log (d_in, N), D and dt_bias (d_in,), h0 (B,
d_in, N), all f32. ``h_out``, if given, receives h_last (it may be h0
itself: decode's state is updated in place). z, Bc and Cc may be views
whose rows (b, t) are evenly spaced with a contiguous last dimension (a
half of in_proj's output, slices of x_proj's): the kernel reads them in
place; every other tensor is contiguous. A CUDA tensor launches the
kernel (N 4 or 16) or raises; a CPU tensor takes the plain version in
``kernels/ref.py``.

Under autograd (grad enabled and an input that requires a gradient) the
call goes through ``_SelectiveScan``: on the card its forward launches the
kernel with ``h_chunks``, h at the start of each 32-token chunk, (B,
ceil(S / 32), d_in, N) f32, and its backward launches
``selective_scan_bwd`` (two launches: the reverse recurrence, then the
sums of its per-block partials), which recomputes each chunk's h from
there; on the CPU the plain forward and ``ref.selective_scan_bwd_ref`` run.
h_out is not taken under autograd.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
STATES = (4, 16)           # the kernel's template instances of N
# lanes a channel's N states are split over in the kernel (csrc:
# kLanesN16, kLanesN4): its sum over n runs in that many partials
LANES = {4: 4, 16: 4}
_STRIDED = ("z", "Bc", "Cc")   # read in place through a row stride
# tokens between the h the forward saves for the backward (csrc: kChunk;
# selective_scan_plan's plan[2])
CHUNK = 32


def _row_stride(name: str, t: torch.Tensor) -> int:
    """The stride between the rows (b, t) of a (B, S, W) view whose last
    dimension is contiguous and whose rows are evenly spaced; raise
    otherwise."""
    B, S, W = t.shape
    if W > 1 and t.stride(2) != 1:
        raise ValueError(f"selective_scan: {name}'s last dimension must be "
                         f"contiguous, got strides {t.stride()}")
    rs = t.stride(1) if S > 1 else (t.stride(0) if B > 1 else W)
    if B > 1 and t.stride(0) != S * rs:
        raise ValueError(f"selective_scan: {name}'s rows must be evenly "
                         f"spaced (contiguous over (B, S)), got strides "
                         f"{t.stride()}")
    return rs


def _check(x, dt, z, Bc, Cc, A_log, D, dt_bias, h0, h_out) -> tuple:
    """Raise unless every tensor lies on x's CUDA device with the shape
    and dtype the kernel takes, contiguous but for the row strides of z,
    Bc and Cc. Returns those three strides."""
    what = "selective_scan"
    if not x.is_cuda:
        raise ValueError(f"{what}: expected a CPU or CUDA tensor, got "
                         f"{x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {x.dtype} is not float32/bfloat16")
    if x.dim() != 3:
        raise ValueError(f"{what}: x must be (B, S, d_in), got "
                         f"{tuple(x.shape)}")
    B, S, d_in = x.shape
    N = A_log.shape[-1] if A_log.dim() == 2 else -1
    if N not in STATES:
        raise ValueError(f"{what}: d_state {N} is not one of the kernel's "
                         f"{STATES}")
    want = {"x": (x, (B, S, d_in), x.dtype), "dt": (dt, (B, S, d_in), None),
            "z": (z, (B, S, d_in), x.dtype), "Bc": (Bc, (B, S, N), None),
            "Cc": (Cc, (B, S, N), None), "A_log": (A_log, (d_in, N), None),
            "D": (D, (d_in,), None), "dt_bias": (dt_bias, (d_in,), None),
            "h0": (h0, (B, d_in, N), None)}
    if h_out is not None:
        want["h_out"] = (h_out, (B, d_in, N), None)
    for name, (t, shape, dtype) in want.items():
        dtype = dtype or torch.float32
        if (t.device != x.device or t.dtype != dtype
                or tuple(t.shape) != shape):
            raise ValueError(f"{what}: {name} must be {shape} {dtype} on "
                             f"{x.device}, got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")
        if name not in _STRIDED and not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    return tuple(_row_stride(name, t) for name, t in
                 (("z", z), ("Bc", Bc), ("Cc", Cc)))


def _launch(x, dt, z, Bc, Cc, A_log, D, dt_bias, h0, h_out, save: bool):
    """One forward launch on the card: (y, h_last, h_chunks or None)."""
    strides = _check(x, dt, z, Bc, Cc, A_log, D, dt_bias, h0, h_out)
    B, S, d_in = x.shape
    N = A_log.shape[-1]
    y = torch.empty_like(x)
    h_last = torch.empty_like(h0) if h_out is None else h_out
    h_chunks = (torch.empty(B, -(-S // CHUNK), d_in, N, dtype=torch.float32,
                            device=x.device) if save else None)
    err = build.library().selective_scan_launch(
        x.data_ptr(), dt.data_ptr(), z.data_ptr(), Bc.data_ptr(),
        Cc.data_ptr(), A_log.data_ptr(), D.data_ptr(), dt_bias.data_ptr(),
        h0.data_ptr(), y.data_ptr(), h_last.data_ptr(),
        None if h_chunks is None else h_chunks.data_ptr(), *strides, B, S,
        d_in, N, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "selective_scan")
    build.LAUNCHES["selective_scan"] += 1
    return y, h_last, h_chunks


def selective_scan_bwd(x, dt, z, Bc, Cc, A_log, D, dt_bias, h0, h_chunks,
                       dy, dh_last=None):
    """The scan's gradient: (dx, ddt, dz, dBc, dCc, dA_log, dD, ddt_bias,
    dh0), each in its input's type and shape, contiguous. ``h_chunks`` is
    what the forward saved under autograd (on the card; ignored on the
    CPU, where ``ref.selective_scan_bwd_ref`` runs); dy is y's cotangent
    (x's type), dh_last h_last's (f32, None for zero)."""
    if x.device.type == "cpu":
        return _ref.selective_scan_bwd_ref(x, dt, z, Bc, Cc, A_log, D,
                                           dt_bias, h0, dy, dh_last)
    if dh_last is not None:
        dh_last = dh_last.contiguous()
    # dh_last takes h_out's checks: (B, d_in, N) f32 on x's device
    strides = _check(x, dt, z, Bc, Cc, A_log, D, dt_bias, h0, dh_last)
    B, S, d_in = x.shape
    N = A_log.shape[-1]
    want = (B, -(-S // CHUNK), d_in, N)
    if (h_chunks is None or tuple(h_chunks.shape) != want
            or h_chunks.dtype != torch.float32 or not h_chunks.is_contiguous()
            or h_chunks.device != x.device):
        raise ValueError(f"selective_scan_bwd: h_chunks must be {want} "
                         f"float32 contiguous on {x.device}")
    if (dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device):
        raise ValueError(f"selective_scan_bwd: dy must be {tuple(x.shape)} "
                         f"{x.dtype} on {x.device}, got {tuple(dy.shape)} "
                         f"{dy.dtype} on {dy.device}")
    dy = dy.contiguous()
    lib = build.library()
    outs = (torch.empty_like(x), torch.empty_like(dt),
            torch.empty(x.shape, dtype=x.dtype, device=x.device),
            torch.empty(B, S, N, device=x.device),
            torch.empty(B, S, N, device=x.device), torch.empty_like(A_log),
            torch.empty_like(D), torch.empty_like(dt_bias),
            torch.empty_like(h0))
    scratch = torch.empty(lib.selective_scan_bwd_scratch_floats(B, S, d_in,
                                                                N),
                          dtype=torch.float32, device=x.device)
    err = lib.selective_scan_bwd_launch(
        x.data_ptr(), dt.data_ptr(), z.data_ptr(), Bc.data_ptr(),
        Cc.data_ptr(), A_log.data_ptr(), D.data_ptr(), dt_bias.data_ptr(),
        h_chunks.data_ptr(), dy.data_ptr(),
        None if dh_last is None else dh_last.data_ptr(),
        *(t.data_ptr() for t in outs), scratch.data_ptr(), *strides, B, S,
        d_in, N, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "selective_scan_bwd")
    build.LAUNCHES["selective_scan_bwd"] += 1
    return outs


class _SelectiveScan(torch.autograd.Function):
    """The scan with its gradient through the kernels (or, on the CPU,
    their plain versions)."""

    @staticmethod
    def forward(ctx, x, dt, z, Bc, Cc, A_log, D, dt_bias, h0):
        if x.device.type == "cpu":
            y, h_last = _ref.selective_scan_ref(x, dt, z, Bc, Cc, A_log, D,
                                                dt_bias, h0)
            h_chunks = None
        else:
            y, h_last, h_chunks = _launch(x, dt, z, Bc, Cc, A_log, D,
                                          dt_bias, h0, None, save=True)
        ctx.save_for_backward(x, dt, z, Bc, Cc, A_log, D, dt_bias, h0,
                              h_chunks)
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        *inputs, h_chunks = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(inputs[0])
        return selective_scan_bwd(*inputs, h_chunks, dy, dh_last)


def selective_scan(x: torch.Tensor, dt: torch.Tensor, z: torch.Tensor,
                   Bc: torch.Tensor, Cc: torch.Tensor, A_log: torch.Tensor,
                   D: torch.Tensor, dt_bias: torch.Tensor, h0: torch.Tensor,
                   *, h_out: Optional[torch.Tensor] = None):
    """(y (B, S, d_in) in x's type, h_last (B, d_in, N) f32); h_last is
    ``h_out`` when given."""
    args = (x, dt, z, Bc, Cc, A_log, D, dt_bias, h0)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        if h_out is not None:
            raise ValueError("selective_scan: h_out is not taken under "
                             "autograd")
        return _SelectiveScan.apply(*args)
    if x.device.type == "cpu":
        y, h = _ref.selective_scan_ref(*args)
        if h_out is None:
            return y, h
        return y, h_out.copy_(h)
    y, h_last, _ = _launch(*args, h_out, save=False)
    return y, h_last
