"""The sLSTM recurrence: the wrapper of the CUDA kernel in ``csrc/slstm.cu``
(no Pallas counterpart: the reference's recurrence is ``repro.models.ssm``'s
``_slstm_step`` under a ``lax.scan``).

    hs, (c, n, m, h) = slstm(x_pre, b, r, c, n, m, h)

runs the recurrence over the whole sequence in one launch. x_pre is the
``w_x`` product (B, S, 4·D) in the model type (f32 or bf16), its last
dimension laid out (gate z, i, f, o; head; column); b (4·D,) f32; r (4, H,
dh, dh) f32; the state c, n, m, h (B, H, dh) f32, D = H·dh. hs is (B, S,
D) in x_pre's type; the final state is f32. ``out``, if given, is four
(B, H, dh) f32 tensors that receive the final state (they may be the input
state itself: decode's state is updated in place). A CUDA tensor launches
the kernel (dh in ``HEAD_DIMS``, every tensor contiguous) or raises; a CPU tensor takes the plain version
``ref.slstm_ref``. The kernel has no backward: under autograd a CUDA call
raises (the first-order rounds refuse an xLSTM model before they get
here, ``core/baselines.py``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the head dims the kernel takes (csrc: takes): one block a head at 16 and
# 32, clusters of dh / 32 blocks above (dh / 16 at B = 1)
HEAD_DIMS = (16, 32, 64, 128, 256)


def _check(x_pre, b, r, state, out) -> None:
    """Raise unless every tensor lies on x_pre's CUDA device with the shape
    and dtype the kernel takes, contiguous."""
    what = "slstm"
    if not x_pre.is_cuda:
        raise ValueError(f"{what}: expected a CPU or CUDA tensor, got "
                         f"{x_pre.device}")
    if x_pre.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {x_pre.dtype} is not "
                        f"float32/bfloat16")
    if r.dim() != 4 or r.shape[0] != 4 or r.shape[2] != r.shape[3]:
        raise ValueError(f"{what}: r must be (4, H, dh, dh), got "
                         f"{tuple(r.shape)}")
    _, H, dh, _ = r.shape
    if dh not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {dh} is not one of the kernel's "
                         f"{HEAD_DIMS}")
    if x_pre.dim() != 3 or x_pre.shape[2] != 4 * H * dh or x_pre.shape[1] < 1:
        raise ValueError(f"{what}: x_pre must be (B, S >= 1, {4 * H * dh}), "
                         f"got {tuple(x_pre.shape)}")
    B = x_pre.shape[0]
    want = {"x_pre": (x_pre, tuple(x_pre.shape), x_pre.dtype),
            "b": (b, (4 * H * dh,), torch.float32),
            "r": (r, (4, H, dh, dh), torch.float32)}
    for i, name in enumerate("cnmh"):
        want[name] = (state[i], (B, H, dh), torch.float32)
        if out is not None:
            want[f"out {name}"] = (out[i], (B, H, dh), torch.float32)
    for name, (t, shape, dtype) in want.items():
        if (t.device != x_pre.device or t.dtype != dtype
                or tuple(t.shape) != shape):
            raise ValueError(f"{what}: {name} must be {shape} {dtype} on "
                             f"{x_pre.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def _launch(x_pre, b, r, state, out):
    _check(x_pre, b, r, state, out)
    B, S, _ = x_pre.shape
    _, H, dh, _ = r.shape
    hs = torch.empty((B, S, H * dh), dtype=x_pre.dtype, device=x_pre.device)
    if out is None:
        out = tuple(torch.empty_like(s) for s in state)
    err = build.library().slstm_launch(
        x_pre.data_ptr(), b.data_ptr(), r.data_ptr(),
        *(s.data_ptr() for s in state), hs.data_ptr(),
        *(o.data_ptr() for o in out), B, S, H, dh, _DTYPES[x_pre.dtype],
        torch.cuda.current_stream(x_pre.device).cuda_stream)
    build.check(err, "slstm")
    build.LAUNCHES["slstm"] += 1
    return hs, tuple(out)


def slstm(x_pre: torch.Tensor, b: torch.Tensor, r: torch.Tensor,
          c: torch.Tensor, n: torch.Tensor, m: torch.Tensor, h: torch.Tensor,
          *, out: Optional[Sequence[torch.Tensor]] = None):
    """(hs (B, S, D) in x_pre's type, (c, n, m, h) (B, H, dh) f32); the
    state tensors are ``out``'s when given."""
    state = (c, n, m, h)
    if x_pre.device.type == "cpu":
        hs, final = _ref.slstm_ref(x_pre, b, r, *state)
        if out is None:
            return hs, final
        for o, s in zip(out, final):
            o.copy_(s)
        return hs, tuple(out)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x_pre, b, r, *state)):
        raise NotImplementedError(
            "slstm: the sLSTM kernel has no backward yet (ROADMAP.md, "
            "queue 1, item 6.4)")
    return _launch(x_pre, b, r, state, out)
