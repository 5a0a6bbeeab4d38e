"""The sLSTM recurrence: the wrappers of the CUDA kernels in
``csrc/slstm.cu`` and its backward ``csrc/slstm_bwd.cu`` (no Pallas
counterpart: the reference's recurrence is ``repro.models.ssm``'s
``_slstm_step`` under a ``lax.scan``, and its gradient XLA's autodiff of
that scan).

    hs, (c, n, m, h) = slstm(x_pre, b, r, c, n, m, h)

runs the recurrence over the whole sequence in one launch. x_pre is the
``w_x`` product (B, S, 4·D) in the model type (f32 or bf16), its last
dimension laid out (gate z, i, f, o; head; column); b (4·D,) f32; r (4, H,
dh, dh) f32; the state c, n, m, h (B, H, dh) f32, D = H·dh. hs is (B, S,
D) in x_pre's type; the final state is f32. ``out``, if given, is four
(B, H, dh) f32 tensors that receive the final state (they may be the input
state itself: decode's state is updated in place). A CUDA tensor launches
the kernel (dh in ``HEAD_DIMS``, every tensor contiguous) or raises; a CPU
tensor takes the plain version ``ref.slstm_ref``.

Under autograd (grad enabled and an input that requires a gradient) the
call goes through ``_SLSTM``: on the card its forward launches the kernel
with a record of each token, ``saved`` (B, S, 8, D) f32 (``SAVED``: the
four pre-activations, then c, n, m and h before the token; 32 bytes a
(token, column), 16 MiB at (1, 512, 1024)), and its backward launches
``slstm_bwd`` (the reverse recurrence, one launch), with dr and db from
the kernel's f32 dpre by one full-f32 product and a sum, only where b or
r needs a gradient (FedLoRA's needs neither); on the CPU ``ref.slstm_ref``
and ``ref.slstm_bwd_ref`` run. ``out`` is not taken under autograd.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the head dims the kernels take (csrc: takes): one block a head at 16 and
# 32, clusters of dh / 32 blocks above (dh / 16 at B = 1)
HEAD_DIMS = (16, 32, 64, 128, 256)
# the fields of the forward's record of a token for the backward (csrc:
# slstm_kernel's SAVE): pre_z, pre_i, pre_f, pre_o, then c, n, m and h as
# they were before the token
SAVED = 8


def _check_state(what, x_pre, B, H, dh, tensors) -> None:
    """Raise unless each named (B, H, dh) f32 tensor lies contiguous on
    x_pre's device."""
    for name, t in tensors.items():
        if (t.device != x_pre.device or t.dtype != torch.float32
                or tuple(t.shape) != (B, H, dh)):
            raise ValueError(f"{what}: {name} must be {(B, H, dh)} "
                             f"{torch.float32} on {x_pre.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def _check(x_pre, b, r, state, out, what="slstm") -> None:
    """Raise unless every tensor lies on x_pre's CUDA device with the shape
    and dtype the kernel takes, contiguous."""
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
    for name, (t, shape, dtype) in want.items():
        if (t.device != x_pre.device or t.dtype != dtype
                or tuple(t.shape) != shape):
            raise ValueError(f"{what}: {name} must be {shape} {dtype} on "
                             f"{x_pre.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    named = dict(zip("cnmh", state))
    if out is not None:
        named.update((f"out {k}", o) for k, o in zip("cnmh", out))
    _check_state(what, x_pre, B, H, dh, named)


def _launch(x_pre, b, r, state, out, save: bool = False):
    """One forward launch on the card: (hs, final state, saved or
    None)."""
    _check(x_pre, b, r, state, out)
    B, S, _ = x_pre.shape
    _, H, dh, _ = r.shape
    hs = torch.empty((B, S, H * dh), dtype=x_pre.dtype, device=x_pre.device)
    if out is None:
        out = tuple(torch.empty_like(s) for s in state)
    lib = build.library()
    args = (x_pre.data_ptr(), b.data_ptr(), r.data_ptr(),
            *(s.data_ptr() for s in state), hs.data_ptr(),
            *(o.data_ptr() for o in out))
    tail = (B, S, H, dh, _DTYPES[x_pre.dtype],
            torch.cuda.current_stream(x_pre.device).cuda_stream)
    saved = None
    if save:
        saved = torch.empty((B, S, SAVED, H * dh), dtype=torch.float32,
                            device=x_pre.device)
        err = lib.slstm_save_launch(*args, saved.data_ptr(), *tail)
    else:
        err = lib.slstm_launch(*args, *tail)
    build.check(err, "slstm")
    build.LAUNCHES["slstm"] += 1
    return hs, tuple(out), saved


def slstm_bwd(saved: torch.Tensor, r: torch.Tensor, dhs: torch.Tensor,
              dstate: Optional[Sequence[Optional[torch.Tensor]]] = None, *,
              params: bool = True):
    """The recurrence's gradient on the card: (dx_pre in dhs's type, db
    (4·D,) or None, dr (4, H, dh, dh) or None, dc0, dn0, dm0, dh0), from
    ``saved``, the forward's record (B, S, SAVED, D) f32, r, dhs (hs's
    cotangent (B, S, D) in the model type) and ``dstate``, the final
    state's four cotangents ((B, H, dh) f32, any None for zero). One
    launch of the reverse recurrence; with ``params`` db and dr from its
    f32 dpre: db a sum over (B, S), dr[g, head] = Σ h_{t-1} ⊗ dpre_g one
    full-f32 product over B·S (TF32 off), as the reference leaves that
    product to XLA's autodiff. The plain version is ``ref.slstm_bwd_ref``,
    which takes the forward's inputs instead of ``saved``."""
    what = "slstm_bwd"
    if not dhs.is_cuda:
        raise ValueError(f"{what}: expected CUDA tensors, got {dhs.device} "
                         f"(the CPU takes ref.slstm_bwd_ref)")
    if dhs.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {dhs.dtype} is not float32/bfloat16")
    if r.dim() != 4 or r.shape[0] != 4 or r.shape[2] != r.shape[3]:
        raise ValueError(f"{what}: r must be (4, H, dh, dh), got "
                         f"{tuple(r.shape)}")
    _, H, dh, _ = r.shape
    if dh not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {dh} is not one of the kernel's "
                         f"{HEAD_DIMS}")
    D = H * dh
    if dhs.dim() != 3 or dhs.shape[2] != D or dhs.shape[1] < 1:
        raise ValueError(f"{what}: dhs must be (B, S >= 1, {D}), got "
                         f"{tuple(dhs.shape)}")
    B, S, _ = dhs.shape
    for name, t, shape in (("saved", saved, (B, S, SAVED, D)),
                           ("r", r, (4, H, dh, dh))):
        if (t.device != dhs.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be {shape} float32 "
                             f"contiguous on {dhs.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    dhs = dhs.contiguous()
    dstate = [None] * 4 if dstate is None else [
        None if t is None else t.contiguous() for t in dstate]
    _check_state(what, dhs, B, H, dh, {
        f"d{k}": t for k, t in zip("cnmh", dstate) if t is not None})
    dx = torch.empty((B, S, 4 * D), dtype=dhs.dtype, device=dhs.device)
    f32_dx = dhs.dtype == torch.float32
    dpre = (torch.empty((B, S, 4 * D), dtype=torch.float32,
                        device=dhs.device) if params and not f32_dx else None)
    d0 = tuple(torch.empty((B, H, dh), dtype=torch.float32,
                           device=dhs.device) for _ in range(4))
    err = build.library().slstm_bwd_launch(
        saved.data_ptr(), dhs.data_ptr(), r.data_ptr(),
        *(None if t is None else t.data_ptr() for t in dstate),
        dx.data_ptr(), None if dpre is None else dpre.data_ptr(),
        *(t.data_ptr() for t in d0), B, S, H, dh, _DTYPES[dhs.dtype],
        torch.cuda.current_stream(dhs.device).cuda_stream)
    build.check(err, what)
    build.LAUNCHES["slstm_bwd"] += 1
    db = dr = None
    if params:
        from repro_torch.models.layers import full_f32
        dp = (dx if f32_dx else dpre).view(B * S, 4, H, dh)
        hprev = saved[:, :, SAVED - 1].reshape(B * S, H, dh)
        with full_f32():
            dr = torch.einsum("nhd,nghe->ghde", hprev, dp)
        db = dp.sum(0).reshape(4 * D)
    return (dx, db, dr) + d0


class _SLSTM(torch.autograd.Function):
    """The recurrence with its gradient through the kernels (or, on the
    CPU, their plain versions). Returns None for an input that needs no
    gradient."""

    @staticmethod
    def forward(ctx, x_pre, b, r, c, n, m, h):
        ctx.set_materialize_grads(False)
        if x_pre.device.type == "cpu":
            hs, final = _ref.slstm_ref(x_pre, b, r, c, n, m, h)
            ctx.save_for_backward(x_pre, b, r, c, n, m, h)
        else:
            hs, final, saved = _launch(x_pre, b, r, (c, n, m, h), None,
                                       save=True)
            ctx.save_for_backward(saved, r)
        ctx.hs_meta = (hs.shape, hs.dtype, hs.device)
        return (hs,) + final

    @staticmethod
    def backward(ctx, dhs, dc, dn, dm, dh):
        need = ctx.needs_input_grad
        if dhs is None:
            shape, dtype, device = ctx.hs_meta
            dhs = torch.zeros(shape, dtype=dtype, device=device)
        if len(ctx.saved_tensors) == 7:
            grads = _ref.slstm_bwd_ref(*ctx.saved_tensors, dhs, dc, dn, dm,
                                       dh)
        else:
            saved, r = ctx.saved_tensors
            grads = slstm_bwd(saved, r, dhs, (dc, dn, dm, dh),
                              params=need[1] or need[2])
        return tuple(g if need[i] else None for i, g in enumerate(grads))


def slstm(x_pre: torch.Tensor, b: torch.Tensor, r: torch.Tensor,
          c: torch.Tensor, n: torch.Tensor, m: torch.Tensor, h: torch.Tensor,
          *, out: Optional[Sequence[torch.Tensor]] = None):
    """(hs (B, S, D) in x_pre's type, (c, n, m, h) (B, H, dh) f32); the
    state tensors are ``out``'s when given."""
    state = (c, n, m, h)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x_pre, b, r, *state)):
        if out is not None:
            raise ValueError("slstm: out is not taken under autograd")
        hs, *final = _SLSTM.apply(x_pre, b, r, *state)
        return hs, tuple(final)
    if x_pre.device.type == "cpu":
        hs, final = _ref.slstm_ref(x_pre, b, r, *state)
        if out is None:
            return hs, final
        for o, s in zip(out, final):
            o.copy_(s)
        return hs, tuple(out)
    hs, final, _ = _launch(x_pre, b, r, state, out)
    return hs, final
