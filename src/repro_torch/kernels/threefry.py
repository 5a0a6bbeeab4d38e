"""Threefry gaussian noise: wrappers of the CUDA kernels in
``csrc/threefry.cu``, the port's counterpart of ``jax.random.normal`` at
one parameter leaf (the noise of ``repro.core.zo`` for dist='gaussian'
and 'sphere').

    threefry_update   y = x + c·z(key)   (or x + c·(z·s), the sphere)
    threefry_sumsq    acc += Σ z(key)²    (the sphere's norm; z not written)
    threefry_noise    bits and z          (tests, the plain comparison)

and ``normal_table_check``, which holds the kernel's float part for every
one of the 2^23 values it can take against the plain version on the card.

``key`` is a raw (2,) uint32 key on the host: the leaf's own key,
fold_in(record key, leaf index). A leaf is read as its flattened elements,
element e drawing the cipher at linear index offset + e, as
jax.random.normal draws it for the whole leaf. A CUDA tensor launches the
kernel (or raises); a CPU tensor takes the plain version in
``kernels/ref.py``. Coefficients and the sphere's scale are read on the
device, so a caller never waits for the device.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.zo_update import _checked, _device_f32

_SCRATCH: Dict[torch.device, torch.Tensor] = {}


def _key_words(key):
    """(k0, k1) of a raw key as Python ints."""
    k = np.asarray(key, np.uint32).reshape(2)
    return int(k[0]), int(k[1])


def threefry_update(x: torch.Tensor, key, coeff, *, scale=None,
                    offset: int = 0) -> torch.Tensor:
    """y = x + coeff·z(key), or x + coeff·(z·scale) when ``scale`` is given
    (a one-element tensor: the sphere's √d/‖z‖). ``coeff`` is a Python
    number or a one-element tensor. The output is a new tensor of x's
    type, rounded once from float32."""
    if x.device.type == "cpu":
        return _ref.threefry_update_ref(x, key, coeff, scale, offset)
    dtype = _checked(x, "threefry_update")
    c = _device_f32(coeff, x.device)
    s = None if scale is None else _device_f32(scale, x.device)
    if c.numel() != 1 or (s is not None and s.numel() != 1):
        raise ValueError("threefry_update: coeff and scale must hold one "
                         "value each")
    k0, k1 = _key_words(key)
    y = torch.empty_like(x)
    err = build.library().threefry_update_launch(
        x.data_ptr(), y.data_ptr(), x.numel(), dtype, k0, k1, c.data_ptr(),
        None if s is None else s.data_ptr(), int(offset),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "threefry_update")
    build.LAUNCHES["threefry"] += 1
    return y


def _scratch(device: torch.device) -> torch.Tensor:
    """The sumsq kernel's counter and partial sums on ``device``: zero when
    made, and each launch leaves it zero."""
    if device not in _SCRATCH:
        words = build.library().threefry_sumsq_scratch_words()
        _SCRATCH[device] = torch.zeros(words, dtype=torch.int32,
                                       device=device)
    return _SCRATCH[device]


def threefry_sumsq(n: int, key, acc: torch.Tensor, *, offset: int = 0
                   ) -> torch.Tensor:
    """acc += Σ z(key)² over a leaf of ``n`` elements; ``acc`` is a
    one-element float32 tensor, added to in place and returned. On the card
    the sum does not depend on the blocks' timing, and sums of one stream
    add in call order."""
    if acc.device.type == "cpu":
        acc += _ref.threefry_sumsq_ref(key, n, offset)
        return acc
    if not acc.is_cuda or acc.dtype != torch.float32 or acc.numel() != 1:
        raise ValueError(f"threefry_sumsq: acc must be one float32 value on "
                         f"a CUDA device, got {tuple(acc.shape)} {acc.dtype} "
                         f"on {acc.device}")
    if n <= 0:
        return acc
    k0, k1 = _key_words(key)
    err = build.library().threefry_sumsq_launch(
        int(n), k0, k1, int(offset), acc.data_ptr(),
        _scratch(acc.device).data_ptr(),
        torch.cuda.current_stream(acc.device).cuda_stream)
    build.check(err, "threefry_sumsq")
    build.LAUNCHES["threefry"] += 1
    return acc


def threefry_noise(n: int, key, device, *, offset: int = 0):
    """(bits, z) for elements offset .. offset + n - 1: (n,) int64 holding
    the cipher's uint32 bits, and (n,) float32 jax.random.normal values."""
    device = torch.device(device)
    if device.type == "cpu":
        bits = _ref.threefry_bits_ref(key, n, offset)
        return bits, _ref.normal_of_bits(bits)
    if device.type != "cuda":
        raise ValueError(f"threefry_noise: expected a CPU or CUDA device, "
                         f"got {device}")
    bits = torch.empty(n, dtype=torch.int32, device=device)
    z = torch.empty(n, dtype=torch.float32, device=device)
    k0, k1 = _key_words(key)
    err = build.library().threefry_noise_launch(
        bits.data_ptr(), z.data_ptr(), int(n), k0, k1, int(offset),
        torch.cuda.current_stream(device).cuda_stream)
    build.check(err, "threefry_noise")
    build.LAUNCHES["threefry"] += 1
    return bits.to(torch.int64) & 0xFFFFFFFF, z


def normal_table_check(device="cuda") -> dict:
    """z for every value m of bits >> 9 (the float part sees nothing else
    of the bits), from the kernel and from the plain version's torch ops on
    the card, compared bit for bit. Returns {"mismatches": n, "first": m or
    None, "max_abs_err": x}. Runs on a CUDA device only: there is no CPU
    version."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"normal_table_check: needs a CUDA device, got "
                         f"{device}")
    got = torch.empty(1 << 23, dtype=torch.float32, device=device)
    err = build.library().threefry_normal_table_launch(
        got.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    build.check(err, "normal_table_check")
    m = torch.arange(1 << 23, dtype=torch.int64, device=device)
    want = _ref.normal_of_bits(m << 9)
    bad = (got.view(torch.int32) != want.view(torch.int32)).nonzero()
    return {"mismatches": int(bad.numel()),
            "first": int(bad[0]) if bad.numel() else None,
            "max_abs_err": float((got - want).abs().max())}
