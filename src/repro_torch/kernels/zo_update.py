"""Counter-noise ZO update / replay: wrappers of the CUDA kernels in
``csrc/zo_update.cu`` (counterpart of ``repro.kernels.zo_update``).

    zo_update_flat   y = x + c·u(seed)            (one record)
    zo_replay_flat   y = x + Σᵢ cᵢ·u(seedᵢ)       (batched seed replay)

and ``noise_exhaustive_check``, which holds the kernels' two Box-Muller
factors bit for bit over all 2^32 hash values against libdevice's precise
logf/sqrtf/cosf compiled beside them, or against the plain version's own
torch ops (on a CUDA device only).

``x`` is any contiguous f32 or bf16 tensor, read as its flattened elements
on the (row, lane) = (offset + e // 1024, e % 1024) counter layout: an
(R, 1024) array is the reference kernels' layout, and any other shape is
the layout the reference reaches by padding to whole rows. A CUDA tensor
launches the kernel (or raises); a CPU tensor takes the plain version in
``kernels/ref.py``. The output is a new tensor; ``x`` is not changed.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as _ref

LANE = _ref.LANE
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# hash values a step of the plain-reference exhaustive check: their int64
# tensor takes 2 GiB, each f32 temporary of the plain version 1 GiB
_CHECK_BLOCK = 1 << 28


def _checked(x: torch.Tensor, what: str) -> int:
    if not x.is_cuda:
        raise ValueError(f"{what}: expected a CPU or CUDA tensor, got "
                         f"{x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {x.dtype} is not float32/bfloat16")
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous")
    return _DTYPES[x.dtype]


def _device_f32(v, device) -> torch.Tensor:
    """A coefficient as a contiguous f32 tensor on ``device``; a Python
    number becomes a device-side fill, never a host round trip."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32).contiguous()
    return torch.full((1,), float(v), dtype=torch.float32, device=device)


def zo_update_flat(x: torch.Tensor, seed: int, coeff, *,
                   offset: int = 0) -> torch.Tensor:
    """y = x + coeff·u(seed). ``seed`` is a host uint32; ``coeff`` a Python
    number or a one-element tensor (read on the device); ``offset`` is the
    ROW offset into the counter space."""
    if x.device.type == "cpu":
        return _ref.zo_update_ref(x, seed, coeff, row_offset=offset)
    dtype = _checked(x, "zo_update_flat")
    c = _device_f32(coeff, x.device)
    if c.numel() != 1:
        raise ValueError(f"zo_update_flat: coeff must hold one value, got "
                         f"{tuple(c.shape)}")
    y = torch.empty_like(x)
    err = build.library().zo_update_launch(
        x.data_ptr(), y.data_ptr(), x.numel(), dtype, int(seed) & 0xFFFFFFFF,
        c.data_ptr(), int(offset) & 0xFFFFFFFF,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "zo_update_flat")
    build.LAUNCHES["zo_update"] += 1
    return y


def zo_replay_flat(x: torch.Tensor, seeds, coeffs: torch.Tensor, *,
                   offset: int = 0) -> torch.Tensor:
    """y = x + Σᵢ coeffs[i]·u(seeds[i]) in one read and one write of x.
    ``seeds``: (N,) host uint32; ``coeffs``: (N,) tensor, read on the
    device. N has no cap."""
    seeds = np.ascontiguousarray(np.asarray(seeds, np.uint32).reshape(-1))
    if x.device.type == "cpu":
        return _ref.zo_replay_ref(x, seeds, coeffs, row_offset=offset)
    dtype = _checked(x, "zo_replay_flat")
    c = _device_f32(coeffs, x.device).reshape(-1)
    if c.numel() != seeds.size:
        raise ValueError(f"zo_replay_flat: {seeds.size} seeds but "
                         f"{c.numel()} coeffs")
    s = torch.from_numpy(seeds.view(np.int32)).to(x.device, non_blocking=True)
    y = torch.empty_like(x)
    err = build.library().zo_replay_launch(
        x.data_ptr(), y.data_ptr(), x.numel(), dtype, s.data_ptr(),
        c.data_ptr(), seeds.size, int(offset) & 0xFFFFFFFF,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "zo_replay_flat")
    build.LAUNCHES["zo_replay"] += 1
    return y


def noise_exhaustive_check(device="cuda", reference: str = "libdevice"
                           ) -> dict:
    """Every hash value h in [0, 2^32) through the kernels' radial factor
    sqrtf(-2·logf(u1(h))) and angular factor cosf(2π·u2(h)), compared bit
    for bit with ``reference``: "libdevice", the precise functions compiled
    beside the kernels (one kernel walks all h), or "plain", the plain
    version's ``ref.radial`` / ``ref.angular`` on the card (torch's log,
    sqrt and cos; _CHECK_BLOCK hash values at a time). Returns
    {"radial": (mismatches, first failing h or None), "angular": (...)}.
    Runs on a CUDA device only: there is no CPU version."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"noise_exhaustive_check: needs a CUDA device, got "
                         f"{device}")
    stream = torch.cuda.current_stream(device).cuda_stream
    if reference == "libdevice":
        out = torch.tensor([0, 0, 1 << 32, 1 << 32], dtype=torch.int64,
                           device=device)
        err = build.library().zo_noise_exhaustive_launch(out.data_ptr(),
                                                         stream)
        build.check(err, "noise_exhaustive_check")
        n_r, n_a, first_r, first_a = out.tolist()
        return {"radial": (n_r, None if first_r == 1 << 32 else first_r),
                "angular": (n_a, None if first_a == 1 << 32 else first_a)}
    if reference != "plain":
        raise ValueError(f"noise_exhaustive_check: reference "
                         f"{reference!r} is not 'libdevice' or 'plain'")
    got = {name: torch.empty(_CHECK_BLOCK, dtype=torch.float32,
                             device=device)
           for name in ("radial", "angular")}
    res = {"radial": (0, None), "angular": (0, None)}
    for h0 in range(0, 1 << 32, _CHECK_BLOCK):
        err = build.library().zo_noise_factors_launch(
            h0, _CHECK_BLOCK, got["radial"].data_ptr(),
            got["angular"].data_ptr(), stream)
        build.check(err, "noise_exhaustive_check")
        h = torch.arange(h0, h0 + _CHECK_BLOCK, dtype=torch.int64,
                         device=device)
        for name, plain in (("radial", _ref.radial),
                            ("angular", _ref.angular)):
            bad = (got[name].view(torch.int32)
                   != plain(h).view(torch.int32)).nonzero()
            count, first = res[name]
            if bad.numel():
                res[name] = (count + bad.numel(),
                             first if first is not None
                             else h0 + int(bad[0]))
    return res
