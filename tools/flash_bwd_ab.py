#!/usr/bin/env python3
"""Time the bf16 flash-attention backward of an older source against the
committed one, in turns, on one CUDA card.

    git show <commit>:src/repro_torch/kernels/csrc/flash_attention_bwd.cu \\
        > build/old_bwd.cu
    python3 tools/flash_bwd_ab.py build/old_bwd.cu

Both sources are built with nvcc into ``build/repro_torch/bwd_ab/`` and
called through their own ``flash_attention_bwd_launch`` (an older source
that takes one head dim D, or the committed one that takes the pair). At
the GQA shapes of ``chip_smoke.py``'s backward phase (path 5's d = 64 and
qwen3-14b's d = 128 with 8 kv heads, causal, and with a window of 128) it
prints whether the two give bit-equal gradients, then the device time
per call of each (torch.profiler, cycling through copies of the inputs
past the 50 MB L2, as chip_smoke.py does) in the order old, new, new, old,
twice, and each one's kernels' time a launch.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

SHAPES = (((1, 32, 32, 512, 64), True, 0), ((1, 40, 8, 512, 128), True, 0),
          ((1, 40, 8, 512, 128), True, 128))


def load(name: str, source: Path, out_dir: Path):
    """The library built from ``source`` and the number of its head-dim
    arguments (1: D; 2: D and Dv)."""
    so = out_dir / f"{name}.so"
    subprocess.run([build.nvcc_path(), *build.ARCH_FLAGS, *build.BASE_FLAGS,
                    "-shared", str(source), "-o", str(so)], check=True)
    dims = 2 if "int D, int Dv, int dtype" in source.read_text() else 1
    lib = ctypes.CDLL(str(so))
    v = ctypes.c_void_p
    lib.flash_attention_bwd_scratch_floats.argtypes = (ctypes.c_int,) * (
        5 + dims)
    lib.flash_attention_bwd_scratch_floats.restype = ctypes.c_longlong
    lib.flash_attention_bwd_launch.argtypes = (v,) * 10 + (
        ctypes.c_longlong,) * 15 + (ctypes.c_int,) * (5 + dims) + (
        ctypes.c_float, ctypes.c_int, ctypes.c_int, v)
    return lib, dims


def call(lib, dims, q, k, v, o, lse, do, causal, window):
    B, H, S, d = q.shape
    Hkv = k.shape[1]
    hd = (d,) * dims
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device)
                  for t in (q, k, v))
    scratch = torch.empty(lib.flash_attention_bwd_scratch_floats(
        B, H, Hkv, S, *hd, 1), dtype=torch.float32, device=q.device)
    err = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), scratch.data_ptr(), *fa._strides(q), *fa._strides(k),
        *fa._strides(v), *fa._strides(o), *fa._strides(do), B, H, Hkv, S,
        *hd, 1, d ** -0.5, int(causal), window,
        torch.cuda.current_stream().cuda_stream)
    build.check(err, "flash bwd A/B")
    return dq, dk, dv


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("flash_bwd_ab: no CUDA device available", file=sys.stderr)
        return 1
    out_dir = build.BUILD_ROOT / "bwd_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {"old": load("old", Path(sys.argv[1]), out_dir),
            "new": load("new", build.CSRC / "flash_attention_bwd.cu",
                        out_dir)}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    for (B, H, Hkv, S, d), causal, window in SHAPES:
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(
                torch.bfloat16)
        q, k = rnd(B, H, S, d), rnd(B, Hkv, S, d)
        v = rnd(B, S, Hkv, d).transpose(1, 2)
        do = rnd(B, S, H, d).transpose(1, 2)
        o, lse = ref.flash_attention_ref(q, k, v, causal, window,
                                         return_lse=True)
        grads = {n: call(*libs[n], q, k, v, o, lse, do, causal, window)
                 for n in libs}
        same = all(torch.equal(a, b) for a, b in zip(*grads.values()))
        nbytes = 2 * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel()
        sets = [(q, k, v, o, lse, do)] + [
            tuple(t.clone() for t in (q, k, v, o, lse, do))
            for _ in range(chip_smoke.L2_BYTES // nbytes + 1)]
        ms = {n: [] for n in libs}
        per = {n: {} for n in libs}
        for n in ("old", "new", "new", "old") * 2:
            ms[n].append(chip_smoke.device_ms(
                lambda t: call(*libs[n], *t, causal, window), sets, 40,
                by_kernel=per[n]))
        print(f"({B},{H},{S},{d}) Hkv {Hkv} causal {causal} window "
              f"{window}: bit-equal {same}; old "
              + " ".join(f"{x:.4f}" for x in ms["old"]) + " ms; new "
              + " ".join(f"{x:.4f}" for x in ms["new"]) + " ms")
        for n in libs:
            print(f"  {n} per launch: " + ", ".join(
                f"{chip_smoke.PORT_KERNEL.search(key).group(0)} "
                f"{t * 1e3:.2f} us" for key, t in sorted(
                    per[n].items(), key=lambda kt: -kt[1])
                if chip_smoke.PORT_KERNEL.search(key)))
        del sets
    return 0


if __name__ == "__main__":
    sys.exit(main())
