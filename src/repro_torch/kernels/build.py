"""Build and load the port's CUDA kernels.

Each source in ``csrc/`` compiles with nvcc into an object (all sources at
once, one nvcc process each), and the objects link into one shared library
with a plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c csrc/<name>.cu

The library lands in ``build/repro_torch/<hash>/`` at the repository root
(listed in .gitignore), keyed by a hash of the sources and flags, and is
built at first use: never on import, so the package imports where there is
no nvcc. Nothing is taken from outside the repository but the CUDA toolkit.

Every C entry point returns ``cudaGetLastError()`` after its launch; the
wrappers raise on a nonzero code. ``LAUNCHES`` counts the launches each
wrapper made, so a run can show that its main path went through the
kernels.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("zo_update.cu", "flash_attention.cu", "flash_attention_bwd.cu",
           "rmsnorm.cu", "threefry.cu")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
BASE_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")

LAUNCHES: collections.Counter = collections.Counter()

_LIB = None
_LOCK = threading.Lock()

_VOIDP = ctypes.c_void_p
SIGNATURES = {
    # x, y, n, dtype, seed, coeff*, row_offset, stream
    "zo_update_launch": (_VOIDP, _VOIDP, ctypes.c_longlong, ctypes.c_int,
                         ctypes.c_uint, _VOIDP, ctypes.c_uint, _VOIDP),
    # x, y, n, dtype, seeds*, coeffs*, n_records, row_offset, stream
    "zo_replay_launch": (_VOIDP, _VOIDP, ctypes.c_longlong, ctypes.c_int,
                         _VOIDP, _VOIDP, ctypes.c_int, ctypes.c_uint, _VOIDP),
    # out (4 device uint64), stream: the exhaustive check of the noise factors
    "zo_noise_exhaustive_launch": (_VOIDP, _VOIDP),
    # h0, n, r*, a*, stream: the noise factors at h0 .. h0 + n - 1
    "zo_noise_factors_launch": (ctypes.c_uint, ctypes.c_longlong, _VOIDP,
                                _VOIDP, _VOIDP),
    # q, k, v, o, lse (or null), then the (batch, head, row) strides of q,
    # k, v and o, B, H, Hkv, S, D, dtype, scale, causal, window, stream
    "flash_attention_launch": (_VOIDP,) * 5 + (ctypes.c_longlong,) * 12 + (
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, _VOIDP),
    # q, k, v, o, dout, lse, dq, dk, dv, f32 scratch, then the (batch,
    # head, row) strides of q, k, v, o and dout, B, H, Hkv, S, D, dtype,
    # scale, causal, window, stream
    "flash_attention_bwd_launch": (_VOIDP,) * 10 + (ctypes.c_longlong,) * 15
    + (ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
       ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, _VOIDP),
    # B, H, Hkv, S, D, dtype: the floats of the backward's scratch
    "flash_attention_bwd_scratch_floats": (ctypes.c_int,) * 6,
    # kernel (0 dK/dV, 1 dQ), D: a bf16 backward launch's dynamic shared
    # memory; blocks that fit an SM
    "flash_attention_bwd_smem_bytes": (ctypes.c_int, ctypes.c_int),
    "flash_attention_bwd_blocks_per_sm": (ctypes.c_int, ctypes.c_int),
    # D, dtype: a launch's dynamic shared memory; blocks that fit an SM
    "flash_attention_smem_bytes": (ctypes.c_int, ctypes.c_int),
    "flash_attention_blocks_per_sm": (ctypes.c_int, ctypes.c_int),
    # x, scale, y, rows, D, dtype, eps, stream
    "rmsnorm_launch": (_VOIDP, _VOIDP, _VOIDP, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, _VOIDP),
    # x, scale, dy, dx, dscale, rstd scratch, partial scratch, rows, D,
    # dtype, eps, stream
    "rmsnorm_bwd_launch": (_VOIDP,) * 7 + (ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_float,
                                           _VOIDP),
    # (): the rows a block of the backward's partial sums covers
    "rmsnorm_bwd_chunk_rows": (),
    # xq, sq, yq, rows_q, xk, sk, yk, rows_k, D, dtype, eps, stream
    "rmsnorm_pair_launch": (_VOIDP, _VOIDP, _VOIDP, ctypes.c_longlong) * 2
    + (ctypes.c_int, ctypes.c_int, ctypes.c_float, _VOIDP),
    # x, y, n, dtype, k0, k1, coeff*, scale* (or null), offset, stream
    "threefry_update_launch": (_VOIDP, _VOIDP, ctypes.c_longlong, ctypes.c_int,
                               ctypes.c_uint, ctypes.c_uint, _VOIDP, _VOIDP,
                               ctypes.c_ulonglong, _VOIDP),
    # n, k0, k1, offset, acc*, scratch*, stream
    "threefry_sumsq_launch": (ctypes.c_longlong, ctypes.c_uint, ctypes.c_uint,
                              ctypes.c_ulonglong, _VOIDP, _VOIDP, _VOIDP),
    # (): the 32-bit words of a sumsq launch's scratch
    "threefry_sumsq_scratch_words": (),
    # bits*, z*, n, k0, k1, offset, stream
    "threefry_noise_launch": (_VOIDP, _VOIDP, ctypes.c_longlong, ctypes.c_uint,
                              ctypes.c_uint, ctypes.c_ulonglong, _VOIDP),
    # z* (2^23 floats), stream: the gaussian of every bits >> 9
    "threefry_normal_table_launch": (_VOIDP, _VOIDP),
}
# entry points that return other than a C int
RESTYPES = {"flash_attention_bwd_scratch_floats": ctypes.c_longlong}


def reset_launches() -> None:
    LAUNCHES.clear()


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    found = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the "
            "repro_torch kernels are built from csrc/ on a machine with the "
            "CUDA toolkit")
    return found


def _build_dir() -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(ARCH_FLAGS + BASE_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def _run_all(cmds) -> None:
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed = []
    for cmd, p in zip(cmds, procs):
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def compile_library() -> Path:
    """Compile (if not already built) and return the library's path."""
    out_dir = _build_dir()
    lib = out_dir / "librepro_torch_kernels.so"
    if lib.exists():
        return lib
    nvcc = nvcc_path()
    out_dir.mkdir(parents=True, exist_ok=True)
    objs = [out_dir / (Path(s).stem + ".o") for s in SOURCES]
    _run_all([[nvcc, *ARCH_FLAGS, *BASE_FLAGS, "-c", str(CSRC / s), "-o",
               str(o)]
              for s, o in zip(SOURCES, objs)])
    tmp = out_dir / f"tmp.{os.getpid()}.so"
    _run_all([[nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o",
               str(tmp)]])
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(compile_library()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = RESTYPES.get(name, ctypes.c_int)
            _LIB = lib
        return _LIB


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
