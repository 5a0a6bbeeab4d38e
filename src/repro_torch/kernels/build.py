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
kernels; the flash forward's and backward's are also counted by head-dim
pair, under ``"flash_attention (d_qk, d_v)"`` and
``"flash_attention_bwd (d_qk, d_v)"``. ``selective_scan_bwd.cu`` includes
``selective_scan.cu`` (its constants and helpers, not its entry points),
which SOURCES holds too, so the hash covers what it compiles;
``slstm_bwd.cu`` includes ``slstm.cu`` the same way.
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
           "rmsnorm.cu", "threefry.cu", "selective_scan.cu",
           "selective_scan_bwd.cu", "slstm.cu", "slstm_bwd.cu")
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
    # k, v and o, B, H, Hkv, S, D (q and k), Dv (v and o), dtype, scale,
    # causal, window, stream
    "flash_attention_launch": (_VOIDP,) * 5 + (ctypes.c_longlong,) * 12 + (
        ctypes.c_int,) * 7 + (ctypes.c_float, ctypes.c_int, ctypes.c_int,
                              _VOIDP),
    # q, k, v, o, dout, lse, dq, dk, dv, f32 scratch, then the (batch,
    # head, row) strides of q, k, v, o and dout, B, H, Hkv, S, D (q and k),
    # Dv (v, o and dout), dtype, scale, causal, window, stream
    "flash_attention_bwd_launch": (_VOIDP,) * 10 + (ctypes.c_longlong,) * 15
    + (ctypes.c_int,) * 7 + (ctypes.c_float, ctypes.c_int, ctypes.c_int,
                             _VOIDP),
    # B, H, Hkv, S, D, Dv, dtype: the floats of the backward's scratch
    "flash_attention_bwd_scratch_floats": (ctypes.c_int,) * 7,
    # kernel (0 dK/dV, 1 dQ), D, Dv: a bf16 backward launch's dynamic
    # shared memory; blocks that fit an SM
    "flash_attention_bwd_smem_bytes": (ctypes.c_int,) * 3,
    "flash_attention_bwd_blocks_per_sm": (ctypes.c_int,) * 3,
    # D, Dv, dtype: a launch's dynamic shared memory; blocks that fit an SM
    "flash_attention_smem_bytes": (ctypes.c_int,) * 3,
    "flash_attention_blocks_per_sm": (ctypes.c_int,) * 3,
    # x, scale, y, rows, D, dtype, eps, stream
    "rmsnorm_launch": (_VOIDP, _VOIDP, _VOIDP, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, _VOIDP),
    # x, scale, dy, dx, dscale, scratch, scratch floats, rows, D, dtype,
    # eps, stream, plan (int[5] or null: nothing launched)
    "rmsnorm_bwd_launch": (_VOIDP,) * 6 + (ctypes.c_longlong,) * 2 + (
        ctypes.c_int, ctypes.c_int, ctypes.c_float, _VOIDP, _VOIDP),
    # xq, sq, dyq, dxq, dsq, rows_q, then k's, scratch, scratch floats, D,
    # dtype, eps, stream, plan
    "rmsnorm_pair_bwd_launch": ((_VOIDP,) * 5 + (ctypes.c_longlong,)) * 2
    + (_VOIDP, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
       _VOIDP, _VOIDP),
    # rows, D, pair: the floats of a backward launch's scratch
    "rmsnorm_bwd_scratch_floats": (ctypes.c_longlong, ctypes.c_int,
                                   ctypes.c_int),
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
    # x, dt, z, Bc, Cc, A_log, D, dt_bias, h0, y, h_last, h_chunks (or
    # null), the row strides of z, Bc and Cc, B, S, d_in, N, dtype, stream
    "selective_scan_launch": (_VOIDP,) * 12 + (ctypes.c_longlong,) * 3 + (
        ctypes.c_int,) * 5 + (_VOIDP,),
    # x, dt, z, Bc, Cc, A_log, D, dt_bias, h_chunks, dy, dh_last (or null),
    # dx, ddt, dz, dBc, dCc, dA_log, dD, ddt_bias, dh0, scratch, the row
    # strides of z, Bc and Cc, B, S, d_in, N, dtype, stream
    "selective_scan_bwd_launch": (_VOIDP,) * 21 + (ctypes.c_longlong,) * 3
    + (ctypes.c_int,) * 5 + (_VOIDP,),
    # B, S, d_in, N: the floats of a backward launch's scratch
    "selective_scan_bwd_scratch_floats": (ctypes.c_int,) * 4,
    # N, dtype, plan (int[10]): the backward instance's lanes, channels a
    # block, tokens a sub-chunk, threads, registers, dynamic shared memory,
    # blocks an SM, blocks a cluster, block barriers a chunk, clusters the
    # card holds at once
    "selective_scan_bwd_plan": (ctypes.c_int, ctypes.c_int, _VOIDP),
    # N, dtype, plan (int[7]): the instance's lanes, channels a block,
    # tokens a chunk, threads, registers, shared memory, blocks an SM
    "selective_scan_plan": (ctypes.c_int, ctypes.c_int, _VOIDP),
    # x_pre, b, r, c0, n0, m0, h0, hs, c, n, m, h (out), B, S, H, dh,
    # dtype, stream
    "slstm_launch": (_VOIDP,) * 12 + (ctypes.c_int,) * 5 + (_VOIDP,),
    # the same with the backward's record after h: saved (B, S, 8, D) f32
    "slstm_save_launch": (_VOIDP,) * 13 + (ctypes.c_int,) * 5 + (_VOIDP,),
    # saved, dhs, r, dc, dn, dm, dh (the final state's cotangents, each or
    # null), dx, dpre (or null), dc0, dn0, dm0, dh0 (out), B, S, H, dh,
    # dtype, stream
    "slstm_bwd_launch": (_VOIDP,) * 13 + (ctypes.c_int,) * 5 + (_VOIDP,),
    # dh, dtype, plan (int[16]): the backward's instance of a group of
    # batch rows a cluster (B > 1): blocks a cluster, columns a block,
    # threads, rows of r a warp, registers, dynamic shared memory, blocks
    # an SM, clusters the card holds at once; then the one-row instance's
    "slstm_bwd_plan": (ctypes.c_int, ctypes.c_int, _VOIDP),
    # dh, dtype, plan (int[20]): the instance of a group of batch rows a
    # cluster (B > 1): blocks a cluster, columns a block, threads, splits
    # of the sum over d, registers, dynamic shared memory, blocks an SM,
    # clusters the card holds at once; batch rows a cluster, slots of the
    # x_pre ring, mbarriers a buffer, outputs a thread; then the one-row
    # instance's (B = 1) first eight fields
    "slstm_plan": (ctypes.c_int, ctypes.c_int, _VOIDP),
}
# entry points that return other than a C int
RESTYPES = {"flash_attention_bwd_scratch_floats": ctypes.c_longlong,
            "rmsnorm_bwd_scratch_floats": ctypes.c_longlong,
            "selective_scan_bwd_scratch_floats": ctypes.c_longlong}


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
