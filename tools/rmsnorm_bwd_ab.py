#!/usr/bin/env python3
"""Time the RMSNorm backward of an older ``rmsnorm.cu`` against the committed
one, in turns, on one CUDA card.

    git show <commit>:src/repro_torch/kernels/csrc/rmsnorm.cu \\
        > build/old_rmsnorm.cu
    python3 tools/rmsnorm_bwd_ab.py build/old_rmsnorm.cu

Both sources are built with nvcc into ``build/repro_torch/norm_bwd_ab/``
and called through their own ``rmsnorm_bwd_launch``: the three-launch
backward (a source with ``rmsnorm_bwd_chunk_rows``: dscale zero-filled
first, an rstd and a chunk-partial scratch, as its wrapper called it) or
the one-pass one (a scratch of ``rmsnorm_bwd_scratch_floats``; the qk
pair through ``rmsnorm_pair_bwd_launch``, where the older source makes two
calls). At the five bf16 shapes of ``chip_smoke.py``'s
``phase_rmsnorm_bwd`` (qwen3-14b's block norm, its qk-norm pair, MLA's
kv_norm and q_norm, and (1,4096,5120)) it prints whether each source's
dx and dscale lie within chip_smoke.py's tolerance of the plain version,
then each one's device time per call (torch.profiler, cycling through
copies of the inputs past the 50 MB L2, as chip_smoke.py does) in the
order old, new, new, old, twice, and the card's name and power limit.
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

# (name, q's shape, k's shape or None)
SHAPES = (("block norm", (1, 512, 5120), None),
          ("qk-norm pair", (1, 512, 40, 128), (1, 512, 8, 128)),
          ("MLA kv_norm", (1, 512, 512), None),
          ("MLA q_norm", (1, 512, 1536), None),
          ("block norm", (1, 4096, 5120), None))
EPS = 1e-5
BF16 = 1                                     # the C entry points' dtype


def start_build(name: str, source: Path, out_dir: Path, ptxas: bool = False):
    """nvcc of ``source`` into out_dir/<name>.so, started; (path, process)."""
    so = out_dir / f"{name}.so"
    flags = ["-Xptxas", "-v"] if ptxas else []
    return so, subprocess.Popen(
        [build.nvcc_path(), *build.ARCH_FLAGS, *build.BASE_FLAGS, *flags,
         "-shared", str(source), "-o", str(so)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


class Norm:
    """A built rmsnorm.cu's backward, called as its own wrapper would."""

    def __init__(self, so: Path, source: str):
        self.lib = lib = ctypes.CDLL(str(so))
        self.three = "rmsnorm_bwd_chunk_rows" in source
        v, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_float)
        if self.three:
            lib.rmsnorm_bwd_launch.argtypes = (v,) * 7 + (ll, i, i, f, v)
            lib.rmsnorm_bwd_chunk_rows.argtypes = ()
            return
        for name in ("rmsnorm_bwd_launch", "rmsnorm_pair_bwd_launch",
                     "rmsnorm_bwd_scratch_floats"):
            fn = getattr(lib, name)
            fn.argtypes = build.SIGNATURES[name]
            fn.restype = build.RESTYPES.get(name, ctypes.c_int)

    def single(self, x, s, dy):
        D = x.shape[-1]
        rows = x.numel() // D
        dx = torch.empty_like(x)
        stream = torch.cuda.current_stream().cuda_stream
        if self.three:
            ds = torch.zeros(D, dtype=torch.float32, device=x.device)
            chunks = -(-rows // self.lib.rmsnorm_bwd_chunk_rows())
            rstd = torch.empty(rows, dtype=torch.float32, device=x.device)
            part = torch.empty(chunks, D, dtype=torch.float32,
                               device=x.device)
            err = self.lib.rmsnorm_bwd_launch(
                x.data_ptr(), s.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                ds.data_ptr(), rstd.data_ptr(), part.data_ptr(), rows, D,
                BF16, EPS, stream)
        else:
            ds = torch.empty(D, dtype=torch.float32, device=x.device)
            floats = self.lib.rmsnorm_bwd_scratch_floats(rows, D, 0)
            scratch = torch.empty(floats, dtype=torch.float32,
                                  device=x.device)
            err = self.lib.rmsnorm_bwd_launch(
                x.data_ptr(), s.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                ds.data_ptr(), scratch.data_ptr(), floats, rows, D, BF16,
                EPS, stream, None)
        build.check(err, "rmsnorm bwd A/B")
        return dx, ds

    def pair(self, xq, sq, dyq, xk, sk, dyk):
        if self.three:
            return (*self.single(xq, sq, dyq), *self.single(xk, sk, dyk))
        D = xq.shape[-1]
        rq, rk = xq.numel() // D, xk.numel() // D
        dxq, dxk = torch.empty_like(xq), torch.empty_like(xk)
        dsq, dsk = (torch.empty(D, dtype=torch.float32, device=xq.device)
                    for _ in range(2))
        floats = self.lib.rmsnorm_bwd_scratch_floats(rq + rk, D, 1)
        scratch = torch.empty(floats, dtype=torch.float32, device=xq.device)
        err = self.lib.rmsnorm_pair_bwd_launch(
            xq.data_ptr(), sq.data_ptr(), dyq.data_ptr(), dxq.data_ptr(),
            dsq.data_ptr(), rq, xk.data_ptr(), sk.data_ptr(), dyk.data_ptr(),
            dxk.data_ptr(), dsk.data_ptr(), rk, scratch.data_ptr(), floats,
            D, BF16, EPS, torch.cuda.current_stream().cuda_stream, None)
        build.check(err, "rmsnorm pair bwd A/B")
        return dxq, dsq, dxk, dsk


def inputs(gen, q_shape, k_shape):
    """bf16 (x, scale, dy) of q, and of k for the pair, from ``gen``."""
    out = []
    for shape in (q_shape, k_shape):
        if shape is None:
            continue
        D = shape[-1]
        x = (torch.randn(shape, generator=gen, device="cuda") * 3.0).to(
            torch.bfloat16)
        dy = torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        s = 1.0 + 0.5 * torch.randn(D, generator=gen, device="cuda")
        out.append((x, s, dy))
    return out


def runner(norm: Norm, tensors):
    """A call of ``norm`` on one set of inputs (its tensors as in inputs)."""
    if len(tensors) == 1:
        return lambda t: norm.single(*t[0])
    return lambda t: norm.pair(*t[0], *t[1])


def agrees(norm: Norm, tensors) -> str:
    """Whether dx and dscale lie within chip_smoke.check_grad of the plain
    version (2^-7·max|dx| in bf16, 1e-5·max|dscale|)."""
    got = runner(norm, tensors)(tensors)
    want = [w for x, s, dy in tensors for w in ref.rmsnorm_bwd_ref(x, s, dy)]
    try:
        err = max(chip_smoke.check_grad(f"grad {i}", g, w)
                  for i, (g, w) in enumerate(zip(got, want)))
    except chip_smoke.SmokeFailure as e:
        return f"OUTSIDE the tolerance ({e})"
    return f"within the tolerance (max|Δ| {err:.3e})"


def copies(tensors):
    """The inputs and enough copies of them to exceed L2."""
    nbytes = sum(3 * x.numel() * x.element_size() + 8 * x.shape[-1]
                 for x, _, _ in tensors)
    return [tensors] + [[(x.clone(), s, dy.clone()) for x, s, dy in tensors]
                        for _ in range(chip_smoke.L2_BYTES // nbytes + 1)]


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("rmsnorm_bwd_ab: no CUDA device available", file=sys.stderr)
        return 1
    out_dir = build.BUILD_ROOT / "norm_bwd_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {"old": Path(sys.argv[1]), "new": build.CSRC / "rmsnorm.cu"}
    started = {n: start_build(n, p, out_dir) for n, p in sources.items()}
    norms = {}
    for n, (so, p) in started.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"rmsnorm_bwd_ab: {n} did not build:\n{log}")
        norms[n] = Norm(so, sources[n].read_text())
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(8)
    for name, q_shape, k_shape in SHAPES:
        tensors = inputs(gen, q_shape, k_shape)
        what = f"{name} {q_shape}" + (f" + {k_shape}" if k_shape else "")
        for n, norm in norms.items():
            print(f"{what} {n}: {agrees(norm, tensors)}")
        sets = copies(tensors)
        ms = {n: [] for n in norms}
        for n in ("old", "new", "new", "old") * 2:
            ms[n].append(chip_smoke.device_ms(runner(norms[n], tensors),
                                              sets, 100))
        print(f"{what}: old " + " ".join(f"{x:.4f}" for x in ms["old"])
              + " ms; new " + " ".join(f"{x:.4f}" for x in ms["new"])
              + " ms" + (" (old: two calls)" if k_shape else ""))
        del sets
    return 0


if __name__ == "__main__":
    sys.exit(main())
