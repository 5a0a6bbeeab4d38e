#!/usr/bin/env python3
"""Time variants of the bf16 flash-attention backward on one CUDA card.

    python3 tools/flash_bwd_sweep.py

Each variant is the committed
``src/repro_torch/kernels/csrc/flash_attention_bwd.cu`` with a few lines
changed (the edits are listed below, each as the text it replaces), built
with nvcc into ``build/repro_torch/bwd_sweep/`` and called through the same
C entry points as the package's kernels. For every variant and shape the
script prints whether its gradients meet chip_smoke.py's check (each
within 2^-7·max|g| of the plain version), the registers and spills ptxas
gave its bf16 dK/dV and dQ kernels at d = 128, and its device time per
call under torch.profiler, cycling through copies of the inputs past the
50 MB L2 as chip_smoke.py does, launch by launch, with the autograd
backward of ``scaled_dot_product_attention`` timed beside it. The variants
are measurements of the design's choices, not alternatives the package
loads.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

SOURCE = "flash_attention_bwd.cu"
# Δ with four rows a thread group (eight 16-byte loads in flight a thread)
DELTA_ONE_ROW = """  const long long r =
      static_cast<long long>(blockIdx.x) * GPB + threadIdx.x / TPR;
  uint4 ov = make_uint4(0u, 0u, 0u, 0u), dv = ov;
  if (r < rows) {
    const int i = static_cast<int>(r % S);
    const long long bh = r / S;
    const int b = static_cast<int>(bh / H);
    const int h = static_cast<int>(bh % H);
    ov = *reinterpret_cast<const uint4*>(o + b * so.b + h * so.h + i * so.r +
                                         ch * 8);
    dv = *reinterpret_cast<const uint4*>(dout + b * sd.b + h * sd.h +
                                         i * sd.r + ch * 8);
  }
  const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
  const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    acc = fmaf(__low2float(d2[j]), __low2float(o2[j]), acc);
    acc = fmaf(__high2float(d2[j]), __high2float(o2[j]), acc);
  }
  // the TPR threads of a row are neighbouring lanes of one warp
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (r < rows && ch == 0) delta[r] = acc;
"""
DELTA_FOUR_ROWS = """  constexpr int R = 4;
  uint4 ov[R], dv[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const long long r = (static_cast<long long>(blockIdx.x) * R + k) * GPB +
                        threadIdx.x / TPR;
    ov[k] = dv[k] = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) {
      const int i = static_cast<int>(r % S);
      const long long bh = r / S;
      const int b = static_cast<int>(bh / H);
      const int h = static_cast<int>(bh % H);
      ov[k] = *reinterpret_cast<const uint4*>(o + b * so.b + h * so.h +
                                              i * so.r + ch * 8);
      dv[k] = *reinterpret_cast<const uint4*>(dout + b * sd.b + h * sd.h +
                                              i * sd.r + ch * 8);
    }
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const long long r = (static_cast<long long>(blockIdx.x) * R + k) * GPB +
                        threadIdx.x / TPR;
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov[k]);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv[k]);
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc = fmaf(__low2float(d2[j]), __low2float(o2[j]), acc);
      acc = fmaf(__high2float(d2[j]), __high2float(o2[j]), acc);
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (r < rows && ch == 0) delta[r] = acc;
  }
"""
VARIANTS = {
    "committed": [],
    # dK/dV: 16 query columns a step at d = 128 (fewer live scores, twice
    # the K and V fragment reads)
    "dK/dV 16 columns a step": [("constexpr int QN = DQK == 64 ? 64 : 32;",
                                 "constexpr int QN = DQK == 64 ? 64 : 16;")],
    # dQ: 64 keys a step at d = 128
    "dQ 64 keys a step": [
        ("constexpr int KN = DQK == 64 ? 64 : DQK == DV ? 32 : 16;",
         "constexpr int KN = DQK == 64 ? 64 : DQK == DV ? 64 : 16;")],
    # dK/dV: one block per (kv head, key tile) walking the group's heads in
    # turn, no partials and no sum launch (64 blocks at 8 kv heads)
    "no head split": [
        ("  const int b = blockIdx.x / H;\n"
         "  const int h = blockIdx.x % H;  // the block's query head\n"
         "  const int kvh = h / G;\n",
         "  const int b = blockIdx.x / Hkv;\n"
         "  const int kvh = blockIdx.x % Hkv;\n"
         "  const int h = kvh * G;  // (no partials)\n"),
        ("  const int n_it = (q_end - q_begin + kTile - 1) / kTile;\n",
         "  const int n_qt = (q_end - q_begin + kTile - 1) / kTile;\n"
         "  const int n_it = G * n_qt;\n"),
        ("  auto load_q = [&](int it, int st) {\n"
         "    const int q_lo = q_begin + it * kTile;\n",
         "  auto load_q = [&](int it, int st) {\n"
         "    const int h = kvh * G + it / n_qt;\n"
         "    const int q_lo = q_begin + it % n_qt * kTile;\n"),
        ("    const int q_lo = q_begin + it * kTile;\n"
         "    const float* lse_t",
         "    const int q_lo = q_begin + it % n_qt * kTile;\n"
         "    const float* lse_t"),
        ("  if (G == 1) {\n    // dK·scale and dV in bf16",
         "  if (true) {\n    // dK·scale and dV in bf16"),
        ("      dim3(B * H, tiles), kTcThreads * dkdv_roles<DQK, DV>()",
         "      dim3(B * Hkv, tiles), kTcThreads * dkdv_roles<DQK, DV>()"),
        ("  if (G > 1) {\n    const long long cells",
         "  if (false) {\n    const long long cells")],
    # causal tiles heaviest first throughout, not paired (tile_rank)
    "heaviest first, unpaired": [(
        "  const int half = (T + 1) / 2;\n"
        "  return y < half ? y : T - 1 - (y - half);",
        "  return y;")],
    "Δ four rows a group": [
        (DELTA_ONE_ROW, DELTA_FOUR_ROWS),
        ("  constexpr int rpb = 256 / (DV / 8);",
         "  constexpr int rpb = 4 * 256 / (DV / 8);")],
    # dQ's dS cast to bf16 once (one MMA a step)
    "dQ's dS one cast": [
        ("a_operand<true>(s[2 * j], s[2 * j + 1], dh, dlo);",
         "a_operand<false>(s[2 * j], s[2 * j + 1], dh, dlo);"),
        ("mma_a<true>(acc[", "mma_a<false>(acc[")],
    # P and both dS as bf16 hi + lo A operands (two MMAs a product)
    "P, dS hi + lo": [("acc_chunks<false,", "acc_chunks<true,")],
}
SHAPES = [("path 5 (paper-opt-1.3b)", (1, 32, 32, 512, 64)),
          ("qwen3-14b, GQA 40/8", (1, 40, 8, 512, 128))]
TC = re.compile(r"(flash_bwd_(?:dkdv|dq)_bf16_kernel)ILi128ELi128E")


def variant_source(src: str, edits) -> str:
    """``src`` with each (old, new) edit applied; stops if one does not
    apply."""
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"edit does not apply:\n{old}")
        src = src.replace(old, new)
    return src


def ptxas_summary(log: str) -> str:
    """'dkdv R regs/S spill, dq R regs/S spill' at d = 128 from -Xptxas -v."""
    out, kernel = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            m = TC.search(line)
            kernel = m.group(1) if m else None
            continue
        if kernel is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores", line)
        used = re.search(r"Used (\d+) registers", line)
        if spill:
            out.setdefault(kernel, {})["spill"] = spill.group(1)
        if used:
            out.setdefault(kernel, {})["regs"] = used.group(1)
    return ", ".join(
        f"{k.split('_')[2]} {v.get('regs')} regs/{v.get('spill')} B spill"
        for k, v in sorted(out.items()))


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_sweep: no CUDA device available", file=sys.stderr)
        return 1
    src = (build.CSRC / SOURCE).read_text()
    out_dir = build.BUILD_ROOT / "bwd_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        cu = out_dir / f"variant{i}.cu"
        cu.write_text(variant_source(src, edits))
        procs[name] = (cu.with_suffix(".so"), subprocess.Popen(
            [build.nvcc_path(), *build.ARCH_FLAGS, *build.BASE_FLAGS,
             "-Xptxas", "-v", "-shared", str(cu), "-o",
             str(cu.with_suffix(".so"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, regs = {}, {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"flash_bwd_sweep: {name} did not build:\n{log}")
        regs[name] = ptxas_summary(log)
        lib = ctypes.CDLL(str(so))
        for fn_name in ("flash_attention_bwd_launch",
                        "flash_attention_bwd_scratch_floats"):
            fn = getattr(lib, fn_name)
            fn.argtypes = build.SIGNATURES[fn_name]
            fn.restype = build.RESTYPES.get(fn_name, ctypes.c_int)
        libs[name] = lib
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())

    def call(lib, q, k, v, o, lse, do):
        B, H, S, d = q.shape
        Hkv = k.shape[1]
        dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device)
                      for t in (q, k, v))
        scratch = torch.empty(lib.flash_attention_bwd_scratch_floats(
            B, H, Hkv, S, d, d, 1), dtype=torch.float32, device=q.device)
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), scratch.data_ptr(), *fa._strides(q),
            *fa._strides(k), *fa._strides(v), *fa._strides(o),
            *fa._strides(do), B, H, Hkv, S, d, d, 1, d ** -0.5, 1, 0,
            torch.cuda.current_stream().cuda_stream)
        build.check(err, "flash bwd sweep")
        return dq, dk, dv

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    for shape_name, (B, H, Hkv, S, d) in SHAPES:
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(
                torch.bfloat16)
        q, k = rnd(B, H, S, d), rnd(B, Hkv, S, d)
        v = rnd(B, S, Hkv, d).transpose(1, 2)
        do = rnd(B, S, H, d).transpose(1, 2)
        o, lse = ref.flash_attention_ref(q, k, v, True, 0, return_lse=True)
        want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, True, 0)
        nbytes = 2 * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel()
        sets = [(q, k, v, o, lse, do)] + [
            tuple(t.clone() for t in (q, k, v, o, lse, do))
            for _ in range(chip_smoke.L2_BYTES // nbytes + 1)]
        graphs = []
        for t in sets:
            qkv = [a.detach().contiguous().requires_grad_(True)
                   for a in t[:3]]
            graphs.append((F.scaled_dot_product_attention(
                *qkv, is_causal=True, enable_gqa=H != Hkv), qkv, t[5]))
        lib_ms = chip_smoke.device_ms(lambda g: torch.autograd.grad(
            g[0], g[1], g[2], retain_graph=True), graphs, 20)
        del graphs
        print(f"{shape_name} ({B},{H},{S},{d}) Hkv {Hkv} causal: autograd "
              f"backward of scaled_dot_product_attention {lib_ms * 1e3:.1f} "
              f"us")
        # two passes over the variants, the second in the opposite order
        ms = {name: [] for name in libs}
        per = {name: {} for name in libs}
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                ms[name].append(chip_smoke.device_ms(
                    lambda t: call(libs[name], *t), sets, 20,
                    by_kernel=per[name]))
        for name, lib in libs.items():
            got = call(lib, q, k, v, o, lse, do)
            try:
                for g, a, b in zip(("dq", "dk", "dv"), got, want):
                    chip_smoke.check_grad(f"{name} {g}", a, b)
                verdict = "within 2^-7·max|g|"
            except chip_smoke.SmokeFailure as e:
                verdict = f"OUTSIDE: {e}"
            a, b = ms[name]
            launches = ", ".join(
                f"{chip_smoke.PORT_KERNEL.search(key).group(0)} "
                f"{t * 1e3:.1f}" for key, t in sorted(
                    per[name].items(), key=lambda kt: -kt[1])
                if chip_smoke.PORT_KERNEL.search(key))
            print(f"  {name:24s} {a * 1e3:6.1f} / {b * 1e3:6.1f} us "
                  f"({min(a, b) / lib_ms:.2f}x the library) {verdict}; "
                  f"{regs[name]}; per launch (us, second pass): {launches}")
        del sets
    return 0


if __name__ == "__main__":
    sys.exit(main())
