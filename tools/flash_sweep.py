#!/usr/bin/env python3
"""Time variants of the bf16 flash-attention kernel on one CUDA card.

    python3 tools/flash_sweep.py

Each variant is the committed ``src/repro_torch/kernels/csrc/flash_attention.cu``
with a few lines changed (the edits are listed below, each as the text it
replaces), built with nvcc into ``build/repro_torch/sweep/`` and called
through the same C entry point as the package's kernel. For every variant
and shape the script prints max |Δ| against the plain version (and whether
it meets chip_smoke.py's one-bf16-ulp check), the registers ptxas gave it,
and its device time per call under torch.profiler, cycling through copies
of (q, k, v) past the 50 MB L2 as chip_smoke.py does, with
``scaled_dot_product_attention`` timed beside it. The variants are
measurements of the design's choices, not alternatives the package loads.
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

SOURCE = "flash_attention.cu"
LOOP_TOP = """    const int next = (t + 1) & 1;  // the stage of tile t + 1
    cp_async_wait<1>();  // K of tile t (V of tile t may still be in flight)
    __syncthreads();     // ... and every warp is done with tile t - 1's K
    if (t + 1 < n_tiles) {
      tc_load<D, kTcBK>(Ks + next * kTcBK * LD, kp, L.k[2], k_lo + kTcBK, S);
      cp_async_commit();
    }
"""
V_WAIT = """    // V of tile t; then every warp is done with tile t - 1's V
    if (t + 1 < n_tiles)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < n_tiles) {
      tc_load<D, kTcBK>(Vs + next * kTcBK * LD, vp, L.v[2], k_lo + kTcBK, S);
      cp_async_commit();
    }
"""
EPILOGUE_MUL = ("acc[n][0] * inv[0], acc[n][1] * inv[0]",
                "acc[n][2] * inv[1], acc[n][3] * inv[1]")
VARIANTS = {
    "committed": [],
    # P·V with P cast to bf16 once: one MMA per step instead of hi + lo
    "P in bf16 once": [
        ("        mma_bf16(acc[2 * dp], pl, vb[0], vb[1]);\n", ""),
        ("        mma_bf16(acc[2 * dp + 1], pl, vb[2], vb[3]);\n", "")],
    # K and V of a tile in one cp.async group, waited for together
    "K and V in one group": [
        ("  cp_async_commit();\n  tc_load<D, kTcBK>(Vs, vp, L.v[2], k_begin, S);",
         "  tc_load<D, kTcBK>(Vs, vp, L.v[2], k_begin, S);"),
        (LOOP_TOP, """    const int next = (t + 1) & 1;
    if (t + 1 < n_tiles) {
      tc_load<D, kTcBK>(Ks + next * kTcBK * LD, kp, L.k[2], k_lo + kTcBK, S);
      tc_load<D, kTcBK>(Vs + next * kTcBK * LD, vp, L.v[2], k_lo + kTcBK, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
"""),
        (V_WAIT, ""),
        ("      }\n    }\n  }\n\n  // out = acc / max(l, 1e-30)",
         "      }\n    }\n    __syncthreads();\n  }\n\n  // out = acc / max(l, 1e-30)")],
    # 32-row query tiles: blocks of 2 warps
    "32-row query tiles": [("constexpr int kWarps = 4;", "constexpr int kWarps = 2;")],
    # 128-row query tiles: blocks of 8 warps, one block per SM
    "128-row query tiles": [
        ("constexpr int kWarps = 4;", "constexpr int kWarps = 8;"),
        ("__launch_bounds__(kTcThreads, 2)", "__launch_bounds__(kTcThreads, 1)")],
    # 32-row kv tiles
    "32-row kv tiles": [("constexpr int kTcBK = 64;", "constexpr int kTcBK = 32;")],
    # out = acc / l element by element
    "division epilogue": [
        (EPILOGUE_MUL[0], "acc[n][0] / fmaxf(l_i[0], 1e-30f), "
                          "acc[n][1] / fmaxf(l_i[0], 1e-30f)"),
        (EPILOGUE_MUL[1], "acc[n][2] / fmaxf(l_i[1], 1e-30f), "
                          "acc[n][3] / fmaxf(l_i[1], 1e-30f)")],
    # the softmax's exponentials by ex2.approx.ftz instead of exp2f
    "ex2.approx": [
        ("__device__ __forceinline__ uint32_t as_u32(",
         "__device__ __forceinline__ float ex2a(float x) {\n  float y;\n"
         "  asm(\"ex2.approx.ftz.f32 %0, %1;\" : \"=f\"(y) : \"f\"(x));\n"
         "  return y;\n}\n\n__device__ __forceinline__ uint32_t as_u32("),
        ("alpha[r] = exp2f(", "alpha[r] = ex2a("),
        ("const float p = exp2f(", "const float p = ex2a(")],
}
QF_IN_SMEM = [
    ("  uint32_t qf[KD][4];\n", ""),
    ("""    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const int r = 16 * warp + (lane % 8) + ((lane / 8) % 2) * 8;
        ldmatrix_x4(qf[kk], smem_addr(Qs + r * LD + kk * 16 +
                                      (lane / 16) * 8));
      }
    }
""", ""),
    ("""    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {""", """    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qk[4];
      ldmatrix_x4(qk, smem_addr(Qs + (16 * warp + (lane % 8) +
                                      ((lane / 8) % 2) * 8) * LD +
                                kk * 16 + (lane / 16) * 8));
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {"""),
    ("mma_bf16(s[2 * np], qf[kk], kb[0], kb[1]);",
     "mma_bf16(s[2 * np], qk, kb[0], kb[1]);"),
    ("mma_bf16(s[2 * np + 1], qf[kk], kb[2], kb[3]);",
     "mma_bf16(s[2 * np + 1], qk, kb[2], kb[3]);")]
PV_LOOP = """#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vb[4];
        const int r = j * 16 + ((lane / 8) % 2) * 8 + (lane % 8);
        ldmatrix_x4_trans(vb, smem_addr(Vt + r * LD + dp * 16 +
                                        (lane / 16) * 8));
        mma_bf16(acc[2 * dp], ph, vb[0], vb[1]);
        mma_bf16(acc[2 * dp], pl, vb[0], vb[1]);
        mma_bf16(acc[2 * dp + 1], ph, vb[2], vb[3]);
        mma_bf16(acc[2 * dp + 1], pl, vb[2], vb[3]);
      }"""
VARIANTS.update({
    # Q's fragments read from shared memory at every tile, not held
    "Q fragments from smem": QF_IN_SMEM,
    # all the P_hi MMAs of a 16-column step, then all the P_lo ones
    "hi pass, then lo pass": QF_IN_SMEM + [(PV_LOOP, """      uint32_t vb[D / 16][4];
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        const int r = j * 16 + ((lane / 8) % 2) * 8 + (lane % 8);
        ldmatrix_x4_trans(vb[dp], smem_addr(Vt + r * LD + dp * 16 +
                                            (lane / 16) * 8));
        mma_bf16(acc[2 * dp], ph, vb[dp][0], vb[dp][1]);
        mma_bf16(acc[2 * dp + 1], ph, vb[dp][2], vb[dp][3]);
      }
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        mma_bf16(acc[2 * dp], pl, vb[dp][0], vb[dp][1]);
        mma_bf16(acc[2 * dp + 1], pl, vb[dp][2], vb[dp][3]);
      }""")],
    # diagnostic, output wrong: P·V's MMAs replaced by a cheap use of
    # their operands (what the rest of the tile costs)
    "no P·V MMAs (diagnostic)": [(
        """        mma_bf16(acc[2 * dp], ph, vb[0], vb[1]);
        mma_bf16(acc[2 * dp], pl, vb[0], vb[1]);
        mma_bf16(acc[2 * dp + 1], ph, vb[2], vb[3]);
        mma_bf16(acc[2 * dp + 1], pl, vb[2], vb[3]);""",
        """        acc[2 * dp][0] += __uint_as_float((ph[0] ^ vb[0]) & 0x3c00ffffu);
        acc[2 * dp + 1][1] += __uint_as_float((pl[2] ^ vb[2]) & 0x3c00ffffu);""")],
    # diagnostic, output wrong: Q·K^T's MMAs replaced likewise
    "no Q·K^T MMAs (diagnostic)": [(
        """        mma_bf16(s[2 * np], qf[kk], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qf[kk], kb[2], kb[3]);""",
        """        s[2 * np][kk % 4] += __uint_as_float((qf[kk][0] ^ kb[0]) & 0x3c00ffffu);
        s[2 * np + 1][kk % 4] += __uint_as_float((qf[kk][1] ^ kb[2]) & 0x3c00ffffu);""")],
    # diagnostic, output wrong: each warp reads a quarter of the K and V
    # fragments from shared memory (the first of every four, reused)
    "K, V fragments read 4x less (diagnostic)": [
        ("""#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t kb[4];
        const int n = np * 16 + (lane / 16) * 8 + (lane % 8);
        ldmatrix_x4(""", """      uint32_t kb[4];
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        const int n = np * 16 + (lane / 16) * 8 + (lane % 8);
        if (np == 0) ldmatrix_x4("""),
        ("""      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vb[4];
        const int r = j * 16 + ((lane / 8) % 2) * 8 + (lane % 8);
        ldmatrix_x4_trans(""", """      uint32_t vb[4];
      for (int dp = 0; dp < D / 16; ++dp) {
        const int r = j * 16 + ((lane / 8) % 2) * 8 + (lane % 8);
        if (dp % 4 == 0) ldmatrix_x4_trans(""")],
})
SHAPES = [("olmo-1b path", (1, 16, 16, 512, 128)),
          ("qwen3-14b path", (1, 40, 8, 512, 128))]


def variant_source(src: str, edits) -> str:
    """``src`` with each (old, new) edit applied; stops if one does not
    apply."""
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"edit does not apply:\n{old}")
        src = src.replace(old, new)
    return src


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_sweep: no CUDA device available", file=sys.stderr)
        return 1
    src = (build.CSRC / SOURCE).read_text()
    out_dir = build.BUILD_ROOT / "sweep"
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
    fns, regs = {}, {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"flash_sweep: {name} did not build:\n{log}")
        kernel = None
        for line in log.splitlines():
            m = chip_smoke.FLASH_KERNEL.search(line)
            if m:
                kernel = f"{m.group(1)}<{m.group(2)}>"
            used = re.search(r"Used (\d+) registers", line)
            if used and kernel == "flash_fwd_bf16_kernel<128>":
                regs[name] = int(used.group(1))
        fn = ctypes.CDLL(str(so)).flash_attention_launch
        fn.argtypes = build.SIGNATURES["flash_attention_launch"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())

    def call(fn, q, k, v):
        o = torch.empty_like(q)
        B, H, S, d = q.shape
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None,
                 *fa._strides(q), *fa._strides(k), *fa._strides(v),
                 *fa._strides(o), B, H, k.shape[1], S, d, 1, d ** -0.5, 1, 0,
                 torch.cuda.current_stream().cuda_stream)
        build.check(err, "flash sweep")
        return o

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    for shape_name, (B, H, Hkv, S, d) in SHAPES:
        q, k, v = (torch.randn(B, h, S, d, generator=gen, device=dev).to(
            torch.bfloat16) for h in (H, Hkv, Hkv))
        want = ref.flash_attention_ref(q, k, v, True, 0)
        nbytes = 2 * (2 * B * H * S * d + 2 * B * Hkv * S * d)
        sets = [(q, k, v)] + [(q.clone(), k.clone(), v.clone()) for _ in
                              range(chip_smoke.L2_BYTES // nbytes + 1)]
        lib_ms = chip_smoke.device_ms(
            lambda t: F.scaled_dot_product_attention(
                *t, is_causal=True, enable_gqa=H != Hkv), sets, 50)
        print(f"{shape_name} ({B},{H},{S},{d}) Hkv {Hkv}: "
              f"scaled_dot_product_attention {lib_ms * 1e3:.1f} us")
        # two passes over the variants, the second in the opposite order
        ms = {name: [] for name in fns}
        for order in (list(fns), list(fns)[::-1]):
            for name in order:
                ms[name].append(chip_smoke.device_ms(
                    lambda t: call(fns[name], *t), sets, 50))
        for name, fn in fns.items():
            got = call(fn, q, k, v)
            err = float((got.float() - want.float()).abs().max())
            try:
                chip_smoke.check_close(name, got, want, 1e-5)
                verdict = "within one bf16 ulp"
            except chip_smoke.SmokeFailure:
                verdict = "OUTSIDE one bf16 ulp"
            a, b = ms[name]
            print(f"  {name:22s} {a * 1e3:6.1f} / {b * 1e3:6.1f} us  "
                  f"({min(a, b) / lib_ms:.2f}x the library)  max|Δ| "
                  f"{err:.3e} {verdict}; {regs[name]} registers at d=128")
        del sets
    return 0


if __name__ == "__main__":
    sys.exit(main())
