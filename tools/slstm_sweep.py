#!/usr/bin/env python3
"""Time variants of the committed ``slstm.cu`` in turns on one CUDA card,
or an older ``slstm.cu`` against the committed one.

    python3 tools/slstm_sweep.py
    git show <commit>:src/repro_torch/kernels/csrc/slstm.cu \\
        > build/old_slstm.cu
    python3 tools/slstm_sweep.py build/old_slstm.cu

Each source (the committed one and each of VARIANTS, one or a few edits
of it; or the older one and the committed one) is built with nvcc
(``-Xptxas -v``, its sLSTM kernels' registers and spills printed) into
``build/repro_torch/slstm_sweep/`` and called through its own
``slstm_launch``. At path 11's round and prefill shapes,
(B, S, H, dh) = (1, 512, 4, 256) and (1, 4096, 4, 256) in bf16
(chip_smoke.py's SLSTM_CASES), it prints whether each source's hs and
final state lie within chip_smoke.py's ``check_slstm`` tolerance of the
plain version, then each one's device time per call (torch.profiler, as
chip_smoke.py times it), every source in turn and then in the opposite
order (with an older source: bf16 and f32, old, new, new, old, twice, and
whether the two sources' results are bit-equal), with the time a token
step beside it. The variants are diagnostics whose results differ: each
leaves out one part of a token's work, the recurrent product, the gate
arithmetic, the stores of h into the other blocks' shared memory (and
with them the cluster barrier), or the precise transcendentals. They measure the design's parts; the package loads none
of them. The card's name and power limit come first.
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

import chip_smoke  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402

SOURCE = "slstm.cu"
SHAPES = tuple((label, shape) for label, shape, _ in chip_smoke.SLSTM_CASES
               if shape[3] == 256 and shape[1] > 1)
PRODUCT = "for (int j = 0; j < L; j += 4) {"
GATE = """      const float lf = log_sigmoid(pf);
      const float lfm = __fadd_rn(lf, m);
      const float mn = fmaxf(lfm, pi);
      const float ig = expf(__fsub_rn(pi, mn));
      const float fg = expf(__fsub_rn(lfm, mn));
      c = __fadd_rn(__fmul_rn(fg, c), __fmul_rn(ig, tanhf(pz)));
      n = fmaxf(__fadd_rn(__fmul_rn(fg, n), ig), expf(-mn));
      const float og = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-po)));
      hv = __fdiv_rn(__fmul_rn(og, c), n);
      m = mn;"""
REMOTE = "for (int rk = 0; rk < cs; ++rk) *cluster.map_shared_rank(nb, rk) = hv;"
TOKEN_BARRIER = """      xo = no;
    }
    cluster.sync();"""
FAST = "namespace cg = cooperative_groups;"

# what each part costs: its work left out (the results differ)
VARIANTS = {
    "product left out (diagnostic)": [
        (PRODUCT, "for (int j = 0; j < 0; j += 4) {")],
    "gate arithmetic left out (diagnostic)": [
        (GATE, "      hv = __fadd_rn(__fadd_rn(pz, pi), __fadd_rn(pf, po));\n"
               "      c = hv;\n      n = pf;\n      m = pi;")],
    "fast transcendentals (diagnostic)": [
        (FAST, FAST + "\n#define expf(x) __expf(x)\n"
               "#define log1pf(x) __logf(1.0f + (x))\n"
               "#define tanhf(x) (1.0f - 2.0f / (__expf(2.0f * (x)) + 1.0f))")],
    "remote stores left out (diagnostic)": [(REMOTE, "*nb = hv;")],
    "remote stores and the token's cluster barrier left out (diagnostic)": [
        (REMOTE, "*nb = hv;"),
        (TOKEN_BARRIER, "      xo = no;\n    }\n    __syncthreads();")],
}
F32, BF16 = 0, 1                                # the C entry point's dtype


def variant_source(src: str, edits) -> str:
    """``src`` with each (old, new) edit applied; stops if one does not
    apply."""
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"edit does not apply:\n{old}")
        src = src.replace(old, new)
    return src


def start_build(name: str, text: str, out_dir: Path):
    """nvcc -Xptxas -v of ``text`` (written to out_dir/<name>.cu) into
    out_dir/<name>.so, started; (path, process)."""
    cu, so = out_dir / f"{name}.cu", out_dir / f"{name}.so"
    cu.write_text(text)
    return so, subprocess.Popen(
        [build.nvcc_path(), *build.ARCH_FLAGS, *build.BASE_FLAGS, "-Xptxas",
         "-v", "-shared", str(cu), "-o", str(so)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def ptxas_report(log: str) -> list:
    """ptxas's lines for the sLSTM kernels: '<type, columns[, head dim]>:
    registers, spills'."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            m = chip_smoke.SLSTM_KERNEL.search(line)
            name = m and ", ".join(
                ["bf16" if m.group(1) != "f" else "f32"]
                + [g for g in m.groups()[1:] if g])
            continue
        if name and ("registers" in line or "spill" in line):
            out.append(f"<{name}>: {line.split(':', 1)[-1].strip()}")
    return out


class SLSTM:
    """A built slstm.cu, called as its wrapper would."""

    def __init__(self, so: Path):
        self.lib = ctypes.CDLL(str(so))
        v, i = ctypes.c_void_p, ctypes.c_int
        self.lib.slstm_launch.argtypes = (v,) * 12 + (i,) * 5 + (v,)

    def __call__(self, args):
        x_pre, b, r, *state = args
        B, S, _ = x_pre.shape
        _, H, dh, _ = r.shape
        hs = torch.empty((B, S, H * dh), dtype=x_pre.dtype,
                         device=x_pre.device)
        out = [torch.empty_like(s) for s in state]
        err = self.lib.slstm_launch(
            x_pre.data_ptr(), b.data_ptr(), r.data_ptr(),
            *(s.data_ptr() for s in state), hs.data_ptr(),
            *(o.data_ptr() for o in out), B, S, H, dh,
            BF16 if x_pre.dtype == torch.bfloat16 else F32,
            torch.cuda.current_stream().cuda_stream)
        build.check(err, "slstm sweep")
        return hs, tuple(out)


def agrees(fn: SLSTM, args, want) -> str:
    """Whether hs and the state lie within chip_smoke.check_slstm of the
    plain version's ``want``."""
    try:
        err = chip_smoke.check_slstm("slstm", fn(args), want)
    except chip_smoke.SmokeFailure as e:
        return f"OUTSIDE the tolerance ({str(e)[:80]})"
    return f"within the tolerance (max|Δ| {err:.3e})"


def main() -> int:
    old = sys.argv[1] if len(sys.argv) == 2 else None
    if len(sys.argv) > 2 or (old or "").startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("slstm_sweep: no CUDA device available", file=sys.stderr)
        return 1
    out_dir = build.BUILD_ROOT / "slstm_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    committed = (build.CSRC / SOURCE).read_text()
    if old:
        texts = {"old": Path(old).read_text(), "new": committed}
    else:
        texts = {"committed": committed, **{
            n: variant_source(committed, e) for n, e in VARIANTS.items()}}
    started = {n: start_build(f"s{i}", t, out_dir)
               for i, (n, t) in enumerate(texts.items())}
    fns = {}
    for n, (so, p) in started.items():
        log, _ = p.communicate()
        if p.returncode:
            if old or n == "committed":
                raise SystemExit(f"slstm_sweep: {n} did not build:\n{log}")
            print(f"{n}: did not build, left out:\n" + "\n".join(
                ln for ln in log.splitlines() if "error" in ln))
            continue
        for line in ptxas_report(log):
            print(f"ptxas {n} {line}")
        fns[n] = SLSTM(so)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    names = list(fns)
    order = (["old", "new", "new", "old"] * 2 if old
             else names + names[::-1])
    dtypes = (torch.bfloat16, torch.float32) if old else (torch.bfloat16,)
    for label, (B, S, H, dh) in SHAPES:
        for dtype in dtypes:
            args = chip_smoke.slstm_inputs(B, S, H, dh, dtype, dev)
            what = f"{label} {(B, S, H, dh)} {str(dtype)[6:]}"
            want = ref.slstm_ref(*args)
            for n, fn in fns.items():
                print(f"{what} {n}: {agrees(fn, args, want)}")
            if old:
                (ha, sa), (hb, sb) = fns["old"](args), fns["new"](args)
                same = torch.equal(ha, hb) and all(
                    torch.equal(x, y) for x, y in zip(sa, sb))
                print(f"{what}: old and new hs and state bit-equal {same}")
            del want
            ms = {n: [] for n in names}
            for n in order:
                ms[n].append(chip_smoke.device_ms(fns[n], [args],
                                                  5 if S >= 4096 else 10))
            for n in names:
                print(f"{what} {n}: " + " ".join(f"{x:.4f}" for x in ms[n])
                      + f" ms ({min(ms[n]) / S * 1e3:.3f} us a token step)")
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
