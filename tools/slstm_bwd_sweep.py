#!/usr/bin/env python3
"""Time the committed ``slstm_bwd.cu``'s chain on one CUDA card beside
variants of it that leave out one part of a token's work, in turns.

    python3 tools/slstm_bwd_sweep.py

Each source is ``slstm_bwd.cu`` with ``slstm.cu``'s text in place of its
``#include`` (so an edit may touch either), built with nvcc (``-Xptxas
-v``, its backward kernels' registers and spills printed) into
``build/repro_torch/slstm_bwd_sweep/``, all at once, and called through
its own ``slstm_bwd_launch`` on the record of the package's saving
forward. VARIANTS are diagnostics: the transposed product, the warp's
reduce-scatter, the gate thread's token (its forward again and its
backward) or the handoff of the partials (local stores, no waits on the
mbarriers) left out; their results differ from the plain version's, the
committed source's must lie within chip_smoke.py's ``check_slstm_bwd``
tolerance. At path 11's head dim 256 (4 heads), bf16, it prints each
source's device time per call of the chain (torch.profiler, as
chip_smoke.py times it) and per token step at B = 1 for S = 64 to 4096
(a start-up cost shows as the difference between the short and the long
sequences) and at the grouped rows (4, 512), every source in turn and
then in the opposite order. The card's name and power limit come first.
The package loads none of the variants.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
import slstm_sweep  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402

SOURCE = "slstm_bwd.cu"
INCLUDE = '#include "slstm.cu"'
SHAPES = ((1, 64), (1, 256), (1, 512), (1, 1024), (1, 4096), (4, 512))
H, DH = 4, 256
PRODUCT = """        float s = rr[0][j] * x[0];
#pragma unroll
        for (int u = 1; u < KO; ++u) s = fmaf(rr[u][j], x[u], s);"""
GATE_START = "      // the token's forward, as slstm.cu computes it\n"
GATE_END = "      dm = dlfm;\n"
# the token's arithmetic replaced by a chain of the same inputs and outputs
GATE_SHORT = """      const float dpz = __fadd_rn(g, pz), dpi = __fadd_rn(pi, c);
      const float dpf = __fadd_rn(pf, n), dpo = __fadd_rn(po, m);
      dc = __fadd_rn(dc, dpz);
      dn = __fadd_rn(dn, dpf);
      dm = __fadd_rn(dm, dpi);
"""

# what each part costs: its work left out (the results differ)
VARIANTS = {
    "product left out (diagnostic)": [
        (PRODUCT, "        float s = x[j % KO];")],
    "reduce-scatter left out (diagnostic)": [
        ("      reduce_scatter<L, 16>(a, lane);\n", "")],
    "gate thread's token left out (diagnostic)": "gate",
    "handoff left out: local stores, no waits (diagnostic)": [
        (slstm_sweep.STORE, '      "st.shared.b32 [%0], %1;" ::"r"(addr), '
                            '"r"(__float_as_uint(v)) : "memory");'),
        (slstm_sweep.WAIT, "  uint32_t done = 1;\n  while (!done) {"),
        (slstm_sweep.ARM, "  (void)bar;\n  (void)bytes;")],
}


def variant_source(src: str, edits) -> str:
    """``src`` (``slstm_bwd.cu``'s text) with slstm.cu's text in place of
    its #include, then each (old, new) edit applied (``"gate"``: the gate
    thread's arithmetic, GATE_START up to GATE_END, replaced by
    GATE_SHORT); stops if one does not apply."""
    if INCLUDE not in src:
        raise SystemExit(f"slstm_bwd_sweep: {SOURCE} does not include "
                         f"slstm.cu as expected")
    src = src.replace(INCLUDE, (build.CSRC / "slstm.cu").read_text())
    if edits == "gate":
        if GATE_START not in src or GATE_END not in src:
            raise SystemExit("edit does not apply: the gate's arithmetic")
        head, rest = src.split(GATE_START, 1)
        _, tail = rest.split(GATE_END, 1)
        return head + GATE_SHORT + tail
    return slstm_sweep.variant_source(src, edits)


def ptxas_report(log: str) -> list:
    """ptxas's lines for the sLSTM backward kernels at dh 256."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            name = chip_smoke.slstm_kernel_name(line)
            continue
        if (name and "bwd" in name and ", 256," in name
                and ("registers" in line or "spill" in line)):
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return out


class Backward:
    """A built source's chain, called as slstm_bwd calls it (db and dr
    from dpre are left to the wrapper and not timed here)."""

    def __init__(self, so: Path):
        self.lib = ctypes.CDLL(str(so))
        self.lib.slstm_bwd_launch.argtypes = build.SIGNATURES[
            "slstm_bwd_launch"]

    def __call__(self, t):
        saved, r, dhs, dfin = t
        B, S, D = dhs.shape
        dh = r.shape[2]
        dx = torch.empty((B, S, 4 * D), dtype=dhs.dtype, device=dhs.device)
        dpre = torch.empty((B, S, 4 * D), device=dhs.device)
        d0 = [torch.empty((B, D // dh, dh), device=dhs.device)
              for _ in range(4)]
        build.check(self.lib.slstm_bwd_launch(
            saved.data_ptr(), dhs.data_ptr(), r.data_ptr(),
            *(x.data_ptr() for x in dfin), dx.data_ptr(), dpre.data_ptr(),
            *(x.data_ptr() for x in d0), B, S, D // dh, dh, 1,
            torch.cuda.current_stream().cuda_stream), "slstm_bwd sweep")
        return dx, dpre, d0


def main() -> int:
    if len(sys.argv) > 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("slstm_bwd_sweep: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.kernels.slstm import _launch
    out_dir = build.BUILD_ROOT / "slstm_bwd_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / SOURCE).read_text()
    texts = {"committed": variant_source(src, []), **{
        n: variant_source(src, e) for n, e in VARIANTS.items()}}
    started = {n: slstm_sweep.start_build(f"b{i}", t, out_dir)
               for i, (n, t) in enumerate(texts.items())}
    fns = {}
    for n, (so, p) in started.items():
        log, _ = p.communicate()
        if p.returncode:
            if n == "committed":
                raise SystemExit(f"slstm_bwd_sweep: {n} did not build:\n{log}")
            print(f"{n}: did not build, left out:\n" + "\n".join(
                ln for ln in log.splitlines() if "error" in ln))
            continue
        for line in ptxas_report(log):
            print(f"ptxas {n} {line}")
        fns[n] = Backward(so)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    names = list(fns)
    for B, S in SHAPES:
        args = chip_smoke.slstm_inputs(B, S, H, DH, torch.bfloat16, dev)
        _, _, saved = _launch(*args[:3], args[3:], None, save=True)
        g = torch.Generator(device=dev).manual_seed(9)
        dhs = torch.randn(B, S, H * DH, generator=g, device=dev).to(
            torch.bfloat16)
        dfin = [torch.randn(B, H, DH, generator=g, device=dev)
                for _ in range(4)]
        what = f"{(B, S, H, DH)} bf16"
        if S == 512:
            want = ref.slstm_bwd_ref(*args, dhs, *dfin, saved=saved)
            for n, fn in fns.items():
                dx, dpre, d0 = fn((saved, args[2], dhs, dfin))
                got = (dx, dpre.view(B * S, 4, -1).sum(0).reshape(-1),
                       want[2], *d0)
                try:
                    err = chip_smoke.check_slstm_bwd(f"{what} {n}", got, want)
                    print(f"{what} {n}: within the tolerance (max|Δ| "
                          f"{err:.3e}; dr not compared)")
                except chip_smoke.SmokeFailure as e:
                    print(f"{what} {n}: OUTSIDE the tolerance "
                          f"({str(e)[:80]})")
            del want
        sets = [(saved, args[2], dhs, dfin)] + [
            (saved.clone(), args[2], dhs.clone(), dfin)
            for _ in range(min(3, chip_smoke.L2_BYTES // saved.nbytes + 1))]
        ms = {n: [] for n in names}
        for n in names + names[::-1]:
            ms[n].append(chip_smoke.device_ms(fns[n], sets,
                                              5 if S >= 4096 else 10))
        for n in names:
            print(f"{what} {n}: " + " ".join(f"{x:.4f}" for x in ms[n])
                  + f" ms ({min(ms[n]) / S * 1e3:.3f} us a token step)")
        del sets, saved
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
