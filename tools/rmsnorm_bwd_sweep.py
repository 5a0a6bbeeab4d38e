#!/usr/bin/env python3
"""Time variants of the one-pass RMSNorm backward on one CUDA card.

    python3 tools/rmsnorm_bwd_sweep.py

Each variant is the committed ``src/repro_torch/kernels/csrc/rmsnorm.cu``
with a few lines changed (the edits are listed below, each as the text it
replaces), built with nvcc into ``build/repro_torch/norm_bwd_sweep/`` and
called through its own C entry points, at the bf16 shapes of
``tools/rmsnorm_bwd_ab.py``. For every variant and shape the script prints
its device time per call in two passes (the second in the opposite order;
torch.profiler, inputs cycled past the 50 MB L2), the grid it launched,
and whether dx and dscale lie within chip_smoke.py's tolerance of the
plain version; the variants marked "diagnostic" leave out part of the
work to show what it costs, and may fail that check. The variants
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
sys.path.insert(0, str(ROOT / "tools"))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from rmsnorm_bwd_ab import (SHAPES, Norm, agrees, copies, inputs,  # noqa: E402
                            runner, start_build)

SOURCE = "rmsnorm.cu"
BOUNDS = "__launch_bounds__(kThreads)\nrmsnorm_bwd_kernel("
VARIANTS = {
    "committed": [],
    # the pass alone: no sum of its clusters' partials (diagnostic)
    "no dscale sum launch (diagnostic)": [(
        "  if (err != cudaSuccess) return err;\n"
        "  rmsnorm_dscale_sum_kernel<<<",
        "  if (err != cudaSuccess || D > 0) return err;\n"
        "  rmsnorm_dscale_sum_kernel<<<")],
    # dx alone: no cluster barrier, no partials (diagnostic)
    "dx only (diagnostic)": [(
        "  cg::cluster_group cluster = cg::this_cluster();\n"
        "  cluster.sync();\n  const float* src[kCluster];",
        "  return;\n  cg::cluster_group cluster = cg::this_cluster();\n"
        "  cluster.sync();\n  const float* src[kCluster];")],
    # bf16 packs left to the compiler across the row's reduction
    "packs not kept packed": [("if constexpr (sizeof(T) == 2 && V == 8) {",
                               "if constexpr (sizeof(T) == 0) {")],
    # clusters of 4 blocks: twice the clusters' partials
    "clusters of 4": [("constexpr int kCluster = 8; ",
                       "constexpr int kCluster = 4; ")],
    # twice the clusters the card holds at once, the rest queued
    "grid x2": [("  const long long cap = kCluster * std::max(1LL, clusters);",
                 "  const long long cap = 2 * kCluster * std::max(1LL, "
                 "clusters);"),
                ("                  1LL * sm_count() * kMaxBlocksPerSM / "
                 "kCluster)",
                 "                  2LL * sm_count() * kMaxBlocksPerSM / "
                 "kCluster)")],
    # at most 64 registers a thread, for 4 blocks an SM
    "4 blocks an SM": [(BOUNDS, "__launch_bounds__(kThreads, 4)\n"
                                "rmsnorm_bwd_kernel(")],
}


def variant_source(src: str, edits) -> str:
    """``src`` with each (old, new) edit applied; stops if one does not
    apply."""
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"edit does not apply:\n{old}")
        src = src.replace(old, new)
    return src


def ptxas_regs(log: str) -> str:
    """Registers (and spill stores) ptxas gave the bf16 instances of the
    pass (V elements a pack, G lanes a row, PL packs a lane, pair or
    not)."""
    out, kernel = [], None
    for line in log.splitlines():
        m = re.search(r"rmsnorm_bwd_kernelI13__nv_bfloat16Li(\d+)ELi(\d+)E"
                      r"Li(\d+)ELb(\d)E", line)
        if "Compiling entry function" in line:
            kernel = m and (f"V{m.group(1)} G{m.group(2)} PL{m.group(3)}"
                            + (" pair" if m.group(4) == "1" else ""))
            continue
        spill = re.search(r"(\d+) bytes spill stores", line)
        if kernel and spill and spill.group(1) != "0":
            out.append(f"{kernel}: SPILLS {spill.group(1)} bytes")
        used = re.search(r"Used (\d+) registers", line)
        if kernel and used:
            out.append(f"{kernel}: {used.group(1)}")
    return ", ".join(out)


def grid_of(norm: Norm, tensors) -> int:
    """The grid of the variant's pass for these inputs."""
    x, s, dy = tensors[0]
    D = x.shape[-1]
    plan = (ctypes.c_int * 5)()
    if len(tensors) == 1:
        norm.lib.rmsnorm_bwd_launch(
            x.data_ptr(), s.data_ptr(), dy.data_ptr(), x.data_ptr(),
            s.data_ptr(), s.data_ptr(), 1 << 40, x.numel() // D, D, 1, 1e-5,
            None, plan)
    else:
        (xq, sq, dq), (xk, sk, dk) = tensors
        norm.lib.rmsnorm_pair_bwd_launch(
            xq.data_ptr(), sq.data_ptr(), dq.data_ptr(), xq.data_ptr(),
            sq.data_ptr(), xq.numel() // D, xk.data_ptr(), sk.data_ptr(),
            dk.data_ptr(), xk.data_ptr(), sk.data_ptr(), xk.numel() // D,
            sq.data_ptr(), 1 << 40, D, 1, 1e-5, None, plan)
    return plan[3]


def main() -> int:
    if not torch.cuda.is_available():
        print("rmsnorm_bwd_sweep: no CUDA device available", file=sys.stderr)
        return 1
    src = (build.CSRC / SOURCE).read_text()
    out_dir = build.BUILD_ROOT / "norm_bwd_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    started = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        cu = out_dir / f"variant{i}.cu"
        cu.write_text(variant_source(src, edits))
        started[name] = (cu, *start_build(f"variant{i}", cu, out_dir,
                                           ptxas=True))
    norms = {}
    for name, (cu, so, p) in started.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"rmsnorm_bwd_sweep: {name} did not build:\n"
                             f"{log}")
        print(f"{name}: registers {ptxas_regs(log)}")
        norms[name] = Norm(so, cu.read_text())
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(8)
    for shape_name, q_shape, k_shape in SHAPES:
        tensors = inputs(gen, q_shape, k_shape)
        print(f"{shape_name} {q_shape}" + (f" + {k_shape}" if k_shape
                                           else ""))
        sets = copies(tensors)
        ms = {name: [] for name in norms}
        for order in (list(norms), list(norms)[::-1]):
            for name in order:
                ms[name].append(chip_smoke.device_ms(
                    runner(norms[name], tensors), sets, 100))
        for name, norm in norms.items():
            a, b = ms[name]
            print(f"  {name:28s} {a * 1e3:6.2f} / {b * 1e3:6.2f} us, grid "
                  f"{grid_of(norm, tensors)}; {agrees(norm, tensors)}")
        del sets
    return 0


if __name__ == "__main__":
    sys.exit(main())
