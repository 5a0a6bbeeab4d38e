#!/usr/bin/env python3
"""Time variants of the threefry noise kernels (threefry_update,
threefry_sumsq) on one CUDA card.

    python3 tools/threefry_sweep.py              # the variants, timed in turns
    python3 tools/threefry_sweep.py --libdevice  # PTX and SASS of log1pf/sqrtf

Each variant is the committed ``src/repro_torch/kernels/csrc/threefry.cu``
with a few lines changed (the edits are listed below, each as the text it
replaces), or, for "one element a thread", ``tools/threefry_scalar.cu``:
the kernels in their grid-stride, one-element-a-thread form, with
libdevice's log1pf and erfinv's constant selects. Each is built with nvcc
into ``build/repro_torch/threefry_sweep/`` and called through the same C
entry points as the package's kernels, so old and new are compared inside
one call. For every variant the script prints ptxas's registers and
spills, the SASS instructions an element (the full report goes to
chiprun_out/threefry_sweep/variant<i>.txt), the gaussian's mismatches
against the plain version over all 2^23 uniforms, and whether the update
at a leaf whose indices cross 2^32 equals the plain version bit for bit;
then the device time of the update and of the sum of squares at the
largest bf16 leaf of each path, timed with CUDA events in two passes (the
second in the opposite order), with the SM clock read beside each time.
torch.add(x, 1.0) on the same leaf (one read, one write) is timed as the
card's floor for a streaming sweep.

--libdevice compiles a probe kernel that calls the precise log1pf and
sqrtf (no fast math) and writes its PTX and SASS to
chiprun_out/threefry_sweep/ and to standard output: the sequence, with
every constant, that the kernel's log1p_neg reproduces; and prints the
committed kernels' ptxas lines and SASS report.
"""
from __future__ import annotations

import contextlib
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from flash_sweep import variant_source  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from zo_sweep import LEAVES, card, nvcc, sass  # noqa: E402

OUT = ROOT / "chiprun_out" / "threefry_sweep"
SOURCE = "threefry.cu"
SCALAR = ROOT / "tools" / "threefry_scalar.cu"
VARIANTS = {
    "committed": [],
    # libdevice's log1pf in place of log1p_neg (the same bits)
    "libdevice log1pf": [
        ("const float w = -log1p_neg(__fmul_rn(u, -u));",
         "const float w = -log1pf(__fmul_rn(u, -u));")],
    # 16 consecutive elements a thread instead of 8
    "16 elements a thread": [("constexpr int kPerThread = 8;",
                              "constexpr int kPerThread = 16;")],
}
KEY = (0x2545F491, 0x9E3779B9)
PROBE = r"""
extern "C" __global__ void probe_log1pf(const float* a, float* o) {
  o[threadIdx.x] = log1pf(a[threadIdx.x]);
}
extern "C" __global__ void probe_neg_log1p_sq(const float* a, float* o) {
  const float x = a[threadIdx.x];
  o[threadIdx.x] = -log1pf(__fmul_rn(x, -x));
}
extern "C" __global__ void probe_sqrtf(const float* a, float* o) {
  o[threadIdx.x] = sqrtf(a[threadIdx.x]);
}
"""


def bind(so: Path):
    lib = ctypes.CDLL(str(so))
    for name in ("threefry_update_launch", "threefry_sumsq_launch",
                 "threefry_sumsq_scratch_words",
                 "threefry_normal_table_launch"):
        fn = getattr(lib, name)
        fn.argtypes = build.SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def build_variants() -> dict:
    """{name: (library, ptxas log, path)}, all built at once."""
    out_dir = build.BUILD_ROOT / "threefry_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / SOURCE).read_text()
    sources = {name: variant_source(src, edits)
               for name, edits in VARIANTS.items()}
    sources["one element a thread"] = SCALAR.read_text()
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        cu = out_dir / f"variant{i}.cu"
        cu.write_text(text)
        procs[name] = (cu.with_suffix(".so"), subprocess.Popen(
            [build.nvcc_path(), *build.ARCH_FLAGS, *build.BASE_FLAGS,
             "-Xptxas", "-v", "-shared", str(cu), "-o",
             str(cu.with_suffix(".so"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"threefry_sweep: {name} did not build:\n{log}")
        libs[name] = (bind(so), log, so)
    return libs


def checks(lib, dev, stream) -> tuple:
    """(mismatches of the gaussian over all 2^23 uniforms, whether the bf16
    update at a (185000,) leaf whose indices cross 2^32 equals the plain
    version bit for bit)."""
    got = torch.empty(1 << 23, dtype=torch.float32, device=dev)
    build.check(lib.threefry_normal_table_launch(got.data_ptr(), stream),
                "table")
    m = torch.arange(1 << 23, dtype=torch.int64, device=dev)
    want = ref.normal_of_bits(m << 9)
    bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(185000, generator=gen, device=dev).to(torch.bfloat16)
    y = torch.empty_like(x)
    c = torch.full((1,), 0.37, device=dev)
    off = (1 << 32) - 1000
    build.check(lib.threefry_update_launch(
        x.data_ptr(), y.data_ptr(), x.numel(), 1, *KEY, c.data_ptr(), None,
        off, stream), "update")
    key = np.array(KEY, np.uint32)
    return bad, bool(torch.equal(y, ref.threefry_update_ref(x, key, c, None,
                                                            off)))


def sweep() -> int:
    card()
    libs = build_variants()
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    OUT.mkdir(parents=True, exist_ok=True)
    for i, (name, (lib, log, so)) in enumerate(libs.items()):
        with open(OUT / f"variant{i}.txt", "w") as f, \
                contextlib.redirect_stdout(f):
            print(f"== {name}")
            (OUT / f"variant{i}.sass").write_text(sass(so))
            try:
                per = chip_smoke.threefry_sass_report(so, log)
            except chip_smoke.SmokeFailure as e:
                print(f"SASS report failed: {e}")
                per = {}
        regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers",
                                                  log)})
        spills = sorted({int(b) for b in re.findall(
            r"(\d+) bytes spill stores", log)})
        bad, equal = checks(lib, dev, stream)
        per_el = {k: round(v[0], 2) for k, v in per.items()}
        print(f"== {name}: gaussian mismatches over all 2^23 uniforms "
              f"{bad}; update across 2^32 equal to the plain version "
              f"{equal}; registers {regs}, spill stores {spills} bytes; "
              f"SASS instructions an element {per_el} "
              f"(chiprun_out/threefry_sweep/variant{i}.txt)")
    gen = torch.Generator(device=dev).manual_seed(5)
    c = torch.full((1,), 0.37, device=dev)
    scratch = {name: torch.zeros(lib.threefry_sumsq_scratch_words(),
                                 dtype=torch.int32, device=dev)
               for name, (lib, _, _) in libs.items()}
    acc = torch.zeros(1, device=dev)
    for leaf, shape in LEAVES:
        x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        y = torch.empty_like(x)
        n = x.numel()
        ms, clk, draw = chip_smoke.time_ms_clocked(lambda: torch.add(x, 1.0))
        print(f"{leaf} leaf {shape} bf16: torch.add(x, 1.0) (streaming "
              f"floor) {ms:.4f} ms at {clk:.0f} MHz, {draw:.0f} W")
        calls = {
            "update": lambda lib, name: build.check(
                lib.threefry_update_launch(
                    x.data_ptr(), y.data_ptr(), n, 1, *KEY, c.data_ptr(),
                    None, 0, stream), "update"),
            "sum of squares": lambda lib, name: build.check(
                lib.threefry_sumsq_launch(
                    n, *KEY, 0, acc.data_ptr(), scratch[name].data_ptr(),
                    stream), "sumsq")}
        for what, call in calls.items():
            res = {name: [] for name in libs}
            for order in (list(libs), list(libs)[::-1]):
                for name in order:
                    lib = libs[name][0]
                    res[name].append(chip_smoke.time_ms_clocked(
                        lambda: call(lib, name)))
            for name, runs in res.items():
                (a, ca, _), (b, cb, _) = runs
                print(f"  {what:14s} {name:22s} {a:.4f} / {b:.4f} ms at "
                      f"{ca:.0f} / {cb:.0f} MHz")
        del x, y
    return 0


def libdevice() -> int:
    card()
    OUT.mkdir(parents=True, exist_ok=True)
    cu = OUT / "probe.cu"
    cu.write_text(PROBE)
    nvcc("-ptx", str(cu), "-o", str(OUT / "probe.ptx"), arch=("-arch=sm_90a",))
    nvcc("-cubin", str(cu), "-o", str(OUT / "probe.cubin"))
    (OUT / "probe.sass").write_text(sass(OUT / "probe.cubin"))
    print((OUT / "probe.ptx").read_text())
    print((OUT / "probe.sass").read_text())
    # the committed kernels: ptxas's registers and spills, the SASS report
    log = nvcc("-Xptxas", "-v", "-cubin", str(build.CSRC / SOURCE), "-o",
               str(OUT / "threefry.cubin"))
    (OUT / "threefry.sass").write_text(sass(OUT / "threefry.cubin"))
    chip_smoke.threefry_sass_report(OUT / "threefry.cubin", log)
    return 0


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("threefry_sweep: no CUDA device available", file=sys.stderr)
        return 1
    if argv == ["--libdevice"]:
        return libdevice()
    return sweep()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
