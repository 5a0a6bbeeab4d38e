#!/usr/bin/env python3
"""Time an older ``selective_scan.cu`` against the committed one, in turns,
on one CUDA card; or time variants of the committed one.

    git show <commit>:src/repro_torch/kernels/csrc/selective_scan.cu \\
        > build/old_selective_scan.cu
    python3 tools/scan_ab.py build/old_selective_scan.cu
    python3 tools/scan_ab.py --sweep

Each source is built with nvcc (``-Xptxas -v``, its scan kernels'
registers, shared memory and spills printed) into
``build/repro_torch/scan_ab/`` and called through its own
``selective_scan_launch`` (a source without ``z_stride`` takes the
signature without the row strides, one without ``h_chunks`` the signature
without that pointer; a source with it is called with a null one, the
path that saves nothing). At path 10's three shapes, (1, 512, 16384, 16),
(1, 4096, 16384, 16) and one token (chip_smoke.py's SCAN_CASES), it
prints whether each source's y and h_last lie within chip_smoke.py's
``check_scan`` tolerance of the plain version (with an older source, also
whether the two sources' y and h_last are bit-equal), then each one's
device time per call (torch.profiler, cycling through copies of the
inputs past the 50 MB L2, as chip_smoke.py does).

With an older source: bf16 and f32, in the order old, new, new, old,
twice. With ``--sweep``: the committed source and each of VARIANTS (its
launch geometry edited: lanes a channel at N = 16, threads a block, tokens
a chunk, the blocks an SM its registers allow, the tokens a scan group
takes; and diagnostics that leave a part of the work out), bf16, every
source timed in turn, then in the opposite order; a variant that does not
build (too much static shared memory) is said so and left out. The
variants are
measurements of the design's choices, not alternatives the package loads.
The card's name and power limit come first.
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

SOURCE = "selective_scan.cu"
SHAPES = tuple((label, shape) for label, shape in chip_smoke.SCAN_CASES
               if shape[2] == 16384)
G16 = "constexpr int kLanesN16 = 4;"
THREADS = "constexpr int kThreads = 128;"
CHUNK = "constexpr int kChunk = 32;"
BLOCKS = "constexpr int kMinBlocks = 4;"
GROUP = "constexpr int kGroup = 8;"


def _set(line: str, value: int):
    """The edit of one of the constants above to ``value``."""
    return line, re.sub(r"\d+;$", f"{value};", line)


VARIANTS = {
    "G 2, 16-token chunks": [_set(G16, 2), _set(CHUNK, 16)],
    "G 8": [_set(G16, 8)],
    "G 8, 8 blocks an SM": [_set(G16, 8), _set(BLOCKS, 8)],
    "G 8, 16-token chunks, 8 blocks an SM": [_set(G16, 8), _set(CHUNK, 16),
                                             _set(BLOCKS, 8)],
    "16-token chunks": [_set(CHUNK, 16)],
    "256 threads, 16-token chunks, 2 blocks an SM": [
        _set(THREADS, 256), _set(CHUNK, 16), _set(BLOCKS, 2)],
    "256 threads, 16-token chunks, 2 blocks an SM, groups of 4": [
        _set(THREADS, 256), _set(CHUNK, 16), _set(BLOCKS, 2), _set(GROUP, 4)],
    "16-token chunks, groups of 4": [_set(CHUNK, 16), _set(GROUP, 4)],
    "no register cap (1 block an SM)": [_set(BLOCKS, 1)],
    "scan in groups of 2 tokens": [_set(GROUP, 2)],
    "scan in groups of 4 tokens": [_set(GROUP, 4)],
    "scan token by token": [_set(GROUP, 1)],
    # what each part costs: its work left out (the results differ)
    "softplus left out (diagnostic)": [(
        "const float delta = fmaxf(v, 0.0f) + log1pf(expf(-fabsf(v)));",
        "const float delta = fmaxf(v, 0.0f) + 0.01f;")],
    "gate left out (diagnostic)": [(
        "gate<T>(o + xz.x, xz.y);", "from_f32<T>(o + xz.x + xz.y);")],
    "scan's exponentials left out (diagnostic)": [(
        "e[i][n] = expf(dd[i].x * A[n]);", "e[i][n] = dd[i].x * A[n];")],
}
F32, BF16 = 0, 1                                # the C entry points' dtype


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
    """ptxas's lines for the scan kernels: '<type, N[, G]>: registers,
    shared memory, spills'."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            m = re.search(r"selective_scan_kernelI(13__nv_bfloat16|f)"
                          r"((?:Li\d+E)+)E", line)
            name = m and ("bf16" if m.group(1) != "f" else "f32") + ", " + \
                ", ".join(re.findall(r"Li(\d+)E", m.group(2)))
            continue
        if name and ("registers" in line or "spill" in line):
            out.append(f"<{name}>: {line.split(':', 1)[-1].strip()}")
    return out


class Scan:
    """A built selective_scan.cu, called as its own wrapper would."""

    def __init__(self, so: Path, text: str):
        self.lib = ctypes.CDLL(str(so))
        self.strided = "z_stride" in text
        self.chunks = "h_chunks" in text
        v, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        self.lib.selective_scan_launch.argtypes = (
            (v,) * (12 if self.chunks else 11)
            + ((ll,) * 3 if self.strided else ()) + (i,) * 5 + (v,))

    def __call__(self, args):
        x, dt, z, Bc, Cc, A_log, D, bias, h0 = args
        B, S, d_in = x.shape
        N = A_log.shape[-1]
        y, h = torch.empty_like(x), torch.empty_like(h0)
        strides = (d_in, N, N) if self.strided else ()
        err = self.lib.selective_scan_launch(
            x.data_ptr(), dt.data_ptr(), z.data_ptr(), Bc.data_ptr(),
            Cc.data_ptr(), A_log.data_ptr(), D.data_ptr(), bias.data_ptr(),
            h0.data_ptr(), y.data_ptr(), h.data_ptr(),
            *((None,) if self.chunks else ()), *strides, B, S, d_in,
            N, BF16 if x.dtype == torch.bfloat16 else F32,
            torch.cuda.current_stream().cuda_stream)
        build.check(err, "selective_scan A/B")
        return y, h


def agrees(scan: Scan, args, want) -> str:
    """Whether y and h_last lie within chip_smoke.check_scan of the plain
    version's ``want``."""
    try:
        err = chip_smoke.check_scan("scan", scan(args), want)
    except chip_smoke.SmokeFailure as e:
        return f"OUTSIDE the tolerance ({e})"
    return f"within the tolerance (max|Δ| {err:.3e})"


def main() -> int:
    sweep = sys.argv[1:] == ["--sweep"]
    if len(sys.argv) != 2 or (sys.argv[1].startswith("-") and not sweep):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("scan_ab: no CUDA device available", file=sys.stderr)
        return 1
    out_dir = build.BUILD_ROOT / "scan_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    committed = (build.CSRC / SOURCE).read_text()
    if sweep:
        texts = {"committed": committed, **{
            n: variant_source(committed, e) for n, e in VARIANTS.items()}}
    else:
        texts = {"old": Path(sys.argv[1]).read_text(), "new": committed}
    started = {n: start_build(f"s{i}", t, out_dir)
               for i, (n, t) in enumerate(texts.items())}
    scans = {}
    for n, (so, p) in started.items():
        log, _ = p.communicate()
        if p.returncode:
            if not sweep or n == "committed":
                raise SystemExit(f"scan_ab: {n} did not build:\n{log}")
            print(f"{n}: did not build, left out:\n" + "\n".join(
                ln for ln in log.splitlines() if "error" in ln))
            continue
        for line in ptxas_report(log):
            print(f"ptxas {n} {line}")
        scans[n] = Scan(so, texts[n])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    names = list(scans)
    order = names + names[::-1] if sweep else ["old", "new", "new", "old"] * 2
    for label, (B, S, d_in, N) in SHAPES:
        for dtype in (torch.bfloat16,) if sweep else (torch.bfloat16,
                                                      torch.float32):
            args = chip_smoke.scan_inputs(B, S, d_in, N, dtype, dev)
            what = f"{label} {(B, S, d_in, N)} {str(dtype)[6:]}"
            want = ref.selective_scan_ref(*args)
            for n, scan in scans.items():
                print(f"{what} {n}: {agrees(scan, args, want)}")
            if not sweep:
                a, b = scans["old"](args), scans["new"](args)
                print(f"{what}: old and new y and h_last bit-equal "
                      f"{torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])}")
            del want
            nbytes = chip_smoke.scan_bytes(B, S, d_in, N, dtype.itemsize)
            sets = [args] + [tuple(t.clone() for t in args)
                             for _ in range(chip_smoke.L2_BYTES // nbytes + 1)]
            ms = {n: [] for n in names}
            for n in order:
                ms[n].append(chip_smoke.device_ms(scans[n], sets, 20))
            for n in names:
                print(f"{what} {n}: " + " ".join(f"{x:.4f}" for x in ms[n])
                      + " ms")
            del sets, args
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
