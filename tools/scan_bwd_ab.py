#!/usr/bin/env python3
"""Time an older ``selective_scan_bwd.cu`` against the committed one, in
turns, on one CUDA card; or time variants of the committed one.

    git show 495cec1:src/repro_torch/kernels/csrc/selective_scan_bwd.cu \\
        > build/old_selective_scan_bwd.cu
    python3 tools/scan_bwd_ab.py build/old_selective_scan_bwd.cu
    python3 tools/scan_bwd_ab.py --sweep

Each source is built with nvcc (``-Xptxas -v``, its backward kernels'
registers, shared memory and spills printed; ``-I`` the package's csrc/,
since the source includes ``selective_scan.cu`` for the forward's
constants and helpers) into ``build/repro_torch/scan_bwd_ab/`` and called
through its own ``selective_scan_bwd_launch`` (the same signature in
every version), on the h at chunk starts that the package's forward
saved. At chip_smoke.py's SCAN_BWD_CASES at d_in 16384 (path 10 (c)'s
round, (1, 512, 16384, 16), and the 4096-token (1, 4096, 16384, 16)), z,
B and C as the Mamba block's strided views, it prints whether each
source's nine gradients lie within chip_smoke.py's ``check_scan_bwd``
tolerance of the plain version (with an older source, also whether the
two sources' gradients are bit-equal), then each one's device time per
call (torch.profiler, both launches and each apart, cycling through
copies of the inputs past the 50 MB L2, as chip_smoke.py does).

With an older source: bf16 and f32, in the order old, new, new, old,
twice. With ``--sweep``: the committed source and each of VARIANTS (one
of its design's choices edited: tokens a sub-chunk, blocks a cluster,
blocks an SM its registers allow, tokens a recompute group; and
diagnostics that leave a part of the work out, whose results differ),
bf16, every source timed in turn, then in the opposite order; a variant
that does not build is said so and left out. The variants are
measurements of the design's choices, not alternatives the package
loads. The card's name and power limit come first.
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

SOURCE = "selective_scan_bwd.cu"
SHAPES = tuple((label, shape) for label, shape in chip_smoke.SCAN_BWD_CASES
               if shape[2] == 16384)
SUB = "constexpr int kSub = 4;"
BLOCKS = "constexpr int kBwdMinBlocks = 4;"
CLUSTER = "constexpr int kCluster = 2;"
GROUP = "constexpr int kRecGroup = 8;"
EXBUFS = "constexpr int kExBufs = 2;"


def _set(line: str, value: int):
    """The edit of one of the constants above to ``value``."""
    return line, re.sub(r"\d+;", f"{value};", line, count=1)


VARIANTS = {
    "sub-chunks of 8 tokens": [_set(SUB, 8)],
    "clusters of 8": [_set(CLUSTER, 8)],
    "clusters of 4": [_set(CLUSTER, 4)],
    "clusters of 1 (per-block partials)": [_set(CLUSTER, 1)],
    "3 blocks an SM (168 registers)": [_set(BLOCKS, 3)],
    "recompute in groups of 4 tokens": [_set(GROUP, 4)],
    "4 exchange buffers, a barrier every 2 sub-chunks": [_set(EXBUFS, 4)],
    "8 exchange buffers, a barrier every 4 sub-chunks": [_set(EXBUFS, 8)],
    "stage copied element by element": [(
        "const int vec = d_in % 8 == 0", "const int vec = d_in < 0")],
    "refills as each sub-chunk frees its rows": [(
        "        }\n      }\n    }\n    if (k > 0) {  // the stage",
        "        }\n      }\n"
        "      if (k > 0) {\n"
        "        copy_rows(k - 1, j * kSub,"
        " j == n_subs - 1 ? kChunk : (j + 1) * kSub, kChunk);\n"
        "        cp_async_commit();\n      }\n    }\n    if (k > 0) {  // the stage"), (
        "      copy_rows(k - 1, 0, kChunk, kChunk);\n", "")],
    "cluster sum before the stage": [(
        "    cp_async_wait_all();\n    stage(len);\n    __syncthreads();\n"
        "    if (k + 1 < n_chunks) {  // the chunk after this one, summed\n"
        "      cluster_wait();\n"
        "      cluster_sum(k + 1, (k + 1) & 1, min(kChunk, S - t0 - kChunk));\n"
        "    }\n",
        "    if (k + 1 < n_chunks) {\n"
        "      cluster_wait();\n"
        "      cluster_sum(k + 1, (k + 1) & 1, min(kChunk, S - t0 - kChunk));\n"
        "    }\n"
        "    cp_async_wait_all();\n    stage(len);\n    __syncthreads();\n")],
    "upper half of the stage refilled halfway": [(
        "    for (int j = n_subs - 1; j >= 0; --j) {\n",
        "    for (int half = 1; half >= 0; --half) {\n"
        "    for (int j = half ? n_subs - 1 : min(n_subs, Bwd::kSubs / 2) - 1;"
        " j >= (half ? Bwd::kSubs / 2 : 0); --j) {\n"), (
        "        }\n      }\n    }\n    if (k > 0) {  // the stage",
        "        }\n      }\n    }\n"
        "    if (half && k > 0) {\n"
        "      copy_rows(k - 1, kChunk / 2, kChunk, kChunk);\n"
        "      cp_async_commit();\n    }\n    }\n    if (k > 0) {  // the stage"), (
        "      copy_rows(k - 1, 0, kChunk, kChunk);\n",
        "      copy_rows(k - 1, 0, kChunk / 2, kChunk);\n")],
    "recompute's group loops unrolled": [(
        "#pragma unroll 1\n      for (; t + kRecGroup <= lr; t += kRecGroup) {",
        "      for (; t + kRecGroup <= lr; t += kRecGroup) {"), (
        "#pragma unroll 1\n      for (; t + kSub <= lr; t += kSub) {",
        "      for (; t + kSub <= lr; t += kSub) {")],
    "sums' and copies' loops unrolled": [(
        "#pragma unroll 1\n    for (int o = tid;", "    for (int o = tid;"), (
        "#pragma unroll 1\n    for (int e = tid;", "    for (int e = tid;"), (
        "#pragma unroll 1\n        for (int jj = ", "        for (int jj = ")],
    "first pass over the whole chunk": [(
        "const int lr = (n_subs - 1) * kSub;",
        "const int lr = len / kSub * kSub;")],
    # what each part costs: its work left out (the results differ)
    "sum launch left out (diagnostic)": [(
        "  selective_scan_bwd_sum_kernel<<<",
        "  if (rows < 0) selective_scan_bwd_sum_kernel<<<")],
    "dB/dC sums left out (diagnostic)": [(
        "const float e = channel_sum<G, V>(red, lane);",
        "const float e = red[0] + red[V - 1];"), (
        "          block_sum(jj, static_cast<int>(k & 1), "
        "min(kSub, len - jj * kSub));\n", "")],
    "lane sums left out (diagnostic)": [(
        "    lane_scatter<kSub, G / 2>(da, fa, lane);\n"
        "    lane_scatter<kSub, G / 2>(sb, fs, lane);\n"
        "    lane_scatter<kSub, G / 2>(op, fo, lane);\n",
        "    fa[0] = da[0];\n    fs[0] = sb[0];\n    fo[0] = op[0];\n")],
    "stage refills left out (diagnostic)": [(
        "      copy_rows(k - 1, 0, kChunk, kChunk);\n", "")],
    "recompute's exponentials left out (diagnostic)": [(
        "e[i][n] = expf(dl[i] * A[n]);", "e[i][n] = dl[i] * A[n];")],
    "sub-chunks' exponentials left out (diagnostic)": [(
        "ee[i][n] = expf(dl[i] * A[n]);", "ee[i][n] = dl[i] * A[n];")],
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
    """nvcc -Xptxas -v of ``text`` (written to out_dir/<name>.cu, built
    with the package's csrc/ on the include path) into out_dir/<name>.so,
    started; (path, process)."""
    cu, so = out_dir / f"{name}.cu", out_dir / f"{name}.so"
    cu.write_text(text)
    return so, subprocess.Popen(
        [build.nvcc_path(), *build.ARCH_FLAGS, *build.BASE_FLAGS, "-I",
         str(build.CSRC), "-Xptxas", "-v", "-shared", str(cu), "-o",
         str(so)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def ptxas_report(log: str) -> list:
    """ptxas's lines for the backward kernels: '<type, N, G>: registers,
    shared memory, spills' (the sum kernel as 'sum')."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            m = re.search(r"selective_scan_bwd_kernelI(13__nv_bfloat16|f)"
                          r"((?:Li\d+E)+)E", line)
            name = (m and ("bf16" if m.group(1) != "f" else "f32") + ", "
                    + ", ".join(re.findall(r"Li(\d+)E", m.group(2)))
                    or ("sum" if "selective_scan_bwd_sum" in line else None))
            continue
        if name and ("registers" in line or "spill" in line):
            out.append(f"<{name}>: {line.split(':', 1)[-1].strip()}")
    return out


class ScanBwd:
    """A built selective_scan_bwd.cu, called as its own wrapper would."""

    def __init__(self, so: Path, text: str):
        self.lib = ctypes.CDLL(str(so))
        self.text = text
        v, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        self.lib.selective_scan_bwd_launch.argtypes = (
            (v,) * 21 + (ll,) * 3 + (i,) * 5 + (v,))
        self.lib.selective_scan_bwd_scratch_floats.argtypes = (i,) * 4
        self.lib.selective_scan_bwd_scratch_floats.restype = ll

    def plan(self):
        """The bf16, N = 16 instance's selective_scan_bwd_plan as a dict,
        for a source whose plan has the cluster fields (int[10]), else
        None."""
        if "plan[10]" not in self.text:
            return None
        plan = (ctypes.c_int * 10)()
        build.check(self.lib.selective_scan_bwd_plan(16, BF16, plan), "plan")
        return dict(zip(("lanes", "channels", "sub", "threads", "registers",
                         "smem", "blocks_per_sm", "cluster", "barriers",
                         "clusters_at_once"), plan))

    def __call__(self, args, hc, dy, dh_last):
        """The nine gradients, as ``selective_scan_bwd`` returns them."""
        from repro_torch.kernels.selective_scan import _row_stride
        x, dt, z, Bc, Cc, A_log, D, bias, h0 = args
        B, S, d_in = x.shape
        N = A_log.shape[-1]
        outs = (torch.empty_like(x), torch.empty_like(dt),
                torch.empty_like(x), torch.empty(B, S, N, device=x.device),
                torch.empty(B, S, N, device=x.device),
                torch.empty_like(A_log), torch.empty_like(D),
                torch.empty_like(bias), torch.empty_like(h0))
        scratch = torch.empty(
            self.lib.selective_scan_bwd_scratch_floats(B, S, d_in, N),
            device=x.device)
        err = self.lib.selective_scan_bwd_launch(
            x.data_ptr(), dt.data_ptr(), z.data_ptr(), Bc.data_ptr(),
            Cc.data_ptr(), A_log.data_ptr(), D.data_ptr(), bias.data_ptr(),
            hc.data_ptr(), dy.data_ptr(), dh_last.data_ptr(),
            *(t.data_ptr() for t in outs), scratch.data_ptr(),
            _row_stride("z", z), _row_stride("Bc", Bc),
            _row_stride("Cc", Cc), B, S, d_in, N,
            BF16 if x.dtype == torch.bfloat16 else F32,
            torch.cuda.current_stream().cuda_stream)
        build.check(err, "selective_scan_bwd A/B")
        return outs


def agrees(scan: ScanBwd, inputs, want) -> str:
    """Whether the gradients lie within chip_smoke.check_scan_bwd of the
    plain version's ``want``."""
    try:
        err = chip_smoke.check_scan_bwd("scan bwd", scan(*inputs), want)
    except chip_smoke.SmokeFailure as e:
        return f"OUTSIDE the tolerance ({e})"
    return f"within the tolerance (max|Δ| {err:.3e})"


def main() -> int:
    sweep = sys.argv[1:] == ["--sweep"]
    if len(sys.argv) != 2 or (sys.argv[1].startswith("-") and not sweep):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("scan_bwd_ab: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.kernels.selective_scan import _launch
    out_dir = build.BUILD_ROOT / "scan_bwd_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    committed = (build.CSRC / SOURCE).read_text()
    if sweep:
        texts = {"committed": committed, **{
            n: variant_source(committed, e) for n, e in VARIANTS.items()}}
    else:
        texts = {"old": Path(sys.argv[1]).read_text(), "new": committed}
    started = {n: start_build(f"s{i}", t, out_dir)
               for i, (n, t) in enumerate(texts.items())}
    build.library()                    # the forward that saves chunk starts
    scans = {}
    for n, (so, p) in started.items():
        log, _ = p.communicate()
        if p.returncode:
            if not sweep or n == "committed":
                raise SystemExit(f"scan_bwd_ab: {n} did not build:\n{log}")
            print(f"{n}: did not build, left out:\n" + "\n".join(
                ln for ln in log.splitlines() if "error" in ln))
            continue
        for line in ptxas_report(log):
            print(f"ptxas {n} {line}")
        scans[n] = ScanBwd(so, texts[n])
        plan = scans[n].plan()
        if plan:
            print(f"plan {n} <bf16, 16>: {plan}")
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
            views = chip_smoke.scan_views(args)
            g = torch.Generator(device=dev).manual_seed(9)
            dy = torch.randn(B, S, d_in, generator=g, device=dev).to(dtype)
            dh_last = torch.randn(B, d_in, N, generator=g, device=dev)
            _, _, hc = _launch(*args, None, save=True)
            what = f"{label} {(B, S, d_in, N)} {str(dtype)[6:]}"
            want = ref.selective_scan_bwd_ref(*args, dy, dh_last)
            for n, scan in scans.items():
                same = all(torch.equal(u, w) for u, w in zip(
                    scan(views, hc, dy, dh_last), scan(args, hc, dy, dh_last)))
                ok = agrees(scan, (views, hc, dy, dh_last), want)
                print(f"{what} {n}: {ok}; z, B and C read in place equal "
                      f"contiguous copies "
                      f"{same}")
            del want
            if not sweep:
                a = scans["old"](args, hc, dy, dh_last)
                b = scans["new"](args, hc, dy, dh_last)
                print(f"{what}: old and new gradients bit-equal "
                      f"{all(torch.equal(u, v) for u, v in zip(a, b))}")
                del a, b
            nbytes = chip_smoke.scan_bwd_bytes(B, S, d_in, N, dtype.itemsize)
            sets = [(args, hc)] + [
                (tuple(t.clone() for t in args), hc.clone())
                for _ in range(chip_smoke.L2_BYTES // nbytes + 1)]
            ms = {n: [] for n in names}
            parts = {n: {} for n in names}
            for n in order:
                by_kernel = {}
                ms[n].append(chip_smoke.device_ms(
                    lambda t, s=scans[n]: s(t[0], t[1], dy, dh_last), sets,
                    10, by_kernel=by_kernel))
                for k, v in by_kernel.items():
                    key = "sum" if "sum" in k else "recurrence"
                    parts[n].setdefault(key, []).append(v)
            for n in names:
                print(f"{what} {n}: " + " ".join(f"{x:.4f}" for x in ms[n])
                      + " ms (" + "; ".join(
                          f"{k} " + " ".join(f"{x:.4f}" for x in v)
                          for k, v in parts[n].items()) + ")")
            del sets, args, views, hc
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
