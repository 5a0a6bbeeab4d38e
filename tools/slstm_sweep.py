#!/usr/bin/env python3
"""Time variants of the committed ``slstm.cu`` in turns on one CUDA card,
its design's choices (``--sweep``), or an older ``slstm.cu`` against the
committed one.

    python3 tools/slstm_sweep.py
    python3 tools/slstm_sweep.py --sweep
    python3 tools/slstm_sweep.py --timeline
    git show <commit>:src/repro_torch/kernels/csrc/slstm.cu \\
        > build/old_slstm.cu
    python3 tools/slstm_sweep.py build/old_slstm.cu

Each source is built with nvcc (``-Xptxas -v``, its sLSTM kernels'
registers and spills printed) into ``build/repro_torch/slstm_sweep/``,
all at once, and called through its own ``slstm_launch``; its
``slstm_plan`` at head dim 256 (bf16) is printed beside it. At
chip_smoke.py's SLSTM_CASES at head dim 256 (path 11's round, its
4096-token prefill, the 4 x 512 serving prefill and the 4-row decode) it
prints whether each source's hs and final state lie within chip_smoke.py's
``check_slstm`` tolerance of the plain version, then each one's device
time per call (torch.profiler, as chip_smoke.py times it) with the time a
token step beside it.

With no argument: the committed source and each of VARIANTS, diagnostics
that leave out one part of a token's work (the recurrent product, the
gate arithmetic, the handoff of h: local stores only, no waits on the
mbarriers) or take the fast transcendentals, bf16, every source timed in
turn and then in the opposite order. Their results differ: they measure
the design's parts. With ``--sweep``: the committed source and each of
SWEEP, one of the design's choices edited (batch rows a cluster, columns
a block, threads a block, outputs a thread, tokens of x_pre loaded ahead,
one mbarrier a source block, how h is sent, how the block waits), in the
same turns; a variant that does not build is said so and left out. With
an older source: bf16 and f32, old, new, new, old,
twice, and whether the two sources' results are bit-equal. With
``--timeline``: the committed source with clock64() stamps at the points
of a token (POINTS) in two blocks of the first cluster, and the median
cycles between them at each shape of 128 tokens or more. The package
loads none of the variants. The card's name and power limit come first.
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
               if shape[3] == 256)
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
STORE = """      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(ra), "r"(__float_as_uint(v)), "r"(rb) : "memory");"""
SENDS = """        const int nxt = cur ^ 1;
        const uint32_t dst =
            smem_addr(hbuf + (nxt * R + gb) * DH + col0 + ge);
        const uint32_t bar = smem_addr(bars + nxt * NBAR);
#pragma unroll 4
        for (int i = 0; i < G::CS; ++i) send(dst, bar, (q + i) % G::CS, hv);"""
# a group of 4 lanes gathers its 4 columns by shuffles into one 16-byte
# st.async, lane j of the group sending to ranks q + j, q + j + 4, ...
VECTOR_SENDS = """        const unsigned group = 0xFu << (tid & 28);
        const uint32_t v0 = __float_as_uint(__shfl_sync(group, hv, 0, 4));
        const uint32_t v1 = __float_as_uint(__shfl_sync(group, hv, 1, 4));
        const uint32_t v2 = __float_as_uint(__shfl_sync(group, hv, 2, 4));
        const uint32_t v3 = __float_as_uint(__shfl_sync(group, hv, 3, 4));
        const int nxt = cur ^ 1;
        const uint32_t dst =
            smem_addr(hbuf + (nxt * R + gb) * DH + col0 + (ge & ~3));
        const uint32_t bar = smem_addr(bars + nxt * NBAR);
#pragma unroll 4
        for (int rk = ge & 3; rk < G::CS; rk += 4) {
          uint32_t ra, rb;
          const uint32_t rank = (q + rk) % G::CS;
          asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                       : "=r"(ra) : "r"(dst), "r"(rank));
          asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                       : "=r"(rb) : "r"(bar), "r"(rank));
          asm volatile(
              "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
              "[%0], {%1, %2, %3, %4}, [%5];" ::"r"(ra), "r"(v0), "r"(v1),
              "r"(v2), "r"(v3), "r"(rb) : "memory");
        }"""
SUMS = """    if (gate) {
      const float* ps = part + (cur * KS * R + gb) * NO + ge;
      float rec[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float s = ps[g * CB];
#pragma unroll
        for (int kk = 1; kk < KS; ++kk) s += ps[kk * R * NO + g * CB];
        rec[g] = s;
      }"""
# the splits summed in the same order by a thread an (output, row), in
# place, then a block barrier and four reads a gate thread
SPREAD_SUMS = """    if (tid < nb * NO) {
      float* po_ = part + cur * KS * R * NO + tid;
      float s = po_[0];
#pragma unroll
      for (int kk = 1; kk < KS; ++kk) s += po_[kk * R * NO];
      po_[0] = s;
    }
    __syncthreads();
    if (gate) {
      const float* ps = part + (cur * KS * R + gb) * NO + ge;
      float rec[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) rec[g] = ps[g * CB];"""
SEND_TAIL = """      if (t + 1 < S) {  // into buffer (t + 1) & 1 of every block
""" + SENDS + """
      }
    }
  }
  if (gate) {"""
# the gate threads leave h in the free half of part; after a block barrier
# every thread sends some of the (value, block) pairs
SPREAD_SEND_TAIL = """      part[(cur ^ 1) * KS * R * NO + gb * CB + ge] = hv;
    }
    __syncthreads();
    if (t + 1 < S) {
      const int nxt = cur ^ 1;
      const float* hl = part + nxt * KS * R * NO;
      const uint32_t bar = smem_addr(bars + nxt * NBAR);
      for (int i = tid; i < nb * CB * G::CS; i += NT) {
        const int e = i % (nb * CB), rk = i / (nb * CB);
        send(smem_addr(hbuf + (nxt * R + e / CB) * DH + col0 + e % CB),
             bar, (q + rk) % G::CS, hl[e]);
      }
    }
  }
  if (gate) {"""
# the wait with cluster-scope acquire semantics (an L1 invalidation each
# token) in place of the default
WAIT_ACQUIRE = ("mbarrier.try_wait.parity.shared::cta.b64",
                "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64")
WAIT = "  uint32_t done = 0;\n  while (!done) {"
ARM = """  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");"""
FAST = "namespace cg = cooperative_groups;"
ROWS = "constexpr int kRows = 2;"
COLS = "constexpr int kCols = 32;"
COLS1 = "constexpr int kCols1 = 16;"
THREADS = "constexpr int kThreads = 256;"
AHEAD = "constexpr int kAhead = 4;"
# one mbarrier a (buffer, source block): each thread waits on a source's
# barrier before its first row from that block, and a block's sends
# complete their own barrier in each peer
PER_SOURCE = [
    ("  static constexpr int NBAR = 1;", "  static constexpr int NBAR = CS;"),
    ("    if (t > 0) bar_wait(wait_bar, parity);\n", ""),
    ("#pragma unroll\n        for (int bb = 0; bb < NB; ++bb) {\n"
     "          const float4 h4",
     "        if (t > 0 && j % CB == 0) {\n"
     "          bar_wait(wait_bar + 8 * ((k * L + j) / CB), parity);\n"
     "        }\n#pragma unroll\n        for (int bb = 0; bb < NB; ++bb) {\n"
     "          const float4 h4"),
    ("const uint32_t bar = smem_addr(bars + nxt * NBAR);",
     "const uint32_t bar = smem_addr(bars + nxt * NBAR + q);")]
OUTS = "constexpr int kOuts = 2;"

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
    "handoff left out: local stores, no waits (diagnostic)": [
        (STORE, '      "st.shared.b32 [%0], %1;" ::"r"(addr), '
                '"r"(__float_as_uint(v)) : "memory");'),
        (WAIT, "  uint32_t done = 1;\n  while (!done) {"),
        (ARM, "  (void)bar;\n  (void)bytes;")],
}


def _set(line: str, value):
    """The edit of one of the constants above to ``value``."""
    word = str(value).lower() if isinstance(value, bool) else str(value)
    return line, re.sub(r"= \w+;", f"= {word};", line, count=1)


# the design's choices, each an edit of the committed source
SWEEP = {
    "B > 1 in groups of 1 row": [_set(ROWS, 1)],
    "B > 1 in groups of 4 rows": [_set(ROWS, 4)],
    "B > 1 in groups of 8 rows": [_set(ROWS, 8)],
    "B > 1 at 16 columns a block": [_set(COLS, 16)],
    "B > 1 at 16 columns a block in groups of 4 rows": [_set(COLS, 16),
                                                        _set(ROWS, 4)],
    "B = 1 at 32 columns a block": [_set(COLS1, 32)],
    "512 threads a block": [_set(THREADS, 512)],
    "1 output a thread": [_set(OUTS, 1)],
    "4 outputs a thread": [_set(OUTS, 4)],
    "x_pre 1 token ahead": [_set(AHEAD, 2)],
    "x_pre 7 tokens ahead": [_set(AHEAD, 8)],
    "one mbarrier a source block": PER_SOURCE,
    "h sent 4 columns a 16-byte st.async (shuffles)": [(SENDS, VECTOR_SENDS)],
    "h sent by every thread": [(SEND_TAIL, SPREAD_SEND_TAIL)],
    "splits summed by a thread an output": [(SUMS, SPREAD_SUMS)],
    "one waiter a block, the others on the block barrier": [(
        "    if (t > 0) bar_wait(wait_bar, parity);",
        "    if (t > 0) {\n"
        "      if (tid == NT - 1) bar_wait(wait_bar, parity);\n"
        "      __syncthreads();\n    }")],
    "cluster-scope acquire on the waits": [WAIT_ACQUIRE],
    "test_wait polling in place of try_wait": [(
        WAIT_ACQUIRE[0], "mbarrier.test_wait.parity.shared::cta.b64")],
}
F32, BF16 = 0, 1                                # the C entry point's dtype

# --timeline: clock64() stamps of thread 0 (a gate thread) in blocks 0 and
# CS - 1 of the first cluster at points of tokens 64-127, read back through
# an added entry point. The points, in a token's order:
POINTS = ("token start", "wait passed", "product done", "block barrier",
          "gate's inputs summed", "h computed", "h sent")
STAMP = ("if (tid == 0 && (blockIdx.x == 0 || blockIdx.x == G::CS - 1) && "
         "blockIdx.y == 0 && t >= 64 && t < 128) slstm_stamps[blockIdx.x "
         "? 1 : 0][{i}][t - 64] = clock64();\n")
TIMELINE = [
    (FAST, FAST + "\n__device__ long long slstm_stamps[2][8][64];\n"
     'extern "C" int slstm_read_stamps(long long* out) {\n'
     "  return static_cast<int>(cudaMemcpyFromSymbol(\n"
     "      out, slstm_stamps, sizeof(slstm_stamps)));\n}"),
    ("    const int cur = t & 1;\n",
     "    " + STAMP.format(i=0) + "    const int cur = t & 1;\n"),
    ("    with_rows<R>(nb, [&](auto nbc) {",
     "    " + STAMP.format(i=1) + "    with_rows<R>(nb, [&](auto nbc) {"),
    ("    cp_wait<kAhead - 2>();", "    " + STAMP.format(i=2)
     + "    cp_wait<kAhead - 2>();"),
    ("    // every wait on buffer cur has passed", "    "
     + STAMP.format(i=3) + "    // every wait on buffer cur has passed"),
    ("      const float lf = log_sigmoid(pf);", "      " + STAMP.format(i=4)
     + "      const float lf = log_sigmoid(pf);"),
    ("      hrow[static_cast<size_t>(t) * D] = from_f32<T>(hv);", "      "
     + STAMP.format(i=5)
     + "      hrow[static_cast<size_t>(t) * D] = from_f32<T>(hv);"),
    ("send(dst, bar, (q + i) % G::CS, hv);\n      }",
     "send(dst, bar, (q + i) % G::CS, hv);\n      }\n      "
     + STAMP.format(i=6))]


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
    """ptxas's lines for the sLSTM kernels: '<type, columns[, head dim[,
    rows[, save]]]>: registers, spills'."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            m = chip_smoke.SLSTM_KERNEL.search(line)
            name = m and ", ".join(
                ["bf16" if m.group(1) != "f" else "f32"]
                + [g for g in m.groups()[1:4] if g]
                + (["save"] if m.group(5) == "1" else []))
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
        self.lib.slstm_plan.argtypes = (i, i, v)

    def plan(self, dh: int, dtype: int) -> list:
        """The instance's slstm_plan fields (as many as the source fills,
        up to 64)."""
        plan = (ctypes.c_int * 64)(*([-1] * 64))
        build.check(self.lib.slstm_plan(dh, dtype, plan), "slstm sweep plan")
        return [x for x in plan if x != -1]

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


def timeline(fn: SLSTM, dev) -> None:
    """The cycles between the points of POINTS, each the median over tokens
    64-127 of one launch, in blocks 0 and CS - 1, at each shape."""
    stamps = (ctypes.c_longlong * (2 * 8 * 64))()
    for label, (B, S, H, dh) in SHAPES:
        if S < 128:
            continue
        args = chip_smoke.slstm_inputs(B, S, H, dh, torch.bfloat16, dev)
        for _ in range(3):
            fn(args)
        torch.cuda.synchronize()
        build.check(fn.lib.slstm_read_stamps(stamps), "slstm_read_stamps")
        st = torch.tensor(list(stamps), dtype=torch.float64).view(2, 8, 64)
        for blk, name in ((0, "block 0"), (1, "block CS - 1")):
            s = st[blk]
            steps = [(POINTS[i + 1], s[i + 1] - s[i])
                     for i in range(len(POINTS) - 1)]
            steps.append(("next token's start", s[0, 1:] - s[6, :-1]))
            steps.append(("a whole token", s[0, 1:] - s[0, :-1]))
            print(f"timeline {label} {(B, S, H, dh)} bf16 {name}: "
                  + "; ".join(f"to {p} {float(d.median()):.0f}"
                              for p, d in steps) + " cycles (medians)")


def agrees(fn: SLSTM, args, want) -> str:
    """Whether hs and the state lie within chip_smoke.check_slstm of the
    plain version's ``want``."""
    try:
        err = chip_smoke.check_slstm("slstm", fn(args), want)
    except chip_smoke.SmokeFailure as e:
        return f"OUTSIDE the tolerance ({str(e)[:80]})"
    return f"within the tolerance (max|Δ| {err:.3e})"


def main() -> int:
    arg = sys.argv[1] if len(sys.argv) == 2 else None
    sweep = arg == "--sweep"
    if arg == "--timeline":
        if not torch.cuda.is_available():
            print("slstm_sweep: no CUDA device available", file=sys.stderr)
            return 1
        out_dir = build.BUILD_ROOT / "slstm_sweep"
        out_dir.mkdir(parents=True, exist_ok=True)
        text = variant_source((build.CSRC / SOURCE).read_text(), TIMELINE)
        so, p = start_build("timeline", text, out_dir)
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(
                f"slstm_sweep: the timeline did not build:\n{log}")
        fn = SLSTM(so)
        fn.lib.slstm_read_stamps.argtypes = (ctypes.c_void_p,)
        timeline(fn, torch.device("cuda"))
        return 0
    old = None if sweep else arg
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
            n: variant_source(committed, e)
            for n, e in (SWEEP if sweep else VARIANTS).items()}}
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
    for n, fn in fns.items():
        print(f"plan {n} (dh 256, bf16): {fn.plan(256, BF16)}")
    dev = torch.device("cuda")
    names = list(fns)
    order = (["old", "new", "new", "old"] * 2 if old
             else names + names[::-1])
    for label, (B, S, H, dh) in SHAPES:
        for dtype in (torch.bfloat16, torch.float32) if old else (
                torch.bfloat16,):
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
