#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card, and hold every
kernel of that path against its plain PyTorch version there.

    python3 chip_smoke.py

Phases (each raises on failure; the exit code is 0 only if all pass):
  1. the card's name and power limit, torch and CUDA versions;
  2. build the kernels from src/repro_torch/kernels/csrc (one nvcc process
     per source, all at once) and print the seconds; beside them,
     flash_attention.cu, flash_attention_bwd.cu, zo_update.cu and
     threefry.cu with -Xptxas -v: the kernels' registers, shared memory,
     stack frames and spills are printed (the bf16 flash kernels and every
     flash backward kernel must not spill); the built library's
     SASS must hold HMMA (tensor-core) instructions in the bf16 flash
     kernels (cuobjdump -sass; the check says so if the toolkit has no
     cuobjdump), the zo kernels' SASS mix by opcode class is printed per
     gaussian, and the threefry kernels' per element (what a thread of a
     whole run of 8 elements executes, over 8, each element's w >= 5 arm
     counted at the chance that a warp enters it: all instructions, those
     on the half-rate ALU pipe and on MUFU), beside the function's own
     issue slots, from which the threefry row's bound comes;
  3. each kernel against its plain version on the card: max |Δ|, kernel
     ms, plain ms (and the library call's ms where one PyTorch call
     computes the same function), at a set of parity shapes and at the
     shapes of the paths below; the counter noise u bit-equal to the plain
     version's, and both Box-Muller factors bit-equal over all 2^32 hash
     values to libdevice's and to the plain version's torch ops
     (zo_update.noise_exhaustive_check); the threefry bits, gaussian and
     updates bit-equal to the plain version's at ragged, aligned and
     misaligned leaves and across 2^32 in the counter, the gaussian over
     all 2^23 values of its uniform
     (threefry.normal_table_check), and its sum of squares within 1e-5; the
     pair norm against two plain norms at the qwen3-14b qk-norm shapes;
     the backward kernels (flash_attention_bwd, bf16 and f32, at path 5's
     shape and qwen3-14b's with GQA 40/8, causal and with a window, its
     forward's lse beside it; rmsnorm_bwd at the qwen3-14b block and
     qk-norm shapes) against their plain versions, f32 within 1e-5 and
     bf16 within one bf16 ulp of each gradient's largest magnitude, with
     the autograd backward of scaled_dot_product_attention and of
     F.rms_norm timed beside them;
  4. small f32 rounds on the card against the same rounds on the CPU
     (MU-SplitFed under counter, gaussian and sphere noise, dense and
     seed_replay; vanilla SplitFed; GAS with a stale client; FedAvg with
     SGD and AdamW, FedLoRA), then the five main paths through the
     training driver (``launch.train``:
     setup, then run_engine, which runs engine.run_rounds), each with every
     kernel launch counter set to 0 just before and read just after, and
     each followed by one more round under torch.profiler for the device
     time by kernel:
       - olmo-1b at its full config (LayerNorm; no rmsnorm), counter
         noise, full participation, 3 rounds, one a chunk;
       - qwen3-14b at its full published width (RMSNorm, qk-norm, GQA
         40/8), its depth cut to 16 of 40 layers, as the first. A ZO
         round holds about 3.9x the parameter bytes (olmo-1b: 9.18 GiB
         for 1.28 B parameters), so the full 14.8 B model (27.5 GiB in
         bf16) would need about 106 GiB; 16 layers are 6.84 B
         parameters;
       - the reference driver's default run: olmo-1b at its full config
         with its default threefry gaussian noise and dense aggregation,
         4 rounds in chunks of 2, on a straggler
         schedule (4 clients, participation 0.75, exponential delays) with
         adaptive tau; masks, simulated times and tau decisions printed;
       - the paper's comparison: paper-opt-1.3b at its full config (24
         layers, d_model 2048, 32 heads of 64, LayerNorm, GELU), 4 clients
         at participation 0.75, straggler scale 3.0, t_server 0.25, t_gen
         2.0, 4 rounds in chunks of 2, once each for MU-SplitFed (adaptive
         tau on the measured clock, with telemetry, a JSONL run log and a
         span trace), vanilla SplitFed and GAS (seed replay, counter
         noise) on the same schedule; each algorithm's simulated clock,
         round seconds, peak memory and losses printed;
       - path 5, the first-order side of Fig. 4: FedAvg and FedLoRA with
         the reference driver's defaults on path 4's model, flags and
         schedule, through the flash forward and backward kernels (2·M·24
         forwards and M·24 backwards a round, checked); then one FedAvg
         round of qwen3-14b at full width, 4 of 40 layers, whose backward
         runs the rmsnorm backward (4·layers + 1 launches a client);
  5. one JSON line with every kernel's numbers (launches summed over the
     paths), then the result line.

Timing: CUDA events around repeated launches after a warm-up (for the
noise kernels at the path leaves, with the SM clock read by nvidia-smi
while they run, and torch.add(x, 1.0) on the same leaf beside them as the
floor of a streaming sweep). The rmsnorm
and flash cases, whose kernels take microseconds to tens of microseconds,
are timed by device time per call under torch.profiler instead (a loop of
such launches is paced by the host), cycling through copies of their
inputs that together exceed the 50 MB L2, so each launch reads them from
device memory; the event-timed loop is printed beside them, labelled as
host-paced. Bounds: the larger of
bytes / 3.35 TB/s and operations / the card's peak for their type (989
TFLOP/s bf16 tensor cores for attention on bf16 inputs, 67 TFLOP/s on the
f32 CUDA cores for the noise kernels and the norm); published H100 SXM
numbers at a 700 W limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16_tensor": 989e12, "f32_core": 67e12}
# operations per counter gaussian and record, counted from the formula:
# two murmur3 finalizers (10 integer ops each), the row mix and salt (3),
# two int->float conversions and the (h+1)·2^-32 scaling (4), then log,
# ×-2, sqrt, ×2π, cos and the product (6, a transcendental as one), and the
# multiply-add into the sum (2)
GAUSS_OPS = 35
# operations per RMSNorm element: the square-and-add, and the two products
NORM_OPS = 4
PATH_ARGV = ["--clients", "2", "--tau", "2", "--batch", "1", "--seq", "512",
             "--rounds", "3", "--chunk-size", "1", "--aggregation",
             "seed_replay"]
OLMO_ARGV = ["--arch", "olmo-1b", *PATH_ARGV]
QWEN_ARGV = ["--arch", "qwen3-14b", *PATH_ARGV]
QWEN_LAYERS = 16            # of 40: the depth cut of the qwen3-14b path
# path 3: the reference driver's default run (gaussian noise, dense
# aggregation) on a straggler schedule with adaptive tau
DRIVER_ARGV = ["--arch", "olmo-1b", "--clients", "4", "--tau", "2",
               "--batch", "1", "--seq", "512", "--rounds", "4",
               "--chunk-size", "2", "--participation", "0.75",
               "--straggler-scale", "2.0", "--t-server", "0.5", "--t-gen",
               "0.3", "--t-comm", "0.2", "--adaptive-tau", "--tau-max", "4"]
# path 4: the paper's comparison (Fig. 2's T_SERVER, T_GEN and straggler
# scale) on paper-opt-1.3b at its full config, one schedule, three
# algorithms
PAPER_ARGV = ["--arch", "paper-opt-1.3b", "--clients", "4", "--batch", "1",
              "--seq", "512", "--rounds", "4", "--chunk-size", "2",
              "--participation", "0.75", "--straggler-scale", "3.0",
              "--t-server", "0.25", "--t-gen", "2.0"]
L2_BYTES = 50 * 2 ** 20
# the first-order path 5: the reference driver's FO baselines on the
# paper's model and schedule, and one FedAvg round of qwen3-14b at full
# width with its depth cut to QWEN_FO_LAYERS (its RMSNorm backward inside
# a real backward)
QWEN_FO_LAYERS = 4
QWEN_FO_ARGV = ["--arch", "qwen3-14b", "--clients", "2", "--batch", "1",
                "--seq", "512", "--rounds", "1", "--chunk-size", "1",
                "--algorithm", "fedavg"]
PORT_KERNEL = re.compile(r"(zo_update|zo_replay|flash_fwd|flash_fwd_bf16|"
                         r"flash_bwd_delta|flash_bwd_dkdv|flash_bwd_dq|"
                         r"flash_bwd_delta_bf16|flash_bwd_dkdv_bf16|"
                         r"flash_bwd_dq_bf16|"
                         r"rmsnorm_block|rmsnorm_pair|rmsnorm_bwd_block|"
                         r"rmsnorm_bwd_rows|rmsnorm_dscale_partial|"
                         r"threefry_update|threefry_sumsq)_kernel<[^>]*>|"
                         r"threefry_sumsq_kernel|rmsnorm_dscale_reduce_kernel|"
                         r"flash_bwd_dkdv_sum_kernel")
# operations of the flash backward per unmasked (query, key) pair: S, dP,
# dV, dK and dQ at 2·d each; of the RMSNorm backward per element
FLASH_BWD_OPS_PER_D = 10
NORM_BWD_OPS = 10


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, iters: int) -> float:
    fn()                                            # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_cold_ms(fn, inputs, iters: int) -> float:
    """Like time_ms, but launch i takes inputs[i % len(inputs)], copies
    that together exceed L2, so each launch reads its input from device
    memory as a caller that just wrote it elsewhere would."""
    fn(inputs[0])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(inputs[i % len(inputs)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, inputs, iters: int, attempts: int = 3,
              by_kernel: dict | None = None) -> float:
    """Device time per call: the time of every CUDA kernel that ``iters``
    calls launch, under torch.profiler, over ``iters``. A call whose host
    side outlasts its kernels (a norm of a few microseconds behind a
    Python wrapper) is not charged for the device's idle gaps, which
    time_cold_ms counts. A profiling session that recorded no device time
    at all (it happened once in three runs of this script, to the library
    attention call) is run again, up to ``attempts`` sessions, and said
    so; 0 comes back only if every session recorded nothing, and the
    callers fail on it. A session whose count of kernels is not a multiple
    of ``iters`` lost some of them (it happened once, to the flash
    backward, which read half its time): it too is run again, and the
    last one is kept with a warning if none was whole. ``by_kernel``, if
    given, receives each kernel's device time per call, by name."""
    from torch.profiler import ProfilerActivity, profile
    fn(inputs[0])
    torch.cuda.synchronize()
    total = 0
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(inputs[i % len(inputs)])
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        total = sum(e.self_device_time_total for e in kernels)
        count = sum(e.count for e in kernels)
        if by_kernel is not None:
            by_kernel.clear()
            by_kernel.update((e.key, e.self_device_time_total / 1e3 / iters)
                             for e in kernels)
        if total > 0 and count % iters == 0:
            return total / 1e3 / iters
        print(f"device_ms: session {attempt} of {attempts} recorded "
              + (f"{count} kernels in {iters} calls" if total > 0
                 else "no device time"))
    if total > 0:
        print("device_ms: WARNING: no session recorded every kernel; the "
              "last one's time is kept")
    return total / 1e3 / iters


def smi(query: str) -> list:
    """One nvidia-smi reading of the card, e.g. smi("clocks.sm,power.draw")
    -> ["1980", "412.51"] (no units)."""
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()
    return [v.strip() for v in out[0].split(",")]


def time_ms_clocked(fn, min_ms: float = 400.0):
    """time_ms over enough launches to keep the card busy for about min_ms,
    with the SM clock (MHz) and power draw (W) read by nvidia-smi while
    they run. Returns (ms a call, clock, draw)."""
    iters = max(5, math.ceil(min_ms / max(time_ms(fn, 2), 1e-3)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    clock, draw = smi("clocks.sm,power.draw")  # the launches are in flight
    end.synchronize()
    return start.elapsed_time(end) / iters, float(clock), float(draw)


def issued_per_gaussian(ms: float, clock_mhz: float, gaussians: float):
    """Instructions a thread could have issued per gaussian in ``ms`` at
    ``clock_mhz``: every SM's 4 schedulers issuing one warp instruction a
    cycle, over the gaussians' warps (32 each). Equal to the instructions
    issued per gaussian when the kernel is issue-bound, above it else."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return ms * 1e-3 * clock_mhz * 1e6 * sms * 4 / (gaussians / 32)


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max())


def check_close(name: str, got: torch.Tensor, want: torch.Tensor,
                f32_tol: float) -> float:
    """f32: max |Δ| <= f32_tol. bf16: every element within one bf16 ulp of
    the plain value (|Δ| <= 2^-7·|want| + 1e-5)."""
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{name}: {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
    require(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite")
    d = (got.float() - want.float()).abs()
    if got.dtype == torch.bfloat16:
        ok = bool((d <= 2.0 ** -7 * want.float().abs() + 1e-5).all())
    else:
        ok = float(d.max()) <= f32_tol
    require(ok, f"{name}: max |Δ| {float(d.max()):.3e} outside tolerance")
    return float(d.max())


def bound(nbytes: float, ops: float, peak: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[peak] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    require(bool(out), "nvidia-smi printed no card")
    print(out[0])
    print(f"torch {torch.__version__}  CUDA {torch.version.cuda}  "
          f"device {torch.cuda.get_device_name(0)}  "
          f"count {torch.cuda.device_count()}")


def phase_build():
    """Build the package's kernel library and, at the same time, -Xptxas -v
    builds of flash_attention.cu, zo_update.cu and threefry.cu. Returns the
    zo kernels' SASS instructions per gaussian and the threefry kernels'
    per element."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    # registers, shared memory, stack frames and spills, from ptxas
    (build.BUILD_ROOT / "ptxas").mkdir(parents=True, exist_ok=True)
    ptxas = {src: subprocess.Popen(
        [build.nvcc_path(), *build.ARCH_FLAGS, *build.BASE_FLAGS, "-Xptxas",
         "-v", "-c", str(build.CSRC / src), "-o",
         str(build.BUILD_ROOT / "ptxas" / (Path(src).stem + ".o"))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in ("flash_attention.cu", "flash_attention_bwd.cu",
                    "zo_update.cu", "threefry.cu")}
    try:
        build.library()
    finally:
        ptxas_out = {src: p.communicate()[0] for src, p in ptxas.items()}
    for src, p in ptxas.items():
        require(p.returncode == 0,
                f"-Xptxas -v build of {src} failed:\n{ptxas_out[src]}")
    print(f"build: {time.perf_counter() - t0:.1f}s  "
          f"({build.compile_library().relative_to(ROOT)})")
    report_ptxas(ptxas_out["flash_attention.cu"])
    report_ptxas_bwd(ptxas_out["flash_attention_bwd.cu"])
    lib = build.library()
    for d in (64, 128):
        print(f"flash_fwd_bf16_kernel<{d}>: dynamic shared memory "
              f"{lib.flash_attention_smem_bytes(d, 1)} bytes, "
              f"{lib.flash_attention_blocks_per_sm(d, 1)} blocks per SM")
    check_sass(build.compile_library())
    return (zo_sass_report(build.compile_library(), ptxas_out["zo_update.cu"]),
            threefry_sass_report(build.compile_library(),
                                 ptxas_out["threefry.cu"]))


FLASH_KERNEL = re.compile(r"(flash_fwd(?:_bf16)?_kernel)ILi(\d+)E")


def report_ptxas(out: str) -> None:
    """Print ptxas's lines for each flash kernel; the bf16 kernels (the
    tensor-core ones, on both paths) must not spill."""
    name, seen = None, set()
    for line in out.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            m = FLASH_KERNEL.search(line)
            name = f"{m.group(1)}<{m.group(2)}>" if m else None
            continue
        if name is None or not line.strip():
            continue
        print(f"ptxas {name}: {line.split(':', 1)[-1].strip()}")
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", line)
        if spills and "bf16" in name:
            seen.add(name)
            require(spills.groups() == ("0", "0"),
                    f"{name} spills registers: {line.strip()}")
    require(seen == {"flash_fwd_bf16_kernel<64>",
                     "flash_fwd_bf16_kernel<128>"},
            f"ptxas -v reported no spill line for the bf16 flash kernels "
            f"(found {sorted(seen)})")


# the backward's kernels: f32 and bf16 (``_bf16``) of each head dim, and
# the bf16 dK/dV partials' sum
BWD_KERNEL = re.compile(r"(flash_bwd_(?:delta|dkdv|dq)(?:_bf16)?_kernel)"
                        r"ILi(\d+)E|(flash_bwd_dkdv_sum_kernel)")
BWD_KERNELS = 13
# the bf16 flash kernels that must run on the tensor cores (HMMA in SASS)
TC_KERNEL = re.compile(r"(flash_(?:fwd|bwd_dkdv|bwd_dq)_bf16_kernel)"
                       r"ILi(\d+)E")
TC_KERNELS = 6


def bwd_name(m) -> str:
    return m.group(3) or f"{m.group(1)}<{m.group(2)}>"


def report_ptxas_bwd(out: str) -> None:
    """Print ptxas's registers, shared memory and spills for each flash
    backward kernel; none may spill."""
    name, seen = None, set()
    for line in out.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            m = BWD_KERNEL.search(line)
            name = bwd_name(m) if m else None
            continue
        if name is None or not line.strip():
            continue
        print(f"ptxas {name}: {line.split(':', 1)[-1].strip()}")
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", line)
        if spills:
            seen.add(name)
            require(spills.groups() == ("0", "0"),
                    f"{name} spills registers: {line.strip()}")
    require(len(seen) == BWD_KERNELS, f"ptxas -v reported spill lines for "
            f"{sorted(seen)}, not the {BWD_KERNELS} flash backward kernels")


def check_sass(lib: Path) -> None:
    """The bf16 flash kernels (the forward, and the backward's dK/dV and dQ
    kernels) must run on the tensor cores: their SASS in the built library
    holds HMMA instructions."""
    from repro_torch.kernels import build
    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    if not tool.exists():
        print(f"SASS check skipped: the toolkit has no cuobjdump (looked "
              f"for {tool}); HMMA in the bf16 flash kernels not verified")
        return
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts = {}
    for section in sass.split("Function : ")[1:]:
        m = TC_KERNEL.search(section.split("\n", 1)[0])
        if m:
            counts[f"{m.group(1)}<{m.group(2)}>"] = section.count("HMMA")
    print(f"SASS ({tool.name} -sass): HMMA instructions {counts}")
    require(len(counts) == TC_KERNELS and min(counts.values()) > 0,
            f"no HMMA in the SASS of some bf16 flash kernel: {counts}")


ZO_KERNEL = re.compile(r"(zo_(?:update|replay)_kernel)I(f|13__nv_bfloat16)E")
SASS_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]\s+)?"
                       r"([A-Z][A-Z0-9_]*)([^;]*);")
# opcode classes of the SASS mix (opcodes not listed fall under "other")
SASS_CLASSES = {
    "fp32": ("FFMA", "FMUL", "FADD", "FSEL", "FSETP", "FMNMX", "FCHK"),
    "int": ("IMAD", "IADD3", "LOP3", "SHF", "PRMT", "LEA", "SEL", "ISETP",
            "IABS", "IMNMX", "BMSK", "SGXT", "FLO", "POPC"),
    "conversion": ("I2F", "F2I", "I2FP", "F2IP", "FRND", "F2F"),
    "mufu": ("MUFU",),
    "branch": ("BRA", "BSSY", "BSYNC", "CALL", "RET", "BREAK", "WARPSYNC",
               "JMP", "EXIT"),
    "local": ("LDL", "STL"),
}


def sass_name(m) -> str:
    """kernel<type> from a ZO_KERNEL match."""
    return f"{m.group(1)}<{'f32' if m.group(2) == 'f' else 'bf16'}>"


def sass_functions(sass: str, pattern, name_of=sass_name) -> dict:
    """{name: [(address, opcode, operands), ...]} for each function of a
    ``cuobjdump -sass`` listing whose mangled name ``pattern`` matches;
    the name is name_of(match)."""
    out = {}
    for section in sass.split("Function : ")[1:]:
        head, body = section.split("\n", 1)
        m = pattern.search(head)
        if m:
            out[name_of(m)] = [(int(a, 16), op, rest.strip())
                               for a, op, rest in SASS_INSN.findall(body)]
    return out


def sass_mix(insns) -> dict:
    """Instruction counts by class, and by opcode within each class."""
    mix = {}
    for _, op, _ in insns:
        cls = next((c for c, ops in SASS_CLASSES.items() if op in ops),
                   "other")
        mix.setdefault(cls, {}).setdefault(op, 0)
        mix[cls][op] += 1
    return {c: {"total": sum(v.values()), **v} for c, v in mix.items()}


def branch_target(op: str, rest: str):
    """The address a BRA jumps to, else None."""
    t = re.match(r"(?:\S+\s+)?0x([0-9a-f]+)", rest)
    return int(t.group(1), 16) if op == "BRA" and t else None


def rsq_count(insns) -> int:
    """MUFU.RSQ instructions: every gaussian takes exactly one (the square
    root's seed)."""
    return sum(op == "MUFU" and ".RSQ" in rest for _, op, rest in insns)


def per_gaussian(insns) -> tuple:
    """The static work per counter gaussian: the body of the loop over
    records (the innermost loop, a backward branch's range, that holds
    MUFU.RSQ instructions), or the kernel up to its last EXIT where it has
    no such loop. Code the fast path branches over (libdevice's slow paths)
    is counted too. Returns (instructions, gaussians, the instructions)."""
    loops = []
    for a, op, rest in insns:
        t = branch_target(op, rest)
        if t is not None and t < a:
            body = [i for i in insns if t <= i[0] <= a]
            if rsq_count(body):
                loops.append((t, a, body))
    inner = [b for s, e, b in loops
             if not any(s <= s2 and e2 <= e and (s2, e2) != (s, e)
                        for s2, e2, _ in loops)]
    if inner:
        body = max(inner, key=rsq_count)
    else:
        last_exit = max(a for a, op, _ in insns if op == "EXIT")
        body = [i for i in insns if i[0] <= last_exit]
    return len(body), rsq_count(body), body


def fast_path(body):
    """``body`` less the code a forward branch jumps over where that code
    holds a slow path's marks (a CALL, a double-precision product, local
    memory or a loop) and no gaussian: libdevice's Payne-Hanek reduction
    and sqrt.rn's out-of-line fix-up, which the noise never takes."""
    cold = set()
    for a, op, rest in body:
        t = branch_target(op, rest)
        if t is None or t <= a:
            continue
        skipped = [i for i in body if a < i[0] < t]
        slow = any(o in ("CALL", "DMUL", "LDL", "STL") or
                   (branch_target(o, r) or x) < x for x, o, r in skipped)
        if slow and not rsq_count(skipped):
            cold.update(i[0] for i in skipped)
    return [i for i in body if i[0] not in cold]


def zo_sass_report(lib: Path, ptxas_out: str) -> dict:
    """Print each zo kernel's registers and stack frame (from ptxas -v)
    and its SASS mix: the whole kernel, and the work per gaussian. Returns
    {kernel: instructions per gaussian on the fast path}."""
    from repro_torch.kernels import build
    name = None
    for line in ptxas_out.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            m = ZO_KERNEL.search(line)
            name = sass_name(m) if m else None
        elif name and line.strip() and ("stack" in line or "registers" in line):
            print(f"ptxas {name}: {line.split(':', 1)[-1].strip()}")
    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    require(tool.exists(), f"no cuobjdump at {tool}: the zo kernels' SASS "
            f"cannot be read")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    per = {}
    for name, insns in sorted(sass_functions(sass, ZO_KERNEL).items()):
        n, g, body = per_gaussian(insns)
        require(g > 0, f"{name}: no MUFU.RSQ in its SASS")
        fast = fast_path(body)
        per[name] = len(fast) / g
        print(f"SASS {name}: {len(insns)} instructions "
              f"{ {c: v['total'] for c, v in sass_mix(insns).items()} }; "
              f"per gaussian {n / g:.1f} ({n} over {g}), of them on the "
              f"fast path {len(fast) / g:.1f}: {sass_mix(fast)}")
    require(set(per) == {f"zo_{k}_kernel<{t}>" for k in ("update", "replay")
                         for t in ("f32", "bf16")},
            f"SASS: expected both zo kernels in f32 and bf16, found "
            f"{sorted(per)}")
    return per


TF_KERNEL = re.compile(r"(threefry_(?:update|sumsq)_kernel)"
                       r"(?:I(f|13__nv_bfloat16)E)?")
# opcodes that issue to the ALU pipe, 16 lanes a scheduler: a warp's
# instruction holds it two cycles (FP32 products and IMAD go to the FMA
# pipe at full rate; MUFU takes eight cycles a warp)
ALU_PIPE = ("IADD3", "LOP3", "SHF", "LEA", "ISETP", "SEL", "PRMT", "FSEL",
            "FSETP", "FMNMX", "IMNMX", "IABS", "SGXT", "BMSK", "PLOP3",
            "FLO", "POPC")


def tf_name(m) -> str:
    t = {"f": "<f32>", "13__nv_bfloat16": "<bf16>", None: ""}[m.group(2)]
    return m.group(1) + t


# a SASS instruction with its guard predicate: (address, guard, opcode,
# operands), the guard "" where there is none
TF_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]\s+)?"
                     r"([A-Z][A-Z0-9_]*)([^;]*);")


def tf_instructions(listing: str) -> list:
    """[(address, guard, opcode, operands)] of one function's SASS."""
    return [(int(a, 16), g.strip(), op, rest.strip())
            for a, g, op, rest in TF_INSN.findall(listing)]


def tf_cold(insns) -> bool:
    """Code a thread of a whole run branches over: it holds a MUFU (the w
    >= 5 arm's square root), a CALL (sqrt's slow path) or a global access
    narrower than 16 bytes (the element-by-element path)."""
    return any(op in ("MUFU", "CALL") or
               (op in ("LDG", "STG") and ".128" not in rest)
               for _, _, op, rest in insns)


def tf_walk(insns, start: int, stop: int):
    """The instructions a thread of a whole run executes from address
    ``start`` up to address ``stop`` (exclusive) or an unguarded EXIT:
    it follows unconditional branches, takes a guarded forward branch
    where the code it skips is cold (tf_cold) and falls through
    otherwise. Returns (executed, arms): arms are the skipped stretches
    that hold a MUFU, the w >= 5 arm of each element."""
    index = {a: k for k, (a, *_) in enumerate(insns)}
    k, done, arms = index[start], [], []
    while k < len(insns) and insns[k][0] < stop:
        a, guard, op, rest = insns[k]
        done.append(insns[k])
        if op == "EXIT" and not guard:
            break
        t = branch_target(op, rest)
        if t is not None and t > a:
            skipped = [i for i in insns if a < i[0] < t]
            if not guard or tf_cold(skipped):
                if guard and any(i[2] == "MUFU" for i in skipped):
                    arms.append(skipped)
                k = index[t]
                continue
        k += 1
    return done, arms


def tf_per_element(insns, share: float) -> dict:
    """The SASS a thread spends per element on a whole run: one pass of
    the element loop (the innermost loop holding a MUFU, the sum kernel's
    grid-stride loop over runs), or the whole kernel where there is none;
    divided by the elements of a pass (one w >= 5 arm each). Each arm is
    counted at the chance that a warp enters it, 1 - (1 - share)^32.
    Returns {"instructions", "alu", "mufu", "elements", "hot", "arm",
    "enter", "mix"}."""
    loops = [(t, a) for a, _, op, rest in insns
             if (t := branch_target(op, rest)) is not None and t < a
             and any(i[2] == "MUFU" for i in insns if t <= i[0] <= a)]
    if loops:
        t, a = min(loops, key=lambda ta: ta[1] - ta[0])
        hot, arms = tf_walk(insns, t, a + 1)
    else:
        hot, arms = tf_walk(insns, insns[0][0], float("inf"))
    require(bool(arms), "no w >= 5 arm in the SASS")
    arm = [tf_walk(insns, s[0][0], s[-1][0] + 1)[0] for s in arms]
    enter = 1.0 - (1.0 - share) ** 32
    n = len(arms)

    def count(pred):
        return (sum(map(pred, hot))
                + enter * sum(sum(map(pred, body)) for body in arm)) / n
    return {"instructions": count(lambda i: True),
            "alu": count(lambda i: i[2] in ALU_PIPE),
            "mufu": count(lambda i: i[2] == "MUFU"), "elements": n,
            "hot": len(hot), "arm": sum(map(len, arm)) / n, "enter": enter,
            "mix": sass_mix([(a, op, rest) for a, _, op, rest in hot])}


def threefry_sass_report(lib: Path, ptxas_out: str) -> dict:
    """Print the threefry kernels' registers, stack and spills (from ptxas
    -v; none may spill) and their SASS per element (tf_per_element):
    instructions, those on the ALU pipe and on MUFU. Returns {kernel:
    (instructions, alu, mufu)} an element."""
    from repro_torch.kernels import build
    name = None
    for line in ptxas_out.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            m = TF_KERNEL.search(line)
            name = tf_name(m) if m else None
        elif name and line.strip() and ("stack" in line or "registers" in line):
            print(f"ptxas {name}: {line.split(':', 1)[-1].strip()}")
            spills = re.search(r"(\d+) bytes spill stores", line)
            require(spills is None or spills.group(1) == "0",
                    f"{name} spills registers: {line.strip()}")
    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    require(tool.exists(), f"no cuobjdump at {tool}: the threefry kernels' "
            f"SASS cannot be read")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    share = tf_sqrt_share()
    per = {}
    for section in sass.split("Function : ")[1:]:
        head, body = section.split("\n", 1)
        m = TF_KERNEL.search(head)
        if not m:
            continue
        name = tf_name(m)
        insns = tf_instructions(body)
        c = tf_per_element(insns, share)
        per[name] = (c["instructions"], c["alu"], c["mufu"])
        print(f"SASS {name}: {len(insns)} instructions; a whole run of "
              f"{c['elements']} elements executes {c['hot']}, and each "
              f"element's w >= 5 arm of {c['arm']:.1f} is entered by a warp "
              f"at {c['enter']:.4f}: {c['instructions']:.2f} an element, "
              f"{c['alu']:.2f} on the ALU pipe, {c['mufu']:.3f} MUFU; the "
              f"run's mix {c['mix']}")
    require({"threefry_update_kernel<bf16>", "threefry_update_kernel<f32>",
             "threefry_sumsq_kernel"} <= set(per),
            f"SASS: threefry kernels not found, found {sorted(per)}")
    return per


def issue_bound_ms(n: float, per_element, clock_mhz: float) -> float:
    """The least time n elements take at ``per_element`` = (instructions,
    alu, mufu) an element: a warp of 32 elements holds its scheduler
    max(instructions, 2·alu, 8·mufu) cycles, 4 schedulers an SM, every SM
    at clock_mhz."""
    total, alu, mufu = per_element
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cycles = max(total, 2 * alu, 8 * mufu)
    return n / 32 * cycles / (sms * 4 * clock_mhz * 1e6) * 1e3


# Issue slots per threefry gaussian, counted from the function, not from
# the kernel's SASS (a transcendental as one, as for the counter gaussian):
# the cipher's 20 rounds of add, rotate and xor, its five key injections of
# two adds, the two words' first key adds and the final xor (73: 32 adds,
# which can go to the FMA pipe as IMAD, and 41 rotates and xors on the
# half-rate ALU pipe); the uniform's shift and or (ALU), minus 1, times 2,
# plus lo and max (ALU) (6); erfinv's x·-x, log1p (MUFU), w < 5 (ALU),
# w - 2.5, 8 multiply-adds and p·x (13); times sqrt 2 (1). sqrt(w) and its
# -3 replace w - 2.5 only where w >= 5 (TF_SQRT_SHARE of the uniforms).
TF_OPS, TF_ALU, TF_MUFU = 73 + 6 + 13 + 1, 41 + 3 + 1, 1
TF_MODE_OPS = {"update": 6,   # load, widen, times c, plus x, narrow, store
               "sumsq": 1}    # z·z + acc


def tf_sqrt_share() -> float:
    """The share of the 2^23 uniforms the threefry kernel draws from whose
    w = -log1p(-x²) is >= 5, the branch that takes sqrt(w)."""
    import numpy as np
    f = np.arange(1 << 23, dtype=np.float32) / np.float32(1 << 23)
    lo = np.nextafter(np.float32(-1), np.float32(0))
    x = np.maximum(lo, f * np.float32(2) + lo).astype(np.float64)
    return float(np.mean(-np.log1p(-x * x) >= 5.0))


def tf_bound_ms(n: float, mode: str, clock_mhz: float, share: float):
    """The threefry kernel's least time for n elements in ``mode``: the
    function's own issue slots (TF_OPS) at the card's issue rate."""
    per_element = (TF_OPS + TF_MODE_OPS[mode] + 2 * share, TF_ALU,
                   TF_MUFU + share)
    return issue_bound_ms(n, per_element, clock_mhz), per_element[0]


def phase_zo(dev, zo_sass) -> dict:
    """The noise kernels against their plain version: parity leaves (f32
    and bf16, row offsets, a misaligned leaf with a ragged end, replays
    past one shared-memory tile of records), u bit-equal to the plain
    version, both Box-Muller factors bit-equal over all 2^32 hash values to
    libdevice's and to the plain version's torch ops, and the main path's
    largest leaves timed with the SM clock read beside them, torch.add(x,
    1.0) on the same leaf (one read and one write) beside them as the
    card's floor for a streaming sweep."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.zo_update import (noise_exhaustive_check,
                                               zo_replay_flat, zo_update_flat)
    gen = torch.Generator(device=dev).manual_seed(0)
    res = {"zo_update": {"err": 0.0}, "zo_replay": {"err": 0.0}}
    seed = 0x2545F491
    coeff = torch.full((1,), 0.37, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(8192, 1024, generator=gen, device=dev).to(dtype)
        for offset in (0, 37):
            name = f"zo_update {str(dtype)[6:]} (8192,1024) offset {offset}"
            got = zo_update_flat(x, seed, coeff, offset=offset)
            want = ref.zo_update_ref(x, seed, coeff, offset)
            err = check_close(name, got, want, 1e-5)
            res["zo_update"]["err"] = max(res["zo_update"]["err"], err)
            print(f"{name}: max|Δ| {err:.3e}  kernel "
                  f"{time_ms(lambda: zo_update_flat(x, seed, coeff, offset=offset), 20):.4f} ms  "
                  f"plain {time_ms(lambda: ref.zo_update_ref(x, seed, coeff, offset), 2):.4f} ms")
        # a leaf at an odd element offset into its buffer (no 16-byte
        # accesses) with a ragged end
        buf = torch.randn(1000004, generator=gen, device=dev).to(dtype)
        x = buf[1:]
        name = f"zo_update {str(dtype)[6:]} misaligned ({x.numel()},)"
        err = check_close(name, zo_update_flat(x, seed, coeff, offset=3),
                          ref.zo_update_ref(x, seed, coeff, 3), 1e-5)
        res["zo_update"]["err"] = max(res["zo_update"]["err"], err)
        seeds = torch.randint(0, 2 ** 32, (5,), generator=torch.Generator()
                              .manual_seed(5)).numpy().astype("uint32")
        c = torch.randn(5, generator=gen, device=dev) * 0.01
        err_r = check_close(name.replace("update", "replay") + " N=5",
                            zo_replay_flat(x, seeds, c, offset=3),
                            ref.zo_replay_ref(x, seeds, c, 3), 1e-5)
        res["zo_replay"]["err"] = max(res["zo_replay"]["err"], err_r)
        print(f"{name}: max|Δ| {err:.3e}; zo_replay N=5 {err_r:.3e}")

    # the noise alone (0 + 1·u) against the plain version
    z = torch.zeros(8192, 1024, device=dev)
    one = torch.ones(1, device=dev)
    u = zo_update_flat(z, seed, one)
    u_plain = ref.zo_update_ref(z, seed, one)
    print(f"noise u: max|Δu| vs plain {max_err(u, u_plain):.3e}")
    require(torch.equal(u, u_plain),
            "noise u: the kernel's u is not bit-equal to the plain version's")
    del z, u, u_plain
    for reference, what in (
            ("libdevice", "libdevice's sqrtf(-2 logf(u1)) and cosf(2 pi u2) "
                          "compiled beside the kernels"),
            ("plain", "the plain version's torch.sqrt(-2 torch.log(u1)) and "
                      "torch.cos(2 pi u2)")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        check = noise_exhaustive_check(dev, reference)
        print(f"noise factors over all 2^32 hash values, bit for bit against "
              f"{what} ({time.perf_counter() - t0:.2f} s): radial mismatches "
              f"{check['radial'][0]} (first h {check['radial'][1]}), angular "
              f"mismatches {check['angular'][0]} (first h "
              f"{check['angular'][1]})")
        require(check == {"radial": (0, None), "angular": (0, None)},
                f"noise factors differ from {reference}: {check}")
    torch.cuda.empty_cache()

    x32 = torch.randn(8192, 1024, generator=gen, device=dev)
    for dtype, n in ((torch.float32, 1), (torch.float32, 16),
                     (torch.float32, 64), (torch.float32, 2500),
                     (torch.bfloat16, 16)):
        x = x32.to(dtype)
        seeds = torch.randint(0, 2 ** 32, (n,), generator=torch.Generator()
                              .manual_seed(n)).numpy().astype("uint32")
        c = torch.randn(n, generator=gen, device=dev) * 0.01
        name = f"zo_replay {str(dtype)[6:]} (8192,1024) N={n}"
        got = zo_replay_flat(x, seeds, c)
        want = ref.zo_replay_ref(x, seeds, c)
        err = check_close(name, got, want, 1e-4)
        res["zo_replay"]["err"] = max(res["zo_replay"]["err"], err)
        print(f"{name}: max|Δ| {err:.3e}  kernel "
              f"{time_ms(lambda: zo_replay_flat(x, seeds, c), 5):.4f} ms  "
              f"plain {time_ms(lambda: ref.zo_replay_ref(x, seeds, c), 1):.4f} ms")

    # main-path shapes: the largest server leaf of each path (the stacked
    # MLP input weight, bf16): olmo-1b at cut 2 (14 units), and qwen3-14b
    # at cut 4 of 16 layers (12 units of 5120 x 17408, 1.07e9 elements).
    # One perturbation record, and the server aggregation's M·τ·P = 4
    # records. The qwen3 leaf's plain version runs over row blocks of the
    # counter layout (row_offset), so its int64 temporaries stay small; the
    # JSON line carries the qwen3 leaf.
    seeds = (torch.randint(0, 2 ** 32, (4,), generator=torch.Generator()
                           .manual_seed(4)).numpy().astype("uint32"))
    c = torch.randn(4, generator=gen, device=dev) * 1e-3
    for shape in ((14, 2048, 8192), (12, 5120, 17408)):
        x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        n_el = x.numel()
        for name, fn, plain, n_rec in (
                ("zo_update", lambda: zo_update_flat(x, seed, coeff),
                 lambda x, r0: ref.zo_update_ref(x, seed, coeff, r0), 1),
                ("zo_replay", lambda: zo_replay_flat(x, seeds, c),
                 lambda x, r0: ref.zo_replay_ref(x, seeds, c, r0), 4)):
            what = f"{name} main-path {shape} bf16 N={n_rec}"
            y = fn().view(-1, ref.LANE)
            xv = x.view(-1, ref.LANE)
            step = 1 << 16                  # rows of 1024 per plain block
            plain_ms = 0.0
            for r0 in range(0, xv.shape[0], step):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                want = plain(xv[r0:r0 + step], r0)
                torch.cuda.synchronize()
                plain_ms += (time.perf_counter() - t0) * 1e3
                err = check_close(what, y[r0:r0 + step], want, 1e-5)
                res[name]["err"] = max(res[name]["err"], err)
            del y, want
            b_ms, b_by = bound(2 * 2 * n_el + 8 * n_rec,
                               n_el * n_rec * GAUSS_OPS, "f32_core")
            ms, clock, draw = time_ms_clocked(fn)
            static = zo_sass[f"{name}_kernel<bf16>"]
            print(f"{what}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms "
                  f"(in row blocks)  bound {b_ms:.4f} ms ({b_by})  at "
                  f"{clock:.0f} MHz, {draw:.0f} W: issue-rate figure "
                  f"{issued_per_gaussian(ms, clock, n_el * n_rec):.1f} "
                  f"instructions per gaussian (SASS fast path {static:.1f}; "
                  f"the bound counts {GAUSS_OPS} operations)")
            res[name].update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, library_ms=None,
                             shape=f"{shape} bf16, N={n_rec}")
        ms, clock, draw = time_ms_clocked(lambda: torch.add(x, 1.0))
        print(f"torch.add(x, 1.0) {shape} bf16 (streaming floor, one read "
              f"and one write; not the noise): {ms:.4f} ms at {clock:.0f} "
              f"MHz, {draw:.0f} W; {4 * n_el / ms / 1e9:.3f} TB/s")
        del x
    return res


def phase_threefry(dev, tf_sass) -> dict:
    """The threefry kernels against their plain version: bits, gaussian and
    updates (gaussian, and the sphere's scaled form) bit-equal at a ragged,
    an aligned and a misaligned leaf in f32 and bf16, at an element offset,
    and at the ragged leaf at offset 2^32 - 1000 (the launch is cut where
    the counter's high word changes);
    the sum of squares within 1e-5 of a float64 sum and the same on a second
    run; the gaussian over all 2^23 values of its uniform; then both paths'
    largest leaves, each compared with the plain version in blocks of 2^24
    elements and timed (update and sum of squares) with the SM clock read
    beside, torch.add(x, 1.0) on the same leaf as the streaming floor. No
    PyTorch call computes this function (torch.randn is Philox)."""
    import numpy as np
    from repro_torch.kernels import ref, threefry
    gen = torch.Generator(device=dev).manual_seed(3)
    key = np.array([0x2545F491, 0x9E3779B9], np.uint32)
    c = torch.full((1,), 0.37, device=dev)
    sc = torch.full((1,), 1.0625, device=dev)
    res = {"err": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        leaves = {
            "ragged (5000, 37)": torch.randn(5000, 37, generator=gen,
                                             device=dev).to(dtype),
            "aligned (8192, 1024)": torch.randn(8192, 1024, generator=gen,
                                                device=dev).to(dtype),
            "misaligned (1000003,)": torch.randn(
                1000004, generator=gen, device=dev).to(dtype)[1:]}
        cases = [(case, x, 3) for case, x in leaves.items()]
        # the counter's high word changes inside the leaf
        cases.append(("ragged (5000, 37)", leaves["ragged (5000, 37)"],
                      2 ** 32 - 1000))
        for case, x, off in cases:
            what = f"threefry {str(dtype)[6:]} {case} offset {off}"
            n = x.numel()
            bits, z = threefry.threefry_noise(n, key, dev, offset=off)
            require(torch.equal(bits, ref.threefry_bits_ref(key, n, off,
                                                            dev)),
                    f"{what}: bits differ from the plain version's")
            require(torch.equal(z, ref.threefry_normal_ref(key, n, off,
                                                           dev)),
                    f"{what}: gaussian differs from the plain version's")
            for scale in (None, sc):
                got = threefry.threefry_update(x, key, c, scale=scale,
                                               offset=off)
                want = ref.threefry_update_ref(x, key, c, scale, off)
                require(torch.equal(got, want), f"{what}: update (scale "
                        f"{scale is not None}) differs from the plain "
                        f"version's")
                res["err"] = max(res["err"], max_err(got, want))
            sums = [float(threefry.threefry_sumsq(
                n, key, torch.zeros(1, device=dev), offset=off))
                for _ in range(2)]
            want = float((z.double() ** 2).sum())
            require(abs(sums[0] - want) <= 1e-5 * want and sums[0] == sums[1],
                    f"{what}: sum of squares {sums} against {want}")
            print(f"{what}: bits, gaussian and updates equal to the plain "
                  f"version's; sum of squares {sums[0]:.6f} (float64 "
                  f"{want:.6f}, the same on a second run)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    check = threefry.normal_table_check(dev)
    print(f"threefry gaussian over all 2^23 uniforms, bit for bit against "
          f"the plain version's torch ops ({time.perf_counter() - t0:.2f} "
          f"s): {check['mismatches']} mismatches (first {check['first']}), "
          f"max |Δ| {check['max_abs_err']:.3e}")
    require(check["mismatches"] == 0, f"threefry gaussian: {check}")
    fmax = float(smi("clocks.max.sm")[0])
    share = tf_sqrt_share()
    print(f"threefry bound: {TF_OPS} issue slots a gaussian ({TF_ALU} on "
          f"the ALU pipe, {TF_MUFU} MUFU) plus {TF_MODE_OPS} by mode, and "
          f"2 for sqrt(w) - 3 on the {share:.6f} of uniforms with w >= 5")
    for shape in ((14, 2048, 8192), (12, 5120, 17408)):
        x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        n = x.numel()
        y = threefry.threefry_update(x, key, c).view(-1)
        xf, step, plain_ms = x.view(-1), 1 << 24, 0.0
        for e0 in range(0, n, step):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = ref.threefry_update_ref(xf[e0:e0 + step], key, c, None, e0)
            torch.cuda.synchronize()
            plain_ms += (time.perf_counter() - t0) * 1e3
            require(torch.equal(y[e0:e0 + step], want),
                    f"threefry update {shape}: elements {e0}.. differ from "
                    f"the plain version's")
        del y, want
        ms, clock, draw = time_ms_clocked(
            lambda: threefry.threefry_update(x, key, c))
        acc = torch.zeros(1, device=dev)
        sq_ms, sq_clock, _ = time_ms_clocked(
            lambda: threefry.threefry_sumsq(n, key, acc))
        add_ms, _, _ = time_ms_clocked(lambda: torch.add(x, 1.0))
        b_ops, slots = tf_bound_ms(n, "update", fmax, share)
        b_bytes = 4 * n / HBM_BYTES_PER_S * 1e3
        b_ms, b_by = (b_ops, "operations") if b_ops >= b_bytes else \
            (b_bytes, "bytes")
        sq_bound, sq_slots = tf_bound_ms(n, "sumsq", fmax, share)
        # diagnostic: the same issue model over the kernel's own SASS
        sass_ms = issue_bound_ms(n, tf_sass["threefry_update_kernel<bf16>"],
                                 fmax)
        sq_sass_ms = issue_bound_ms(n, tf_sass["threefry_sumsq_kernel"],
                                    fmax)
        print(f"threefry update {shape} bf16: kernel {ms:.4f} ms at "
              f"{clock:.0f} MHz, {draw:.0f} W  plain {plain_ms:.4f} ms (in "
              f"blocks of 2^24, equal bit for bit)  bound {b_ms:.4f} ms "
              f"({b_by}; the function's {slots:.4f} issue slots an element "
              f"at {fmax:.0f} MHz {b_ops:.4f} ms, bytes {b_bytes:.4f} ms)  "
              f"{ms / b_ms:.2f}x the bound; the kernel's SASS per element "
              f"at the same rate {sass_ms:.4f} ms ({ms / sass_ms:.2f}x); sum "
              f"of squares {sq_ms:.4f} ms at {sq_clock:.0f} MHz (bound "
              f"{sq_bound:.4f} ms from {sq_slots:.4f} slots, its SASS "
              f"{sq_sass_ms:.4f} ms); torch.add(x, 1.0) {add_ms:.4f} ms")
        if shape[0] == 14:      # path 3's largest leaf: the JSON row's
            res.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                       bound_by=b_by, library_ms=None,
                       shape=f"{shape} bf16, update")
        del x
    return res


def phase_rmsnorm(dev) -> dict:
    """The rmsnorm kernel against its plain version at the qwen3-14b
    path's shapes (the block norms' rows of 5120, the qk-norm's rows of
    128 over 40 query and 8 kv heads), f32 and bf16, and at row counts and
    widths that take the kernel's other branches: a row count that is no
    multiple of the 16 rows of a block of half-warp rows, and widths that are no
    multiple of a 16-byte load. F.rms_norm is timed beside it as the
    yardstick (the port never calls it). Times are device time per call
    (device_ms); the event-timed loop beside them is paced by the host."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_pair
    gen = torch.Generator(device=dev).manual_seed(2)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("block norm (main path)", (1, 512, 5120), bf16),
             ("qk-norm q", (1, 512, 40, 128), bf16),
             ("qk-norm k", (1, 512, 8, 128), bf16),
             ("block norm", (1, 512, 5120), f32),
             ("qk-norm q", (1, 512, 40, 128), f32),
             ("ragged rows, half-warp per row", (3, 7, 128), bf16),
             ("ragged rows, block per row", (1, 300, 5120), f32),
             ("D=100, element loads", (333, 100), bf16),
             ("D=1030, element loads", (77, 1030), f32)]
    res = {"err": 0.0}
    for name, shape, dtype in cases:
        D = shape[-1]
        x = (torch.randn(shape, generator=gen, device=dev) * 3.0).to(dtype)
        s = 1.0 + 0.5 * torch.randn(D, generator=gen, device=dev)
        what = f"rmsnorm {name} {str(dtype)[6:]} {shape}"
        err = check_close(what, rmsnorm(x, s), ref.rmsnorm_ref(x, s), 1e-5)
        res["err"] = max(res["err"], err)
        nbytes = 2 * x.numel() * x.element_size() + 4 * D
        xs = [x] + [x.clone() for _ in range(L2_BYTES // nbytes + 1)]
        ms = device_ms(lambda t: rmsnorm(t, s), xs, 100)
        lib_ms = device_ms(lambda t: F.rms_norm(t, (D,), s, 1e-5), xs, 100)
        plain_ms = device_ms(lambda t: ref.rmsnorm_ref(t, s), xs, 20)
        paced_ms = time_cold_ms(lambda t: rmsnorm(t, s), xs, 100)
        require(min(ms, lib_ms, plain_ms) > 0,
                f"{what}: the profiler recorded no device time")
        b_ms, b_by = bound(nbytes, NORM_OPS * x.numel(), "f32_core")
        print(f"{what}: max|Δ| {err:.3e}  kernel {ms:.4f} ms  plain "
              f"{plain_ms:.4f} ms  library (F.rms_norm) {lib_ms:.4f} ms  "
              f"bound {b_ms:.4f} ms ({b_by})  event-timed loop "
              f"{paced_ms:.4f} ms a call")
        if "main path" in name:
            res.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=b_ms, bound_by=b_by,
                       shape=f"{shape} bf16, f32 scale")
    # the qk-norm of the qwen3-14b path: q and k in one launch
    D = 128
    xq, xk = [(torch.randn(sh, generator=gen, device=dev) * 3.0).to(bf16)
              for sh in ((1, 512, 40, D), (1, 512, 8, D))]
    sq, sk = [1.0 + 0.5 * torch.randn(D, generator=gen, device=dev)
              for _ in range(2)]
    yq, yk = rmsnorm_pair(xq, sq, xk, sk)
    wq, wk = ref.rmsnorm_pair_ref(xq, sq, xk, sk)
    err = max(check_close("rmsnorm pair q", yq, wq, 1e-5),
              check_close("rmsnorm pair k", yk, wk, 1e-5))
    require(torch.equal(yq, rmsnorm(xq, sq))
            and torch.equal(yk, rmsnorm(xk, sk)),
            "rmsnorm pair: differs from the two single-tensor launches")
    res["err"] = max(res["err"], err)
    nbytes = 2 * (xq.numel() + xk.numel()) * 2 + 2 * 4 * D
    sets = [(xq, xk)] + [(xq.clone(), xk.clone())
                         for _ in range(L2_BYTES // nbytes + 1)]
    pair_ms = device_ms(lambda t: rmsnorm_pair(t[0], sq, t[1], sk), sets, 100)
    q_ms = device_ms(lambda t: rmsnorm(t[0], sq), sets, 100)
    k_ms = device_ms(lambda t: rmsnorm(t[1], sk), sets, 100)
    plain_ms = device_ms(lambda t: ref.rmsnorm_pair_ref(t[0], sq, t[1], sk),
                         sets, 20)
    lib_ms = device_ms(lambda t: (F.rms_norm(t[0], (D,), sq, 1e-5),
                                  F.rms_norm(t[1], (D,), sk, 1e-5)), sets, 100)
    require(min(pair_ms, q_ms, k_ms, plain_ms, lib_ms) > 0,
            "rmsnorm pair: the profiler recorded no device time")
    b_ms, b_by = bound(nbytes, NORM_OPS * (xq.numel() + xk.numel()),
                       "f32_core")
    print(f"rmsnorm pair (qk-norm) q {tuple(xq.shape)} + k "
          f"{tuple(xk.shape)} bf16: max|Δ| {err:.3e}  one launch "
          f"{pair_ms:.4f} ms against the single launches q {q_ms:.4f} + k "
          f"{k_ms:.4f} = {q_ms + k_ms:.4f} ms  plain {plain_ms:.4f} ms  "
          f"library (two F.rms_norm) {lib_ms:.4f} ms  bound {b_ms:.4f} ms "
          f"({b_by})")
    res["pair"] = dict(ms=pair_ms, q_ms=q_ms, k_ms=k_ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=b_ms)
    return res


def flash_pairs(S: int, causal: bool, window: int) -> int:
    """The (query, key) pairs a causal / window mask leaves unmasked."""
    n = 0
    for i in range(S):
        lo = max(0, i - window + 1) if window > 0 else 0
        hi = i if causal else S - 1
        n += hi - lo + 1
    return n


def phase_flash(dev) -> dict:
    """The flash kernel against its plain version, bf16, at parity shapes
    and at the paths' shapes (d_head 128 on paths 1-3, 64 on path 4), with
    scaled_dot_product_attention timed beside it at the path shapes as the
    yardstick (the port never calls it). Times are device time per call
    (device_ms), cycling through copies of (q, k, v) that together exceed
    the 50 MB L2; the event-timed loop beside them is paced by the host
    for calls of tens of microseconds."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    gen = torch.Generator(device=dev).manual_seed(1)
    res = {"err": 0.0}

    def qkv(B, H, Hkv, S, d):
        return [torch.randn(B, h, S, d, generator=gen, device=dev).to(
            torch.bfloat16) for h in (H, Hkv, Hkv)]

    cases = [("causal", (2, 16, 16, 512, 128), True, 0),
             ("window 128", (2, 16, 16, 512, 128), True, 128),
             ("GQA 16/4", (2, 16, 4, 512, 128), True, 0),
             ("ragged S=500", (2, 16, 16, 500, 128), True, 0),
             ("paper-opt-1.3b path, d=64", (1, 32, 32, 512, 64), True, 0),
             ("d=64, ragged S=500, window 70, not causal",
              (1, 32, 32, 500, 64), False, 70),
             ("B=2, GQA 40/8", (2, 40, 8, 512, 128), True, 0),
             ("olmo-1b path", (1, 16, 16, 512, 128), True, 0),
             ("qwen3-14b path, GQA 40/8 (group 5)", (1, 40, 8, 512, 128),
              True, 0)]
    for name, shape, causal, window in cases:
        B, H, Hkv, S, d = shape
        q, k, v = qkv(*shape)
        got = flash_attention(q, k, v, causal=causal, window=window)
        want = ref.flash_attention_ref(q, k, v, causal, window)
        err = check_close(f"flash {name}", got, want, 1e-5)
        res["err"] = max(res["err"], err)
        nbytes = 2 * (2 * B * H * S * d + 2 * B * Hkv * S * d)
        sets = [(q, k, v)] + [(q.clone(), k.clone(), v.clone()) for _ in
                              range(L2_BYTES // nbytes + 1)]
        ms = device_ms(lambda t: flash_attention(*t, causal=causal,
                                                 window=window), sets, 50)
        plain_ms = device_ms(lambda t: ref.flash_attention_ref(
            *t, causal, window), sets, 10)
        paced_ms = time_cold_ms(lambda t: flash_attention(
            *t, causal=causal, window=window), sets, 50)
        require(min(ms, plain_ms) > 0,
                f"flash {name}: the profiler recorded no device time")
        b_ms, b_by = bound(nbytes, 4 * d * flash_pairs(S, causal, window)
                           * B * H, "bf16_tensor")
        line = (f"flash {name} bf16 {shape}: max|Δ| {err:.3e}  kernel "
                f"{ms:.4f} ms  plain {plain_ms:.4f} ms  bound {b_ms:.4f} ms "
                f"({b_by})")
        if "path" in name:
            lib_ms = device_ms(lambda t: F.scaled_dot_product_attention(
                *t, is_causal=True, enable_gqa=H != Hkv), sets, 50)
            require(lib_ms > 0, f"flash {name}: no device time for the "
                    f"library call")
            line += (f"  library (scaled_dot_product_attention) "
                     f"{lib_ms:.4f} ms")
            # the JSON line carries the qwen3-14b path's shape
            res.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=b_ms, bound_by=b_by,
                       shape=f"({B},{H},{S},{d}) bf16 causal, Hkv={Hkv}")
        print(line + f"  event-timed loop (host-paced) {paced_ms:.4f} ms "
              f"a call")
        del sets
    return res


def check_grad(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """A gradient against its plain version: f32 within 1e-5 of max|want|,
    bf16 within one bf16 ulp of it (2^-7·max|want|; both sum in f32 and
    round the result once, the bf16 kernels having rounded P and dS to
    enter the tensor cores, as tests/test_torch_flash_bwd.py emulates).
    Returns max |Δ|."""
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{name}: {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
    require(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite")
    d = float((got.float() - want.float()).abs().max())
    top = float(want.float().abs().max())
    tol = (2.0 ** -7 if got.dtype == torch.bfloat16 else 1e-5) * top
    require(d <= tol, f"{name}: max |Δ| {d:.3e} above {tol:.3e} "
            f"(max |g| {top:.3e})")
    return d


def bwd_grid(B: int, H: int, Hkv: int, S: int, d: int) -> str:
    """The bf16 flash backward's launch geometry at these shapes: one
    dK/dV block a (batch, query head, 64-row key tile), the kv group's
    H/Hkv partials summed by a fourth launch where there are more than one,
    and one dQ block a (batch, head, 64-row query tile); shared memory and
    blocks an SM as the library reports them."""
    from repro_torch.kernels import build
    lib = build.library()
    blocks, parts = B * H * -(-S // 64), H // Hkv
    kv_smem, q_smem = (lib.flash_attention_bwd_smem_bytes(w, d)
                       for w in (0, 1))
    kv_sm, q_sm = (lib.flash_attention_bwd_blocks_per_sm(w, d)
                   for w in (0, 1))
    return (f"dK/dV grid {blocks} blocks ({kv_sm} an SM, {kv_smem} bytes of "
            f"shared memory; {parts} partials a kv head"
            + (", summed by a fourth launch" if parts > 1 else "")
            + f"), dQ grid {blocks} blocks ({q_sm} an SM, {q_smem} bytes)")


def phase_flash_bwd(dev) -> dict:
    """The flash backward kernel against its plain version
    (``ref.flash_attention_bwd_ref``, on the plain forward's o and lse) in
    bf16 and f32 at path 5's shape (1,32,512,64) and at qwen3-14b's
    (1,40,512,128) with 8 kv heads, causal and with a window of 128; v and
    dO as strided views of (B, S, heads, d) buffers, as the model passes
    them. The forward kernel's lse against the plain version's (relative
    1e-5). Device time per call (device_ms) for bf16, beside the plain
    version and the autograd backward of scaled_dot_product_attention on
    the same inputs (causal cases; it takes no window), the port never
    calling it. Bound: the larger of the bytes (q, k, v, o, dO and lse
    read, dq, dk and dv written) over 3.35 TB/s and 10·d operations a
    causal pair on the bf16 tensor cores."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (_launch_forward,
                                                     flash_attention_bwd)
    gen = torch.Generator(device=dev).manual_seed(4)
    cases = [("path 5 (paper-opt-1.3b), d=64", (1, 32, 32, 512, 64), True,
              0),
             ("qwen3-14b shape, GQA 40/8", (1, 40, 8, 512, 128), True, 0),
             ("qwen3-14b shape, window 128", (1, 40, 8, 512, 128), True,
              128)]
    res = {"err": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for name, (B, H, Hkv, S, d), causal, window in cases:
            what = f"flash bwd {name} {str(dtype)[6:]} ({B},{H},{S},{d})"

            def rnd(*shape):
                return torch.randn(shape, generator=gen, device=dev).to(dtype)
            q, k = rnd(B, H, S, d), rnd(B, Hkv, S, d)
            v = rnd(B, S, Hkv, d).transpose(1, 2)
            do = rnd(B, S, H, d).transpose(1, 2)
            o, lse = ref.flash_attention_ref(q, k, v, causal, window,
                                             return_lse=True)
            got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                      window=window)
            want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal,
                                               window)
            err = max(check_grad(f"{what} {g}", a, b)
                      for g, a, b in zip(("dq", "dk", "dv"), got, want))
            res["err"] = max(res["err"], err)
            ko, kl = torch.empty_like(q), torch.empty_like(lse)
            _launch_forward(q, k, v, ko, kl, causal, window)
            lse_err = float(((kl - lse).abs() / lse.abs().clamp(min=1)).max())
            require(lse_err <= 1e-5, f"{what}: forward lse {lse_err:.3e} "
                    f"off the plain version")
            line = (f"{what}, Hkv {Hkv}, causal {causal}, window {window}: "
                    f"max|Δ| {err:.3e}, lse relative {lse_err:.3e}")
            if dtype == torch.float32:
                print(line)
                continue
            n_qo = q.numel()
            nbytes = 2 * (4 * n_qo + 4 * k.numel()) + 4 * lse.numel()
            sets = [(q, k, v, o, lse, do)] + [
                tuple(t.clone() for t in (q, k, v, o, lse, do))
                for _ in range(L2_BYTES // nbytes + 1)]
            per_kernel = {}
            ms = device_ms(lambda t: flash_attention_bwd(
                *t, causal=causal, window=window), sets, 20,
                by_kernel=per_kernel)
            plain_ms = device_ms(lambda t: ref.flash_attention_bwd_ref(
                *t, causal, window), sets, 5)
            require(min(ms, plain_ms) > 0,
                    f"{what}: the profiler recorded no device time")
            lib_ms = None
            if window == 0:
                graphs = []
                for t in sets:
                    qkv = [a.detach().contiguous().requires_grad_(True)
                           for a in t[:3]]
                    out = F.scaled_dot_product_attention(
                        *qkv, is_causal=True, enable_gqa=H != Hkv)
                    graphs.append((out, qkv, t[5]))
                lib_ms = device_ms(lambda g: torch.autograd.grad(
                    g[0], g[1], g[2], retain_graph=True), graphs, 20)
                require(lib_ms > 0, f"{what}: no device time for the "
                        f"library backward")
                del graphs
            b_ms, b_by = bound(nbytes, FLASH_BWD_OPS_PER_D * d * B * H
                               * flash_pairs(S, causal, window),
                               "bf16_tensor")
            print(line + f"  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                  f"library (autograd backward of "
                  f"scaled_dot_product_attention) "
                  + ("n/a (no window)" if lib_ms is None
                     else f"{lib_ms:.4f} ms")
                  + f"  bound {b_ms:.4f} ms ({b_by})")
            print(f"  {bwd_grid(B, H, Hkv, S, d)}; per launch: " + ", ".join(
                f"{PORT_KERNEL.search(key).group(0)} {t * 1e3:.2f} us"
                for key, t in sorted(per_kernel.items(),
                                     key=lambda kt: -kt[1])
                if PORT_KERNEL.search(key)))
            if "path 5" in name:
                res.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=b_ms, bound_by=b_by,
                           shape=f"({B},{H},{S},{d}) bf16 causal, "
                                 f"Hkv={Hkv}")
            elif window == 0:
                res["qwen3"] = dict(ms=ms, plain_ms=plain_ms,
                                    library_ms=lib_ms, bound_ms=b_ms)
            del sets
    return res


def phase_rmsnorm_bwd(dev) -> dict:
    """The rmsnorm backward (dx, and dscale in f32 summed over the rows)
    against ``ref.rmsnorm_bwd_ref`` at the qwen3-14b path's shapes: the
    block norms' rows of 5120 and the qk-norm pair's q and k rows of 128
    (the pair's backward is one launch each), bf16 and f32, with the
    autograd backward of F.rms_norm timed beside it (the port never calls
    it). Times are device time per call (device_ms), cycling past L2.
    Bound: bytes (x and dy read, dx written, the scale read and dscale
    written)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd
    gen = torch.Generator(device=dev).manual_seed(8)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("block norm (qwen3-14b)", (1, 512, 5120), bf16),
             ("qk-norm q", (1, 512, 40, 128), bf16),
             ("qk-norm k", (1, 512, 8, 128), bf16),
             ("block norm", (1, 512, 5120), f32),
             ("qk-norm q", (1, 512, 40, 128), f32),
             ("ragged rows, D=1030", (77, 1030), f32)]
    res = {"err": 0.0, "pair_ms": 0.0}
    for name, shape, dtype in cases:
        D = shape[-1]
        x = (torch.randn(shape, generator=gen, device=dev) * 3.0).to(dtype)
        dy = torch.randn(shape, generator=gen, device=dev).to(dtype)
        s = 1.0 + 0.5 * torch.randn(D, generator=gen, device=dev)
        what = f"rmsnorm bwd {name} {str(dtype)[6:]} {shape}"
        dx, ds = rmsnorm_bwd(x, s, dy)
        wx, ws = ref.rmsnorm_bwd_ref(x, s, dy)
        err = max(check_grad(f"{what} dx", dx, wx),
                  check_grad(f"{what} dscale", ds, ws))
        res["err"] = max(res["err"], err)
        if dtype == f32:
            print(f"{what}: max|Δ| {err:.3e}")
            continue
        nbytes = 3 * x.numel() * x.element_size() + 2 * 4 * D
        sets = [(x, dy)] + [(x.clone(), dy.clone())
                            for _ in range(L2_BYTES // nbytes + 1)]
        ms = device_ms(lambda t: rmsnorm_bwd(t[0], s, t[1]), sets, 100)
        plain_ms = device_ms(lambda t: ref.rmsnorm_bwd_ref(t[0], s, t[1]),
                             sets, 20)
        graphs = []
        for t in sets:
            xx = t[0].detach().requires_grad_(True)
            ss = s.detach().clone().requires_grad_(True)
            graphs.append((F.rms_norm(xx, (D,), ss, 1e-5), (xx, ss), t[1]))
        lib_ms = device_ms(lambda g: torch.autograd.grad(
            g[0], g[1], g[2], retain_graph=True), graphs, 100)
        require(min(ms, plain_ms, lib_ms) > 0,
                f"{what}: the profiler recorded no device time")
        b_ms, b_by = bound(nbytes, NORM_BWD_OPS * x.numel(), "f32_core")
        print(f"{what}: max|Δ| {err:.3e}  kernel {ms:.4f} ms (three "
              f"launches)  plain {plain_ms:.4f} ms  library (autograd "
              f"backward of F.rms_norm) {lib_ms:.4f} ms  bound {b_ms:.4f} "
              f"ms ({b_by})")
        if "block" in name:
            res.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=b_ms, bound_by=b_by,
                       shape=f"{shape} bf16, f32 scale")
        else:
            res["pair_ms"] += ms
        del sets, graphs
    print(f"rmsnorm bwd qk-norm pair (two launches, q then k) "
          f"{res['pair_ms']:.4f} ms")
    return res


SMALL_ROUNDS = (("mu_splitfed", "counter", "seed_replay"),
                ("mu_splitfed", "gaussian", "dense"),
                ("mu_splitfed", "gaussian", "seed_replay"),
                ("mu_splitfed", "sphere", "dense"),
                ("mu_splitfed", "sphere", "seed_replay"),
                ("vanilla", "gaussian", "dense"),
                ("gas", "gaussian", "dense"),
                ("gas", "counter", "seed_replay"))


def small_round(algorithm, cfg, sfl, params, batch, mask, key, aggregation):
    """One round of ``algorithm`` from its freshly built state: (params,
    metrics, state leaves)."""
    from repro_torch.core.baselines import (gas_init_state, gas_round,
                                            vanilla_splitfed_round)
    from repro_torch.core.splitfed import mu_splitfed_round
    if algorithm == "gas":
        state = gas_init_state(cfg, sfl, params, batch)
        p, st, m = gas_round(cfg, sfl, params, state, batch, mask, key,
                             aggregation=aggregation)
        return p, m, [*st.h_buffer.values(), *st.label_buffer.values()]
    fn = (vanilla_splitfed_round if algorithm == "vanilla"
          else mu_splitfed_round)
    p, m = fn(cfg, sfl, params, batch, mask, key, aggregation=aggregation)
    return p, m, []


def phase_small_round(dev):
    """One round of a small f32 model (d_head 64) on the card against the
    same round on the CPU, where the plain versions run, for each
    algorithm, noise and aggregation in SMALL_ROUNDS (GAS with a stale
    client: its buffer too)."""
    import numpy as np
    from repro_torch.configs import SFLConfig, get_config
    from repro_torch.core import prng
    from repro_torch.models import init_params, untie_params
    from repro_torch.utils import tree
    cfg = get_config("olmo-1b", smoke=True).replace(
        d_model=128, n_heads=2, n_kv_heads=2, dtype="float32")
    params = untie_params(cfg, init_params(
        cfg, torch.Generator().manual_seed(0)))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 2, 64))
    for algorithm, dist, aggregation in SMALL_ROUNDS:
        sfl = SFLConfig(n_clients=2, tau=2, n_perturbations=2, cut_units=2,
                        perturbation_dist=dist)
        mask = [1.0, 0.0] if algorithm == "gas" else [1.0, 0.5]
        outs = {}
        for d in ("cpu", dev):
            b = {"tokens": torch.from_numpy(toks).to(d),
                 "labels": torch.from_numpy(np.roll(toks, -1, -1)).to(d)}
            p = tree.tree_map(lambda a: a.to(d), params)
            outs[str(d)] = small_round(
                algorithm, cfg, sfl, p, b, torch.tensor(mask, device=d),
                prng.PRNGKey(3), aggregation)
        (pc, mc, sc), (pg, mg, sg) = outs["cpu"], outs[str(dev)]
        dp = max(max_err(a.cpu(), b) for a, b in zip(tree.leaves(pg),
                                                     tree.leaves(pc)))
        dm = max(max_err(getattr(mg, f).cpu(), getattr(mc, f))
                 for f in mc._fields)
        ds = max([max_err(a.cpu(), b) for a, b in zip(sg, sc)], default=0.0)
        what = f"{algorithm}, {dist}, {aggregation}"
        print(f"small f32 round ({what}), card vs CPU: params max|Δ| "
              f"{dp:.3e}  metrics max|Δ| {dm:.3e}"
              + (f"  buffer max|Δ| {ds:.3e}" if sc else ""))
        require(dp <= 1e-4 and dm <= 1e-4 and ds <= 1e-4,
                f"small round ({what}): card and CPU disagree")


# learning rates of the small first-order rounds: AdamW at the repo's
# first-order default (TrainConfig.lr), where its first step's sign-like
# direction g/(|g| + 1e-8) keeps rounding-level gradients from moving an
# element by more than the check's 1e-4
FO_SMALL = (("fedavg", "sgd", 1e-2), ("fedavg", "adamw", 1e-3),
            ("fedlora", "sgd", 1e-2))


def phase_small_fo(dev):
    """One small f32 first-order round on the card (the flash and rmsnorm
    forward and backward kernels) against the same round on the CPU (their
    plain versions), within 1e-4: FedAvg with SGD and with AdamW on olmo-1b
    (d_head 64), FedLoRA on qwen3-14b with qk-norm and GQA (d_head 64, two
    query heads a kv head)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.core.baselines import fedavg_round, fedlora_round
    from repro_torch.kernels import build
    from repro_torch.models import init_params, untie_params
    from repro_torch.optim import init_lora
    from repro_torch.utils import tree
    for algorithm, optimizer, lr in FO_SMALL:
        arch = "olmo-1b" if algorithm == "fedavg" else "qwen3-14b"
        cfg = get_config(arch, smoke=True).replace(
            d_model=128, n_heads=2, n_kv_heads=2 if algorithm == "fedavg"
            else 1, dtype="float32")
        params = untie_params(cfg, init_params(
            cfg, torch.Generator().manual_seed(0)))
        toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                 (2, 2, 64))
        outs = {}
        for d in ("cpu", dev):
            p = tree.tree_map(lambda a: a.to(d), params)
            b = {"tokens": torch.from_numpy(toks).to(d),
                 "labels": torch.from_numpy(np.roll(toks, -1, -1)).to(d)}
            mask = torch.tensor([1.0, 0.5], device=d)
            before = dict(build.LAUNCHES)
            if algorithm == "fedavg":
                out = fedavg_round(cfg, p, b, mask, lr, optimizer=optimizer,
                                   eta_g=0.3)
            else:
                out = fedlora_round(cfg, p, init_lora(cfg, p, 4,
                                                      prng.PRNGKey(0)),
                                    b, mask, lr, eta_g=0.3)
            outs[str(d)] = (tree.leaves(out), {
                k: build.LAUNCHES[k] - before.get(k, 0)
                for k in ("flash_attention_bwd", "rmsnorm_bwd")})
        (want, _), (got, n) = outs["cpu"], outs[str(dev)]
        err = max(max_err(a.cpu(), b) for a, b in zip(got, want))
        what = f"{algorithm} ({optimizer}, lr {lr})"
        print(f"small f32 first-order round ({what}), card vs CPU: max|Δ| "
              f"{err:.3e}; backward launches on the card {n}")
        require(err <= 1e-4, f"small round ({what}): card and CPU disagree")
        require(n["flash_attention_bwd"] > 0 and (
            algorithm == "fedavg" or n["rmsnorm_bwd"] > 0),
            f"small round ({what}): a backward kernel did not launch")


def drive(dev, name: str, run, sfl, kernels, frozen: bool = False) -> tuple:
    """Rounds of a path through the driver's engine (``train.run_engine``
    on ``run`` with ``sfl``): every launch counter set to 0 just before and
    read just after, and every kernel in ``kernels`` must have launched.
    Each chunk's seconds (ending in the chunk's flush, a synchronise) and
    peak memory are printed with its masks. Losses and parameters must be
    finite, and the parameters must have moved (a sample of each leaf is
    kept before the rounds), or with ``frozen`` (FedLoRA's base) must not
    have. One more round at the last tau then runs under
    the profiler (without the run's telemetry, log or trace). Returns
    (EngineResult, controller or None, launches, chunks): chunks is a list
    of (masks, seconds, peak GiB), one a chunk."""
    from repro_torch.kernels import build
    from repro_torch.launch import train
    from repro_torch.models import param_count
    from repro_torch.utils import tree
    print(f"{name}: {run.cfg.n_layers} layers, d_model {run.cfg.d_model}, "
          f"heads {run.cfg.n_heads}/{run.cfg.n_kv_heads}, d_head "
          f"{run.cfg.d_head}, d_ff {run.cfg.d_ff}, vocab "
          f"{run.cfg.vocab_size}, cut {sfl.cut_units}; parameters (untied "
          f"head) {param_count(run.params):,}; noise "
          f"{sfl.perturbation_dist}, aggregation {run.args.aggregation}")
    before = [a.reshape(-1)[:4096].clone() for a in tree.leaves(run.params)]
    t_last = [0.0]
    chunks = []

    def on_chunk(info, p, s):
        dt = time.perf_counter() - t_last[0]
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        print(f"{name}: rounds {info.start}-{info.stop - 1}: masks "
              f"{info.masks.tolist()}  {dt:.3f} s, "
              f"{dt / (info.stop - info.start):.3f} s a round, peak "
              f"{peak:.2f} GiB")
        chunks.append((info.masks, dt, peak))
        torch.cuda.reset_peak_memory_stats(dev)
        t_last[0] = time.perf_counter()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    build.reset_launches()
    t_last[0] = time.perf_counter()
    res, ctl = train.run_engine(run, sfl=sfl, chunk_callback=on_chunk)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    print(f"{name}: losses {list(res.round_loss)}  simulated round times "
          f"{list(res.round_times)}  sim_t {res.sim_time}  tau per round "
          f"{list(res.tau_per_round)}  launches {launches}")
    require(all(math.isfinite(x) for x in res.round_loss),
            f"{name}: non-finite loss")
    for k in kernels:
        require(launches.get(k, 0) > 0,
                f"{name}: kernel {k} was never launched")
    leaves = tree.leaves(res.params)
    require(len(leaves) == len(before), f"{name}: parameter tree changed")
    moved = 0.0
    for a, b in zip(leaves, before):
        require(bool(torch.isfinite(a).all()),
                f"{name}: non-finite parameters")
        moved = max(moved, max_err(a.reshape(-1)[:4096], b))
    print(f"{name}: max |Δparam| over {len(res.round_loss)} rounds (first "
          f"4096 elements of each leaf) {moved:.3e}")
    if frozen:
        require(moved == 0, f"{name}: frozen parameters changed")
    else:
        require(moved > 0, f"{name}: parameters did not change")
    tau = int(res.tau_per_round[-1])
    one = run._replace(
        args=argparse.Namespace(**{**vars(run.args), "rounds": 1,
                                   "adaptive_tau": False, "tau_source": "sim",
                                   "telemetry": False, "log_jsonl": "",
                                   "trace_out": ""}),
        params=res.params)
    profile_round(f"{name}, one round at tau {tau}", lambda: train.run_engine(
        one, sfl=dataclasses.replace(sfl, tau=tau), log=None))
    return res, ctl, launches, chunks


def phase_path(dev, name: str, argv, cfg, kernels) -> dict:
    """Paths 1-2: ``train.setup`` (with ``cfg`` in place of the --arch
    config where given), counter noise set after it, then ``drive`` at full
    participation, one round a chunk (so each round's seconds and peak
    memory are its own). Returns the launch counts."""
    from repro_torch.launch import train
    print(f"{name}: device memory in use before the path "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    run = train.setup(argv, cfg=cfg)
    sfl = dataclasses.replace(run.sfl, perturbation_dist="counter")
    return drive(dev, name, run, sfl, kernels)[2]


def phase_driver(dev) -> dict:
    """Path 3, the reference driver's default run at olmo-1b's full config:
    ``train.setup`` then ``drive`` on the straggler schedule with adaptive
    tau and the config's threefry gaussian noise and dense aggregation.
    Threefry and flash attention must launch and the counter kernels must
    not; the schedule must drop a client and adaptive tau must decide.
    Returns the launch counts."""
    from repro_torch.launch import train
    name = "driver path (olmo-1b, gaussian, stragglers, adaptive tau)"
    run = train.setup(DRIVER_ARGV)
    require(run.sfl.perturbation_dist == "gaussian",
            f"{name}: the driver's default noise is not gaussian")
    res, ctl, launches, _ = drive(dev, name, run, run.sfl,
                                  ("threefry", "flash_attention"))
    print(f"{name}: tau decisions {ctl.trace}")
    require(bool(ctl.trace), f"{name}: adaptive tau made no decision")
    require(not launches.get("zo_update") and not launches.get("zo_replay"),
            f"{name}: counter-noise kernels launched on a gaussian run")
    require(bool((train.schedule(run).masks == 0).any()),
            f"{name}: the schedule dropped no client")
    return launches


def phase_paper(dev) -> dict:
    """Path 4, the paper's comparison on paper-opt-1.3b at its full
    config: three runs through ``train.setup`` + ``drive`` on the same
    seed, and so on the same straggler schedule: (a) MU-SplitFed with
    adaptive tau on the measured clock, telemetry, a JSONL run log and a
    Chrome trace (threefry gaussian, dense); (b) vanilla SplitFed
    (gaussian, dense); (c) GAS with seed-replay aggregation and counter
    noise set after setup. Requires identical masks across the runs, a
    stale client in GAS's rows, one measured record with positive
    durations a chunk, an adaptive-tau decision, 4 round rows and 2 chunk
    rows in the log and engine.dispatch spans in the trace; prints each
    algorithm's simulated clock, round seconds, peak memory and losses.
    Returns the launch counts and each algorithm's summary."""
    import tempfile

    import numpy as np
    from repro_torch import obs
    from repro_torch.launch import train
    launches, summary = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        log, trace = f"{tmp}/run.jsonl", f"{tmp}/trace.json"
        runs = [("mu_splitfed", ["--tau", "2", "--adaptive-tau",
                                 "--tau-source", "measured", "--tau-max", "4",
                                 "--telemetry", "--log-jsonl", log,
                                 "--trace-out", trace], "gaussian",
                 ("threefry", "flash_attention")),
                ("vanilla", [], "gaussian", ("threefry", "flash_attention")),
                ("gas", ["--aggregation", "seed_replay"], "counter",
                 ("zo_update", "zo_replay", "flash_attention"))]
        for algorithm, extra, dist, kernels in runs:
            name = f"paper path ({algorithm})"
            torch.cuda.empty_cache()
            run = train.setup([*PAPER_ARGV, "--algorithm", algorithm, *extra])
            require(run.cfg.n_layers == 24 and run.cfg.d_model == 2048
                    and run.cfg.d_head == 64,
                    f"{name}: not paper-opt-1.3b's full config")
            sfl = dataclasses.replace(run.sfl, perturbation_dist=dist)
            res, ctl, n, chunks = drive(dev, name, run, sfl, kernels)
            for k, v in n.items():
                launches[k] = launches.get(k, 0) + v
            noise = ({"zo_update", "zo_replay"} if dist == "gaussian"
                     else {"threefry"})
            require(not any(n.get(k) for k in noise),
                    f"{name}: a kernel of the other noise launched")
            summary[algorithm] = dict(
                masks=np.concatenate([c[0] for c in chunks]),
                sim_t=res.sim_time, round_times=list(res.round_times),
                seconds=[c[1] / len(c[0]) for c in chunks],
                peak=[c[2] for c in chunks], losses=list(res.round_loss),
                tau=list(res.tau_per_round))
            if ctl is not None:
                print(f"{name}: tau decisions {ctl.trace} "
                      f"({ctl.source} clock)")
                require(bool(ctl.trace), f"{name}: adaptive tau made no "
                        f"decision")
            del run, res, ctl
        rows = obs.read_jsonl(log, kind="round")
        chunk_rows = obs.read_jsonl(log, kind="chunk")
        require(len(rows) == 4 and len(chunk_rows) == 2,
                f"paper path: the run log has {len(rows)} round and "
                f"{len(chunk_rows)} chunk rows, not 4 and 2")
        for c in chunk_rows:
            meas = [t for t in c["telemetry"] if t["source"] == "measured"]
            require(len(meas) == 1 and meas[0]["start"] == c["start"]
                    and meas[0]["stop"] == c["stop"]
                    and min(meas[0]["durations"]) > 0,
                    f"paper path: chunk {c['start']}-{c['stop']} has no "
                    f"measured record with positive durations")
            print(f"paper path (mu_splitfed) measured chunk {c['start']}-"
                  f"{c['stop']}: dispatch {meas[0]['dispatch_seconds']:.3f} "
                  f"s, staging {meas[0]['staging_seconds'] * 1e3:.3f} ms "
                  f"({meas[0]['staging_bytes']} bytes)")
        spans = [e["name"] for e in
                 json.load(open(trace))["traceEvents"]]
        require(spans.count("engine.dispatch") == 2,
                f"paper path: {spans.count('engine.dispatch')} "
                f"engine.dispatch spans in the trace, not 2")
    masks = [v["masks"] for v in summary.values()]
    require(all(np.array_equal(m, masks[0]) for m in masks),
            "paper path: the three runs consumed different masks")
    require(bool((summary["gas"]["masks"] == 0).any()),
            "paper path: GAS had no stale client")
    for algorithm, v in summary.items():
        print(f"paper path comparison, {algorithm}: sim_t {v['sim_t']}  "
              f"simulated round times {v['round_times']}  tau "
              f"{v['tau']}  seconds a round by chunk {v['seconds']}  peak "
              f"GiB by chunk {v['peak']}  losses {v['losses']}")
    return launches, summary


def peak_sites(events, top: int = 8):
    """Replay an allocator trace (``torch.cuda.memory._snapshot()``'s
    device trace: alloc and free events with Python stacks) and return
    (peak bytes above the trace's start, [(bytes, site)]) for the blocks
    live at the peak, grouped by the innermost frame of the port's own
    code that allocated them."""
    def replay(stop):
        live, total, best, at = {}, 0, 0, -1
        for i, e in enumerate(events[:stop]):
            if e["action"] == "alloc":
                live[e["addr"]] = e
                total += e["size"]
                if total > best:
                    best, at = total, i
            elif e["action"] in ("free_requested", "free") \
                    and e["addr"] in live:
                total -= live.pop(e["addr"])["size"]
        return live, best, at
    _, best, at = replay(len(events))
    live, _, _ = replay(at + 1)
    sites = {}
    for e in live.values():
        frames = [f for f in e.get("frames", ())
                  if "repro_torch" in f.get("filename", "")]
        f = frames[0] if frames else None
        site = (f"{f['filename'].split('src/')[-1]}:{f['line']} {f['name']}"
                if f else "outside the port's code")
        sites[site] = sites.get(site, 0) + e["size"]
    return best, sorted(((b, k) for k, b in sites.items()), reverse=True)[:top]


def fo_memory(dev, run) -> None:
    """Where one FedAvg client's memory goes on path 5: each step of
    ``fedavg_round``'s client loop bracketed by the allocator, as the peak
    above what was allocated before the step and what the step keeps. The
    gradient is taken twice on one random batch of the run's shape: by
    ``loss_fn`` (each stacked leaf unbound once) and by the client/server
    composition of the zeroth-order rounds (``split_params`` slices each
    leaf in two, and each slice's backward fills a zero gradient of the
    whole leaf); the two gradients must agree."""
    from repro_torch.core.baselines import (_fedavg_aggregate, _grads,
                                            fedavg_round)
    from repro_torch.models import (client_forward, loss_fn, server_forward,
                                    split_params)
    from repro_torch.optim.optimizers import sgd_update
    from repro_torch.utils import tree
    cfg, params, a = run.cfg, run.params, run.args
    gen = torch.Generator(device=dev).manual_seed(a.seed)
    tokens = torch.randint(cfg.vocab_size, (a.batch, a.seq + 1),
                           generator=gen, device=dev)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    gib = 2.0 ** -30

    def bracket(what, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        out = fn()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated(dev) - base) * gib
        kept = (torch.cuda.memory_allocated(dev) - base) * gib
        print(f"FedAvg client memory, {what}: peak {peak:.3f} GiB above "
              f"the {base * gib:.3f} GiB before it, keeps {kept:.3f} GiB")
        return out

    def sliced(q):
        cp, sp = split_params(cfg, q, cfg.default_cut_units)
        return server_forward(cfg, sp, client_forward(cfg, cp, batch), batch)

    size = sum(x.numel() * x.element_size() for x in tree.leaves(params))
    print(f"FedAvg client memory: parameters {size * gib:.3f} GiB")
    g = bracket("gradient by loss_fn",
                lambda: _grads(lambda q: loss_fn(cfg, q, batch), params))
    g2 = bracket("gradient by split_params' slices", lambda: _grads(sliced,
                                                                    params))
    err = max(max_err(x, y) for x, y in zip(tree.leaves(g), tree.leaves(g2)))
    top = max(float(x.abs().max()) for x in tree.leaves(g))
    print(f"FedAvg client memory: the two gradients max |Δ| {err:.3e} "
          f"(largest |g| {top:.3e})")
    require(math.isfinite(top) and err <= 2 ** -8 * top,
            "FedAvg client memory: the two gradients disagree")
    del g2
    p_m = bracket("SGD update", lambda: sgd_update(params, g, a.lr_client))
    del g
    out = bracket("aggregate of one client (f32 sum, new tree)",
                  lambda: _fedavg_aggregate(params, lambda m: p_m,
                                            torch.ones(1, device=dev), 1.0))
    del p_m, out
    # one whole round of the run's M clients, its peak taken apart by the
    # code that allocated what was live at it
    M = run.sfl.n_clients
    toks = torch.randint(cfg.vocab_size, (M, a.batch, a.seq + 1),
                         generator=gen, device=dev)
    batches = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.memory._record_memory_history(enabled="all", context="all",
                                             stacks="python")
    try:
        out = fedavg_round(cfg, params, batches, torch.ones(M, device=dev),
                           a.lr_client, eta_g=run.sfl.lr_global)
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    del out
    peak, sites = peak_sites(snap["device_traces"][0])
    print(f"FedAvg round memory ({M} clients): peak {peak * gib:.3f} GiB "
          f"above the {base * gib:.3f} GiB before it; live at the peak:")
    for b, site in sites:
        print(f"  {b * gib:8.3f} GiB  {site}")


def phase_fo_paper(dev, zo_summary) -> dict:
    """Path 5, the first-order side of Fig. 4: the reference driver's
    FedAvg and FedLoRA (one local SGD step at lr_client, η_g = lr_global;
    LoRA rank 4, alpha 16 on wq and wv) on paper-opt-1.3b at its full
    config with path 4's flags and schedule (``PAPER_ARGV``), through
    ``train.setup`` + ``drive``. Each round trains every one of the M
    clients through the flash forward and backward kernels: 2·M·24 flash
    forwards a round (each client's loss, then its training forward) and
    M·24 backwards, checked exactly; no noise kernel launches. FedAvg's
    parameters must move; FedLoRA's base must not, and its adapters must
    leave their initial values. Prints each run's seconds a round, peak
    memory, losses and simulated total beside path 4's zeroth-order
    runs. Returns the launch counts."""
    import numpy as np
    from repro_torch.core import engine
    from repro_torch.launch import train
    from repro_torch.utils import tree
    launches, summary = {}, {}
    for algorithm in ("fedavg", "fedlora"):
        name = f"FO paper path ({algorithm})"
        torch.cuda.empty_cache()
        run = train.setup([*PAPER_ARGV, "--algorithm", algorithm])
        cfg = run.cfg
        require(cfg.n_layers == 24 and cfg.d_model == 2048
                and cfg.d_head == 64 and cfg.vocab_size == 50272,
                f"{name}: not paper-opt-1.3b's full config")
        if algorithm == "fedavg":
            fo_memory(dev, run)
        res, _, n, chunks = drive(dev, name, run, run.sfl,
                                  ("flash_attention", "flash_attention_bwd"),
                                  frozen=algorithm == "fedlora")
        M, R, L = run.sfl.n_clients, run.args.rounds, cfg.n_layers
        require(n.get("flash_attention") == R * 2 * M * L
                and n.get("flash_attention_bwd") == R * M * L,
                f"{name}: launches {n}, not {R * 2 * M * L} flash forwards "
                f"and {R * M * L} backwards")
        require(not any(n.get(k) for k in ("zo_update", "zo_replay",
                                           "threefry")),
                f"{name}: a noise kernel launched on a first-order run")
        if algorithm == "fedlora":
            init = engine.get_algorithm("fedlora").init_state(
                cfg, run.sfl, run.params, None)
            moved = max(max_err(a, b) for a, b in
                        zip(tree.leaves(res.state), tree.leaves(init)))
            print(f"{name}: adapters max |Δ| from their init {moved:.3e}")
            require(moved > 0, f"{name}: the adapters did not move")
        for k, v in n.items():
            launches[k] = launches.get(k, 0) + v
        summary[algorithm] = dict(
            masks=np.concatenate([c[0] for c in chunks]), sim_t=res.sim_time,
            seconds=[c[1] / len(c[0]) for c in chunks],
            peak=[c[2] for c in chunks], losses=list(res.round_loss))
        del run, res
    require(np.array_equal(summary["fedavg"]["masks"],
                           zo_summary["mu_splitfed"]["masks"]),
            "FO paper path: another schedule than path 4's")
    for algorithm, v in {**summary, **zo_summary}.items():
        print(f"Fig. 4 on the card, {algorithm}: peak GiB by chunk "
              f"{v['peak']}  seconds a round by chunk {v['seconds']}  "
              f"sim_t {v['sim_t']}  losses {v['losses']}")
    return launches


def phase_qwen_fo(dev) -> dict:
    """One FedAvg round (2 clients) of qwen3-14b at its full published
    width with its depth cut to QWEN_FO_LAYERS of 40 layers, through the
    driver: the RMSNorm backward runs inside a real backward (per client
    two block norms and the qk-norm's q and k a layer, and the final norm:
    4·layers + 1 launches), beside the flash backward at d_head 128 with
    GQA 40/8. Returns the launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    name = f"qwen3-14b FedAvg ({QWEN_FO_LAYERS} of 40 layers)"
    torch.cuda.empty_cache()
    run = train.setup(QWEN_FO_ARGV, cfg=get_config("qwen3-14b").replace(
        n_layers=QWEN_FO_LAYERS))
    n = drive(dev, name, run, run.sfl, ("flash_attention",
                                        "flash_attention_bwd", "rmsnorm",
                                        "rmsnorm_bwd"))[2]
    M, L = run.sfl.n_clients, QWEN_FO_LAYERS
    require(n.get("rmsnorm_bwd") == M * (4 * L + 1)
            and n.get("flash_attention_bwd") == M * L,
            f"{name}: launches {n}, not {M * (4 * L + 1)} rmsnorm and "
            f"{M * L} flash backwards")
    return n


def profile_round(name: str, fn):
    """One round of a path (``fn``) under torch.profiler: device time by
    kernel, and the device's busy share of the round's wall time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels)
    print(f"{name} profiled round: wall {wall_us / 1e3:.1f} ms (profiler "
          f"on), device busy {busy / 1e3:.1f} ms = {busy / wall_us:.1%}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.self_device_time_total / max(busy, 1):6.1%} "
              f"x{e.count:<5d} {e.key[:90]}")
    for e in kernels:           # the port's own kernels, per launch
        m = PORT_KERNEL.search(e.key)
        if m:
            print(f"  {m.group(0)}: x{e.count} "
                  f"{e.self_device_time_total / 1e3:.3f} ms, "
                  f"{e.self_device_time_total / e.count:.2f} us a launch")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_card()
    zo_sass, tf_sass = phase_build()
    zo = phase_zo(dev, zo_sass)
    flash = phase_flash(dev)
    norm = phase_rmsnorm(dev)
    tf = phase_threefry(dev, tf_sass)
    flash_bwd = phase_flash_bwd(dev)
    norm_bwd = phase_rmsnorm_bwd(dev)
    phase_small_round(dev)
    phase_small_fo(dev)
    from repro_torch.configs import get_config
    launches = phase_path(dev, "olmo-1b path", OLMO_ARGV, None,
                          ("zo_update", "zo_replay", "flash_attention"))
    torch.cuda.empty_cache()
    qwen = get_config("qwen3-14b").replace(n_layers=QWEN_LAYERS)
    for k, n in phase_path(dev, f"qwen3-14b path ({QWEN_LAYERS} of 40 "
                           f"layers)", QWEN_ARGV, qwen,
                           ("zo_update", "zo_replay", "flash_attention",
                            "rmsnorm")).items():
        launches[k] = launches.get(k, 0) + n
    torch.cuda.empty_cache()
    for k, n in phase_driver(dev).items():
        launches[k] = launches.get(k, 0) + n
    torch.cuda.empty_cache()
    paper_launches, zo_summary = phase_paper(dev)
    for k, n in paper_launches.items():
        launches[k] = launches.get(k, 0) + n
    torch.cuda.empty_cache()
    for k, n in phase_fo_paper(dev, zo_summary).items():
        launches[k] = launches.get(k, 0) + n
    for k, n in phase_qwen_fo(dev).items():
        launches[k] = launches.get(k, 0) + n
    src = "src/repro_torch/kernels/csrc/"
    rows = [("zo_update", src + "zo_update.cu",
             "src/repro/kernels/zo_update.py:79", zo["zo_update"]),
            ("zo_replay", src + "zo_update.cu",
             "src/repro/kernels/zo_update.py:119", zo["zo_replay"]),
            ("flash_attention", src + "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:86", flash),
            ("rmsnorm", src + "rmsnorm.cu",
             "src/repro/kernels/rmsnorm.py:23", norm),
            # no Pallas kernel: the counterpart of jax.random.normal (XLA's
            # threefry and erfinv) in the reference's tree_noise
            ("threefry", src + "threefry.cu", "src/repro/core/zo.py:125",
             tf),
            # no Pallas kernels: the reference's gradients are XLA's
            # autodiff of its einsum attention and its jnp RMSNorm
            ("flash_attention_bwd", src + "flash_attention_bwd.cu",
             "src/repro/models/attention.py:91", flash_bwd),
            ("rmsnorm_bwd", src + "rmsnorm.cu",
             "src/repro/models/layers.py:47", norm_bwd)]
    for name, *_ in rows:
        require(launches.get(name, 0) > 0,
                f"kernel {name} was launched on no path")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": rep,
         "launches": launches.get(name, 0), "max_abs_err": r["err"],
         "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"],
         "shape": r["shape"]}
        for name, source, rep, r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
