#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card, and hold every
kernel of that path against its plain PyTorch version there.

    python3 chip_smoke.py

Phases (each raises on failure; the exit code is 0 only if all pass):
  1. the card's name and power limit, torch and CUDA versions;
  2. build the kernels from src/repro_torch/kernels/csrc (one nvcc process
     per source, all at once) and print the seconds; beside them,
     flash_attention.cu, flash_attention_bwd.cu, zo_update.cu,
     threefry.cu, rmsnorm.cu, selective_scan.cu, selective_scan_bwd.cu,
     slstm.cu and slstm_bwd.cu with -Xptxas -v: the kernels' registers,
     shared memory, stack frames and spills are printed (the bf16 flash
     kernels, every flash backward kernel, each (d_qk, d_v) pair's, every
     rmsnorm backward kernel, the thirteen selective-scan kernels, forward
     and backward, the forty sLSTM kernels, inference and saving, and the
     twenty sLSTM backward kernels must not spill); the
     built library's
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
     shapes of the paths below (the flash kernel's MLA pair (192, 128) in
     f32 and bf16 at path 9's round and prefill shapes, and rmsnorm at
     path 9's kv_norm and q_norm widths); the counter
     noise u bit-equal to the plain
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
     forward's lse beside it, and at MLA's (192, 128) pair at (1,128,512)
     and (1,128,4096) with v and dO strided views; rmsnorm_bwd, one
     launch a call, at the qwen3-14b block shape and its qk-norm pair in
     one launch, at MLA's kv_norm and q_norm widths 512 and 1536 and at
     (1,4096,5120), two calls bit-equal) against their plain versions, f32
     within 1e-5 and bf16 within one bf16 ulp of each gradient's largest
     magnitude,
     with the autograd backward of scaled_dot_product_attention and of
     F.rms_norm timed beside them; the selective scan (Mamba) against its
     plain version at path 10's round, prefill and decode shapes
     (d_inner 16384, d_state 16) and at the card SMOKE's d_state 4, f32
     within 1e-5 and bf16 within two ulps, from a nonzero h0, two
     launches bit-equal, h_out = h0 equal to a new h_last, and z, B and
     C read in place as the Mamba block's strided views equal to
     contiguous copies; each instance's launch geometry first (lanes a
     channel, registers, shared memory, blocks an SM); and the scan's
     backward (selective_scan_bwd) against its plain version at path 10
     (c)'s round shape, at 4096 tokens and at the card SMOKE's d_state 4,
     f32 and bf16, from a nonzero h0 and dh_last, each gradient within
     1e-5 (f32) or 2^-7 (bf16) of its largest magnitude, two calls
     bit-equal and z, B and C read in place; its geometry first (cluster
     size, barriers a chunk, registers, shared memory, blocks an SM); the
     sLSTM recurrence (slstm) against its plain version at path 11's
     round, prefill, 4 x 512 serving prefill and decode shapes (head dim
     256, a cluster a head and group of batch rows) in bf16 (and f32 at
     the round and decode) and at the card SMOKE's and SMOKE's head dims
     32 and 16 in f32, from a nonzero state: hs within 1e-5 of max|hs|
     (f32) or two bf16 ulps of each element, the state within 1e-5; two
     launches bit-equal, the state as out equal; each instance's geometry
     first (cluster size, batch rows a cluster, columns, registers, shared
     memory, clusters at once) and each case's waves, each case's time a
     token step beside; and the sLSTM backward (slstm_bwd) against its
     plain version (ref.slstm_bwd_ref) at path 11's round shape in bf16
     and f32, its grouped rows (4,512) and a 4096-token chain in bf16,
     from a nonzero state with nonzero cotangents, both on the saving
     forward's record: dx_pre within 2^-7 (bf16) or 1e-5 (f32), db, dr
     and the state's cotangents within 1e-5, of each output's largest
     magnitude; two launches bit-equal; the saving forward's hs and state
     bit-equal to the inference forward's, its record within the
     forward's tolerance of the plain record;
     each case's time a token step beside the forward's;
  4. small f32 rounds on the card against the same rounds on the CPU
     (MU-SplitFed under counter, gaussian and sphere noise, dense and
     seed_replay; vanilla SplitFed; GAS with a stale client; each on
     olmo-1b, and MU-SplitFed and GAS on mixtral-8x22b SMOKE widened to
     d_head 64 and on deepseek-v2-236b SMOKE widened to MLA's (192, 128);
     FedAvg with SGD and AdamW, FedLoRA, and FedAvg with SGD on
     deepseek-v2-236b at (192, 128); MU-SplitFed and GAS, FedAvg with SGD
     and FedLoRA on jamba-1.5-large-398b SMOKE widened to d_head 64;
     MU-SplitFed and GAS, FedAvg with SGD and FedLoRA on xlstm-350m SMOKE
     at d_model 128) and
     small f32
     serving (mixtral-8x22b past its window, qwen3-14b, deepseek-v2-236b,
     jamba-1.5-large-398b, xlstm-350m), then
     the training paths through the
     training driver (``launch.train``:
     setup, then run_engine, which runs engine.run_rounds), each with every
     kernel launch counter set to 0 just before and read just after, and
     each followed by one more round under torch.profiler for the device
     time by kernel:
       - olmo-1b at its full config (LayerNorm; no rmsnorm), counter
         noise, full participation, 3 rounds, one a chunk;
       - qwen3-14b at its full published width (RMSNorm, qk-norm, GQA
         40/8), its depth cut to 8 of 40 layers, as the first. A dense
         model's ZO round holds about 3.9x the parameter bytes (olmo-1b:
         9.18 GiB for 1.28 B parameters), so the full 14.8 B model (27.5
         GiB in bf16) would need about 106 GiB; 8 layers are 4.20 B
         parameters (16 until path 7 joined, to keep this script's run
         near 600 s). An MoE round holds less beside its experts, whose
         activations are few: mixtral-8x22b at 3 layers measured 43.54
         GiB for 14.74 GiB of parameters, 2.95x
         (MOE_ROUND_BYTES_PER_PARAM_BYTE);
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
         runs the rmsnorm backward (3·layers + 1 launches a client: the
         qk-norm pair's backward is one);
       - path 6, checkpoint and resume on path 4's model, flags and
         schedule: MU-SplitFed (adaptive tau on the simulated clock,
         params-only checkpoints), GAS (seed replay, counter noise; its
         activation buffer checkpointed) and FedLoRA (its adapters
         checkpointed), each run 4 rounds uninterrupted, then 2 rounds
         with --ckpt-dir and --ckpt-every 2 and resumed by a fresh setup
         for rounds 2-3: losses equal and every parameter and state leaf
         torch.equal; save, wait, restore and verify seconds and the
         checkpoint's GiB printed;
       - path 7, the semi-async event engine on path 4's model, flags
         and schedule (quorum 2, staleness discount 0.5, tau 2, seed
         replay, 4 versions in chunks of 2): (a) the dense timeline,
         whose per-version start sets, apply weights, durations and
         quorum waits must equal the host compile_timeline's; (b) the
         sparse timeline with subset staging, its round times equal to
         (a)'s and its losses and parameters within one bf16 ulp; (c)
         crash, loss, duplicate and corrupt faults with a quorum timeout
         and the adaptive quorum, the fault counters equal to the host
         timeline's; (d) the driver SIGKILLed by --faults kill=2 in a
         subprocess and resumed by a second, its final checkpoint equal
         leaf by leaf to an uninterrupted run's (``phase_async``);
     and path 8, serving and the MoE family (``phase_serve``), through
     ``serve.generate`` with every counter set to 0 before each request:
     (a) qwen3-14b at full width, 8 of 40 layers, 4 requests of 512-token
     prompts, greedy, 32 new tokens; (b) mixtral-8x22b at full width, 3
     of 56 layers (7.91 B parameters), one 4160-token prompt past its
     4096 window, 16 new tokens, at its capacity factor and at 4.0; each
     request's prefill and decode steps held against the card's own
     logits_fn (bf16, PREFILL_TOL and DECODE_TOL); (c) one MU-SplitFed
     round of (b)'s model through the driver (counter noise, seed replay,
     M=2, tau=2, seq 512) with its peak memory against the reckoning;
     and path 9, MLA and deepseek-v2-236b (``phase_mla``): (a) serving at
     full width, 3 of 60 layers (MLA through the flash kernel at head
     dims (192, 128), the compressed-cache decode, 160 experts top-6 and
     2 shared), a 4096-token prompt and 16 new tokens in bf16, then a
     512-token prompt and 8 tokens in f32 at capacity factor 160/6, each
     decode step held against logits_fn; (b) one MU-SplitFed round of
     (a)'s model through the driver, as path 8 (c); (c) one FedAvg round
     of (a)'s model with 32 of its 160 routed experts through the driver
     (the flash backward at (192, 128), M·L launches, and the rmsnorm
     backward, M·(4·L + 1)), its peak beside the reckoning;
     and path 10, the Mamba hybrid jamba-1.5-large-398b (``phase_jamba``)
     at full width on one unit, 8 of 72 layers: (a) serving in bf16 with
     8 of its 16 experts (25.9 B parameters), a 4096-token prompt and 16
     new tokens (the selective scan at S = 4096 and 1), then the f32
     decode-vs-full check with 2 experts at capacity factor 1.0 on a
     512-token prompt; (b) one MU-SplitFed round of the 2-expert model
     (11.4 B) through the driver, its peak beside the reckoning; (c) one
     FedLoRA round of (b)'s model through the driver, the selective scan's
     backward launched for the 4 Mamba blocks behind the adapters, its
     peak beside the reckoning (FedAvg, at 5x its parameter bytes or more,
     does not fit the card);
     and path 11, xLSTM (``phase_xlstm``): xlstm-350m at its full
     published config (24 layers, d_model 1024, mlstm x3 then slstm, no
     FFN, vocab 50304; nothing cut): (a) serving in bf16, 4 x 512-token
     prompts and 32 new tokens, then one 4096-token prompt and 16, then
     the f32 decode-vs-full check (512 tokens, 8 new); (b) path 1's
     MU-SplitFed run through the driver (3 rounds) and one profiled
     round; every request's and the run's zo_update, zo_replay, rmsnorm
     and slstm launches equal to the counts derived from their structure
     (``xlstm_request_launches``, ``zo_round_launches``: 76 sLSTM launches
     a round); (c) one FedAvg round (SGD) and (d) one FedLoRA round
     through the driver (M=2, batch 1, seq 512), the sLSTM backward
     launched for each client's 6 sLSTM blocks, every leaf (FedAvg) or
     every LoRA B (FedLoRA; A's gradient is 0 at the reference's B = 0)
     moved and FedLoRA's base untouched, each peak beside its reckoning;
  5. one JSON line with every kernel's numbers (launches summed over the
     paths; the flash row and the flash backward's row carry their MLA
     instance's numbers under "mla", with the launches the wrappers
     counted at the (192, 128) pair, the rmsnorm backward's row its
     MLA widths', the selective scan's row, at path 10's round shape,
     its prefill's under "tokens_4096" and its decode's under "decode",
     and its backward's row at the round shape, the 4096-token case under
     "tokens_4096"; the sLSTM's row at path 11's round shape, its prefill's
     under "tokens_4096", its 4 x 512 serving prefill's under
     "serve_prefill" and its decode's under "decode"; its backward's row
     at the round shape (ms the whole call, the chain's launch under
     "chain_ms"), the 4096-token chain under "tokens_4096" and the grouped
     rows under "grouped_rows"), then the result line.

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
f32 CUDA cores for the noise kernels, the norm and the sLSTM recurrence
and its backward,
and for the selective scan its exponentials, logarithms and reciprocals on
the SFU at 16 a clock an SM, 132 SMs at 1980 MHz); published H100 SXM
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
# the SFU (MUFU: exp2, log2, reciprocal) issues 16 operations a clock an SM
# (Hopper's throughput table), on 132 SMs at the 1980 MHz boost clock
PEAK_OPS_PER_S = {"bf16_tensor": 989e12, "f32_core": 67e12,
                  "mufu": 16 * 132 * 1980e6}
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
QWEN_LAYERS = 8             # of 40: the depth cut of the qwen3-14b path
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
                         r"rmsnorm_block|rmsnorm_pair|rmsnorm_bwd|"
                         r"rmsnorm_bwd_wide|selective_scan|"
                         r"selective_scan_bwd|"
                         r"threefry_update|threefry_sumsq)_kernel<[^>]*>|"
                         r"threefry_sumsq_kernel|flash_bwd_dkdv_sum_kernel|"
                         r"selective_scan_bwd_sum_kernel")
# operations of the RMSNorm backward per element
NORM_BWD_OPS = 10


def scan_mufu_ops(N: int) -> int:
    """MUFU operations of the selective scan per (token, channel): N
    exponentials for exp(δ·A), 2 for softplus (exp, log1p) and 2 for
    silu(z) (exp, the reciprocal of its division)."""
    return N + 4


def scan_bytes(B: int, S: int, d_in: int, N: int, elem: int) -> int:
    """Bytes the selective scan must move: x, z and y in the model type
    and dt in f32 per (token, channel); B and C per token; h0 and h_last;
    A_log, D and dt_bias once."""
    return (B * S * d_in * (3 * elem + 4) + 2 * B * S * N * 4
            + 2 * B * d_in * N * 4 + d_in * N * 4 + 2 * d_in * 4)


def scan_bwd_mufu_ops(N: int) -> int:
    """MUFU operations the selective scan's gradient needs per (token,
    channel): N exponentials for the decays exp(δ·A) (h recomputed once),
    2 for softplus (exp, log1p), 1 for sigmoid(v) (a reciprocal beside
    softplus's exp) and 2 for silu'(z) (exp, reciprocal). The kernel
    issues about N more (it recomputes h twice, but for each chunk's last
    sub-chunk) and 2 more (silu(z)'s exponential and reciprocal again for
    dz)."""
    return N + 5


def scan_bwd_bytes(B: int, S: int, d_in: int, N: int, elem: int,
                   chunk: int = 32) -> int:
    """Bytes the scan's gradient must move: x, z and dy in the model type
    and dt in f32 read, dx and dz in the model type and ddt in f32 written,
    per (token, channel); B and C read and dB and dC written per token; the
    forward's h at each chunk's start read (the first is h0); dh_last read
    and dh0 written; A_log, D and dt_bias read and their gradients
    written."""
    return (B * S * d_in * (5 * elem + 8) + 4 * B * S * N * 4
            + B * -(-S // chunk) * d_in * N * 4 + 2 * B * d_in * N * 4
            + 2 * d_in * N * 4 + 4 * d_in * 4)


def flash_bwd_ops(d_qk: int, d_v: int) -> int:
    """Operations of the flash backward per unmasked (query, key) pair: S,
    dK and dQ at 2·d_qk each, dP and dV at 2·d_v each (10·d where the
    dims are equal)."""
    return 2 * (3 * d_qk + 2 * d_v)


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
    builds of flash_attention.cu, flash_attention_bwd.cu, zo_update.cu,
    threefry.cu, rmsnorm.cu, selective_scan.cu, selective_scan_bwd.cu,
    slstm.cu and slstm_bwd.cu.
    Returns the zo
    kernels' SASS instructions per gaussian and the threefry kernels' per
    element."""
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
                    "zo_update.cu", "threefry.cu", "rmsnorm.cu",
                    "selective_scan.cu", "selective_scan_bwd.cu",
                    "slstm.cu", "slstm_bwd.cu")}
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
    report_ptxas_norm_bwd(ptxas_out["rmsnorm.cu"])
    report_ptxas_scan(ptxas_out["selective_scan.cu"]
                      + ptxas_out["selective_scan_bwd.cu"])
    report_ptxas_slstm(ptxas_out["slstm.cu"] + ptxas_out["slstm_bwd.cu"])
    lib = build.library()
    for d, dv in FLASH_PAIRS:
        print(f"flash_fwd_bf16_kernel<{d}, {dv}>: dynamic shared memory "
              f"{lib.flash_attention_smem_bytes(d, dv, 1)} bytes, "
              f"{lib.flash_attention_blocks_per_sm(d, dv, 1)} blocks per SM; "
              f"f32 flash_fwd_kernel<{d}, {dv}>: "
              f"{lib.flash_attention_smem_bytes(d, dv, 0)} bytes, "
              f"{lib.flash_attention_blocks_per_sm(d, dv, 0)} blocks per SM")
    check_sass(build.compile_library())
    return (zo_sass_report(build.compile_library(), ptxas_out["zo_update.cu"]),
            threefry_sass_report(build.compile_library(),
                                 ptxas_out["threefry.cu"]))


# the forward kernels' (d_qk, d_v) template pairs: the GQA models' and MLA's
FLASH_PAIRS = ((64, 64), (128, 128), (192, 128))
FLASH_KERNEL = re.compile(r"(flash_fwd(?:_bf16)?_kernel)ILi(\d+)ELi(\d+)E")


def flash_name(m) -> str:
    return f"{m.group(1)}<{m.group(2)}, {m.group(3)}>"


def report_ptxas(out: str) -> None:
    """Print ptxas's lines for each flash kernel; the bf16 kernels (the
    tensor-core ones, on every path) must not spill."""
    name, seen = None, set()
    for line in out.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            m = FLASH_KERNEL.search(line)
            name = flash_name(m) if m else None
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
    require(seen == {f"flash_fwd_bf16_kernel<{d}, {dv}>"
                     for d, dv in FLASH_PAIRS},
            f"ptxas -v reported no spill line for the bf16 flash kernels "
            f"(found {sorted(seen)})")


# the backward's kernels: f32 and bf16 (``_bf16``) of each (d_qk, d_v)
# pair (Δ's of each d_v), and the bf16 dK/dV partials' sum of each pair
BWD_KERNEL = re.compile(r"(flash_bwd_(?:delta|dkdv|dq|dkdv_sum)(?:_bf16)?"
                        r"_kernel)ILi(\d+)E(?:Li(\d+)E)?")
BWD_KERNELS = 19
# the bf16 flash kernels that must run on the tensor cores (HMMA in SASS):
# the forward's and the backward's dK/dV and dQ at the three pairs
TC_KERNEL = re.compile(r"(flash_(?:fwd|bwd_dkdv|bwd_dq)_bf16_kernel)"
                       r"ILi(\d+)ELi(\d+)E")
TC_KERNELS = 9


def bwd_name(m) -> str:
    return m.group(1) + (f"<{m.group(2)}, {m.group(3)}>" if m.group(3)
                         else f"<{m.group(2)}>")


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


# the rmsnorm backward's kernels: the pass's instances (dtype, V elements a
# pack, G lanes a row, PL packs a lane, the qk pair or one tensor), the
# reread branch's of each dtype and pack, and the dscale sum
NORM_BWD_KERNEL = re.compile(
    r"(rmsnorm_bwd_kernel)I(13__nv_bfloat16|f)Li(\d+)ELi(\d+)ELi(\d+)"
    r"ELb([01])E|(rmsnorm_bwd_wide_kernel)I(13__nv_bfloat16|f)Li(\d+)EE|"
    r"(rmsnorm_dscale_sum_kernel)")
NORM_BWD_KERNELS = 40


def norm_bwd_name(m) -> str:
    if m.group(1):
        dtype = "bf16" if m.group(2) != "f" else "f32"
        return (f"rmsnorm_bwd_kernel<{dtype}, V{m.group(3)}, G{m.group(4)}, "
                f"PL{m.group(5)}" + (", pair>" if m.group(6) == "1" else ">"))
    if m.group(7):
        dtype = "bf16" if m.group(8) != "f" else "f32"
        return f"rmsnorm_bwd_wide_kernel<{dtype}, V{m.group(9)}>"
    return m.group(10)


def report_ptxas_norm_bwd(out: str) -> None:
    """Print ptxas's registers, shared memory and spills for each kernel of
    the rmsnorm backward; none may spill."""
    name, seen, lines = None, set(), {}
    for line in out.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            m = NORM_BWD_KERNEL.search(line)
            name = norm_bwd_name(m) if m else None
            continue
        if name is None or not line.strip():
            continue
        if "Compile time" not in line:
            lines.setdefault(name, []).append(line.split(":", 1)[-1].strip())
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", line)
        if spills:
            seen.add(name)
            require(spills.groups() == ("0", "0"),
                    f"{name} spills registers: {line.strip()}")
    for name in sorted(lines):
        print(f"ptxas {name}: " + "; ".join(lines[name]))
    require(len(seen) == NORM_BWD_KERNELS, f"ptxas -v reported spill lines "
            f"for {len(seen)} rmsnorm backward kernels, not "
            f"{NORM_BWD_KERNELS}: {sorted(seen)}")


# the selective scan's instances: f32 and bf16 at d_state 4 and 16, each
# at its lanes a channel (G); the forward without and with the chunk
# starts saved for the backward (kSave), the backward, and the backward's
# sum launch
SCAN_KERNEL = re.compile(r"(selective_scan(?:_bwd)?_kernel)I"
                         r"(13__nv_bfloat16|f)Li(\d+)ELi(\d+)E(?:Lb([01])E)?E"
                         r"|selective_scan_bwd_sum_kernel")
SCAN_KERNELS = 13


def scan_name(m) -> str:
    if m.group(1) is None:
        return m.group(0)
    save = "" if m.group(5) is None else (", save" if m.group(5) == "1"
                                          else ", no save")
    return (f"{m.group(1)}<{'bf16' if m.group(2) != 'f' else 'f32'}, "
            f"{m.group(3)}, {m.group(4)}{save}>")


def report_ptxas_scan(out: str) -> None:
    """Print ptxas's registers, shared memory and spills for each
    selective-scan kernel, forward and backward; none may spill."""
    name, seen = None, set()
    for line in out.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            m = SCAN_KERNEL.search(line)
            name = scan_name(m) if m else None
            continue
        if name is None or not line.strip() or "Compile time" in line:
            continue
        print(f"ptxas {name}: {line.split(':', 1)[-1].strip()}")
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", line)
        if spills:
            seen.add(name)
            require(spills.groups() == ("0", "0"),
                    f"{name} spills registers: {line.strip()}")
    require(len(seen) == SCAN_KERNELS, f"ptxas -v reported spill lines for "
            f"{sorted(seen)}, not the {SCAN_KERNELS} selective-scan kernels "
            f"(forward with and without the saved chunk starts, backward "
            f"and its sum)")


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
            counts[flash_name(m)] = section.count("HMMA")
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
    128 over 40 query and 8 kv heads), f32 and bf16, at path 8's and path 9's
    (mixtral's 6144, deepseek-v2-236b's kv_norm of 512 and q_norm of 1536
    in prefill, the round and decode), and at row counts and
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
             ("D=1030, element loads", (77, 1030), f32),
             ("mixtral-8x22b prefill block norm (path 8)", (1, 4160, 6144),
              bf16),
             ("qwen3-14b decode block norm (path 8)", (4, 1, 5120), bf16)]
    # path 10's jamba-1.5-large-398b block norms (d_model 8192): the
    # round's and the f32 check's 512 rows, prefill's 4096
    for rows in (512, 4096):
        for dtype in (bf16, f32):
            cases.append(("jamba-1.5-large-398b block norm (path 10)",
                          (1, rows, 8192), dtype))
    # path 9's MLA norms: kv_norm on the 512-wide latent (32 lanes a row,
    # in bf16 the only case of that instance), q_norm on the 1536-wide q
    # latent (a block a row), over prefill's and the round's rows and a
    # decode row, bf16, and f32 as the f32 serving check runs them
    for label, rows, dtype in (("prefill", 4096, bf16), ("round", 512, bf16),
                               ("decode", 1, bf16), ("f32 check", 512, f32),
                               ("f32 decode", 1, f32)):
        for norm, D in (("kv_norm", 512), ("q_norm", 1536)):
            cases.append((f"deepseek-v2-236b {norm} {label} (path 9)",
                          (1, rows, D), dtype))
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


# the selective scan's cases: (label, (B, S, d_in, N)); path 10's round
# (512 tokens), prefill (4096) and decode (1) at jamba's published d_inner
# and d_state, and the card-sized SMOKE's N = 4 (d_inner 256)
SCAN_CASES = (("round (path 10)", (1, 512, 16384, 16)),
              ("prefill (path 10)", (1, 4096, 16384, 16)),
              ("decode (path 10)", (1, 1, 16384, 16)),
              ("card SMOKE", (2, 40, 256, 4)))


def scan_inputs(B, S, d_in, N, dtype, dev, seed=5):
    """The scan's inputs as a Mamba block gives them: x the silu of a
    normal and z a normal in the model type; dt (the dt_proj product
    before the bias), B and C normal f32; A_log, D and dt_bias near the
    reference's init; h0 a nonzero state."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    x = torch.nn.functional.silu(randn(B, S, d_in) * 2.0).to(dtype)
    z = randn(B, S, d_in).to(dtype)
    A_log = torch.log(torch.arange(1, N + 1.0, device=dev)).expand(
        d_in, N).contiguous()
    bias = math.log(math.expm1(0.01)) + randn(d_in)
    return (x, randn(B, S, d_in), z, randn(B, S, N), randn(B, S, N), A_log,
            1.0 + 0.1 * randn(d_in), bias, randn(B, d_in, N) * 0.5)


def scan_views(args):
    """``args`` with z, B and C as the Mamba block passes them: z the second
    half of a (B, S, 2·d_in) tensor, B and C slices of one (B, S, 7 + 2N)
    tensor (7 columns standing for dt's), values equal."""
    x, dt, z, Bc, Cc, *rest = args
    B, S, d_in = z.shape
    N = Bc.shape[-1]
    xz = torch.empty(B, S, 2 * d_in, dtype=z.dtype, device=z.device)
    xz[..., d_in:] = z
    dbl = torch.empty(B, S, 7 + 2 * N, device=Bc.device)
    dbl[..., 7:7 + N], dbl[..., 7 + N:] = Bc, Cc
    return (x, dt, xz[..., d_in:], dbl[..., 7:7 + N], dbl[..., 7 + N:],
            *rest)


def check_scan(what: str, got, want) -> float:
    """y: f32 within 1e-5 of max|y|; bf16 within two bf16 ulps of each
    element plus 1e-5 of max|y| (y is rounded before and after the silu(z)
    gate, so an f32 difference that moves the first rounding moves the
    product by up to two ulps); h_last (f32) within 1e-5 of max|h|.
    Returns the largest |Δ| of y and h."""
    (y, h), (wy, wh) = got, want
    require(y.shape == wy.shape and y.dtype == wy.dtype
            and h.dtype == torch.float32, f"{what}: {y.shape} {y.dtype}, "
            f"h {h.dtype} vs {wy.shape} {wy.dtype}")
    require(bool(torch.isfinite(y.float()).all())
            and bool(torch.isfinite(h).all()), f"{what}: non-finite")
    scale = float(wy.float().abs().max())
    d = (y.float() - wy.float()).abs()
    if y.dtype == torch.bfloat16:
        ok = bool((d <= 2.0 ** -6 * wy.float().abs() + 1e-5 * scale).all())
    else:
        ok = float(d.max()) <= 1e-5 * scale
    dh = float((h - wh).abs().max())
    require(ok and dh <= 1e-5 * float(wh.abs().max()),
            f"{what}: y max |Δ| {float(d.max()):.3e} of {scale:.3e}, h max "
            f"|Δ| {dh:.3e} outside tolerance")
    return max(float(d.max()), dh)


def phase_selective_scan(dev) -> dict:
    """The selective-scan kernel against its plain version
    (``ref.selective_scan_ref``, one token at a time in PyTorch ops) at
    SCAN_CASES, f32 and bf16, each from a nonzero h0 (``check_scan``); two
    launches bit-equal, and h_out = h0 (decode's in-place state) equal to
    a launch into a new h_last. Times: the kernel's device time per call
    (device_ms, cycling through copies of the inputs that together
    exceed L2), the plain version's by CUDA events; the bound from ``scan_bytes`` and
    ``scan_mufu_ops``. No PyTorch call computes this function, so the
    library column is null. z, B and C read in place as the Mamba block
    passes them (z a half of a (B, S, 2·d_in) tensor, B and C slices of
    one (B, S, dt_rank + 2N) tensor) give y and h_last bit-equal to
    contiguous copies. First each instance's launch geometry
    (``selective_scan_plan``: lanes a channel, which must equal the
    wrapper's LANES, channels a block, tokens a chunk, threads, registers,
    static shared memory, blocks an SM). Returns the round case's numbers
    (bf16), with prefill's under "tokens_4096" and decode's under
    "decode"."""
    import ctypes
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.selective_scan import LANES, selective_scan
    for N in (4, 16):
        for dt_code, dt_name in ((0, "f32"), (1, "bf16")):
            plan = (ctypes.c_int * 7)()
            build.check(build.library().selective_scan_plan(N, dt_code, plan),
                        "selective_scan_plan")
            G, cb, chunk, threads, regs, smem, blocks = plan
            require(G == LANES[N], f"selective_scan N = {N}: the kernel "
                    f"splits a channel over {G} lanes, the wrapper's LANES "
                    f"says {LANES[N]}")
            print(f"selective_scan_kernel<{dt_name}, {N}, {G}>: {cb} "
                  f"channels x {G} lanes = {threads} threads a block, "
                  f"{chunk}-token chunks, {regs} registers, {smem} bytes "
                  f"of shared memory, {blocks} blocks an SM")
    res = {"err": 0.0, "library_ms": None}
    for label, (B, S, d_in, N) in SCAN_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            args = scan_inputs(B, S, d_in, N, dtype, dev)
            what = (f"selective_scan {label} {str(dtype)[6:]} "
                    f"(B, S, d_in, N) = {(B, S, d_in, N)}")
            got = selective_scan(*args)
            err = check_scan(what, got, ref.selective_scan_ref(*args))
            again = selective_scan(*args)
            state = args[-1].clone()
            inplace = selective_scan(*args[:-1], state, h_out=state)
            require(torch.equal(got[0], again[0])
                    and torch.equal(got[1], again[1]),
                    f"{what}: two launches differ")
            require(torch.equal(inplace[0], got[0])
                    and torch.equal(state, got[1]),
                    f"{what}: h_out = h0 differs from a new h_last")
            strided = selective_scan(*scan_views(args))
            require(torch.equal(strided[0], got[0])
                    and torch.equal(strided[1], got[1]),
                    f"{what}: z, B and C read in place differ from "
                    f"contiguous copies")
            res["err"] = max(res["err"], err)
            nbytes = scan_bytes(B, S, d_in, N, dtype.itemsize)
            sets = [args] + [tuple(t.clone() for t in args)
                             for _ in range(L2_BYTES // nbytes + 1)]
            ms = device_ms(lambda t: selective_scan(*t), sets, 10)
            plain_ms = time_ms(lambda: ref.selective_scan_ref(*args), 1)
            require(ms > 0, f"{what}: the profiler recorded no device time")
            b_ms, b_by = bound(nbytes, scan_mufu_ops(N) * B * S * d_in,
                               "mufu")
            print(f"{what}: max|Δ| {err:.3e}  kernel {ms:.4f} ms  plain "
                  f"{plain_ms:.4f} ms  library none  bound {b_ms:.4f} ms "
                  f"({b_by}; bytes {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms)"
                  f"  two launches bit-equal, h_out = h0 equal, in-place "
                  f"z/B/C equal")
            if dtype != torch.bfloat16 or label == "card SMOKE":
                continue
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       shape=f"(B, S, d_in, N) = {(B, S, d_in, N)} bf16")
            if label.startswith("round"):
                res.update(row)
            else:
                res["tokens_4096" if S == 4096 else "decode"] = row
    return res



# the scan backward's cases: path 10 (c)'s round shape and the 4096-token
# prefill at jamba's published d_inner and d_state, and the card SMOKE's
# N = 4 (FO_SMALL's jamba rounds)
SCAN_BWD_CASES = (("round (path 10)", (1, 512, 16384, 16)),
                  ("tokens 4096", (1, 4096, 16384, 16)),
                  ("card SMOKE", (2, 40, 256, 4)))
SCAN_BWD_NAMES = ("dx", "ddt", "dz", "dBc", "dCc", "dA_log", "dD",
                  "ddt_bias", "dh0")


def check_scan_bwd(what: str, got, want) -> float:
    """Each gradient within 1e-5 (f32) or 2^-7 (bf16: dx and dz are
    rounded to it, and do and dy·T(o) before them) of its largest
    magnitude; types and shapes equal. Returns the largest |Δ| over
    them."""
    worst = 0.0
    for name, g, w in zip(SCAN_BWD_NAMES, got, want):
        require(g.shape == w.shape and g.dtype == w.dtype,
                f"{what} {name}: {g.shape} {g.dtype} vs {w.shape} {w.dtype}")
        require(bool(torch.isfinite(g.float()).all()),
                f"{what} {name}: non-finite")
        tol = 1e-5 if want[0].dtype == torch.float32 else 2.0 ** -7
        scale = float(w.float().abs().max())
        err = max_err(g, w)
        require(err <= tol * scale, f"{what} {name}: max |Δ| {err:.3e} of "
                f"{scale:.3e} outside {tol:.1e} of it")
        worst = max(worst, err)
    return worst


def event_ms(fn):
    """(fn's result, its milliseconds by CUDA events): one call."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def phase_selective_scan_bwd(dev) -> dict:
    """The scan's backward kernel (``selective_scan_bwd``: the reverse
    recurrence, then the launch that sums its per-block partials) against
    its plain version (``ref.selective_scan_bwd_ref``, a loop over tokens
    in PyTorch ops) at SCAN_BWD_CASES, f32 and bf16, from a nonzero h0 and
    dh_last, on the h at chunk starts that the forward saved
    (``check_scan_bwd``); z, B and C as the Mamba block's strided views
    (``scan_views``) give every gradient bit-equal to contiguous copies,
    and two calls are bit-equal. Times: the kernel's device time per call
    (both launches, device_ms over copies of the inputs past L2), the
    plain version's by CUDA events (one call); the bound from
    ``scan_bwd_bytes`` and ``scan_bwd_mufu_ops``; no PyTorch call
    computes it. First each instance's geometry (``selective_scan_bwd_plan``:
    cluster size, barriers a chunk, registers, shared memory, blocks an SM).
    Returns the round case's numbers (bf16), with the 4096-token case's
    under "tokens_4096"."""
    import ctypes
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.selective_scan import (LANES, _launch,
                                                    selective_scan_bwd)
    for N in (4, 16):
        for dt_code, dt_name in ((0, "f32"), (1, "bf16")):
            plan = (ctypes.c_int * 10)()
            build.check(build.library().selective_scan_bwd_plan(
                N, dt_code, plan), "selective_scan_bwd_plan")
            (G, cb, sub, threads, regs, smem, blocks, cluster, barriers,
             clusters) = plan
            require(G == LANES[N], f"selective_scan_bwd N = {N}: {G} lanes, "
                    f"the forward's {LANES[N]}")
            print(f"selective_scan_bwd_kernel<{dt_name}, {N}, {G}>: {cb} "
                  f"channels x {G} lanes = {threads} threads a block, "
                  f"{sub}-token sub-chunks, clusters of {cluster} blocks, "
                  f"{barriers} block barriers and 1 cluster barrier a "
                  f"32-token chunk, {regs} registers, {smem} bytes of "
                  f"dynamic shared memory, {blocks} blocks an SM, {clusters} "
                  f"clusters at once ({clusters * cluster} blocks)")
    res = {"err": 0.0, "library_ms": None}
    for label, (B, S, d_in, N) in SCAN_BWD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            args = scan_inputs(B, S, d_in, N, dtype, dev)
            g = torch.Generator(device=dev).manual_seed(9)
            dy = torch.randn(B, S, d_in, generator=g, device=dev).to(dtype)
            dh_last = torch.randn(B, d_in, N, generator=g, device=dev)
            what = (f"selective_scan_bwd {label} {str(dtype)[6:]} "
                    f"(B, S, d_in, N) = {(B, S, d_in, N)}")
            views = scan_views(args)
            _, _, hc = _launch(*views, None, save=True)
            got = selective_scan_bwd(*views, hc, dy, dh_last)
            want, plain_ms = event_ms(lambda: ref.selective_scan_bwd_ref(
                *args, dy, dh_last))
            err = check_scan_bwd(what, got, want)
            del want
            again = selective_scan_bwd(*args, hc, dy, dh_last)
            require(all(torch.equal(a, b) for a, b in zip(got, again)),
                    f"{what}: two calls differ, or z, B and C read in place "
                    f"differ from contiguous copies")
            res["err"] = max(res["err"], err)
            nbytes = scan_bwd_bytes(B, S, d_in, N, dtype.itemsize)
            sets = [(args, hc)] + [
                (tuple(t.clone() for t in args), hc.clone())
                for _ in range(L2_BYTES // nbytes + 1)]
            by_kernel = {}
            ms = device_ms(lambda t: selective_scan_bwd(*t[0], t[1], dy,
                                                        dh_last), sets, 10,
                           by_kernel=by_kernel)
            del sets
            require(ms > 0, f"{what}: the profiler recorded no device time")
            b_ms, b_by = bound(nbytes, scan_bwd_mufu_ops(N) * B * S * d_in,
                               "mufu")
            print(f"{what}: max|Δ| {err:.3e}  kernel {ms:.4f} ms  plain "
                  f"{plain_ms:.4f} ms  library none  bound {b_ms:.4f} ms "
                  f"({b_by}; bytes {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms)"
                  f"  two calls bit-equal, in-place z/B/C equal; by launch "
                  + ", ".join(f"{'sum' if 'sum' in k else 'recurrence'} "
                              f"{v:.4f} ms" for k, v in by_kernel.items()))
            if dtype != torch.bfloat16 or label == "card SMOKE":
                continue
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       shape=f"(B, S, d_in, N) = {(B, S, d_in, N)} bf16")
            if label.startswith("round"):
                res.update(row)
            else:
                res["tokens_4096"] = row
    return res


# the sLSTM kernel's cases (B, S, H, dh): path 11's round, prefill, 4 x 512
# serving prefill and its decode at xlstm-350m's head dim 256 (4 heads,
# d_model 1024), the card SMOKE's head dim 32 (card_smoke_config: the small
# rounds and serving) and SMOKE's 16 (the CPU tests' size); (label, shape,
# dtypes)
SLSTM_CASES = (("round (path 11)", (1, 512, 4, 256),
                (torch.bfloat16, torch.float32)),
               ("prefill (path 11)", (1, 4096, 4, 256), (torch.bfloat16,)),
               ("serve prefill (path 11)", (4, 512, 4, 256),
                (torch.bfloat16,)),
               ("decode (path 11)", (4, 1, 4, 256),
                (torch.bfloat16, torch.float32)),
               ("card SMOKE", (2, 64, 4, 32), (torch.float32,)),
               ("SMOKE", (2, 40, 4, 16), (torch.float32,)))
# the sLSTM kernel's instances <type, columns a block, head dim, batch rows
# a cluster, the backward's record> (an older source's <type, columns[,
# head dim[, rows]]> matches too)
SLSTM_KERNEL = re.compile(r"slstm_kernelI(f|13__nv_bfloat16)Li(\d+)E"
                          r"(?:Li(\d+)E)?(?:Li(\d+)E)?(?:Lb([01])E)?E")
# and the backward's <type, columns a block, head dim, batch rows a cluster>
SLSTM_BWD_KERNEL = re.compile(r"slstm_bwd_kernelI(f|13__nv_bfloat16)"
                              r"Li(\d+)ELi(\d+)ELi(\d+)EE")
# f32 and bf16 at 5 head dims, each with a group of batch rows a cluster
# (B > 1) and with one (B = 1), each an inference and a saving instance;
# and the backward's twenty
SLSTM_KERNELS = 60
# the fields slstm_plan fills
SLSTM_PLAN = 20
# f32 operations of the sLSTM recurrence per (token, column) beside the
# product: the bias and the three sums of the pre-activations (8), the log
# sigmoid (4: exp, log1p, min, subtraction), m' and the two exponentials'
# arguments (4), i_g and f_g (2), tanh and c (4), n (5 with exp(-m')), the
# sigmoid (3) and h (2)
SLSTM_GATE_OPS = 32


def slstm_bytes(B: int, S: int, H: int, dh: int, elem: int) -> int:
    """Bytes the sLSTM recurrence must move: x_pre (4·D a token) read and
    hs (D) written in the model type, r and the bias read once, the state
    (c, n, m, h) read and written."""
    D = H * dh
    return (B * S * 5 * D * elem + 4 * H * dh * dh * 4 + 4 * D * 4
            + 8 * B * D * 4)


def slstm_ops(B: int, S: int, H: int, dh: int) -> int:
    """f32 operations of the sLSTM recurrence: the recurrent product, 2
    operations a multiply-add, 4 gates x dh x dh a head and token, and
    SLSTM_GATE_OPS a (token, column)."""
    return B * S * H * (8 * dh * dh + SLSTM_GATE_OPS * dh)


def slstm_kernel_name(line: str):
    """'slstm_kernel<type, columns, head dim, rows[, save]>' or
    'slstm_bwd_kernel<type, columns, head dim, rows>' for a ptxas line
    naming one, else None."""
    for kernel, pattern in (("slstm_kernel", SLSTM_KERNEL),
                            ("slstm_bwd_kernel", SLSTM_BWD_KERNEL)):
        m = pattern.search(line)
        if m:
            args = ["f32" if m.group(1) == "f" else "bf16"]
            args += [g for g in m.groups()[1:4] if g]
            if m.groups()[4:] == ("1",):
                args.append("save")
            return f"{kernel}<{', '.join(args)}>"
    return None


def report_ptxas_slstm(out: str) -> None:
    """Print ptxas's registers, shared memory and spills for each sLSTM
    kernel instance (f32 and bf16 at head dims 16, 32, 64, 128 and 256,
    with a group of batch rows a cluster and with 1; inference and
    saving) and each of its backward's; none may spill."""
    name, seen = None, set()
    for line in out.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            name = slstm_kernel_name(line)
            continue
        if name is None or not line.strip() or "Compile time" in line:
            continue
        print(f"ptxas {name}: {line.split(':', 1)[-1].strip()}")
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", line)
        if spills:
            seen.add(name)
            require(spills.groups() == ("0", "0"),
                    f"{name} spills registers: {line.strip()}")
    require(len(seen) == SLSTM_KERNELS, f"ptxas -v reported spill lines for "
            f"{sorted(seen)}, not the {SLSTM_KERNELS} sLSTM kernels")


def slstm_inputs(B, S, H, dh, dtype, dev, seed=5):
    """The sLSTM kernel's inputs as an sLSTM block gives them: x_pre a
    normal times 2 in the model type (the gates out of their linear
    range), b with its forget quarter at 3.0, r at its init scale
    1/sqrt(dh), and a nonzero state (c and h normal, n >= 1, m near 0)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    D = H * dh
    b = torch.zeros(4 * D, device=dev)
    b[2 * D:3 * D] = 3.0
    return ((randn(B, S, 4 * D) * 2.0).to(dtype), b,
            randn(4, H, dh, dh) / math.sqrt(dh), randn(B, H, dh),
            randn(B, H, dh).abs() + 1.0, randn(B, H, dh) * 0.5,
            randn(B, H, dh) * 0.5)


def check_slstm(what: str, got, want) -> float:
    """hs: f32 within 1e-5 of max|hs|, bf16 within two bf16 ulps of each
    element plus 1e-5 of max|hs| (the recurrent h is f32 in both, an f32
    difference can move hs's rounding by one ulp, and the plain version's
    own bf16 rounding of the same value by another); the final c, n, h
    within 1e-5 of each largest magnitude, m within 1e-5 of max(|m|, 1).
    Returns the largest |Δ| of hs and the state."""
    (hs, st), (whs, wst) = got, want
    require(hs.shape == whs.shape and hs.dtype == whs.dtype,
            f"{what}: hs {hs.shape} {hs.dtype} vs {whs.shape} {whs.dtype}")
    require(bool(torch.isfinite(hs.float()).all())
            and all(bool(torch.isfinite(t).all()) for t in st),
            f"{what}: non-finite")
    scale = float(whs.float().abs().max())
    d = (hs.float() - whs.float()).abs()
    if hs.dtype == torch.bfloat16:
        ok = bool((d <= 2.0 ** -6 * whs.float().abs() + 1e-5 * scale).all())
    else:
        ok = float(d.max()) <= 1e-5 * scale
    err = float(d.max())
    for k, (a, w) in enumerate(zip(st, wst)):
        dk = float((a - w).abs().max())
        ok = ok and a.dtype == torch.float32 and dk <= 1e-5 * max(
            float(w.abs().max()), 1.0 if k == 2 else 0.0)
        err = max(err, dk)
    require(ok, f"{what}: max |Δ| {err:.3e} (hs of {scale:.3e}) outside "
            f"tolerance")
    return err


def phase_slstm(dev) -> dict:
    """The sLSTM kernel against its plain version (``ref.slstm_ref``, one
    token at a time in PyTorch ops) at SLSTM_CASES, from a nonzero state
    (``check_slstm``); two launches bit-equal, and the state given as
    ``out`` (decode's in-place state) equal to a launch into a new one.
    First each instance's launch geometry (``slstm_plan``: blocks a
    cluster (a head), columns a block, threads, splits of the sum over d,
    registers, dynamic shared memory, blocks an SM, clusters the card
    holds, batch rows a cluster, slots of the x_pre ring, mbarriers a
    buffer, outputs a thread; for the instance of a group of batch rows a
    cluster (B > 1) and of one (B = 1)), and at each case its clusters and
    the waves they take.
    Times: the kernel's device time per call (device_ms), per token step
    beside it, the plain version's by CUDA events; the bound from
    ``slstm_bytes`` and ``slstm_ops`` on the f32 cores. No PyTorch call
    computes this function, so the library column is null. Returns the
    round case's numbers (bf16), with prefill's under "tokens_4096", the
    4 x 512 serving prefill's under "serve_prefill" and decode's under
    "decode", and each case's us a token step under
    "us_per_token_by_case"."""
    import ctypes
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.slstm import slstm
    plans = {}
    for dh in (16, 32, 256):
        for code, name in ((0, "f32"), (1, "bf16")):
            plan = (ctypes.c_int * SLSTM_PLAN)()
            build.check(build.library().slstm_plan(dh, code, plan),
                        "slstm_plan")
            plans[dh, code] = tuple(plan)
            rows, ahead, bars, outs = plan[8:12]
            for n, (cs, cols, threads, splits, regs, smem, blocks,
                    clusters) in ((rows, plan[:8]), (1, plan[12:20])):
                print(f"slstm_kernel<{name}, {cols}, {dh}, {n}> (B "
                      f"{'> 1' if n > 1 else '= 1'}): clusters of {cs} "
                      f"block(s) a (head, {n} batch row(s)), {cols} columns "
                      f"x 4 gates / {outs} outputs a thread x {splits} "
                      f"splits = {threads} threads a block, {regs} "
                      f"registers, {smem} bytes of dynamic shared memory "
                      f"(x_pre ring of {ahead} tokens, mbarriers: {bars} a "
                      f"buffer at B > 1), {blocks} block(s) an SM, "
                      f"{clusters} clusters at once")
    res = {"err": 0.0, "library_ms": None, "us_per_token_by_case": {}}
    for label, (B, S, H, dh), dtypes in SLSTM_CASES:
        for dtype in dtypes:
            args = slstm_inputs(B, S, H, dh, dtype, dev)
            what = (f"slstm {label} {str(dtype)[6:]} (B, S, H, dh) = "
                    f"{(B, S, H, dh)}")
            plan = plans[dh, int(dtype == torch.bfloat16)]
            cs, rows, at_once = ((plan[12], 1, plan[19]) if B == 1
                                 else (plan[0], plan[8], plan[7]))
            n_clusters = H * -(-B // rows)
            print(f"{what}: {n_clusters} clusters of {cs} block(s) and "
                  f"{rows} batch row(s) in {-(-n_clusters // at_once)} "
                  f"wave(s)")
            got = slstm(*args)
            err = check_slstm(what, got, ref.slstm_ref(*args))
            again = slstm(*args)
            state = [t.clone() for t in args[3:]]
            inplace = slstm(*args[:3], *state, out=state)
            require(torch.equal(got[0], again[0]) and all(
                torch.equal(a, b) for a, b in zip(got[1], again[1])),
                f"{what}: two launches differ")
            require(torch.equal(inplace[0], got[0]) and all(
                torch.equal(a, b) for a, b in zip(state, got[1])),
                f"{what}: the state as out differs from a new state")
            res["err"] = max(res["err"], err)
            nbytes = slstm_bytes(B, S, H, dh, dtype.itemsize)
            sets = [args] + [tuple(t.clone() for t in args)
                             for _ in range(min(3, L2_BYTES // nbytes + 1))]
            ms = device_ms(lambda t: slstm(*t), sets, 5 if S >= 4096 else 10)
            plain_ms = time_ms(lambda: ref.slstm_ref(*args), 1)
            require(ms > 0, f"{what}: the profiler recorded no device time")
            b_ms, b_by = bound(nbytes, slstm_ops(B, S, H, dh), "f32_core")
            print(f"{what}: max|Δ| {err:.3e}  kernel {ms:.4f} ms "
                  f"({ms / S * 1e3:.3f} us a token step)  plain "
                  f"{plain_ms:.4f} ms  library none  bound {b_ms:.4f} ms "
                  f"({b_by}; bytes {nbytes / HBM_BYTES_PER_S * 1e3:.4f} "
                  f"ms)  two launches bit-equal, the state as out equal")
            res["us_per_token_by_case"][B, S, dh, dtype] = ms / S * 1e3
            if dtype != torch.bfloat16 or label.startswith(("card", "SMOKE")):
                continue
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       us_per_token=ms / S * 1e3,
                       shape=f"(B, S, H, dh) = {(B, S, H, dh)} bf16")
            if label.startswith("round"):
                res.update(row)
            else:
                res["tokens_4096" if S == 4096 else "serve_prefill" if B > 1
                    and S > 1 else "decode"] = row
    return res


# the sLSTM backward's cases (B, S, H, dh): path 11 (c)'s round shape, a
# group of batch rows (the B > 1 instance at path 11's serving rows) and
# the chain at 4096 tokens, at xlstm-350m's head dim 256; (label, shape,
# dtypes)
SLSTM_BWD_CASES = (("round (path 11)", (1, 512, 4, 256),
                    (torch.bfloat16, torch.float32)),
                   ("grouped rows", (4, 512, 4, 256), (torch.bfloat16,)),
                   ("chain 4096", (1, 4096, 4, 256), (torch.bfloat16,)))
SLSTM_BWD_NAMES = ("dx_pre", "db", "dr", "dc0", "dn0", "dm0", "dh0")
# f32 operations of the sLSTM backward per (token, column) beside the
# products: the token's forward again without its sums (24 of
# SLSTM_GATE_OPS), dhs plus the recurrent part (1), dpre_o (5), dc' and
# dn' (6), the max of n' (3), df_g, di_g and dpre_z (9), dpre_i and dm'
# (6), the max of m' (2), dpre_f (3) and the carried dc and dn (2)
SLSTM_BWD_GATE_OPS = 61
# fields of slstm_bwd_plan
SLSTM_BWD_PLAN = 16


def slstm_bwd_bytes(B: int, S: int, H: int, dh: int, elem: int) -> int:
    """Bytes the sLSTM backward must move: the forward's record (8 f32 a
    (token, column): the chain's 7 and h for dr) and dhs (D a token, the
    model type) read, dx_pre (4·D) written, r read and dr and db written
    once, the final state's cotangents read and the initial state's
    written."""
    D = H * dh
    return (B * S * D * (8 * 4 + elem + 4 * elem) + 2 * 4 * H * dh * dh * 4
            + 4 * D * 4 + 8 * B * D * 4)


def slstm_bwd_ops(B: int, S: int, H: int, dh: int) -> int:
    """f32 operations of the sLSTM backward with db and dr: the transposed
    recurrent product and dr's product, 8·dh² a head, batch row and token
    each (2 operations a multiply-add), SLSTM_BWD_GATE_OPS a (token,
    column), and db's sum (4 a (token, column))."""
    return B * S * H * (16 * dh * dh + (SLSTM_BWD_GATE_OPS + 4) * dh)


def check_slstm_bwd(what: str, got, want) -> float:
    """dx_pre within 2^-7 (bf16: rounded to it on both sides) or 1e-5
    (f32) of its largest magnitude; db, dr and the initial state's
    cotangents (f32) within 1e-5 of theirs; types and shapes equal.
    Returns the largest |Δ| over them."""
    worst = 0.0
    for k, (name, g, w) in enumerate(zip(SLSTM_BWD_NAMES, got, want)):
        require(g.shape == w.shape and g.dtype == w.dtype,
                f"{what} {name}: {g.shape} {g.dtype} vs {w.shape} {w.dtype}")
        require(bool(torch.isfinite(g.float()).all()),
                f"{what} {name}: non-finite")
        tol = 2.0 ** -7 if k == 0 and g.dtype == torch.bfloat16 else 1e-5
        scale = float(w.float().abs().max())
        err = max_err(g, w)
        require(err <= tol * scale, f"{what} {name}: max |Δ| {err:.3e} of "
                f"{scale:.3e} outside {tol:.1e} of it")
        worst = max(worst, err)
    return worst


def check_slstm_record(what: str, got, want) -> None:
    """The saving forward's record against ``ref.slstm_record_ref``: the
    pre-activations and c, n, h within 1e-5 of each field's largest
    magnitude (the forward's tolerance), m within 1e-5 of max(|m|, 1)
    past token 0 and equal to the initial m at token 0."""
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{what}: record {got.shape} {got.dtype} vs {want.shape}")
    for k in range(8):
        g, w = got[:, :, k], want[:, :, k]
        if k == 6:
            require(torch.equal(g[:, 0], w[:, 0]),
                    f"{what}: the record's m at token 0 is not m0")
            g, w = g[:, 1:], w[:, 1:]
        floor = 1.0 if k == 6 else 0.0
        err = max_err(g, w) if w.numel() else 0.0
        require(err <= 1e-5 * max(float(w.abs().max()) if w.numel() else 0,
                                  floor),
                f"{what}: the record's field {k} is {err:.3e} off the plain "
                f"record")


def phase_slstm_bwd(dev, fwd_us: dict) -> dict:
    """The sLSTM backward (``slstm_bwd``: the reverse recurrence in one
    launch from the saving forward's record, then dr's full-f32 product
    and db's sum) against its plain version (``ref.slstm_bwd_ref``, the
    reverse loop in PyTorch ops) on the same record, so both take each
    max of a token's forward as the kernel's forward took it, at
    SLSTM_BWD_CASES, from a nonzero state with nonzero dhs and
    final-state cotangents (``check_slstm_bwd``); the saving forward's hs
    and final state bit-equal to the inference forward's, its record
    within the forward's tolerance of the plain record
    (``check_slstm_record``, ``ref.slstm_record_ref``); two calls
    bit-equal. First each instance's geometry (``slstm_bwd_plan``). Times:
    the call's device time (device_ms over copies of the record past L2)
    and its chain launch's alone, per token step beside the forward's
    (``fwd_us``, phase_slstm's us a step by shape), the saving forward's
    beside the inference forward's, the plain version's by CUDA events
    (one call); the bound from ``slstm_bwd_bytes`` and ``slstm_bwd_ops``
    on the f32 cores. No PyTorch call computes this function, so the
    library column is null. Returns the round case's numbers (bf16), with
    the 4096-token chain's under "tokens_4096" and the grouped rows' under
    "grouped_rows"."""
    import ctypes
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.slstm import _launch, slstm_bwd
    for dh in (16, 32, 256):
        for code, name in ((0, "f32"), (1, "bf16")):
            plan = (ctypes.c_int * SLSTM_BWD_PLAN)()
            build.check(build.library().slstm_bwd_plan(dh, code, plan),
                        "slstm_bwd_plan")
            for n, (cs, cols, threads, rows, regs, smem, blocks,
                    clusters) in (("groups", plan[:8]), ("1", plan[8:])):
                print(f"slstm_bwd_kernel<{name}, {cols}, {dh}> (batch rows "
                      f"a cluster: {n}): clusters of {cs} block(s), {cols} "
                      f"columns, {threads} threads a block ({rows} rows of "
                      f"r a warp), {regs} registers, {smem} bytes of "
                      f"dynamic shared memory, {blocks} block(s) an SM, "
                      f"{clusters} clusters at once")
    res = {"err": 0.0, "library_ms": None}
    for label, (B, S, H, dh), dtypes in SLSTM_BWD_CASES:
        for dtype in dtypes:
            args = slstm_inputs(B, S, H, dh, dtype, dev)
            what = (f"slstm_bwd {label} {str(dtype)[6:]} (B, S, H, dh) = "
                    f"{(B, S, H, dh)}")
            g = torch.Generator(device=dev).manual_seed(9)
            dhs = torch.randn(B, S, H * dh, generator=g, device=dev).to(dtype)
            dfin = [torch.randn(B, H, dh, generator=g, device=dev)
                    for _ in range(4)]
            hs, st, saved = _launch(*args[:3], args[3:], None, save=True)
            hs0, st0, _ = _launch(*args[:3], args[3:], None)
            require(torch.equal(hs, hs0) and all(
                torch.equal(a, b) for a, b in zip(st, st0)),
                f"{what}: the saving forward differs from the inference one")
            del hs, st, hs0, st0
            check_slstm_record(what, saved, ref.slstm_record_ref(*args))
            got = slstm_bwd(saved, args[2], dhs, dfin)
            want, plain_ms = event_ms(lambda: ref.slstm_bwd_ref(
                *args, dhs, *dfin, saved=saved))
            err = check_slstm_bwd(what, got, want)
            rel = max(max_err(a, b) / float(b.float().abs().max())
                      for a, b in zip(got, want))
            del want
            again = slstm_bwd(saved, args[2], dhs, dfin)
            require(all(torch.equal(a, b) for a, b in zip(got, again)),
                    f"{what}: two calls differ")
            del got, again
            res["err"] = max(res["err"], err)
            nbytes = slstm_bwd_bytes(B, S, H, dh, dtype.itemsize)
            sets = [(saved, dhs)] + [
                (saved.clone(), dhs.clone())
                for _ in range(min(3, L2_BYTES // nbytes + 1))]
            by_kernel = {}
            ms = device_ms(lambda t: slstm_bwd(t[0], args[2], t[1], dfin),
                           sets, 5 if S >= 4096 else 10, by_kernel=by_kernel)
            del sets
            require(ms > 0, f"{what}: the profiler recorded no device time")
            chain = [v for k, v in by_kernel.items() if "slstm_bwd_kernel" in k]
            require(len(chain) == 1, f"{what}: the chain's launch is not "
                    f"among the profiled kernels {sorted(by_kernel)}")
            chain_ms = chain[0]
            fwd = {}
            fwd_ms = device_ms(lambda t: _launch(*t[:3], t[3:], None), [args],
                               5 if S >= 4096 else 10)
            save_ms = device_ms(lambda t: _launch(*t[:3], t[3:], None,
                                                  save=True), [args],
                                5 if S >= 4096 else 10)
            fwd["inference"], fwd["saving"] = fwd_ms, save_ms
            b_ms, b_by = bound(nbytes, slstm_bwd_ops(B, S, H, dh), "f32_core")
            us = chain_ms / S * 1e3
            print(f"{what}: max|Δ| {err:.3e} ({rel:.3e} of its output's "
                  f"largest magnitude at most)  call {ms:.4f} ms (the chain "
                  f"{chain_ms:.4f} ms, {us:.3f} us a token step against the "
                  f"forward's {fwd_us.get((B, S, dh, dtype), float('nan')):.3f}"
                  f"; dr and db {ms - chain_ms:.4f} ms)  plain "
                  f"{plain_ms:.4f} ms  library none  bound {b_ms:.4f} ms "
                  f"({b_by}; bytes {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms)  "
                  f"two calls bit-equal; forward {fwd_ms:.4f} ms, saving "
                  f"{save_ms:.4f} ms, bit-equal; by launch "
                  + ", ".join(f"{k[:40]} {v:.4f} ms"
                              for k, v in by_kernel.items()))
            if dtype != torch.bfloat16:
                continue
            row = dict(ms=ms, chain_ms=chain_ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, us_per_token=us,
                       forward_ms=fwd,
                       shape=f"(B, S, H, dh) = {(B, S, H, dh)} bf16")
            if label.startswith("round"):
                res.update(row)
            else:
                res["tokens_4096" if S == 4096 else "grouped_rows"] = row
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
              True, 0),
             ("mixtral-8x22b prefill (path 8), GQA 48/8, window 4096",
              (1, 48, 8, 4160, 128), True, 4096)]
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
        if "path" in name and "path 8" not in name:
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


# path 9's MLA attention shapes (B, H, S): the ZO round's sequence and the
# serving prompt; q and k 192 wide (128 nope + 64 rope), v and o 128
MLA_FLASH_SHAPES = (("round", (1, 128, 512)), ("prefill", (1, 128, 4096)))


def top_kernel(by_kernel: dict) -> str:
    """The name of the kernel that took the most device time."""
    return max(by_kernel, key=by_kernel.get)[:80] if by_kernel else "none"


def phase_flash_mla(dev) -> dict:
    """The flash kernel at MLA's head dims (d_qk, d_v) = (192, 128), H =
    Hkv = 128, causal, f32 and bf16, at MLA_FLASH_SHAPES, against its plain
    version (bf16 within one bf16 ulp, f32 within 1e-5), with v a strided
    view of a (B, S, H, 256) tensor as the model passes it, and
    scaled_dot_product_attention (q and k 192 wide, v 128) timed beside it,
    the backend it took named by its busiest kernel. Bounds: bytes of q,
    k, v and o at 3.35 TB/s against (2·192 + 2·128) operations a causal
    pair at the bf16 tensor-core peak (f32: the f32 CUDA-core peak; the
    f32 kernel is scalar). Returns the bf16 round shape's numbers for the
    JSON line."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    gen = torch.Generator(device=dev).manual_seed(9)
    res = {"err": 0.0}
    for dtype, peak in ((torch.bfloat16, "bf16_tensor"),
                        (torch.float32, "f32_core")):
        for label, (B, H, S) in MLA_FLASH_SHAPES:
            q, k = (torch.randn(B, H, S, 192, generator=gen,
                                device=dev).to(dtype) for _ in range(2))
            kv = torch.randn(B, S, H, 256, generator=gen, device=dev).to(
                dtype)
            v = kv[..., 128:].transpose(1, 2)
            name = f"flash MLA {label} (192, 128) {str(dtype)[6:]} " \
                   f"({B},{H},{S})"
            got = flash_attention(q, k, v, causal=True)
            want = ref.flash_attention_ref(q, k, v, True, 0)
            err = check_close(name, got, want, 1e-5)
            del got, want
            nbytes = q.element_size() * B * H * S * (2 * 192 + 2 * 128)
            sets = [(q, k, v)] + [
                (q.clone(), k.clone(), kv.clone()[..., 128:].transpose(1, 2))
                for _ in range(L2_BYTES // nbytes + 1)]
            ms = device_ms(lambda t: flash_attention(*t, causal=True), sets,
                           20)
            plain_ms = device_ms(lambda t: ref.flash_attention_ref(
                *t, True, 0), sets, 3)
            backend = {}
            lib_ms = device_ms(lambda t: F.scaled_dot_product_attention(
                *t, is_causal=True), sets, 20, by_kernel=backend)
            require(min(ms, plain_ms, lib_ms) > 0,
                    f"{name}: the profiler recorded no device time")
            b_ms, b_by = bound(nbytes, (2 * 192 + 2 * 128) * B * H
                               * flash_pairs(S, True, 0), peak)
            print(f"{name}: max|Δ| {err:.3e}  kernel {ms:.4f} ms  plain "
                  f"{plain_ms:.4f} ms  library (scaled_dot_product_attention"
                  f", {top_kernel(backend)}) {lib_ms:.4f} ms  bound "
                  f"{b_ms:.4f} ms ({b_by})")
            if dtype == torch.bfloat16:
                res["err"] = max(res["err"], err)
                if label == "round":
                    res.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                               bound_ms=b_ms, bound_by=b_by,
                               shape=f"({B},{H},{S},192/128) bf16 causal, "
                                     f"v a strided view")
            del sets, q, k, v, kv
            torch.cuda.empty_cache()
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


def bwd_grid(B: int, H: int, Hkv: int, S: int, d: int, dv: int) -> str:
    """The bf16 flash backward's launch geometry at these shapes: one
    dK/dV block a (batch, query head, 64-row key tile), the kv group's
    H/Hkv partials summed by a fourth launch where there are more than one,
    and one dQ block a (batch, head, 64-row query tile); shared memory and
    blocks an SM as the library reports them."""
    from repro_torch.kernels import build
    lib = build.library()
    blocks, parts = B * H * -(-S // 64), H // Hkv
    kv_smem, q_smem = (lib.flash_attention_bwd_smem_bytes(w, d, dv)
                       for w in (0, 1))
    kv_sm, q_sm = (lib.flash_attention_bwd_blocks_per_sm(w, d, dv)
                   for w in (0, 1))
    return (f"dK/dV grid {blocks} blocks ({kv_sm} an SM, {kv_smem} bytes of "
            f"shared memory; {parts} partials a kv head"
            + (", summed by a fourth launch" if parts > 1 else "")
            + f"), dQ grid {blocks} blocks ({q_sm} an SM, {q_smem} bytes)")


# the flash backward's cases: (name, (B, H, Hkv, S, d_qk, d_v), causal,
# window, dtypes); MLA's at path 9 (c)'s 128 heads (G = 1), at S = 512 (its
# round) and 4096 (bf16 only: the plain version's f32 scores of that shape
# take 8.6 GB each)
BF16, F32 = "bfloat16", "float32"
FLASH_BWD_CASES = (
    ("path 5 (paper-opt-1.3b), d=64", (1, 32, 32, 512, 64, 64), True, 0,
     (BF16, F32)),
    ("qwen3-14b shape, GQA 40/8", (1, 40, 8, 512, 128, 128), True, 0,
     (BF16, F32)),
    ("qwen3-14b shape, window 128", (1, 40, 8, 512, 128, 128), True, 128,
     (BF16, F32)),
    ("MLA path 9 (c) round, (192, 128)", (1, 128, 128, 512, 192, 128), True,
     0, (BF16, F32)),
    ("MLA long, (192, 128)", (1, 128, 128, 4096, 192, 128), True, 0,
     (BF16,)))


def phase_flash_bwd(dev) -> dict:
    """The flash backward kernel against its plain version
    (``ref.flash_attention_bwd_ref``, on the plain forward's o and lse) at
    FLASH_BWD_CASES: path 5's shape (1,32,512,64), qwen3-14b's
    (1,40,512,128) with 8 kv heads, causal and with a window of 128, and
    MLA's (d_qk, d_v) = (192, 128) at (1,128,512) and (1,128,4096); v and
    dO as strided views of (B, S, heads, ·) buffers, as the model passes
    them (MLA's v at offset 128 of each head's 256-wide row). bf16 within
    2^-7·max|g| of each gradient, f32 within 1e-5 of it. The forward
    kernel's lse against the plain version's (relative 1e-5). Device time
    per call (device_ms) for bf16, beside the plain version and the
    autograd backward of scaled_dot_product_attention on the same inputs
    (causal cases; it takes no window; the backend named by its busiest
    kernel), the port never calling it. Bound: the larger of the bytes
    (q, k, v, o, dO and lse read, dq, dk and dv written) over 3.35 TB/s
    and flash_bwd_ops(d_qk, d_v) operations a causal pair on the bf16
    tensor cores. Returns path 5's numbers, qwen3's under "qwen3" and
    MLA's under "mla" (its S = 4096 ones under "long")."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (_launch_forward,
                                                     flash_attention_bwd)
    gen = torch.Generator(device=dev).manual_seed(4)
    res = {"err": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for name, (B, H, Hkv, S, d, dv), causal, window, dts in \
                FLASH_BWD_CASES:
            if str(dtype)[6:] not in dts:
                continue
            mla = d != dv
            what = (f"flash bwd {name} {str(dtype)[6:]} ({B},{H},{S},{d}"
                    + (f"/{dv})" if mla else ")"))

            def rnd(*shape):
                return torch.randn(shape, generator=gen, device=dev).to(dtype)
            q, k = rnd(B, H, S, d), rnd(B, Hkv, S, d)
            v = (rnd(B, S, Hkv, 256)[..., 128:] if mla
                 else rnd(B, S, Hkv, d)).transpose(1, 2)
            do = rnd(B, S, H, dv).transpose(1, 2)
            o, lse = ref.flash_attention_ref(q, k, v, causal, window,
                                             return_lse=True)
            got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                      window=window)
            want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal,
                                               window)
            err = max(check_grad(f"{what} {g}", a, b)
                      for g, a, b in zip(("dq", "dk", "dv"), got, want))
            del got, want
            res["err"] = max(res["err"], err)
            ko = torch.empty(B, S, H, dv, dtype=dtype,
                             device=dev).transpose(1, 2)
            kl = torch.empty_like(lse)
            _launch_forward(q, k, v, ko, kl, causal, window)
            lse_err = float(((kl - lse).abs() / lse.abs().clamp(min=1)).max())
            require(lse_err <= 1e-5, f"{what}: forward lse {lse_err:.3e} "
                    f"off the plain version")
            del ko, kl
            line = (f"{what}, Hkv {Hkv}, causal {causal}, window {window}: "
                    f"max|Δ| {err:.3e}, lse relative {lse_err:.3e}")
            if dtype == torch.float32:
                print(line)
                continue
            n_q, n_o = q.numel(), o.numel()
            n_k, n_v = k.numel(), B * Hkv * S * dv
            # q, k, v, o, dO and the lse read; dq, dk and dv written
            nbytes = 2 * (2 * n_q + 2 * n_k + 2 * n_o + 2 * n_v) \
                + 4 * lse.numel()
            sets = [(q, k, v, o, lse, do)] + [
                tuple(t.clone() for t in (q, k, v, o, lse, do))
                for _ in range(L2_BYTES // nbytes + 1)]
            per_kernel = {}
            ms = device_ms(lambda t: flash_attention_bwd(
                *t, causal=causal, window=window), sets, 20 if S <= 512
                else 5, by_kernel=per_kernel)
            torch.cuda.empty_cache()
            plain_ms = device_ms(lambda t: ref.flash_attention_bwd_ref(
                *t, causal, window), sets, 5 if S <= 512 else 2)
            torch.cuda.empty_cache()
            require(min(ms, plain_ms) > 0,
                    f"{what}: the profiler recorded no device time")
            lib_ms, backend = None, {}
            if window == 0:
                graphs = []
                for t in sets:
                    qkv = [a.detach().contiguous().requires_grad_(True)
                           for a in t[:3]]
                    out = F.scaled_dot_product_attention(
                        *qkv, is_causal=True, enable_gqa=H != Hkv)
                    graphs.append((out, qkv, t[5]))
                lib_ms = device_ms(lambda g: torch.autograd.grad(
                    g[0], g[1], g[2], retain_graph=True), graphs,
                    20 if S <= 512 else 5, by_kernel=backend)
                require(lib_ms > 0, f"{what}: no device time for the "
                        f"library backward")
                del graphs
            b_ms, b_by = bound(nbytes, flash_bwd_ops(d, dv) * B * H
                               * flash_pairs(S, causal, window),
                               "bf16_tensor")
            print(line + f"  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                  f"library (autograd backward of "
                  f"scaled_dot_product_attention"
                  + ("" if lib_ms is None else f", {top_kernel(backend)}")
                  + ") " + ("n/a (no window)" if lib_ms is None
                            else f"{lib_ms:.4f} ms")
                  + f"  bound {b_ms:.4f} ms ({b_by})")
            print(f"  {bwd_grid(B, H, Hkv, S, d, dv)}; per launch: "
                  + ", ".join(
                      f"{PORT_KERNEL.search(key).group(0)} {t * 1e3:.2f} us"
                      for key, t in sorted(per_kernel.items(),
                                           key=lambda kt: -kt[1])
                      if PORT_KERNEL.search(key)))
            nums = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                        bound_ms=b_ms, bound_by=b_by,
                        shape=f"({B},{H},{S},{d}" + (f"/{dv}" if mla else "")
                        + f") bf16 causal, Hkv={Hkv}"
                        + (", v and dO strided views" if mla else ""))
            if "path 5" in name:
                res.update(nums)
            elif mla:
                m = res.setdefault("mla", {"max_abs_err": 0.0})
                m["max_abs_err"] = max(m["max_abs_err"], err)
                m.update(nums if S <= 512 else {"long": nums})
            elif window == 0:
                res["qwen3"] = nums
            del sets, q, k, v, do, o, lse
            torch.cuda.empty_cache()
    return res


# the rmsnorm backward's cases: (name, x's shape, k's shape for the qk
# pair or None, dtype); bf16 ones at the paths' shapes are timed
NORM_BWD_CASES = (
    ("block norm (qwen3-14b)", (1, 512, 5120), None, torch.bfloat16),
    ("qk-norm pair (qwen3-14b)", (1, 512, 40, 128), (1, 512, 8, 128),
     torch.bfloat16),
    ("MLA kv_norm", (1, 512, 512), None, torch.bfloat16),
    ("MLA q_norm", (1, 512, 1536), None, torch.bfloat16),
    ("block norm, 4096 tokens", (1, 4096, 5120), None, torch.bfloat16),
    ("block norm", (1, 512, 5120), None, torch.float32),
    ("qk-norm pair", (1, 512, 40, 128), (1, 512, 8, 128), torch.float32),
    ("MLA kv_norm", (1, 512, 512), None, torch.float32),
    ("MLA q_norm", (1, 512, 1536), None, torch.float32),
    ("ragged rows, D=1030", (77, 1030), None, torch.float32),
    ("ragged rows, D=1030", (77, 1030), None, torch.bfloat16))


def phase_rmsnorm_bwd(dev) -> dict:
    """The rmsnorm backward (dx, and dscale in f32 summed over the rows;
    one call a norm, the qk-norm pair's q and k in one grid: a pass over
    the rows and a small launch summing its clusters' partials) against
    ``ref.rmsnorm_bwd_ref`` at NORM_BWD_CASES: the qwen3-14b path's block
    norm rows of 5120 and its qk-norm pair's q and k rows of 128, path 9
    (c)'s MLA norms' rows of 512 (kv_norm) and 1536 (q_norm), 4096 rows of
    5120, where bytes rather than the launch set the time, and ragged
    rows; bf16 and f32. Each case also requires one counted launch a call
    and two calls bit-equal. The bf16 path shapes are timed with the autograd
    backward of F.rms_norm beside them (two of them for the pair; the port
    never calls it): device time per call (device_ms), cycling past L2.
    Bound: bytes (x and dy read, dx written, the scale read and dscale
    written). The block norm at 512 tokens is the row's own numbers; the
    pair's, the MLA widths' and the 4096 tokens' come back under "pair",
    "mla" and "tokens_4096"."""
    import torch.nn.functional as F
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.rmsnorm import (rmsnorm_bwd, rmsnorm_bwd_plan,
                                            rmsnorm_pair_bwd)
    gen = torch.Generator(device=dev).manual_seed(8)
    res = {"err": 0.0}
    for name, shape, k_shape, dtype in NORM_BWD_CASES:
        tensors = []
        for sh in (shape, k_shape) if k_shape else (shape,):
            D = sh[-1]
            x = (torch.randn(sh, generator=gen, device=dev) * 3.0).to(dtype)
            dy = torch.randn(sh, generator=gen, device=dev).to(dtype)
            s = 1.0 + 0.5 * torch.randn(D, generator=gen, device=dev)
            tensors.append((x, s, dy))
        shapes = f"{shape}" + (f" + {k_shape}" if k_shape else "")
        what = f"rmsnorm bwd {name} {str(dtype)[6:]} {shapes}"
        if k_shape:
            def call(t):
                return rmsnorm_pair_bwd(*t[0], *t[1])
        else:
            def call(t):
                return rmsnorm_bwd(*t[0])
        plan = rmsnorm_bwd_plan(*tensors)
        n0 = build.LAUNCHES["rmsnorm_bwd"]
        got, again = call(tensors), call(tensors)
        launches = (build.LAUNCHES["rmsnorm_bwd"] - n0) / 2
        require(launches == 1, f"{what}: {launches} calls counted, not 1")
        want = [w for x, s, dy in tensors
                for w in ref.rmsnorm_bwd_ref(x, s, dy)]
        err = max(check_grad(f"{what} {'dx' if i % 2 == 0 else 'dscale'}",
                             g, w) for i, (g, w) in enumerate(zip(got, want)))
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"{what}: two calls are not bit-equal")
        res["err"] = max(res["err"], err)
        geometry = (f"one call: a pass of grid {plan['grid']}, "
                    f"{plan['G']} lanes a row, then the sum of its "
                    f"{plan['grid'] // 8} clusters' partials: 2 kernels")
        if dtype == torch.float32 or "ragged" in name:
            print(f"{what}: max|Δ| {err:.3e}, two calls bit-equal ({geometry})")
            continue
        nbytes = sum(3 * x.numel() * x.element_size() + 2 * 4 * x.shape[-1]
                     for x, _, _ in tensors)
        sets = [tensors] + [[(x.clone(), s, dy.clone()) for x, s, dy in
                             tensors]
                            for _ in range(L2_BYTES // nbytes + 1)]
        ms = device_ms(call, sets, 100)
        plain_ms = device_ms(lambda t: [ref.rmsnorm_bwd_ref(*a) for a in t],
                             sets, 20)
        graphs = []
        for t in sets:
            leaves, outs, cots = [], [], []
            for x, s, dy in t:
                xx = x.detach().requires_grad_(True)
                ss = s.detach().clone().requires_grad_(True)
                outs.append(F.rms_norm(xx, (x.shape[-1],), ss, 1e-5))
                leaves += [xx, ss]
                cots.append(dy)
            graphs.append((outs, leaves, cots))
        lib_ms = device_ms(lambda g: torch.autograd.grad(
            g[0], g[1], g[2], retain_graph=True), graphs, 100)
        require(min(ms, plain_ms, lib_ms) > 0,
                f"{what}: the profiler recorded no device time")
        elements = sum(x.numel() for x, _, _ in tensors)
        b_ms, b_by = bound(nbytes, NORM_BWD_OPS * elements, "f32_core")
        print(f"{what}: max|Δ| {err:.3e}, two calls bit-equal  kernel "
              f"{ms:.4f} ms ({geometry})  plain {plain_ms:.4f} ms  library "
              f"(autograd backward of F.rms_norm"
              f"{', two' if k_shape else ''}) {lib_ms:.4f} ms  bound "
              f"{b_ms:.4f} ms ({b_by})")
        numbers = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=b_ms, bound_by=b_by,
                       shape=f"{shapes} bf16, f32 scale")
        if k_shape:
            res["pair"] = numbers
        elif "MLA" in name:
            res.setdefault("mla", {})[name[4:]] = numbers
        elif shape[1] == 4096:
            res["tokens_4096"] = numbers
        else:
            res.update(numbers)
        del sets, graphs
    return res


SMALL_ROUNDS = (("mu_splitfed", "counter", "seed_replay"),
                ("mu_splitfed", "gaussian", "dense"),
                ("mu_splitfed", "gaussian", "seed_replay"),
                ("mu_splitfed", "sphere", "dense"),
                ("mu_splitfed", "sphere", "seed_replay"),
                ("vanilla", "gaussian", "dense"),
                ("gas", "gaussian", "dense"),
                ("gas", "counter", "seed_replay"))
# mixtral's: path 8 (c)'s round, and GAS, whose buffer carries the aux
# (the MoE round's CPU side takes 2-4x olmo's, in its expert leaves' noise)
MOE_SMALL_ROUNDS = (("mu_splitfed", "counter", "seed_replay"),
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
    """One round of a small f32 model on the card against the same round
    on the CPU, where the plain versions run, for each algorithm, noise
    and aggregation in SMALL_ROUNDS (GAS with a stale client: its buffer,
    the MoE aux with it, too, an MoE buffer within 1e-4 of its largest
    magnitude): olmo-1b SMOKE, and for MOE_SMALL_ROUNDS mixtral-8x22b
    SMOKE (4 experts top-2, window 32 under 64 tokens), deepseek-v2-236b
    SMOKE (MLA, 8 experts top-2 and 1 shared) and jamba-1.5-large-398b
    SMOKE (Mamba through the selective scan at d_state 4, 4 experts top-2
    at every other block) and xlstm-350m SMOKE (mLSTM heads of 64, the
    sLSTM kernel at head dim 32), each as ``configs.card_smoke_config``
    widens it."""
    for arch, kv, cases in (("olmo-1b", 2, SMALL_ROUNDS),
                            ("mixtral-8x22b", 1, MOE_SMALL_ROUNDS),
                            ("deepseek-v2-236b", 2, MOE_SMALL_ROUNDS),
                            ("jamba-1.5-large-398b", 1, MOE_SMALL_ROUNDS),
                            ("xlstm-350m", 1, MOE_SMALL_ROUNDS)):
        small_rounds(dev, arch, kv, cases)


def small_rounds(dev, arch: str, n_kv_heads: int, cases):
    import numpy as np
    from repro_torch.configs import SFLConfig, card_smoke_config
    from repro_torch.core import prng
    from repro_torch.models import init_params, untie_params
    from repro_torch.utils import tree
    cfg = card_smoke_config(arch, n_kv_heads)
    params = untie_params(cfg, init_params(
        cfg, torch.Generator().manual_seed(0)))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 2, 64))
    for algorithm, dist, aggregation in cases:
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
        # an MoE buffer's activations reach |h| ~ 10^2-10^3 (the experts'
        # fan-in init), so its tolerance is relative to the largest
        hs = (max(float(b.abs().max()) for b in sc)
              if sc and cfg.moe is not None else 1.0)
        what = f"{arch}, {algorithm}, {dist}, {aggregation}"
        print(f"small f32 round ({what}), card vs CPU: params max|Δ| "
              f"{dp:.3e}  metrics max|Δ| {dm:.3e}"
              + (f"  buffer max|Δ| {ds:.3e} (of {hs:.3e})" if sc else ""))
        require(dp <= 1e-4 and dm <= 1e-4 and ds <= 1e-4 * hs,
                f"small round ({what}): card and CPU disagree")


# the small first-order rounds: (algorithm, optimizer, learning rate,
# arch), AdamW at the repo's first-order default (TrainConfig.lr), where
# its first step's sign-like direction g/(|g| + 1e-8) keeps rounding-level
# gradients from moving an element by more than the check's 1e-4 on
# olmo-1b (on deepseek-v2-236b's MLA it moved one by 2.7e-4, so MLA's
# round runs SGD here; its AdamW round is held against the reference on
# the CPU, tests/test_torch_mla_grad.py); jamba's FedAvg and FedLoRA
# through the selective scan's backward at the card SMOKE's d_state 4;
# xlstm's through the sLSTM backward at the card SMOKE's head dim 32
FO_SMALL = (("fedavg", "sgd", 1e-2, "olmo-1b"),
            ("fedavg", "adamw", 1e-3, "olmo-1b"),
            ("fedlora", "sgd", 1e-2, "qwen3-14b"),
            ("fedavg", "sgd", 1e-2, "deepseek-v2-236b"),
            ("fedavg", "sgd", 1e-2, "jamba-1.5-large-398b"),
            ("fedlora", "sgd", 1e-2, "jamba-1.5-large-398b"),
            ("fedavg", "sgd", 1e-2, "xlstm-350m"),
            ("fedlora", "sgd", 1e-2, "xlstm-350m"))


def phase_small_fo(dev):
    """One small f32 first-order round on the card (the flash and rmsnorm
    forward and backward kernels) against the same round on the CPU (their
    plain versions), within 1e-4: FedAvg with SGD and with AdamW on olmo-1b
    (d_head 64), FedLoRA on qwen3-14b with qk-norm and GQA (d_head 64, two
    query heads a kv head), FedAvg with SGD on deepseek-v2-236b's MLA at
    (192, 128) (the flash backward at that pair, the rmsnorm backward of
    its kv_norm and q_norm), FedAvg with SGD and FedLoRA on
    jamba-1.5-large-398b (the selective scan's backward at d_state 4; the
    adapters on its attention block), FedAvg with SGD and FedLoRA on
    xlstm-350m (no attention: the sLSTM backward at head dim 32 and the
    rmsnorm backward; the adapters on the mLSTM blocks), each widened by
    ``card_smoke_config``."""
    import numpy as np
    from repro_torch.configs import card_smoke_config
    from repro_torch.core import prng
    from repro_torch.core.baselines import fedavg_round, fedlora_round
    from repro_torch.kernels import build
    from repro_torch.models import init_params, untie_params
    from repro_torch.optim import init_lora
    from repro_torch.utils import tree
    for algorithm, optimizer, lr, arch in FO_SMALL:
        cfg = card_smoke_config(arch, 2 if arch == "olmo-1b" else 1)
        params = untie_params(cfg, init_params(
            cfg, torch.Generator().manual_seed(0)))
        toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                 (2, 2, 64))
        keys = ("flash_attention_bwd", "rmsnorm_bwd",
                "flash_attention_bwd (192, 128)", "selective_scan_bwd",
                "slstm_bwd")
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
                k: build.LAUNCHES[k] - before.get(k, 0) for k in keys})
        (want, _), (got, n) = outs["cpu"], outs[str(dev)]
        err = max(max_err(a.cpu(), b) for a, b in zip(got, want))
        what = f"{arch} {algorithm} ({optimizer}, lr {lr})"
        print(f"small f32 first-order round ({what}), card vs CPU: max|Δ| "
              f"{err:.3e}; backward launches on the card {n}")
        require(err <= 1e-4, f"small round ({what}): card and CPU disagree")
        mla = cfg.attn_impl == "mla"
        mamba = "mamba" in cfg.block_pattern
        xlstm = "slstm" in cfg.block_pattern
        require((xlstm or n["flash_attention_bwd"] > 0) and (
            algorithm == "fedavg" or n["rmsnorm_bwd"] > 0) and (
            not mla or min(n["rmsnorm_bwd"],
                           n["flash_attention_bwd (192, 128)"]) > 0) and (
            not mamba or n["selective_scan_bwd"] > 0) and (
            not xlstm or min(n["rmsnorm_bwd"], n["slstm_bwd"]) > 0),
            f"small round ({what}): a backward kernel did not launch")


def drive(dev, name: str, run, sfl, kernels, frozen: bool = False,
          profile: bool = True) -> tuple:
    """Rounds of a path through the driver's engine (``train.run_engine``
    on ``run`` with ``sfl``): every launch counter set to 0 just before and
    read just after, and every kernel in ``kernels`` must have launched.
    Each chunk's seconds (ending in the chunk's flush, a synchronise) and
    peak memory are printed with its masks. Losses and parameters must be
    finite, and the parameters must have moved (a sample of each leaf is
    kept before the rounds), or with ``frozen`` (FedLoRA's base) must not
    have. One more round at the last tau then runs under
    the profiler (without the run's telemetry, log or trace), unless
    ``profile`` is False. Returns
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
    if profile:
        profile_one_round(name, run._replace(params=res.params), sfl,
                          int(res.tau_per_round[-1]))
    return res, ctl, launches, chunks


def profile_one_round(name: str, run, sfl, tau: int) -> None:
    """One more round of ``run`` (from its parameters) at ``tau`` under the
    profiler, without the run's telemetry, log, trace or checkpoints."""
    from repro_torch.launch import train
    one = run._replace(
        args=argparse.Namespace(**{**vars(run.args), "rounds": 1,
                                   "adaptive_tau": False, "tau_source": "sim",
                                   "telemetry": False, "log_jsonl": "",
                                   "trace_out": "", "ckpt_dir": ""}))
    profile_round(f"{name}, one round at tau {tau}", lambda: train.run_engine(
        one, sfl=dataclasses.replace(sfl, tau=tau), log=None))


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


def paper_run(name: str, argv):
    """``train.setup(argv)`` on paper-opt-1.3b at its full config (paths
    4-7), after emptying the allocator's cache."""
    from repro_torch.launch import train
    torch.cuda.empty_cache()
    run = train.setup(argv)
    require(run.cfg.n_layers == 24 and run.cfg.d_model == 2048
            and run.cfg.d_head == 64 and run.cfg.vocab_size == 50272,
            f"{name}: not paper-opt-1.3b's full config")
    return run


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
            run = paper_run(name, [*PAPER_ARGV, "--algorithm", algorithm,
                                   *extra])
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
    from repro_torch.utils import tree
    launches, summary = {}, {}
    for algorithm in ("fedavg", "fedlora"):
        name = f"FO paper path ({algorithm})"
        run = paper_run(name, [*PAPER_ARGV, "--algorithm", algorithm])
        cfg = run.cfg
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
    two block norms and the qk-norm pair, q and k in one launch, a layer,
    and the final norm: 3·layers + 1 launches), beside the flash backward
    at d_head 128 with GQA 40/8. Returns the launch counts."""
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
    require(n.get("rmsnorm_bwd") == M * (3 * L + 1)
            and n.get("flash_attention_bwd") == M * L,
            f"{name}: launches {n}, not {M * (3 * L + 1)} rmsnorm and "
            f"{M * L} flash backwards")
    return n


# path 6: checkpoint and resume on path 4's model, flags and schedule, one
# algorithm for each kind of checkpoint: MU-SplitFed's params alone with
# adaptive tau's overrides (simulated clock), GAS's {'params','state'}
# bundle with its activation buffer, FedLoRA's with its adapters
# MU-SplitFed re-plans τ every round (--chunk-size 1), so τ reaches its
# cap at round 1, before the checkpoint: the resumed run replays that
# override, and its first boundary, which observes no window, keeps it
RESUME_RUNS = (
    ("mu_splitfed", ["--tau", "2", "--adaptive-tau", "--tau-max", "4",
                     "--chunk-size", "1"],
     "gaussian", ("threefry", "flash_attention")),
    ("gas", ["--aggregation", "seed_replay"], "counter",
     ("zo_update", "zo_replay", "flash_attention")),
    ("fedlora", [], "gaussian", ("flash_attention", "flash_attention_bwd")))


def host_leaves(tree_) -> list:
    """(path, tensor on the host) for every leaf of a tree; a numpy leaf
    (the semi-async store's uint32 keys) as an int64 tensor."""
    import numpy as np
    from repro_torch.utils import tree
    return [(k, torch.from_numpy(t.astype(np.int64))
             if isinstance(t, np.ndarray) else t.detach().cpu())
            for k, t in tree.path_leaves(tree_)]


def require_equal(name: str, got, want) -> None:
    """Every leaf of ``got`` torch.equal to its counterpart in ``want``
    (both host leaf lists); else print each leaf that differs with its max
    |Δ| and fail."""
    require([k for k, _ in got] == [k for k, _ in want],
            f"{name}: the trees hold other leaves")
    bad = [(k, max_err(a, b)) for (k, a), (_, b) in zip(got, want)
           if a.dtype != b.dtype or not torch.equal(a, b)]
    for k, err in bad:
        print(f"{name}: leaf {k} differs, max |Δ| {err:.3e}")
    require(not bad, f"{name}: {len(bad)} leaves differ")


def phase_resume(dev) -> dict:
    """Path 6, checkpoint and resume on paper-opt-1.3b at its full config
    with ``PAPER_ARGV``, through ``train.setup`` + ``train.run_engine`` and
    the driver's resume (``--ckpt-dir``, ``--ckpt-every 2``), for each of
    ``RESUME_RUNS`` on the same seed and schedule: an uninterrupted 4-round
    run, copied to the host; a run of rounds 0-1 that checkpoints; and a
    fresh setup with --rounds 4 on the same directory, which must resume
    from round 2, at the uninterrupted run's τ of round 2, and run rounds
    2-3. The resumed run's round losses (and tau per round) must equal
    the uninterrupted run's and every parameter and state leaf be
    torch.equal to its counterpart, and the card-written checkpoints must
    verify. Then, on the resumed run's bundle, the
    seconds of a Checkpointer.save (the host copy) and of its wait() (the
    write), of restore_params onto the card and of verify_checkpoint, and
    the checkpoint's GiB, beside the card's name and power limit; the
    restored bundle must equal the saved one. Returns the resumed runs'
    launch counts (the counters set to 0 just before each resumed run)."""
    import os
    import tempfile

    from repro_torch.ckpt import (Checkpointer, latest_good_step,
                                  restore_params, verify_checkpoint)
    from repro_torch.core import engine
    from repro_torch.kernels import build
    from repro_torch.launch import train
    card = ", ".join(smi("name,power.limit"))
    launches = {}
    t_path = time.perf_counter()
    for algorithm, extra, dist, kernels in RESUME_RUNS:
        name = f"resume path ({algorithm})"
        argv = [*PAPER_ARGV, "--algorithm", algorithm, *extra]
        lines = []

        def log(line, lines=lines, name=name):
            lines.append(line)
            print(f"{name}: {line}")

        def setup(*more):
            run = paper_run(name, [*argv, *more])
            return run, dataclasses.replace(run.sfl, perturbation_dist=dist)

        run, sfl = setup()
        full, _ = train.run_engine(run, sfl=sfl, log=log)
        want = ([float(x) for x in full.round_loss],
                [int(t) for t in full.tau_per_round],
                host_leaves(full.params), host_leaves(full.state))
        del run, full
        with tempfile.TemporaryDirectory() as tmp:
            ck_argv = ["--ckpt-dir", tmp, "--ckpt-every", "2"]
            run, sfl = setup("--rounds", "2", *ck_argv)
            part1, _ = train.run_engine(run, sfl=sfl, log=log)
            del run
            require(latest_good_step(tmp) == 1,
                    f"{name}: no checkpoint at round 1")
            run, sfl = setup(*ck_argv)
            lines.clear()
            torch.cuda.synchronize()
            build.reset_launches()
            part2, _ = train.run_engine(run, sfl=sfl, log=log)
            torch.cuda.synchronize()
            n = dict(build.LAUNCHES)
            del run
            require(lines and lines[0] ==
                    f"[resume] from round 2 (tau={want[1][2]})",
                    f"{name}: the run did not resume from round 2 at the "
                    f"uninterrupted run's tau: {lines[:1]}")
            for k in kernels:
                require(n.get(k, 0) > 0,
                        f"{name}: kernel {k} was never launched")
            for k, v in n.items():
                launches[k] = launches.get(k, 0) + v
            losses = [float(x) for x in (*part1.round_loss,
                                         *part2.round_loss)]
            taus = [int(t) for t in (*part1.tau_per_round,
                                     *part2.tau_per_round)]
            print(f"{name}: losses uninterrupted {want[0]} resumed {losses}; "
                  f"tau per round {want[1]} resumed {taus}; launches {n}")
            require(losses == want[0] and taus == want[1],
                    f"{name}: the resumed rounds differ")
            require_equal(f"{name}: parameters", host_leaves(part2.params),
                          want[2])
            require_equal(f"{name}: state", host_leaves(part2.state),
                          want[3])
            # step 1 verified above (latest_good_step); step 3 is the
            # resumed run's final save
            require(verify_checkpoint(tmp, 3),
                    f"{name}: the checkpoint at step 3 does not verify")
            del part1, want
            for step in (1, 3):
                for f in os.listdir(os.path.join(tmp, f"step_{step:010d}")):
                    os.remove(os.path.join(tmp, f"step_{step:010d}", f))
            bundle = engine._ckpt_tree(part2.params, part2.state)
            ck = Checkpointer(os.path.join(tmp, "timed"))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ck.save(3, bundle)
            t1 = time.perf_counter()
            ck.wait()
            t2 = time.perf_counter()
            got, _ = restore_params(ck.dir, bundle, 3)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            require(verify_checkpoint(ck.dir, 3),
                    f"{name}: the timed checkpoint does not verify")
            t4 = time.perf_counter()
            gib = os.path.getsize(os.path.join(
                ck.dir, "step_0000000003", "arrays.npz")) / 2 ** 30
            require_equal(f"{name}: restored bundle", host_leaves(got),
                          host_leaves(bundle))
            print(f"{name}: checkpoint {gib:.3f} GiB: save (host copy) "
                  f"{t1 - t0:.3f} s, wait (write) {t2 - t1:.3f} s, restore "
                  f"onto the card {t3 - t2:.3f} s, verify_checkpoint "
                  f"{t4 - t3:.3f} s ({card})")
            del bundle, got, part2
    print(f"resume path: {time.perf_counter() - t_path:.1f} s in all")
    return launches


# path 7: path 4's model, flags and schedule under the semi-async engine
ASYNC_ARGV = [*PAPER_ARGV, "--tau", "2", "--async", "--quorum", "2",
              "--staleness-discount", "0.5"]
ASYNC_FAULTS = "crash=0.2,loss=0.2,dup=0.1,corrupt=0.1"
ASYNC_KERNELS = ("zo_update", "zo_replay", "flash_attention")


def sim_records(log: str) -> list:
    """The 'sim' telemetry records of a run log's chunk rows."""
    from repro_torch import obs
    return [t for c in obs.read_jsonl(log, kind="chunk")
            for t in c["telemetry"] if t["source"] == "sim"]


def phase_async(dev) -> dict:
    """Path 7, the semi-async event engine on paper-opt-1.3b at its full
    config with ``ASYNC_ARGV`` (path 4's flags, schedule and 4 versions in
    chunks of 2; quorum 2, staleness discount 0.5, τ 2, seed replay),
    through ``train.setup`` + ``drive`` (counter noise set after setup):
      a. the dense timeline: each version's start set and apply weights as
         the device step received them, its staleness, simulated commit
         time and duration and its quorum wait (the run log's 'sim'
         records) must equal the host ``compile_timeline``'s on the same
         schedule;
      b. the sparse timeline with ``--loader subset`` and the automatic
         k_max and ring: round times equal run a's; losses within 2^-7 of
         run a's relatively and every parameter leaf within 2^-7 of its
         largest magnitude (one bf16 ulp: the sparse replay sums the
         gathered records without the dense store's zero-weight ones);
      c. faults (``ASYNC_FAULTS``, quorum timeout 1.0, ``--adaptive-quorum``,
         ``--telemetry``): the fault counters of each chunk's 'sim' record
         must equal the host timeline's under the quorums the controller
         chose; its decisions are printed;
      d. SIGKILL and resume: ``python -m repro_torch.launch.train`` with
         run a's flags and the driver's default threefry gaussian noise,
         ``--ckpt-dir``, ``--ckpt-every 2`` and ``--faults kill=2`` must
         die by SIGKILL after printing the kill line, leaving only
         step_0000000001; a second one without the kill must resume at
         version 2; its final checkpoint must be ``torch.equal``, leaf by
         leaf over the parameters and the store, to an uninterrupted
         in-process run's, and its logged losses equal.
    Returns the launch counts of runs a-c and of d's in-process run."""
    import os
    import signal
    import tempfile

    import numpy as np
    from repro_torch import obs
    from repro_torch.ckpt import restore_params
    from repro_torch.core import engine, events
    from repro_torch.kernels import build
    from repro_torch.launch import train
    from repro_torch.utils import tree
    card = ", ".join(smi("name,power.limit"))
    launches = {}

    def add(n):
        for k, v in n.items():
            launches[k] = launches.get(k, 0) + v

    t_path = time.perf_counter()
    V = 4
    with tempfile.TemporaryDirectory() as tmp:
        # a. the dense timeline, each device step's rows recorded
        name = "async path (a: dense timeline, counter)"
        run = paper_run(name, [*ASYNC_ARGV, "--log-jsonl", f"{tmp}/a.jsonl"])
        sfl = dataclasses.replace(run.sfl, perturbation_dist="counter")
        step, seen = events.async_mu_splitfed_step, []

        def spy(cfg, sfl_, params, store, batches, start_mask, apply_w, key,
                **kw):
            seen.append((np.asarray(start_mask).copy(),
                         np.asarray(apply_w).copy()))
            return step(cfg, sfl_, params, store, batches, start_mask,
                        apply_w, key, **kw)

        events.async_mu_splitfed_step = spy
        try:
            res_a, _, n, chunks = drive(dev, name, run, sfl, ASYNC_KERNELS)
        finally:
            events.async_mu_splitfed_step = step
        add(n)
        sched = train.schedule(run)
        tl = events.compile_timeline(sched, V, quorum=2, discount=0.5, tau=2)
        qw = np.concatenate([r["quorum_wait"] for r in
                             sim_records(f"{tmp}/a.jsonl")])
        for v in range(V):
            start, w = seen[v]
            starts = np.flatnonzero(start > 0).tolist()
            print(f"{name}: version {v}: starts {starts}  apply weights "
                  f"{w.tolist()}  staleness "
                  f"{tl.staleness_m[v].tolist()}  commit at "
                  f"{tl.commit_times[v]} s (duration {res_a.round_times[v]}"
                  f" s)  quorum wait {qw[v]} s  loss {res_a.round_loss[v]}")
            require(np.array_equal(start, tl.start_mask[v])
                    and np.array_equal(w, tl.apply_w[v]),
                    f"{name}: version {v} ran other rows than the host "
                    f"timeline's")
        require(np.array_equal(res_a.round_times, tl.durations)
                and np.array_equal(qw, tl.quorum_wait),
                f"{name}: round times or quorum waits differ from the host "
                f"timeline's")
        require(bool((tl.staleness_m > 0).any()),
                f"{name}: no contribution was stale")
        print(f"{name}: seconds a version by chunk "
              f"{[c[1] / len(c[0]) for c in chunks]}, peak GiB by chunk "
              f"{[c[2] for c in chunks]} ({card})")
        want = (res_a.round_loss, res_a.params)
        del run, res_a

        print(f"async path: run a {time.perf_counter() - t_path:.1f} s")
        t_run = time.perf_counter()

        # b. the sparse timeline with subset staging
        name = "async path (b: sparse timeline, subset loader)"
        run = paper_run(name, [*ASYNC_ARGV, "--timeline", "sparse",
                               "--loader", "subset"])
        sfl = dataclasses.replace(run.sfl, perturbation_dist="counter")
        print(f"{name}: k_max, ring capacity "
              f"{events.resolve_store_geometry(sfl)}")
        res_b, _, n, chunks = drive(dev, name, run, sfl, ASYNC_KERNELS,
                                    profile=False)
        add(n)
        loss_rel = float(np.max(np.abs(res_b.round_loss - want[0])
                                / np.maximum(np.abs(want[0]), 1e-30)))
        param_rel = 0.0
        for a, b in zip(tree.leaves(res_b.params), tree.leaves(want[1])):
            param_rel = max(param_rel, max_err(a, b)
                            / max(float(b.float().abs().max()), 1e-30))
        print(f"{name}: against run a: round times equal "
              f"{np.array_equal(res_b.round_times, tl.durations)}, losses "
              f"within {loss_rel:.3e} relative, parameters within "
              f"{param_rel:.3e} of each leaf's max |x|; seconds a version "
              f"by chunk {[c[1] / len(c[0]) for c in chunks]} ({card})")
        require(np.array_equal(res_b.round_times, tl.durations),
                f"{name}: round times differ from run a's")
        require(loss_rel <= 2.0 ** -7 and param_rel <= 2.0 ** -7,
                f"{name}: losses or parameters past one bf16 ulp of run a's")
        del run, res_b, want

        print(f"async path: run b {time.perf_counter() - t_run:.1f} s")
        t_run = time.perf_counter()

        # c. faults with the adaptive quorum
        name = "async path (c: faults, adaptive quorum)"
        run = paper_run(name, [*ASYNC_ARGV, "--faults", ASYNC_FAULTS,
                               "--quorum-timeout", "1.0",
                               "--adaptive-quorum", "--telemetry",
                               "--log-jsonl", f"{tmp}/c.jsonl"])
        sfl = dataclasses.replace(run.sfl, perturbation_dist="counter")
        res_c, ctl, n, _ = drive(dev, name, run, sfl, ASYNC_KERNELS,
                                 profile=False)
        add(n)
        quorums = np.full(V, 2, np.int64)
        for r, k in ctl.trace:
            quorums[r:] = k
        tl = events.compile_timeline(
            sched, V, quorum=quorums, discount=0.5, tau=2, faults=sfl.faults,
            quorum_timeout=1.0, max_retries=sfl.max_retries)
        recs = sim_records(f"{tmp}/c.jsonl")
        require(len(recs) == 2, f"{name}: {len(recs)} sim records, not 2")
        for rec in recs:
            r0, r1 = rec["start"], rec["stop"]
            got = {f: rec[f] for f in engine.FAULT_COLS}
            host = {f: int(getattr(tl, f)[r0:r1].sum())
                    if getattr(tl, f, None) is not None else 0
                    for f in engine.FAULT_COLS}
            print(f"{name}: versions {r0}-{r1 - 1}: fault counters {got}")
            require(got == host, f"{name}: the counters differ from the "
                    f"host timeline's {host}")
        require(sum(r[f] for r in recs for f in
                    ("crashed", "lost", "corrupt", "dups", "retries")) > 0,
                f"{name}: the fault plan never acted")
        print(f"{name}: adaptive quorum decisions {ctl.trace}, quorum per "
              f"version {quorums.tolist()}, losses "
              f"{list(res_c.round_loss)} ({card})")
        del run, res_c, ctl

        print(f"async path: run c {time.perf_counter() - t_run:.1f} s")

        # d. SIGKILL after the chunk holding version 2, then the resume
        name = "async path (d: SIGKILL and resume, gaussian)"
        ck, log = f"{tmp}/ck", f"{tmp}/d.jsonl"
        cmd = [sys.executable, "-m", "repro_torch.launch.train", *ASYNC_ARGV,
               "--ckpt-dir", ck, "--ckpt-every", "2", "--log-jsonl", log]
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        killed = subprocess.run([*cmd, "--faults", "kill=2"], cwd=ROOT,
                                env=env, capture_output=True, text=True,
                                timeout=300)
        t1 = time.perf_counter()
        print(f"{name}: killed run: exit {killed.returncode} in "
              f"{t1 - t0:.1f} s; checkpoints {sorted(os.listdir(ck))}")
        require(killed.returncode == -signal.SIGKILL
                and "[faults] kill=2: SIGKILL after chunk [2, 4)"
                in killed.stdout,
                f"{name}: the run did not die by SIGKILL after chunk [2, 4):"
                f" {killed.stdout[-1000:]} {killed.stderr[-2000:]}")
        require(sorted(os.listdir(ck)) == ["step_0000000001"],
                f"{name}: the killed chunk's checkpoint landed")
        resumed = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                                 text=True, timeout=300)
        t2 = time.perf_counter()
        print(f"{name}: resumed run: exit {resumed.returncode} in "
              f"{t2 - t1:.1f} s")
        require(resumed.returncode == 0
                and "[resume] from round 2 (tau=2)" in resumed.stdout,
                f"{name}: the rerun did not resume at version 2: "
                f"{resumed.stdout[-1000:]} {resumed.stderr[-2000:]}")
        t3 = time.perf_counter()
        run = paper_run(name, [*ASYNC_ARGV, "--log-jsonl", f"{tmp}/u.jsonl"])
        require(run.sfl.perturbation_dist == "gaussian",
                f"{name}: the driver's default noise is not gaussian")
        torch.cuda.synchronize()
        build.reset_launches()
        full, _ = train.run_engine(run, log=None)
        torch.cuda.synchronize()
        add(dict(build.LAUNCHES))
        print(f"{name}: uninterrupted run in process "
              f"{time.perf_counter() - t3:.1f} s (setup included)")
        print(f"{name}: uninterrupted run launches {dict(build.LAUNCHES)}")
        require(build.LAUNCHES.get("threefry", 0) > 0,
                f"{name}: threefry was never launched")
        bundle = engine._ckpt_tree(full.params, full.state)
        got, _ = restore_params(ck, bundle, V - 1)
        require_equal(name, host_leaves(got), host_leaves(bundle))
        losses = [r["loss"] for r in obs.read_jsonl(log, kind="round")]
        want = [r["loss"] for r in obs.read_jsonl(f"{tmp}/u.jsonl",
                                                  kind="round")]
        print(f"{name}: losses resumed {losses} uninterrupted {want}; "
              f"every parameter and store leaf of the final checkpoint "
              f"equal ({card})")
        require(losses == want and len(losses) == V,
                f"{name}: the logged losses differ")
        del run, full, bundle, got
    print(f"async path: {time.perf_counter() - t_path:.1f} s in all")
    return launches


# path 8: serving and the MoE family. (a) qwen3-14b at full width, path
# 2's depth; (b) mixtral-8x22b at full width, 3 of 56 layers (7.91 B
# parameters; 4 would not fit a ZO round), a prompt past its 4096 window;
# (c) one MU-SplitFed round of (b)'s model through the driver
SERVE_QWEN = dict(batch=4, prompt_len=512, gen=32, steps=(1, 16, 32))
SERVE_MIXTRAL = dict(batch=1, prompt_len=4160, gen=16, steps=(1, 8, 16))
MIXTRAL_LAYERS = 3
MIXTRAL_ARGV = ["--arch", "mixtral-8x22b", "--clients", "2", "--tau", "2",
                "--batch", "1", "--seq", "512", "--rounds", "1",
                "--chunk-size", "1", "--aggregation", "seed_replay"]
# an MoE model's ZO round holds about 2.95x its parameter bytes (module
# docstring; a dense model's about 3.9x)
MOE_ROUND_BYTES_PER_PARAM_BYTE = 2.95
# bf16 tolerances of path 8, relative to the largest |logit| of the full
# forward: prefill's last position against logits_fn on the prompt (the
# same computation but the head product's shape: a few bf16 ulps), and a
# decode step against logits_fn on the prompt and the generated tokens
# (decode attends in plain PyTorch with bf16 probabilities, the flash
# kernel in f32, and every product has another shape: bf16 rounding
# through every layer)
PREFILL_TOL = 2.0 ** -6
DECODE_TOL = 2.0 ** -4
# mixtral's decode-vs-full check runs in f32: in bf16 the decode path's
# activations, a few bf16 ulps off the full forward's, send a token whose
# top-2 routing probabilities are that close to another expert (on the CPU
# at SMOKE size, bf16, capacity 16: one step 38% of max|logit| off, while
# f32 stays within 2e-6), a difference of rounding and not a fault
F32_DECODE_TOL = 1e-4


def serve_request(dev, name, cfg, params, prompt, gen, steps, kernels,
                  decode_tol=DECODE_TOL, profile=True):
    """One request through ``serve.generate`` (greedy), every launch
    counter set to 0 just before and read just after; then the check pass:
    prefill and decode_step on the generated tokens, each timed with a
    synchronise, prefill's last logits held against ``logits_fn`` on the
    prompt and the decode logits of ``steps`` (1-based) against
    ``logits_fn`` on the prompt and the generated tokens (relative to that
    forward's largest |logit|). The check pass must reproduce the tokens.
    With ``profile``, one more request runs under the profiler (device
    busy share, time by kernel). Returns (launches, {prefill_ms,
    decode_ms, tok_s, peak})."""
    from repro_torch.kernels import build
    from repro_torch.launch import serve
    from repro_torch.models import decode_step, logits_fn, prefill
    B, S = prompt.shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    build.reset_launches()
    t0 = time.perf_counter()
    toks = serve.generate(cfg, params, {"tokens": prompt}, S, gen)
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    tok_s = serve.stats()["metrics"]["serve.last_tok_per_s"]["value"]
    print(f"{name}: generate {B}x{gen} tokens after a {S}-token prompt in "
          f"{wall:.3f} s ({tok_s:.1f} tokens/s, the serve.last_tok_per_s "
          f"gauge); peak {peak:.2f} GiB; launches {launches}")
    for k in kernels:
        require(launches.get(k, 0) > 0, f"{name}: kernel {k} was never "
                f"launched")
    require(tuple(toks.shape) == (B, gen), f"{name}: tokens {toks.shape}")
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = prefill(cfg, params, {"tokens": prompt},
                            cache_len=S + gen)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        step_logits = {}
        t0 = time.perf_counter()
        first = lg[:, -1].argmax(-1, keepdim=True)
        for i in range(gen):
            lg_i, cache = decode_step(cfg, params, toks[:, i:i + 1], cache,
                                      S + i)
            if i + 1 in steps:
                step_logits[i + 1] = lg_i[:, 0]
            if i + 1 < gen:
                require(torch.equal(lg_i[:, -1].argmax(-1),
                                    toks[:, i + 1]),
                        f"{name}: the check pass's token {i + 2} differs")
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / gen
        require(torch.equal(first, toks[:, :1]),
                f"{name}: the check pass's first token differs")
        want = logits_fn(cfg, params, {"tokens": prompt})[:, -1].float()
        scale = float(want.abs().max())
        d = float((lg[:, 0].float() - want).abs().max())
        print(f"{name}: prefill {prefill_ms:.1f} ms, decode "
              f"{decode_ms:.2f} ms a token ({B} requests a step); prefill "
              f"logits vs logits_fn on the prompt max|Δ| {d:.4e} of "
              f"max|logit| {scale:.4e} ({d / scale:.2e}; tolerance "
              f"{PREFILL_TOL:.2e})")
        require(math.isfinite(scale) and d <= PREFILL_TOL * scale,
                f"{name}: prefill logits outside tolerance")
        if steps:
            full = logits_fn(cfg, params, {"tokens": torch.cat(
                [prompt, toks], 1)})
            scale = float(full.float().abs().max())
        for j, got in step_logits.items():
            want = full[:, S + j - 1].float()
            d = float((got.float() - want).abs().max())
            agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
            print(f"{name}: decode step {j} logits vs logits_fn max|Δ| "
                  f"{d:.4e} ({d / scale:.2e} of max|logit|; tolerance "
                  f"{decode_tol:.2e}); argmax agrees on {agree:.0%} of the "
                  f"requests")
            require(d <= decode_tol * scale,
                    f"{name}: decode step {j} outside tolerance")
    if profile:
        profile_round(f"{name}, one more request", lambda: serve.generate(
            cfg, params, {"tokens": prompt}, S, gen))
    return launches, dict(prefill_ms=prefill_ms, decode_ms=decode_ms,
                          tok_s=tok_s, peak=peak)


def phase_serve(dev) -> dict:
    """Path 8: serving (``serve.generate``: ``prefill`` through the flash
    kernel, ``decode_step`` over the KV cache) and the MoE family, on the
    card's own ``logits_fn`` as the reference:
      a. qwen3-14b at full width, QWEN_LAYERS of 40 layers: 4 requests of
         512-token prompts, greedy, 32 new tokens; decode steps 1, 16, 32
         held against the full forward;
      b. mixtral-8x22b at full width, MIXTRAL_LAYERS of 56 layers: one
         request of a 4160-token prompt (past the 4096 window: prefill
         fills the ring) and 16 new tokens (decode wraps it), in bf16 at
         the config's capacity factor 1.25; then the decode-vs-full check
         in f32 (F32_DECODE_TOL) at n_experts/top_k = 4.0, where no token
         can drop (prefill sees 4160 tokens a group, the full forward
         4176);
      c. one MU-SplitFed round of (b)'s model through the driver
         (``MIXTRAL_ARGV``: counter noise, seed replay, M=2, tau=2, batch
         1, seq 512), ``moe_round``.
    Prints each part's seconds; returns the launches summed over a-c."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, param_count
    t_path = time.perf_counter()
    launches = {}

    def add(n):
        for k, v in n.items():
            launches[k] = launches.get(k, 0) + v

    def prompt(cfg, B, S, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                             device=dev)

    t0 = time.perf_counter()
    qwen = get_config("qwen3-14b").replace(n_layers=QWEN_LAYERS)
    params = init_params(qwen, torch.Generator(device=dev).manual_seed(0))
    a = SERVE_QWEN
    n, qs = serve_request(dev, f"serve path (a) qwen3-14b ({QWEN_LAYERS} of "
                          f"40 layers)", qwen, params,
                          prompt(qwen, a["batch"], a["prompt_len"], 1),
                          a["gen"], a["steps"], ("flash_attention",
                                                 "rmsnorm"))
    add(n)
    del params
    torch.cuda.empty_cache()
    print(f"serve path (a): {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    mix = get_config("mixtral-8x22b").replace(n_layers=MIXTRAL_LAYERS)
    params = init_params(mix, torch.Generator(device=dev).manual_seed(0))
    b = SERVE_MIXTRAL
    print(f"serve path (b) mixtral-8x22b: {MIXTRAL_LAYERS} of 56 layers, "
          f"{param_count(params):,} parameters, window "
          f"{mix.sliding_window}, {mix.moe.n_experts} experts top "
          f"{mix.moe.top_k}, d_ff {mix.d_ff}")
    p_b = prompt(mix, b["batch"], b["prompt_len"], 2)
    n, ms = serve_request(dev, "serve path (b) mixtral-8x22b bf16, capacity "
                          "factor 1.25", mix, params, p_b, b["gen"], (),
                          ("flash_attention", "rmsnorm"))
    add(n)
    del params
    torch.cuda.empty_cache()
    lifted = mix.replace(dtype="float32", moe=dataclasses.replace(
        mix.moe, capacity_factor=mix.moe.n_experts / mix.moe.top_k))
    params = init_params(lifted, torch.Generator(device=dev).manual_seed(0))
    n, _ = serve_request(dev, "serve path (b) mixtral-8x22b f32, capacity "
                         "factor 4.0", lifted, params, p_b, b["gen"],
                         b["steps"], ("flash_attention", "rmsnorm"),
                         decode_tol=F32_DECODE_TOL, profile=False)
    add(n)
    del params
    torch.cuda.empty_cache()
    print(f"serve path (b): {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    add(moe_round(dev, f"MoE round path (c) mixtral-8x22b ({MIXTRAL_LAYERS} "
                  f"of 56 layers)", MIXTRAL_ARGV, mix))
    print(f"MoE round path (c): {time.perf_counter() - t0:.1f} s")
    print(f"serve path: qwen3-14b prefill {qs['prefill_ms']:.1f} ms, decode "
          f"{qs['decode_ms']:.2f} ms a step, {qs['tok_s']:.1f} tokens/s, "
          f"peak {qs['peak']:.2f} GiB; mixtral-8x22b prefill "
          f"{ms['prefill_ms']:.1f} ms, decode {ms['decode_ms']:.2f} ms a "
          f"step, {ms['tok_s']:.1f} tokens/s, peak {ms['peak']:.2f} GiB; "
          f"path 8 {time.perf_counter() - t_path:.1f} s in all")
    return launches


MOE_ROUND_KERNELS = ("zo_update", "zo_replay", "flash_attention", "rmsnorm")


def moe_round(dev, name: str, argv, cfg, kernels=MOE_ROUND_KERNELS) -> dict:
    """One MU-SplitFed round of an MoE model through the driver
    (``train.setup(argv, cfg=cfg)``, counter noise set after it) with
    ``drive``: ``kernels`` (zo_update, zo_replay, flash_attention and
    rmsnorm; path 10 adds selective_scan) must launch; its peak memory
    printed against the reckoning of MOE_ROUND_BYTES_PER_PARAM_BYTE times
    the parameter bytes, with the
    round's own ratio beside it; the client's MoE aux loss after the round
    finite and positive. The profiled round runs after the initial
    parameters are dropped (deepseek-v2's round, at 70.5 GiB, leaves no
    room for a second copy). Returns the launches."""
    from repro_torch.launch import train
    from repro_torch.models import client_forward, param_count, split_params
    run = train.setup(argv, cfg=cfg)
    sfl = dataclasses.replace(run.sfl, perturbation_dist="counter")
    res, _, launches, chunks = drive(dev, name, run, sfl, kernels,
                                     profile=False)
    gib = param_count(run.params) * 2 / 2 ** 30
    peak = max(c[2] for c in chunks)
    with torch.inference_mode():
        xc, _ = split_params(cfg, res.params, sfl.cut_units)
        batch = {k: torch.as_tensor(v[0], device=dev)
                 for k, v in run.loader.round_batch(0).items()}
        aux = float(client_forward(cfg, xc, batch)["aux"])
    print(f"{name}: loss {list(res.round_loss)}; client aux (MoE load "
          f"balance, after the round) {aux:.6f}; peak {peak:.2f} GiB "
          f"against the reckoning {MOE_ROUND_BYTES_PER_PARAM_BYTE} x "
          f"{gib:.2f} GiB of parameters = "
          f"{MOE_ROUND_BYTES_PER_PARAM_BYTE * gib:.1f} GiB; measured ratio "
          f"{peak / gib:.3f}")
    require(math.isfinite(aux) and aux > 0, f"{name}: aux {aux}")
    run = run._replace(params=res.params)
    del res, xc
    torch.cuda.empty_cache()
    profile_one_round(name, run, sfl, sfl.tau)
    del run
    torch.cuda.empty_cache()
    return launches


# path 9: MLA and deepseek-v2-236b at full width (d_model 5120, 128 heads,
# q_lora 1536, kv_lora 512, nope/rope/v 128/64/128, 160 experts top-6 of
# d_expert 1536 and 2 shared, vocab 102400), DEEPSEEK_LAYERS of 60 layers
# (cut 2 + 1 server unit: 12.97 B parameters, 24.15 GiB in bf16). (a)
# serving: one 4096-token prompt, 16 greedy tokens in bf16 at the config's
# capacity factor; then the decode-vs-full check in f32 (48.3 GiB of
# parameters) on a 512-token prompt at capacity factor 160/6, where no
# token drops; (b) one MU-SplitFed round through the driver
DEEPSEEK_LAYERS = 3
SERVE_DEEPSEEK = dict(batch=1, prompt_len=4096, gen=16)
SERVE_DEEPSEEK_F32 = dict(batch=1, prompt_len=512, gen=8, steps=(1, 4, 8))
DEEPSEEK_ARGV = ["--arch", "deepseek-v2-236b", "--clients", "2", "--tau",
                 "2", "--batch", "1", "--seq", "512", "--rounds", "1",
                 "--chunk-size", "1", "--aggregation", "seed_replay"]
# path 9 (c): one FedAvg round of (a)'s model through the driver (SGD at
# the driver's defaults), its routed experts also cut, to
# DEEPSEEK_FO_EXPERTS of 160 (top-6 and the 2 shared kept): a FedAvg round
# holds a client's copy, its gradients and an f32 running sum beside the
# parameters; path 5's peaked at FO_ROUND_BYTES_PER_PARAM_BYTE = 6.6x its
# parameter bytes (17.37 GiB for paper-opt-1.3b's 2.634), which at 160
# experts (24.15 GiB) is 160 GiB. 32 experts: 3 x 951.5 M + 1,049 M =
# 3.90 B parameters, 7.27 GiB, a reckoned 48 GiB
DEEPSEEK_FO_EXPERTS = 32
DEEPSEEK_FO_ARGV = ["--arch", "deepseek-v2-236b", "--clients", "2",
                    "--batch", "1", "--seq", "512", "--rounds", "1",
                    "--chunk-size", "1", "--algorithm", "fedavg"]
FO_ROUND_BYTES_PER_PARAM_BYTE = 6.6


def mla_fo_round(dev, ds) -> dict:
    """Path 9 (c): one FedAvg round of ``ds`` with DEEPSEEK_FO_EXPERTS
    routed experts through the driver (``DEEPSEEK_FO_ARGV``) with
    ``drive``: the flash forward and backward at (192, 128) and the
    rmsnorm forward and backward must launch, the backward exactly M·L
    times at that pair (each client's one backward a layer) and the
    rmsnorm backward M·(4·L + 1) (norm1, norm2, q_norm and kv_norm a
    layer, and the final norm: q_norm's rows of 1536 and kv_norm's of 512
    are no pair, so each is a launch of its own); the loss finite, the
    parameters moved;
    the peak printed against FO_ROUND_BYTES_PER_PARAM_BYTE times the
    parameter bytes. Returns the launches."""
    from repro_torch.launch import train
    from repro_torch.models import param_count
    cfg = ds.replace(moe=dataclasses.replace(
        ds.moe, n_experts=DEEPSEEK_FO_EXPERTS))
    name = (f"FedAvg path (9c) deepseek-v2-236b ({DEEPSEEK_LAYERS} of 60 "
            f"layers, {DEEPSEEK_FO_EXPERTS} of 160 routed experts)")
    torch.cuda.empty_cache()
    run = train.setup(DEEPSEEK_FO_ARGV, cfg=cfg)
    gib = param_count(run.params) * 2 / 2 ** 30
    _, _, n, chunks = drive(dev, name, run, run.sfl, (
        "flash_attention", "flash_attention_bwd", "rmsnorm", "rmsnorm_bwd"))
    M, L = run.sfl.n_clients, DEEPSEEK_LAYERS
    # 4·L + 1: MLA's q_norm and kv_norm have different widths, so they are
    # not a pair (the qk-norm pair's one launch is qwen3's, 3·L + 1)
    require(n.get("flash_attention_bwd (192, 128)") == M * L
            and n.get("flash_attention_bwd") == M * L
            and n.get("rmsnorm_bwd") == M * (4 * L + 1),
            f"{name}: launches {n}, not {M * L} flash backwards at "
            f"(192, 128) and {M * (4 * L + 1)} rmsnorm backwards")
    peak = max(c[2] for c in chunks)
    print(f"{name}: a round {chunks[0][1]:.3f} s, peak {peak:.2f} GiB "
          f"against the reckoning {FO_ROUND_BYTES_PER_PARAM_BYTE} x "
          f"{gib:.2f} GiB of parameters = "
          f"{FO_ROUND_BYTES_PER_PARAM_BYTE * gib:.1f} GiB; measured ratio "
          f"{peak / gib:.3f}")
    del run
    torch.cuda.empty_cache()
    return n


def phase_mla(dev) -> dict:
    """Path 9: MLA and deepseek-v2-236b on the card's own ``logits_fn`` as
    the reference:
      a. ``serve.generate`` at full width, DEEPSEEK_LAYERS of 60 layers,
         bf16 at capacity factor 1.25: one request of a 4096-token prompt
         (MLA through the flash kernel at (192, 128), prefill filling the
         compressed c_kv and k_rope cache), 16 new tokens (the
         absorbed-weight decode), prefill's logits within PREFILL_TOL;
         then in f32 at n_experts/top_k = 160/6 (no token drops) a
         512-token prompt and 8 tokens, decode steps 1, 4, 8 within
         F32_DECODE_TOL of logits_fn on prompt and tokens;
      b. one MU-SplitFed round of (a)'s model through the driver
         (``DEEPSEEK_ARGV``: counter noise, seed replay, M=2, tau=2, batch
         1, seq 512), ``moe_round``;
      c. one FedAvg round of (a)'s model with 32 of its 160 routed
         experts through the driver (``DEEPSEEK_FO_ARGV``), the flash
         backward at (192, 128) and the rmsnorm backward at 5120, 1536
         and 512 under autograd, ``mla_fo_round``.
    Prints each part's seconds; returns the launches summed over a-c."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, param_count
    t_path = time.perf_counter()
    launches = {}

    def add(n):
        for k, v in n.items():
            launches[k] = launches.get(k, 0) + v

    t0 = time.perf_counter()
    ds = get_config("deepseek-v2-236b").replace(n_layers=DEEPSEEK_LAYERS)
    params = init_params(ds, torch.Generator(device=dev).manual_seed(0))
    a = SERVE_DEEPSEEK
    print(f"serve path (9a) deepseek-v2-236b: {DEEPSEEK_LAYERS} of 60 "
          f"layers, {param_count(params):,} parameters, MLA head dims "
          f"({ds.qk_nope_dim + ds.qk_rope_dim}, {ds.v_head_dim}), kv_lora "
          f"{ds.kv_lora_rank}, {ds.moe.n_experts} experts top "
          f"{ds.moe.top_k} and {ds.moe.n_shared} shared of d_expert "
          f"{ds.moe.d_expert}")
    g = torch.Generator(device=dev).manual_seed(3)
    prompt = torch.randint(0, ds.vocab_size, (a["batch"], a["prompt_len"]),
                           generator=g, device=dev)
    n, st = serve_request(dev, "serve path (9a) deepseek-v2-236b bf16, "
                          "capacity factor 1.25", ds, params, prompt,
                          a["gen"], (), ("flash_attention", "rmsnorm"))
    add(n)
    del params
    torch.cuda.empty_cache()
    f = SERVE_DEEPSEEK_F32
    lifted = ds.replace(dtype="float32", moe=dataclasses.replace(
        ds.moe, capacity_factor=ds.moe.n_experts / ds.moe.top_k))
    params = init_params(lifted, torch.Generator(device=dev).manual_seed(0))
    n, _ = serve_request(dev, "serve path (9a) deepseek-v2-236b f32, "
                         "capacity factor 160/6", lifted, params,
                         prompt[:, :f["prompt_len"]], f["gen"], f["steps"],
                         ("flash_attention", "rmsnorm"),
                         decode_tol=F32_DECODE_TOL, profile=False)
    add(n)
    del params
    torch.cuda.empty_cache()
    print(f"serve path (9a): {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    add(moe_round(dev, f"MoE round path (9b) deepseek-v2-236b "
                  f"({DEEPSEEK_LAYERS} of 60 layers)", DEEPSEEK_ARGV, ds))
    print(f"MoE round path (9b): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    add(mla_fo_round(dev, ds))
    print(f"FedAvg path (9c): {time.perf_counter() - t0:.1f} s")
    print(f"MLA path: deepseek-v2-236b prefill {st['prefill_ms']:.1f} ms, "
          f"decode {st['decode_ms']:.2f} ms a step, {st['tok_s']:.1f} "
          f"tokens/s, peak {st['peak']:.2f} GiB; path 9 "
          f"{time.perf_counter() - t_path:.1f} s in all")
    return launches


# path 10: the Mamba hybrid jamba-1.5-large-398b at its full published
# width (d_model 8192, d_inner 16384, d_state 16, d_conv 4, dt_rank 512, 64
# query and 8 kv heads of 128, d_ff 24576, vocab 65536, top-2 routing) on
# one unit: JAMBA_LAYERS of its 72 layers (the pattern's length, the
# least the config takes), with its 16 experts cut. One unit without its
# MoE layers is 6.58 B parameters and each expert kept adds 2.42 B: all 16
# (45.2 B, 84 GiB in bf16) would not fit even serving. (a) serving at
# JAMBA_SERVE_EXPERTS (25.9 B, 48.3 GiB): one 4096-token prompt, 16
# greedy tokens; then the decode-vs-full check in f32 at
# JAMBA_ROUND_EXPERTS and capacity factor n_experts / top_k = 1.0, where
# every token reaches both experts and none drops (11.4 B, 42.5 GiB): a
# 512-token prompt and 8 tokens; (b) one MU-SplitFed round at
# JAMBA_ROUND_EXPERTS, reckoned at MOE_ROUND_BYTES_PER_PARAM_BYTE x its
# parameter bytes (62.8 GiB; 3 experts would need about 75 of the card's
# 79.2)
JAMBA_LAYERS = 8
JAMBA_SERVE_EXPERTS = 8
JAMBA_ROUND_EXPERTS = 2
SERVE_JAMBA = dict(batch=1, prompt_len=4096, gen=16)
SERVE_JAMBA_F32 = dict(batch=1, prompt_len=512, gen=8, steps=(1, 4, 8))
JAMBA_ARGV = ["--arch", "jamba-1.5-large-398b", "--clients", "2", "--tau",
              "2", "--batch", "1", "--seq", "512", "--rounds", "1",
              "--chunk-size", "1", "--aggregation", "seed_replay"]
JAMBA_KERNELS = ("flash_attention", "rmsnorm", "selective_scan")
# path 10 (c): one FedLoRA round of (b)'s model through the driver (rank 4,
# alpha 16 on the attention block's wq and wv, one local SGD step). FedAvg
# holds at least 5x the parameter bytes (the global tree, a client copy,
# its gradients and an f32 running sum; path 9 (c) measured 5.40x), 106
# GiB at 2 experts, over the card's 79.2 GiB (84 GiB with every MoE
# position dense); FedLoRA holds the parameters, the activations and the
# adapters, 1.65x on path 5 (4.36 GiB for paper-opt-1.3b's 2.634)
JAMBA_FO_ARGV = ["--arch", "jamba-1.5-large-398b", "--clients", "2",
                 "--batch", "1", "--seq", "512", "--rounds", "1",
                 "--chunk-size", "1", "--algorithm", "fedlora"]
FEDLORA_ROUND_BYTES_PER_PARAM_BYTE = 1.65
FEDAVG_MIN_BYTES_PER_PARAM_BYTE = 5.0


def jamba_fo_round(dev, rcfg) -> dict:
    """Path 10 (c): one FedLoRA round of ``rcfg`` through the driver
    (``JAMBA_FO_ARGV``) with ``drive``: the flash backward once a client
    (the attention block b3 holds the adapters), the selective scan's
    backward once for each Mamba block behind it (b4-b7: 4 a client), the
    rmsnorm backward; the loss finite, the base frozen and the adapters
    moved; its peak reckoned first (FEDLORA_ROUND_BYTES_PER_PARAM_BYTE x
    the parameter bytes) and printed with the round's seconds. Returns the
    launches."""
    from repro_torch.core import engine
    from repro_torch.launch import train
    from repro_torch.models import param_count
    from repro_torch.utils import tree
    name = (f"FedLoRA path (10c) jamba-1.5-large-398b ({JAMBA_LAYERS} of 72 "
            f"layers, {JAMBA_ROUND_EXPERTS} of 16 experts)")
    torch.cuda.empty_cache()
    run = train.setup(JAMBA_FO_ARGV, cfg=rcfg)
    gib = param_count(run.params) * 2 / 2 ** 30
    card = torch.cuda.get_device_properties(dev).total_memory / 2 ** 30
    behind = [j for j, b in enumerate(rcfg.block_pattern)
              if b == "mamba" and j > rcfg.block_pattern.index("attn")]
    print(f"{name}: reckoned peak {FEDLORA_ROUND_BYTES_PER_PARAM_BYTE} x "
          f"{gib:.2f} GiB of parameters = "
          f"{FEDLORA_ROUND_BYTES_PER_PARAM_BYTE * gib:.1f} GiB of the card's "
          f"{card:.1f}; FedAvg would hold at least "
          f"{FEDAVG_MIN_BYTES_PER_PARAM_BYTE} x {gib:.2f} = "
          f"{FEDAVG_MIN_BYTES_PER_PARAM_BYTE * gib:.1f} GiB; Mamba blocks "
          f"behind the adapters {behind}")
    res, _, n, chunks = drive(dev, name, run, run.sfl, (
        "flash_attention", "flash_attention_bwd", "rmsnorm", "rmsnorm_bwd",
        "selective_scan", "selective_scan_bwd"), frozen=True)
    M = run.sfl.n_clients
    print(f"{name}: backward launches: selective_scan_bwd "
          f"{n.get('selective_scan_bwd')}, flash_attention_bwd "
          f"{n.get('flash_attention_bwd')}, rmsnorm_bwd "
          f"{n.get('rmsnorm_bwd')}")
    require(n.get("selective_scan_bwd") == M * len(behind)
            and n.get("flash_attention_bwd") == M,
            f"{name}: launches {n}, not {M * len(behind)} selective-scan "
            f"backwards and {M} flash backwards")
    init = engine.get_algorithm("fedlora").init_state(rcfg, run.sfl,
                                                       run.params, None)
    moved = max(max_err(a, b) for a, b in zip(tree.leaves(res.state),
                                              tree.leaves(init)))
    peak = max(c[2] for c in chunks)
    print(f"{name}: adapters max |Δ| from their init {moved:.3e}; a round "
          f"{chunks[0][1]:.3f} s, peak {peak:.2f} GiB against the reckoning "
          f"{FEDLORA_ROUND_BYTES_PER_PARAM_BYTE * gib:.1f} GiB; measured "
          f"ratio {peak / gib:.3f}")
    require(moved > 0, f"{name}: the adapters did not move")
    require(peak < card, f"{name}: peak {peak:.2f} GiB over the card")
    del run, res, init
    torch.cuda.empty_cache()
    return n


def phase_jamba(dev) -> dict:
    """Path 10: jamba-1.5-large-398b on the card's own ``logits_fn`` as
    the reference:
      a. ``serve.generate`` in bf16 with JAMBA_SERVE_EXPERTS of 16 experts
         at the config's capacity factor: one 4096-token prompt (each Mamba
         layer's prefill one selective-scan launch over the 4096 tokens,
         the attention layer through the flash kernel at (128, 128)), 16
         new tokens (the scan at S = 1 on the in-place state), prefill's
         logits within PREFILL_TOL; then in f32 with JAMBA_ROUND_EXPERTS at
         capacity factor 1.0 a 512-token prompt and 8 tokens, decode steps
         1, 4 and 8 within F32_DECODE_TOL of logits_fn on prompt and
         tokens;
      b. one MU-SplitFed round of the JAMBA_ROUND_EXPERTS model through the
         driver (``JAMBA_ARGV``: counter noise, seed replay, M=2, tau=2,
         batch 1, seq 512, the config's cut after the one unit, so the
         server holds final_norm and the head only), ``moe_round``: the
         noise kernels, flash, rmsnorm and selective_scan must launch;
      c. one FedLoRA round of (b)'s model through the driver
         (``jamba_fo_round``): the selective scan's backward 4 times a
         client, the flash and rmsnorm backwards.
    Prints what it cut, each part's seconds and the parameter counts and
    reckoned peak; returns the launches summed over a-c."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, param_count, split_dims
    from repro_torch.models.ssm import mamba_dims
    t_path = time.perf_counter()
    launches = {}

    def add(n):
        for k, v in n.items():
            launches[k] = launches.get(k, 0) + v

    def experts(cfg, n, **kw):
        return cfg.replace(moe=dataclasses.replace(cfg.moe, n_experts=n,
                                                   **kw))

    full = get_config("jamba-1.5-large-398b")
    base = full.replace(n_layers=JAMBA_LAYERS)
    d_in, N, d_conv, dt_rank, _ = mamba_dims(base)
    print(f"jamba path (10): {JAMBA_LAYERS} of {full.n_layers} layers (one "
          f"unit of {base.block_pattern}), MoE at pattern positions "
          f"{[j for j in range(JAMBA_LAYERS) if base.layer_uses_moe(j)]}, "
          f"experts cut from {full.moe.n_experts} to {JAMBA_SERVE_EXPERTS} "
          f"(serving, bf16) and {JAMBA_ROUND_EXPERTS} (the f32 check and the "
          f"round), top {full.moe.top_k}; width as published: d_model "
          f"{base.d_model}, d_inner {d_in}, d_state {N}, d_conv {d_conv}, "
          f"dt_rank {dt_rank}, {base.n_heads} query and {base.n_kv_heads} "
          f"kv heads of {base.d_head}, d_ff {base.d_ff}, vocab "
          f"{base.vocab_size}")
    t0 = time.perf_counter()
    cfg = experts(base, JAMBA_SERVE_EXPERTS)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    print(f"serve path (10a) jamba-1.5-large-398b: {param_count(params):,} "
          f"parameters ({param_count(params) * 2 / 2 ** 30:.2f} GiB bf16)")
    a = SERVE_JAMBA
    g = torch.Generator(device=dev).manual_seed(4)
    prompt = torch.randint(0, cfg.vocab_size, (a["batch"], a["prompt_len"]),
                           generator=g, device=dev)
    n, st = serve_request(dev, f"serve path (10a) jamba-1.5-large-398b bf16, "
                          f"{JAMBA_SERVE_EXPERTS} of 16 experts, capacity "
                          f"factor {cfg.moe.capacity_factor}", cfg, params,
                          prompt, a["gen"], (), JAMBA_KERNELS)
    add(n)
    del params
    torch.cuda.empty_cache()
    f = SERVE_JAMBA_F32
    lifted = experts(base, JAMBA_ROUND_EXPERTS,
                     capacity_factor=JAMBA_ROUND_EXPERTS / base.moe.top_k
                     ).replace(dtype="float32")
    params = init_params(lifted, torch.Generator(device=dev).manual_seed(0))
    print(f"serve path (10a) f32 check: {param_count(params):,} parameters "
          f"({param_count(params) * 4 / 2 ** 30:.2f} GiB f32)")
    n, _ = serve_request(dev, f"serve path (10a) jamba-1.5-large-398b f32, "
                         f"{JAMBA_ROUND_EXPERTS} of 16 experts, capacity "
                         f"factor 1.0", lifted, params,
                         prompt[:, :f["prompt_len"]], f["gen"], f["steps"],
                         JAMBA_KERNELS, decode_tol=F32_DECODE_TOL,
                         profile=False)
    add(n)
    del params
    torch.cuda.empty_cache()
    print(f"serve path (10a): {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    rcfg = experts(base, JAMBA_ROUND_EXPERTS)
    d_c, d_s = split_dims(rcfg, rcfg.default_cut_units)
    n_params = d_c + d_s
    per_unit = d_c - rcfg.vocab_size * rcfg.d_model
    gib = n_params * 2 / 2 ** 30
    card = torch.cuda.get_device_properties(dev).total_memory / 2 ** 30
    print(f"MoE round path (10b): {n_params:,} parameters ({gib:.2f} GiB "
          f"bf16), reckoned peak {MOE_ROUND_BYTES_PER_PARAM_BYTE} x "
          f"{gib:.2f} = {MOE_ROUND_BYTES_PER_PARAM_BYTE * gib:.1f} GiB of the "
          f"card's {card:.1f}; cut {rcfg.default_cut_units}: the client holds "
          f"the embedding and the unit, the server final_norm and the head "
          f"only (a second unit would add {per_unit / 1e9:.1f} B "
          f"parameters)")
    add(moe_round(dev, f"MoE round path (10b) jamba-1.5-large-398b "
                  f"({JAMBA_LAYERS} of 72 layers, {JAMBA_ROUND_EXPERTS} of 16 "
                  f"experts)", JAMBA_ARGV, rcfg,
                  kernels=MOE_ROUND_KERNELS + ("selective_scan",)))
    print(f"MoE round path (10b): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    add(jamba_fo_round(dev, rcfg))
    print(f"FedLoRA path (10c): {time.perf_counter() - t0:.1f} s")
    print(f"jamba path: prefill {st['prefill_ms']:.1f} ms (4096 tokens), "
          f"decode {st['decode_ms']:.2f} ms a step, {st['tok_s']:.1f} "
          f"tokens/s, peak {st['peak']:.2f} GiB; path 10 "
          f"{time.perf_counter() - t_path:.1f} s in all")
    return launches


# path 11: xLSTM, xlstm-350m at its full published config (24 layers,
# d_model 1024, mlstm x3 then slstm, no FFN, vocab 50304: 499.7 M
# parameters with the untied head, 0.93 GiB in bf16), random weights from
# seed 0. (a) serving in bf16: 4 requests of 512-token prompts and 32 new
# tokens, then one 4096-token prompt and 16; then the f32 decode-vs-full
# check, a 512-token prompt and 8 tokens; (b) path 1's MU-SplitFed run
# through the driver (M=2, tau=2, P=1, batch 1, seq 512, counter noise,
# seed replay, 3 rounds, one a chunk, cut after the first unit) and one
# profiled round. Nothing is cut.
XLSTM_ARGV = ["--arch", "xlstm-350m", *PATH_ARGV]
SERVE_XLSTM = (dict(batch=4, prompt_len=512, gen=32),
               dict(batch=1, prompt_len=4096, gen=16))
SERVE_XLSTM_F32 = dict(batch=1, prompt_len=512, gen=8, steps=(1, 4, 8))
XLSTM_KERNELS = ("zo_update", "zo_replay", "rmsnorm", "slstm")
# the f32 decode-vs-full check of path 11 holds each decode step within
# F32_DECODE_TOL or XLSTM_DECODE_MARGIN times the model's own rounding
# spread, whichever is larger: the spread is max|logits_fn at chunk 64 -
# logits_fn at chunk 32| over the prompt, of max|logit|, two algebraically
# equal forms of the same forward (the mLSTM's chunkwise form), as decode
# (the recurrent form) and logits_fn are. At the published width and 24
# layers rounding grows through the layers: PR 32's call 3 measured a
# decode step 2.8e-4 of max|logit| off logits_fn. At 4 layers on the CPU
# the reference's own decode steps are 1.5-2.1e-6 off its logits_fn, the
# port's 1.7-2.8e-6, and the port's chunk 32 against chunk 64 6.0e-6
XLSTM_DECODE_MARGIN = 4.0
# path 11 (c) and (d): one FedAvg round (one local SGD step) and one
# FedLoRA round (rank 4, alpha 16 on the mLSTM blocks' wq and wv) through
# the driver at the full published config, M=2, batch 1, seq 512, at
# lr_client 1e-2 (the small rounds' SGD rate: at the driver's 5e-4 a bf16
# weight's step falls below its half ulp for most elements). Every sLSTM
# block lies behind b0's adapters, so both run the sLSTM backward 6 times
# a client. FedAvg holds at least FEDAVG_MIN_BYTES_PER_PARAM_BYTE x the
# parameter bytes (the global tree, a client copy, its gradients and an
# f32 running sum; path 9 (c) measured 5.40x), FedLoRA about 1.1-1.65x
# (path 10 (c) 1.098x, path 5 1.65x)
XLSTM_FO_ARGV = ["--arch", "xlstm-350m", "--clients", "2", "--batch", "1",
                 "--seq", "512", "--rounds", "1", "--chunk-size", "1",
                 "--lr-client", "1e-2"]


def xlstm_request_launches(cfg, gen: int) -> dict:
    """Launches a ``serve.generate`` request makes: the prefill and each of
    its ``gen`` decode steps (the last one's logits unused) run every
    block once: an rmsnorm a block and the final norm, an sLSTM launch a
    sLSTM block."""
    norms = cfg.n_layers + 1
    slstms = cfg.n_units * cfg.block_pattern.count("slstm")
    return {"rmsnorm": norms * (1 + gen), "slstm": slstms * (1 + gen)}


def zo_round_launches(cfg, sfl, params) -> dict:
    """Launches a MU-SplitFed round with seed replay and counter noise
    makes (``core/splitfed.py``), from its structure, M clients each: 3
    client forwards (h, h+, h-) and 2·tau·P + 3 server forwards (the
    round-start loss, tau SPSA steps of P ± pairs, and the client delta's
    two); zo_update perturbs the client's L_c leaves twice and the
    server's L_s leaves 2·tau·P times; zo_replay applies each SPSA step
    once over the server's leaves, then the aggregation once over each
    side's leaves. A forward runs an rmsnorm a block (the server's also
    the final norm) and an sLSTM launch a sLSTM block."""
    from repro_torch.models import split_params
    from repro_torch.utils import tree
    M, tau, P, cut = (sfl.n_clients, sfl.tau, sfl.n_perturbations,
                      sfl.cut_units)
    xc, xs = split_params(cfg, params, cut)
    L_c, L_s = len(tree.leaves(xc)), len(tree.leaves(xs))
    per_unit = len(cfg.block_pattern)
    slstm = cfg.block_pattern.count("slstm")
    client_fwd, server_fwd = 3, 2 * tau * P + 3
    server_units = cfg.n_units - cut
    return {"zo_update": M * (2 * L_c + 2 * tau * P * L_s),
            "zo_replay": M * tau * L_s + L_s + L_c,
            "rmsnorm": M * (client_fwd * cut * per_unit
                            + server_fwd * (server_units * per_unit + 1)),
            "slstm": M * slstm * (client_fwd * cut
                                  + server_fwd * server_units)}


def xlstm_fo_round(dev, algorithm: str) -> dict:
    """Path 11 (c) FedAvg or (d) FedLoRA: one round of xlstm-350m at its
    full published config through the driver (``XLSTM_FO_ARGV``) with
    ``drive``: the peak reckoned first and measured after, with the
    round's seconds; slstm_bwd launched M x (the sLSTM blocks) times, the
    rmsnorm backward too; the loss finite; FedAvg moves every leaf (each
    compared whole with a host copy taken before), FedLoRA every LoRA B
    (A's gradient is B's product, 0 at the reference's init B = 0, so each
    A stays as it was) and leaves the base untouched; then, from the
    allocator's trace of one more round (``peak_sites``), what is live at
    its peak by the port's line that allocated it. Returns the
    launches."""
    from repro_torch.core import engine
    from repro_torch.core.baselines import fedavg_round, fedlora_round
    from repro_torch.launch import train
    from repro_torch.models import param_count
    from repro_torch.utils import tree
    letter = "c" if algorithm == "fedavg" else "d"
    name = f"{'FedAvg' if algorithm == 'fedavg' else 'FedLoRA'} path (11{letter}) xlstm-350m"
    torch.cuda.empty_cache()
    run = train.setup([*XLSTM_FO_ARGV, "--algorithm", algorithm])
    gib = param_count(run.params) * 2 / 2 ** 30
    nbytes = sum(a.numel() * a.element_size()
                 for a in tree.leaves(run.params)) / 2 ** 30
    card = torch.cuda.get_device_properties(dev).total_memory / 2 ** 30
    ratio = (FEDAVG_MIN_BYTES_PER_PARAM_BYTE if algorithm == "fedavg"
             else FEDLORA_ROUND_BYTES_PER_PARAM_BYTE)
    M = run.sfl.n_clients
    blocks = run.cfg.n_units * run.cfg.block_pattern.count("slstm")
    print(f"{name}: reckoned peak {'at least ' if algorithm == 'fedavg' else ''}"
          f"{ratio} x {gib:.2f} GiB of parameters = {ratio * gib:.2f} GiB of "
          f"the card's {card:.1f} ({nbytes:.2f} GiB as allocated, the f32 "
          f"leaves at 4 bytes); sLSTM backwards derived: {M} clients x "
          f"{blocks} sLSTM blocks = {M * blocks}")
    host = [a.cpu() for a in tree.leaves(run.params)]
    init = (engine.get_algorithm("fedlora").init_state(run.cfg, run.sfl,
                                                       run.params, None)
            if algorithm == "fedlora" else None)
    init_host = None if init is None else [
        (path, a.cpu()) for path, a in tree.path_leaves(init)]
    res, _, n, chunks = drive(dev, name, run, run.sfl, (
        "rmsnorm", "rmsnorm_bwd", "slstm", "slstm_bwd"),
        frozen=algorithm == "fedlora")
    print(f"{name}: launches slstm {n.get('slstm')}, slstm_bwd "
          f"{n.get('slstm_bwd')}, rmsnorm {n.get('rmsnorm')}, rmsnorm_bwd "
          f"{n.get('rmsnorm_bwd')}")
    require(n.get("slstm_bwd") == M * blocks,
            f"{name}: {n.get('slstm_bwd')} sLSTM backwards, not the derived "
            f"{M * blocks}")
    leaves = [a.cpu() for a in tree.leaves(res.params)]
    moved = [not torch.equal(a, b) for a, b in zip(leaves, host)]
    if algorithm == "fedavg":
        require(all(moved), f"{name}: {moved.count(False)} of {len(moved)} "
                f"leaves did not move")
        print(f"{name}: all {len(moved)} leaves moved")
    else:
        require(not any(moved), f"{name}: the base moved")
        lora = dict((path, a.cpu()) for path, a in tree.path_leaves(res.state))
        for path, a0 in init_host:
            same = torch.equal(lora[path], a0)
            require(same == path.endswith("/A"),
                    f"{name}: adapter {path} {'did not move' if same else 'moved'}")
        print(f"{name}: the base untouched; all {len(init_host) // 2} LoRA B "
              f"moved, each A as initialised")
    peak = max(c[2] for c in chunks)
    print(f"{name}: a round {chunks[0][1]:.3f} s, peak {peak:.2f} GiB against "
          f"the reckoning {ratio * gib:.2f} GiB; measured ratio "
          f"{peak / gib:.3f} of the {gib:.2f} GiB of parameters")
    require(peak < card, f"{name}: peak {peak:.2f} GiB over the card")
    state = engine.get_algorithm(algorithm).init_state(run.cfg, run.sfl,
                                                       res.params, None)
    g = torch.Generator(device=dev).manual_seed(run.args.seed)
    toks = torch.randint(run.cfg.vocab_size,
                         (M, run.args.batch, run.args.seq + 1), generator=g,
                         device=dev)
    batches = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    mask = torch.ones(M, device=dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.memory._record_memory_history(enabled="all", context="all",
                                             stacks="python")
    try:
        if algorithm == "fedavg":
            out = fedavg_round(run.cfg, res.params, batches, mask,
                               run.args.lr_client, eta_g=run.sfl.lr_global)
        else:
            out = fedlora_round(run.cfg, res.params, state, batches, mask,
                                run.args.lr_client, eta_g=run.sfl.lr_global)
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    del out
    top, sites = peak_sites(snap["device_traces"][0])
    print(f"{name}: one more round's peak {top / 2 ** 30:.3f} GiB above the "
          f"{base / 2 ** 30:.3f} GiB before it; live at the peak:")
    for b, site in sites:
        print(f"  {b / 2 ** 30:8.3f} GiB  {site}")
    del run, res, init, host, leaves, state, snap
    torch.cuda.empty_cache()
    return n


def phase_xlstm(dev) -> dict:
    """Path 11: xlstm-350m at its full published config, on the card's own
    ``logits_fn`` as the reference:
      a. ``serve.generate`` in bf16 (``serve_request``): 4 requests of
         512-token prompts and 32 new tokens, then one 4096-token prompt and
         16 tokens (each sLSTM layer's prefill one launch over the prompt,
         each decode step one at S = 1 on the in-place state; the mLSTM's
         chunks of 64 in PyTorch), prefill's logits within PREFILL_TOL; then
         in f32 a 512-token prompt and 8 tokens, decode steps 1, 4 and 8
         within F32_DECODE_TOL, or XLSTM_DECODE_MARGIN times the forward's
         measured rounding spread, of logits_fn on prompt and tokens; each
         request's rmsnorm and slstm launches equal to
         ``xlstm_request_launches``;
      b. path 1's MU-SplitFed run through the driver (``XLSTM_ARGV``,
         counter noise set after setup) with ``drive``: 3 rounds, one a
         chunk, then one profiled round; zo_update, zo_replay, rmsnorm and
         slstm launches equal to 3 x ``zo_round_launches``; peak memory
         beside the parameter bytes;
      c. one FedAvg round through the driver (``xlstm_fo_round``);
      d. one FedLoRA round the same way.
    Prints each part's seconds; returns the launches summed over a-d."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import init_params, logits_fn, param_count
    from repro_torch.models.ssm import mlstm_dims, slstm_dims
    t_path = time.perf_counter()
    launches = {}

    def add(n):
        for k, v in n.items():
            launches[k] = launches.get(k, 0) + v

    cfg = get_config("xlstm-350m")
    d_up, H, dh, chunk = mlstm_dims(cfg)
    sh, sdh = slstm_dims(cfg)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    n_params = param_count(params)
    gib = n_params * 2 / 2 ** 30
    print(f"xlstm path (11): xlstm-350m at its full published config, "
          f"{cfg.n_layers} layers ({cfg.block_pattern} x {cfg.n_units}), "
          f"d_model {cfg.d_model}, mLSTM d_up {d_up} in {H} heads of {dh} "
          f"(chunk {chunk}), sLSTM {sh} heads of {sdh}, no FFN, vocab "
          f"{cfg.vocab_size}; {n_params:,} parameters (untied head), "
          f"{gib:.2f} GiB in bf16 (their f32 leaves counted at 2 bytes); "
          f"nothing cut")
    g = torch.Generator(device=dev).manual_seed(4)
    stats = []
    for i, a in enumerate(SERVE_XLSTM):
        prompt = torch.randint(0, cfg.vocab_size,
                               (a["batch"], a["prompt_len"]), generator=g,
                               device=dev)
        name = (f"serve path (11a) xlstm-350m bf16, {a['batch']} x "
                f"{a['prompt_len']}-token prompt(s), {a['gen']} tokens")
        n, st = serve_request(dev, name, cfg, params, prompt, a["gen"], (),
                              ("rmsnorm", "slstm"), profile=i == 0)
        want = xlstm_request_launches(cfg, a["gen"])
        got = {k: n.get(k, 0) for k in want}
        print(f"{name}: launches {got}, derived {want}")
        require(got == want, f"{name}: launches {got}, not {want}")
        add(n)
        stats.append(st)
    del params
    torch.cuda.empty_cache()
    f32 = cfg.replace(dtype="float32")
    params = init_params(f32, torch.Generator(device=dev).manual_seed(0))
    f = SERVE_XLSTM_F32
    prompt = torch.randint(0, cfg.vocab_size, (f["batch"], f["prompt_len"]),
                           generator=g, device=dev)
    with torch.inference_mode():
        full = logits_fn(f32, params, {"tokens": prompt})
        halves = logits_fn(f32.replace(xlstm=dataclasses.replace(
            f32.xlstm, chunk=f32.xlstm.chunk // 2)), params,
            {"tokens": prompt})
        spread = float((full - halves).abs().max() / full.abs().max())
    tol = max(F32_DECODE_TOL, XLSTM_DECODE_MARGIN * spread)
    print(f"serve path (11a) xlstm-350m f32: the forward's rounding spread "
          f"(logits_fn at chunk {f32.xlstm.chunk} against "
          f"{f32.xlstm.chunk // 2}, over the {f['prompt_len']}-token prompt) "
          f"{spread:.3e} of max|logit|; decode tolerance {tol:.3e}")
    del full, halves
    n, _ = serve_request(dev, "serve path (11a) xlstm-350m f32", f32, params,
                         prompt, f["gen"], f["steps"], ("rmsnorm", "slstm"),
                         decode_tol=tol, profile=False)
    require(n.get("slstm") == xlstm_request_launches(f32, f["gen"])["slstm"],
            f"serve path (11a) f32: slstm launches {n.get('slstm')}")
    add(n)
    del params
    torch.cuda.empty_cache()
    print(f"serve path (11a): {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    run = train.setup(XLSTM_ARGV)
    sfl = dataclasses.replace(run.sfl, perturbation_dist="counter")
    name = "xlstm path (11b) xlstm-350m MU-SplitFed"
    per_round = zo_round_launches(run.cfg, sfl, run.params)
    res, _, n, chunks = drive(dev, name, run, sfl, XLSTM_KERNELS)
    rounds = len(res.round_loss)
    want = {k: v * rounds for k, v in per_round.items()}
    got = {k: n.get(k, 0) for k in want}
    print(f"{name}: launches over {rounds} rounds {got}, derived from the "
          f"round's structure {want} ({per_round} a round)")
    require(got == want, f"{name}: launches {got}, not {want}")
    add(n)
    peak = max(c[2] for c in chunks)
    secs = [round(c[1], 3) for c in chunks]
    print(f"{name}: round seconds {secs}; peak {peak:.2f} GiB against "
          f"{gib:.2f} GiB of parameters (ratio {peak / gib:.3f})")
    del run, res
    torch.cuda.empty_cache()
    print(f"xlstm round path (11b): {time.perf_counter() - t0:.1f} s")
    for algorithm, part in (("fedavg", "11c"), ("fedlora", "11d")):
        t0 = time.perf_counter()
        add(xlstm_fo_round(dev, algorithm))
        print(f"xlstm {algorithm} path ({part}): "
              f"{time.perf_counter() - t0:.1f} s")
    a, b = stats
    print(f"xlstm path: 4 x 512 prefill {a['prefill_ms']:.1f} ms, decode "
          f"{a['decode_ms']:.2f} ms a step, {a['tok_s']:.1f} tokens/s, peak "
          f"{a['peak']:.2f} GiB; 1 x 4096 prefill {b['prefill_ms']:.1f} ms, "
          f"decode {b['decode_ms']:.2f} ms a step, {b['tok_s']:.1f} "
          f"tokens/s, peak {b['peak']:.2f} GiB; round seconds {secs}; path "
          f"11 {time.perf_counter() - t_path:.1f} s in all")
    return launches


def phase_small_serve(dev):
    """Serving on the card against the CPU in f32 (the plain versions
    there): mixtral-8x22b SMOKE past its window, qwen3-14b SMOKE (qk-norm),
    deepseek-v2-236b SMOKE (MLA, the compressed-cache decode),
    jamba-1.5-large-398b SMOKE (the Mamba state's in-place decode) and
    xlstm-350m SMOKE (the mLSTM's chunks of 16 and its tail over a 40-token
    prompt, the sLSTM kernel at S = 40 and 1 on the in-place state), widened
    by ``configs.card_smoke_config`` (1 kv head for the GQA models), at
    SMOKE's capacity factor: tokens equal, and
    the prefill and every decode step's logits within 1e-4 of
    max(|logits|, 1)."""
    import numpy as np
    from repro_torch.configs import card_smoke_config
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.utils import tree
    for arch, S, gen in (("mixtral-8x22b", 40, 8), ("qwen3-14b", 24, 8),
                         ("deepseek-v2-236b", 24, 8),
                         ("jamba-1.5-large-398b", 24, 8),
                         ("xlstm-350m", 40, 8)):
        cfg = card_smoke_config(arch, 1)
        params = init_params(cfg, torch.Generator().manual_seed(0))
        toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, S))
        outs = {}
        for d in ("cpu", dev):
            p = tree.tree_map(lambda a: a.to(d), params)
            with torch.inference_mode():
                lg, cache = prefill(cfg, p, {"tokens": torch.from_numpy(
                    toks).to(d)}, cache_len=S + gen)
                logits, out = [lg[:, 0].cpu()], []
                for i in range(gen):
                    tok = lg[:, -1].argmax(-1, keepdim=True)
                    out.append(tok.cpu())
                    lg, cache = decode_step(cfg, p, tok, cache, S + i)
                    logits.append(lg[:, 0].cpu())
            outs[str(d)] = torch.cat(out, 1), torch.stack(logits)
        (tc, lc), (tg, lg_) = outs["cpu"], outs[str(dev)]
        err = max_err(lg_, lc)
        scale = max(float(lc.abs().max()), 1.0)
        dv = cfg.v_head_dim if cfg.attn_impl == "mla" else cfg.d_head
        print(f"small f32 serving ({arch} SMOKE, head dims ({cfg.d_head}, "
              f"{dv}), prompt {S}, {gen} tokens), card vs CPU: tokens equal "
              f"{torch.equal(tc, tg)}, logits max|Δ| {err:.3e} of "
              f"{scale:.3e}")
        require(torch.equal(tc, tg) and err <= 1e-4 * scale,
                f"small serving ({arch}): card and CPU disagree")


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
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_card()
    zo_sass, tf_sass = phase_build()
    zo = phase_zo(dev, zo_sass)
    flash = phase_flash(dev)
    flash_mla = phase_flash_mla(dev)
    norm = phase_rmsnorm(dev)
    tf = phase_threefry(dev, tf_sass)
    flash_bwd = phase_flash_bwd(dev)
    norm_bwd = phase_rmsnorm_bwd(dev)
    scan = phase_selective_scan(dev)
    scan_bwd = phase_selective_scan_bwd(dev)
    slstm_res = phase_slstm(dev)
    slstm_bwd_res = phase_slstm_bwd(dev, slstm_res.pop("us_per_token_by_case"))
    t_small = time.perf_counter()
    phase_small_round(dev)
    phase_small_fo(dev)
    phase_small_serve(dev)
    print(f"small card-vs-CPU cases: {time.perf_counter() - t_small:.1f} s")
    from repro_torch.configs import get_config
    qwen = get_config("qwen3-14b").replace(n_layers=QWEN_LAYERS)
    paths = [
        ("path 1", lambda: phase_path(
            dev, "olmo-1b path", OLMO_ARGV, None,
            ("zo_update", "zo_replay", "flash_attention"))),
        ("path 2", lambda: phase_path(
            dev, f"qwen3-14b path ({QWEN_LAYERS} of 40 layers)", QWEN_ARGV,
            qwen, ("zo_update", "zo_replay", "flash_attention", "rmsnorm"))),
        ("path 3", lambda: phase_driver(dev)),
        ("path 4", lambda: phase_paper(dev)),
        ("path 5", lambda: [phase_fo_paper(dev, zo_summary),
                            phase_qwen_fo(dev)]),
        ("path 6", lambda: phase_resume(dev)),
        ("path 7", lambda: phase_async(dev)),
        ("path 8", lambda: phase_serve(dev)),
        ("path 9", lambda: phase_mla(dev)),
        ("path 10", lambda: phase_jamba(dev)),
        ("path 11", lambda: phase_xlstm(dev))]
    launches, seconds, zo_summary = {}, {}, None
    for label, fn in paths:
        t0 = time.perf_counter()
        counts = fn()
        if label == "path 4":           # (launches, the ZO runs' summary)
            counts, zo_summary = counts
        for n in counts if isinstance(counts, list) else [counts]:
            for k, v in n.items():
                launches[k] = launches.get(k, 0) + v
        seconds[label] = round(time.perf_counter() - t0, 1)
        torch.cuda.empty_cache()
    print(f"seconds by path: {seconds}")
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
             "src/repro/models/layers.py:47", norm_bwd),
            # no Pallas kernel: the counterpart of the reference's jnp
            # chunked associative scan and its gate (XLA)
            ("selective_scan", src + "selective_scan.cu",
             "src/repro/models/ssm.py:70", scan),
            # no Pallas kernel: XLA's autodiff of that scan and gate
            ("selective_scan_bwd", src + "selective_scan_bwd.cu",
             "src/repro/models/ssm.py:70", scan_bwd),
            # no Pallas kernel: the reference's jnp _slstm_step under a
            # lax.scan over the tokens (XLA)
            ("slstm", src + "slstm.cu", "src/repro/models/ssm.py:319",
             slstm_res),
            # no Pallas kernel: XLA's autodiff of that scan
            ("slstm_bwd", src + "slstm_bwd.cu",
             "src/repro/models/ssm.py:319", slstm_bwd_res)]
    for name, *_ in rows:
        require(launches.get(name, 0) > 0,
                f"kernel {name} was launched on no path")
    # the flash row carries MLA's (192, 128) instance beside its other
    # shapes: its own numbers, and its launches counted by the wrapper
    mla_key = "flash_attention (192, 128)"
    require(launches.get(mla_key, 0) > 0,
            "the flash kernel's (192, 128) pair was launched on no path")
    flash["err"] = max(flash["err"], flash_mla["err"])
    flash["mla"] = {"launches": launches[mla_key],
                    "max_abs_err": flash_mla.pop("err"), **flash_mla}
    # and the backward's row its (192, 128) instance's, launched on path 9
    # (c) under autograd
    mla_bwd = "flash_attention_bwd (192, 128)"
    require(launches.get(mla_bwd, 0) > 0,
            "the flash backward's (192, 128) pair was launched on no path")
    flash_bwd["mla"] = {"launches": launches[mla_bwd],
                        "replaces": "src/repro/models/attention.py:262",
                        **flash_bwd["mla"]}
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": rep,
         "launches": launches.get(name, 0), "max_abs_err": r["err"],
         "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"],
         "shape": r["shape"],
         **{k: r[k] for k in ("mla", "pair", "tokens_4096", "decode",
                              "serve_prefill", "grouped_rows", "chain_ms",
                              "us_per_token", "forward_ms") if k in r}}
        for name, source, rep, r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
