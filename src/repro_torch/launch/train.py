"""Split federated training driver for the port (counterpart of
``repro.launch.train``).

The run is the reference driver's: ``straggler.make_schedule`` builds the
system model (per-client delays, participation and deadline masks,
simulated round times), ``engine.run_rounds`` drives the chosen algorithm
through it (``--algorithm``: MU-SplitFed, vanilla SplitFed, GAS, or the
first-order FedAvg and FedLoRA with the reference's defaults: one local
SGD step at ``--lr-client``, η_g the config's lr_global, LoRA rank 4 and
alpha 16 on wq and wv), round r under the key fold_in(PRNGKey(seed), r),
on the same seeded synthetic LM and Dirichlet partition, and with the
same noise: the config's
default, threefry 'gaussian' (the reference driver has no dist flag
either). ``--adaptive-tau`` re-plans τ at chunk boundaries, on the
simulated clock or (``--tau-source measured``) on the card's. Each round
prints its mask-weighted loss, its active clients, the wall seconds since
the start (at the chunk's end, where the metrics reach the host) and the
simulated clock. ``--telemetry`` attaches a TelemetrySink and prints its
summary and the metrics at the end; ``--log-jsonl`` writes round and
chunk rows; ``--trace-out`` writes the engine's spans (.json Chrome
trace, .jsonl one span a line). ``--ckpt-dir`` checkpoints the run every
``--ckpt-every`` rounds and at its end, and a run started on a directory
that holds a checkpoint resumes from the latest one that verifies: the
parameters, the algorithm's state (GAS's buffer, FedLoRA's adapters), the
controller's overrides and EMA, and the run log cut back to the resumed
round. ``--async`` runs the semi-async event engine (``core/events.py``,
``async_mu_splitfed`` with seed replay): a server version commits once
``--quorum`` contributions arrived, late ones fold in discounted by
``--staleness-discount``; ``--timeline sparse`` streams the timeline over
a ring store (``--k-max``, ``--ring-capacity``; ``--loader subset``
stages only the starting clients' rows); ``--faults`` injects crashes,
lost, duplicated and corrupt deliveries (``--quorum-timeout``,
``--max-retries``; ``--adaptive-quorum`` resizes the quorum from the
delivery rate), and its ``kill=R`` SIGKILLs the process after the chunk
that holds round R flushed, before that chunk's checkpoint lands, in any
mode; the next run on the same ``--ckpt-dir`` resumes from the checkpoint
before it, with the async run's per-version τ and quorum.

Runs on the card unless ``--device cpu`` is given:
    python -m repro_torch.launch.train --arch paper-opt-1.3b --clients 4 \\
        --batch 1 --seq 512 --rounds 4 --chunk-size 2 --participation 0.75 \\
        --straggler-scale 3.0 --t-server 0.25 --t-gen 2.0 --algorithm gas
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --rounds 4 --seq 16 --straggler-scale 2.0 --adaptive-tau \\
        --tau-source measured --telemetry --log-jsonl run.jsonl
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --rounds 3 --seq 16 --algorithm fedlora
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch deepseek-v2-236b --smoke --device cpu --rounds 2 --seq 16
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch deepseek-v2-236b --smoke --device cpu --rounds 2 --seq 16 \\
        --algorithm fedavg
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch jamba-1.5-large-398b --smoke --device cpu --rounds 2 --seq 16
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch xlstm-350m --smoke --device cpu --rounds 2 --seq 40
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --rounds 2 --seq 16 --ckpt-dir ckpt --ckpt-every 2   # then --rounds 4
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --rounds 4 --seq 16 --chunk-size 2 --straggler-scale 2.0 --async \\
        --quorum 2 --staleness-discount 0.5 --faults crash=0.2,loss=0.2 \\
        --quorum-timeout 1.0 --adaptive-quorum --telemetry

The reference's ``--fleet-shard`` (``launch/fleet.py``: the sparse ring
store sharded over a multi-device mesh) is not taken: the port runs on
one card. An MLA model (deepseek-v2-236b) trains with the zeroth-order
algorithms and with FedAvg (``--algorithm fedavg``: its gradient goes
through the flash backward at MLA's head dims (192, 128)); FedLoRA raises
NotImplementedError there, since its targets (wq, wv) are not in an MLA
attention (ROADMAP.md, queue 1, item 6). The Mamba hybrid
(jamba-1.5-large-398b) trains with the zeroth-order algorithms and with
FedAvg and FedLoRA (``--algorithm fedavg|fedlora``: its gradient goes
through the selective scan's backward kernel; FedLoRA's adapters are the
attention block's wq and wv). xLSTM (xlstm-350m) trains with the
zeroth-order algorithms and with FedAvg and FedLoRA (its gradient goes
through the sLSTM recurrence's backward kernel; FedLoRA's adapters are
the mLSTM blocks' wq and wv).
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import time
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.ckpt import Checkpointer, latest_good_step, read_meta
from repro_torch.configs import ModelConfig, SFLConfig, get_config
from repro_torch.core import engine, events, prng
from repro_torch.core import straggler as strag
from repro_torch.core.faults import parse_faults
from repro_torch.data import FederatedLoader, SyntheticLM, dirichlet_partition
from repro_torch.models import init_params, untie_params

N_SAMPLES = 4096


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Split federated training (PyTorch port of "
                    "repro.launch.train).")
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--algorithm", default="mu_splitfed",
                    choices=sorted(engine.ALGORITHMS))
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--tau", type=int, default=2)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2, help="per-client batch")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--cut", type=int, default=0, help="0 = arch default")
    ap.add_argument("--participation", type=float, default=1.0)
    ap.add_argument("--straggler-scale", type=float, default=0.0)
    ap.add_argument("--deadline", type=float, default=0.0)
    ap.add_argument("--population", default="",
                    help="heterogeneous fleet spec, e.g. "
                         "'tiered:4x1.0,12x0.2' (see "
                         "core/population.py:parse_population); overrides "
                         "--clients/--participation; --straggler-scale "
                         "becomes the shared jitter")
    ap.add_argument("--async", dest="run_async", action="store_true",
                    help="event-driven semi-async execution (core/events.py)"
                         ": commit a server version as soon as --quorum "
                         "contributions arrive; late arrivals fold into a "
                         "later commit, discounted by --staleness-discount "
                         "per missed commit. Implies "
                         "--algorithm async_mu_splitfed")
    ap.add_argument("--quorum", type=int, default=0,
                    help="semi-async commit quorum K (0 = wait for all "
                         "pending contributions, the synchronous barrier)")
    ap.add_argument("--staleness-discount", type=float, default=1.0,
                    help="weight base for stale contributions: a record "
                         "applied s commits after its fetch weighs "
                         "discount**s before per-commit normalization")
    ap.add_argument("--timeline", default="dense",
                    choices=["dense", "sparse"],
                    help="async timeline backend: 'dense' precompiles "
                         "(V, M) rows; 'sparse' streams (chunk, k_max) "
                         "commit batches over an arrival-slot ring store")
    ap.add_argument("--k-max", type=int, default=0,
                    help="sparse timeline: per-version commit-batch width "
                         "(0 = auto: 4x quorum, floor 16, capped at M)")
    ap.add_argument("--ring-capacity", type=int, default=0,
                    help="sparse timeline: in-flight record slots (0 = "
                         "auto: an 8-batch staleness window, capped at M)")
    ap.add_argument("--loader", default="fleet",
                    choices=["fleet", "subset"],
                    help="sparse data staging: 'fleet' gathers each "
                         "version's rows from a fleet-width (M, ...) batch; "
                         "'subset' materializes only the <= k_max clients "
                         "that start each version (bit-exact with the "
                         "gather); requires --timeline sparse")
    ap.add_argument("--faults", default="",
                    help="fault-injection plan (core/faults.py), e.g. "
                         "'crash=0.1,loss=0.05,dup=0.02,corrupt=0.01,"
                         "kill=40': crash-after-fetch, delivery-loss, "
                         "duplication and corruption rates per dispatch, "
                         "'key@cohort=rate' per-cohort overrides, "
                         "'backoff=s' the crash re-dispatch base, 'kill=R' "
                         "SIGKILLs the process after the chunk containing "
                         "round R (checkpoint-resume exercise). Event "
                         "rates require --async")
    ap.add_argument("--quorum-timeout", type=float, default=0.0,
                    help="graceful degradation: commit with however many "
                         "contributions arrived once the quorum has "
                         "waited this long (weights renormalized; 0 = "
                         "wait forever). Requires --async")
    ap.add_argument("--max-retries", type=int, default=3,
                    help="retransmissions per lost delivery before the "
                         "contribution is dropped")
    ap.add_argument("--adaptive-quorum", action="store_true",
                    help="shrink/grow the commit quorum K from the "
                         "observed delivery rate (engine.AdaptiveQuorum; "
                         "--quorum is K0, the cap). Requires --async and "
                         "a --quorum > 0")
    ap.add_argument("--adaptive-tau", action="store_true",
                    help="re-plan tau at chunk boundaries from the observed "
                         "straggler gap (engine.AdaptiveTau; --tau is the "
                         "starting point)")
    ap.add_argument("--tau-max", type=int, default=64,
                    help="cap for --adaptive-tau's planner")
    ap.add_argument("--tau-source", default="sim",
                    choices=["sim", "measured"],
                    help="clock --adaptive-tau observes the straggler gap "
                         "on: 'sim' reads the schedule's simulated rows; "
                         "'measured' reads the measured-clock "
                         "RoundTelemetry records from the engine's sink "
                         "(the card's seconds a round)")
    ap.add_argument("--telemetry", action="store_true",
                    help="attach a TelemetrySink to the engine (sim + "
                         "measured producers) and print the telemetry and "
                         "metrics summary at run end")
    ap.add_argument("--trace-out", default="",
                    help="write the span trace here at run end: .json = "
                         "Chrome trace-event format, .jsonl = one span a "
                         "line")
    ap.add_argument("--log-jsonl", default="",
                    help="structured JSONL run log: per-round rows plus "
                         "per-chunk RoundTelemetry records")
    ap.add_argument("--log-every", type=int, default=1,
                    help="log every Nth round row to --log-jsonl (chunk "
                         "rows always log)")
    ap.add_argument("--t-server", type=float, default=0.1,
                    help="simulated server step time (s) for the wall-clock "
                         "model")
    ap.add_argument("--t-gen", type=float, default=0.0,
                    help="GAS activation-generation overhead (s) per round")
    ap.add_argument("--t-comm", type=float, default=0.0,
                    help="simulated per-round communication time (s)")
    ap.add_argument("--aggregation", default=None,
                    choices=["dense", "seed_replay"],
                    help="server aggregation (default dense; --async "
                         "requires seed_replay, the record store being the "
                         "replay wire format)")
    ap.add_argument("--client-mode", default="parallel",
                    choices=["parallel", "sequential"],
                    help="accepted for the reference's flags: both are the "
                         "one client loop here")
    ap.add_argument("--loop", default=None, choices=["scan", "python"],
                    help="'scan' (default) flushes the metrics once a "
                         "chunk, 'python' once a round (the reference's "
                         "legacy loop); incompatible with --async")
    ap.add_argument("--chunk-size", type=int, default=8,
                    help="rounds between host flushes (and controller "
                         "boundaries)")
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint here, and resume from the latest "
                         "checkpoint that verifies")
    ap.add_argument("--ckpt-every", type=int, default=10,
                    help="rounds between checkpoints (chunks are cut at "
                         "its multiples)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr-server", type=float, default=1e-3)
    ap.add_argument("--lr-client", type=float, default=5e-4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the card by default; cpu runs the kernels' plain "
                         "versions")
    return ap


class Run(NamedTuple):
    """Everything a run is built from, before its first round."""
    args: argparse.Namespace
    cfg: ModelConfig
    sfl: SFLConfig
    params: Dict
    loader: FederatedLoader
    device: torch.device


def check_async_args(ap: argparse.ArgumentParser, args: argparse.Namespace):
    """The reference driver's checks of the semi-async and fault flags
    (those that need no fleet size), resolving --algorithm, --aggregation
    and --loop for --async. Returns the parsed FaultPlan or None."""
    if args.run_async:
        if args.loop is not None:
            raise SystemExit("--async and --loop are mutually exclusive: "
                             "--async runs the event-driven mode")
        if args.algorithm == "mu_splitfed":
            args.algorithm = "async_mu_splitfed"
        elif args.algorithm != "async_mu_splitfed":
            raise SystemExit(f"--async supports async_mu_splitfed, "
                             f"not {args.algorithm}")
        if args.aggregation == "dense":
            raise SystemExit("--async requires --aggregation seed_replay: "
                             "the in-flight record store is the seed-replay "
                             "wire format")
        args.aggregation = "seed_replay"
        args.loop = "async"
    else:
        if args.quorum or args.staleness_discount != 1.0:
            raise SystemExit("--quorum/--staleness-discount only take "
                             "effect under --async (the synchronous modes "
                             "never read them)")
        if args.timeline != "dense":
            ap.error("--timeline sparse is the semi-async streaming "
                     "backend; it requires --async")
        if args.loop is None:
            args.loop = "scan"
        if args.aggregation is None:
            args.aggregation = "dense"
    fault_plan = None
    if args.faults:
        try:
            fault_plan = parse_faults(args.faults)
        except ValueError as e:
            ap.error(str(e))
    if not args.run_async:
        if fault_plan is not None and fault_plan.any():
            ap.error("--faults event rates perturb the semi-async event "
                     "stream; they require --async (kill=R alone works "
                     "in any mode)")
        if args.quorum_timeout or args.adaptive_quorum:
            ap.error("--quorum-timeout/--adaptive-quorum are semi-async "
                     "degradation knobs; they require --async")
    if args.quorum_timeout < 0:
        ap.error(f"--quorum-timeout must be >= 0: got "
                 f"{args.quorum_timeout}")
    if args.max_retries < 0:
        ap.error(f"--max-retries must be >= 0: got {args.max_retries}")
    if args.adaptive_quorum and args.quorum <= 0:
        ap.error("--adaptive-quorum plans within [1, K0]; pass a finite "
                 "initial --quorum > 0")
    if args.adaptive_quorum and args.adaptive_tau:
        ap.error("--adaptive-tau and --adaptive-quorum are separate "
                 "controllers; the engine runs one controller per run")
    if args.loader == "subset" and args.timeline != "sparse":
        ap.error("--loader subset is the sparse O(K) staging path; it "
                 "requires --async --timeline sparse")
    return fault_plan


def setup(argv=None, cfg: Optional[ModelConfig] = None) -> Run:
    """Parse the flags and build config, random parameters (seeded) and
    the data loader on the chosen device. ``cfg``, if given, is run in
    place of the config that ``--arch`` names (``chip_smoke.py`` runs
    qwen3-14b with its depth cut this way)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    fault_plan = check_async_args(ap, args)
    if args.log_every < 1:
        ap.error(f"--log-every must be >= 1: got {args.log_every}")
    if args.tau_source == "measured" and not args.adaptive_tau:
        ap.error("--tau-source measured configures --adaptive-tau's clock; "
                 "pass --adaptive-tau")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run the plain versions on the CPU")
    device = torch.device(args.device)
    if cfg is None:
        cfg = get_config(args.arch, smoke=args.smoke)
    population = (strag.parse_population(
        args.population, straggler_scale=args.straggler_scale)
        if args.population else None)
    n_clients = population.n_clients if population else args.clients
    # the semi-async knobs are checked against the resolved fleet size
    if args.quorum < 0 or args.quorum > n_clients:
        ap.error(f"--quorum must be in [0, n_clients]: got {args.quorum} "
                 f"with n_clients={n_clients} (0 = wait for all pending)")
    if not 0.0 <= args.staleness_discount <= 1.0:
        ap.error(f"--staleness-discount must be in [0.0, 1.0]: got "
                 f"{args.staleness_discount} (weight base per missed "
                 f"commit)")
    if args.k_max < 0 or args.ring_capacity < 0:
        ap.error("--k-max/--ring-capacity must be >= 0 (0 = auto)")
    sfl = SFLConfig(n_clients=n_clients, tau=args.tau,
                    cut_units=args.cut or cfg.default_cut_units,
                    lr_server=args.lr_server, lr_client=args.lr_client,
                    participation=args.participation,
                    straggler_rate=args.straggler_scale,
                    deadline=args.deadline, population=population,
                    quorum=args.quorum,
                    staleness_discount=args.staleness_discount,
                    timeline=args.timeline, k_max=args.k_max,
                    ring_capacity=args.ring_capacity, faults=fault_plan,
                    quorum_timeout=args.quorum_timeout,
                    max_retries=args.max_retries)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = untie_params(cfg, init_params(cfg, gen))
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq,
                     seed=args.seed)
    parts = dirichlet_partition(np.arange(N_SAMPLES) % 10, n_clients,
                                alpha=0.5, seed=args.seed)
    loader = FederatedLoader(ds, parts, args.batch, seed=args.seed)
    return Run(args, cfg, sfl, params, loader, device)


def schedule(run: Run) -> strag.Schedule:
    """The run's whole system model as (rounds, M) host arrays."""
    a = run.args
    return strag.make_schedule(
        a.seed, a.rounds, population=strag.ClientPopulation.resolve(run.sfl),
        deadline=a.deadline, t_server=a.t_server, t_gen=a.t_gen,
        t_comm=a.t_comm)


def algorithm_options(args: argparse.Namespace) -> Dict:
    """The reference driver's options for each algorithm: GAS takes no
    client mode, FedAvg and FedLoRA run on their defaults."""
    if args.algorithm in ("mu_splitfed", "vanilla", "async_mu_splitfed"):
        return {"client_mode": args.client_mode,
                "aggregation": args.aggregation}
    if args.algorithm == "gas":
        return {"aggregation": args.aggregation}
    return {}


def run_engine(run: Run, sfl: Optional[SFLConfig] = None,
               log: Optional[Callable[[str], None]] = print,
               chunk_callback: Optional[Callable] = None):
    """``engine.run_rounds`` over the run's schedule, printing each round
    as the reference driver does, with the run's telemetry sink, span
    tracer, run log and checkpoints; with ``--ckpt-dir`` on a directory
    that holds a checkpoint, it resumes from the latest one that verifies
    (the reference driver's resume). Returns (EngineResult, the controller
    or None).
    ``sfl``, if given, replaces the run's config (``chip_smoke.py`` sets
    counter noise this way); ``chunk_callback`` runs after the printing
    and logging. A ``kill=R`` in ``sfl.faults`` SIGKILLs the process after
    the chunk that holds round R, the callback included, before its
    checkpoint is saved (and after the previous checkpoint's write has
    finished)."""
    a = run.args
    sfl = run.sfl if sfl is None else sfl
    out = log if log is not None else (lambda line: None)
    controller = (engine.AdaptiveTau(tau_max=a.tau_max, source=a.tau_source)
                  if a.adaptive_tau
                  else engine.AdaptiveQuorum() if a.adaptive_quorum
                  else None)
    algo = engine.get_algorithm(a.algorithm, **algorithm_options(a))
    plan = sfl.faults
    if plan is not None:
        out(f"faults: {plan.describe()}"
            + (f"  quorum_timeout={sfl.quorum_timeout:g}"
               if sfl.quorum_timeout else "")
            + f"  max_retries={sfl.max_retries}")
    if a.run_async:
        out(f"semi-async: quorum {sfl.quorum or 'all'} of {sfl.n_clients}, "
            f"staleness discount {sfl.staleness_discount}, "
            f"timeline {sfl.timeline}" + (
                " (k_max {}, ring {})".format(
                    *events.resolve_store_geometry(sfl))
                if sfl.timeline == "sparse" else ""))
    # the sink feeds the controllers and the log (AdaptiveQuorum observes
    # the fault counters through it); the tracer records spans over the
    # engine's hot path; the registry keeps running totals
    sink = (obs.TelemetrySink()
            if (a.telemetry or a.log_jsonl or a.adaptive_quorum
                or a.tau_source == "measured") else None)
    tracer = obs.SpanTracer() if a.trace_out else None
    prev_tracer = obs.install(tracer) if tracer is not None else None
    registry = obs.get_registry()
    # resume: the controller's overrides and EMA replay before the restore,
    # so a state template is built from the adapted config
    ck = Checkpointer(a.ckpt_dir) if a.ckpt_dir else None
    params, start_round, state = run.params, 0, None
    tau_history = quorum_history = None
    step = latest_good_step(a.ckpt_dir) if ck is not None else None
    if step is not None:
        sfl = engine.apply_resume_overrides(
            sfl, read_meta(a.ckpt_dir, step), controller)
        params, state, meta = engine.restore_run(
            ck, algo, run.cfg, sfl, params, run.loader.round_batch, step=step)
        start_round = meta["step"] + 1
        # an async controller run recompiles the timeline's prefix with
        # the per-version τ and quorum that ran
        tau_history = meta["metadata"].get("tau_per_version")
        quorum_history = meta["metadata"].get("quorum_per_version")
        out(f"[resume] from round {start_round} (tau={sfl.tau})")
    runlog = (obs.RunLog(a.log_jsonl, resume_round=start_round,
                         log_every=a.log_every)
              if a.log_jsonl else None)
    wall = strag.WallClock()
    t0 = time.time()

    def on_chunk(info, p, s):
        for i, r in enumerate(range(info.start, info.stop)):
            sim_t = wall.tick(info.round_times[i])
            active = int((info.masks[i] > 0).sum())
            if log is not None:
                log(f"round {r:4d}  loss {info.round_loss[i]:.4f}  active "
                    f"{active}/{sfl.n_clients}  "
                    f"wall {time.time() - t0:.1f}s  sim_t {sim_t:.1f}")
            if runlog is not None:
                runlog.round(r, loss=float(info.round_loss[i]),
                             active=active, sim_t=float(sim_t),
                             wall_s=round(time.time() - t0, 3))
        if sink is not None:
            registry.counter("train.rounds").inc(info.stop - info.start)
            registry.counter("train.chunks").inc()
            registry.gauge("train.last_loss").set(float(info.round_loss[-1]))
            h = registry.histogram("train.sim_round_seconds")
            for dt in info.round_times:
                h.observe(float(dt))
            meas = sink.latest("measured")
            if meas is not None and meas.stop == info.stop:
                registry.histogram("train.chunk_dispatch_seconds").observe(
                    meas.dispatch_seconds)
                registry.counter("train.staging_bytes").inc(
                    meas.staging_bytes)
            # the chunk's simulated fault counters, as running totals
            for rec in sink.window(info.start, info.stop, "sim"):
                for f in engine.FAULT_COLS:
                    n = getattr(rec, f)
                    if n:
                        registry.counter(f"train.faults.{f}").inc(n)
        if runlog is not None:
            runlog.chunk(info.start, info.stop,
                         telemetry=(sink.window(info.start, info.stop)
                                    if sink is not None else ()))
        if chunk_callback is not None:
            chunk_callback(info, p, s)
        if plan is not None and info.start <= plan.kill_round < info.stop:
            # the host-kill schedule: SIGKILL (no cleanup) right after the
            # chunk holding kill_round flushed, before its checkpoint; a
            # resume restarts from the previous boundary, whose write
            # (seconds for a 2.6 GiB model, in the checkpointer's thread)
            # is joined first so that the kill loses the chunk, not the
            # checkpoint before it
            if ck is not None:
                ck.wait()
            print(f"[faults] kill={plan.kill_round}: SIGKILL after "
                  f"chunk [{info.start}, {info.stop})", flush=True)
            os.kill(os.getpid(), signal.SIGKILL)

    try:
        result = engine.run_rounds(
            algo, run.cfg, sfl, params, run.loader.round_batch,
            schedule(run), prng.PRNGKey(a.seed), rounds=a.rounds,
            start_round=start_round, state=state, chunk_size=a.chunk_size,
            mode=a.loop, checkpointer=ck, ckpt_every=a.ckpt_every,
            chunk_callback=on_chunk, controller=controller,
            tau_history=tau_history, quorum_history=quorum_history,
            batch_subset_fn=(run.loader.subset_batch
                             if a.loader == "subset" else None),
            telemetry=sink)
    finally:
        if tracer is not None:
            obs.install(prev_tracer)
        if runlog is not None:
            runlog.close()
    if controller is not None and controller.trace:
        vals = [t for _, t in controller.trace]
        if a.adaptive_quorum:
            out(f"adaptive quorum: K0 {a.quorum} -> final {vals[-1]} "
                f"(decisions: {vals})")
        else:
            out(f"adaptive tau ({a.tau_source}): start {a.tau} -> final "
                f"{vals[-1]} (decisions: {vals})")
    if runlog is not None:
        out(f"run log: {a.log_jsonl}")
    if tracer is not None:
        n_spans = (tracer.export_jsonl(a.trace_out)
                   if a.trace_out.endswith(".jsonl")
                   else tracer.export_chrome(a.trace_out))
        out(f"trace: {n_spans} spans -> {a.trace_out}")
    if a.telemetry:
        out("telemetry summary:")
        out(json.dumps(sink.summary(), indent=2, sort_keys=True))
        out("metrics:")
        out(json.dumps(registry.snapshot(), indent=2, sort_keys=True))
    return result, controller


def main(argv=None):
    run = setup(argv)
    return run_engine(run)[0]


if __name__ == "__main__":
    main()
