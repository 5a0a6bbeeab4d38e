"""Synchronous split federated training driver for the port (counterpart
of ``repro.launch.train`` in its synchronous modes).

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
trace, .jsonl one span a line).

Runs on the card unless ``--device cpu`` is given:
    python -m repro_torch.launch.train --arch paper-opt-1.3b --clients 4 \\
        --batch 1 --seq 512 --rounds 4 --chunk-size 2 --participation 0.75 \\
        --straggler-scale 3.0 --t-server 0.25 --t-gen 2.0 --algorithm gas
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --rounds 4 --seq 16 --straggler-scale 2.0 --adaptive-tau \\
        --tau-source measured --telemetry --log-jsonl run.jsonl
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --rounds 3 --seq 16 --algorithm fedlora

Not ported yet (ROADMAP.md, queue 1): checkpoints (--ckpt-dir,
--ckpt-every), --async and its flags, --faults and --adaptive-quorum.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs import ModelConfig, SFLConfig, get_config
from repro_torch.core import engine, prng
from repro_torch.core import straggler as strag
from repro_torch.data import FederatedLoader, SyntheticLM, dirichlet_partition
from repro_torch.models import init_params, untie_params

N_SAMPLES = 4096


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Synchronous split federated training (PyTorch port "
                    "of repro.launch.train's synchronous modes).")
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
                    help="server aggregation (default dense)")
    ap.add_argument("--client-mode", default="parallel",
                    choices=["parallel", "sequential"],
                    help="accepted for the reference's flags: both are the "
                         "one client loop here")
    ap.add_argument("--loop", default="scan", choices=["scan", "python"],
                    help="'scan' flushes the metrics once a chunk, "
                         "'python' once a round (the reference's legacy "
                         "loop)")
    ap.add_argument("--chunk-size", type=int, default=8,
                    help="rounds between host flushes (and controller "
                         "boundaries)")
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


def setup(argv=None, cfg: Optional[ModelConfig] = None) -> Run:
    """Parse the flags and build config, random parameters (seeded) and
    the data loader on the chosen device. ``cfg``, if given, is run in
    place of the config that ``--arch`` names (``chip_smoke.py`` runs
    qwen3-14b with its depth cut this way)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.aggregation is None:
        args.aggregation = "dense"
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
    sfl = SFLConfig(n_clients=n_clients, tau=args.tau,
                    cut_units=args.cut or cfg.default_cut_units,
                    lr_server=args.lr_server, lr_client=args.lr_client,
                    participation=args.participation,
                    straggler_rate=args.straggler_scale,
                    deadline=args.deadline, population=population)
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
    if args.algorithm in ("mu_splitfed", "vanilla"):
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
    tracer and run log. Returns (EngineResult, the controller or None).
    ``sfl``, if given, replaces the run's config (``chip_smoke.py`` sets
    counter noise this way); ``chunk_callback`` runs after the printing
    and logging."""
    a = run.args
    sfl = run.sfl if sfl is None else sfl
    controller = (engine.AdaptiveTau(tau_max=a.tau_max, source=a.tau_source)
                  if a.adaptive_tau else None)
    algo = engine.get_algorithm(a.algorithm, **algorithm_options(a))
    # the sink feeds the controller and the log; the tracer records spans
    # over the engine's hot path; the registry keeps running totals
    sink = (obs.TelemetrySink()
            if a.telemetry or a.log_jsonl or a.tau_source == "measured"
            else None)
    tracer = obs.SpanTracer() if a.trace_out else None
    prev_tracer = obs.install(tracer) if tracer is not None else None
    registry = obs.get_registry()
    runlog = (obs.RunLog(a.log_jsonl, log_every=a.log_every)
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
        if runlog is not None:
            runlog.chunk(info.start, info.stop,
                         telemetry=(sink.window(info.start, info.stop)
                                    if sink is not None else ()))
        if chunk_callback is not None:
            chunk_callback(info, p, s)

    try:
        result = engine.run_rounds(
            algo, run.cfg, sfl, run.params, run.loader.round_batch,
            schedule(run), prng.PRNGKey(a.seed), rounds=a.rounds,
            chunk_size=a.chunk_size, mode=a.loop, chunk_callback=on_chunk,
            controller=controller, telemetry=sink)
    finally:
        if tracer is not None:
            obs.install(prev_tracer)
        if runlog is not None:
            runlog.close()
    out = log if log is not None else (lambda line: None)
    if controller is not None and controller.trace:
        vals = [t for _, t in controller.trace]
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
