"""Synchronous MU-SplitFed training driver for the port (counterpart of
``repro.launch.train`` running ``--loop python``).

Round r uses the key fold_in(PRNGKey(seed), r) and, under the default full
participation, the all-ones mask, exactly as the reference engine's python
mode does; data come from the same seeded synthetic LM and Dirichlet
partition. Each round prints its mask-weighted mean client loss and its
wall seconds (ending in a device sync).

The noise is always ``perturbation_dist='counter'``, the one this slice
ports. The reference driver has no dist flag and runs threefry 'gaussian'
noise, so the two drivers train on different noise; parity with the
reference is held by calling its round with 'counter' (see the tests).

Runs on the card unless ``--device cpu`` is given:
    python -m repro_torch.launch.train --arch olmo-1b --clients 2 --tau 2 \\
        --batch 1 --seq 512 --rounds 3 --aggregation seed_replay
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b \\
        --smoke --device cpu --rounds 2 --seq 16
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs import ModelConfig, SFLConfig, get_config
from repro_torch.core import prng
from repro_torch.core.splitfed import mu_splitfed_round
from repro_torch.data import FederatedLoader, SyntheticLM, dirichlet_partition
from repro_torch.models import init_params, untie_params

N_SAMPLES = 4096


class TrainResult(NamedTuple):
    params: Dict
    round_loss: List[float]       # mask-weighted mean client loss per round
    round_seconds: List[float]    # wall seconds per round, device-synced
    round_peak_bytes: List[int]   # peak device memory per round (0 on CPU)


def to_device_batch(host: Dict[str, np.ndarray], device) -> Dict:
    return {k: torch.from_numpy(np.asarray(v, np.int64)).to(device)
            for k, v in host.items()}


def train_rounds(cfg: ModelConfig, sfl: SFLConfig, params: Dict,
                 batch_fn: Callable[[int], Dict[str, np.ndarray]], seed: int,
                 rounds: int, *, aggregation: str, device,
                 log: Optional[Callable[[str], None]] = print
                 ) -> TrainResult:
    """Rounds [0, rounds) of mu_splitfed_round on ``device``."""
    key = prng.PRNGKey(seed)
    mask = torch.ones(sfl.n_clients, dtype=torch.float32, device=device)
    cuda = device.type == "cuda"
    losses, seconds, peaks = [], [], []
    for r in range(rounds):
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        batches = to_device_batch(batch_fn(r), device)
        params, met = mu_splitfed_round(cfg, sfl, params, batches, mask,
                                        prng.fold_in(key, r),
                                        aggregation=aggregation)
        loss = float((met.loss * mask).sum() / mask.sum().clamp(min=1.0))
        if cuda:
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        losses.append(loss)
        seconds.append(dt)
        peaks.append(peak)
        if log is not None:
            log(f"round {r:4d}  loss {loss:.4f}  wall {dt:.3f}s"
                + (f"  peak {peak / 2 ** 30:.2f} GiB" if cuda else ""))
    return TrainResult(params, losses, seconds, peaks)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Synchronous MU-SplitFed training (PyTorch port). The "
                    "ZO noise is perturbation_dist='counter', the only one "
                    "ported; the JAX driver runs threefry 'gaussian' noise.")
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--tau", type=int, default=2)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2, help="per-client batch")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--cut", type=int, default=0, help="0 = arch default")
    ap.add_argument("--lr-server", type=float, default=1e-3)
    ap.add_argument("--lr-client", type=float, default=5e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--aggregation", default="dense",
                    choices=["dense", "seed_replay"])
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
    args = build_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run the plain versions on the CPU")
    device = torch.device(args.device)
    if cfg is None:
        cfg = get_config(args.arch, smoke=args.smoke)
    sfl = SFLConfig(n_clients=args.clients, tau=args.tau,
                    cut_units=args.cut or cfg.default_cut_units,
                    lr_server=args.lr_server, lr_client=args.lr_client,
                    perturbation_dist="counter")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = untie_params(cfg, init_params(cfg, gen))
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq,
                     seed=args.seed)
    parts = dirichlet_partition(np.arange(N_SAMPLES) % 10, args.clients,
                                alpha=0.5, seed=args.seed)
    loader = FederatedLoader(ds, parts, args.batch, seed=args.seed)
    return Run(args, cfg, sfl, params, loader, device)


def main(argv=None) -> TrainResult:
    run = setup(argv)
    return train_rounds(run.cfg, run.sfl, run.params, run.loader.round_batch,
                        run.args.seed, run.args.rounds,
                        aggregation=run.args.aggregation, device=run.device)


if __name__ == "__main__":
    main()
