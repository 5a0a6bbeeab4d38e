"""The synchronous algorithm engine (counterpart of the synchronous part of
``repro.core.engine``).

  Algorithm    protocol (init_state / round_fn / time_model) with the
               registered ``mu_splitfed`` adapter: a round is
               (params, state, batch, mask, key) -> (params, state, metrics),
               and every system effect enters as the (M,) mask row.
  run_rounds   the driver. Straggler delays and participation / deadline
               masks come from a host ``straggler.Schedule``, round r's key
               is fold_in(key, r), and the simulated wall-clock of each
               round is the algorithm's time model. PyTorch runs eagerly,
               so the reference's 'scan' and 'python' modes are the one
               Python loop here; ``chunk_size`` sets where metrics reach the
               host (one synchronise a chunk), where ``chunk_callback``
               runs, and where a Controller may re-plan.
  Controller   chunk-boundary policy hook; ``AdaptiveTau`` is the paper's
               adaptive τ (§5), re-planned from the observed straggler gap
               with ``straggler.plan_tau``.

Not ported yet (ROADMAP.md, queue 1): the baselines' adapters (items 1
and 4), telemetry (item 2), checkpoints and resume (item 3), mode='async'
and the sparse timeline (item 5).
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, List, NamedTuple, Optional, Protocol,
                    Tuple, Union, runtime_checkable)

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, SFLConfig
from repro_torch.core import prng
from repro_torch.core import straggler as strag
from repro_torch.core.splitfed import mu_splitfed_round
from repro_torch.utils import tree

Params = Any
State = Any
Batch = Dict[str, Any]


@runtime_checkable
class Algorithm(Protocol):
    """One federated algorithm as the engine sees it. State is whatever the
    algorithm carries across rounds (an empty tuple when stateless)."""
    name: str

    def init_state(self, cfg: ModelConfig, sfl: SFLConfig, params: Params,
                   batch0: Batch) -> State: ...

    def round_fn(self, cfg: ModelConfig, sfl: SFLConfig, params: Params,
                 state: State, batch: Batch, mask: torch.Tensor, key
                 ) -> Tuple[Params, State, Dict[str, torch.Tensor]]: ...

    def time_model(self, delays: np.ndarray, mask: np.ndarray,
                   sfl: SFLConfig, sched: strag.Schedule) -> float: ...


ALGORITHMS: Dict[str, Callable[..., Algorithm]] = {}


def register(cls):
    ALGORITHMS[cls.name] = cls
    return cls


def get_algorithm(name: Union[str, Algorithm], **opts) -> Algorithm:
    """An algorithm by registry name, built with ``opts``, or a ready-made
    Algorithm instance passed through."""
    if isinstance(name, str):
        if name not in ALGORITHMS:
            raise ValueError(f"unknown algorithm {name!r}; registered: "
                             f"{sorted(ALGORITHMS)} (the baselines are "
                             f"ROADMAP.md, queue 1, items 1 and 4)")
        return ALGORITHMS[name](**opts)
    if opts:
        raise ValueError("opts only apply when resolving by name")
    return name


class AlgorithmBase:
    """Shared defaults: stateless, the schedule's mask row."""

    def init_state(self, cfg, sfl, params, batch0) -> State:
        return ()

    def round_mask(self, sched: strag.Schedule, r: int) -> np.ndarray:
        """The (M,) mask row round r's round_fn consumes."""
        return sched.masks[r % sched.n_rounds]


@register
class MuSplitFed(AlgorithmBase):
    """The paper's τ-unbalanced split federated round (Algorithm 1)."""
    name = "mu_splitfed"

    def __init__(self, client_mode: str = "parallel",
                 aggregation: str = "dense", replay: str = "auto",
                 eval_loss: bool = True):
        self.client_mode = client_mode
        self.aggregation = aggregation
        self.replay = replay
        self.eval_loss = eval_loss

    def round_fn(self, cfg, sfl, params, state, batch, mask, key):
        params, m = mu_splitfed_round(
            cfg, sfl, params, batch, mask, key, client_mode=self.client_mode,
            aggregation=self.aggregation, replay=self.replay,
            eval_loss=self.eval_loss)
        return params, state, {"loss": m.loss, "server_deltas": m.server_deltas,
                               "client_delta": m.client_delta}

    def time_model(self, delays, mask, sfl, sched):
        return strag.round_time_mu_splitfed(delays, mask, sched.t_server,
                                            sfl.tau, sched.comm_for(mask))


class SchedWindow(NamedTuple):
    """What a Controller observes at a chunk boundary: the system-model
    rows of the rounds run since its previous update."""
    start: int
    stop: int
    delays: np.ndarray   # (C, M) simulated client compute times
    masks: np.ndarray    # (C, M) the schedule's participation·deadline rows
    t_server: float
    t_comm: float


@runtime_checkable
class Controller(Protocol):
    """Chunk-boundary policy hook. ``update`` runs once per chunk, before
    it runs, with the window of rounds just run (None at the first
    boundary) and the last flushed ChunkInfo; the returned dict maps
    SFLConfig fields to new values ('tau', 'lr_server', ...). A new
    'deadline' raises: no ported controller sets one.
    An optional ``bind(sfl)`` is called once with the initial config."""

    def update(self, round_idx: int, window: Optional[SchedWindow],
               metrics: Optional["ChunkInfo"]) -> Dict[str, Any]: ...


class AdaptiveTau:
    """The paper's adaptive τ (§5) as a Controller: at each chunk boundary
    it smooths the observed straggler gap (the largest active delay of each
    round run; an EMA with weight EMA on the new window) and re-plans
    τ* = t_straggler / t_server (``straggler.plan_tau``, Eq. 12). The
    server lr keeps η_s·τ at its initial value (Thm 4.1's coupling).
    ``trace`` records the (round_idx, τ) decisions. The gap is read on the
    schedule's simulated clock (``source='sim'``); the measured clock needs
    the telemetry sink, which is not ported (ROADMAP.md, queue 1, item 2).
    The reference's ``couple_lr=False`` and ``quantize`` options are left
    out: no caller here sets them."""

    EMA = 0.5

    def __init__(self, tau_max: int = 64, source: str = "sim"):
        if source == "measured":
            raise NotImplementedError(
                "AdaptiveTau(source='measured') reads the telemetry sink, "
                "which is not ported (ROADMAP.md, queue 1, item 2)")
        if source != "sim":
            raise ValueError(f"AdaptiveTau source must be 'sim'|'measured', "
                             f"got {source!r}")
        self.tau_max = tau_max
        self.source = source
        self.t_hat: Optional[float] = None
        self._eta_step: Optional[float] = None
        self.trace: List[Tuple[int, int]] = []

    def bind(self, sfl) -> None:
        if self._eta_step is None:
            self._eta_step = sfl.lr_server * sfl.tau

    def update(self, round_idx, window, metrics):
        if window is None or window.delays.size == 0:
            return {}
        act = np.where(window.masks > 0, window.delays, -np.inf)
        per_round = act.max(axis=1)
        per_round = np.where(np.isfinite(per_round), per_round, 0.0)
        obs = float(per_round.mean())
        self.t_hat = (obs if self.t_hat is None
                      else self.EMA * obs + (1.0 - self.EMA) * self.t_hat)
        tau = strag.plan_tau(self.t_hat, window.t_server, self.tau_max)
        self.trace.append((round_idx, tau))
        return {"tau": tau, "lr_server": self._eta_step / tau}


class EngineResult(NamedTuple):
    params: Params
    state: State
    metrics: Dict[str, np.ndarray]  # per-round stacks, leading dim = rounds run
    round_loss: np.ndarray          # (rounds,) mask-weighted mean client loss
    round_times: np.ndarray         # (rounds,) simulated per-round wall-clock
    sim_time: float                 # sum(round_times)
    tau_per_round: Optional[np.ndarray] = None  # (rounds,) τ each round


class ChunkInfo(NamedTuple):
    """What a chunk_callback gets about the rounds just flushed."""
    start: int                      # first absolute round in the chunk
    stop: int                       # one past the last round
    metrics: Dict[str, np.ndarray]  # host stacks, leading dim C
    masks: np.ndarray               # (C, M) the mask rows the rounds consumed
    round_loss: np.ndarray          # (C,) mask-weighted mean client loss
    round_times: np.ndarray         # (C,) simulated per-round wall-clock


def to_device_batch(host: Dict[str, np.ndarray], device) -> Dict:
    """A host batch (integer token arrays) as int64 tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(v, np.int64)).to(device)
            for k, v in host.items()}


def run_rounds(algorithm: Union[str, Algorithm], cfg: ModelConfig,
               sfl: SFLConfig, params: Params, batch_fn: Callable[[int], Batch],
               schedule: strag.Schedule, key, *, rounds: int,
               chunk_size: int = 8, mode: str = "scan",
               checkpointer=None, ckpt_every: int = 0,
               chunk_callback: Optional[Callable] = None,
               controller: Optional[Controller] = None,
               telemetry=None, **algo_opts) -> EngineResult:
    """Run rounds [0, rounds) of ``algorithm`` on the device the parameters
    lie on.

    batch_fn(r) returns round r's host batch (leaves with a leading M dim).
    ``schedule`` gives the (R, M) delay and mask rows (cyclic if shorter
    than the run) and the wall-clock knobs; ``key`` is the run's raw base
    key, and round r uses fold_in(key, r). mode 'scan' and 'python' run
    the same loop. Rounds go in chunks of ``chunk_size``: at each chunk's
    end the metrics reach the host and ``chunk_callback(ChunkInfo, params,
    state)`` runs; at each chunk's start ``controller`` may override
    SFLConfig fields for the remaining rounds ('tau' re-plans the server
    steps and the simulated round times).
    Masks, simulated round times and the τ trace always reflect what ran.
    Resuming (the reference's ``start_round`` and ``state``) comes with
    checkpoints.
    """
    algo = get_algorithm(algorithm, **algo_opts)
    if mode == "async":
        raise NotImplementedError(
            "mode='async' (the semi-async event engine) is not ported: "
            "ROADMAP.md, queue 1, item 5")
    if mode not in ("scan", "python"):
        raise ValueError(f"run_rounds: mode must be 'scan'|'python'|'async', "
                         f"got {mode!r}")
    if checkpointer is not None or ckpt_every:
        raise NotImplementedError("checkpoints are not ported: ROADMAP.md, "
                                  "queue 1, item 3 (ckpt/checkpoint.py)")
    if telemetry is not None:
        raise NotImplementedError("the telemetry sink is not ported: "
                                  "ROADMAP.md, queue 1, item 2 (obs/)")
    if rounds <= 0:
        empty = np.zeros((0,), np.float64)
        return EngineResult(params, (), {}, empty, empty, 0.0,
                            np.zeros((0,), np.int64))
    device = tree.leaves(params)[0].device
    state = algo.init_state(cfg, sfl, params,
                            to_device_batch(batch_fn(0), device))

    R = schedule.n_rounds
    # two sets of (rounds, M) rows, as the reference keeps them: the
    # schedule's own masks set the simulated round times and what a
    # controller observes; the algorithm's round_mask rows are what its
    # rounds consume and what weights their losses
    time_masks = np.stack([schedule.masks[r % R] for r in range(rounds)])
    masks = np.stack([algo.round_mask(schedule, r) for r in range(rounds)])
    round_times = np.array([algo.time_model(schedule.delays[r % R],
                                            time_masks[r], sfl, schedule)
                            for r in range(rounds)])
    tau_used = np.full(rounds, sfl.tau, np.int64)
    segments = [(r, min(r + chunk_size, rounds))
                for r in range(0, rounds, chunk_size)]

    if controller is not None and hasattr(controller, "bind"):
        controller.bind(sfl)

    chunks: List[Dict[str, np.ndarray]] = []
    last_info: Optional[ChunkInfo] = None

    def controller_step(seg_idx):
        """Apply the controller's overrides for rounds >= this segment and
        re-derive the simulated times they change."""
        nonlocal sfl
        r0 = segments[seg_idx][0]
        window = None
        if seg_idx > 0:
            p0, p1 = segments[seg_idx - 1]
            window = SchedWindow(
                p0, p1,
                np.stack([schedule.delays[rr % R] for rr in range(p0, p1)]),
                time_masks[p0:p1], schedule.t_server, schedule.t_comm)
        upd = controller.update(r0, window, last_info) or {}
        changed = {k: v for k, v in upd.items() if getattr(sfl, k) != v}
        if not changed:
            return
        if "deadline" in changed:
            raise NotImplementedError(
                "a controller that moves the deadline is not ported (the "
                "reference re-derives the masks from the schedule's delays)")
        sfl = dataclasses.replace(sfl, **changed)
        for rr in range(r0, rounds):
            round_times[rr] = algo.time_model(schedule.delays[rr % R],
                                              time_masks[rr], sfl, schedule)
        tau_used[r0:] = sfl.tau

    for si, (r0, r1) in enumerate(segments):
        if controller is not None:
            controller_step(si)
        mets = []
        for rr in range(r0, r1):
            params, state, met = algo.round_fn(
                cfg, sfl, params, state,
                to_device_batch(batch_fn(rr), device),
                torch.from_numpy(masks[rr]).to(device),
                prng.fold_in(key, rr))
            mets.append(met)
        # the chunk's one synchronise: its metrics reach the host
        host = {k: torch.stack([m[k] for m in mets]).cpu().numpy()
                for k in mets[0]}
        chunks.append(host)
        m = masks[r0:r1]
        rl = ((host["loss"] * m).sum(1)
              / np.maximum(m.sum(1), 1.0)).astype(np.float64)
        last_info = ChunkInfo(r0, r1, host, m, rl, round_times[r0:r1])
        if chunk_callback is not None:
            chunk_callback(last_info, params, state)

    def _cat(k2):
        arrs = [c[k2] for c in chunks]
        shapes = {a.shape[1:] for a in arrs}
        if len(shapes) > 1:     # a controller changed τ: pad trailing axes
            full = tuple(max(dims) for dims in zip(*shapes))
            arrs = [np.pad(a, [(0, 0)] + [(0, t - s) for s, t
                                          in zip(a.shape[1:], full)])
                    for a in arrs]
        return np.concatenate(arrs)

    metrics = {k2: _cat(k2) for k2 in chunks[0]}
    round_loss = ((metrics["loss"] * masks).sum(1)
                  / np.maximum(masks.sum(1), 1.0)).astype(np.float64)
    return EngineResult(params, state, metrics, round_loss, round_times,
                        float(round_times.sum()), tau_used)
