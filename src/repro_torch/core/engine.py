"""The synchronous algorithm engine (counterpart of the synchronous part of
``repro.core.engine``).

  Algorithm    protocol (init_state / round_fn / time_model) with the
               registered ``mu_splitfed``, ``vanilla`` and ``gas``
               adapters: a round is (params, state, batch, mask, key) ->
               (params, state, metrics), and every system effect enters as
               the (M,) mask row (GAS carries its activation buffer as
               state).
  run_rounds   the driver. Straggler delays and participation / deadline
               masks come from a host ``straggler.Schedule``, round r's key
               is fold_in(key, r), and the simulated wall-clock of each
               round is the algorithm's time model. PyTorch runs eagerly:
               mode 'scan' stages a chunk's batches, launches its rounds
               and flushes the metrics to the host once a chunk (one
               synchronise); mode 'python' flushes after every round, as
               the reference's per-round loop does. ``chunk_size`` sets
               where a Controller may re-plan in both. A
               ``obs.TelemetrySink`` gets the simulator's and the measured
               clock's records.
  Controller   chunk-boundary policy hook; ``AdaptiveTau`` is the paper's
               adaptive τ (§5), re-planned from the observed straggler gap
               (simulated or measured) with ``straggler.plan_tau``.

Not ported yet (ROADMAP.md, queue 1): checkpoints and resume (item 3),
the first-order baselines (item 4), mode='async' and the sparse timeline
(item 5).
"""
from __future__ import annotations

import dataclasses
from time import perf_counter
from typing import (Any, Callable, Dict, List, NamedTuple, Optional, Protocol,
                    Tuple, Union, runtime_checkable)

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, SFLConfig
from repro_torch.core import prng
from repro_torch.core import straggler as strag
from repro_torch.core.baselines import (gas_init_state, gas_round,
                                        vanilla_splitfed_round)
from repro_torch.core.splitfed import mu_splitfed_round
from repro_torch.obs.telemetry import RoundTelemetry, TelemetrySink
from repro_torch.obs.trace import span
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
                             f"{sorted(ALGORITHMS)} (fedavg and fedlora are "
                             f"ROADMAP.md, queue 1, item 4)")
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
        return params, state, m._asdict()

    def time_model(self, delays, mask, sfl, sched):
        return strag.round_time_mu_splitfed(delays, mask, sched.t_server,
                                            sfl.tau, sched.comm_for(mask))


@register
class VanillaSplitFed(MuSplitFed):
    """SplitFed without unbalanced updates: exactly MU-SplitFed at τ=1."""
    name = "vanilla"

    def round_fn(self, cfg, sfl, params, state, batch, mask, key):
        params, m = vanilla_splitfed_round(
            cfg, sfl, params, batch, mask, key, client_mode=self.client_mode,
            aggregation=self.aggregation, replay=self.replay,
            eval_loss=self.eval_loss)
        return params, state, m._asdict()

    def time_model(self, delays, mask, sfl, sched):
        return strag.round_time_vanilla(delays, mask, sched.t_server,
                                        sched.comm_for(mask))


@register
class Gas(AlgorithmBase):
    """GAS-like async SFL with a carried activation buffer. ``fresh``
    selects where the freshness mask comes from: 'mask' (the schedule's
    participation·deadline row, the training driver's convention) or
    'median' (clients at or below the round's median delay, Fig. 2)."""
    name = "gas"

    def __init__(self, aggregation: str = "dense", replay: str = "auto",
                 fresh: str = "mask"):
        if fresh not in ("mask", "median"):
            raise ValueError(f"gas: fresh must be 'mask'|'median', "
                             f"got {fresh!r}")
        self.aggregation = aggregation
        self.replay = replay
        self.fresh = fresh

    def init_state(self, cfg, sfl, params, batch0):
        return gas_init_state(cfg, sfl, params, batch0)

    def round_mask(self, sched, r):
        i = r % sched.n_rounds
        return (sched.fresh_median[i] if self.fresh == "median"
                else sched.masks[i])

    def round_fn(self, cfg, sfl, params, state, batch, mask, key):
        params, state, m = gas_round(cfg, sfl, params, state, batch, mask,
                                     key, aggregation=self.aggregation,
                                     replay=self.replay)
        return params, state, m._asdict()

    def time_model(self, delays, mask, sfl, sched):
        return strag.round_time_gas(delays, mask, sched.t_server, sched.t_gen,
                                    sched.comm_for(mask))


class SchedWindow(NamedTuple):
    """What a Controller observes at a chunk boundary: the system-model
    rows of the rounds run since its previous update, and the
    TelemetrySink records overlapping them when run_rounds was given a
    sink (both producers, 'sim' and 'measured', so a controller chooses
    its clock). ``quorum_wait`` is the semi-async engine's (not ported):
    always None here."""
    start: int
    stop: int
    delays: np.ndarray   # (C, M) simulated client compute times
    masks: np.ndarray    # (C, M) the schedule's participation·deadline rows
    t_server: float
    t_comm: float
    quorum_wait: Optional[np.ndarray] = None
    telemetry: Tuple[RoundTelemetry, ...] = ()  # sink records for the window


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
    """The paper's adaptive τ (§5) as a Controller.

    At each chunk boundary it EMA-smooths the observed straggler gap (the
    largest active delay of each round run) and re-plans
    τ* = t_straggler / t_server (``straggler.plan_tau``, Eq. 12). With
    ``couple_lr`` (default) the server lr keeps Thm 4.1's coupling: η_s·τ
    is held at its initial value. ``quantize`` snaps τ to a power of two
    (capped at tau_max). ``trace`` records the (round_idx, τ) decisions.

    ``source`` picks the clock the gap is observed on: 'sim' (default)
    reads the schedule's simulated delays from the window rows;
    'measured' reads the measured-clock RoundTelemetry records of
    ``window.telemetry`` (synchronise-bracketed wall time a round) and
    falls back to the simulated rows when no measured record covers the
    window (the first boundary, or a run without a sink).
    """

    def __init__(self, tau_max: int = 64, ema: float = 0.5,
                 couple_lr: bool = True, quantize: bool = False,
                 source: str = "sim"):
        if source not in ("sim", "measured"):
            raise ValueError(f"AdaptiveTau source must be 'sim'|'measured', "
                             f"got {source!r}")
        self.tau_max = tau_max
        self.ema = ema
        self.couple_lr = couple_lr
        self.source = source
        self.quantize = quantize
        self.t_hat: Optional[float] = None
        self._eta_step: Optional[float] = None    # η_s·τ at bind time
        self.trace: List[Tuple[int, int]] = []

    def bind(self, sfl) -> None:
        if self.couple_lr and self._eta_step is None:
            self._eta_step = sfl.lr_server * sfl.tau

    def state_dict(self) -> Dict[str, Any]:
        return {"t_hat": self.t_hat, "eta_step": self._eta_step}

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        self.t_hat = d.get("t_hat")
        self._eta_step = d.get("eta_step")

    def _observed(self, window) -> np.ndarray:
        if self.source == "measured":
            meas = [r for r in getattr(window, "telemetry", ()) or ()
                    if r.source == "measured"]
            if meas:
                return np.concatenate([np.asarray(r.durations, np.float64)
                                       for r in meas])
        if window.quorum_wait is not None:
            return np.asarray(window.quorum_wait, np.float64)
        act = np.where(window.masks > 0, window.delays, -np.inf)
        per_round = act.max(axis=1)
        return np.where(np.isfinite(per_round), per_round, 0.0)

    def update(self, round_idx, window, metrics):
        if window is None or window.delays.size == 0:
            return {}
        obs = float(self._observed(window).mean())
        self.t_hat = (obs if self.t_hat is None
                      else self.ema * obs + (1.0 - self.ema) * self.t_hat)
        tau = strag.plan_tau(self.t_hat, window.t_server, self.tau_max)
        if self.quantize:
            tau = min(1 << int(round(np.log2(max(tau, 1)))), self.tau_max)
        self.trace.append((round_idx, tau))
        out = {"tau": tau}
        if self._eta_step is not None:
            out["lr_server"] = self._eta_step / tau
        return out


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


def _synchronize(device) -> None:
    """Wait for the device's queued work (nothing to wait for on the
    CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _comm_of(schedule) -> np.ndarray:
    """(M,) per-client uplink seconds."""
    comm = np.full(schedule.n_clients, schedule.t_comm, np.float64)
    if schedule.t_comm_scale is not None:
        comm = schedule.t_comm * np.asarray(schedule.t_comm_scale, np.float64)
    return comm


def _cohort_bounds_of(schedule) -> List[Tuple[int, int]]:
    pop = getattr(schedule, "population", None)
    if pop is None:
        return [(0, schedule.n_clients)]
    return [(s.start, s.stop) for s in pop.slices()]


def run_rounds(algorithm: Union[str, Algorithm], cfg: ModelConfig,
               sfl: SFLConfig, params: Params, batch_fn: Callable[[int], Batch],
               schedule: strag.Schedule, key, *, rounds: int,
               chunk_size: int = 8, mode: str = "scan",
               checkpointer=None, ckpt_every: int = 0,
               chunk_callback: Optional[Callable] = None,
               controller: Optional[Controller] = None,
               telemetry: Optional[TelemetrySink] = None,
               **algo_opts) -> EngineResult:
    """Run rounds [0, rounds) of ``algorithm`` on the device the parameters
    lie on.

    batch_fn(r) returns round r's host batch (leaves with a leading M dim).
    ``schedule`` gives the (R, M) delay and mask rows (cyclic if shorter
    than the run) and the wall-clock knobs; ``key`` is the run's raw base
    key, and round r uses fold_in(key, r). Rounds go in segments of
    ``chunk_size``; at each segment's start ``controller`` may override
    SFLConfig fields for the remaining rounds ('tau' re-plans the server
    steps and the simulated round times). mode 'scan' flushes the metrics
    to the host (and runs ``chunk_callback(ChunkInfo, params, state)``)
    once a segment; mode 'python' once a round, with a one-round
    ChunkInfo, while the controller still sees the whole segment's.
    Masks, simulated round times and the τ trace always reflect what ran.

    ``telemetry`` (an ``obs.TelemetrySink``) turns on both producers: a
    'sim' record at every flush (durations bit-identical to
    ChunkInfo.round_times, per-cohort arrival latencies) and one
    'measured' record a segment (in 'scan' the host staging seconds and
    bytes, and the dispatch seconds up to a ``torch.cuda.synchronize``; in
    'python' the segment's seconds, its per-round flushes being the
    synchronises). Controllers see the window's records in
    ``SchedWindow.telemetry``. With telemetry=None no clock is read and
    no extra synchronise happens. Spans ``engine.stage``,
    ``engine.dispatch`` and ``engine.flush`` go to the installed
    ``obs.trace`` tracer ('scan' mode).
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
    if rounds <= 0:
        empty = np.zeros((0,), np.float64)
        return EngineResult(params, (), {}, empty, empty, 0.0,
                            np.zeros((0,), np.int64))
    device = tree.leaves(params)[0].device
    state = algo.init_state(cfg, sfl, params,
                            to_device_batch(batch_fn(0), device))
    tele = telemetry is not None

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
    cohort_bounds = _cohort_bounds_of(schedule)

    if controller is not None and hasattr(controller, "bind"):
        controller.bind(sfl)

    chunks: List[Dict[str, np.ndarray]] = []
    last_info: Optional[ChunkInfo] = None

    def chunk_info(host, r0, r1):
        m = masks[r0:r1]
        rl = ((host["loss"] * m).sum(1)
              / np.maximum(m.sum(1), 1.0)).astype(np.float64)
        return ChunkInfo(r0, r1, host, m, rl, round_times[r0:r1])

    def seg_info(r0, r1):
        seg = chunks[-(r1 - r0):]
        return chunk_info({k2: np.concatenate([c[k2] for c in seg])
                           for k2 in seg[0]}, r0, r1)

    def cohort_arrival(r0, r1):
        """Per-cohort mean arrival latency (delay + uplink) of the
        window's active clients."""
        arr = (np.stack([schedule.delays[rr % R] for rr in range(r0, r1)])
               + _comm_of(schedule)[None, :])
        m = time_masks[r0:r1]
        out = np.zeros(len(cohort_bounds), np.float64)
        for ci, (cs, ce) in enumerate(cohort_bounds):
            w = m[:, cs:ce]
            tot = w.sum()
            out[ci] = float((arr[:, cs:ce] * w).sum() / tot) if tot else 0.0
        return out

    def flush(mets, r0, r1):
        """The metrics of rounds [r0, r1) reach the host (a synchronise)."""
        nonlocal last_info
        host = {k: torch.stack([m[k] for m in mets]).cpu().numpy()
                for k in mets[0]}
        chunks.append(host)
        last_info = chunk_info(host, r0, r1)
        if tele:    # durations: the same slice ChunkInfo carries
            telemetry.emit(RoundTelemetry(
                r0, r1, "sim", mode, round_times[r0:r1].copy(),
                cohort_arrival=cohort_arrival(r0, r1)))
        if chunk_callback is not None:
            chunk_callback(last_info, params, state)

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
                time_masks[p0:p1], schedule.t_server, schedule.t_comm,
                telemetry=telemetry.window(p0, p1) if tele else ())
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

    def one_round(rr, batch):
        nonlocal params, state
        params, state, met = algo.round_fn(
            cfg, sfl, params, state, batch,
            torch.from_numpy(masks[rr]).to(device), prng.fold_in(key, rr))
        return met

    for si, (r0, r1) in enumerate(segments):
        if controller is not None:
            controller_step(si)
        C = r1 - r0
        if mode == "python":
            t_seg = perf_counter() if tele else 0.0
            for rr in range(r0, r1):
                flush([one_round(rr, to_device_batch(batch_fn(rr), device))],
                      rr, rr + 1)
            if tele:    # the per-round flushes above are the synchronises
                dt = perf_counter() - t_seg
                telemetry.emit(RoundTelemetry(
                    r0, r1, "measured", mode, np.full(C, dt / C),
                    dispatch_seconds=dt))
            if controller is not None and C > 1:
                last_info = seg_info(r0, r1)
            continue
        t_host = perf_counter() if tele else 0.0
        with span("engine.stage", start=r0, stop=r1):
            staged = [to_device_batch(batch_fn(rr), device)
                      for rr in range(r0, r1)]
        t_disp = perf_counter() if tele else 0.0
        with span("engine.dispatch", start=r0, stop=r1):
            mets = [one_round(rr, b) for rr, b in zip(range(r0, r1), staged)]
        if tele:
            _synchronize(device)
            t_sync = perf_counter()
            telemetry.emit(RoundTelemetry(
                r0, r1, "measured", mode, np.full(C, (t_sync - t_disp) / C),
                staging_seconds=t_disp - t_host,
                staging_bytes=sum(t.nbytes for b in staged
                                  for t in b.values()),
                dispatch_seconds=t_sync - t_disp))
        with span("engine.flush", start=r0, stop=r1):
            flush(mets, r0, r1)

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
