"""The algorithm engine (counterpart of ``repro.core.engine``).

  Algorithm    protocol (init_state / round_fn / time_model) with the
               registered ``mu_splitfed``, ``vanilla``, ``gas``, ``fedavg``,
               ``fedlora`` and ``async_mu_splitfed`` adapters: a round is
               (params, state, batch, mask, key) -> (params, state,
               metrics), and every system effect enters as the (M,) mask
               row (GAS carries its activation buffer as state, FedLoRA
               its adapters, the semi-async one its record store).
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
               clock's records. A ``ckpt.Checkpointer`` saves at chunk
               boundaries aligned to ``ckpt_every``; ``restore_run`` and
               ``apply_resume_overrides`` bring a run back, and
               ``run_rounds(start_round=..., state=...)`` continues it.
               mode 'async' runs the semi-async event engine
               (``core/events.py``): each "round" is one quorum-committed
               server version of the compiled ('dense') or streamed
               ('sparse') timeline, with faults and quorum_timeout.
  Controller   chunk-boundary policy hook; ``AdaptiveTau`` is the paper's
               adaptive τ (§5), re-planned from the observed straggler gap
               (simulated or measured) with ``straggler.plan_tau``;
               ``AdaptiveQuorum`` resizes the commit quorum from the
               observed fault pressure.

The reference's ``batch_put`` (the sharded placement of a sparse chunk on
a multi-device mesh, ``launch/fleet.py``) is not taken: the port runs on
one card.
"""
from __future__ import annotations

import dataclasses
from time import perf_counter
from typing import (Any, Callable, Dict, List, NamedTuple, Optional, Protocol,
                    Tuple, Union, runtime_checkable)

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import read_meta
from repro_torch.configs.base import ModelConfig, SFLConfig
from repro_torch.core import events, prng
from repro_torch.core import straggler as strag
from repro_torch.core.baselines import (fedavg_round, fedlora_round,
                                        gas_init_state, gas_round,
                                        vanilla_splitfed_round)
from repro_torch.core.splitfed import mu_splitfed_round
from repro_torch.models import loss_fn
from repro_torch.obs.telemetry import RoundTelemetry, TelemetrySink
from repro_torch.obs.trace import span
from repro_torch.optim.lora import apply_lora, init_lora
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
                             f"{sorted(ALGORITHMS)}")
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
class AsyncMuSplitFed(MuSplitFed):
    """Semi-async MU-SplitFed over the event timeline (core/events.py): the
    server commits a version as soon as a quorum of contributions has
    arrived; late arrivals fold into a later commit with a staleness
    discount, applied through seed replay. Run it with ``mode='async'``;
    the quorum and discount live in SFLConfig (``quorum``,
    ``staleness_discount``). Under the sync modes it is MU-SplitFed with
    seed-replay aggregation (its record store rides along untouched). The
    in-flight buffer is the (key, coeff) wire format, so anything but
    aggregation='seed_replay' is rejected."""
    name = "async_mu_splitfed"

    def __init__(self, client_mode: str = "parallel",
                 aggregation: str = "seed_replay", replay: str = "auto",
                 eval_loss: bool = True):
        if client_mode != "parallel":
            raise ValueError("async_mu_splitfed: the event-driven store "
                             "needs stacked per-client replicas "
                             "(client_mode='parallel')")
        if aggregation != "seed_replay":
            raise ValueError("async_mu_splitfed: the record store is the "
                             "seed-replay wire format; aggregation "
                             f"{aggregation!r} is not replayable")
        super().__init__(client_mode=client_mode, aggregation=aggregation,
                         replay=replay, eval_loss=eval_loss)

    def init_state(self, cfg, sfl, params, batch0):
        return events.init_store(sfl, tree.leaves(params)[0].device)

    def async_round_fn(self, cfg, sfl, params, store, batch, start_mask,
                       apply_w, key):
        return events.async_mu_splitfed_step(
            cfg, sfl, params, store, batch, start_mask, apply_w, key,
            replay=self.replay, eval_loss=self.eval_loss)

    def async_sparse_round_fn(self, cfg, sfl, params, store, batch,
                              start_client, start_slot, apply_slot,
                              apply_w, key):
        return events.async_mu_splitfed_sparse_step(
            cfg, sfl, params, store, batch, start_client, start_slot,
            apply_slot, apply_w, key, replay=self.replay,
            eval_loss=self.eval_loss)

    def time_model(self, delays, mask, sfl, sched):
        # the sync modes run the full barrier, so the version ends at the
        # last pending arrival (quorum 0); mode='async' reads the quorum
        # pacing off the timeline instead
        return events.quorum_round_time(delays, mask, sched.t_server,
                                        sfl.tau, quorum=0,
                                        t_comm=sched.t_comm,
                                        t_comm_scale=sched.t_comm_scale)


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


def _client_losses(cfg: ModelConfig, params: Params, batch) -> torch.Tensor:
    """(M,) f32 loss of each client's batch at ``params``, with no graph."""
    M = next(iter(batch.values())).shape[0]
    with torch.no_grad():
        return torch.stack([loss_fn(cfg, params,
                                    {k: v[m] for k, v in batch.items()})
                            for m in range(M)]).to(torch.float32)


@register
class FedAvg(AlgorithmBase):
    """First-order FedAvg (full model on every client, E local steps)."""
    name = "fedavg"

    def __init__(self, lr: Optional[float] = None, local_steps: int = 1,
                 optimizer: str = "sgd"):
        self.lr = lr
        self.local_steps = local_steps
        self.optimizer = optimizer

    def round_fn(self, cfg, sfl, params, state, batch, mask, key):
        first = ({k: v[:, 0] for k, v in batch.items()}
                 if self.local_steps > 1 else batch)
        loss0 = _client_losses(cfg, params, first)
        params = fedavg_round(cfg, params, batch, mask,
                              self.lr if self.lr is not None else sfl.lr_client,
                              self.local_steps, self.optimizer,
                              eta_g=sfl.lr_global)
        return params, state, {"loss": loss0}

    def time_model(self, delays, mask, sfl, sched):
        return strag.round_time_local_only(delays, mask, sched.comm_for(mask))


@register
class FedLora(FedAvg):
    """FedAvg over LoRA adapters only; the base parameters never move, and
    the adapter tree is the engine's state."""
    name = "fedlora"

    def __init__(self, rank: int = 4, alpha: float = 16.0,
                 lr: Optional[float] = None):
        super().__init__(lr=lr)
        self.rank = rank
        self.alpha = alpha

    def init_state(self, cfg, sfl, params, batch0):
        return init_lora(cfg, params, self.rank, prng.PRNGKey(sfl.seed))

    def round_fn(self, cfg, sfl, params, state, batch, mask, key):
        with torch.no_grad():
            merged = apply_lora(params, state, self.alpha)
        loss0 = _client_losses(cfg, merged, batch)
        del merged
        lora = fedlora_round(cfg, params, state, batch, mask,
                             self.lr if self.lr is not None else sfl.lr_client,
                             self.alpha, eta_g=sfl.lr_global)
        return params, lora, {"loss": loss0}


class SchedWindow(NamedTuple):
    """What a Controller observes at a chunk boundary: the system-model
    rows of the rounds run since its previous update, and the
    TelemetrySink records overlapping them when run_rounds was given a
    sink (both producers, 'sim' and 'measured', so a controller chooses
    its clock). Async runs also carry ``quorum_wait``, the per-version
    waits for the quorum's arrival before the τ·t_server floor: under
    event-driven commits that is the gap adaptive τ should fill."""
    start: int
    stop: int
    delays: np.ndarray   # (C, M) simulated client compute times
    masks: np.ndarray    # (C, M) the schedule's participation·deadline rows
    t_server: float
    t_comm: float
    quorum_wait: Optional[np.ndarray] = None   # (C,) async quorum waits
    telemetry: Tuple[RoundTelemetry, ...] = ()  # sink records for the window


@runtime_checkable
class Controller(Protocol):
    """Chunk-boundary policy hook. ``update`` runs once per chunk, before
    it runs, with the window of rounds just run (None at the first
    boundary, a resumed run's too) and the last flushed ChunkInfo; the
    returned dict maps
    SFLConfig fields to new values ('tau', 'lr_server', ...; a new
    'deadline' re-derives the deadline masks from the schedule's delay
    rows). An optional ``bind(sfl)`` is called once with the initial
    config, and optional ``state_dict()`` / ``load_state_dict(d)`` carry
    the controller across a checkpoint."""

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


class AdaptiveQuorum:
    """Graceful degradation: resize the commit quorum K from the observed
    fault pressure (core/faults.py).

    At each chunk boundary it reads the window's simulator RoundTelemetry
    records (``SchedWindow.telemetry``): started dispatches against
    contributions lost to crashes, exhausted retries, checksum drops and
    ring evictions. It EMA-smooths the delivery rate and re-plans
    K = ceil(K0 · rate), clipped to [k_min, K0]. ``trace`` records the
    (round_idx, K) decisions."""

    def __init__(self, k_min: int = 1, ema: float = 0.5):
        if k_min < 1:
            raise ValueError(f"AdaptiveQuorum k_min must be >= 1, "
                             f"got {k_min}")
        self.k_min = int(k_min)
        self.ema = ema
        self.k0: Optional[int] = None
        self.rate: Optional[float] = None      # EMA'd delivery rate
        self.trace: List[Tuple[int, int]] = []

    def bind(self, sfl) -> None:
        if self.k0 is None:
            if sfl.quorum <= 0:
                raise ValueError(
                    "AdaptiveQuorum needs a finite initial quorum "
                    "(sfl.quorum > 0): K0 anchors the [k_min, K0] range")
            self.k0 = int(sfl.quorum)

    def state_dict(self) -> Dict[str, Any]:
        return {"k0": self.k0, "rate": self.rate}

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        self.k0 = d.get("k0")
        self.rate = d.get("rate")

    def update(self, round_idx, window, metrics):
        if window is None or self.k0 is None:
            return {}
        recs = [r for r in getattr(window, "telemetry", ()) or ()
                if r.source == "sim"]
        started = sum(r.started for r in recs)
        if not started:                  # no sink, or no dispatch counted
            return {}
        dropped = sum(r.crashed + r.lost + r.corrupt + r.evicted
                      for r in recs)
        obs = max(0.0, 1.0 - dropped / started)
        self.rate = (obs if self.rate is None
                     else self.ema * obs + (1.0 - self.ema) * self.rate)
        k = int(np.clip(int(np.ceil(self.k0 * self.rate)),
                        self.k_min, self.k0))
        self.trace.append((round_idx, k))
        return {"quorum": k}


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


def _stack_sparse_chunk(batch_fn, r0: int, start_clients: np.ndarray,
                        device, subset_fn=None) -> List[Dict]:
    """A sparse chunk's device batches, one (K, ...) dict a version: the
    starting clients' rows of that round's batch (a pad, -1, re-reads
    client 0; its record lands in the ring's dropped pad slot).
    ``subset_fn(round, client_ids)`` (``FederatedLoader.subset_batch``)
    materialises only those K rows on the host, bit-exact with the
    gather."""
    out = []
    for j in range(start_clients.shape[0]):
        idx = np.clip(start_clients[j], 0, None)
        host = (subset_fn(r0 + j, idx) if subset_fn is not None
                else {k: np.asarray(v)[idx]
                      for k, v in batch_fn(r0 + j).items()})
        out.append(to_device_batch(host, device))
    return out


def _has_state(state) -> bool:
    return bool(tree.path_leaves(state))


def _ckpt_tree(params, state):
    """What the engine checkpoints: params alone for stateless algorithms
    (the reference's params-only checkpoints), else a {'params','state'}
    bundle so resume is exact for stateful algorithms (GAS's activation
    buffer, FedLoRA's adapters)."""
    return {"params": params, "state": state} if _has_state(state) else params


def restore_run(checkpointer, algorithm: Union[str, Algorithm],
                cfg: ModelConfig, sfl: SFLConfig, params: Params,
                batch_fn: Callable[[int], Batch], *,
                step: Optional[int] = None,
                **algo_opts) -> Tuple[Params, State, dict]:
    """Restore an engine checkpoint for resume: (params, state, meta), the
    leaves on the device ``params`` lie on.

    A checkpoint with the {'params','state'} bundle restores the engine
    state too (its template is the algorithm's init_state on the first
    resumed round's batch); a params-only one returns state=None, and
    run_rounds then initialises the state from that batch. Continue with
    ``run_rounds(..., state=state, start_round=meta['step'] + 1)``; a run
    with a controller also passes meta through ``apply_resume_overrides``.
    step=None takes the latest checkpoint that verifies.
    """
    algo = get_algorithm(algorithm, **algo_opts)
    checkpointer.wait()
    meta = read_meta(checkpointer.dir, step)
    start = meta["step"] + 1
    if meta.get("metadata", {}).get("has_state"):
        device = tree.leaves(params)[0].device
        state = algo.init_state(cfg, sfl, params,
                                to_device_batch(batch_fn(start), device))
        bundle, meta = checkpointer.restore(
            {"params": params, "state": state}, meta["step"])
        return bundle["params"], bundle["state"], meta
    params, meta = checkpointer.restore(params, meta["step"])
    return params, None, meta


def apply_resume_overrides(sfl: SFLConfig, meta: dict,
                           controller: Optional[Controller] = None
                           ) -> SFLConfig:
    """Re-apply a resumed run's controller decisions: the SFLConfig fields
    the controller had overridden by the save (metadata
    'controller_overrides') onto ``sfl``, and the controller's own state
    (metadata 'controller_state', through its load_state_dict), so the run
    goes on at the adapted τ and learning rates with the controller's EMA
    intact instead of restarting from the flags. A restored 'deadline'
    needs no new schedule: run_rounds re-derives the deadline masks from
    the schedule's delay rows when sfl.deadline differs from the
    schedule's."""
    md = meta.get("metadata", {})
    overrides = md.get("controller_overrides") or {}
    if overrides:
        sfl = dataclasses.replace(sfl, **overrides)
    cs = md.get("controller_state")
    if controller is not None and cs and hasattr(controller,
                                                 "load_state_dict"):
        controller.load_state_dict(cs)
    return sfl


def _segments(start: int, rounds: int, chunk_size: int,
              ckpt_every: int) -> List[Tuple[int, int]]:
    """Chunks of at most ``chunk_size`` rounds from ``start``, cut at every
    multiple of ``ckpt_every``."""
    out, r = [], start
    while r < rounds:
        C = min(chunk_size, rounds - r)
        if ckpt_every:
            C = min(C, ckpt_every - r % ckpt_every)
        out.append((r, r + C))
        r += C
    return out


def _with_deadline(schedule, deadline: float):
    """``schedule`` with its deadline and consumed masks re-derived from its
    delay rows for ``deadline``."""
    nd = np.stack([strag.deadline_mask(d, deadline)
                   for d in schedule.delays])
    return dataclasses.replace(schedule, deadline=nd,
                               masks=schedule.participation * nd)


def _json_value(v):
    """A controller override as a JSON value (numpy scalars as Python's)."""
    return v.item() if isinstance(v, np.generic) else v


FAULT_COLS = ("started", "evicted", "crashed", "lost", "corrupt", "dups",
              "retries", "timeouts")


def run_rounds(algorithm: Union[str, Algorithm], cfg: ModelConfig,
               sfl: SFLConfig, params: Params, batch_fn: Callable[[int], Batch],
               schedule: strag.Schedule, key, *, rounds: int,
               start_round: int = 0, chunk_size: int = 8,
               mode: str = "scan", state: Optional[State] = None,
               checkpointer=None, ckpt_every: int = 0,
               chunk_callback: Optional[Callable] = None,
               controller: Optional[Controller] = None,
               tau_history: Optional[List[int]] = None,
               quorum_history: Optional[List[int]] = None,
               batch_subset_fn: Optional[Callable] = None,
               telemetry: Optional[TelemetrySink] = None,
               **algo_opts) -> EngineResult:
    """Run rounds [start_round, rounds) of ``algorithm`` on the device the
    parameters lie on.

    batch_fn(r) returns round r's host batch (leaves with a leading M dim;
    stateless in r, so a resumed run sees the same data). ``schedule``
    gives the (R, M) delay and mask rows (cyclic if shorter than the run)
    and the wall-clock knobs; ``key`` is the run's raw base key, and round
    r uses fold_in(key, r). ``state`` is the algorithm's state at
    start_round (None: init_state on batch_fn(start_round)). Rounds go in
    segments of ``chunk_size``, cut at every multiple of ``ckpt_every``;
    at each segment's start ``controller`` may override SFLConfig fields
    for the remaining rounds ('tau' re-plans the server steps and the
    simulated round times, 'deadline' re-derives the deadline masks from
    the schedule's delay rows, 'quorum' the async commit quorum). mode
    'scan' flushes the metrics to the host (and runs
    ``chunk_callback(ChunkInfo, params, state)``) once a segment; mode
    'python' once a round, with a one-round ChunkInfo, while the
    controller still sees the whole segment's. Masks, simulated round
    times and the τ trace always reflect what ran; their rows, the metrics
    and EngineResult cover rounds [start_round, rounds), and ChunkInfo,
    telemetry records and controller windows carry absolute round
    numbers.

    mode 'async' is the semi-async event engine (core/events.py), flushed
    once a segment as 'scan': each round is one quorum-committed server
    version (sfl.quorum, sfl.staleness_discount), the in-flight record
    store is the state, the masks are the normalized staleness-discounted
    apply weights, and the round times are the timeline's
    commit-to-commit durations; it needs an algorithm with
    ``async_round_fn`` (async_mu_splitfed). With quorum 0 and discount 1.0
    it reproduces mode 'scan'. sfl.timeline picks the backend: 'dense'
    compiles the whole (V, M) timeline from version 0 and slices it from
    start_round; 'sparse' streams (chunk, k_max) commit batches from the
    heap DES (skipped to start_round on a resume) over a bounded ring
    store (events.resolve_store_geometry), and stages only the starting
    clients' batch rows, through ``batch_subset_fn(round, client_ids)``
    when given (``FederatedLoader.subset_batch``). ``sfl.faults`` (a
    core/faults.py FaultPlan) perturbs the event stream and
    ``sfl.quorum_timeout`` caps a commit's wait; the fault counters reach
    the 'sim' telemetry records. ``tau_history`` / ``quorum_history``
    (the checkpoint metadata's 'tau_per_version' / 'quorum_per_version')
    replay a resumed controller run's per-version τ and quorum onto the
    timeline's prefix.

    ``checkpointer`` (a ``ckpt.Checkpointer``) saves at step = the last
    round of a segment that ends on a multiple of ``ckpt_every`` ('python'
    mode: after such a round), and at rounds - 1, blocking, with the last
    round's loss. The tree is the params, or {'params','state'} for a
    stateful algorithm; the metadata records 'has_state' and, with a
    controller, its overrides so far ('controller_overrides'), its
    state_dict ('controller_state') and, in mode 'async', the per-version
    τ and quorum. Resume with ``restore_run``, ``apply_resume_overrides``
    and start_round = step + 1. As in the reference, a resumed run's first
    boundary gives the controller no window, so it keeps the restored τ.
    Unlike the reference, a resumed synchronous run whose ``sfl.deadline``
    (a restored override) differs from the deadline ``schedule`` was drawn
    with re-derives the deadline masks from the schedule's delay rows
    before its first round (an async run compiles its timeline from
    version 0 and keeps the schedule's masks, as the reference does).

    ``telemetry`` (an ``obs.TelemetrySink``) turns on both producers: a
    'sim' record at every flush (durations bit-identical to
    ChunkInfo.round_times, per-cohort arrival latencies, async quorum
    waits and fault counters) and one 'measured' record a segment (in
    'scan' and 'async' the host staging seconds and bytes, and the
    dispatch seconds up to a ``torch.cuda.synchronize``, with the sparse
    stream's prefetch of the next chunk inside them as overlap_seconds; in
    'python' the segment's seconds, its per-round flushes being the
    synchronises). Controllers see the window's records in
    ``SchedWindow.telemetry``. With telemetry=None no clock is read and
    no extra synchronise happens. Spans ``engine.compile_timeline``,
    ``engine.des_take``, ``engine.stage``, ``engine.dispatch``,
    ``engine.des_prefetch`` and ``engine.flush`` go to the installed
    ``obs.trace`` tracer.
    """
    algo = get_algorithm(algorithm, **algo_opts)
    if mode not in ("scan", "python", "async"):
        raise ValueError(f"run_rounds: mode must be 'scan'|'python'|'async', "
                         f"got {mode!r}")
    if mode == "async" and not hasattr(algo, "async_round_fn"):
        raise ValueError(
            f"mode='async' needs an async-capable algorithm (e.g. "
            f"'async_mu_splitfed'); {algo.name!r} has no async_round_fn")
    if sfl.timeline not in ("dense", "sparse"):
        raise ValueError(f"run_rounds: sfl.timeline must be 'dense'|"
                         f"'sparse', got {sfl.timeline!r}")
    sparse = sfl.timeline == "sparse"
    if sparse and mode != "async":
        raise ValueError(
            "timeline='sparse' is the streaming semi-async path; run it "
            "with mode='async' (the sync modes scan dense schedule rows)")
    if sparse and not hasattr(algo, "async_sparse_round_fn"):
        raise ValueError(f"timeline='sparse' needs an algorithm with "
                         f"async_sparse_round_fn; {algo.name!r} has none")
    if batch_subset_fn is not None and not sparse:
        raise ValueError(
            "batch_subset_fn is the sparse timeline's O(K) staging hook; "
            "the dense modes consume fleet-width batches — set "
            "sfl.timeline='sparse' (with mode='async') to use it")
    n_run = rounds - start_round
    if n_run <= 0:
        empty = np.zeros((0,), np.float64)
        return EngineResult(params, state if state is not None else (), {},
                            empty, empty, 0.0, np.zeros((0,), np.int64))
    device = tree.leaves(params)[0].device
    if state is None:
        # the subset path never builds a fleet-width batch, not even for
        # the state template (the ring store is sized from sfl)
        batch0 = (batch_subset_fn(start_round, np.zeros(1, np.int64))
                  if batch_subset_fn is not None else batch_fn(start_round))
        state = algo.init_state(cfg, sfl, params,
                                to_device_batch(batch0, device))
    tele = telemetry is not None
    is_async = mode == "async"

    R = schedule.n_rounds
    sched_eff = schedule            # re-derived on a controller's deadline
    if start_round > 0 and not is_async:    # a restored deadline override
        resumed = _with_deadline(schedule, sfl.deadline)
        if not np.array_equal(resumed.deadline, schedule.deadline):
            sched_eff = resumed
    rows = range(start_round, rounds)
    # the schedule's own masks set the sync round times and what a
    # controller observes (the sparse timeline never builds them: its
    # windows rebuild rows from the mask epochs); the algorithm's
    # round_mask rows (async: the apply weights) are what its rounds
    # consume and what weights their losses. Row i is round start_round + i.
    time_masks = (None if sparse else
                  np.stack([sched_eff.masks[r % R] for r in rows]))
    timeline: Optional[events.Timeline] = None
    stream: Optional[events.TimelineStream] = None
    start_masks = qwaits = fcounts = None
    if is_async:
        # per-version τ and quorum over the whole run; a resumed controller
        # run replays the values that ran onto the prefix (the DES is only
        # prefix-stable if the prefix is compiled with them)
        taus_v = np.full(rounds, sfl.tau, np.int64)
        quorums_v = np.full(rounds, sfl.quorum, np.int64)
        for arr, hist in ((taus_v, tau_history), (quorums_v, quorum_history)):
            if hist is not None:
                h = np.asarray(hist, np.int64)[:rounds]
                arr[:len(h)] = h
        if sparse:
            k_geo, cap_geo = events.resolve_store_geometry(sfl)
            # deadline re-plans append (from_version, schedule) epochs
            mask_epochs: List[Tuple[int, strag.Schedule]] = [(0, sched_eff)]

            def mask_row_at(v: int) -> np.ndarray:
                sch = mask_epochs[0][1]
                for v0, cand in mask_epochs:
                    if v >= v0:
                        sch = cand
                return sch.masks[v % R]

            def new_stream(skip_to: int) -> events.TimelineStream:
                st = events.TimelineStream(
                    sched_eff, rounds, quorum=sfl.quorum,
                    discount=sfl.staleness_discount, taus=taus_v,
                    k_max=k_geo, capacity=cap_geo, mask_row_fn=mask_row_at,
                    quorums=quorums_v, faults=sfl.faults,
                    quorum_timeout=sfl.quorum_timeout,
                    max_retries=sfl.max_retries)
                st.skip(skip_to)
                return st

            stream = new_stream(start_round)
            masks = np.zeros((n_run, k_geo), np.float32)
            round_times = np.zeros(n_run, np.float64)
            qwaits = np.zeros(n_run, np.float64)
            fcounts = np.zeros((n_run, len(FAULT_COLS)), np.int64)
        else:
            amask_rows = np.stack([sched_eff.masks[v % R]
                                   for v in range(rounds)])

            def compile_timeline() -> events.Timeline:
                return events.compile_timeline(
                    sched_eff, rounds, quorum=quorums_v,
                    discount=sfl.staleness_discount, tau=taus_v,
                    mask_rows=amask_rows, faults=sfl.faults,
                    quorum_timeout=sfl.quorum_timeout,
                    max_retries=sfl.max_retries)

            with span("engine.compile_timeline", versions=rounds):
                timeline = compile_timeline()
            masks = timeline.apply_w[start_round:rounds].copy()
            start_masks = timeline.start_mask[start_round:rounds].copy()
            round_times = timeline.durations[start_round:rounds].copy()
    else:
        masks = np.stack([algo.round_mask(sched_eff, r) for r in rows])
        round_times = np.array([algo.time_model(sched_eff.delays[r % R],
                                                time_masks[i], sfl, sched_eff)
                                for i, r in enumerate(rows)])
    tau_used = np.full(n_run, sfl.tau, np.int64)
    segments = _segments(start_round, rounds, chunk_size, ckpt_every)
    cohort_bounds = events._cohort_bounds_of(schedule)

    if controller is not None and hasattr(controller, "bind"):
        controller.bind(sfl)

    chunks: List[Dict[str, np.ndarray]] = []
    last_info: Optional[ChunkInfo] = None
    applied: Dict[str, Any] = {}    # controller overrides in effect

    def ckpt_meta(**extra):
        md = {"has_state": _has_state(state), **extra}
        if controller is not None:
            if applied:             # JSON values
                md["controller_overrides"] = {k: _json_value(v)
                                              for k, v in applied.items()}
            if hasattr(controller, "state_dict"):
                md["controller_state"] = controller.state_dict()
            if is_async:
                md["tau_per_version"] = [int(t) for t in taus_v]
                md["quorum_per_version"] = [int(q) for q in quorums_v]
        return md

    def save(step, block=False, **extra):
        checkpointer.save(step, _ckpt_tree(params, state),
                          metadata=ckpt_meta(**extra), block=block)

    def chunk_info(host, r0, r1):
        i0, i1 = r0 - start_round, r1 - start_round
        m = masks[i0:i1]
        rl = ((host["loss"] * m).sum(1)
              / np.maximum(m.sum(1), 1.0)).astype(np.float64)
        return ChunkInfo(r0, r1, host, m, rl, round_times[i0:i1])

    def seg_info(r0, r1):
        seg = chunks[-(r1 - r0):]
        return chunk_info({k2: np.concatenate([c[k2] for c in seg])
                           for k2 in seg[0]}, r0, r1)

    def cohort_arrival(r0, r1):
        """Per-cohort mean arrival latency (delay + uplink) of the
        window's active clients (None on the sparse timeline, which never
        builds fleet-width rows)."""
        if sparse:
            return None
        arr = (np.stack([sched_eff.delays[rr % R] for rr in range(r0, r1)])
               + events._comm_of(sched_eff)[None, :])
        m = time_masks[r0 - start_round:r1 - start_round]
        out = np.zeros(len(cohort_bounds), np.float64)
        for ci, (cs, ce) in enumerate(cohort_bounds):
            w = m[:, cs:ce]
            tot = w.sum()
            out[ci] = float((arr[:, cs:ce] * w).sum() / tot) if tot else 0.0
        return out

    def sim_record(r0, r1) -> RoundTelemetry:
        """The simulator's record: durations the same slice ChunkInfo
        carries, quorum waits the same rows a controller window reads."""
        i0, i1 = r0 - start_round, r1 - start_round
        qw, counts = None, {}
        if sparse:
            qw = qwaits[i0:i1].copy()
            counts = {f: int(fcounts[i0:i1, j].sum())
                      for j, f in enumerate(FAULT_COLS)}
        elif is_async:
            qw = timeline.quorum_wait[r0:r1].copy()
            for f in FAULT_COLS:
                col = getattr(timeline, f, None)
                if col is not None:
                    counts[f] = int(col[r0:r1].sum())
        return RoundTelemetry(r0, r1, "sim", mode,
                              round_times[i0:i1].copy(), quorum_wait=qw,
                              cohort_arrival=cohort_arrival(r0, r1),
                              **counts)

    def flush(mets, r0, r1):
        """The metrics of rounds [r0, r1) reach the host (a synchronise)."""
        nonlocal last_info
        host = {k: torch.stack([m[k] for m in mets]).cpu().numpy()
                for k in mets[0]}
        chunks.append(host)
        last_info = chunk_info(host, r0, r1)
        if tele:
            telemetry.emit(sim_record(r0, r1))
        if chunk_callback is not None:
            chunk_callback(last_info, params, state)

    def controller_step(seg_idx):
        """Apply the controller's overrides for rounds >= this segment and
        re-derive the masks and simulated times they change. In async mode
        the future of the timeline is recompiled (the DES is prefix-stable,
        so the versions already run are untouched)."""
        nonlocal sfl, sched_eff, timeline, stream, state
        r0 = segments[seg_idx][0]
        window = None
        if seg_idx > 0:
            p0, p1 = segments[seg_idx - 1]
            i0, i1 = p0 - start_round, p1 - start_round
            if sparse:
                wmasks = np.stack([mask_row_at(rr) for rr in range(p0, p1)])
                qw = qwaits[i0:i1].copy()
            else:
                wmasks = time_masks[i0:i1]
                qw = (timeline.quorum_wait[p0:p1].copy()
                      if timeline is not None else None)
            window = SchedWindow(
                p0, p1,
                np.stack([sched_eff.delays[rr % R] for rr in range(p0, p1)]),
                wmasks, sched_eff.t_server, sched_eff.t_comm, qw,
                telemetry=telemetry.window(p0, p1) if tele else ())
        upd = controller.update(r0, window, last_info) or {}
        changed = {k: v for k, v in upd.items() if getattr(sfl, k) != v}
        if not changed:
            return
        if is_async and "staleness_discount" in changed:
            raise ValueError(
                "controllers cannot override staleness_discount mid-run: "
                "already-applied records carry its weights, so the "
                "timeline is not prefix-stable under that change")
        if sparse and "quorum" in changed:
            # the ring geometry was resolved from the initial config and
            # is baked into the store's shape; pin it so the new quorum
            # cannot re-derive another k_max/capacity under the autos
            if sfl.k_max != k_geo:
                changed["k_max"] = k_geo
            if sfl.ring_capacity != cap_geo:
                changed["ring_capacity"] = cap_geo
        applied.update(changed)
        sfl = dataclasses.replace(sfl, **changed)
        i = r0 - start_round
        if "deadline" in changed:
            sched_eff = _with_deadline(sched_eff, sfl.deadline)
            if sparse:
                mask_epochs.append((r0, sched_eff))
            else:
                for j in range(i, n_run):
                    time_masks[j] = sched_eff.masks[(start_round + j) % R]
            if not is_async:
                for j in range(i, n_run):
                    masks[j] = algo.round_mask(sched_eff, start_round + j)
        if is_async:
            if {"tau", "deadline", "quorum"} & set(changed):
                # versions >= r0 take the new values; the prefix keeps
                # what it ran with
                taus_v[r0:] = sfl.tau
                quorums_v[r0:] = sfl.quorum
                if sparse:
                    stream = new_stream(r0)
                else:
                    amask_rows[r0:] = np.stack(
                        [sched_eff.masks[v % R] for v in range(r0, rounds)])
                    timeline = compile_timeline()
                    masks[i:] = timeline.apply_w[r0:rounds]
                    start_masks[i:] = timeline.start_mask[r0:rounds]
                    round_times[i:] = timeline.durations[r0:rounds]
            if "tau" in changed:
                state = events.resize_store(state, sfl.tau)
        else:
            for j in range(i, n_run):
                round_times[j] = algo.time_model(
                    sched_eff.delays[(start_round + j) % R], time_masks[j],
                    sfl, sched_eff)
        tau_used[i:] = sfl.tau

    def one_round(rr, batch, sparse_rows=None, j=0):
        nonlocal params, state
        i = rr - start_round
        k = prng.fold_in(key, rr)
        if sparse_rows is not None:
            params, state, met = algo.async_sparse_round_fn(
                cfg, sfl, params, state, batch, sparse_rows.start_client[j],
                sparse_rows.start_slot[j], sparse_rows.apply_slot[j],
                masks[i], k)
        elif is_async:
            params, state, met = algo.async_round_fn(
                cfg, sfl, params, state, batch, start_masks[i], masks[i], k)
        else:
            params, state, met = algo.round_fn(
                cfg, sfl, params, state, batch,
                torch.from_numpy(masks[i]).to(device), k)
        return met

    pending_rows: Optional[events.SparseRows] = None
    for si, (r0, r1) in enumerate(segments):
        if controller is not None:
            controller_step(si)
        C = r1 - r0
        if mode == "python":
            t_seg = perf_counter() if tele else 0.0
            for rr in range(r0, r1):
                flush([one_round(rr, to_device_batch(batch_fn(rr), device))],
                      rr, rr + 1)
                if (checkpointer is not None and ckpt_every
                        and (rr + 1) % ckpt_every == 0 and rr + 1 < rounds):
                    save(rr)
            if tele:    # the per-round flushes above are the synchronises
                dt = perf_counter() - t_seg
                telemetry.emit(RoundTelemetry(
                    r0, r1, "measured", mode, np.full(C, dt / C),
                    dispatch_seconds=dt))
            if controller is not None and C > 1:
                last_info = seg_info(r0, r1)
            continue
        i = r0 - start_round
        t_host = perf_counter() if tele else 0.0
        rows_c, overlap = None, 0.0
        if sparse:
            with span("engine.des_take", start=r0, stop=r1):
                rows_c = (pending_rows if pending_rows is not None
                          else stream.take(C))
            pending_rows = None
            masks[i:i + C] = rows_c.apply_w
            round_times[i:i + C] = rows_c.durations
            qwaits[i:i + C] = rows_c.quorum_wait
            for j, f in enumerate(FAULT_COLS):
                fcounts[i:i + C, j] = getattr(rows_c, f)
            with span("engine.stage", start=r0, stop=r1):
                staged = _stack_sparse_chunk(batch_fn, r0,
                                             rows_c.start_client, device,
                                             batch_subset_fn)
        else:
            with span("engine.stage", start=r0, stop=r1):
                staged = [to_device_batch(batch_fn(rr), device)
                          for rr in range(r0, r1)]
        t_disp = perf_counter() if tele else 0.0
        with span("engine.dispatch", start=r0, stop=r1):
            mets = [one_round(rr, b, rows_c, j)
                    for j, (rr, b) in enumerate(zip(range(r0, r1), staged))]
            if sparse and controller is None and si + 1 < len(segments):
                # the DES makes the next chunk's rows while the device runs
                # this one (a controller run cannot: the next boundary may
                # rebuild the stream)
                n0, n1 = segments[si + 1]
                t_pre = perf_counter() if tele else 0.0
                with span("engine.des_prefetch", start=n0, stop=n1):
                    pending_rows = stream.take(n1 - n0)
                if tele:
                    overlap = perf_counter() - t_pre
        if tele:
            _synchronize(device)
            t_sync = perf_counter()
            telemetry.emit(RoundTelemetry(
                r0, r1, "measured", mode, np.full(C, (t_sync - t_disp) / C),
                staging_seconds=t_disp - t_host,
                staging_bytes=sum(t.nbytes for b in staged
                                  for t in b.values()),
                dispatch_seconds=t_sync - t_disp, overlap_seconds=overlap))
        with span("engine.flush", start=r0, stop=r1):
            flush(mets, r0, r1)
        if (checkpointer is not None and ckpt_every
                and r1 % ckpt_every == 0 and r1 < rounds):
            save(r1 - 1)

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
    if checkpointer is not None:
        save(rounds - 1, block=True, loss=float(round_loss[-1]))
    return EngineResult(params, state, metrics, round_loss, round_times,
                        float(round_times.sum()), tau_used)
