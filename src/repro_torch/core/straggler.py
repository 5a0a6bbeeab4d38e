"""Straggler system model: device heterogeneity, wall-clock simulation,
deadline-based participation, and the paper's τ-planner.

(A copy of ``repro.core.straggler``, which is pure numpy: the port keeps
its own so that it imports nothing of the JAX package. Schedules are
bit-identical to the reference's, tests/test_torch_engine.py.)

The paper (§5) simulates heterogeneity by sampling per-client computation
time from an exponential distribution; Eq. 12 shows that with
τ = t_straggler / t_server the total time T₀·t_straggler/τ = T₀·t_server
becomes independent of the straggler. This module reproduces that system
model and exposes it to the trainer as *data* (delays, masks) — the jit'd
round math never blocks on it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.population import (AvailRow, ClientPopulation, Cohort,
                                   DelayModel, parse_population)

__all__ = [
    "DelayModel", "Cohort", "ClientPopulation", "parse_population",
    "AvailRow", "Schedule", "SparseSchedule", "make_schedule",
    "make_schedule_stream", "make_sparse_schedule", "participation_mask",
    "deadline_mask", "median_fresh_mask", "plan_tau",
    "round_time_mu_splitfed", "round_time_vanilla", "round_time_gas",
    "round_time_local_only", "WallClock", "simulate_total_time",
]


def participation_mask(rng: np.random.Generator, n_clients: int,
                       fraction: float) -> np.ndarray:
    """Random partial participation (paper: 50%). Always >=1 active."""
    k = max(1, int(round(fraction * n_clients)))
    idx = rng.choice(n_clients, size=k, replace=False)
    m = np.zeros((n_clients,), np.float32)
    m[idx] = 1.0
    return m


def deadline_mask(delays: np.ndarray, deadline: float) -> np.ndarray:
    """Drop clients slower than the deadline (straggler mitigation knob)."""
    if deadline <= 0:
        return np.ones_like(delays, np.float32)
    m = (delays <= deadline).astype(np.float32)
    if m.sum() == 0:                       # never drop everyone
        m[np.argmin(delays)] = 1.0
    return m


def median_fresh_mask(delays: np.ndarray) -> np.ndarray:
    """GAS freshness rule (Fig. 2 protocol): clients at or below the
    per-round median delay deliver in time; the rest are served from the
    stale activation buffer. delays: (M,) or (R, M); returns same shape."""
    d = np.asarray(delays, np.float64)
    med = np.median(d, axis=-1, keepdims=True)
    return (d <= med).astype(np.float32)


def plan_tau(t_straggler: float, t_server: float, tau_max: int = 64) -> int:
    """Paper Eq. 12: τ* = t_straggler / t_server (clipped, >=1)."""
    return int(np.clip(round(t_straggler / max(t_server, 1e-9)), 1, tau_max))


# ---------------------------------------------------------------------------
# precomputed schedules: the system model as (R, M) data
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Schedule:
    """The full system-model trace for an R-round run, precomputed on host.

    The engine (core/engine.py) scans these rows as *data* — the jit'd
    round math never blocks on the host simulator. All arrays are (R, M):

      delays         per-round client compute times (seconds, simulated)
      participation  0/1 availability·participation draw (per cohort)
      deadline       0/1 deadline survivors (all-ones when deadline <= 0)
      masks          participation * deadline — what the round consumes
      fresh_median   GAS freshness rule (<= per-round median delay)

    t_server / t_gen / t_comm are the scalar wall-clock model knobs; the
    per-algorithm round-time models read them through this object.
    ``t_comm_scale`` ((M,), optional) carries per-client uplink multipliers
    from a heterogeneous population — ``comm_for(mask)`` charges the round
    the slowest *active* link; ``population`` records the fleet spec the
    schedule was sampled from.
    """
    delays: np.ndarray
    participation: np.ndarray
    deadline: np.ndarray
    masks: np.ndarray
    fresh_median: np.ndarray
    seed: int = 0
    t_server: float = 0.1
    t_gen: float = 0.0
    t_comm: float = 0.0
    t_comm_scale: Optional[np.ndarray] = None
    population: Optional[ClientPopulation] = None

    @property
    def n_rounds(self) -> int:
        return self.delays.shape[0]

    @property
    def n_clients(self) -> int:
        return self.delays.shape[1]

    def row(self, r: int) -> Tuple[np.ndarray, np.ndarray]:
        """(delays, mask) for absolute round r (cyclic past n_rounds)."""
        i = r % self.n_rounds
        return self.delays[i], self.masks[i]

    def comm_for(self, mask: np.ndarray) -> float:
        """Per-round communication time under ``mask``: t_comm scaled by the
        slowest active client's uplink (uniform fleets: just t_comm)."""
        if self.t_comm_scale is None or self.t_comm == 0.0:
            return self.t_comm
        active = self.t_comm_scale[np.asarray(mask) > 0]
        return self.t_comm * (float(active.max()) if active.size else 1.0)


def make_schedule(seed: int, n_rounds: int, n_clients: Optional[int] = None,
                  *,
                  population: Optional[ClientPopulation] = None,
                  delay_model: Optional[DelayModel] = None,
                  straggler_scale: float = 0.0,
                  participation: float = 1.0,
                  deadline: float = 0.0,
                  t_server: float = 0.1,
                  t_gen: float = 0.0,
                  t_comm: float = 0.0) -> Schedule:
    """Precompute the whole system-model trace as stacked (R, M) arrays.

    The fleet is a ClientPopulation: delays, availability (iid draws or
    Markov up/down chains), and participation are sampled per cohort. The
    legacy scalar knobs (``delay_model``/``straggler_scale``/
    ``participation``) are the deprecated single-cohort shorthand — they
    resolve to ``ClientPopulation.single`` and, because the per-cohort
    sampler consumes the RNG in the historical order (delay draw first,
    only when stochastic, then the participation draw, cohort by cohort),
    a single-iid-cohort population reproduces the old per-round scalar
    path bit-for-bit (tests/test_engine.py + tests/test_population.py pin
    this). Deterministic in (seed, n_rounds, population, knobs).
    """
    population = _resolve_population(population, n_clients, delay_model,
                                     straggler_scale, participation)
    M = population.n_clients
    chunks = list(make_schedule_stream(
        seed, n_rounds, population=population, deadline=deadline,
        t_server=t_server, t_gen=t_gen, t_comm=t_comm))

    def cat(field, dtype, width=M):
        if not chunks:
            return np.zeros((0, width), dtype)
        return np.concatenate([getattr(c, field) for c in chunks])

    return Schedule(delays=cat("delays", np.float64),
                    participation=cat("participation", np.float32),
                    deadline=cat("deadline", np.float32),
                    masks=cat("masks", np.float32),
                    fresh_median=cat("fresh_median", np.float32),
                    seed=seed, t_server=t_server, t_gen=t_gen, t_comm=t_comm,
                    t_comm_scale=(None if population.uniform_comm
                                  else population.t_comm_scales()),
                    population=population)


def _resolve_population(population, n_clients, delay_model, straggler_scale,
                        participation) -> ClientPopulation:
    if population is None:
        if n_clients is None:
            raise ValueError("make_schedule: pass n_clients or population")
        return ClientPopulation.single(
            n_clients,
            delay=delay_model or DelayModel(base=1.0, scale=straggler_scale),
            participation=participation)
    if n_clients is not None and n_clients != population.n_clients:
        raise ValueError(f"n_clients={n_clients} != population's "
                         f"{population.n_clients}")
    return population


def make_schedule_stream(seed: int, n_rounds: int,
                         n_clients: Optional[int] = None,
                         *,
                         population: Optional[ClientPopulation] = None,
                         delay_model: Optional[DelayModel] = None,
                         straggler_scale: float = 0.0,
                         participation: float = 1.0,
                         deadline: float = 0.0,
                         t_server: float = 0.1,
                         t_gen: float = 0.0,
                         t_comm: float = 0.0,
                         chunk_rounds: int = 64,
                         lazy: bool = False):
    """Stream the system-model trace as Schedule chunks of ``chunk_rounds``
    rows each (the last chunk may be shorter).

    One shared PopulationSampler draws rows in round order — delay row
    first, then participation, cohort by cohort — so the chunked stream
    consumes the RNG exactly like the monolithic loop: concatenating the
    yielded chunks reproduces make_schedule(...) bit-for-bit. The pinning
    is structural: make_schedule IS the concatenation of this generator
    (and tests/test_population.py cross-checks odd chunk sizes). Each
    chunk is a full Schedule carrying the shared scalar knobs, so row
    consumers (the sparse TimelineStream, bench_timeline) can work on
    fleets whose full (R, M) trace would not fit on the host.

    ``lazy=True`` switches to the streaming mask protocol: yields ONE
    SparseSchedule covering all rounds — per-cohort AvailRows and keyed
    on-demand delays, nothing materialized at all, so million-client
    fleets never densify (not RNG-compatible with the dense draw; see
    SparseSchedule). Requires deadline <= 0 (a deadline needs the full
    delay row by definition).
    """
    population = _resolve_population(population, n_clients, delay_model,
                                     straggler_scale, participation)
    if lazy:
        if deadline > 0:
            raise ValueError("lazy schedules cannot apply a deadline: the "
                             "deadline mask needs every client's delay — "
                             "use the dense stream for deadline runs")
        yield SparseSchedule(seed=seed, n_rounds=n_rounds,
                             population=population, t_server=t_server,
                             t_gen=t_gen, t_comm=t_comm)
        return
    M = population.n_clients
    rng = np.random.default_rng(seed)
    sampler = population.sampler()
    t_comm_scale = (None if population.uniform_comm
                    else population.t_comm_scales())
    done = 0
    while done < n_rounds:
        C = min(int(chunk_rounds), n_rounds - done)
        delays = np.empty((C, M), np.float64)
        parts = np.empty((C, M), np.float32)
        for r in range(C):
            delays[r] = sampler.delays_row(rng)
            parts[r] = sampler.participation_row(rng)
        dead = np.stack([deadline_mask(delays[r], deadline)
                         for r in range(C)])
        yield Schedule(delays=delays, participation=parts, deadline=dead,
                       masks=parts * dead,
                       fresh_median=median_fresh_mask(delays),
                       seed=seed, t_server=t_server, t_gen=t_gen,
                       t_comm=t_comm, t_comm_scale=t_comm_scale,
                       population=population)
        done += C


# ---------------------------------------------------------------------------
# lazy fleet schedules: the streaming mask protocol (never densified)
# ---------------------------------------------------------------------------

def _mix64(x: np.ndarray) -> np.ndarray:
    """SplitMix64 finalizer, vectorized over uint64 (wrapping arithmetic).
    Counter-based keyed randomness for the lazy schedule's per-client
    draws: hashing (seed, round, client-id) costs O(ids) with a numpy-op
    constant, where a per-client Generator init would cost ~30us each —
    the difference between O(K) and O(K · rng-setup) per DES version."""
    x = x.astype(np.uint64)
    x = (x + np.uint64(0x9E3779B97F4A7C15))
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _hash_uniform(seed: int, lane: int, r: int, ids: np.ndarray) -> np.ndarray:
    """Deterministic U(0, 1) per (seed, lane, round, id), open interval."""
    key = _mix64(_mix64(np.array([seed], np.uint64) ^
                        (np.uint64(lane) << np.uint64(32))) ^ np.uint64(r))
    h = _mix64(key ^ ids.astype(np.uint64))
    return ((h >> np.uint64(11)).astype(np.float64) + 0.5) * (2.0 ** -53)


def _sample_ids(rng: np.random.Generator, n: int, k: int) -> np.ndarray:
    """k distinct ints from [0, n), sorted — O(k) when k << n (rejection
    sampling), falling back to numpy's permutation draw for dense k."""
    if k >= n:
        return np.arange(n, dtype=np.int64)
    if k > n // 2 or n < 64:
        return np.sort(rng.choice(n, size=k, replace=False)).astype(np.int64)
    seen: set = set()
    while len(seen) < k:
        for x in rng.integers(0, n, size=2 * (k - len(seen))):
            if len(seen) >= k:
                break
            seen.add(int(x))
    return np.sort(np.fromiter(seen, np.int64, len(seen)))


def _sample_from_complement(rng: np.random.Generator, n: int,
                            exclude: np.ndarray, k: int) -> np.ndarray:
    """k distinct ints from [0, n) \\ exclude (sorted ascending), sorted."""
    n_avail = n - exclude.size
    if k <= 0:
        return np.empty(0, np.int64)
    if k >= n_avail or exclude.size > n // 2 or n < 64:
        avail = np.setdiff1d(np.arange(n, dtype=np.int64), exclude,
                             assume_unique=True)
        if k >= avail.size:
            return avail
        return avail[np.sort(rng.choice(avail.size, size=k, replace=False))]
    excl = set(exclude.tolist())
    seen: set = set()
    while len(seen) < k:
        for x in rng.integers(0, n, size=2 * (k - len(seen))):
            if len(seen) >= k:
                break
            xi = int(x)
            if xi not in excl:
                seen.add(xi)
    return np.sort(np.fromiter(seen, np.int64, len(seen)))


def _markov_down_rows(rng: np.random.Generator, n: int, p_drop: float,
                      p_rec: float, n_rounds: int) -> list:
    """Per-round sorted down-sets of an n-client up/down chain, sampled by
    flip COUNTS (binomial) + uniform subset draws — distributionally
    identical to n independent per-client flips, at O(flips + |down|) per
    round instead of O(n). Starts all-up with one transition before round
    0, matching PopulationSampler."""
    down = np.empty(0, np.int64)
    rows = []
    for _ in range(n_rounds):
        n_up = n - down.size
        k_dn = int(rng.binomial(n_up, p_drop)) if n_up and p_drop > 0 else 0
        k_rc = (int(rng.binomial(down.size, p_rec))
                if down.size and p_rec > 0 else 0)
        new_down = _sample_from_complement(rng, n, down, k_dn)
        if k_rc:
            rec = np.sort(rng.choice(down.size, size=k_rc, replace=False))
            down = np.delete(down, rec)
        if new_down.size:
            down = np.sort(np.concatenate([down, new_down]))
        rows.append(down.copy())
    return rows


@dataclasses.dataclass
class SparseSchedule:
    """A lazily-sampled fleet schedule — the streaming mask protocol.

    Never materializes (R, M) rows: availability comes back as per-cohort
    AvailRows (``avail_row``) and delays are evaluated only for the
    clients a DES version actually admits (``delays_for``), each draw
    keyed on (seed, stream, round, cohort/client-id). Deterministic and
    random-access in the round index, so the sparse TimelineStream can
    consume it in place of a dense Schedule and million-client fleets
    cost O(K + availability events) per version, not O(M).

    NOT RNG-compatible with make_schedule: the dense sampler consumes one
    sequential stream (and its participation draw is O(M) even at
    fraction 1.0), so the same seed yields a different — equally valid —
    draw. Fleets whose rows are deterministic (scale-0 delays, full
    participation, no chains) are identical by construction; tests gate
    that, plus distributional agreement for the stochastic parts. Markov
    chains are precomputed per cohort at O(flips) per round (memory
    scales with outage density, not fleet size); ``deadline`` is
    unsupported here — it needs the full delay row by definition.
    """
    seed: int
    n_rounds: int
    population: ClientPopulation
    t_server: float = 0.1
    t_gen: float = 0.0
    t_comm: float = 0.0

    def __post_init__(self):
        if self.n_rounds < 1:
            raise ValueError("SparseSchedule needs n_rounds >= 1")
        self._slices = self.population.slices()
        self._bounds = [(s.start, s.stop) for s in self._slices]
        self._his = np.array([hi for _, hi in self._bounds], np.int64)
        # availability chains, precomputed per cohort (O(R) scalars for
        # shared chains; O(R · outage size) for per-client chains)
        self._shared_up: Dict[int, np.ndarray] = {}
        self._down_rows: Dict[int, list] = {}
        for i, c in enumerate(self.population.cohorts):
            if c.availability == "markov-shared":
                rng = np.random.default_rng((self.seed, 2, i))
                up, ups = True, np.empty(self.n_rounds, bool)
                for r in range(self.n_rounds):
                    u = rng.random()
                    up = (u >= c.p_dropout) if up else (u < c.p_recover)
                    ups[r] = up
                self._shared_up[i] = ups
            elif c.availability == "markov":
                rng = np.random.default_rng((self.seed, 3, i))
                self._down_rows[i] = _markov_down_rows(
                    rng, c.n, c.p_dropout, c.p_recover, self.n_rounds)

    @property
    def n_clients(self) -> int:
        return self.population.n_clients

    @property
    def t_comm_scale(self) -> Optional[np.ndarray]:
        return (None if self.population.uniform_comm
                else self.population.t_comm_scales())

    def _part_ids(self, r: int, i: int, c: Cohort) -> np.ndarray:
        """Cohort-local sorted participation draw (always >= 1 active —
        the participation_mask convention)."""
        k = max(1, int(round(c.participation * c.n)))
        rng = np.random.default_rng((self.seed, 0, r, i))
        return _sample_ids(rng, c.n, k)

    def avail_row(self, r: int) -> AvailRow:
        """This round's availability as per-cohort sparse records."""
        kinds, ids = [], []
        for i, (c, (lo, _hi)) in enumerate(
                zip(self.population.cohorts, self._bounds)):
            if c.availability == "markov-shared" and not self._shared_up[i][r]:
                kinds.append("none")
                ids.append(None)
                continue
            down = (self._down_rows[i][r] if c.availability == "markov"
                    else np.empty(0, np.int64))
            if c.participation >= 1.0:
                if down.size == 0:
                    kinds.append("all")
                    ids.append(None)
                elif down.size == c.n:
                    kinds.append("none")
                    ids.append(None)
                else:
                    kinds.append("not_ids")
                    ids.append(down + lo)
                continue
            part = self._part_ids(r, i, c)
            if down.size:
                pos = np.minimum(np.searchsorted(down, part), down.size - 1)
                part = part[down[pos] != part]
            if part.size:
                kinds.append("ids")
                ids.append(part + lo)
            else:
                kinds.append("none")
                ids.append(None)
        return AvailRow(list(self._bounds), kinds, ids)

    def delays_for(self, r: int, ids: np.ndarray) -> np.ndarray:
        """Delays for exactly ``ids`` (global, ascending), keyed
        (seed, round, id) via the counter-based hash — O(ids), vectorized,
        no per-client Generator setup. t = base·(1 + Exp(scale)) with
        Exp(scale) = -scale·ln(U), the DelayModel distribution."""
        ids = np.asarray(ids, np.int64)
        out = np.empty(ids.size, np.float64)
        coh = np.searchsorted(self._his, ids, side="right")
        u = None
        for i in np.unique(coh).tolist():
            sel = coh == i
            d = self.population.cohorts[i].delay
            if d.scale > 0:
                if u is None:
                    u = _hash_uniform(self.seed, 1, r, ids)
                out[sel] = d.base * (1.0 - d.scale * np.log(u[sel]))
            else:
                out[sel] = d.base
            if d.hetero is not None:
                h = np.asarray(d.hetero)
                out[sel] = out[sel] * h[ids[sel] - self._bounds[i][0]]
        return out


def make_sparse_schedule(seed: int, n_rounds: int,
                         n_clients: Optional[int] = None, *,
                         population: Optional[ClientPopulation] = None,
                         delay_model: Optional[DelayModel] = None,
                         straggler_scale: float = 0.0,
                         participation: float = 1.0,
                         t_server: float = 0.1, t_gen: float = 0.0,
                         t_comm: float = 0.0) -> SparseSchedule:
    """The lazy counterpart of make_schedule — same fleet/knob surface,
    but rows are sampled on demand through the streaming mask protocol
    (SparseSchedule) instead of materialized as (R, M) arrays."""
    population = _resolve_population(population, n_clients, delay_model,
                                     straggler_scale, participation)
    return SparseSchedule(seed=seed, n_rounds=n_rounds,
                          population=population, t_server=t_server,
                          t_gen=t_gen, t_comm=t_comm)


# ---------------------------------------------------------------------------
# wall-clock round-time models (per algorithm)
# ---------------------------------------------------------------------------

def round_time_mu_splitfed(client_times: np.ndarray, mask: np.ndarray,
                           t_server: float, tau: int,
                           t_comm: float = 0.0) -> float:
    """Server overlaps its τ local steps with client compute: the round ends
    when BOTH the slowest active client and the server's τ steps are done."""
    active = client_times[mask > 0]
    t_straggler = float(active.max()) if active.size else 0.0
    return max(t_straggler, tau * t_server) + t_comm


def round_time_vanilla(client_times: np.ndarray, mask: np.ndarray,
                       t_server: float, t_comm: float = 0.0) -> float:
    """Vanilla SplitFed: strictly serialized client -> server dependency."""
    active = client_times[mask > 0]
    t_straggler = float(active.max()) if active.size else 0.0
    return t_straggler + t_server + t_comm


def round_time_gas(client_times: np.ndarray, mask: np.ndarray,
                   t_server: float, t_gen: float,
                   t_comm: float = 0.0) -> float:
    """GAS-like async: proceeds at the median client's pace but pays an
    activation-generation overhead t_gen each round (paper §5 discussion)."""
    active = client_times[mask > 0]
    t_med = float(np.median(active)) if active.size else 0.0
    return t_med + t_server + t_gen + t_comm


def round_time_local_only(client_times: np.ndarray, mask: np.ndarray,
                          t_comm: float = 0.0) -> float:
    """FedAvg/FedLoRA: no split-server compute; the round is bounded by the
    slowest active client's full local pass plus the model exchange."""
    active = client_times[mask > 0]
    t_straggler = float(active.max()) if active.size else 0.0
    return t_straggler + t_comm


class WallClock:
    """Accumulates simulated time across rounds (one per algorithm run)."""

    def __init__(self) -> None:
        self.t = 0.0
        self.per_round = []

    def tick(self, dt: float) -> float:
        self.t += dt
        self.per_round.append(dt)
        return self.t


def simulate_total_time(algorithm: str, delays: np.ndarray,
                        masks: np.ndarray, t_server: float, tau: int,
                        t_gen: float = 0.0, t_comm: float = 0.0,
                        rounds_needed: Optional[int] = None) -> float:
    """Total wall-clock for ``rounds_needed`` rounds (default: all rows).

    For MU-SplitFed the τ-speedup also divides the number of rounds needed
    to converge (Cor. 4.4: T₁ = T₀/τ) — the caller passes the appropriate
    rounds_needed per algorithm; this function only sums round times.
    """
    n = rounds_needed if rounds_needed is not None else delays.shape[0]
    total = 0.0
    for r in range(n):
        row, m = delays[r % delays.shape[0]], masks[r % masks.shape[0]]
        if algorithm == "mu_splitfed":
            total += round_time_mu_splitfed(row, m, t_server, tau, t_comm)
        elif algorithm == "vanilla":
            total += round_time_vanilla(row, m, t_server, t_comm)
        elif algorithm == "gas":
            total += round_time_gas(row, m, t_server, t_gen, t_comm)
        else:
            raise ValueError(algorithm)
    return total
