"""Event-driven semi-async execution: arrival-ordered server updates with
quorum aggregation and staleness-weighted seed replay (counterpart of
``repro.core.events``).

The engine's sync modes run a hard round barrier: every server commit waits
for the full per-round mask, so one slow cohort stalls the fleet. This
module drops the barrier:

  compile_timeline   a host-side discrete-event simulator over the
                     straggler.Schedule. Clients fetch the newest params at
                     each server-version broadcast and deliver their
                     contribution delay + uplink later; the server COMMITS
                     version v+1 as soon as a quorum of K contributions has
                     arrived (FedBuff-style semi-async; K=0 means "all
                     pending", the synchronous barrier). Contributions that
                     miss the commit are not dropped: they fold into a
                     later commit with staleness s = commits missed, and a
                     discount^s weight. The product is a globally
                     arrival-ordered event stream plus its per-version
                     compiled form ((V, M) start/apply matrices and (V,)
                     commit times) that the engine runs as data.
  async_mu_splitfed_step
                     one server version on the device. Every MU-SplitFed
                     contribution is replayable seed records ((key, coeff)
                     pairs, zo.py's wire format), so the in-flight buffer
                     is an (M, τ, P) record store carried as engine state:
                     committing a quorum is one zo.replay_weighted_records
                     call with the timeline's staleness-discounted weights.

Semantics (the "semi" in semi-async): a client only fetches params and
starts a fresh contribution at a version broadcast, never mid-version; the
server commits on quorum arrival. With quorum K=0 (or K>=M) and discount
1.0 every version's buffer is the sync round's active set with the sync
weights, so mode='async' reproduces mode='scan'.

Wall-clock model: version duration = max(K-th pending arrival, τ·t_server)
(the unbalanced server steps overlap the wait, Eq. 12), where an arrival
is fetch_time + delay + t_comm·uplink_scale.

Two timeline backends share these semantics (SFLConfig.timeline):

  'dense'   compile_timeline's (V, M) rows and the (M, τ, P) per-client
            store.
  'sparse'  the streaming path (TimelineStream / SparseRows): a heap DES
            emits (V, k_max) scatter/gather commit batches chunk by chunk
            over a bounded arrival-slot ring store, so host memory is
            O(k_max · chunk) + O(M) instead of O(V · M).

The host half (everything up to the record store) is the reference's,
with one departure: ``compile_sparse_timeline`` collects the contributions
still in flight at the horizon even when no event was recorded before it
(the reference's returns an empty event stream then, for example at M=2,
V=1, quorum=1, quorum_timeout=1.0 with both arrivals past the deadline,
where its dense compiler keeps both arrivals with commit_idx -1); the
port's sparse DES follows the dense compiler.

The record store is the reference's dict with its keys, shapes and dtypes:
``srv_keys`` (lead, τ, P, 2) and ``ukey`` (lead, 2) are host numpy uint32
(keys are host values in the port, core/prng.py); ``srv_coeffs``,
``ccoeff`` and ``loss0`` are f32 tensors on the run's device. Unlike the
reference, which computes every one of the M clients (vmap) and discards
the records of those that do not start, the device steps compute only the
starting clients; the store, the params and the metrics are the same.
"""
from __future__ import annotations

import bisect
import dataclasses
import heapq
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, SFLConfig
from repro_torch.core import prng, zo
from repro_torch.core.faults import (OUT_CORRUPT, OUT_CRASH, OUT_DELIVER,
                                     OUT_LOST, STALE_CORRUPT, STALE_CRASH,
                                     STALE_LOST, ResolvedFaults)
from repro_torch.core.population import AvailRow
from repro_torch.core.splitfed import _client_round
from repro_torch.models import merge_params, split_params
from repro_torch.obs.trace import span

Params = Any

__all__ = ["Timeline", "compile_timeline", "quorum_round_time",
           "init_store", "resize_store", "async_mu_splitfed_step",
           "SparseRows", "SparseTimeline", "TimelineStream",
           "compile_sparse_timeline", "resolve_store_geometry",
           "async_mu_splitfed_sparse_step", "QuorumStallError"]


class QuorumStallError(ValueError):
    """A version's quorum can never fill and no quorum_timeout is set."""


def _resolve_faults(schedule, faults) -> Optional[ResolvedFaults]:
    """FaultPlan -> per-client rates keyed on the schedule's seed; None
    (or an inert plan) -> None, so callers can gate every fault branch on
    a single ``is not None`` and the zero-fault path stays byte-identical."""
    if faults is None:
        return None
    if isinstance(faults, ResolvedFaults):
        return faults
    if not faults.any():
        return None
    return faults.resolve(schedule.n_clients,
                          getattr(schedule, "population", None),
                          getattr(schedule, "seed", 0))


def _stall_error(v: int, n_deliverable: int, quorum: int) -> QuorumStallError:
    return QuorumStallError(
        f"quorum stall at version {v}: only {n_deliverable} deliverable "
        f"contribution(s) pending against quorum={quorum} under an active "
        "fault plan — the commit would silently under-fill forever. Set "
        "quorum_timeout (SFLConfig.quorum_timeout / --quorum-timeout) to "
        "commit with whatever arrived by the deadline, or lower the "
        "quorum/fault rates.")


# ---------------------------------------------------------------------------
# the event compiler (host-side discrete-event simulation)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Timeline:
    """A compiled semi-async execution trace.

    Flat, globally arrival-ordered event view — one row per delivered
    contribution, all (E,):

      arrival_time     absolute simulated delivery time
      client_id        which client delivered
      cohort_id        its population cohort (0 for scalar fleets)
      round_of_origin  the version whose params/batch/mask it consumed
      staleness        commits between fetch and apply (>=1 means it missed
                       its own version's quorum and folded forward)
      commit_idx       the version commit that applied it (-1: still in
                       flight when the horizon ended — never applied)

    Per-version compiled form the engine scans as data:

      start_mask   (V, M) 1.0 where a client fetches params and begins a
                   fresh contribution at this version's broadcast
      apply_w      (V, M) normalized staleness-discounted aggregation
                   weights of the records this commit applies (rows sum to
                   1, or 0 for an empty commit); 0 = not applied
      staleness_m  (V, M) staleness of the applied record (-1 = not applied)
      commit_times (V,)   absolute commit completion times
      durations    (V,)   per-version wall-clock (commit_times diffs)
      quorum_wait  (V,)   time from broadcast to the quorum arrival, BEFORE
                   the τ·t_server server floor — what an adaptive-τ
                   controller should fill with server steps (Eq. 12)
      applied      (V,)   contributions folded into each commit
    """
    arrival_time: np.ndarray
    client_id: np.ndarray
    cohort_id: np.ndarray
    round_of_origin: np.ndarray
    staleness: np.ndarray
    commit_idx: np.ndarray
    start_mask: np.ndarray
    apply_w: np.ndarray
    staleness_m: np.ndarray
    commit_times: np.ndarray
    durations: np.ndarray
    quorum_wait: np.ndarray
    applied: np.ndarray
    quorum: int
    discount: float
    tau_per_version: np.ndarray
    # fault / degradation accounting, all (V,) — zero everywhere when the
    # run had no FaultPlan (started == dispatches incl. faulted fetches;
    # timeouts flags commits forced by the quorum_timeout deadline)
    started: Optional[np.ndarray] = None
    crashed: Optional[np.ndarray] = None
    lost: Optional[np.ndarray] = None
    corrupt: Optional[np.ndarray] = None
    dups: Optional[np.ndarray] = None
    retries: Optional[np.ndarray] = None
    timeouts: Optional[np.ndarray] = None

    @property
    def n_versions(self) -> int:
        return self.start_mask.shape[0]

    @property
    def n_clients(self) -> int:
        return self.start_mask.shape[1]

    @property
    def n_events(self) -> int:
        return self.arrival_time.shape[0]


def compile_timeline(schedule, n_versions: int, *, quorum=0,
                     discount: float = 1.0, tau=1,
                     mask_rows: Optional[np.ndarray] = None,
                     faults=None, quorum_timeout: float = 0.0,
                     max_retries: int = 3) -> Timeline:
    """Compile ``n_versions`` semi-async server versions from a Schedule.

    quorum    K: commit as soon as K of the pending contributions have
              arrived (K<=0 or K>=pending: wait for all — the sync
              barrier). A commit folds in *everything* delivered by the
              commit moment, quorum members and opportunistic extras alike.
              Scalar, or a (n_versions,) array for controller-driven
              piecewise-quorum runs (AdaptiveQuorum).
    discount  staleness weight base: a contribution applied s commits after
              its fetch weighs discount**s before per-commit normalization
              (discount 1.0 = stale and fresh weigh equally).
    tau       server steps per version — scalar, or a (n_versions,) array
              for controller-driven piecewise-τ runs. The commit can never
              land before fetch + τ·t_server (unbalanced-update overlap).
    mask_rows optional (n_versions, M) availability override; defaults to
              the schedule's masks rows (cyclic). Used by the engine when a
              controller re-derives deadline drops mid-run.
    faults    FaultPlan (or pre-resolved ResolvedFaults) perturbing the
              event stream — crash-after-fetch, lossy delivery with up to
              ``max_retries`` retransmissions, duplication (deduped by
              (client, round_of_origin) — one in-flight record per client),
              checksum-dropped corruption. None / inert plan: the code
              path below is byte-identical to the pre-fault engine.
    quorum_timeout  graceful-degradation deadline: a commit with a quorum
              that hasn't filled by ``t + quorum_timeout`` proceeds with
              however many contributions arrived (weights renormalized —
              never deadlocks). With faults active, an under-fillable
              quorum and no timeout raises QuorumStallError instead of
              silently committing thin versions forever.

    Deterministic in its inputs (the schedule already froze every random
    draw; fault draws are counter-hashed on (seed, lane, version, client)),
    and prefix-stable: two compilations agreeing on the first v versions
    of (tau, quorum, mask_rows) agree on the first v rows of every output
    — which is what lets a controller recompile the future without
    rewriting the past.
    """
    R, M = schedule.delays.shape
    V = int(n_versions)
    taus = np.full(V, tau, np.int64) if np.ndim(tau) == 0 else \
        np.asarray(tau, np.int64)
    if taus.shape != (V,):
        raise ValueError(f"tau_per_version shape {taus.shape} != ({V},)")
    quorums = np.full(V, quorum, np.int64) if np.ndim(quorum) == 0 else \
        np.asarray(quorum, np.int64)
    if quorums.shape != (V,):
        raise ValueError(
            f"quorum_per_version shape {quorums.shape} != ({V},)")
    if mask_rows is None:
        mask_rows = (np.stack([schedule.masks[v % R] for v in range(V)])
                     if V else np.zeros((0, M), np.float32))
    mask_rows = np.asarray(mask_rows, np.float32)
    if mask_rows.shape != (V, M):
        raise ValueError(f"mask_rows shape {mask_rows.shape} != ({V}, {M})")
    comm = np.full(M, schedule.t_comm, np.float64)
    if schedule.t_comm_scale is not None:
        comm = schedule.t_comm * np.asarray(schedule.t_comm_scale, np.float64)
    cohorts = (schedule.population.cohort_ids()
               if getattr(schedule, "population", None) is not None
               else np.zeros(M, np.int64))
    rf = _resolve_faults(schedule, faults)

    start_mask = np.zeros((V, M), np.float32)
    apply_w = np.zeros((V, M), np.float32)
    staleness_m = np.full((V, M), -1, np.int64)
    commit_times = np.zeros(V, np.float64)
    durations = np.zeros(V, np.float64)
    quorum_wait = np.zeros(V, np.float64)
    applied_n = np.zeros(V, np.int64)
    started_n = np.zeros(V, np.int64)
    crashed_n = np.zeros(V, np.int64)
    lost_n = np.zeros(V, np.int64)
    corrupt_n = np.zeros(V, np.int64)
    dup_n = np.zeros(V, np.int64)
    retry_n = np.zeros(V, np.int64)
    timeout_n = np.zeros(V, np.int64)
    events = []                       # (arrival, client, origin, stale, commit)

    t = 0.0
    pending: Dict[int, Tuple[float, int]] = {}   # client -> (arrival, origin)
    recovering: Dict[int, float] = {}   # crashed/dropped client -> idle time
    streaks = np.zeros(M, np.int64) if rf is not None else None
    for v in range(V):
        if rf is not None and recovering:
            for m in [m for m, rdy in recovering.items() if rdy <= t]:
                del recovering[m]
        # broadcast: every idle client on this version's mask fetches the
        # just-committed params and starts a fresh contribution
        if rf is None:
            for m in range(M):
                if mask_rows[v, m] > 0 and m not in pending:
                    pending[m] = (t + schedule.delays[v % R, m] + comm[m], v)
                    start_mask[v, m] = 1.0
        else:
            starters = [m for m in range(M)
                        if mask_rows[v, m] > 0 and m not in pending
                        and m not in recovering]
            started_n[v] = len(starters)
            if starters:
                sids = np.asarray(starters, np.int64)
                f = rf.dispatch_fates(v, sids, t,
                                      schedule.delays[v % R, sids],
                                      comm[sids], streaks, max_retries)
                retry_n[v] = int(f["retries"].sum())
                dup_n[v] = int(f["dup"].sum())
                for j, m in enumerate(starters):
                    out = int(f["outcome"][j])
                    if out == OUT_DELIVER:
                        pending[m] = (float(f["arrival"][j]), v)
                        start_mask[v, m] = 1.0
                        streaks[m] = 0
                        continue
                    recovering[m] = float(f["ready"][j])
                    if out == OUT_CRASH:
                        streaks[m] += 1
                        crashed_n[v] += 1
                        events.append((t, m, v, STALE_CRASH, -1))
                    elif out == OUT_LOST:
                        streaks[m] = 0
                        lost_n[v] += 1
                        events.append((float(f["ready"][j]), m, v,
                                       STALE_LOST, -1))
                    else:                      # corrupt: checksum drop
                        streaks[m] = 0
                        corrupt_n[v] += 1
                        events.append((float(f["arrival"][j]), m, v,
                                       STALE_CORRUPT, -1))
        q_req = int(quorums[v])
        arrivals = sorted(a for a, _ in pending.values())
        k = len(arrivals) if q_req <= 0 else min(q_req, len(arrivals))
        q_arrival = arrivals[k - 1] if k else t
        if q_req > 0 and quorum_timeout > 0:
            deadline = t + quorum_timeout
            if len(arrivals) < q_req or q_arrival > deadline:
                q_arrival = deadline            # degrade: commit what came
                timeout_n[v] = 1
        elif rf is not None and q_req > 0 and len(arrivals) < q_req:
            raise _stall_error(v, len(arrivals), q_req)
        quorum_wait[v] = max(q_arrival - t, 0.0)
        c_time = max(q_arrival, t + float(taus[v]) * schedule.t_server)
        # fold in everything delivered by the commit moment
        w = np.zeros(M, np.float64)
        for m in sorted(pending):
            arr, origin = pending[m]
            if arr <= c_time:
                s = v - origin
                w[m] = discount ** s
                staleness_m[v, m] = s
                events.append((arr, m, origin, s, v))
                del pending[m]
        tot = w.sum()
        if tot > 0:
            w = w / tot
        apply_w[v] = w.astype(np.float32)
        applied_n[v] = int((w > 0).sum())
        commit_times[v] = c_time
        durations[v] = c_time - t
        t = c_time
    if rf is None:
        started_n = start_mask.sum(axis=1).astype(np.int64)
    # contributions still in flight at the horizon: delivered to nobody
    for m in sorted(pending):
        arr, origin = pending[m]
        events.append((arr, m, origin, -1, -1))

    ev = (np.array(events, np.float64) if events
          else np.zeros((0, 5), np.float64))
    order = np.lexsort((ev[:, 1], ev[:, 0]))       # arrival, then client id
    ev = ev[order]
    client_id = ev[:, 1].astype(np.int64)
    return Timeline(
        arrival_time=ev[:, 0], client_id=client_id,
        cohort_id=cohorts[client_id],
        round_of_origin=ev[:, 2].astype(np.int64),
        staleness=ev[:, 3].astype(np.int64),
        commit_idx=ev[:, 4].astype(np.int64),
        start_mask=start_mask, apply_w=apply_w, staleness_m=staleness_m,
        commit_times=commit_times, durations=durations,
        quorum_wait=quorum_wait, applied=applied_n,
        quorum=int(quorums[0]) if V else
        (0 if np.ndim(quorum) else int(quorum)),
        discount=float(discount), tau_per_version=taus,
        started=started_n, crashed=crashed_n, lost=lost_n,
        corrupt=corrupt_n, dups=dup_n, retries=retry_n, timeouts=timeout_n)


def quorum_round_time(delays: np.ndarray, mask: np.ndarray, t_server: float,
                      tau: int, quorum: int = 0, t_comm: float = 0.0,
                      t_comm_scale: Optional[np.ndarray] = None) -> float:
    """Steady-state single-version time under quorum commits: the K-th
    smallest active arrival (delay + uplink), floored by the server's
    τ·t_server. The compiled timeline is the exact account (it carries
    busy clients across versions); this is the per-row approximation an
    Algorithm.time_model can give without one."""
    comm = (np.full_like(delays, t_comm) if t_comm_scale is None
            else t_comm * np.asarray(t_comm_scale, np.float64))
    arrivals = np.sort((delays + comm)[np.asarray(mask) > 0])
    k = len(arrivals) if quorum <= 0 else min(quorum, len(arrivals))
    wait = float(arrivals[k - 1]) if k else 0.0
    return max(wait, tau * t_server)


# ---------------------------------------------------------------------------
# sparse streaming timeline: heap DES -> (V, K) commit batches over an
# arrival-slot ring store
# ---------------------------------------------------------------------------
#
# The dense compiler above materializes (V, M) rows and re-sorts the whole
# pending set every version — fine as the small-M reference, O(V·M) host
# memory and O(V·M log M) time at fleet scale. The sparse path below keeps
# the *identical* commit semantics but emits only what a commit actually
# touches: per version, the <= K clients that start (scatter indices into a
# bounded ring of record slots) and the <= K contributions that apply
# (gather indices + staleness-discounted weights). The DES itself is a
# min-heap over arrivals with lazy deletion, so a version costs
# O(M) vectorized candidate scan + O((K + E_v) log M) heap work instead of
# a full sort, and the engine consumes the rows chunk-by-chunk while the
# device scans the previous chunk.
#
# Equivalence contract (gated in tests): with
# k_max >= M and capacity >= M there is no truncation and no eviction, and
# SparseTimeline.densify() reproduces compile_timeline field-for-field;
# the engine's sparse loss trajectory then matches the dense async path.


def resolve_store_geometry(sfl: SFLConfig) -> Tuple[int, int]:
    """(k_max, ring_capacity) for timeline='sparse'.

    k_max bounds both the per-version start batch (fresh fetches admitted
    at a broadcast) and the apply batch (records gathered per commit);
    ring_capacity bounds the in-flight record store. Autos: with quorum=0
    both default to M (every client can be in flight — exactly the dense
    store, so the paths are bit-equivalent); with a quorum, k_max covers
    the quorum plus opportunistic extras (4x, floor 16) and the ring holds
    a staleness window of 8 commit batches. Neither ever exceeds M: a
    client carries at most one in-flight contribution.
    """
    M = int(sfl.n_clients)
    k = int(sfl.k_max)
    if k <= 0:
        k = M if sfl.quorum <= 0 else min(M, max(4 * int(sfl.quorum), 16))
    k = min(k, M)
    cap = int(sfl.ring_capacity)
    if cap <= 0:
        cap = M if sfl.quorum <= 0 else min(M, 8 * k)
    return k, min(max(cap, k), M)


class _CohortIdleIndex:
    """Per-cohort idle-client index: a virgin-range pointer plus a
    recycled-id min-heap per cohort, with exact per-cohort idle counters.

    Replaces the DES's O(M) ``flatnonzero((mask > 0) & ~busy)`` candidate
    scan: selection walks cohorts in client-id order, admitting up to
    k_max idle available clients by taking the min of the cohort's
    never-yet-consumed ascending range [virgin, hi) and its heap of
    recycled (previously finished) ids — O(K·log W + A_v) per version,
    where W is the in-flight window and A_v the size of the version's
    sparse availability records. Init is O(#cohorts), never O(M): the
    virgin range is two integers, and the heap only ever holds ids the
    pointer has already passed (``finish`` guards the push), so the
    min-of-union pop order is globally ascending. Heap entries are lazily
    invalidated (the busy vector is the truth); duplicates pop
    consecutively and are dropped; a busy id under the pointer is skipped
    (its eventual ``finish`` re-adds it). Bit-exact with the dense scan:
    cohorts are contiguous ascending id ranges, so admission order is
    ascending client id, and the idle counters make the skipped-candidate
    count exact without enumeration.
    """

    def __init__(self, bounds: Sequence[Tuple[int, int]]):
        self.bounds = [(int(lo), int(hi)) for lo, hi in bounds]
        self.virgin = [lo for lo, _ in self.bounds]
        self.heaps: List[List[int]] = [[] for _ in self.bounds]
        self.n_idle = [hi - lo for lo, hi in self.bounds]
        self._his = [hi for _, hi in self.bounds]

    def cohort_of(self, m: int) -> int:
        return bisect.bisect_right(self._his, m)

    def start(self, m: int) -> None:
        """Client m went busy (any heap entry for it goes stale)."""
        self.n_idle[self.cohort_of(m)] -= 1

    def start_batch(self, admitted: List[int]) -> None:
        """Admitted ids (ascending) went busy — one counter update per
        cohort instead of one per client."""
        n_idle, lo_i, n = self.n_idle, 0, len(admitted)
        for c, hi in enumerate(self._his):
            if lo_i >= n:
                break
            hi_i = bisect.bisect_left(admitted, hi, lo_i)
            if hi_i != lo_i:
                n_idle[c] -= hi_i - lo_i
                lo_i = hi_i

    def finish(self, m: int) -> None:
        """Client m went idle (commit or eviction)."""
        c = self.cohort_of(m)
        if m < self.virgin[c]:          # else still covered by the range
            heapq.heappush(self.heaps[c], m)
        self.n_idle[c] += 1

    def finish_batch(self, ms: Sequence[int]) -> None:
        """Clients went idle (commit or eviction), arbitrary order."""
        his, virgin = self._his, self.virgin
        heaps, n_idle = self.heaps, self.n_idle
        push, br = heapq.heappush, bisect.bisect_right
        for m in ms:
            c = br(his, m)
            n_idle[c] += 1
            if m < virgin[c]:           # else still covered by the range
                push(heaps[c], m)

    def select(self, avail: AvailRow, busy: np.ndarray,
               k_max: int) -> Tuple[List[int], int]:
        """(admitted ids, total candidate count) for one broadcast.

        Admitted = the first k_max idle available clients in ascending id
        order — exactly ``flatnonzero((mask > 0) & ~busy)[:k_max]``. The
        total count covers ALL cohorts (the skipped statistic), via the
        idle counters / sparse rows, never a fleet scan.
        """
        admitted: List[int] = []
        total = 0
        for c, kind in enumerate(avail.kinds):
            if kind == "none":
                continue
            need = k_max - len(admitted)
            if kind == "ids":
                ids = avail.ids[c]
                idle = ids[~busy[ids]]
                total += int(idle.size)
                if need > 0:
                    admitted.extend(idle[:need].tolist())
                continue                # index untouched (lazy staleness)
            if kind == "not_ids":
                down = avail.ids[c]
                down_idle = int((~busy[down]).sum()) if down.size else 0
                total += self.n_idle[c] - down_idle
            else:                       # 'all'
                total += self.n_idle[c]
            heap = self.heaps[c]
            down = avail.down_set(c) if kind == "not_ids" else ()
            hi = self.bounds[c][1]
            nxt = self.virgin[c]
            deferred: List[int] = []    # idle but unavailable: keep them
            last = -1
            while need > 0:
                if heap and (nxt >= hi or heap[0] < nxt):
                    m = heapq.heappop(heap)
                    if m == last:       # duplicate copy of the same entry
                        continue
                    last = m
                    if busy[m]:         # stale entry (lazy deletion)
                        continue
                elif nxt < hi:
                    m = nxt
                    nxt += 1
                    if busy[m]:         # started via an 'ids' row; its
                        continue        # finish() re-adds it to the heap
                else:
                    break
                if m in down:
                    deferred.append(m)
                    continue
                admitted.append(m)
                need -= 1
            self.virgin[c] = nxt
            for m in deferred:
                heapq.heappush(heap, m)
        return admitted, total


class _VStep(NamedTuple):
    """One simulated version, ragged (host-side only)."""
    start_clients: List[int]
    start_slots: List[int]
    apply_clients: List[int]
    apply_slots: List[int]
    apply_stales: List[int]
    apply_ws: List[float]
    commit_time: float
    duration: float
    quorum_wait: float
    evicted: int
    skipped: int
    # fault accounting (all zero on the zero-fault path); ``started``
    # counts every dispatch including faulted fetches, so
    # started == len(start_clients) + crashed + lost + corrupt
    started: int = 0
    crashed: int = 0
    lost: int = 0
    corrupt: int = 0
    dups: int = 0
    retries: int = 0
    timed_out: int = 0


class _EventSim:
    """The discrete-event core of the sparse timeline.

    State is slot-indexed over the ring: (capacity,) arrays of arrival
    time, occupying client (-1 = free slot), version of origin, and a
    monotone start counter (eviction order = start order). Admissions
    write a batch of slots per version (lowest free slots first, so
    capacity >= M degenerates to the dense one-slot-per-client layout and
    never evicts); commit selection is one lexsort by (arrival, client)
    over the <= capacity pending slots — no fleet-width pass anywhere.
    Candidate selection is driven by a _CohortIdleIndex over the
    population's cohort ranges (O(K·log W + A_v) per version), never an
    O(M) scan. Deterministic and prefix-stable in exactly the dense
    compiler's sense: same (quorum, discount, taus, masks) prefix ->
    same rows.

    ``step`` takes the availability row as either a dense (M,) mask (the
    bit-exact reference adapter, O(M) to bucket) or an AvailRow (the
    streaming mask protocol — sub-O(M)); delays as a dense (M,) row or a
    ``delays_for(ids)`` callable evaluated only on the admitted clients.
    """

    def __init__(self, n_clients: int, comm: np.ndarray, t_server: float,
                 *, quorum: int, discount: float, k_max: int,
                 capacity: int, collect_events: bool = False,
                 cohort_bounds: Optional[Sequence[Tuple[int, int]]] = None,
                 faults: Optional[ResolvedFaults] = None,
                 quorum_timeout: float = 0.0, max_retries: int = 3):
        self.M = int(n_clients)
        self.comm = np.asarray(comm, np.float64)
        self.t_server = float(t_server)
        self.quorum = int(quorum)
        self.discount = float(discount)
        self.k_max = int(k_max)
        self.capacity = int(capacity)
        self.quorum_timeout = float(quorum_timeout)
        self.max_retries = int(max_retries)
        self.faults = faults
        self.t = 0.0
        self.v = 0
        self._ord = 0
        # the ring, slot-indexed: client -1 marks a free slot
        self.slot_arr = np.zeros(self.capacity, np.float64)
        self.slot_client = np.full(self.capacity, -1, np.int64)
        self.slot_origin = np.zeros(self.capacity, np.int64)
        self.slot_ord = np.zeros(self.capacity, np.int64)
        self.busy = np.zeros(self.M, bool)
        self.idle = _CohortIdleIndex(cohort_bounds or [(0, self.M)])
        self._finished: List[int] = []  # drops awaiting the per-step flush
        if faults is not None:
            # crashed/dropped clients parked until their re-dispatch time,
            # and per-client consecutive-crash streaks (backoff exponent)
            self._recovering: List[Tuple[float, int]] = []
            self._streaks = np.zeros(self.M, np.int64)
        self.events: Optional[List[Tuple[float, int, int, int, int]]] = \
            [] if collect_events else None

    def step(self, delay_row, mask_row, tau: int,
             quorum: Optional[int] = None) -> _VStep:
        t, v = self.t, self.v
        rf = self.faults
        if rf is not None and self._recovering:
            # fault-freed clients whose backoff/drop time has passed
            # re-enter the idle index before this broadcast
            rec, freed = self._recovering, []
            while rec and rec[0][0] <= t:
                freed.append(heapq.heappop(rec)[1])
            if freed:
                self.busy[np.asarray(freed, np.int64)] = False
                self.idle.finish_batch(freed)
        # broadcast: idle clients on the mask fetch and start, in client-id
        # order (the dense compiler's iteration order), admitted up to the
        # k_max batch width; the rest are skipped, not deferred — they may
        # start at a later broadcast whose mask includes them
        avail = (mask_row if isinstance(mask_row, AvailRow) else
                 AvailRow.from_mask(mask_row, self.idle.bounds))
        admitted, n_cand = self.idle.select(avail, self.busy, self.k_max)
        skipped = n_cand - len(admitted)
        adm = np.asarray(admitted, np.int64)
        delays = (np.asarray(delay_row(adm), np.float64) if callable(delay_row)
                  else np.asarray(delay_row)[adm])
        self.busy[adm] = True           # evictions below re-clear theirs
        self.idle.start_batch(admitted)
        n_started = len(admitted)
        crashed = lost = corrupt = dups = retries = 0
        if rf is not None and n_started:
            f = rf.dispatch_fates(v, adm, t, delays, self.comm[adm],
                                  self._streaks, self.max_retries)
            out = f["outcome"]
            dups = int(f["dup"].sum())
            retries = int(f["retries"].sum())
            crashed = int((out == OUT_CRASH).sum())
            lost = int((out == OUT_LOST).sum())
            corrupt = int((out == OUT_CORRUPT).sum())
            self._streaks[adm[out != OUT_CRASH]] = 0
            if crashed or lost or corrupt:
                self._streaks[adm[out == OUT_CRASH]] += 1
                for j in np.flatnonzero(out != OUT_DELIVER).tolist():
                    m = int(adm[j])
                    # stays busy (no slot) until its re-dispatch time
                    heapq.heappush(self._recovering,
                                   (float(f["ready"][j]), m))
                    if self.events is not None:
                        o = int(out[j])
                        if o == OUT_CRASH:
                            self.events.append((t, m, v, STALE_CRASH, -1))
                        elif o == OUT_LOST:
                            self.events.append((float(f["ready"][j]), m, v,
                                                STALE_LOST, -1))
                        else:
                            self.events.append((float(f["arrival"][j]), m,
                                                v, STALE_CORRUPT, -1))
                keep = out == OUT_DELIVER
                adm = adm[keep]
                admitted = adm.tolist()
                arrs = f["arrival"][keep]
            else:
                arrs = f["arrival"]
        else:
            arrs = t + delays + self.comm[adm]
        n_admit = len(admitted)
        free_idx = np.flatnonzero(self.slot_client < 0)
        evicted = 0
        if n_admit <= free_idx.size:
            # common path: batch-assign the lowest free slots in admitted
            # (= ascending client id) order — exactly the sequential
            # pop-lowest-slot assignment when no eviction interleaves
            slots = free_idx[:n_admit]
            self.slot_arr[slots] = arrs
            self.slot_client[slots] = adm
            self.slot_origin[slots] = v
            self.slot_ord[slots] = self._ord + np.arange(n_admit)
            self._ord += n_admit
        else:
            # ring pressure: interleave evictions sequentially — each
            # admitted client takes the lowest slot free at that moment,
            # evicting the oldest-started in-flight contribution when none
            # is (it never applies — counted, never silent)
            free_heap = free_idx.tolist()   # ascending => a valid heap
            slot_list: List[int] = []
            for m, arr in zip(admitted, arrs.tolist()):
                if not free_heap:
                    valid = np.flatnonzero(self.slot_client >= 0)
                    es = int(valid[np.argmin(self.slot_ord[valid])])
                    em = int(self.slot_client[es])
                    self.slot_client[es] = -1
                    self.busy[em] = False
                    self._finished.append(em)
                    if self.events is not None:
                        self.events.append((float(self.slot_arr[es]), em,
                                            int(self.slot_origin[es]),
                                            -1, -1))
                    evicted += 1
                    heapq.heappush(free_heap, es)
                slot = heapq.heappop(free_heap)
                self.slot_arr[slot] = arr
                self.slot_client[slot] = m
                self.slot_origin[slot] = v
                self.slot_ord[slot] = self._ord
                self._ord += 1
                slot_list.append(slot)
            slots = np.asarray(slot_list, np.int64)
        # quorum: the k earliest pending arrivals, ties broken by client id
        # (the arrival heap's pop order) — one lexsort over <= capacity
        # slots; the k-th is the quorum arrival
        q_req = self.quorum if quorum is None else int(quorum)
        valid_idx = np.flatnonzero(self.slot_client >= 0)
        n_pend = valid_idx.size
        k = n_pend if q_req <= 0 else min(q_req, n_pend)
        if n_pend:
            va = self.slot_arr[valid_idx]
            order = np.lexsort((self.slot_client[valid_idx], va))
            sorted_slots = valid_idx[order]
            sa = va[order]
        q_arrival = float(sa[k - 1]) if k > 0 else t
        timed_out = 0
        if q_req > 0 and self.quorum_timeout > 0:
            deadline = t + self.quorum_timeout
            if n_pend < q_req or q_arrival > deadline:
                q_arrival = deadline            # degrade: commit what came
                timed_out = 1
        elif rf is not None and q_req > 0 and n_pend < q_req:
            raise _stall_error(v, n_pend, q_req)
        quorum_wait = max(q_arrival - t, 0.0) if (k > 0 or timed_out) else 0.0
        c_time = max(q_arrival, t + float(tau) * self.t_server)
        # opportunistic extras: everything else delivered by the commit,
        # up to the k_max batch width; overflow past the width (possible
        # when quorum > k_max) simply stays pending — it folds into a
        # later commit at discount**(staleness then), never dropped
        n_del = int(np.searchsorted(sa, c_time, side="right")) if n_pend \
            else 0
        n_take = min(n_del, self.k_max)
        take = sorted_slots[:n_take] if n_take else \
            np.zeros(0, np.int64)
        # apply in client-id order (dense: `for m in sorted(pending)`)
        ord2 = np.argsort(self.slot_client[take])
        take = take[ord2]
        clients = self.slot_client[take]
        stales = v - self.slot_origin[take]
        ws_arr = np.power(self.discount, stales.astype(np.float64))
        tot = float(np.sum(ws_arr)) if n_take else 0.0
        if tot > 0:
            ws_arr = ws_arr / tot
        if self.events is not None and n_take:
            arrs_t = self.slot_arr[take]
            origins = self.slot_origin[take]
            for j in range(n_take):
                self.events.append((float(arrs_t[j]), int(clients[j]),
                                    int(origins[j]), int(stales[j]), v))
        if n_take:
            self.slot_client[take] = -1
            self.busy[clients] = False
            self._finished.extend(clients.tolist())
        if self._finished:
            self.idle.finish_batch(self._finished)
            self._finished.clear()
        self.t, self.v = c_time, v + 1
        return _VStep(
            start_clients=admitted, start_slots=slots.tolist(),
            apply_clients=clients.tolist(),
            apply_slots=take.tolist(),
            apply_stales=stales.tolist(), apply_ws=ws_arr.tolist(),
            commit_time=c_time, duration=c_time - t,
            quorum_wait=quorum_wait, evicted=evicted, skipped=skipped,
            started=n_started, crashed=crashed, lost=lost, corrupt=corrupt,
            dups=dups, retries=retries, timed_out=timed_out)

    def finalize_events(self) -> List[Tuple[float, int, int, int, int]]:
        """Contributions still in flight at the horizon (delivered to
        nobody), appended to the collected event list."""
        assert self.events is not None
        valid = np.flatnonzero(self.slot_client >= 0)
        for s_i in valid[np.argsort(self.slot_client[valid])].tolist():
            self.events.append((float(self.slot_arr[s_i]),
                                int(self.slot_client[s_i]),
                                int(self.slot_origin[s_i]), -1, -1))
        return self.events


class SparseRows(NamedTuple):
    """(C, K)-padded sparse commit rows for C consecutive versions.

    Pad conventions (the reference's): start_client / apply_client pad -1
    (clipped to 0 for the batch gather; the row is inert because its slot
    and weight pads make it so); start_slot pads `capacity` (the scatter
    drops the row); apply_slot pads `capacity` (the gather clamps it to the
    last slot, whose records apply_w's 0 pad makes inert).
    """
    start_client: np.ndarray     # (C, Ks) i64, pad -1
    start_slot: np.ndarray       # (C, Ks) i64, pad = capacity
    apply_client: np.ndarray     # (C, Ka) i64, pad -1
    apply_slot: np.ndarray       # (C, Ka) i64, pad = capacity
    apply_stale: np.ndarray      # (C, Ka) i64, pad -1
    apply_w: np.ndarray          # (C, Ka) f32, pad 0
    commit_times: np.ndarray     # (C,) f64
    durations: np.ndarray        # (C,) f64
    quorum_wait: np.ndarray      # (C,) f64
    applied: np.ndarray          # (C,) i64
    started: np.ndarray          # (C,) i64  dispatches incl. faulted
    evicted: np.ndarray          # (C,) i64
    skipped: np.ndarray          # (C,) i64
    # fault accounting (zero on the zero-fault path)
    crashed: np.ndarray = np.zeros(0, np.int64)    # (C,) i64
    lost: np.ndarray = np.zeros(0, np.int64)       # (C,) i64
    corrupt: np.ndarray = np.zeros(0, np.int64)    # (C,) i64
    dups: np.ndarray = np.zeros(0, np.int64)       # (C,) i64
    retries: np.ndarray = np.zeros(0, np.int64)    # (C,) i64
    timeouts: np.ndarray = np.zeros(0, np.int64)   # (C,) i64


def _pack_rows(steps: Sequence[_VStep], k_start: int, k_apply: int,
               capacity: int) -> SparseRows:
    C = len(steps)
    sc = np.full((C, k_start), -1, np.int64)
    ss = np.full((C, k_start), capacity, np.int64)
    ac = np.full((C, k_apply), -1, np.int64)
    asl = np.full((C, k_apply), capacity, np.int64)
    ast = np.full((C, k_apply), -1, np.int64)
    aw = np.zeros((C, k_apply), np.float32)
    for i, s in enumerate(steps):
        ns, na = len(s.start_clients), len(s.apply_clients)
        sc[i, :ns] = s.start_clients
        ss[i, :ns] = s.start_slots
        ac[i, :na] = s.apply_clients
        asl[i, :na] = s.apply_slots
        ast[i, :na] = s.apply_stales
        aw[i, :na] = np.asarray(s.apply_ws, np.float64).astype(np.float32) \
            if na else 0.0
    return SparseRows(
        start_client=sc, start_slot=ss, apply_client=ac, apply_slot=asl,
        apply_stale=ast, apply_w=aw,
        commit_times=np.array([s.commit_time for s in steps], np.float64),
        durations=np.array([s.duration for s in steps], np.float64),
        quorum_wait=np.array([s.quorum_wait for s in steps], np.float64),
        applied=np.array([len(s.apply_clients) for s in steps], np.int64),
        started=np.array([s.started for s in steps], np.int64),
        evicted=np.array([s.evicted for s in steps], np.int64),
        skipped=np.array([s.skipped for s in steps], np.int64),
        crashed=np.array([s.crashed for s in steps], np.int64),
        lost=np.array([s.lost for s in steps], np.int64),
        corrupt=np.array([s.corrupt for s in steps], np.int64),
        dups=np.array([s.dups for s in steps], np.int64),
        retries=np.array([s.retries for s in steps], np.int64),
        timeouts=np.array([s.timed_out for s in steps], np.int64))


def _comm_of(schedule) -> np.ndarray:
    comm = np.full(schedule.n_clients, schedule.t_comm, np.float64)
    if schedule.t_comm_scale is not None:
        comm = schedule.t_comm * np.asarray(schedule.t_comm_scale, np.float64)
    return comm


def _cohort_bounds_of(schedule) -> List[Tuple[int, int]]:
    pop = getattr(schedule, "population", None)
    if pop is None:
        return [(0, schedule.n_clients)]
    return [(s.start, s.stop) for s in pop.slices()]


class TimelineStream:
    """Chunk-streamed sparse timeline.

    The engine pulls ``take(C)`` (C, K) commit-batch rows while the device
    scans the previous chunk — the (V, ·) trace never materializes on the
    host. ``skip(n)`` advances the simulation without building rows (the
    engine replays the prefix on resume and on controller re-plans, which
    is what makes the stream prefix-stable in the dense compiler's sense:
    rebuild with the same knob prefix + skip(v) == the original stream at
    v, ring state included).

    taus may be a live (n_versions,) array a controller mutates for
    versions not yet taken; mask_row_fn(v) -> (M,) overrides the cyclic
    schedule masks (the engine uses it for deadline re-plans).

    ``schedule`` is a dense straggler.Schedule — or any lazy schedule
    speaking the streaming mask protocol (straggler.make_sparse_schedule):
    ``avail_row(r)`` AvailRows + ``delays_for(r, ids)`` keyed delays
    instead of materialized (R, M) rows, which is what lets the DES run
    million-client fleets without ever densifying the schedule.
    """

    def __init__(self, schedule, n_versions: int, *, quorum: int,
                 discount: float, taus, k_max: int, capacity: int,
                 mask_row_fn: Optional[Callable[[int], np.ndarray]] = None,
                 collect_events: bool = False, quorums=None,
                 faults=None, quorum_timeout: float = 0.0,
                 max_retries: int = 3):
        self.schedule = schedule
        self.R, self.M = schedule.n_rounds, schedule.n_clients
        self._lazy = not hasattr(schedule, "masks")
        self.n_versions = int(n_versions)
        self.taus = (np.full(self.n_versions, taus, np.int64)
                     if np.ndim(taus) == 0 else np.asarray(taus))
        if self.taus.shape != (self.n_versions,):
            raise ValueError(
                f"taus shape {self.taus.shape} != ({self.n_versions},)")
        # per-version quorum — a live array like taus (AdaptiveQuorum
        # mutates versions not yet taken); None = the scalar everywhere
        self.quorums = (np.full(self.n_versions, quorum, np.int64)
                        if quorums is None else np.asarray(quorums, np.int64))
        if self.quorums.shape != (self.n_versions,):
            raise ValueError(
                f"quorums shape {self.quorums.shape} != "
                f"({self.n_versions},)")
        self.k_max = int(k_max)
        self.capacity = int(capacity)
        self.mask_row_fn = mask_row_fn
        self.sim = _EventSim(
            self.M, _comm_of(schedule), schedule.t_server, quorum=quorum,
            discount=discount, k_max=k_max, capacity=capacity,
            collect_events=collect_events,
            cohort_bounds=_cohort_bounds_of(schedule),
            faults=_resolve_faults(schedule, faults),
            quorum_timeout=quorum_timeout, max_retries=max_retries)

    @property
    def v(self) -> int:
        return self.sim.v

    def _step(self) -> _VStep:
        v = self.sim.v
        if v >= self.n_versions:
            raise ValueError(f"stream exhausted at version {v}")
        r = v % self.R
        if self._lazy:
            mask = (self.mask_row_fn(v) if self.mask_row_fn is not None
                    else self.schedule.avail_row(r))
            delays = lambda ids: self.schedule.delays_for(r, ids)
        else:
            mask = (self.mask_row_fn(v) if self.mask_row_fn is not None
                    else self.schedule.masks[r])
            delays = self.schedule.delays[r]
        return self.sim.step(delays, mask, int(self.taus[v]),
                             quorum=int(self.quorums[v]))

    def skip(self, n: int) -> None:
        for _ in range(int(n)):
            self._step()

    def take(self, n: int) -> SparseRows:
        n = min(int(n), self.n_versions - self.sim.v)
        with span("events.stream_take", v=self.sim.v, n=n):
            return _pack_rows([self._step() for _ in range(n)],
                              self.k_max, self.k_max, self.capacity)


@dataclasses.dataclass(frozen=True)
class SparseTimeline:
    """A fully-compiled sparse trace: SparseRows over all V versions plus
    the flat arrival-ordered event view (same columns as Timeline) and the
    run config. ``densify()`` expands back to the dense Timeline — the
    equivalence gate compares that against compile_timeline field-for-
    field (exact when nothing was truncated or evicted, i.e. k_max and
    capacity >= M)."""
    rows: SparseRows
    arrival_time: np.ndarray
    client_id: np.ndarray
    cohort_id: np.ndarray
    round_of_origin: np.ndarray
    staleness: np.ndarray
    commit_idx: np.ndarray
    quorum: int
    discount: float
    tau_per_version: np.ndarray
    n_clients: int
    capacity: int

    @property
    def n_versions(self) -> int:
        return self.rows.start_client.shape[0]

    @property
    def n_events(self) -> int:
        return self.arrival_time.shape[0]

    def densify(self) -> Timeline:
        V, M, r = self.n_versions, self.n_clients, self.rows
        start_mask = np.zeros((V, M), np.float32)
        apply_w = np.zeros((V, M), np.float32)
        staleness_m = np.full((V, M), -1, np.int64)
        for v in range(V):
            sc = r.start_client[v]
            start_mask[v, sc[sc >= 0]] = 1.0
            live = r.apply_client[v] >= 0
            ac = r.apply_client[v][live]
            apply_w[v, ac] = r.apply_w[v][live]
            staleness_m[v, ac] = r.apply_stale[v][live]
        return Timeline(
            arrival_time=self.arrival_time, client_id=self.client_id,
            cohort_id=self.cohort_id,
            round_of_origin=self.round_of_origin, staleness=self.staleness,
            commit_idx=self.commit_idx, start_mask=start_mask,
            apply_w=apply_w, staleness_m=staleness_m,
            commit_times=r.commit_times, durations=r.durations,
            quorum_wait=r.quorum_wait, applied=r.applied,
            quorum=self.quorum, discount=self.discount,
            tau_per_version=self.tau_per_version,
            started=r.started, crashed=r.crashed, lost=r.lost,
            corrupt=r.corrupt, dups=r.dups, retries=r.retries,
            timeouts=r.timeouts)


def compile_sparse_timeline(schedule, n_versions: int, *, quorum=0,
                            discount: float = 1.0, tau=1,
                            mask_rows: Optional[np.ndarray] = None,
                            k_max: Optional[int] = None,
                            capacity: Optional[int] = None,
                            faults=None, quorum_timeout: float = 0.0,
                            max_retries: int = 3) -> SparseTimeline:
    """Sparse counterpart of compile_timeline — same knobs (faults,
    quorum_timeout and per-version quorum arrays included), heap DES,
    (V, K) rows. k_max/capacity None = M (no truncation, no eviction:
    densify() reproduces the dense compiler exactly). Row widths are the
    realized maxima when k_max is None, else k_max."""
    R, M = schedule.delays.shape
    V = int(n_versions)
    taus = np.full(V, tau, np.int64) if np.ndim(tau) == 0 else \
        np.asarray(tau, np.int64)
    if taus.shape != (V,):
        raise ValueError(f"tau_per_version shape {taus.shape} != ({V},)")
    quorums = np.full(V, quorum, np.int64) if np.ndim(quorum) == 0 else \
        np.asarray(quorum, np.int64)
    if quorums.shape != (V,):
        raise ValueError(
            f"quorum_per_version shape {quorums.shape} != ({V},)")
    if mask_rows is not None:
        mask_rows = np.asarray(mask_rows, np.float32)
        if mask_rows.shape != (V, M):
            raise ValueError(
                f"mask_rows shape {mask_rows.shape} != ({V}, {M})")
    exact = k_max is None
    k = M if exact else int(k_max)
    cap = M if capacity is None else int(capacity)
    sim = _EventSim(M, _comm_of(schedule), schedule.t_server,
                    quorum=int(quorums[0]) if V else 0,
                    discount=discount, k_max=k, capacity=cap,
                    collect_events=True,
                    cohort_bounds=_cohort_bounds_of(schedule),
                    faults=_resolve_faults(schedule, faults),
                    quorum_timeout=quorum_timeout, max_retries=max_retries)
    steps = []
    with span("events.compile_sparse_timeline", versions=V, clients=M):
        for v in range(V):
            mask = mask_rows[v] if mask_rows is not None \
                else schedule.masks[v % R]
            steps.append(sim.step(schedule.delays[v % R], mask,
                                  int(taus[v]), quorum=int(quorums[v])))
    if exact:
        k_start = max([1] + [len(s.start_clients) for s in steps])
        k_apply = max([1] + [len(s.apply_clients) for s in steps])
    else:
        k_start = k_apply = k
    rows = _pack_rows(steps, k_start, k_apply, cap)
    # the in-flight contributions are collected first: a run that recorded
    # no event before the horizon still has them (the reference tested
    # the list before collecting, and lost them)
    collected = sim.finalize_events()
    ev = np.array(collected, np.float64) \
        if collected else np.zeros((0, 5), np.float64)
    order = np.lexsort((ev[:, 1], ev[:, 0]))
    ev = ev[order]
    client_id = ev[:, 1].astype(np.int64)
    cohorts = (schedule.population.cohort_ids()
               if getattr(schedule, "population", None) is not None
               else np.zeros(M, np.int64))
    return SparseTimeline(
        rows=rows, arrival_time=ev[:, 0], client_id=client_id,
        cohort_id=cohorts[client_id],
        round_of_origin=ev[:, 2].astype(np.int64),
        staleness=ev[:, 3].astype(np.int64),
        commit_idx=ev[:, 4].astype(np.int64),
        quorum=int(quorums[0]) if V else
        (0 if np.ndim(quorum) else int(quorum)),
        discount=float(discount), tau_per_version=taus,
        n_clients=M, capacity=cap)


# ---------------------------------------------------------------------------
# the per-version device step: the record store and the quorum commit
# ---------------------------------------------------------------------------

_STORE_KEYS = ("srv_keys", "srv_coeffs", "ukey", "ccoeff", "loss0")


def init_store(sfl: SFLConfig, device=None) -> Dict[str, Any]:
    """The in-flight contribution buffer, each slot the replayable
    seed-record wire format of a full MU-SplitFed contribution: (τ, P)
    server records, the client (key, coeff) pair, and the fetch-time loss.
    Zero coeffs make an empty or consumed slot replay-inert.

    Layout follows sfl.timeline: 'dense' keys slots by client id (M slots;
    a client computes at most one contribution at a time); 'sparse' is the
    bounded arrival-slot ring (resolve_store_geometry's capacity), the
    timeline stream owning the slot <-> contribution mapping. Keys are host
    numpy uint32, coefficients and losses f32 tensors on ``device``."""
    M, T, P = sfl.n_clients, sfl.tau, sfl.n_perturbations
    lead = M
    if getattr(sfl, "timeline", "dense") == "sparse":
        lead = resolve_store_geometry(sfl)[1]

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {"srv_keys": np.zeros((lead, T, P, 2), np.uint32),
            "srv_coeffs": zeros(lead, T, P),
            "ukey": np.zeros((lead, 2), np.uint32),
            "ccoeff": zeros(lead),
            "loss0": zeros(lead)}


def resize_store(store: Dict[str, Any], tau: int) -> Dict[str, Any]:
    """Re-shape the record store's τ axis after a controller re-plans τ.
    Growth zero-pads (inert records); shrink truncates the tail server
    records of still-in-flight stale contributions, an approximation on
    work that would have been staleness-discounted anyway."""
    old = store["srv_keys"].shape[1]
    if tau == old:
        return store
    out = dict(store)
    keys, coeffs = store["srv_keys"], store["srv_coeffs"]
    if tau > old:
        out["srv_keys"] = np.pad(keys, [(0, 0), (0, tau - old), (0, 0),
                                        (0, 0)])
        out["srv_coeffs"] = torch.cat(
            [coeffs, coeffs.new_zeros((coeffs.shape[0], tau - old)
                                      + tuple(coeffs.shape[2:]))], dim=1)
    else:
        out["srv_keys"] = keys[:, :tau].copy()
        out["srv_coeffs"] = coeffs[:, :tau].clone()
    return out


def _host_vector(x, dtype) -> np.ndarray:
    """A per-version row as a host numpy vector (tensor rows too)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype).reshape(-1)


def _weights(apply_w, sfl: SFLConfig, device) -> torch.Tensor:
    """η_g·apply_w as f32 on ``device`` (the reference's f32 product)."""
    w = torch.as_tensor(_host_vector(apply_w, np.float32), device=device)
    return (sfl.lr_global * w).to(torch.float32)


def _compute_fresh(cfg: ModelConfig, sfl: SFLConfig, xc, xs, batches,
                   rows: Sequence[int], clients: Sequence[int],
                   version_key, eval_loss: bool, replay: str):
    """The contributions of ``clients`` (client ids), batch row ``rows[j]``
    for client ``clients[j]``, each under fold_in(version_key, client):
    host keys stacked on the host, device values stacked on the device."""
    outs = []
    for j, m in zip(rows, clients):
        r = _client_round(cfg, sfl, xc, xs,
                          {k: v[j] for k, v in batches.items()},
                          prng.fold_in(version_key, int(m)), eval_loss,
                          replay)
        r.pop("xs_final")
        outs.append(r)
    return {"srv_keys": np.stack([o["srv_keys"] for o in outs]),
            "srv_coeffs": torch.stack([o["srv_coeffs"] for o in outs]),
            "ukey": np.stack([o["ukey"] for o in outs]),
            "ccoeff": torch.stack([o["ccoeff"].reshape(())
                                   for o in outs]).to(torch.float32),
            "loss0": torch.stack([o["loss0"].reshape(())
                                  for o in outs]).to(torch.float32)}


def scatter_rows(store: Dict[str, Any], slots: np.ndarray,
                 fresh: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """A copy of ``store`` with row ``slots[j]`` of every entry set to row j
    of ``fresh``; a slot past the store's lead (a pad) is dropped, as the
    reference's scatter with mode='drop'. ``fresh`` holds one row per slot
    (None when nothing starts)."""
    lead = store["srv_keys"].shape[0]
    slots = np.asarray(slots, np.int64).reshape(-1)
    keep = np.flatnonzero((slots >= 0) & (slots < lead))
    out = {}
    for name in _STORE_KEYS:
        a = store[name]
        if isinstance(a, np.ndarray):
            a = a.copy()
            if keep.size:
                a[slots[keep]] = fresh[name][keep]
        else:
            a = a.clone()
            if keep.size:
                idx = torch.as_tensor(slots[keep], device=a.device)
                a.index_copy_(0, idx, fresh[name][
                    torch.as_tensor(keep, device=a.device)].to(a.dtype))
        out[name] = a
    return out


def gather_rows(a, slots: np.ndarray):
    """Rows ``slots`` of a store entry, each index clamped into the store
    (the reference's gather with mode='clip')."""
    idx = np.clip(np.asarray(slots, np.int64).reshape(-1), 0,
                  a.shape[0] - 1)
    if isinstance(a, np.ndarray):
        return a[idx]
    return a.index_select(0, torch.as_tensor(idx, device=a.device))


def _commit(cfg: ModelConfig, sfl: SFLConfig, xc, xs, keys, coeffs, ukeys,
            ccoeffs, w, replay: str):
    """Replay one commit's records, (N, τ, P) server and (N,) client ones,
    under the (N,) weights ``w`` (zo.replay_weighted_records)."""
    dist = sfl.perturbation_dist
    xs_new = zo.replay_weighted_records(xs, keys, coeffs, w, dist, replay)
    xc_new = zo.replay_weighted_records(xc, ukeys, ccoeffs, w, dist, replay)
    return merge_params(cfg, xc_new, xs_new)


@torch.inference_mode()
def async_mu_splitfed_step(cfg: ModelConfig, sfl: SFLConfig, params,
                           store: Dict[str, Any], batches, start_mask,
                           apply_w, version_key, *, replay: str = "auto",
                           eval_loss: bool = True):
    """One server version of semi-async MU-SplitFed.

    start_mask (M,) (host) selects the clients that fetch the current
    params and compute a fresh contribution this version (their records
    overwrite their store slot; the timeline guarantees the old slot was
    already committed). apply_w (M,) are the normalized
    staleness-discounted weights of this version's quorum commit: the whole
    store is replayed with per-record coefficients c·η_g·w_m, so slots with
    w=0 (in flight or idle) contribute exactly zero. Client compute happens
    at fetch time, which is what makes stale records stale: they were
    generated against the params of their round of origin. Returns
    (params, store, {'loss': (M,) fetch-time losses of the store})."""
    xc, xs = split_params(cfg, params, sfl.cut_units)
    starters = np.flatnonzero(_host_vector(start_mask, np.float32) > 0)
    fresh = (_compute_fresh(cfg, sfl, xc, xs, batches, starters, starters,
                            version_key, eval_loss, replay)
             if starters.size else None)
    store = scatter_rows(store, starters, fresh)
    device = store["loss0"].device
    params = _commit(cfg, sfl, xc, xs, store["srv_keys"],
                     store["srv_coeffs"], store["ukey"], store["ccoeff"],
                     _weights(apply_w, sfl, device), replay)
    return params, store, {"loss": store["loss0"]}


@torch.inference_mode()
def async_mu_splitfed_sparse_step(cfg: ModelConfig, sfl: SFLConfig, params,
                                  store: Dict[str, Any], batches,
                                  start_client, start_slot, apply_slot,
                                  apply_w, version_key, *,
                                  replay: str = "auto",
                                  eval_loss: bool = True):
    """One server version over the arrival-slot ring store.

    ``batches`` are pre-gathered (K, ...) rows of the starting clients.
    start_client (K,) gives each row's client id (its fold-in key, so a
    starting client's records are bit-identical to the dense path's);
    start_slot (K,) scatters the fresh records into the ring (a pad slot,
    = capacity, is dropped, and its row is not computed). apply_slot and
    apply_w (K,) gather this commit's records for one weighted replay, in
    commit (client id) order: a pad gathers the last slot (clamped) with
    weight 0, which zeroes its coefficients. Returns (params, store,
    {'loss': (K,) gathered fetch-time losses})."""
    xc, xs = split_params(cfg, params, sfl.cut_units)
    clients = _host_vector(start_client, np.int64)
    slots = _host_vector(start_slot, np.int64)
    lead = store["srv_keys"].shape[0]
    live = np.flatnonzero((slots >= 0) & (slots < lead))
    fresh = None
    if live.size:
        fresh = _compute_fresh(
            cfg, sfl, xc, xs, batches, live,
            np.clip(clients[live], 0, sfl.n_clients - 1), version_key,
            eval_loss, replay)
    store = scatter_rows(store, slots[live], fresh)
    take = _host_vector(apply_slot, np.int64)
    device = store["loss0"].device
    params = _commit(cfg, sfl, xc, xs, gather_rows(store["srv_keys"], take),
                     gather_rows(store["srv_coeffs"], take),
                     gather_rows(store["ukey"], take),
                     gather_rows(store["ccoeff"], take),
                     _weights(apply_w, sfl, device), replay)
    return params, store, {"loss": gather_rows(store["loss0"], take)}
