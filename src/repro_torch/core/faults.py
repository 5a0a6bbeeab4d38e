"""Fault injection for the event-driven execution substrate (a copy of
``repro.core.faults``, numpy only).

A ``FaultPlan`` is the declarative description of everything that can go
wrong between a version broadcast and its commit:

  crash     a client crashes after fetching params (its contribution never
            materializes); it re-enters the idle pool only after an
            exponential-backoff re-dispatch delay (``backoff * 2**streak``
            simulated seconds, streak = consecutive crashes).
  loss      a delivery attempt is lost in transit; the client retransmits
            (one uplink ``t_comm`` per attempt) up to ``max_retries`` times
            before the contribution is dropped for good.
  dup       a delivery arrives twice; the duplicate is deduped by
            (client, round_of_origin) — one in-flight record per client is
            an invariant of the store, so the copy is counted and discarded.
  corrupt   the payload arrives with a bad coefficient checksum (see
            ``record_checksum``) and is dropped at delivery; the client is
            free to re-fetch at the next broadcast.
  kill      host-kill schedule: the train driver SIGKILLs itself when the
            run reaches this round — exercised by the crash-safe-checkpoint
            resume gate, never by the DES itself.

The plan is a frozen, hashable dataclass so it can live in the frozen
``SFLConfig``. Every fault decision is a
counter-based SplitMix64 draw (``straggler._hash_uniform``) keyed on
(seed, lane, version, client) with lanes 4..7 — disjoint from the
schedule's participation/delay/Markov lanes 0..3 — so the dense compiler
and the sparse DES make bit-identical decisions, and a resumed or
re-planned stream replays the same faults (prefix stability).

The zero-fault contract: ``FaultPlan.none()`` (or ``faults=None``) must
leave the event stream byte-identical to an engine without this module —
callers gate every fault branch on ``plan.any()`` and consume no extra
randomness when it is False.

CLI grammar (``parse_faults``), population-style::

    faults:crash=0.2,loss=0.1,dup=0.05,corrupt=0.01,backoff=0.5,kill=6
    faults:crash=0.05,crash@slow=0.4        # per-cohort override by name
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.straggler import _hash_uniform

__all__ = ["FaultPlan", "ResolvedFaults", "parse_faults",
           "record_checksum", "OUT_DELIVER", "OUT_CRASH", "OUT_LOST",
           "OUT_CORRUPT"]

# keyed-draw lanes (straggler.py owns 0..3: participation, delays, Markov)
_LANE_CRASH = 4
_LANE_LOSS = 5
_LANE_DUP = 6
_LANE_CORRUPT = 7

# per-dispatch outcomes (ResolvedFaults.dispatch_fates)
OUT_DELIVER = 0     # arrives intact at `arrival` (after `retries` resends)
OUT_CRASH = 1       # crashed after fetch; idle again at `ready` (backoff)
OUT_LOST = 2        # every attempt lost; idle again at `ready`
OUT_CORRUPT = 3     # arrives at `arrival`, checksum fails, dropped there

# staleness codes for dropped contributions in the flat event view
# (>= 0: applied; -1: in flight at horizon / evicted — pre-existing)
STALE_CRASH = -2
STALE_LOST = -3
STALE_CORRUPT = -4

_FIELDS = ("crash", "loss", "dup", "corrupt")
_MAX_RETRY_STRIDE = 64          # loss draws key r = version*stride + attempt


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Hashable fault description (rates are per-dispatch probabilities)."""
    crash: float = 0.0
    loss: float = 0.0
    dup: float = 0.0
    corrupt: float = 0.0
    backoff: float = 0.5        # crash re-dispatch base delay (sim seconds)
    kill_round: int = -1        # host-kill schedule (-1 = never)
    # per-cohort rate overrides: (field, cohort_name, rate) triples
    overrides: Tuple[Tuple[str, str, float], ...] = ()

    def __post_init__(self):
        for f in _FIELDS:
            p = getattr(self, f)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"faults: {f}={p} outside [0, 1]")
        if self.backoff < 0:
            raise ValueError(f"faults: backoff={self.backoff} < 0")
        for field, cohort, rate in self.overrides:
            if field not in _FIELDS:
                raise ValueError(
                    f"faults: unknown override field {field!r} "
                    f"(expected one of {_FIELDS})")
            if not 0.0 <= rate <= 1.0:
                raise ValueError(
                    f"faults: {field}@{cohort}={rate} outside [0, 1]")

    @classmethod
    def none(cls) -> "FaultPlan":
        return cls()

    def any(self) -> bool:
        """True when the DES must take fault branches at all. kill_round
        is driver-side (checkpoint exercise), not an event perturbation."""
        return any(getattr(self, f) > 0.0 for f in _FIELDS) or \
            any(rate > 0.0 for _, _, rate in self.overrides)

    def describe(self) -> str:
        parts = [f"{f}={getattr(self, f):g}" for f in _FIELDS
                 if getattr(self, f) > 0]
        parts += [f"{f}@{c}={r:g}" for f, c, r in self.overrides]
        if self.kill_round >= 0:
            parts.append(f"kill={self.kill_round}")
        return ",".join(parts) or "none"

    def resolve(self, n_clients: int, population=None,
                seed: int = 0) -> "ResolvedFaults":
        """Expand per-cohort overrides into (M,) per-client rate vectors.

        ``population`` is a ClientPopulation (or None for a scalar fleet);
        overrides name its cohorts. ``seed`` keys the fault draw lanes —
        callers pass the schedule seed so faults replay with the schedule.
        """
        M = int(n_clients)
        rates = {f: np.full(M, getattr(self, f), np.float64)
                 for f in _FIELDS}
        if self.overrides:
            if population is None:
                names = ", ".join(sorted({c for _, c, _ in self.overrides}))
                raise ValueError(
                    f"faults: cohort overrides ({names}) need a population")
            slices = {c.name: s for c, s in
                      zip(population.cohorts, population.slices())}
            for field, cohort, rate in self.overrides:
                if cohort not in slices:
                    raise ValueError(
                        f"faults: unknown cohort {cohort!r} "
                        f"(population has {sorted(slices)})")
                rates[field][slices[cohort]] = rate
        return ResolvedFaults(
            crash=rates["crash"], loss=rates["loss"], dup=rates["dup"],
            corrupt=rates["corrupt"], backoff=float(self.backoff),
            seed=int(seed))


class ResolvedFaults:
    """Per-client fault rates + the deterministic per-dispatch fate draw.

    Host-side only: the DES consumes this, and no device code reads it.
    """

    def __init__(self, *, crash: np.ndarray, loss: np.ndarray,
                 dup: np.ndarray, corrupt: np.ndarray, backoff: float,
                 seed: int):
        self.crash = crash
        self.loss = loss
        self.dup = dup
        self.corrupt = corrupt
        self.backoff = float(backoff)
        self.seed = int(seed)

    def dispatch_fates(self, v: int, ids: np.ndarray, t0: float,
                       delays: np.ndarray, comm: np.ndarray,
                       streaks: np.ndarray, max_retries: int
                       ) -> Dict[str, np.ndarray]:
        """The fate of each contribution dispatched at version ``v``.

        All arrays are over the dispatched ``ids`` (ascending client id).
        Deterministic: draws key on (seed, lane, version[, attempt],
        client), so both timeline backends and any replayed prefix agree.

          outcome   OUT_DELIVER / OUT_CRASH / OUT_LOST / OUT_CORRUPT
          arrival   delivery time for DELIVER/CORRUPT —
                    t0 + delay + (retries + 1) * comm (one uplink per
                    attempt, the retransmission model)
          ready     when a CRASH/LOST/CORRUPT client re-enters the idle
                    pool (crash: t0 + backoff * 2**streak; lost: the
                    moment the final attempt is known lost; corrupt: the
                    corrupted arrival itself)
          retries   retransmissions consumed (0 for a first-try delivery)
          dup       duplicated-delivery flag on delivered contributions
                    (deduped by construction — counted only)
        """
        if max_retries >= _MAX_RETRY_STRIDE:
            raise ValueError(
                f"max_retries={max_retries} >= {_MAX_RETRY_STRIDE}")
        ids = np.asarray(ids, np.int64)
        K = ids.size
        seed = self.seed
        crashed = _hash_uniform(seed, _LANE_CRASH, v, ids) < self.crash[ids]
        # first successful delivery attempt (a resend per lost attempt)
        attempt = np.zeros(K, np.int64)
        undelivered = np.ones(K, bool)
        for a in range(int(max_retries) + 1):
            lost_a = _hash_uniform(seed, _LANE_LOSS,
                                   v * _MAX_RETRY_STRIDE + a, ids) \
                < self.loss[ids]
            landed = undelivered & ~lost_a
            attempt[landed] = a
            undelivered &= lost_a
            if not undelivered.any():
                break
        all_lost = undelivered & ~crashed
        arrival = t0 + delays + (attempt + 1).astype(np.float64) * comm
        last_try = t0 + delays + float(max_retries + 1) * comm
        corrupt = (_hash_uniform(seed, _LANE_CORRUPT, v, ids)
                   < self.corrupt[ids]) & ~crashed & ~all_lost
        dup = (_hash_uniform(seed, _LANE_DUP, v, ids) < self.dup[ids]) \
            & ~crashed & ~all_lost
        outcome = np.full(K, OUT_DELIVER, np.int8)
        outcome[corrupt] = OUT_CORRUPT
        outcome[all_lost] = OUT_LOST
        outcome[crashed] = OUT_CRASH
        ready = np.zeros(K, np.float64)
        ready[crashed] = t0 + self.backoff * \
            np.power(2.0, streaks[ids][crashed].astype(np.float64))
        ready[all_lost] = last_try[all_lost]
        ready[corrupt] = arrival[corrupt]
        retries = np.where(all_lost, max_retries, attempt).astype(np.int64)
        retries[crashed] = 0
        return {"outcome": outcome, "arrival": arrival, "ready": ready,
                "retries": retries, "dup": dup}


def parse_faults(spec: str) -> FaultPlan:
    """Parse the ``faults:crash=p,loss=q,...`` CLI grammar.

    Items are comma-separated ``key=value`` pairs; rate keys (crash, loss,
    dup, corrupt) accept a per-cohort override ``key@cohort=value``;
    ``backoff`` is the crash re-dispatch base delay in simulated seconds
    and ``kill`` the host-kill round. The ``faults:`` prefix is optional.
    """
    body = spec[len("faults:"):] if spec.startswith("faults:") else spec
    kw: Dict[str, object] = {}
    overrides: List[Tuple[str, str, float]] = []
    for item in body.split(","):
        item = item.strip()
        if not item:
            continue
        try:
            key, val = item.split("=", 1)
        except ValueError:
            raise ValueError(
                f"bad faults item {item!r}: expected key=value "
                "(e.g. 'faults:crash=0.2,loss=0.1,backoff=0.5,kill=6')")
        key = key.strip()
        if "@" in key:
            field, cohort = key.split("@", 1)
            if field not in _FIELDS:
                raise ValueError(
                    f"bad faults item {item!r}: only {_FIELDS} take "
                    "@cohort overrides")
            overrides.append((field, cohort, float(val)))
        elif key in _FIELDS or key == "backoff":
            kw[key] = float(val)
        elif key == "kill":
            kw["kill_round"] = int(val)
        else:
            raise ValueError(
                f"bad faults item {item!r}: unknown key {key!r} "
                f"(expected one of {_FIELDS + ('backoff', 'kill')})")
    return FaultPlan(overrides=tuple(overrides), **kw)   # type: ignore[arg-type]


def record_checksum(*arrays) -> int:
    """Content checksum over seed-replay record arrays (keys + coeffs).

    The corruption detector of the wire format: a contribution's records
    are (key, coeff) pairs, so a CRC over their raw bytes is the cheapest
    end-to-end integrity check, computed host-side at payload
    boundaries.
    """
    crc = 0
    for a in arrays:
        crc = zlib.crc32(np.ascontiguousarray(a).tobytes(), crc)
    return crc & 0xFFFFFFFF
