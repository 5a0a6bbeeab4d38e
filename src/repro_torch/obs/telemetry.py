"""RoundTelemetry + TelemetrySink: the measured record the control loop
reads.

The engine historically had exactly one account of time: the schedule's
*simulated* delays, consumed by AdaptiveTau through SchedWindow. This
module makes that one producer among several. A ``RoundTelemetry`` record
describes a contiguous window of rounds (sync) or versions (async) from
ONE producer's point of view:

  source='sim'       the simulator: per-round durations are the
                     wall-clock model's round times (bit-identical to
                     ChunkInfo.round_times — gated in tests), quorum
                     waits come from the compiled/streamed timeline, and
                     per-cohort arrival latencies are derived from the
                     schedule's delay + uplink rows.
  source='measured'  the measured clock: chunk dispatch bracketed by
                     torch.cuda.synchronize, host staging time (the
                     chunk's host batches and their copies to the
                     device), bytes staged, and the host-prefetch time
                     that overlapped the device work (0 in the
                     synchronous engine).

``TelemetrySink`` is the hub: a bounded ring buffer (deque) the engine
emits into and controllers read from via ``SchedWindow.telemetry``. A
served deployment replaces the simulator producer with real arrival
measurements without touching the controller — that is the sim-to-real
seam.

Records are immutable; array fields are numpy arrays compared bit-for-bit
in the equivalence gates. ``durations`` is always per-round/(C,): the
measured producer spreads the chunk wall time uniformly across its C
rounds, so windows concatenate cleanly across chunk boundaries.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np


class RoundTelemetry(NamedTuple):
    """One producer's account of rounds [start, stop)."""
    start: int                       # first round/version in the window
    stop: int                        # one past the last
    source: str                      # 'sim' | 'measured' | external
    mode: str                        # engine mode: 'scan'|'python'|'async'
    durations: np.ndarray            # (C,) per-round seconds
    quorum_wait: Optional[np.ndarray] = None   # (C,) async quorum waits
    cohort_arrival: Optional[np.ndarray] = None  # (n_cohorts,) mean
    #                                  arrival latency (delay + uplink) of
    #                                  the window's active clients
    staging_seconds: float = 0.0     # host time staging chunk batches
    staging_bytes: int = 0           # bytes staged for the chunk
    dispatch_seconds: float = 0.0    # synchronise-bracketed chunk
    #                                  dispatch wall time
    overlap_seconds: float = 0.0     # host prefetch time overlapped with
    #                                  the device scan (sparse streaming)
    t_wall: float = 0.0              # time.time() at emission
    # fault / degradation counters over the window (core/faults.py): how
    # many dispatched contributions were lost to each cause, plus ring
    # evictions (contribution loss under ring pressure), retransmissions,
    # deduped duplicate deliveries, started dispatches, and commits forced
    # by the quorum_timeout deadline. All zero on a zero-fault run.
    started: int = 0                 # dispatches incl. faulted fetches
    evicted: int = 0                 # ring-store evict-oldest drops
    crashed: int = 0                 # crash-after-fetch
    lost: int = 0                    # all delivery attempts lost
    corrupt: int = 0                 # checksum-dropped payloads
    dups: int = 0                    # duplicate deliveries (deduped)
    retries: int = 0                 # retransmissions consumed
    timeouts: int = 0                # quorum_timeout-forced commits

    @property
    def n_rounds(self) -> int:
        return self.stop - self.start

    def to_json(self) -> Dict[str, Any]:
        """JSON-serializable form (runlog / CI artifacts)."""
        def arr(a):
            return None if a is None else [float(x) for x in np.asarray(a)]
        return {"start": int(self.start), "stop": int(self.stop),
                "source": self.source, "mode": self.mode,
                "durations": arr(self.durations),
                "quorum_wait": arr(self.quorum_wait),
                "cohort_arrival": arr(self.cohort_arrival),
                "staging_seconds": float(self.staging_seconds),
                "staging_bytes": int(self.staging_bytes),
                "dispatch_seconds": float(self.dispatch_seconds),
                "overlap_seconds": float(self.overlap_seconds),
                "t_wall": float(self.t_wall),
                "started": int(self.started),
                "evicted": int(self.evicted),
                "crashed": int(self.crashed), "lost": int(self.lost),
                "corrupt": int(self.corrupt), "dups": int(self.dups),
                "retries": int(self.retries),
                "timeouts": int(self.timeouts)}


def _stamp(rec: RoundTelemetry) -> RoundTelemetry:
    return rec if rec.t_wall else rec._replace(t_wall=time.time())


class TelemetrySink:
    """Bounded ring-buffer hub for RoundTelemetry records.

    Thread-safe: producers ``emit`` under a lock (the async checkpointer
    and future per-host producers share the sink); readers get snapshot
    lists. Capacity bounds memory on long runs — a window query only ever
    needs the last few chunks, and the JSONL run log persists the rest.
    """

    def __init__(self, capacity: int = 1024):
        if capacity <= 0:
            raise ValueError(f"TelemetrySink capacity must be > 0, "
                             f"got {capacity}")
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._emitted = 0

    def emit(self, rec: RoundTelemetry) -> None:
        with self._lock:
            self._ring.append(_stamp(rec))
            self._emitted += 1

    @property
    def emitted(self) -> int:
        """Total records ever emitted (>= len(records()) once the ring
        wraps)."""
        return self._emitted

    def records(self, source: Optional[str] = None) -> List[RoundTelemetry]:
        with self._lock:
            recs = list(self._ring)
        if source is not None:
            recs = [r for r in recs if r.source == source]
        return recs

    def window(self, start: int, stop: int,
               source: Optional[str] = None) -> Tuple[RoundTelemetry, ...]:
        """Records overlapping rounds [start, stop), oldest first — what
        the engine attaches to SchedWindow.telemetry."""
        return tuple(r for r in self.records(source)
                     if r.start < stop and r.stop > start)

    def latest(self, source: Optional[str] = None
               ) -> Optional[RoundTelemetry]:
        recs = self.records(source)
        return recs[-1] if recs else None

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def summary(self) -> Dict[str, Any]:
        """Aggregate view for run-end reporting / the stats surface."""
        recs = self.records()
        out: Dict[str, Any] = {"emitted": self._emitted,
                               "buffered": len(recs), "sources": {}}
        for src in sorted({r.source for r in recs}):
            rs = [r for r in recs if r.source == src]
            durs = np.concatenate([np.asarray(r.durations, np.float64)
                                   for r in rs]) if rs else np.zeros(0)
            s: Dict[str, Any] = {
                "records": len(rs),
                "rounds": int(sum(r.n_rounds for r in rs)),
                "total_duration_s": float(durs.sum()),
                "mean_round_s": float(durs.mean()) if durs.size else 0.0,
                "staging_seconds": float(sum(r.staging_seconds
                                             for r in rs)),
                "staging_bytes": int(sum(r.staging_bytes for r in rs)),
                "dispatch_seconds": float(sum(r.dispatch_seconds
                                              for r in rs)),
                "overlap_seconds": float(sum(r.overlap_seconds
                                             for r in rs)),
            }
            qw = [np.asarray(r.quorum_wait, np.float64) for r in rs
                  if r.quorum_wait is not None]
            if qw:
                allq = np.concatenate(qw)
                s["mean_quorum_wait_s"] = float(allq.mean())
            faults = {f: int(sum(getattr(r, f) for r in rs))
                      for f in ("started", "evicted", "crashed", "lost",
                                "corrupt", "dups", "retries", "timeouts")}
            if any(faults[f] for f in faults if f != "started"):
                s["faults"] = faults
            out["sources"][src] = s
        return out
