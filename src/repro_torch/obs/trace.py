"""Nestable span tracer over the engine hot path.

Design constraints, in order:

1. **Near-zero cost when disabled.** Every instrumentation point calls the
   module-level ``span(name, **attrs)``; when no enabled tracer is
   installed it returns one shared no-op context manager — the cost is a
   global load, an attribute check, and the kwargs dict Python builds
   anyway. No allocation, no clock read, no lock. The disabled path is
   gated by a unit test.
2. **Thread-safe nesting.** The engine's host side is single-threaded
   today, but checkpointing is async and multi-host fleets won't be: the
   span stack is thread-local (so ``depth``/parent attribution is per
   thread) and the finished-record list is appended under a lock.
3. **Standard exports.** ``export_chrome`` writes the Chrome trace-event
   JSON (load in chrome://tracing or https://ui.perfetto.dev);
   ``export_jsonl`` writes one span per line for ad-hoc processing.

Spans measure HOST time (time.perf_counter). Kernel launches return
before the device has run them, so device work is measured by bracketing
dispatch with ``torch.cuda.synchronize`` at chunk boundaries.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional


class SpanRecord(NamedTuple):
    """One finished span."""
    name: str
    start: float         # perf_counter seconds at entry
    duration: float      # seconds
    thread: int          # OS thread ident
    depth: int           # nesting depth within its thread (0 = top level)
    attrs: Dict[str, Any]


class _NullSpan:
    """The shared disabled-path context manager: enters and exits for free
    and swallows nothing (exceptions propagate)."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):             # symmetric API with _Span
        return self


_NULL_SPAN = _NullSpan()


class _Span:
    """A live span; created only when the tracer is enabled."""
    __slots__ = ("_tracer", "name", "attrs", "_t0", "_depth")

    def __init__(self, tracer: "SpanTracer", name: str,
                 attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs

    def set(self, **attrs) -> "_Span":
        """Attach attributes discovered mid-span (e.g. bytes staged)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "_Span":
        stack = self._tracer._stack()
        self._depth = len(stack)
        stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        tracer = self._tracer
        tracer._stack().pop()
        rec = SpanRecord(self.name, self._t0, t1 - self._t0,
                         threading.get_ident(), self._depth, self.attrs)
        with tracer._lock:
            tracer._records.append(rec)
        return False


class SpanTracer:
    """Collects SpanRecords; install one with ``obs.trace.install``."""

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._records: List[SpanRecord] = []
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str, **attrs):
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, attrs)

    def records(self) -> List[SpanRecord]:
        with self._lock:
            return list(self._records)

    def clear(self) -> None:
        with self._lock:
            self._records.clear()

    # -- exports ----------------------------------------------------------

    def export_jsonl(self, path: str) -> int:
        """One span per line: {name, start, duration, thread, depth, attrs}.
        Returns the number of spans written."""
        recs = self.records()
        with open(path, "w", encoding="utf-8") as fh:
            for r in recs:
                fh.write(json.dumps(r._asdict()) + "\n")
        return len(recs)

    def export_chrome(self, path: str) -> int:
        """Chrome trace-event format ('X' complete events, µs timebase) —
        loadable in chrome://tracing / perfetto. Returns the span count."""
        recs = self.records()
        events = [{"name": r.name, "ph": "X", "pid": 0, "tid": r.thread,
                   "ts": r.start * 1e6, "dur": r.duration * 1e6,
                   "args": r.attrs} for r in recs]
        with open(path, "w", encoding="utf-8") as fh:
            json.dump({"traceEvents": events,
                       "displayTimeUnit": "ms"}, fh)
        return len(recs)


# ---------------------------------------------------------------------------
# the module-level instrumentation surface
# ---------------------------------------------------------------------------

_ACTIVE: Optional[SpanTracer] = None


def install(tracer: Optional[SpanTracer]) -> Optional[SpanTracer]:
    """Install (or, with None, remove) the process-wide tracer; returns the
    previously installed one so callers can restore it."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = tracer
    return prev


def get_tracer() -> Optional[SpanTracer]:
    return _ACTIVE


def span(name: str, **attrs):
    """The hot-path probe: ``with span('engine.chunk', r0=r0): ...``.
    Free when no enabled tracer is installed."""
    t = _ACTIVE
    if t is None or not t.enabled:
        return _NULL_SPAN
    return _Span(t, name, attrs)
