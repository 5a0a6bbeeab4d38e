"""Counters / gauges / histograms registry.

The aggregate face of the observability layer: spans and RoundTelemetry
are per-event records; metrics are the cheap running totals a CLI flag
(`train.py --telemetry`) can print at any moment without walking the
ring buffers.

Deliberately tiny and dependency-free:

  Counter    monotonically increasing float (``inc``)
  Gauge      last-written value (``set``)
  Histogram  streaming count/sum/min/max + fixed log-spaced buckets
             (``observe``) — enough for latency tails without reservoirs

All instruments are created through a ``MetricsRegistry`` so a snapshot
is one dict, JSON-ready. A process-wide registry is available via
``get_registry()`` for the launch layer; libraries should accept a
registry argument instead of importing the global.
"""
from __future__ import annotations

import bisect
import threading
from typing import Any, Dict, List, Optional, Tuple

# Default histogram buckets: log-spaced seconds, 1µs .. 100s.
_DEFAULT_BUCKETS = tuple(m * (10.0 ** e) for e in range(-6, 3)
                         for m in (1.0, 2.5, 5.0))


class Counter:
    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"Counter {self.name}: negative inc {amount}")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> Dict[str, Any]:
        return {"type": "counter", "value": self._value}


class Gauge:
    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0

    def set(self, value: float) -> None:
        self._value = float(value)

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> Dict[str, Any]:
        return {"type": "gauge", "value": self._value}


class Histogram:
    __slots__ = ("name", "buckets", "_counts", "_count", "_sum",
                 "_min", "_max", "_lock")

    def __init__(self, name: str,
                 buckets: Optional[Tuple[float, ...]] = None):
        self.name = name
        self.buckets = tuple(sorted(buckets or _DEFAULT_BUCKETS))
        self._counts = [0] * (len(self.buckets) + 1)  # +1 = overflow
        self._count = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        value = float(value)
        idx = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._counts[idx] += 1
            self._count += 1
            self._sum += value
            if value < self._min:
                self._min = value
            if value > self._max:
                self._max = value

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def quantile(self, q: float) -> float:
        """Approximate quantile from bucket upper bounds (the standard
        histogram-quantile estimate; exact enough for latency tails)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self._count == 0:
            return 0.0
        rank = q * self._count
        seen = 0
        for i, c in enumerate(self._counts):
            seen += c
            if seen >= rank:
                return self.buckets[i] if i < len(self.buckets) else self._max
        return self._max

    def snapshot(self) -> Dict[str, Any]:
        return {"type": "histogram", "count": self._count,
                "sum": self._sum, "mean": self.mean,
                "min": self._min if self._count else 0.0,
                "max": self._max if self._count else 0.0,
                "p50": self.quantile(0.5), "p99": self.quantile(0.99)}


class MetricsRegistry:
    """Name → instrument map; instruments are create-or-get so call sites
    don't coordinate. Names collide across kinds deliberately (an error):
    one name, one meaning."""

    def __init__(self):
        self._instruments: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls, *args):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, *args)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, requested {cls.__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  buckets: Optional[Tuple[float, ...]] = None) -> Histogram:
        return self._get(name, Histogram, buckets)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._instruments)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            insts = dict(self._instruments)
        return {name: inst.snapshot() for name, inst in sorted(insts.items())}

    def clear(self) -> None:
        with self._lock:
            self._instruments.clear()


_GLOBAL = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide registry used by the launch layer."""
    return _GLOBAL
