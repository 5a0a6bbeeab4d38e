"""The one benchmark measurement helper: (seconds, peak_bytes).

Every perf row records wall time and peak host allocation identically:
gc.collect() first (so a prior row's garbage doesn't count against this
one), tracemalloc around the call (peak Python-heap bytes — device
buffers are invisible here by design; those are accounted by staging_bytes
in RoundTelemetry), perf_counter for wall seconds.

tracemalloc adds real overhead — use this for benchmark rows, never on
the engine hot path (that's what obs.trace spans are for).
"""
from __future__ import annotations

import gc
import tracemalloc
from time import perf_counter
from typing import Any, Callable, NamedTuple


class Measurement(NamedTuple):
    result: Any
    seconds: float
    peak_bytes: int


def measure(fn: Callable[..., Any], *args, **kwargs) -> Measurement:
    """Run ``fn(*args, **kwargs)`` and return (result, seconds, peak_bytes).
    Exception-safe: tracemalloc is stopped even when fn raises (a
    benchmark arm that refuses to run must not poison the next row)."""
    gc.collect()
    tracemalloc.start()
    t0 = perf_counter()
    try:
        out = fn(*args, **kwargs)
        dt = perf_counter() - t0
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    return Measurement(out, dt, peak)
