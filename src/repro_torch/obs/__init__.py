"""Observability substrate: telemetry records, span tracing, metrics
(counterpart of ``repro.obs``, copied whole: it imports neither the
engine nor any array library).

The sim-to-real seam: a control decision in the engine (AdaptiveTau
re-planning τ) can read the schedule's *simulated* delays or what the
card actually took. This package is the measurement layer both the
simulator and the engine feed:

  telemetry   RoundTelemetry (per-chunk durations, quorum waits,
              per-cohort arrival latencies, staging bytes, host-prefetch
              vs device-scan overlap) + TelemetrySink, a ring-buffer hub
              with named producers — the simulator is just one of them.
  trace       a nestable, thread-safe span tracer (perf_counter) with
              Chrome-trace / JSONL export, near-zero-cost when disabled,
              installed over the engine hot path (batch staging, chunk
              dispatch, flush).
  metrics     a counters/gauges/histograms registry surfaced by
              launch/train.py (--telemetry).
  measure     the (seconds, peak_bytes) perf_counter + tracemalloc
              helper every benchmark row is measured with.
  runlog      structured JSONL run log (per-round rows + per-chunk
              telemetry), resume-safe (never duplicates rounds).

Nothing here imports torch or the engine: probes are host-side and read
at chunk boundaries only, where the engine synchronises the device.
"""
from repro_torch.obs.measure import Measurement, measure
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, get_registry)
from repro_torch.obs.runlog import RunLog, read_jsonl
from repro_torch.obs.telemetry import RoundTelemetry, TelemetrySink
from repro_torch.obs.trace import (SpanRecord, SpanTracer, get_tracer,
                                   install, span)

__all__ = [
    "Measurement", "measure",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_registry",
    "RunLog", "read_jsonl",
    "RoundTelemetry", "TelemetrySink",
    "SpanRecord", "SpanTracer", "get_tracer", "install", "span",
]
