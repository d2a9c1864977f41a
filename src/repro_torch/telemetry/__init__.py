"""``repro_torch.telemetry`` — cross-layer observability for the co-simulation stack.

Three parts, all zero-dependency and deterministic under seeded runs:

  * :mod:`.metrics` — a registry of counters, gauges and **exact-quantile**
    histograms on the simulated clock: the serving simulator feeds it
    per-event (queue depths, batch occupancy, SLO hits/misses), the fabric
    per-routing-pass (link loads, fair-share contention factor, hotspot
    saturation, adaptive-vs-static price deltas), the tuner per-trial
    (move kinds, beat deltas, charged wall cost).
  * :mod:`.tracer` — a structured span/event timeline (request lifecycles,
    re-tune exploration windows, repartition/revival decisions, per-window
    fabric flow injections) exportable as JSONL and as Chrome trace-event
    JSON loadable in Perfetto — tenants as processes, EPs/links as tracks.
  * :mod:`.core` — the :class:`Telemetry` facade tying both to the
    wall-clock :meth:`~repro_torch.telemetry.core.Telemetry.timed` profiling hooks
    that the JAX package's ``benchmarks/selfbench.py`` turns into a simulated-events/sec
    trajectory (``BENCH_selfbench.json``).

Everything is **off by default**: every instrumented constructor accepts
``telemetry=None`` (or the explicit no-op :data:`NULL` sink) and the hot
paths then reduce to one ``is not None`` check, keeping un-instrumented
results bit-for-bit identical to the pre-telemetry stack.  Exported
artifacts contain only simulated timestamps, never wall time, so two seeded
runs export byte-identical traces.
"""

from .core import NULL, NullTelemetry, Telemetry, live
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .tracer import SpanTracer, TraceEvent

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL",
    "NullTelemetry",
    "SpanTracer",
    "Telemetry",
    "TraceEvent",
    "live",
]
