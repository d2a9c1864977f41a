"""The :class:`Telemetry` facade the simulation layers record into.

One ``Telemetry`` object is one observation session: a
:class:`~repro_torch.telemetry.metrics.MetricsRegistry`, a
:class:`~repro_torch.telemetry.tracer.SpanTracer` and a wall-clock profile for
the :meth:`Telemetry.timed` hooks, shared by every layer of a run (serving
lanes, co-simulator, tuner traces, fabric).  Pass it to
``ServingSimulator(..., telemetry=...)`` / ``co_serve(..., telemetry=...)``
and export afterwards.

Observability is **off by default**: constructors take ``telemetry=None``
and the instrumented hot paths reduce to a single ``is not None`` check, so
un-instrumented runs stay bit-for-bit what they were.  :class:`NullTelemetry`
(exported as :data:`NULL`) is the explicit no-op sink for callers that want
an object rather than ``None`` — it accepts every call, records nothing,
and reports ``enabled = False``, which the constructors normalize to the
same disabled fast path.

Clock discipline: everything *exported* (metrics observations, span/instant
timestamps) lives on the simulated clock, so seeded runs export
byte-identical artifacts.  The only wall-clock state is :attr:`Telemetry
.profile`, fed by ``timed()`` scopes around real hot loops; it exists for
``benchmarks/selfbench.py`` (simulated-events/sec) and is deliberately kept
out of every trace/JSONL export.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

from .metrics import MetricsRegistry
from .tracer import SpanTracer


class _Timer:
    """Accumulates perf_counter wall time into a profile slot."""

    __slots__ = ("_profile", "_scope", "_t0")

    def __init__(self, profile: dict, scope: str):
        self._profile = profile
        self._scope = scope

    def __enter__(self):
        # the one sanctioned wall-clock instrument: timed() profiles real
        # elapsed time by design and its readings are never exported into
        # seeded artifacts (see profile_snapshot)
        self._t0 = time.perf_counter()  # shisha: allow(wall-clock)
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0  # shisha: allow(wall-clock)
        slot = self._profile.get(self._scope)
        if slot is None:
            self._profile[self._scope] = [1, dt]
        else:
            slot[0] += 1
            slot[1] += dt
        return False


class Telemetry:
    """Live observation session: metrics + spans + wall-clock profile."""

    #: constructors treat a telemetry object with ``enabled = False`` (see
    #: :class:`NullTelemetry`) exactly like ``None``
    enabled = True

    def __init__(self):
        self.registry = MetricsRegistry()
        self.tracer = SpanTracer()
        #: scope -> [calls, wall seconds]; wall-clock by design, never exported
        self.profile: dict[str, list] = {}
        #: current simulated time, maintained by the event loop that owns
        #: this session (convenience for recorders without a timestamp)
        self.now = 0.0

    # -- metrics ------------------------------------------------------------

    def counter(self, name: str):
        return self.registry.counter(name)

    def gauge(self, name: str):
        return self.registry.gauge(name)

    def histogram(self, name: str):
        return self.registry.histogram(name)

    # -- tracing ------------------------------------------------------------

    def span(self, name: str, ts: float, dur: float, **kw) -> None:
        self.tracer.span(name, ts, dur, **kw)

    def instant(self, name: str, ts: float, **kw) -> None:
        self.tracer.instant(name, ts, **kw)

    def counter_track(self, name: str, ts: float, value: float, **kw) -> None:
        """One sample of a Perfetto counter track (temperature, watts)."""
        self.tracer.counter(name, ts, value, **kw)

    # -- profiling hooks -----------------------------------------------------

    def timed(self, scope: str) -> _Timer:
        """``with telemetry.timed("event_loop.run"): ...`` — wall profiling."""
        return _Timer(self.profile, scope)

    def profile_snapshot(self) -> dict:
        """scope -> {calls, wall_s}, sorted; for benchmark payloads only."""
        return {
            scope: {"calls": calls, "wall_s": wall}
            for scope, (calls, wall) in sorted(self.profile.items())
        }

    # -- exports (simulated-clock artifacts only) ----------------------------

    def metrics_snapshot(self) -> dict:
        return self.registry.snapshot()

    def export_jsonl(self, path=None) -> str:
        """The timeline as JSONL; optionally written to ``path``."""
        text = self.tracer.to_jsonl()
        if path is not None:
            p = Path(path)
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_text(text)
        return text

    def export_chrome_trace(self, path=None) -> dict:
        """The timeline as Chrome trace-event JSON (Perfetto-loadable)."""
        trace = self.tracer.to_chrome()
        if path is not None:
            p = Path(path)
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_text(json.dumps(trace, sort_keys=True, indent=1))
        return trace


class _NullMetric:
    """Accepts any record call, keeps nothing."""

    __slots__ = ()

    def inc(self, v: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass


class _NullTimer:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_METRIC = _NullMetric()
_NULL_TIMER = _NullTimer()


class NullTelemetry(Telemetry):
    """The no-op sink: same interface, records nothing, ``enabled = False``.

    Instrumented constructors normalize it to their ``None`` fast path, so
    passing ``NULL`` costs exactly what passing nothing costs — the contract
    ``tests/test_torch_telemetry.py`` pins (bit-identical summaries, empty sink).
    """

    enabled = False

    def counter(self, name: str):
        return _NULL_METRIC

    def gauge(self, name: str):
        return _NULL_METRIC

    def histogram(self, name: str):
        return _NULL_METRIC

    def span(self, name: str, ts: float, dur: float, **kw) -> None:
        pass

    def instant(self, name: str, ts: float, **kw) -> None:
        pass

    def counter_track(self, name: str, ts: float, value: float, **kw) -> None:
        pass

    def timed(self, scope: str) -> _NullTimer:
        return _NULL_TIMER


#: shared no-op sink; safe to pass anywhere a Telemetry is accepted
NULL = NullTelemetry()


def live(telemetry: "Telemetry | None") -> "Telemetry | None":
    """Normalize to the hot-path sentinel: a live session or ``None``.

    Instrumented constructors call this once so their per-event guard is a
    single ``is not None`` check (``NULL`` and ``None`` both disable).
    """
    return telemetry if telemetry is not None and telemetry.enabled else None
