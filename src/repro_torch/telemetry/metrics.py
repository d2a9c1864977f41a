"""Metrics registry: counters, gauges and exact-quantile histograms.

Everything here is deliberately zero-dependency and deterministic: a metric
is plain Python state fed by the simulation layers, so two seeded runs that
dispatch the same events record byte-identical snapshots.  Histograms keep
*every* observation and answer quantile queries with the same nearest-rank
arithmetic the serving simulator's latency percentiles use
(:func:`repro_torch.serve.simulator.percentile`) — exact, not sketched, because
the quantities observed live on the simulated clock where an approximation
would be an unforced loss of reproducibility.

Naming convention (informal, enforced only by the callers): dotted paths
namespaced by layer — ``serve.<lane>.latency_s``, ``fabric.contention_factor``,
``tune.trial_cost_s``, ``cosim.repartitions`` — with units suffixed where a
unit exists (``_s`` seconds, ``_rps`` requests/second, ``_bytes``).
"""

from __future__ import annotations

import math


class Counter:
    """Monotonically increasing count (events, trials, SLO misses)."""

    __slots__ = ("name", "value")
    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v

    def snapshot(self) -> dict:
        return {"kind": self.kind, "value": self.value}


class Gauge:
    """Last-write-wins instantaneous value (queue depth, active flows)."""

    __slots__ = ("name", "value")
    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self.value = math.nan

    def set(self, v: float) -> None:
        self.value = v

    def snapshot(self) -> dict:
        return {"kind": self.kind, "value": self.value}


class Histogram:
    """Exact-quantile histogram over every recorded observation.

    Observations are kept verbatim (the simulation horizons here are
    bounded, and exactness is the point); quantiles are nearest-rank on the
    sorted multiset, matching the simulator's latency percentiles.
    """

    __slots__ = ("name", "_values", "_is_sorted", "_sum")
    kind = "histogram"

    def __init__(self, name: str):
        self.name = name
        self._values: list[float] = []
        self._is_sorted = True
        self._sum = 0.0

    def observe(self, v: float) -> None:
        if self._values and v < self._values[-1]:
            self._is_sorted = False
        self._values.append(v)
        self._sum += v

    @property
    def count(self) -> int:
        return len(self._values)

    @property
    def sum(self) -> float:
        return self._sum

    def _sorted(self) -> list[float]:
        if not self._is_sorted:
            self._values.sort()
            self._is_sorted = True
        return self._values

    def quantile(self, q: float) -> float:
        """Exact nearest-rank quantile of everything observed, q in [0, 1]."""
        vals = self._sorted()
        if not vals:
            return math.nan
        idx = max(0, math.ceil(q * len(vals)) - 1)
        return vals[idx]

    def snapshot(self) -> dict:
        vals = self._sorted()
        if not vals:
            return {"kind": self.kind, "count": 0}
        return {
            "kind": self.kind,
            "count": len(vals),
            "sum": self._sum,
            "min": vals[0],
            "max": vals[-1],
            "mean": self._sum / len(vals),
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }


class MetricsRegistry:
    """Get-or-create home for every metric of one telemetry session.

    Asking for an existing name returns the same object; asking for it as a
    different kind is an error (a name means one thing per session).
    Snapshots iterate names in sorted order, so serialized registries are
    deterministic regardless of creation order.
    """

    def __init__(self):
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}

    def _get(self, name: str, cls):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name)
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, not {cls.kind}"
            )
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def __len__(self) -> int:
        return len(self._metrics)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def names(self) -> list[str]:
        return sorted(self._metrics)

    def snapshot(self) -> dict:
        """name -> metric snapshot, names sorted (deterministic)."""
        return {name: self._metrics[name].snapshot() for name in self.names()}
