"""Arrival-process generators for the serving simulator.

Every generator is a deterministic function of its seed: calling
``arrivals(horizon)`` twice returns the identical timestamp list, and a
recorded trace replays bit-identically (:class:`ReplayTraffic`).  This is
what makes simulator results reproducible across the static-vs-continuous
Shisha comparisons in ``benchmarks/serve_sim.py`` — both arms see the very
same request stream.

Time is *simulated* seconds on the same axis the :class:`~repro_torch.core.evaluator.Trace`
cost accounting uses (a pipeline "beat" = the slowest stage time), so an
arrival rate is directly comparable to the evaluator's steady-state
throughput ``1 / beat``.

Processes:

  * :class:`PoissonTraffic`   — memoryless baseline (open-loop load).
  * :class:`MMPPTraffic`      — 2-state Markov-modulated Poisson process,
    the standard bursty-traffic model (calm/burst states with exponential
    sojourns).
  * :class:`DiurnalTraffic`   — inhomogeneous Poisson with a sinusoidal
    rate profile (a compressed day/night cycle), sampled by thinning.
  * :class:`ReplayTraffic`    — replays an explicit timestamp list; use
    :meth:`ReplayTraffic.record` to freeze any generator into a trace.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Protocol, Sequence

import numpy as np


class TrafficGenerator(Protocol):
    """Anything that can produce a sorted list of arrival times."""

    def arrivals(self, horizon: float) -> list[float]: ...


def _rng(seed: int) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64(seed))


# Arrivals are drawn in chunks of this many exponential gaps at a time; the
# value only trades numpy call overhead against overshoot past the horizon,
# it does not affect the emitted timestamps.
_CHUNK = 4096


# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PoissonTraffic:
    """Homogeneous Poisson arrivals at ``rate`` requests/second.

    Gaps are drawn ``_CHUNK`` at a time and accumulated with a *carry-in*
    cumsum: the running timestamp is written into slot 0 of the work buffer
    so ``np.cumsum`` performs exactly the same left-to-right additions as
    the scalar ``t += gap`` loop it replaced.  (The naive
    ``t + np.cumsum(gaps)`` form is NOT bit-exact — it reassociates the
    carry addition and drifts by 1 ulp at chunk boundaries.)  A PCG64
    ``Generator`` consumes the identical stream for ``exponential(s)``
    scalar draws and one ``exponential(s, size=n)`` array draw, so the
    emitted timestamps are bit-for-bit those of the sequential loop;
    ``tests/test_torch_serve.py`` pins this against an inline scalar
    reference.
    """

    rate: float
    seed: int = 0

    def arrivals(self, horizon: float) -> list[float]:
        if self.rate <= 0:
            return []
        rng = _rng(self.seed)
        scale = 1.0 / self.rate
        out: list[float] = []
        buf = np.empty(_CHUNK + 1)
        t = 0.0
        while True:
            buf[0] = t
            buf[1:] = rng.exponential(scale, size=_CHUNK)
            ts = np.cumsum(buf)[1:]
            cut = int(np.searchsorted(ts, horizon, side="left"))
            out.extend(ts[:cut].tolist())
            if cut < _CHUNK:
                return out
            t = ts[-1]


@dataclasses.dataclass(frozen=True)
class MMPPTraffic:
    """2-state Markov-modulated Poisson process (bursty traffic).

    The process alternates between a *calm* state (``rate_low``) and a
    *burst* state (``rate_high``); sojourn times in each state are
    exponential with means ``mean_calm`` / ``mean_burst`` seconds.
    """

    rate_low: float
    rate_high: float
    mean_calm: float = 5.0
    mean_burst: float = 1.0
    seed: int = 0

    def arrivals(self, horizon: float) -> list[float]:
        # Stays sequential: each draw's distribution depends on the current
        # state, and state flips are decided by comparing against the drawn
        # gap — the stream cannot be pre-drawn in chunks without changing
        # which variates land where.
        rng = _rng(self.seed)
        out: list[float] = []
        t = 0.0
        burst = False
        state_end = rng.exponential(self.mean_calm)
        while t < horizon:
            rate = self.rate_high if burst else self.rate_low
            dt = rng.exponential(1.0 / rate) if rate > 0 else math.inf
            if t + dt < state_end:
                t += dt
                if t < horizon:
                    out.append(t)
            else:
                t = state_end
                burst = not burst
                state_end = t + rng.exponential(self.mean_burst if burst else self.mean_calm)
        return out


@dataclasses.dataclass(frozen=True)
class DiurnalTraffic:
    """Inhomogeneous Poisson with a sinusoidal day/night rate profile.

    ``lambda(t) = base_rate + (peak_rate - base_rate) * (1 - cos(2*pi*t/period)) / 2``
    starts at the ``base_rate`` trough, peaks at ``period/2``.  Sampled by
    thinning against the ``peak_rate`` envelope (Lewis & Shedler), so the
    output is exact for the profile, not a stepwise approximation.
    """

    base_rate: float
    peak_rate: float
    period: float = 60.0
    seed: int = 0

    def rate_at(self, t: float) -> float:
        swing = (1.0 - math.cos(2.0 * math.pi * t / self.period)) / 2.0
        return self.base_rate + (self.peak_rate - self.base_rate) * swing

    def arrivals(self, horizon: float) -> list[float]:
        # Stays sequential: thinning interleaves exponential and uniform
        # draws per candidate, so chunked array draws would consume the
        # PCG64 stream in a different order and change the trace.
        lam_max = max(self.peak_rate, self.base_rate)
        if lam_max <= 0:
            return []
        rng = _rng(self.seed)
        out: list[float] = []
        t = 0.0
        while True:
            t += rng.exponential(1.0 / lam_max)
            if t >= horizon:
                return out
            if rng.uniform() * lam_max <= self.rate_at(t):
                out.append(t)


def interarrival_cv2(times: Sequence[float]) -> float:
    """Squared coefficient of variation of a trace's inter-arrival times.

    The burstiness statistic the MMPP fit keys on: a Poisson stream has
    CV^2 = 1, a Markov-modulated one (calm/burst switching) pushes it above.
    Returns 1.0 for traces too short to estimate (< 3 arrivals).
    """
    if len(times) < 3:
        return 1.0
    gaps = [b - a for a, b in zip(times, times[1:])]
    mean = sum(gaps) / len(gaps)
    if mean <= 0:
        return 1.0
    var = sum((g - mean) ** 2 for g in gaps) / len(gaps)
    return var / (mean * mean)


@dataclasses.dataclass(frozen=True)
class ReplayTraffic:
    """Replays an explicit, frozen timestamp trace."""

    times: tuple[float, ...]

    @classmethod
    def record(cls, gen: TrafficGenerator, horizon: float) -> "ReplayTraffic":
        """Freeze any generator's output into a replayable trace."""
        return cls(times=tuple(gen.arrivals(horizon)))

    def arrivals(self, horizon: float) -> list[float]:
        return [t for t in self.times if t < horizon]

    def save(self, path: str | Path) -> Path:
        p = Path(path)
        p.write_text(json.dumps(list(self.times)))
        return p

    @classmethod
    def load(cls, path: str | Path) -> "ReplayTraffic":
        return cls(times=tuple(json.loads(Path(path).read_text())))

    def fit_mmpp(
        self,
        horizon: float | None = None,
        window: float | None = None,
        cv2_threshold: float = 1.15,
        seed: int = 0,
    ) -> MMPPTraffic:
        """Calibrate a 2-state MMPP to this recorded trace (moments fit).

        Method of moments on the trace's burstiness statistics, so synthetic
        load can be matched to a production arrival log:

          1. The inter-arrival CV^2 (:func:`interarrival_cv2`) gates the
             model: at or below ``cv2_threshold`` the trace is Poisson-like
             and the fit degenerates to ``rate_low == rate_high == n/T``
             (an MMPP whose states are indistinguishable).
          2. Otherwise arrivals are counted in windows of length ``window``
             (default: sized for ~8 expected arrivals, enough signal to
             separate the states) and windows are classified calm/burst by
             thresholding at the mean count — the two conditional first
             moments give ``rate_low``/``rate_high``, and the mean run
             lengths of consecutive same-class windows give the exponential
             sojourn means ``mean_calm``/``mean_burst``.

        Deterministic; the returned generator replays nothing — it is a
        fresh seeded process whose statistics match the recording.
        """
        times = sorted(self.times)
        if horizon is not None:
            # fit the horizon prefix: arrivals past an explicit (exclusive)
            # horizon would otherwise inflate the mean rate and pile into
            # the last counting window as a spurious burst
            times = [t for t in times if t < horizon]
        T = horizon if horizon is not None else (times[-1] if times else 0.0)
        if T <= 0 or len(times) < 4:
            rate = len(times) / T if T > 0 else 0.0
            return MMPPTraffic(rate_low=rate, rate_high=rate, seed=seed)
        rate_mean = len(times) / T
        if interarrival_cv2(times) <= cv2_threshold:
            return MMPPTraffic(rate_low=rate_mean, rate_high=rate_mean, seed=seed)
        w = window if window is not None else 8.0 / rate_mean
        n_win = max(2, int(math.ceil(T / w)))
        counts = [0] * n_win
        for t in times:
            counts[min(int(t / w), n_win - 1)] += 1
        mean_count = sum(counts) / n_win
        burst = [c > mean_count for c in counts]
        if all(burst) or not any(burst):  # threshold failed to split: flat
            return MMPPTraffic(rate_low=rate_mean, rate_high=rate_mean, seed=seed)
        n_burst = sum(burst)
        arr_burst = sum(c for c, b in zip(counts, burst) if b)
        arr_calm = sum(c for c, b in zip(counts, burst) if not b)
        rate_high = arr_burst / (n_burst * w)
        rate_low = arr_calm / ((n_win - n_burst) * w)
        # mean sojourn = window length x mean run of same-class windows
        runs: dict[bool, list[int]] = {True: [], False: []}
        length = 1
        for prev, cur in zip(burst, burst[1:]):
            if cur == prev:
                length += 1
            else:
                runs[prev].append(length)
                length = 1
        runs[burst[-1]].append(length)
        mean_burst = w * sum(runs[True]) / len(runs[True])
        mean_calm = w * sum(runs[False]) / len(runs[False])
        return MMPPTraffic(
            rate_low=rate_low,
            rate_high=rate_high,
            mean_calm=mean_calm,
            mean_burst=mean_burst,
            seed=seed,
        )
