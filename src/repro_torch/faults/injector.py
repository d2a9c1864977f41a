"""Expanding a :class:`FaultModel` into a concrete, seeded chaos trace.

The injector is where the randomness lives — and where it is pinned.  Every
fault class draws from its own ``random.Random`` stream keyed by
``(model.seed, class, element)`` through SHA-256 (never Python's ``hash``,
whose string salt varies per process), so:

  * the chaos trace is a pure function of (model, platform shape, horizon);
  * adding a fault class, or an element to one, never perturbs the draws of
    any other stream (no shared-stream coupling);
  * the same model replayed against both event engines, or re-run in a
    fresh process, produces the identical trace.

EP and domain failures are alternating up/down renewal processes; an EP's
effective down-time is the *union* of its own process and every domain it
belongs to, merged into disjoint intervals before events are emitted — so
overlapping failures never produce a revival while a correlated fault still
holds the EP down.  Link hard-failures and degradations merge the same way,
with hard failure (factor 0) taking precedence over degradation.
"""

from __future__ import annotations

import hashlib
import random
from typing import Sequence

from .model import FaultEvent, FaultModel


def stream(seed: int, *key: object) -> random.Random:
    """A dedicated RNG for one fault stream, stable across processes."""
    tag = "|".join([str(seed), *[str(k) for k in key]]).encode()
    return random.Random(int.from_bytes(hashlib.sha256(tag).digest()[:8], "big"))


def _down_intervals(
    rng: random.Random, mtbf: float, mttr: float, horizon: float
) -> list[tuple[float, float]]:
    """Down intervals of an alternating Exp(mtbf)/Exp(mttr) renewal process."""
    out: list[tuple[float, float]] = []
    t = rng.expovariate(1.0 / mtbf)
    while t < horizon:
        repair = rng.expovariate(1.0 / mttr)
        out.append((t, t + repair))
        t = t + repair + rng.expovariate(1.0 / mtbf)
    return out


def _merge(intervals: Sequence[tuple[float, float]]) -> list[tuple[float, float]]:
    """Union of half-open intervals as a sorted disjoint list."""
    merged: list[tuple[float, float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


def _in_any(t: float, intervals: Sequence[tuple[float, float]]) -> bool:
    return any(s <= t < e for s, e in intervals)


def _link_events(
    key: tuple[int, int],
    fails: Sequence[tuple[float, float]],
    degrades: Sequence[tuple[float, float]],
    degrade_factor: float,
    horizon: float,
) -> list[FaultEvent]:
    """Piecewise link-state changes; hard failure shadows degradation."""
    times = sorted({t for iv in list(fails) + list(degrades) for t in iv if t < horizon})
    out: list[FaultEvent] = []
    factor = 1.0
    for t in times:
        if _in_any(t, fails):
            now = 0.0
        elif _in_any(t, degrades):
            now = degrade_factor
        else:
            now = 1.0
        if now != factor:
            out.append(FaultEvent(t=t, kind="link", link=key, factor=now))
            factor = now
    return out


class BatchFailureStream:
    """Seeded Bernoulli stream: one draw per served batch, in dispatch order.

    Batch completions cannot be pre-drawn (how many batches a run serves is
    itself an outcome), so transient batch errors consume this stream one
    draw per ``_DONE`` dispatch.  Dispatch order is pinned by the event
    engines' ``(time, kind, push-order)`` contract, making the consumption
    order — and therefore every draw — engine-independent and reproducible.
    """

    def __init__(self, p: float, rng: random.Random):
        self.p = p
        self._rng = rng

    def fails(self) -> bool:
        return self._rng.random() < self.p


class FaultInjector:
    """Expands a :class:`FaultModel` against a concrete platform."""

    def __init__(self, model: FaultModel):
        self.model = model

    def trace(self, platform, horizon: float) -> tuple[FaultEvent, ...]:
        """The full chaos trace over ``[0, horizon)``, sorted by time.

        ``platform`` is duck-typed: ``.n_eps``, ``.eps[i].perf_class`` and
        (optionally) ``.fabric.topology.links`` are all the shape the
        injector reads.  Ties at one timestamp order ``dropout`` before
        ``link`` before ``revival`` — a repair never races ahead of a
        failure scheduled at the same instant.
        """
        m = self.model
        horizon = float(horizon)
        events: list[FaultEvent] = []

        down: dict[int, list[tuple[float, float]]] = {
            ep: [] for ep in range(platform.n_eps)
        }
        for ep in range(platform.n_eps):
            mtbf = m.ep_mtbf.get(platform.eps[ep].perf_class)
            if mtbf is None:
                continue
            mttr = m.ep_mttr[platform.eps[ep].perf_class]
            down[ep].extend(_down_intervals(stream(m.seed, "ep", ep), mtbf, mttr, horizon))
        if m.domain_mtbf is not None:
            for d, members in enumerate(m.domains):
                ivs = _down_intervals(
                    stream(m.seed, "domain", d), m.domain_mtbf, m.domain_mttr, horizon
                )
                for ep in members:
                    if not (0 <= ep < platform.n_eps):
                        raise ValueError(f"failure domain EP {ep} outside platform")
                    down[ep].extend(ivs)
        for ep in range(platform.n_eps):
            for s, e in _merge(down[ep]):
                events.append(FaultEvent(t=s, kind="dropout", ep=ep))
                if e < horizon:
                    events.append(FaultEvent(t=e, kind="revival", ep=ep))

        fabric = getattr(platform, "fabric", None)
        if fabric is not None and (m.link_mtbf is not None or m.degrade_mtbf is not None):
            for key in sorted(fabric.topology.links):
                fails = (
                    _merge(_down_intervals(stream(m.seed, "link", key), m.link_mtbf, m.link_mttr, horizon))
                    if m.link_mtbf is not None
                    else []
                )
                degrades = (
                    _merge(_down_intervals(stream(m.seed, "degrade", key), m.degrade_mtbf, m.degrade_mttr, horizon))
                    if m.degrade_mtbf is not None
                    else []
                )
                events.extend(_link_events(key, fails, degrades, m.degrade_factor, horizon))

        kind_rank = {"dropout": 0, "link": 1, "revival": 2}
        events.sort(
            key=lambda e: (
                e.t,
                kind_rank[e.kind],
                -1 if e.ep is None else e.ep,
                e.link if e.link is not None else (-1, -1),
            )
        )
        return tuple(events)

    def batch_failures(self, label: str) -> BatchFailureStream | None:
        """The per-lane transient-batch-error stream, or None when disabled.

        Keyed by the serving lane's label so co-served tenants draw from
        independent streams regardless of their interleaving.
        """
        if self.model.batch_error_p <= 0.0:
            return None
        return BatchFailureStream(
            self.model.batch_error_p, stream(self.model.seed, "batch", label)
        )
