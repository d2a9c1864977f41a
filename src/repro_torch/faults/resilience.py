"""Request-level resilience policy: deadlines, retries, load shedding.

A :class:`ResiliencePolicy` tells the serving simulator how to degrade
*gracefully* when the chaos layer strikes: requests carry deadlines, failed
batches re-enter after seeded exponential backoff (up to a retry cap),
and the admission queue is bounded with deadline-aware shedding instead of
growing without limit.  Every knob defaults to off — a lane with no policy
(or the default one) behaves bit-for-bit as before this layer existed.

Backoff jitter is *keyed*, not streamed: the delay of attempt ``k`` of
request ``r`` is a pure function of (policy seed, r, k) through SHA-256,
so retry timing never depends on the order failures happen to interleave —
the same property that keeps the fabric's tie-breaks replay-stable.
"""

from __future__ import annotations

import dataclasses
import hashlib


@dataclasses.dataclass(frozen=True)
class ResiliencePolicy:
    """Serving-lane resilience knobs.  All off by default."""

    #: per-request completion deadline, seconds after arrival; None = none.
    #: Completions past their deadline still count as throughput but not as
    #: goodput, and expired queued requests become sheddable.
    deadline_s: float | None = None
    #: how many times a failed batch's requests are re-served before being
    #: counted as failed
    max_retries: int = 3
    #: base retry delay; attempt ``k`` waits ``backoff_s * 2**(k-1)`` plus
    #: keyed jitter
    backoff_s: float = 0.05
    #: jitter amplitude as a fraction of the exponential backoff
    jitter: float = 0.25
    #: key for the jitter hash (NOT a stream seed — see module docstring)
    seed: int = 0
    #: admission-queue bound (stage-0 queued requests); None = unbounded
    queue_cap: int | None = None
    #: shed queued requests that have already missed their deadline instead
    #: of serving them (only meaningful with ``deadline_s`` set)
    shed_expired: bool = True

    def __post_init__(self):
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(f"deadline must be positive, got {self.deadline_s}")
        if self.max_retries < 0:
            raise ValueError(f"retry cap must be >= 0, got {self.max_retries}")
        if self.backoff_s < 0 or self.jitter < 0:
            raise ValueError("backoff and jitter must be non-negative")
        if self.queue_cap is not None and self.queue_cap < 1:
            raise ValueError(f"queue cap must be >= 1, got {self.queue_cap}")

    def backoff(self, rid: int, attempt: int) -> float:
        """Deterministic exponential backoff with keyed jitter (seconds)."""
        base = self.backoff_s * (2.0 ** (attempt - 1))
        tag = f"{self.seed}|{rid}|{attempt}".encode()
        u = int.from_bytes(hashlib.sha256(tag).digest()[:8], "big") / 2.0**64
        return base * (1.0 + self.jitter * u)

    def expired(self, t_arrival: float, now: float) -> bool:
        """Has a request that arrived at ``t_arrival`` missed its deadline?"""
        return self.deadline_s is not None and now > t_arrival + self.deadline_s
