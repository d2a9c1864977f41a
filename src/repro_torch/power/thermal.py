"""Thermal RC node model per chiplet, integrated on the simulated clock.

Each chiplet is one lumped RC node: junction temperature relaxes toward
``T_ambient + P·R`` with time constant ``τ = R·C``.  The serving simulator
steps the integrator once per monitor window using the *average* electrical
power it accounted over that window — no events are pushed, no wall clock
is read, and the only randomness is a hashed per-chiplet parameter jitter
(:func:`uniform_thermal`), so two runs of the same scenario produce
bit-identical temperature trajectories.

Throttling is hysteretic: a chiplet that crosses ``t_hot_c`` derates its
effective stage times by ``throttle_derate`` (and its electrical draw by
``electrical_derate`` — the forced frequency dip burns superlinearly less)
until it cools below ``t_cool_c``.  Under a steady load just past the hot
threshold this produces the slow *oscillating* derate that
:class:`repro_torch.serve.autotuner.DriftDetector` classifies as ``"throttle"``
drift, distinguishing it from a step ``"slowdown"``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Sequence


def _jitter(key: str, sigma: float) -> float:
    """Deterministic multiplicative jitter in ``[1 - sigma, 1 + sigma]``.

    Same construction as ``repro_torch.core.evaluator._noise``: a sha256 of the
    key mapped to the unit interval, so parameter variation is stable
    across runs and platforms without touching any RNG state.
    """
    h = hashlib.sha256(key.encode()).digest()
    u = int.from_bytes(h[:8], "big") / 2**64
    return 1.0 + sigma * (2.0 * u - 1.0)


@dataclasses.dataclass(eq=False)
class ThermalModel:
    """Per-chiplet lumped RC thermal nodes with hysteretic throttling.

    Mutable simulation state (temperatures, throttle latches) lives on the
    instance, so like :class:`~repro_torch.power.model.PowerModel` it is excluded
    from equality and attached to frozen platforms by reference.
    """

    #: junction-to-ambient thermal resistance per chiplet, K/W
    r_k_per_w: tuple[float, ...]
    #: thermal capacitance per chiplet, J/K
    c_j_per_k: tuple[float, ...]
    t_ambient_c: float = 45.0
    #: throttle engages at or above this junction temperature
    t_hot_c: float = 85.0
    #: throttle releases at or below this (hysteresis band)
    t_cool_c: float = 75.0
    #: stage-time multiplier while throttled (> 1 = slower)
    throttle_derate: float = 1.6

    def __post_init__(self):
        if len(self.r_k_per_w) != len(self.c_j_per_k):
            raise ValueError(
                f"R covers {len(self.r_k_per_w)} chiplets, C covers "
                f"{len(self.c_j_per_k)}"
            )
        if not self.r_k_per_w:
            raise ValueError("thermal model needs at least one chiplet")
        if self.t_cool_c >= self.t_hot_c:
            raise ValueError(
                f"hysteresis band inverted: t_cool {self.t_cool_c} >= "
                f"t_hot {self.t_hot_c}"
            )
        if self.throttle_derate < 1.0:
            raise ValueError("throttle_derate must be >= 1")
        #: current junction temperature per chiplet, °C
        self.temps: list[float] = [self.t_ambient_c] * len(self.r_k_per_w)
        #: throttle latch per chiplet
        self.throttled: list[bool] = [False] * len(self.r_k_per_w)
        #: total throttle engagements since construction
        self.throttle_events: int = 0

    @property
    def n_eps(self) -> int:
        return len(self.r_k_per_w)

    @property
    def electrical_derate(self) -> float:
        """Power reduction factor while throttled.

        The forced clock dip slows compute by ``throttle_derate`` but cuts
        electrical draw quadratically (``f·V²`` with V tracking f would be
        cubic; quadratic is the conservative choice), which is what lets a
        throttled chiplet actually cool and produces the release/re-engage
        oscillation.
        """
        return self.throttle_derate * self.throttle_derate

    def step(self, ep: int, avg_w: float, dt: float) -> float:
        """Advance one chiplet by ``dt`` seconds of ``avg_w`` average draw.

        Exact exponential update of ``dT/dt = (P·R + T_amb − T) / (R·C)``,
        so the trajectory is independent of how the simulator slices the
        window.  Returns the stage-time derate now in force (1.0 or
        ``throttle_derate``).
        """
        r = self.r_k_per_w[ep]
        c = self.c_j_per_k[ep]
        target = avg_w * r + self.t_ambient_c
        alpha = 1.0 - math.exp(-dt / (r * c))
        self.temps[ep] += (target - self.temps[ep]) * alpha
        if self.throttled[ep]:
            if self.temps[ep] <= self.t_cool_c:
                self.throttled[ep] = False
        elif self.temps[ep] >= self.t_hot_c:
            self.throttled[ep] = True
            self.throttle_events += 1
        return self.throttle_derate if self.throttled[ep] else 1.0

    def factor(self, ep: int) -> float:
        return self.throttle_derate if self.throttled[ep] else 1.0

    def restrict(self, keep: Sequence[int]) -> "ThermalModel":
        """Sub-model over the kept chiplets, carrying their current state."""
        sub = ThermalModel(
            r_k_per_w=tuple(self.r_k_per_w[i] for i in keep),
            c_j_per_k=tuple(self.c_j_per_k[i] for i in keep),
            t_ambient_c=self.t_ambient_c,
            t_hot_c=self.t_hot_c,
            t_cool_c=self.t_cool_c,
            throttle_derate=self.throttle_derate,
        )
        sub.temps = [self.temps[i] for i in keep]
        sub.throttled = [self.throttled[i] for i in keep]
        return sub


def uniform_thermal(
    n_eps: int,
    *,
    seed: int = 0,
    r_k_per_w: float = 2.0,
    c_j_per_k: float = 20.0,
    sigma: float = 0.1,
    t_ambient_c: float = 45.0,
    t_hot_c: float = 85.0,
    t_cool_c: float = 75.0,
    throttle_derate: float = 1.6,
) -> ThermalModel:
    """Thermal model with hashed per-chiplet parameter variation.

    Each chiplet's R and C get an independent jitter in ``[1±sigma]`` keyed
    on ``(seed, index)`` — process variation without RNG state.  The
    defaults give ``τ = R·C = 40 s``: slow against a monitor window, fast
    enough to oscillate within a serving horizon.
    """
    if n_eps < 1:
        raise ValueError("need at least one chiplet")
    return ThermalModel(
        r_k_per_w=tuple(
            r_k_per_w * _jitter(f"{seed}|r|{i}", sigma) for i in range(n_eps)
        ),
        c_j_per_k=tuple(
            c_j_per_k * _jitter(f"{seed}|c|{i}", sigma) for i in range(n_eps)
        ),
        t_ambient_c=t_ambient_c,
        t_hot_c=t_hot_c,
        t_cool_c=t_cool_c,
        throttle_derate=throttle_derate,
    )
