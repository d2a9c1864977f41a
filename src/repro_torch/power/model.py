"""Package power model: per-EP DVFS ladders under a package power cap.

The lumos MPSoC models (SNIPPETS.md §1–2) build heterogeneous systems from
explicit per-core power budgets; CHIPSIM couples power and thermal to
chiplet DL performance.  This module gives ``Platform`` that axis with zero
dependencies:

  * :class:`DVFSLevel` — one frequency/voltage operating point: a ``scale``
    factor applied to the EP's compute rate *and* memory bandwidth (the
    evaluators divide nominal stage times by it), plus the dynamic watts
    drawn while serving and the static leakage watts drawn always.
  * :class:`EPPowerSpec` — one EP's DVFS ladder, fastest level first.
  * :class:`PowerModel` — the package: one spec per EP, the *current* level
    per EP as mutable state (like :class:`~repro_torch.interconnect.Fabric`, it is
    attached to a frozen ``Platform`` via a compare-excluded field), and a
    package-level power cap.  Peak package power is pure model-side
    arithmetic — ``Σ static + Σ dynamic(in-use)`` — so cap feasibility is
    checked *before* paying an online trial, exactly like the elastic
    partitioner's pricing.

Attachment follows the fabric playbook: off by default (``Platform.power``
is ``None`` and every consumer guards with one ``is not None`` check), and
a :func:`degenerate_power` model — a single nominal level of ``scale=1.0``
under an infinite cap — reproduces the power-free results bit-for-bit
(dividing a float by exactly ``1.0`` is an identity in IEEE 754).

Determinism: the model owns no randomness and never reads the wall clock;
the only state is the per-EP level vector, mutated explicitly by the tuner
(:func:`repro_torch.core.tuner.tune` with ``dvfs=True``) and the serving layer's
throttle response.
"""

from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, Iterable, Sequence

if TYPE_CHECKING:
    from .thermal import ThermalModel


@dataclasses.dataclass(frozen=True)
class DVFSLevel:
    """One operating point of an EP's frequency/voltage ladder."""

    name: str
    #: relative clock: compute rate and memory bandwidth multiply by this
    #: (1.0 = nominal); stage times divide by it
    scale: float
    #: power drawn while the EP is serving a batch, watts
    dynamic_w: float
    #: leakage drawn always (busy or idle), watts
    static_w: float

    def __post_init__(self):
        if not 0.0 < self.scale <= 1.0:
            raise ValueError(f"level scale must be in (0, 1], got {self.scale}")
        if self.dynamic_w < 0 or self.static_w < 0:
            raise ValueError("level watts must be non-negative")


@dataclasses.dataclass(frozen=True)
class EPPowerSpec:
    """One EP's DVFS ladder, fastest (largest ``scale``) level first."""

    levels: tuple[DVFSLevel, ...]
    #: index of the launch-time level
    nominal: int = 0

    def __post_init__(self):
        if not self.levels:
            raise ValueError("EP power spec needs at least one DVFS level")
        scales = [l.scale for l in self.levels]
        if scales != sorted(scales, reverse=True):
            raise ValueError(f"DVFS levels must be fastest-first, got scales {scales}")
        if not 0 <= self.nominal < len(self.levels):
            raise ValueError(f"nominal level {self.nominal} out of range")


@dataclasses.dataclass(eq=False)
class PowerModel:
    """The package: per-EP DVFS state under a shared power cap.

    Mutable by design (current levels are tuned state), so it is attached
    to the frozen ``Platform`` via a compare-excluded field and excluded
    from equality itself, mirroring ``Fabric``.
    """

    specs: tuple[EPPowerSpec, ...]
    #: package-level power cap, watts (``inf`` = unconstrained)
    cap_w: float = math.inf
    #: optional thermal RC model per chiplet (:mod:`repro_torch.power.thermal`)
    thermal: "ThermalModel | None" = None

    def __post_init__(self):
        if not self.specs:
            raise ValueError("power model needs at least one EP spec")
        if self.thermal is not None and self.thermal.n_eps != len(self.specs):
            raise ValueError(
                f"thermal model covers {self.thermal.n_eps} chiplets but the "
                f"power model has {len(self.specs)} EPs"
            )
        #: current DVFS level index per EP (mutable tuned state)
        self._levels: list[int] = [spec.nominal for spec in self.specs]

    # -- current state -------------------------------------------------------

    @property
    def n_eps(self) -> int:
        return len(self.specs)

    @property
    def tunable(self) -> bool:
        """True when at least one EP has more than one level to explore."""
        return any(len(spec.levels) > 1 for spec in self.specs)

    def level(self, ep: int) -> int:
        return self._levels[ep]

    def set_level(self, ep: int, idx: int) -> None:
        if not 0 <= idx < len(self.specs[ep].levels):
            raise ValueError(
                f"EP {ep} has {len(self.specs[ep].levels)} DVFS levels; "
                f"level {idx} does not exist"
            )
        self._levels[ep] = idx

    def can_step_up(self, ep: int) -> bool:
        """A faster level exists (levels are fastest-first)."""
        return self._levels[ep] > 0

    def can_step_down(self, ep: int) -> bool:
        return self._levels[ep] < len(self.specs[ep].levels) - 1

    def snapshot(self) -> tuple[int, ...]:
        """The current per-EP level vector (restorable)."""
        return tuple(self._levels)

    def restore(self, levels: Sequence[int]) -> None:
        if len(levels) != len(self.specs):
            raise ValueError(
                f"level vector covers {len(levels)} EPs, model has {len(self.specs)}"
            )
        for ep, idx in enumerate(levels):
            self.set_level(ep, idx)

    # -- per-EP physics at the current level ---------------------------------

    def current(self, ep: int) -> DVFSLevel:
        return self.specs[ep].levels[self._levels[ep]]

    def scale(self, ep: int) -> float:
        return self.current(ep).scale

    def dynamic_w(self, ep: int) -> float:
        return self.current(ep).dynamic_w

    def static_w(self, ep: int) -> float:
        return self.current(ep).static_w

    # -- package arithmetic (model-side: costs no simulated time) ------------

    @property
    def static_package_w(self) -> float:
        """Leakage of the whole package at the current levels, watts."""
        return sum(self.static_w(ep) for ep in range(len(self.specs)))

    def package_w(self, in_use: Iterable[int]) -> float:
        """Peak package draw: all leakage + dynamic watts of ``in_use`` EPs."""
        return self.static_package_w + sum(
            self.dynamic_w(ep) for ep in sorted(set(in_use))
        )

    def cap_feasible(self, in_use: Iterable[int]) -> bool:
        return self.package_w(in_use) <= self.cap_w

    # -- restriction (sub-platforms / elastic rescale) ------------------------

    def restrict(self, keep: Sequence[int]) -> "PowerModel":
        """Sub-model over the kept EPs, carrying their current levels.

        The package cap is inherited as-is — a deliberate simplification:
        each tenant's view enforces the whole-package budget rather than a
        per-partition share, so a restricted model can never admit a level
        vector the full package would reject.
        """
        sub = PowerModel(
            specs=tuple(self.specs[i] for i in keep),
            cap_w=self.cap_w,
            thermal=self.thermal.restrict(keep) if self.thermal is not None else None,
        )
        sub.restore(tuple(self._levels[i] for i in keep))
        return sub


# ---------------------------------------------------------------------------
# factories
# ---------------------------------------------------------------------------

#: nominal dynamic watts per GFLOP/s of EP compute (sets the power scale of
#: the gem5-style platforms: a 4-core big EP lands around 16 W)
WATTS_PER_GFLOPS = 0.25

#: leakage as a fraction of nominal dynamic draw
STATIC_FRACTION = 0.15


def dvfs_ladder(
    nominal_dynamic_w: float,
    nominal_static_w: float,
    *,
    n_levels: int = 4,
    min_scale: float = 0.4,
) -> tuple[DVFSLevel, ...]:
    """Evenly spaced scale ladder with the classic cubic dynamic-power law.

    Dynamic power follows ``P ∝ f·V²`` with voltage tracking frequency, so
    a level at ``scale`` draws ``nominal · scale³``; leakage falls only
    mildly with the voltage (``0.5 + 0.5·scale``).
    """
    if n_levels < 1:
        raise ValueError("need at least one DVFS level")
    if not 0.0 < min_scale <= 1.0:
        raise ValueError(f"min_scale must be in (0, 1], got {min_scale}")
    levels = []
    for i in range(n_levels):
        scale = (
            1.0
            if n_levels == 1
            else 1.0 - (1.0 - min_scale) * i / (n_levels - 1)
        )
        levels.append(
            DVFSLevel(
                name=f"L{i}",
                scale=scale,
                dynamic_w=nominal_dynamic_w * scale**3,
                static_w=nominal_static_w * (0.5 + 0.5 * scale),
            )
        )
    return tuple(levels)


def uniform_power(
    platform,
    *,
    cap_w: float = math.inf,
    n_levels: int = 4,
    min_scale: float = 0.4,
    watts_per_gflops: float = WATTS_PER_GFLOPS,
    static_fraction: float = STATIC_FRACTION,
    thermal: "ThermalModel | None" = None,
) -> PowerModel:
    """A plausible package model sized from the platform's EP compute rates.

    Each EP's nominal dynamic draw is proportional to its aggregate FLOP
    rate (faster chiplets burn more), with a ``n_levels``-step DVFS ladder
    down to ``min_scale``.  Attach with ``platform.with_power(...)``.
    """
    specs = []
    for ep in platform.eps:
        dyn = watts_per_gflops * ep.flops / 1e9
        specs.append(
            EPPowerSpec(
                levels=dvfs_ladder(
                    dyn,
                    dyn * static_fraction,
                    n_levels=n_levels,
                    min_scale=min_scale,
                )
            )
        )
    return PowerModel(specs=tuple(specs), cap_w=cap_w, thermal=thermal)


def degenerate_power(platform, **kw) -> PowerModel:
    """The identity model: one nominal level per EP, no cap, no thermal.

    Attaching it reproduces the power-free platform bit-for-bit (the
    evaluators divide by a scale of exactly ``1.0``), which is the
    regression pin keeping every pre-power result standing — the power
    analogue of ``scalar_fabric``.
    """
    return uniform_power(platform, n_levels=1, **kw)
