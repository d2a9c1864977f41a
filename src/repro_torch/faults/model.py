"""Seeded stochastic fault specification — what can break, and how often.

A :class:`FaultModel` is a frozen, declarative description of the failure
physics of a platform: per-EP-class MTBF/MTTR renewal processes, correlated
package-domain failures (a chiplet's EPs die together), fabric link failures
and bandwidth degradations, and transient batch-level errors.  It contains
*no* randomness itself — the :class:`~repro_torch.faults.injector.FaultInjector`
expands a model into a concrete chaos trace from explicit
``random.Random(seed)`` streams, so the trace is a pure function of
(model, platform shape, horizon).

Like the power and fabric layers, the chaos layer is off by default and
degenerate by construction: :func:`no_faults` (or simply never attaching a
model) produces an empty trace and reproduces every fault-free result
bit-for-bit.  This package is stdlib-only and imports nothing from the rest
of ``repro_torch`` — platforms are duck-typed (anything with ``.n_eps`` /
``.eps[i].perf_class`` / ``.fabric``).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

#: fault-event kinds the injector can emit, in dispatch-tie order
FAULT_KINDS = ("dropout", "link", "revival")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault transition in a chaos trace.

    ``kind``:
      * ``"dropout"`` — EP ``ep`` fails (stops serving; in-flight work is
        requeued by the serving layer).
      * ``"revival"`` — EP ``ep`` is repaired and resumes serving.
      * ``"link"`` — fabric link ``link`` changes state: ``factor`` is the
        bandwidth multiplier from this instant on (``0.0`` = link dead,
        ``0 < f < 1`` = degraded, ``1.0`` = fully restored).
    """

    t: float
    kind: str
    ep: int | None = None
    link: tuple[int, int] | None = None
    factor: float | None = None

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.t < 0:
            raise ValueError(f"fault at negative time {self.t}")
        if self.kind in ("dropout", "revival"):
            if self.ep is None or self.link is not None:
                raise ValueError(f"{self.kind} fault needs an EP target, not a link")
        else:
            if self.link is None or self.factor is None or self.ep is not None:
                raise ValueError("link fault needs a link key and a factor")
            if not (0.0 <= self.factor <= 1.0):
                raise ValueError(f"link factor must be in [0, 1], got {self.factor}")


def _check_rate_pair(what: str, mtbf: float | None, mttr: float | None) -> None:
    if mtbf is None:
        return
    if mtbf <= 0:
        raise ValueError(f"{what} MTBF must be positive, got {mtbf}")
    if mttr is None or mttr <= 0:
        raise ValueError(f"{what} MTBF set but MTTR is {mttr!r} (need > 0)")


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Declarative chaos spec.  Every fault class is off unless configured.

    MTBF/MTTR are *means* of exponential fail/repair renewal processes
    (seconds of simulated time): an element is up for Exp(MTBF), down for
    Exp(MTTR), repeating — the standard availability model, matching the
    paper's §6 framing of runtime drift as an ongoing process rather than a
    one-shot script.
    """

    #: root seed; every fault stream is keyed off (seed, class, element)
    seed: int = 0
    #: EP ``perf_class`` -> mean time between failures; absent class = immune
    ep_mtbf: Mapping[int, float] = dataclasses.field(default_factory=dict)
    #: EP ``perf_class`` -> mean time to repair (required per failing class)
    ep_mttr: Mapping[int, float] = dataclasses.field(default_factory=dict)
    #: correlated failure domains: groups of EP indices that die together
    #: (a package losing power takes every chiplet on it down)
    domains: tuple[tuple[int, ...], ...] = ()
    domain_mtbf: float | None = None
    domain_mttr: float | None = None
    #: fabric link hard failures (link removed from routing while down)
    link_mtbf: float | None = None
    link_mttr: float | None = None
    #: fabric link bandwidth degradations (link keeps routing at reduced bw)
    degrade_mtbf: float | None = None
    degrade_mttr: float | None = None
    #: bandwidth multiplier while a link is degraded
    degrade_factor: float = 0.5
    #: probability a served batch errors and must be re-served
    batch_error_p: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "ep_mtbf", dict(self.ep_mtbf))
        object.__setattr__(self, "ep_mttr", dict(self.ep_mttr))
        object.__setattr__(
            self, "domains", tuple(tuple(d) for d in self.domains)
        )
        for cls in sorted(self.ep_mtbf):
            _check_rate_pair(f"EP class {cls}", self.ep_mtbf[cls], self.ep_mttr.get(cls))
        _check_rate_pair("domain", self.domain_mtbf, self.domain_mttr)
        _check_rate_pair("link", self.link_mtbf, self.link_mttr)
        _check_rate_pair("degrade", self.degrade_mtbf, self.degrade_mttr)
        if self.domain_mtbf is not None and not self.domains:
            raise ValueError("domain MTBF set but no failure domains given")
        for d in self.domains:
            if not d:
                raise ValueError("empty failure domain")
        if not (0.0 <= self.batch_error_p < 1.0):
            raise ValueError(f"batch error probability must be in [0, 1), got {self.batch_error_p}")
        if not (0.0 < self.degrade_factor < 1.0):
            raise ValueError(f"degrade factor must be in (0, 1), got {self.degrade_factor}")

    @property
    def enabled(self) -> bool:
        """True when any fault class can actually fire."""
        return bool(
            self.ep_mtbf
            or self.domain_mtbf is not None
            or self.link_mtbf is not None
            or self.degrade_mtbf is not None
            or self.batch_error_p > 0.0
        )


def no_faults(seed: int = 0) -> FaultModel:
    """The degenerate model: nothing ever fails.

    Attaching it is bit-for-bit equivalent to attaching nothing — the
    injector emits an empty trace and no batch-failure stream, so every
    simulator path stays on its fault-free arithmetic.  This is the chaos
    layer's analogue of :func:`repro_torch.power.degenerate_power` /
    :func:`repro_torch.interconnect.scalar_fabric`.
    """
    return FaultModel(seed=seed)
