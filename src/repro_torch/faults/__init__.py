"""Chaos layer: seeded stochastic fault injection and resilience policy.

Off by default; attach a :class:`FaultModel` with
``Platform.with_faults(...)`` (or the ``co_serve(chaos=...)`` knob) and a
:class:`ResiliencePolicy` on the serving lane.  The degenerate
:func:`no_faults` model reproduces every fault-free result bit-for-bit.
Stdlib-only by the layering contract (see the JAX package's ``repro.analysis.layering``).
"""

from .injector import BatchFailureStream, FaultInjector
from .model import FAULT_KINDS, FaultEvent, FaultModel, no_faults
from .resilience import ResiliencePolicy

__all__ = [
    "BatchFailureStream",
    "FAULT_KINDS",
    "FaultEvent",
    "FaultInjector",
    "FaultModel",
    "ResiliencePolicy",
    "no_faults",
]
