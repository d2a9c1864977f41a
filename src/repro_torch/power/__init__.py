"""Power/thermal co-simulation: DVFS ladders, package caps, RC thermals.

The port's copy of the JAX package's ``power``, its thermal RC model
(:mod:`repro_torch.power.thermal`, stepped by the serving simulator)
included.  Zero-dependency (stdlib-only, no internal imports) so every layer
can consume an attached :class:`PowerModel` duck-typed via
``Platform.power`` without an import edge.  See
:mod:`repro_torch.power.model` for the attachment contract (off by default,
degenerate model is bit-for-bit identity).
"""

from .model import (
    DVFSLevel,
    EPPowerSpec,
    PowerModel,
    degenerate_power,
    dvfs_ladder,
    uniform_power,
)
from .thermal import ThermalModel, uniform_thermal

__all__ = [
    "DVFSLevel",
    "EPPowerSpec",
    "PowerModel",
    "ThermalModel",
    "degenerate_power",
    "dvfs_ladder",
    "uniform_power",
    "uniform_thermal",
]
