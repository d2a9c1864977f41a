"""Power co-simulation: per-EP DVFS ladders under a package power cap.

The port's copy of the JAX package's ``power``, without its thermal RC
model, which comes with the serving layer that steps it.  Zero-dependency
(stdlib-only, no internal imports) so every layer can consume an attached
:class:`PowerModel` duck-typed via ``Platform.power`` without an import
edge.  See :mod:`repro_torch.power.model` for the attachment contract (off
by default, degenerate model is bit-for-bit identity).
"""

from .model import (
    DVFSLevel,
    EPPowerSpec,
    PowerModel,
    degenerate_power,
    dvfs_ladder,
    uniform_power,
)

__all__ = [
    "DVFSLevel",
    "EPPowerSpec",
    "PowerModel",
    "degenerate_power",
    "dvfs_ladder",
    "uniform_power",
]
