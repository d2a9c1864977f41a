"""Runtime fault handling: the straggler rebalancer."""

from .fault import StragglerMitigator

__all__ = ["StragglerMitigator"]
