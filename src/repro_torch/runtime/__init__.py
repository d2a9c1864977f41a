"""Runtime fault handling: the straggler rebalancer, elastic rescale and the supervised train loop."""

from .fault import ElasticScheduler, StragglerMitigator, TrainSupervisor

__all__ = ["ElasticScheduler", "StragglerMitigator", "TrainSupervisor"]
