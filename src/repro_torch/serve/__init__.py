"""``repro_torch.serve`` — discrete-event serving on top of Shisha scheduling.

The port's copy of the JAX package's framework-free serving layer.  The
paper's algorithms answer "which configuration is fastest at steady state";
this subsystem answers the production question layered on top: "what
latency do users see under live, drifting traffic, and when is it worth
paying Algorithm 2's online exploration cost again?".

  * :mod:`.traffic`      — seeded arrival processes (Poisson, bursty MMPP,
                           diurnal, replayable traces).
  * :mod:`.simulator`    — event-driven pipeline server over the evaluator
                           stage-time model: queues, micro-batching, tail
                           latency, SLO accounting, EP occupancy.
  * :mod:`.autotuner`    — continuous Shisha: drift detection, mid-flight
                           re-tuning and batch-knob search charged to the
                           simulated clock.
  * :mod:`.multitenant`  — disjoint EP partitioning plus the shared-clock
                           elastic co-simulator: all tenants on one
                           discrete-event timeline, with mid-flight EP
                           re-allocation under faults.
"""

from .autotuner import (
    DRIFT_KINDS,
    ContinuousShisha,
    Drift,
    DriftDetector,
    Retune,
    drifted_platform,
    tune_batch_policy,
)
from .multitenant import (
    PARTITION_STRATEGIES,
    CoServeResult,
    ElasticPartitioner,
    RepartitionEvent,
    SharedClockCoSimulator,
    Tenant,
    TenantResult,
    co_schedule,
    co_serve,
    compare_partitions,
    partition_eps,
    subplatform,
)
from .simulator import (
    EventLoop,
    HeapEventLoop,
    Replatform,
    Request,
    ServingSimulator,
    SimResult,
    percentile,
    slo_violation_rate,
)
from .traffic import (
    DiurnalTraffic,
    MMPPTraffic,
    PoissonTraffic,
    ReplayTraffic,
    TrafficGenerator,
    interarrival_cv2,
)

__all__ = [
    "CoServeResult",
    "ContinuousShisha",
    "DRIFT_KINDS",
    "DiurnalTraffic",
    "Drift",
    "DriftDetector",
    "ElasticPartitioner",
    "EventLoop",
    "HeapEventLoop",
    "MMPPTraffic",
    "PARTITION_STRATEGIES",
    "PoissonTraffic",
    "RepartitionEvent",
    "Replatform",
    "ReplayTraffic",
    "Request",
    "Retune",
    "ServingSimulator",
    "SharedClockCoSimulator",
    "SimResult",
    "Tenant",
    "TenantResult",
    "TrafficGenerator",
    "co_schedule",
    "co_serve",
    "compare_partitions",
    "drifted_platform",
    "interarrival_cv2",
    "partition_eps",
    "percentile",
    "slo_violation_rate",
    "subplatform",
    "tune_batch_policy",
]
