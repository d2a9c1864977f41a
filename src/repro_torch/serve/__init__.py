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

The reference's multi-tenant layer (``multitenant``: EP partitioning,
``co_serve`` and the shared-clock elastic co-simulator) is not copied yet;
it comes with the next slice of the port.
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
    "ContinuousShisha",
    "DRIFT_KINDS",
    "DiurnalTraffic",
    "Drift",
    "DriftDetector",
    "EventLoop",
    "HeapEventLoop",
    "MMPPTraffic",
    "PoissonTraffic",
    "Replatform",
    "ReplayTraffic",
    "Request",
    "Retune",
    "ServingSimulator",
    "SimResult",
    "TrafficGenerator",
    "drifted_platform",
    "interarrival_cv2",
    "percentile",
    "slo_violation_rate",
    "tune_batch_policy",
]
