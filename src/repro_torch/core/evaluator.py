"""The ``execute(conf)`` oracle of Algorithm 2.

The paper measures throughput of a candidate pipeline by running it.  The
oracle is pluggable:

  * :class:`AnalyticEvaluator` — roofline model per (layer, EP):
        t_layer = max(flops / EP.flops, bytes / EP.mem_bw)
    plus inter-stage transfer time over the EP link (bandwidth + latency).
    Throughput = 1 / max_stage_time (steady-state pipeline, one inference
    unit per beat).
  * :class:`~repro_torch.pipeline.runtime.MeasuringEvaluator` — the same
    plumbing over layer times measured on the device; the "online" mode.

Every evaluator is wrapped in :class:`Trace` by the exploration loops to
account configurations tried and the *simulated wall-clock cost* of trying
them (a trial costs ``measure_batches`` pipeline beats plus a
reconfiguration penalty — what makes trying bad configurations expensive,
the effect Shisha exploits).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from .config import PipelineConfig
from .cost_model import Layer
from .platform import Platform


@dataclasses.dataclass
class AnalyticEvaluator:
    """Roofline-model oracle (layer time = max(compute, memory) + link)."""

    platform: Platform
    layers: Sequence[Layer]
    #: per-layer fixed overhead on the EP (kernel-launch / queue pop), s
    layer_overhead: float = 2e-6

    def layer_time(self, layer: Layer, ep_idx: int) -> float:
        ep = self.platform.eps[ep_idx]
        return max(layer.flops / ep.flops, layer.bytes_mem / ep.mem_bw) + self.layer_overhead

    def transfer_times(self, conf: PipelineConfig) -> list[float]:
        """Inter-stage transfer time per stage boundary (s -> s+1): the
        output activations of the stage's last layer cross one link priced
        by the two EPs' specs."""
        bounds = conf.boundaries()
        out = []
        for s in range(conf.depth - 1):
            ep = self.platform.eps[conf.eps[s]]
            nxt = self.platform.eps[conf.eps[s + 1]]
            bw = min(ep.link_bw, nxt.link_bw)
            lat = max(ep.link_latency, nxt.link_latency)
            out.append(self.layers[bounds[s][1] - 1].act_bytes / bw + lat)
        return out

    def stage_times(self, conf: PipelineConfig) -> list[float]:
        times = []
        link = self.transfer_times(conf)
        for s, (a, b) in enumerate(conf.boundaries()):
            ep_idx = conf.eps[s]
            t = sum(self.layer_time(self.layers[i], ep_idx) for i in range(a, b))
            if s < conf.depth - 1:
                t += link[s]
            times.append(t)
        return times

    def throughput(self, conf: PipelineConfig) -> float:
        """Steady-state inferences/second = 1 / slowest stage beat."""
        return 1.0 / max(self.stage_times(conf))

    def pipeline_latency(self, conf: PipelineConfig) -> float:
        return sum(self.stage_times(conf))


@dataclasses.dataclass
class Trial:
    conf: PipelineConfig
    throughput: float
    #: cumulative simulated wall-clock when this trial finished, seconds
    t_wall: float


@dataclasses.dataclass
class Trace:
    """Wraps an evaluator; accounts every execute() like the real runtime.

    Trying a configuration online costs real time: the pipeline must be
    reconfigured and run for a few batches to measure steady-state
    throughput.  All exploration paths pay this identically.
    """

    evaluator: AnalyticEvaluator
    measure_batches: int = 8
    reconfig_overhead: float = 0.05  # seconds per reconfiguration

    def __post_init__(self):
        self.trials: list[Trial] = []
        self._wall = 0.0

    @property
    def wall(self) -> float:
        return self._wall

    @property
    def n_trials(self) -> int:
        return len(self.trials)

    def execute(self, conf: PipelineConfig) -> float:
        """Measure throughput of ``conf``, paying the simulated cost."""
        beat = max(self.evaluator.stage_times(conf))
        fill = self.evaluator.pipeline_latency(conf)
        self._wall += self.reconfig_overhead + fill + self.measure_batches * beat
        tp = self.evaluator.throughput(conf)
        self.trials.append(Trial(conf, tp, self._wall))
        return tp
