"""The ``execute(conf)`` oracle of Algorithm 2.

The paper measures throughput of a candidate pipeline by running it.  The
oracle is pluggable:

  * :class:`AnalyticEvaluator` — roofline model per (layer, EP):
        t_layer = max(flops / EP.flops, bytes / EP.mem_bw)
    plus inter-stage transfer time over the EP link (bandwidth + latency).
    Throughput = 1 / max_stage_time (steady-state pipeline, one inference
    unit per beat).  When the platform carries an interconnect fabric
    (:class:`~repro_torch.interconnect.Fabric`), each stage-boundary
    transfer is *routed* and priced under the steady-state flow set — all of
    the schedule's boundary transfers plus any ``background_flows`` — so
    shared links fair-share their bandwidth; with a power model
    (:class:`~repro_torch.power.PowerModel`) every on-EP time divides by the
    EP's DVFS scale.
  * :class:`DatabaseEvaluator` — mimics the paper's gem5 database: per
    (layer, EP) times are precomputed once with deterministic measurement
    noise, then only *queried* during exploration (the oracle of the
    paper's comparison arms, ``baselines.py``).
  * :class:`~repro_torch.pipeline.runtime.MeasuringEvaluator` — layer
    times measured on the device; the "online" mode.  Like the reference's,
    it prices every boundary on the scalar link and ignores DVFS scales.

Every evaluator is wrapped in :class:`Trace` by the exploration loops to
account configurations tried and the *simulated wall-clock cost* of trying
them (a trial costs ``measure_batches`` pipeline beats plus a
reconfiguration penalty — what makes trying bad configurations expensive,
the effect Shisha exploits).
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
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
    #: co-tenant flows priced into every transfer when the platform has a
    #: fabric (node-space :class:`~repro_torch.interconnect.Flow`s); ignored
    #: on scalar-link platforms
    background_flows: tuple = ()

    def nominal_layer_time(self, layer: Layer, ep_idx: int) -> float:
        """Layer time at the EP's nominal clock (DVFS-independent)."""
        ep = self.platform.eps[ep_idx]
        return max(layer.flops / ep.flops, layer.bytes_mem / ep.mem_bw) + self.layer_overhead

    def layer_time(self, layer: Layer, ep_idx: int) -> float:
        t = self.nominal_layer_time(layer, ep_idx)
        pm = self.platform.power
        if pm is not None:
            # DVFS scales the EP's compute rate and memory bandwidth
            # together, so the whole on-EP time divides by the level's
            # scale (exactly 1.0 at nominal: the no-power path is
            # reproduced bit-for-bit).  Link transfers are unscaled — the
            # interconnect runs on its own clock.
            t = t / pm.scale(ep_idx)
        return t

    def transfer_times(self, conf: PipelineConfig) -> list[float]:
        """Inter-stage transfer time per stage boundary (s -> s+1).

        Scalar path: the output activations of the stage's last layer cross
        one link priced by the two EPs' specs.  Fabric path: every boundary
        transfer of the steady-state pipeline (plus ``background_flows``) is
        routed and priced under shared-link contention.
        """
        n_links = conf.depth - 1
        if n_links <= 0:
            return []
        bounds = conf.boundaries()
        fabric = self.platform.fabric
        if fabric is None:
            out = []
            for s in range(n_links):
                ep = self.platform.eps[conf.eps[s]]
                nxt = self.platform.eps[conf.eps[s + 1]]
                bw = min(ep.link_bw, nxt.link_bw)
                lat = max(ep.link_latency, nxt.link_latency)
                out.append(self.layers[bounds[s][1] - 1].act_bytes / bw + lat)
            return out
        from ..interconnect import Flow

        flows = [
            Flow(conf.eps[s], conf.eps[s + 1], self.layers[bounds[s][1] - 1].act_bytes)
            for s in range(n_links)
        ]
        return fabric.flow_times(flows + list(self.background_flows))[:n_links]

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


def _noise(key: str, sigma: float) -> float:
    """Deterministic pseudo-measurement noise in [1-sigma, 1+sigma]."""
    h = int.from_bytes(hashlib.sha256(key.encode()).digest()[:8], "big")
    u = h / float(1 << 64)  # [0,1)
    return 1.0 + sigma * (2.0 * u - 1.0)


@dataclasses.dataclass
class DatabaseEvaluator(AnalyticEvaluator):
    """gem5-style database: times precomputed once, then only queried.

    Deterministic multiplicative noise models gem5-vs-model discrepancy; it
    is keyed on (layer, EP) so repeated queries return identical values, as
    a database would.
    """

    noise_sigma: float = 0.08

    def __post_init__(self):
        self._db: dict[tuple[int, int], float] = {}
        for li, layer in enumerate(self.layers):
            for ei in range(self.platform.n_eps):
                # DB entries are nominal-clock times: the database is
                # measured once, while DVFS levels move during tuning, so
                # the scale is applied at query time (see stage_times)
                base = AnalyticEvaluator.nominal_layer_time(self, layer, ei)
                self._db[(li, ei)] = base * _noise(f"{layer.name}|{self.platform.eps[ei].name}", self.noise_sigma)

    def layer_time_by_index(self, layer_idx: int, ep_idx: int) -> float:
        t = self._db[(layer_idx, ep_idx)]
        pm = self.platform.power
        if pm is not None:
            t = t / pm.scale(ep_idx)
        return t

    def stage_times(self, conf: PipelineConfig) -> list[float]:
        times = []
        link = self.transfer_times(conf)
        pm = self.platform.power
        for s, (a, b) in enumerate(conf.boundaries()):
            ep_idx = conf.eps[s]
            t = sum(self._db[(i, ep_idx)] for i in range(a, b))
            if pm is not None:
                t = t / pm.scale(ep_idx)
            if s < conf.depth - 1:
                t += link[s]
            times.append(t)
        return times


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
    #: one-off setup cost (e.g. Pipe-Search / ES database generation)
    setup_cost: float = 0.0
    #: when True, re-visiting a configuration returns the remembered
    #: throughput for free (no wall-clock charge, no new trial).  Off by
    #: default: the Fig. 4 cost accounting pays every visit, as on real
    #: hardware where a revisit still costs pipeline time.
    use_cache: bool = False

    def __post_init__(self):
        self.trials: list[Trial] = []
        self._wall = float(self.setup_cost)
        self._cache: dict[PipelineConfig, float] = {}

    @property
    def wall(self) -> float:
        return self._wall

    @property
    def n_trials(self) -> int:
        return len(self.trials)

    def execute(self, conf: PipelineConfig, reconfig_cost: float | None = None) -> float:
        """Measure throughput of ``conf``, paying the simulated cost.

        ``reconfig_cost`` overrides the flat ``reconfig_overhead`` for this
        one trial — how placement-aware tuning charges an EP relocation its
        routed weight-shipping cost instead of the flat boundary-move price.
        ``None`` keeps the flat charge.  A ``use_cache`` hit stays free.
        """
        if self.use_cache and conf in self._cache:
            return self._cache[conf]
        beat = max(self.evaluator.stage_times(conf))
        fill = self.evaluator.pipeline_latency(conf)
        if reconfig_cost is None:
            reconfig_cost = self.reconfig_overhead
        if math.isfinite(beat):
            self._wall += reconfig_cost + fill + self.measure_batches * beat
        else:
            # a severed stage boundary makes the pipeline unable to flow:
            # the trial is abandoned and only the reconfiguration is paid
            self._wall += reconfig_cost
        tp = self.evaluator.throughput(conf)
        if self.use_cache:
            self._cache[conf] = tp
        self.trials.append(Trial(conf, tp, self._wall))
        return tp

    def best(self) -> Trial:
        if not self.trials:
            raise RuntimeError("no trials executed")
        return max(self.trials, key=lambda t: t.throughput)

    def convergence_curve(self) -> list[tuple[float, float]]:
        """(wall time, best-so-far throughput) staircase, for Fig. 4."""
        out, best = [], 0.0
        for t in self.trials:
            best = max(best, t.throughput)
            out.append((t.t_wall, best))
        return out
