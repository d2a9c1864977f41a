"""Shisha-scheduled pipeline runtime on CUDA streams.

The paper's deployment story on one card: a chain-structured network is
split into N contiguous stages by a Shisha ``PipelineConfig``; each stage
runs on a stream of its own (``launch/mesh.py``) and microbatches stream
through the stages GPipe-style — fill, steady, drain — with every hand-off
an event the next stage's stream waits on (the paper's inter-chiplet link).

Two oracles close the online-tuning loop:

  * :class:`MeasuringEvaluator` — times each layer on the device (CUDA
    events after a warm-up, best of ``reps``) and scales by the EP derate
    (hetero.py): the paper's "runtime performance value", consumed by
    Algorithm 2 like the gem5 database.
  * :func:`pipeline_throughput` — runs the actual pipelined computation
    and measures end-to-end microbatches/s.

Host clocks appear only where the caller asked for the CPU, and around
work that ends in ``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import time
from typing import Callable, Sequence

import torch

from ..core.config import PipelineConfig
from ..core.cost_model import Layer
from ..core.evaluator import AnalyticEvaluator
from ..core.platform import Platform
from ..launch.mesh import StageMesh
from .hetero import EPDerates

# ---------------------------------------------------------------------------
# Measured oracle
# ---------------------------------------------------------------------------


def _best_time(fn: Callable, args: tuple, reps: int, device: torch.device) -> float:
    """Seconds of one call of ``fn(*args)``: best of ``reps`` after one
    warm-up call; CUDA events on the card, the host clock on the CPU."""
    fn(*args)
    best = math.inf
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        elif device.type == "cpu":
            t0 = time.perf_counter()
            fn(*args)
            best = min(best, time.perf_counter() - t0)
        else:
            raise ValueError(f"cannot time on device {device}")
    return best


@dataclasses.dataclass
class MeasuringEvaluator(AnalyticEvaluator):
    """`execute(conf)` backed by per-layer times measured on the device.

    Stage times are sums of measured layer times scaled by the stage EP's
    derate, plus the modelled link cost of the stage boundary — the live
    analogue of the paper's gem5 database.

    As in the reference's measured oracle, every boundary is priced on the
    scalar per-EP ``link_bw``/``link_latency`` and no time divides by a DVFS
    scale, even when the platform carries a fabric or a power model: those
    reach the tuner only through its placement candidates, their routed
    relocation costs and the power cap, so ``tune(dvfs=True)`` over this
    oracle sees a frequency step as free.
    """

    layer_fns: Sequence[Callable] | None = None
    layer_args: Sequence[tuple] | None = None
    reps: int = 3
    device: str | torch.device = "cuda"

    def __post_init__(self):
        if len(self.layer_fns) != len(self.layers) or len(self.layer_args) != len(self.layers):
            raise ValueError(
                f"{len(self.layers)} layers, {len(self.layer_fns)} layer_fns, {len(self.layer_args)} layer_args"
            )
        self.derates = EPDerates.from_platform(self.platform)
        device = torch.device(self.device)
        self.measured = [
            _best_time(fn, args, self.reps, device) for fn, args in zip(self.layer_fns, self.layer_args)
        ]

    def on_platform(self, platform: Platform) -> "MeasuringEvaluator":
        """The same oracle over ``platform``, which has the same EPs (with a
        fabric or a power model attached, say): the layers measured here
        serve it, and nothing is measured again."""
        if platform.eps != self.platform.eps:
            raise ValueError(f"{platform.name} has other EPs than {self.platform.name}")
        other = copy.copy(self)
        other.platform = platform
        return other

    def layer_time(self, layer: Layer, ep_idx: int) -> float:  # type: ignore[override]
        li = list(self.layers).index(layer)
        return self.derates.scale(ep_idx, self.measured[li]) + self.layer_overhead

    def stage_times(self, conf: PipelineConfig) -> list[float]:
        times = []
        for s, (a, b) in enumerate(conf.boundaries()):
            ep_idx = conf.eps[s]
            t = sum(self.derates.scale(ep_idx, self.measured[i]) + self.layer_overhead for i in range(a, b))
            if s < conf.depth - 1:
                # the scalar link, fabric or not (the reference's formula)
                ep = self.platform.eps[ep_idx]
                nxt = self.platform.eps[conf.eps[s + 1]]
                t += self.layers[b - 1].act_bytes / min(ep.link_bw, nxt.link_bw) + max(
                    ep.link_latency, nxt.link_latency
                )
            times.append(t)
        return times


# ---------------------------------------------------------------------------
# Stream GPipe pipeline
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PipelineRunner:
    """Runs a layer chain as an N-stage microbatched pipeline.

    ``apply_layer(i, x)`` applies layer i.  Unlike the JAX runner, whose
    ``lax.switch`` branches need one canonical activation shape, stages here
    pass their natural shapes on.  Tick t runs stage s on microbatch
    t - s, for ``n_micro + n_stages - 1`` ticks (fill, steady, drain).
    """

    mesh: StageMesh
    conf: PipelineConfig
    apply_layer: Callable[[int, torch.Tensor], torch.Tensor]
    n_micro: int = 8

    def __post_init__(self):
        if self.mesh.n_stages != self.conf.depth:
            raise ValueError(f"mesh has {self.mesh.n_stages} stages, pipeline depth is {self.conf.depth}")
        #: ticks of the last run
        self.ticks = 0

    def _stage(self, s: int, x: torch.Tensor) -> torch.Tensor:
        a, b = self.conf.boundaries()[s]
        for i in range(a, b):
            x = self.apply_layer(i, x)
        return x

    def run(self, micro: torch.Tensor) -> torch.Tensor:
        """micro: [n_micro, ...]. Returns [n_micro, ...] final activations.

        On CUDA the result is ordered on the caller's current stream; the
        call does not synchronise.
        """
        if len(micro) != self.n_micro:
            raise ValueError(f"got {len(micro)} microbatches, runner takes {self.n_micro}")
        n_stages = self.conf.depth
        streams = self.mesh.streams
        caller = torch.cuda.current_stream(self.mesh.device) if streams is not None else None
        outs: list = [None] * self.n_micro
        #: inbox[s]: (activation, event it is ready at) waiting for stage s
        inbox: list = [None] * n_stages
        ticks = self.n_micro + n_stages - 1
        for t in range(ticks):
            for s in reversed(range(n_stages)):  # consume inbox[s] before stage s-1 refills it
                m = t - s
                if not 0 <= m < self.n_micro:
                    continue
                x, ready = (micro[m], None) if s == 0 else inbox[s]
                if streams is None:
                    y = (self._stage(s, x), None)
                else:
                    stream = streams[s]
                    if ready is None:
                        stream.wait_stream(caller)
                    else:
                        stream.wait_event(ready)
                    x.record_stream(stream)  # x was allocated on another stream
                    with torch.cuda.stream(stream):
                        out = self._stage(s, x)
                    done = torch.cuda.Event()
                    done.record(stream)
                    y = (out, done)
                if s == n_stages - 1:
                    outs[m] = y
                else:
                    inbox[s + 1] = y
        self.ticks = ticks
        if streams is not None:
            for y, ready in outs:
                caller.wait_event(ready)
                y.record_stream(caller)
        return torch.stack([y for y, _ in outs])


def pipeline_throughput(runner: PipelineRunner, micro: torch.Tensor, reps: int = 3) -> float:
    """Measured end-to-end microbatches/second of the real pipeline: best
    of ``reps`` runs after a warm-up, each ending in a device sync."""
    device = runner.mesh.device

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    runner.run(micro)
    sync()
    best = math.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        runner.run(micro)
        sync()
        best = min(best, time.perf_counter() - t0)
    return runner.n_micro / best
