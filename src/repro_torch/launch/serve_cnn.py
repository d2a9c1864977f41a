"""The paper's loop end to end: online-scheduled CNN pipeline inference.

:func:`serve_cnn` is what ``examples/pipeline_serve_cnn_torch.py`` and
``chip_smoke.py`` run:

1. build a runnable SynthNet from its layer table, weights from a seed;
2. measure each layer on the device (the live ``execute()`` oracle);
3. run Shisha — Algorithm 1 seed, Algorithm 2 tuning, heuristic H3 — on a
   4-EP platform of streams whose EP derates emulate FEP/SEP chiplets;
4. run the chosen split as a GPipe pipeline of microbatches, one CUDA
   stream per stage, and measure its throughput;
5. make one stage's EP slower and rebalance with the same tuner.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import torch

from ..core import PipelineConfig, Platform, ShishaResult, Trace, TuneResult, run_shisha, weights
from ..models.cnn import CNNModel, make_cnn, network_layers
from ..pipeline import MeasuringEvaluator, PipelineRunner, h100_platform_from_streams, pipeline_throughput
from ..runtime import StragglerMitigator
from .mesh import make_stage_mesh

N_STAGES = 4
#: images per microbatch and microbatches per pipeline run
BATCH, N_MICRO = 2, 8
#: the injected straggler: this stage's EP becomes this many times slower
STRAGGLER_STAGE, STRAGGLER_FACTOR = 1, 4.0
#: on the CPU there is no card to read; describe an H100 SXM so the platform
#: (and with it the schedule) has the same shape
_CPU_PROPS = SimpleNamespace(name="cpu-as-H100", multi_processor_count=132, total_memory=80 * 2**30)


@dataclasses.dataclass
class CNNLoopResult:
    model: CNNModel
    platform: Platform
    evaluator: MeasuringEvaluator
    shisha: ShishaResult
    runner: PipelineRunner
    micro: torch.Tensor
    out: torch.Tensor
    measured_throughput: float
    rebalanced: tuple[PipelineConfig, TuneResult] | None

    @property
    def conf(self) -> PipelineConfig:
        return self.shisha.result.best_conf

    def report(self) -> list[str]:
        conf, res = self.conf, self.shisha.result
        lines = [
            f"[schedule] {conf.pretty([ep.name for ep in self.platform.eps])}",
            f"[schedule] modelled throughput {res.best_throughput:.1f} micro/s after {self.shisha.trace.n_trials} trials",
            f"[serve] pipelined {self.out.shape[0]} microbatches, output {tuple(self.out.shape)}, "
            f"measured {self.measured_throughput:.1f} micro/s",
        ]
        if self.rebalanced is None:
            lines.append("[fault] imbalance below threshold; no rebalance needed")
        else:
            new_conf, result = self.rebalanced
            lines.append(f"[fault] straggler on stage {STRAGGLER_STAGE} -> rebalanced: {new_conf.pretty()}")
            lines.append(f"[fault] modelled throughput after rebalance {result.best_throughput:.1f} micro/s")
        return lines


def serve_cnn(
    *,
    device: str | torch.device = "cuda",
    scale: float = 1.0,
    in_shape: tuple[int, int, int] = (220, 220, 3),
    seed: int = 0,
) -> CNNLoopResult:
    """Steps 1–5 on ``device`` with SynthNet at channel ``scale``; inputs
    of ``in_shape`` (H, W, C) per image; weights and inputs from ``seed``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = make_cnn("synthnet", scale=scale, device=device).init(gen)
    cost_layers = network_layers("synthnet")
    props = _CPU_PROPS if device.type == "cpu" else torch.cuda.get_device_properties(device)
    platform = h100_platform_from_streams(N_STAGES, props=props)

    # 1-2. measured oracle + Shisha
    x_probe = torch.zeros((BATCH, *in_shape), device=device)
    layer_fns = [lambda x, i=i: model.apply_layer(i, x) for i in range(len(model.specs))]
    probe_args = [(x_probe,)] * len(layer_fns)

    def evaluator(p: Platform) -> MeasuringEvaluator:
        return MeasuringEvaluator(p, cost_layers, layer_fns=layer_fns, layer_args=probe_args, device=device)

    ev = evaluator(platform)
    shisha = run_shisha(weights(cost_layers), Trace(ev), "H3", n_stages=N_STAGES)
    conf = shisha.result.best_conf

    # 3. run it for real
    runner = PipelineRunner(
        mesh=make_stage_mesh(conf.depth, device), conf=conf, apply_layer=model.apply_layer, n_micro=N_MICRO
    )
    micro = torch.randn((N_MICRO, BATCH, *in_shape), generator=gen, device=device)
    out = runner.run(micro)
    tp = pipeline_throughput(runner, micro)

    # 4. straggler: one stage's EP becomes slower; re-measure and re-tune
    mit = StragglerMitigator(platform, conf, lambda p: Trace(evaluator(p)))
    times = ev.stage_times(conf)
    times[STRAGGLER_STAGE] *= STRAGGLER_FACTOR
    rebalanced = mit.rebalance(times)
    return CNNLoopResult(model, platform, ev, shisha, runner, micro, out, tp, rebalanced)
