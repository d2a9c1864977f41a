"""The paper's loop end to end: online-scheduled CNN pipeline inference.

:func:`serve_cnn` is what ``examples/pipeline_serve_cnn_torch.py`` and
``chip_smoke.py`` run:

1. build a runnable SynthNet from its layer table, weights from a seed;
2. measure each layer on the device (the live ``execute()`` oracle;
   :func:`measure_cnn` does steps 1–2 for any of the repo's CNNs);
3. run Shisha — Algorithm 1 seed, Algorithm 2 tuning, heuristic H3 — on a
   4-EP platform of streams whose EP derates emulate FEP/SEP chiplets;
4. run the chosen split as a GPipe pipeline of microbatches, one CUDA
   stream per stage (or, with ``ranks=True``, one stage a rank), and
   measure its throughput;
5. make one stage's EP slower and rebalance with the same tuner.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import NamedTuple

import torch
import torch.distributed as dist

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
    """What :func:`serve_cnn` did.  Over ranks, only rank 0 holds the
    oracle, the schedule and the rebalance (None elsewhere), and a rank
    outside the tuned split's stages holds no runner, output or
    throughput."""

    model: CNNModel
    platform: Platform
    evaluator: MeasuringEvaluator | None
    shisha: ShishaResult | None
    runner: PipelineRunner | None
    micro: torch.Tensor
    out: torch.Tensor | None
    measured_throughput: float | None
    rebalanced: tuple[PipelineConfig, TuneResult] | None
    conf: PipelineConfig

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


class MeasuredCNN(NamedTuple):
    """A runnable CNN with weights from a seed, and its measured oracle."""

    model: CNNModel
    evaluator: MeasuringEvaluator
    #: the seeded generator after the weights were drawn, for the inputs
    gen: torch.Generator


def measure_cnn(
    network: str,
    platform: Platform,
    *,
    device: str | torch.device = "cuda",
    in_shape: tuple[int, int, int] = (220, 220, 3),
    seed: int = 0,
    scale: float = 1.0,
) -> MeasuredCNN:
    """Steps 1–2 for any network of ``models.cnn.NETWORKS``: build it at
    channel ``scale`` on ``device`` with weights from ``seed``, and time
    each layer on a zero probe of ``BATCH`` images of ``in_shape`` (H, W,
    C) — the measured oracle over ``platform``.  ``dataclasses.replace(
    evaluator, platform=p)`` measures again over ``p``;
    ``evaluator.on_platform(p)`` does not."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = make_cnn(network, scale=scale, device=device).init(gen)
    x_probe = torch.zeros((BATCH, *in_shape), device=device)
    layer_fns = [lambda x, i=i: model.apply_layer(i, x) for i in range(len(model.specs))]
    ev = MeasuringEvaluator(
        platform, network_layers(network), layer_fns=layer_fns, layer_args=[(x_probe,)] * len(layer_fns),
        device=device,
    )
    return MeasuredCNN(model, ev, gen)


def serve_cnn(
    *,
    device: str | torch.device = "cuda",
    scale: float = 1.0,
    in_shape: tuple[int, int, int] = (220, 220, 3),
    seed: int = 0,
    ranks: bool = False,
) -> CNNLoopResult:
    """Steps 1–5 on ``device`` with SynthNet at channel ``scale``; inputs
    of ``in_shape`` (H, W, C) per image; weights and inputs from ``seed``.

    With ``ranks=True`` every rank of the joined group
    (``launch.mesh.join_group``) calls it, and the platform has one EP a
    rank.  Rank 0 measures the oracle on its device and tunes, as on one
    device; the tuned split is broadcast and runs one stage a rank
    (``make_stage_mesh(depth, ranks=True)``: ranks past the split's depth
    sit the run out), and rank 0 rebalances the straggler."""
    device = torch.device(device)
    n_stages = dist.get_world_size() if ranks else N_STAGES
    lead = not ranks or dist.get_rank() == 0
    props = _CPU_PROPS if device.type == "cpu" else torch.cuda.get_device_properties(device)
    platform = h100_platform_from_streams(n_stages, props=props)

    # 1-2. measured oracle + Shisha
    ev = shisha = None
    if lead:
        model, ev, gen = measure_cnn("synthnet", platform, device=device, in_shape=in_shape, seed=seed, scale=scale)
        shisha = run_shisha(weights(ev.layers), Trace(ev), "H3", n_stages=n_stages)
        conf = shisha.result.best_conf
    else:
        gen = torch.Generator(device=device).manual_seed(seed)
        model = make_cnn("synthnet", scale=scale, device=device).init(gen)
    if ranks:
        box = [(conf.stages, conf.eps) if lead else None]
        dist.broadcast_object_list(box, src=0)
        conf = PipelineConfig(*box[0])

    # 3. run it for real
    mesh = make_stage_mesh(conf.depth, device, ranks=ranks)
    micro = torch.randn((N_MICRO, BATCH, *in_shape), generator=gen, device=device)
    runner = out = tp = None
    if not ranks or mesh.get_coordinate() is not None:
        runner = PipelineRunner(mesh=mesh, conf=conf, apply_layer=model.apply_layer, n_micro=N_MICRO)
        out = runner.run(micro)
        tp = pipeline_throughput(runner, micro)

    # 4. straggler: one stage's EP becomes slower; re-measure and re-tune
    rebalanced = None
    if lead:
        mit = StragglerMitigator(platform, conf, lambda p: Trace(dataclasses.replace(ev, platform=p)))
        times = ev.stage_times(conf)
        times[STRAGGLER_STAGE] *= STRAGGLER_FACTOR
        rebalanced = mit.rebalance(times)
    return CNNLoopResult(model, platform, ev, shisha, runner, micro, out, tp, rebalanced, conf)
