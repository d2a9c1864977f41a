"""Shisha core: seed generation (Alg. 1), online tuning (Alg. 2) and the
paper's comparison arms (HC, SA, RW, ES, Pipe-Search).

The port's copy of the JAX package's framework-free ``core``.  A platform
may carry a routed, contention-priced interconnect fabric
(``Platform.with_fabric``, :mod:`repro_torch.interconnect`) and a DVFS power
model under a package cap (``Platform.with_power``, :mod:`repro_torch.power`);
the evaluators price both, and ``tune`` adds the placement (EP relocation)
and DVFS moves over them.  Without either, every result is the scalar-link
one, bit for bit.  A platform may also carry a chaos fault model
(``Platform.with_faults``, :mod:`repro_torch.faults`), which the serving
simulator expands; a :class:`Trace` may carry a telemetry session.  The
cost model carries the LM-block formulas too (attention, FFN/MoE, SSD,
``fuse``), which ``models/transformer.py::layer_costs`` chains.
"""

from .baselines import (
    SearchResult,
    database_generation_cost,
    exhaustive_search,
    hill_climbing,
    pipe_search,
    random_config,
    random_walk,
    simulated_annealing,
)
from .config import PipelineConfig
from .cost_model import (
    Layer,
    attention_layer,
    conv_layer,
    ffn_layer,
    fuse,
    ssd_layer,
    total_flops,
    weights,
)
from .evaluator import AnalyticEvaluator, DatabaseEvaluator, Evaluator, Trace, Trial
from .heuristics import HEURISTICS, ShishaResult, run_shisha
from .platform import EP, Platform, paper_platform, table3_platform
from .seed import Seed, assign_eps, generate_seed, merge_layers
from .space import compositions, enumerate_configs, space_size
from .tuner import TuneResult, pick_target, placement_candidate, placement_reconfig_cost, tune

__all__ = [
    "AnalyticEvaluator",
    "DatabaseEvaluator",
    "EP",
    "Evaluator",
    "HEURISTICS",
    "Layer",
    "PipelineConfig",
    "Platform",
    "SearchResult",
    "Seed",
    "ShishaResult",
    "Trace",
    "Trial",
    "TuneResult",
    "assign_eps",
    "attention_layer",
    "compositions",
    "conv_layer",
    "database_generation_cost",
    "enumerate_configs",
    "exhaustive_search",
    "ffn_layer",
    "fuse",
    "generate_seed",
    "hill_climbing",
    "merge_layers",
    "paper_platform",
    "pick_target",
    "placement_candidate",
    "placement_reconfig_cost",
    "pipe_search",
    "random_config",
    "random_walk",
    "run_shisha",
    "simulated_annealing",
    "space_size",
    "ssd_layer",
    "table3_platform",
    "total_flops",
    "tune",
    "weights",
]
