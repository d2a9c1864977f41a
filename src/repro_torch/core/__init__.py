"""Shisha core: seed generation (Alg. 1), online tuning (Alg. 2) and the
paper's comparison arms (HC, SA, RW, ES, Pipe-Search).

The port's copy of the JAX package's framework-free ``core``.  A platform
may carry a routed, contention-priced interconnect fabric
(``Platform.with_fabric``, :mod:`repro_torch.interconnect`) and a DVFS power
model under a package cap (``Platform.with_power``, :mod:`repro_torch.power`);
the evaluators price both, and ``tune`` adds the placement (EP relocation)
and DVFS moves over them.  Without either, every result is the scalar-link
one, bit for bit.  Fault models and the LM-block cost formulas come with the
serving layer.
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
from .cost_model import Layer, conv_layer, weights
from .evaluator import AnalyticEvaluator, DatabaseEvaluator, Trace, Trial
from .heuristics import HEURISTICS, ShishaResult, run_shisha
from .platform import EP, Platform, paper_platform, table3_platform
from .seed import Seed, generate_seed
from .space import compositions, enumerate_configs, space_size
from .tuner import TuneResult, pick_target, placement_candidate, placement_reconfig_cost, tune

__all__ = [
    "AnalyticEvaluator",
    "DatabaseEvaluator",
    "EP",
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
    "compositions",
    "conv_layer",
    "database_generation_cost",
    "enumerate_configs",
    "exhaustive_search",
    "generate_seed",
    "hill_climbing",
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
    "table3_platform",
    "tune",
    "weights",
]
