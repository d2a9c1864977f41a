"""Shisha core: seed generation (Alg. 1), online tuning (Alg. 2) and the
paper's comparison arms (HC, SA, RW, ES, Pipe-Search).

A trimmed copy of the JAX package's framework-free ``core``: the scalar-link
path without fabric, power or fault models.
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
from .tuner import TuneResult, pick_target, tune

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
