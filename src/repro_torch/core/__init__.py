"""Shisha core: seed generation (Alg. 1) and online tuning (Alg. 2).

A trimmed copy of the JAX package's framework-free ``core``: the scalar-link
path without fabric, power or fault models, which is all the CNN pipeline
loop runs.
"""

from .config import PipelineConfig
from .cost_model import Layer, conv_layer, weights
from .evaluator import AnalyticEvaluator, Trace, Trial
from .heuristics import HEURISTICS, ShishaResult, run_shisha
from .platform import EP, Platform, paper_platform
from .seed import Seed, generate_seed
from .tuner import TuneResult, pick_target, tune

__all__ = [
    "AnalyticEvaluator",
    "EP",
    "HEURISTICS",
    "Layer",
    "PipelineConfig",
    "Platform",
    "Seed",
    "ShishaResult",
    "Trace",
    "Trial",
    "TuneResult",
    "conv_layer",
    "generate_seed",
    "paper_platform",
    "pick_target",
    "run_shisha",
    "tune",
    "weights",
]
