"""Shisha-scheduled pipeline runtime (one CUDA stream per stage)."""

from .hetero import EPDerates, h100_platform_from_streams
from .runtime import MeasuringEvaluator, PipelineRunner, pipeline_throughput

__all__ = [
    "EPDerates",
    "MeasuringEvaluator",
    "PipelineRunner",
    "h100_platform_from_streams",
    "pipeline_throughput",
]
