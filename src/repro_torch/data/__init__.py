"""The port's synthetic LM data pipeline (``repro/data``)."""

from .pipeline import DataConfig, SyntheticLMData, make_batch_iterator

__all__ = ["DataConfig", "SyntheticLMData", "make_batch_iterator"]
