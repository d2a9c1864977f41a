"""The port's checkpoint store (``repro/checkpoint``)."""

from .store import CheckpointStore

__all__ = ["CheckpointStore"]
