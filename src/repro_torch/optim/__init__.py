"""Optimizer and gradient compression of the port (``repro/optim``)."""

from .adamw import AdamW, AdamWConfig, cosine_schedule
from .grad_compress import compressed_psum, dequantize, quantize_int8

__all__ = [
    "AdamW",
    "AdamWConfig",
    "cosine_schedule",
    "compressed_psum",
    "dequantize",
    "quantize_int8",
]
