"""Int8 gradient quantisation (port of ``repro/optim/grad_compress.py``).

``quantize_int8`` and ``dequantize`` only: the reference's
``compressed_psum`` (int8 all-reduce with error feedback over a data-parallel
axis) waits for the port's multi-card work (ROADMAP.md queue 1 item 7).
"""

from __future__ import annotations

import torch


def quantize_int8(x: torch.Tensor, scale: torch.Tensor | float) -> torch.Tensor:
    """round(x / scale) clipped to [-127, 127], as int8 (x read in fp32)."""
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)


def dequantize(q: torch.Tensor, scale: torch.Tensor | float) -> torch.Tensor:
    return q.float() * scale
