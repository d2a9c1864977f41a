"""Public kernel entry points: the device of the input picks the path.

A CUDA tensor goes to the hand-written kernel, which launches or raises; a
CPU tensor, which only a caller that asked for the CPU holds, goes to the
plain PyTorch version.  There is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from . import flash_attention as _fa
from . import gemm as _gemm
from . import im2col_conv
from . import ssd_scan as _ssd


def gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A·B, fp32 sum, output in a's type. a: [(E,) M, K]; b: [(E,) K, N] -> [(E,) M, N]."""
    if a.is_cuda:
        return _gemm.gemm(a, b)
    if a.device.type == "cpu":
        return _gemm.gemm_plain(a, b)
    raise ValueError(f"no gemm for device {a.device}")


def conv2d_im2col(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1) -> torch.Tensor:
    """SAME-padded conv. x: [N, H, W, C]; w: [R, S, C, K] -> [N, HO, WO, K]."""
    if x.is_cuda:
        return im2col_conv.conv2d_im2col(x, w, stride=stride)
    if x.device.type == "cpu":
        return im2col_conv.conv2d_im2col_plain(x, w, stride=stride)
    raise ValueError(f"no conv2d_im2col for device {x.device}")


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True, window: int = 0
) -> torch.Tensor:
    """Attention. q: [B, H, Sq, D]; k, v: [B, KVH, Skv, D] -> [B, H, Sq, D]
    (the causal mask top-left: key j visible to query i when j <= i)."""
    if q.is_cuda:
        return _fa.flash_attention(q, k, v, causal=causal, window=window)
    if q.device.type == "cpu":
        return _fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    raise ValueError(f"no flash_attention for device {q.device}")


def ssd_scan(x, dt, A, B, C, *, chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD. x: [b, l, h, p]; dt: [b, l, h]; A: [h]; B, C: [b, l, n]
    -> (y [b, l, h, p], final state [b, h, p, n] fp32)."""
    if x.is_cuda:
        return _ssd.ssd_scan(x, dt, A, B, C, chunk=chunk)
    if x.device.type == "cpu":
        return _ssd.ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
    raise ValueError(f"no ssd_scan for device {x.device}")
