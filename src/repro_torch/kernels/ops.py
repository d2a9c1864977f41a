"""Public kernel entry points: the device of the input picks the path.

A CUDA tensor goes to the hand-written kernel, which launches or raises; a
CPU tensor, which only a caller that asked for the CPU holds, goes to the
plain PyTorch version.  There is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from . import im2col_conv


def conv2d_im2col(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1) -> torch.Tensor:
    """SAME-padded conv. x: [N, H, W, C]; w: [R, S, C, K] -> [N, HO, WO, K]."""
    if x.is_cuda:
        return im2col_conv.conv2d_im2col(x, w, stride=stride)
    if x.device.type == "cpu":
        return im2col_conv.conv2d_im2col_plain(x, w, stride=stride)
    raise ValueError(f"no conv2d_im2col for device {x.device}")
