"""Im2Col + GEMM convolution: the CUDA kernel's wrapper and its plain version.

Replaces ``repro/kernels/im2col_conv.py::conv2d_im2col`` (Pallas
``_conv_kernel``), the GEMM-based conv operator the paper simulates (§6).
The kernel, ``csrc/conv2d_im2col.cu``, is an implicit GEMM over
``M = N·HO·WO`` output pixels, ``K`` output channels and an ``R·S·C``
reduction, in full fp32 on the FMA pipes.  It is bound by operations at the
shapes of the paper's CNNs.  Its design: 128×64 output tiles spread over
blocks, input patches gathered from the unpadded input into shared memory
with the SAME padding and ragged edges masked, fp32 accumulators in
registers.

:func:`conv2d_im2col_plain` computes the same function in PyTorch with the
Pallas kernel's arithmetic (a sum of R·S shifted ``[HO·WO, C] × [C, K]``
products); the CPU path and the on-card checks use it.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

#: launches of the CUDA kernel since this count was last set to 0
launches = 0

_INT32_MAX = 2**31 - 1


def same_padding(h: int, w: int, r: int, s: int, stride: int) -> tuple[int, int, int, int, int, int]:
    """(HO, WO, pad_top, pad_bottom, pad_left, pad_right) of a SAME conv:
    ``HO = ceil(H / stride)``, padding split ``pad // 2`` before, the rest
    after, as ``repro/kernels/im2col_conv.py`` pads."""
    ho, wo = -(-h // stride), -(-w // stride)
    pad_h = max((ho - 1) * stride + r - h, 0)
    pad_w = max((wo - 1) * stride + s - w, 0)
    return ho, wo, pad_h // 2, pad_h - pad_h // 2, pad_w // 2, pad_w - pad_w // 2


def conv2d_im2col_plain(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1) -> torch.Tensor:
    """SAME-padded conv in plain PyTorch. x: [N, H, W, C]; w: [R, S, C, K]
    -> [N, HO, WO, K], accumulated in fp32 and cast to ``x.dtype``."""
    n, h, wd, c = x.shape
    r, s, c2, k = w.shape
    if c != c2:
        raise ValueError(f"channel mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}")
    ho, wo, pt, pb, pl, pr = same_padding(h, wd, r, s, stride)
    xp = F.pad(x, (0, 0, pl, pr, pt, pb))
    acc = torch.zeros((n * ho * wo, k), dtype=torch.float32, device=x.device)
    for dr in range(r):
        for ds in range(s):
            patch = xp[:, dr : dr + (ho - 1) * stride + 1 : stride, ds : ds + (wo - 1) * stride + 1 : stride, :]
            acc += patch.reshape(n * ho * wo, c).float() @ w[dr, ds].float()
    return acc.reshape(n, ho, wo, k).to(x.dtype)


def conv2d_im2col(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1) -> torch.Tensor:
    """SAME-padded conv on the CUDA kernel. x: [N, H, W, C] fp32 contiguous
    on the current CUDA device; w: [R, S, C, K] likewise -> [N, HO, WO, K].

    Launches on the current stream without synchronising; raises if the
    inputs are not what the kernel takes or the launch is refused.
    """
    global launches
    if not (x.is_cuda and w.is_cuda):
        raise ValueError(f"conv2d_im2col needs CUDA tensors, got {x.device} and {w.device}")
    if x.device != w.device or x.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {x.device}/{w.device}, current device cuda:{torch.cuda.current_device()}")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"conv2d_im2col takes float32, got {x.dtype} and {w.dtype}")
    if x.dim() != 4 or w.dim() != 4 or x.shape[3] != w.shape[2]:
        raise ValueError(f"need x [N,H,W,C] and w [R,S,C,K], got {tuple(x.shape)} and {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv2d_im2col needs contiguous tensors")
    if stride < 1:
        raise ValueError(f"stride must be positive, got {stride}")
    n, h, wd, c = x.shape
    r, s, _, k = w.shape
    ho, wo, pt, _, pl, _ = same_padding(h, wd, r, s, stride)
    if min(n, h, wd, c, r, s, k) == 0:
        raise ValueError(f"empty conv: x {tuple(x.shape)}, w {tuple(w.shape)}")
    if max(x.numel(), w.numel(), n * ho * wo * k) > _INT32_MAX:
        raise ValueError("conv2d_im2col indexes with int32; tensors above 2**31 elements are not supported")
    y = torch.empty((n, ho, wo, k), dtype=torch.float32, device=x.device)
    fn = _kernel()
    err = fn(
        x.data_ptr(), w.data_ptr(), y.data_ptr(),
        n, h, wd, c, r, s, k, stride, ho, wo, pt, pl,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"conv2d_im2col launch failed: cudaError {err}")
    launches += 1
    return y


@functools.cache
def _kernel():
    from .build import library

    fn = library("conv2d_im2col").conv2d_im2col_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
