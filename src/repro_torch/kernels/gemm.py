"""Batched GEMM: the CUDA kernel's wrapper and its plain version.

Replaces ``repro/kernels/gemm.py::gemm`` (Pallas ``_gemm_kernel``):
``C = A·B`` with an fp32 accumulator and the output in ``a.dtype``.  On the
LM path it runs the three capacity-batched expert products of
``blocks.moe_ffn_local`` (the reference's einsums ``ecd,edf->ecf`` and
``ecf,efd->ecd``), all experts in one launch.  The kernel,
``csrc/gemm.cu``, runs bf16 on the tensor cores (``mma.sync`` m16n8k16,
fp32 accumulators, a 4-stage ``cp.async`` ring, the tile picked by M) and
fp32 on the FMA pipes with no TF32; ragged edges are masked in the kernel,
not padded (see the source note).

:func:`gemm_plain` is the same function in fp32 PyTorch, cast to
``a.dtype``, as the reference's ``gemm_ref``; the CPU path and the on-card
checks use it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

#: launches of the CUDA kernel since this count was last set to 0
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_shapes(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() not in (2, 3) or b.dim() != a.dim():
        raise ValueError(f"need a [M, K] and b [K, N], or a [E, M, K] and b [E, K, N]; got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if a.shape[-1] != b.shape[-2] or a.shape[:-2] != b.shape[:-2]:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} disagree on K or the batch")


def gemm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: [..., M, K] @ b: [..., K, N] -> [..., M, N] in ``a.dtype``, summed in fp32.
    Either both are 2-D or both share one leading batch dim."""
    _check_shapes(a, b)
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def _aligned(t: torch.Tensor) -> bool:
    """Every row starts 16-byte aligned (bf16: strides multiples of 8 elements)."""
    return t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in t.stride()[:-1])


def gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A·B on the CUDA kernel.  a: [M, K] and b: [K, N], or a: [E, M, K]
    and b: [E, K, N] (one launch for the whole batch); float32 or bfloat16
    alike, on the current CUDA device, unit stride over the last dim (other
    strides free) -> [(E,) M, N] contiguous in ``a.dtype``.

    Launches on the current stream without synchronising; raises if the
    inputs are not what the kernel takes or the launch is refused.
    """
    global launches
    if not (a.is_cuda and b.is_cuda):
        raise ValueError(f"gemm needs CUDA tensors, got {a.device}, {b.device}")
    if a.device != b.device or a.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {a.device}/{b.device}, current device cuda:{torch.cuda.current_device()}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"gemm takes float32 or bfloat16 alike, got {a.dtype}, {b.dtype}")
    _check_shapes(a, b)
    if a.stride(-1) != 1 or b.stride(-1) != 1:
        raise ValueError("gemm needs unit stride over the last dim of a and b")
    batched = a.dim() == 3
    a3, b3 = (a, b) if batched else (a[None], b[None])
    E, M, K = a3.shape
    N = b3.shape[2]
    if min(E, M, N, K) == 0:
        raise ValueError(f"empty gemm: a {tuple(a.shape)}, b {tuple(b.shape)}")
    if E > 65535 or -(-M // 16) > 65535:
        raise ValueError(f"gemm too large for the kernel's grid: a {tuple(a.shape)}, b {tuple(b.shape)}")
    c = torch.empty((E, M, N), dtype=a.dtype, device=a.device)
    vec = a.dtype == torch.bfloat16 and K % 8 == 0 and N % 8 == 0 and _aligned(a3) and _aligned(b3)
    err = _kernel()(
        a3.data_ptr(), b3.data_ptr(), c.data_ptr(), _DTYPES[a.dtype], E, M, N, K,
        a3.stride(0), a3.stride(1), b3.stride(0), b3.stride(1), c.stride(0), c.stride(1),
        int(vec), torch.cuda.current_stream(a.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"gemm launch failed: cudaError {err}")
    launches += 1
    return c if batched else c[0]


@functools.cache
def _kernel():
    from .build import library

    fn = library("gemm").gemm_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 6 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
