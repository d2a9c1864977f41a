"""Batched GEMM: the CUDA kernel's wrapper and its plain version.

Replaces ``repro/kernels/gemm.py::gemm`` (Pallas ``_gemm_kernel``):
``C = A·B`` with an fp32 accumulator and the output in ``a.dtype``.  On the
LM path it runs the three capacity-batched expert products of
``blocks.moe_ffn_local`` (the reference's einsums ``ecd,edf->ecf`` and
``ecf,efd->ecd``), all experts in one launch.  ``csrc/gemm.cu`` holds five
kernels and :func:`route` picks one by type, M and alignment alone: bf16
prefill products (M > 16, rows the TMA can address) on
``gemm_wgmma_bf16_kernel`` (``wgmma`` fed by TMA through an ``mbarrier``
ring), bf16 decode (M <= 16) and unaligned bf16 on ``mma.sync`` tiles, fp32
on the FMA pipes with no TF32.  Ragged edges are handled in the kernels, not
padded (see the source note).

:func:`gemm_plain` is the same function in fp32 PyTorch, cast to
``a.dtype``, as the reference's ``gemm_ref``; the CPU path and the on-card
checks use it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

#: launches of the CUDA kernels since this count was last set to 0
launches = 0
#: of those, the launches made for a gradient (``ops.gemm``'s backward, dA and dB) since this count was last set to 0
bwd_launches = 0
#: gemm_fwd's own error codes (csrc/gemm.cu): no tensor-map encoder; a refused map (+ CUresult)
_NO_ENCODER, _TENSOR_MAP_ERROR = 9999, 10000

#: the kernels of ``csrc/gemm.cu``, indexed by the route code ``gemm_fwd`` takes
KERNELS = (
    "gemm_fma_f32_kernel",  # fp32
    "gemm_mma_bf16_kernel<16, 128> 16-byte rows",  # bf16, M <= 16
    "gemm_mma_bf16_kernel<16, 128> masked",  # bf16, M <= 16, rows not 16-byte aligned
    "gemm_mma_bf16_kernel<64, 256> masked",  # bf16, M > 16, rows not 16-byte aligned
    "gemm_wgmma_bf16_kernel",  # bf16, M > 16, rows the TMA can address
)


def route(dtype: torch.dtype, m: int, k: int, n: int, aligned: bool) -> int:
    """Index in :data:`KERNELS` of the kernel that computes a [m, k] · [k, n]
    product, by shape, type and alignment alone.  ``aligned``: every row of
    a, b and the output starts 16-byte aligned (:func:`_aligned`).  bf16
    rows the TMA can address need that and K, N multiples of 8."""
    if dtype == torch.float32:
        return 0
    if dtype != torch.bfloat16:
        raise TypeError(f"gemm takes float32 or bfloat16, got {dtype}")
    vec = aligned and k % 8 == 0 and n % 8 == 0
    if m <= 16:
        return 1 if vec else 2
    return 4 if vec else 3


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
    if a.dtype not in (torch.float32, torch.bfloat16) or b.dtype != a.dtype:
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
    kernel = route(a.dtype, M, K, N, _aligned(a3) and _aligned(b3))
    err = _kernel()(
        a3.data_ptr(), b3.data_ptr(), c.data_ptr(), kernel, E, M, N, K,
        a3.stride(0), a3.stride(1), b3.stride(0), b3.stride(1), c.stride(0), c.stride(1),
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    if err >= _TENSOR_MAP_ERROR:
        raise RuntimeError(f"gemm: {KERNELS[kernel]}: the driver refused a tensor map (CUresult {err - _TENSOR_MAP_ERROR})")
    if err == _NO_ENCODER:
        raise RuntimeError(f"gemm: {KERNELS[kernel]}: no cuTensorMapEncodeTiled in the loaded CUDA driver")
    if err != 0:
        raise RuntimeError(f"gemm: {KERNELS[kernel]} launch failed: cudaError {err}")
    launches += 1
    return c if batched else c[0]


@functools.cache
def _kernel():
    from .build import library

    fn = library("gemm").gemm_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
