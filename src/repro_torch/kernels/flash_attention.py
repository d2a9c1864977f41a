"""Flash attention: the CUDA kernel's wrapper and its plain version.

Replaces ``repro/kernels/flash_attention.py::flash_attention`` (Pallas
``_flash_kernel``): forward online-softmax attention with an optional causal
mask and GQA head grouping.  On the LM path it is the prefill attention of
every ``attn`` model, in place of the reference's ``blocks._sdpa`` (which
calls itself the XLA stand-in for this kernel).  ``csrc/flash_attention.cu``
holds two kernels, picked by type: bf16 runs ``flash_fwd_mma_bf16_kernel``
on the tensor cores (``mma.sync`` products with fp32 accumulators, Q in
registers, a ``cp.async`` K/V ring, P kept in registers), fp32 runs
``flash_fwd_kernel`` on the SIMT pipes (TF32 would miss the reference's
2e-4).  Both keep the running max, normaliser and accumulator in fp32, skip
causal tiles above the diagonal, mask a sliding window as ``_sdpa`` does and
mask a ragged ``S`` instead of asserting that it divides the tile (see the
source note).

:func:`flash_attention_plain` is exact softmax attention in fp32 with the
same masks and the same cast of the probabilities to ``v.dtype`` before
P·V; the CPU path and the on-card checks use it.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

#: launches of the CUDA kernel since this count was last set to 0
launches = 0

#: head dims the kernels are built for (zamba2-2.7b runs 80, nemotron-4-340b 192)
HEAD_DIMS = (16, 32, 64, 80, 128, 192)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q [B,H,S,D] and k, v [B,KVH,S,D], got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, s, d = q.shape
    if k.shape[0] != b or k.shape[2] != s or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} disagree on batch, length or head dim")
    if k.shape[1] == 0 or h % k.shape[1] != 0:
        raise ValueError(f"q heads {h} are not a multiple of kv heads {k.shape[1]}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True, window: int = 0
) -> torch.Tensor:
    """Exact attention in fp32.  q: [B, H, S, D]; k, v: [B, KVH, S, D] ->
    [B, H, S, D] in ``q.dtype``.  Key j is visible to query i when
    ``j <= i`` (causal) and ``i - j < window`` (window > 0)."""
    _check_shapes(q, k, v, window)
    b, h, s, d = q.shape
    kvh = k.shape[1]
    qg = q.float().reshape(b, kvh, h // kvh, s, d)
    scores = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) / math.sqrt(d)
    pos = torch.arange(s, device=q.device)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if window:
        mask &= pos[:, None] - pos[None, :] < window
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(v.dtype).float()
    out = torch.einsum("bkgqs,bksd->bkgqd", probs, v.float())
    return out.reshape(b, h, s, d).to(q.dtype)


def _vector_strides(t: torch.Tensor) -> tuple[int, int, int] | None:
    """The batch, head and position strides of ``t`` if it has unit stride
    over D, strides that are multiples of 4 and a 16-byte aligned base (rows
    the kernel's vector copies can read), else None."""
    sb, sh, ss, sd = t.stride()
    if sd != 1 or sb % 4 or sh % 4 or ss % 4 or t.data_ptr() % 16:
        return None
    return sb, sh, ss


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True, window: int = 0
) -> torch.Tensor:
    """Attention on the CUDA kernel.  q: [B, H, S, D]; k, v: [B, KVH, S, D],
    float32 or bfloat16 on the current CUDA device, D in ``HEAD_DIMS``, unit
    stride over D (other strides free, so ``[b, s, h, d]`` tensors pass as
    transposed views) -> [B, H, S, D] with q's layout and type.

    Launches on the current stream without synchronising; raises if the
    inputs are not what the kernel takes or the launch is refused.
    """
    global launches
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError(f"flash_attention needs CUDA tensors, got {q.device}, {k.device}, {v.device}")
    if not (q.device == k.device == v.device) or q.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {q.device}/{k.device}/{v.device}, current device "
                         f"cuda:{torch.cuda.current_device()}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 alike, got {q.dtype}, {k.dtype}, {v.dtype}")
    _check_shapes(q, k, v, window)
    b, h, s, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported (have {HEAD_DIMS})")
    if min(b, s) == 0:
        raise ValueError(f"empty attention: q {tuple(q.shape)}")
    if b * h > 2**31 - 1 or -(-s // 64) > 65535:
        raise ValueError(f"grid too large for q {tuple(q.shape)}")
    strides = [_vector_strides(t) for t in (q, k, v)]
    if None in strides:
        raise ValueError("flash_attention needs unit stride over D and 16-byte aligned rows (strides % 4 == 0)")
    o = torch.empty_like(q)  # same strides as q: a transposed [b, s, h, d] view stays one
    err = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), _DTYPES[q.dtype],
        b, h, k.shape[1], s, d,
        *strides[0], *strides[1], *strides[2], *o.stride()[:3],
        int(causal), int(window), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    launches += 1
    return o


@functools.cache
def _kernel():
    """The C entry ``flash_attention_fwd``, typed."""
    from .build import library

    fn = library("flash_attention").flash_attention_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
        + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn
