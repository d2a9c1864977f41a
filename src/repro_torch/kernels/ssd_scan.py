"""Mamba2 SSD chunk scan: the CUDA kernel's wrapper and its plain version.

Replaces ``repro/kernels/ssd_scan.py::ssd_scan`` (Pallas ``_ssd_kernel``):
within each chunk a masked-decay ``(C·Bᵀ ∘ L)·(x·dt)``, across chunks a
carried fp32 ``[P, N]`` state.  On the LM path it is the prefill scan of
every ``ssd`` model, in place of the reference's ``blocks.ssd_chunked``.
Unlike the Pallas kernel it also returns the final state, which
``ssd_block(return_state=True)`` hands to decode.  The kernel,
``csrc/ssd_scan.cu``, runs one block per (batch, head, ≤64-row tile of the
state) with the state in shared memory across a loop over chunks, and reads
B and C from their ``[b, l, n]`` rows rather than copying them per head.

:func:`ssd_scan_plain` uses the Pallas kernel's fp32 chunk arithmetic in
PyTorch; the CPU path and the on-card checks use it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

#: launches of the CUDA kernel since this count was last set to 0
launches = 0

#: state rows over p per block, and the most shared memory a block may use on the H100
P_TILE = 64
MAX_SMEM_BYTES = 232_448
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_shapes(x, dt, A, B, C, chunk: int) -> None:
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 3 or C.shape != B.shape:
        raise ValueError(f"need x [b,l,h,p], dt [b,l,h], A [h], B, C [b,l,n]; got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}, {tuple(B.shape)}, {tuple(C.shape)}")
    b, l, h, _ = x.shape
    if tuple(dt.shape) != (b, l, h) or A.shape[0] != h or tuple(B.shape[:2]) != (b, l):
        raise ValueError(f"inconsistent shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
                         f"B {tuple(B.shape)}")
    if chunk < 1 or l % chunk != 0:
        raise ValueError(f"sequence length {l} is not a multiple of chunk {chunk}")


def ssd_scan_plain(x, dt, A, B, C, *, chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD in plain PyTorch, fp32 inside.  x: [b, l, h, p]; dt: [b, l, h];
    A: [h]; B, C: [b, l, n] -> (y [b, l, h, p] in ``x.dtype``, final state
    [b, h, p, n] fp32)."""
    _check_shapes(x, dt, A, B, C, chunk)
    b, l, h, p = x.shape
    n = B.shape[-1]
    nc = l // chunk
    xf = x.float().reshape(b, nc, chunk, h, p)
    dtf = dt.float().reshape(b, nc, chunk, h)
    Bf = B.float().reshape(b, nc, chunk, n)
    Cf = C.float().reshape(b, nc, chunk, n)
    cum = torch.cumsum(dtf * A.float(), dim=2)  # [b, c, cl, h] log decay
    xdt = xf * dtf[..., None]
    idx = torch.arange(chunk, device=x.device)
    causal = idx[:, None] >= idx[None, :]
    # intra-chunk: L[l, s] = exp(cum_l - cum_s) for l >= s, 0 above the diagonal
    seg = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).permute(0, 1, 4, 2, 3)  # [b, c, h, l, s]
    ldec = torch.where(causal, torch.exp(seg), torch.zeros((), device=x.device))
    g = torch.einsum("bcln,bcsn->bcls", Cf, Bf)
    y = torch.einsum("bchls,bcshp->bclhp", g[:, :, None] * ldec, xdt)
    # inter-chunk: the carried state, then its update, in order
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # [b, c, cl, h]
    ys = []
    for c in range(nc):
        y_c = y[:, c] + torch.exp(cum[:, c])[..., None] * torch.einsum("bln,bhpn->blhp", Cf[:, c], state)
        ys.append(y_c)
        new = torch.einsum("blhp,bln->bhpn", decay_to_end[:, c, :, :, None] * xdt[:, c], Bf[:, c])
        state = state * torch.exp(cum[:, c, -1])[..., None, None] + new
    return torch.stack(ys, dim=1).reshape(b, l, h, p).to(x.dtype), state


def smem_bytes(chunk: int, n: int, p_tile: int) -> int:
    """Dynamic shared memory of one block (``smem_floats`` in the source)."""
    return 4 * (2 * chunk * (n + 1) + p_tile * (n + 1) + chunk * p_tile + chunk * chunk + 3 * chunk)


def ssd_scan(x, dt, A, B, C, *, chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD on the CUDA kernel.  x: [b, l, h, p] float32 or bfloat16 with
    unit stride over p; dt: [b, l, h] float32; A: [h] float32 contiguous;
    B, C: [b, l, n] of x's type with unit stride over n (other strides free,
    so slices of one projection pass without a copy) -> (y contiguous
    [b, l, h, p] of x's type, final state [b, h, p, n] float32).

    Launches on the current stream without synchronising; raises if the
    inputs are not what the kernel takes or the launch is refused.
    """
    global launches
    ts = (x, dt, A, B, C)
    if not all(t.is_cuda for t in ts):
        raise ValueError(f"ssd_scan needs CUDA tensors, got {[str(t.device) for t in ts]}")
    if any(t.device != x.device for t in ts) or x.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {[str(t.device) for t in ts]}, current device cuda:{torch.cuda.current_device()}")
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd_scan takes x, B, C float32 or bfloat16 alike, got {x.dtype}, {B.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd_scan takes dt and A float32, got {dt.dtype}, {A.dtype}")
    _check_shapes(x, dt, A, B, C, chunk)
    b, l, h, p = x.shape
    n = B.shape[-1]
    if min(b, l, h, p, n) == 0:
        raise ValueError(f"empty scan: x {tuple(x.shape)}, B {tuple(B.shape)}")
    if x.stride(3) != 1 or B.stride(2) != 1 or C.stride(2) != 1 or not A.is_contiguous():
        raise ValueError("ssd_scan needs unit stride over p (x) and n (B, C) and a contiguous A")
    p_tile = min(p, P_TILE)
    smem = smem_bytes(chunk, n, p_tile)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"chunk {chunk} with state {n} needs {smem} B of shared memory per block "
                         f"(at most {MAX_SMEM_BYTES})")
    if b * h * -(-p // p_tile) > 2**31 - 1:
        raise ValueError(f"grid too large for x {tuple(x.shape)}")
    y = torch.empty((b, l, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    err = _kernel()(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(), state.data_ptr(),
        _DTYPES[x.dtype], b, l, h, p, n, chunk, p_tile,
        *x.stride()[:3], *dt.stride(), B.stride(0), B.stride(1), C.stride(0), C.stride(1),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: cudaError {err}")
    launches += 1
    return y, state


@functools.cache
def _kernel():
    from .build import library

    fn = library("ssd_scan").ssd_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
