"""Mamba2 SSD chunk scan: the CUDA kernels' wrapper, their plan and the plain version.

Replaces ``repro/kernels/ssd_scan.py::ssd_scan`` (Pallas ``_ssd_kernel``):
within each chunk a masked-decay ``(C·Bᵀ ∘ L)·(x·dt)``, across chunks a
carried fp32 ``[P, N]`` state.  On the LM path it is the prefill scan of
every ``ssd`` model, in place of the reference's ``blocks.ssd_chunked``.
Unlike the Pallas kernel it also returns the final state, which
``ssd_block(return_state=True)`` hands to decode.

``csrc/ssd_scan.cu`` holds two kernels, both one block per (batch, head,
tile of the state's rows over p) with a loop over chunks inside, reading B
and C from their ``[b, l, n]`` rows rather than copying them per head.
:func:`route` picks one by type, shape and alignment alone: bf16 at chunk
16/32/64, state width 64/128, p a multiple of 16 and 16-byte-aligned rows on
``ssd_scan_mma_bf16_kernel`` (the four chunk products on ``mma.sync``, each
operand that is not exact in bf16 split into bf16 terms, the state in fp32
registers, a ``cp.async`` ring over chunks); everything else, fp32
included, on ``ssd_scan_kernel`` (fp32 FMA on the SIMT pipes).
:func:`plan` picks the tensor-core kernel's p tile from the shape and the
SM count (see the source note for both designs).

:func:`ssd_scan_plain` uses the Pallas kernel's fp32 chunk arithmetic in
PyTorch; the CPU path and the on-card checks use it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

#: launches of the CUDA kernels since this count was last set to 0
launches = 0

#: the kernels of ``csrc/ssd_scan.cu``, indexed by the route code ``ssd_scan_fwd`` takes
KERNELS = (
    "ssd_scan_kernel<float>",  # fp32
    "ssd_scan_kernel<__nv_bfloat16>",  # bf16 outside the tensor-core kernel's shapes
    "ssd_scan_mma_bf16_kernel",  # bf16 on the tensor cores
)
#: state rows over p per block of the SIMT kernel
SIMT_P_TILE = 64
#: what the tensor-core kernel compiles: chunks, state widths, p tiles (largest first)
MMA_CHUNKS, MMA_STATES, MMA_P_TILES = (16, 32, 64), (64, 128), (64, 32, 16)
#: bf16 terms the tensor-core kernel splits each product operand that is not exact in bf16 into (SSD_TERMS)
MMA_TERMS = 3
#: the most shared memory a block may use on the H100, and its SMs
MAX_SMEM_BYTES = 232_448
H100_SMS = 132
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


def simt_smem_bytes(chunk: int, n: int, p_tile: int) -> int:
    """Dynamic shared memory of one ``ssd_scan_kernel`` block (``smem_floats`` in the source)."""
    return 4 * (2 * chunk * (n + 1) + p_tile * (n + 1) + chunk * p_tile + chunk * chunk + 3 * chunk)


def mma_smem_bytes(chunk: int, n: int, p_tile: int) -> int:
    """Dynamic shared memory of one ``ssd_scan_mma_bf16_kernel`` block
    (``mma_smem_bytes`` in the source): a 2-stage ring of x, B, C (bf16,
    rows padded by 8) and dt, the state (fp32), the 10 tiles of the scaled
    C·Bᵀ of a 64-step chunk on and below its diagonal (fp32), each of the 8
    warps' factors."""
    stage = chunk * ((p_tile + 8) + 2 * (n + 8)) * 2 + chunk * 4
    return 2 * stage + p_tile * n * 4 + 10 * 256 * 4 + 8 * 3 * 64 * 4


def route(dtype: torch.dtype, p: int, n: int, chunk: int, aligned: bool) -> int:
    """Index in :data:`KERNELS` of the kernel that scans x ``[.., p]`` with
    B, C ``[.., n]`` at ``chunk``, by type, shape and alignment alone.
    ``aligned``: x, B and C start 16-byte aligned with every stride but the
    last a multiple of 8 elements (:func:`_aligned`)."""
    if dtype == torch.float32:
        return 0
    if dtype != torch.bfloat16:
        raise TypeError(f"ssd_scan takes float32 or bfloat16, got {dtype}")
    mma = aligned and chunk in MMA_CHUNKS and n in MMA_STATES and p % 16 == 0
    return 2 if mma else 1


@dataclasses.dataclass(frozen=True)
class SsdPlan:
    """How a kernel of :data:`KERNELS` runs one shape: ``p_tile`` rows of the
    state over p a block, ``blocks`` in the grid, ``smem`` bytes a block."""

    route: int
    p_tile: int
    blocks: int
    smem: int


def _plan_of(kernel: int, b: int, h: int, p: int, n: int, chunk: int, p_tile: int) -> SsdPlan:
    blocks = b * h * -(-p // p_tile)
    smem = mma_smem_bytes(chunk, n, p_tile) if kernel == 2 else simt_smem_bytes(chunk, n, p_tile)
    return SsdPlan(kernel, p_tile, blocks, smem)


@functools.lru_cache(maxsize=1024)
def plan(dtype: torch.dtype, b: int, h: int, p: int, n: int, chunk: int, aligned: bool,
         sms: int = H100_SMS) -> SsdPlan:
    """The plan for x ``[b, l, h, p]``, B, C ``[b, l, n]`` at ``chunk`` on a
    card of ``sms`` SMs, a pure function of these.  The SIMT kernel takes
    p tiles of :data:`SIMT_P_TILE`.  The tensor-core kernel takes the
    largest p tile of :data:`MMA_P_TILES` that still launches a block on
    every SM (a wider tile reads B and C and computes C·Bᵀ for more rows at
    once), else the smallest (``scripts/ssd_probe.py``, PERF.md)."""
    kernel = route(dtype, p, n, chunk, aligned)
    if kernel != 2:
        return _plan_of(kernel, b, h, p, n, chunk, min(p, SIMT_P_TILE))
    for p_tile in MMA_P_TILES:
        chosen = _plan_of(kernel, b, h, p, n, chunk, p_tile)
        if chosen.blocks >= sms:
            return chosen
    return chosen


def mma_plans(b: int, h: int, p: int, n: int, chunk: int) -> list[SsdPlan]:
    """Every p tile of the tensor-core kernel at this shape (which
    :func:`route` must send there), as :func:`run_plan` takes them."""
    return [_plan_of(2, b, h, p, n, chunk, p_tile) for p_tile in MMA_P_TILES]


def _aligned(t: torch.Tensor) -> bool:
    """Starts 16-byte aligned, every stride but the last a multiple of 8 elements (bf16 rows)."""
    return t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in t.stride()[:-1])


def _check(x, dt, A, B, C, chunk: int) -> None:
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


def ssd_scan(x, dt, A, B, C, *, chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD on the CUDA kernel :func:`plan` picks.  x: [b, l, h, p] float32
    or bfloat16 with unit stride over p; dt: [b, l, h] float32; A: [h]
    float32 contiguous; B, C: [b, l, n] of x's type with unit stride over n
    (other strides free, so slices of one projection pass without a copy)
    -> (y contiguous [b, l, h, p] of x's type, final state [b, h, p, n]
    float32).

    Launches on the current stream without synchronising; raises if the
    inputs are not what the kernel takes or the launch is refused.
    """
    _check(x, dt, A, B, C, chunk)
    b, _, h, p = x.shape
    aligned = _aligned(x) and _aligned(B) and _aligned(C)
    chosen = plan(x.dtype, b, h, p, B.shape[-1], chunk, aligned, sms=_sm_count(x.device.index))
    return _launch(x, dt, A, B, C, chunk, chosen)


def run_plan(x, dt, A, B, C, chunk: int, p: SsdPlan) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the scan as ``p`` says, which need not be :func:`plan`'s (the
    inputs checked as :func:`ssd_scan` checks them, the plan against what
    the kernels compile)."""
    _check(x, dt, A, B, C, chunk)
    b, _, h, pp = x.shape
    n = B.shape[-1]
    kernel = route(x.dtype, pp, n, chunk, _aligned(x) and _aligned(B) and _aligned(C))
    ok = (p.route == kernel and p == _plan_of(kernel, b, h, pp, n, chunk, p.p_tile)
          and (p in mma_plans(b, h, pp, n, chunk) if kernel == 2 else p.p_tile == min(pp, SIMT_P_TILE)))
    if not ok:
        raise ValueError(f"plan {p} is not one of {KERNELS[kernel]}'s for x {tuple(x.shape)}, n {n}, chunk {chunk}")
    return _launch(x, dt, A, B, C, chunk, p)


def _launch(x, dt, A, B, C, chunk: int, p: SsdPlan) -> tuple[torch.Tensor, torch.Tensor]:
    global launches
    b, l, h, pp = x.shape
    n = B.shape[-1]
    if p.smem > MAX_SMEM_BYTES:
        raise ValueError(f"chunk {chunk} with state {n} needs {p.smem} B of shared memory per block "
                         f"(at most {MAX_SMEM_BYTES})")
    if p.blocks > 2**31 - 1:
        raise ValueError(f"grid too large for x {tuple(x.shape)}")
    y = torch.empty((b, l, h, pp), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, pp, n), dtype=torch.float32, device=x.device)
    err = _kernel()(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(), state.data_ptr(),
        p.route, b, l, h, pp, n, chunk, p.p_tile,
        *x.stride()[:3], *dt.stride(), B.stride(0), B.stride(1), C.stride(0), C.stride(1),
        # the current stream's handle without building a torch.cuda.Stream:
        # at these sizes the host's time to issue a call rivals the card's
        torch._C._cuda_getCurrentRawStream(x.device.index),
    )
    if err != 0:
        raise RuntimeError(f"ssd_scan: {KERNELS[p.route]} ({p}) launch failed: cudaError {err}")
    launches += 1
    return y, state


def occupancy(n: int, p_tile: int, chunk: int) -> int:
    """Blocks of ``ssd_scan_mma_bf16_kernel<n, p_tile>`` at ``chunk`` one SM
    of the current card holds at once."""
    fn = library().ssd_scan_mma_occupancy
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    got = fn(n, p_tile, chunk)
    if got < 0:
        raise RuntimeError(f"ssd_scan_mma_bf16_kernel<{n}, {p_tile}> occupancy: cudaError {-got}")
    return got


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def library() -> ctypes.CDLL:
    from .build import library as load

    return load("ssd_scan")


@functools.cache
def _kernel():
    fn = library().ssd_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
