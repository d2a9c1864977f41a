"""Batched GEMM: the CUDA kernel's wrapper and its plain version.

Replaces ``repro/kernels/gemm.py::gemm`` (Pallas ``_gemm_kernel``):
``C = A·B`` with an fp32 accumulator and the output in ``a.dtype``.  On the
LM path it runs the three capacity-batched expert products of
``blocks.moe_ffn_local`` (the reference's einsums ``ecd,edf->ecf`` and
``ecf,efd->ecd``), all experts in one launch, and in training their
gradients dA = dC·Bᵀ and dB = Aᵀ·dC, which ``ops.gemm``'s backward passes
as transposed views.  Each operand may have unit stride over either of its
last two dims: A [M, K] K-major (unit over K) or MN-major (unit over M), B
[K, N] MN-major (unit over N) or K-major (unit over K).  :func:`route`
picks a kernel of ``csrc/gemm.cu`` by type, M, K, the two majors and
alignment alone: bf16 products with M > 16 and rows the TMA can address on
``gemm_wgmma_bf16_kernel`` (``wgmma`` fed by TMA through an ``mbarrier``
ring), one instantiation per pair of majors and schedule (a long reduction,
or a short one such as dB's), each reading both operands where they lie;
bf16 decode (M <= 16) with rows the TMA can address on
``gemm_decode_bf16_kernel`` and ``gemm_decode_sum_kernel`` (a persistent
grid that gives every SM an equal share of the weights, :func:`decode_plan`,
and sums the K slices of the tiles split between SMs in a fixed order);
unaligned bf16 on ``mma.sync`` tiles, fp32 on the FMA pipes with no TF32.
All but the wgmma route read A K-major and B MN-major only: there, and only
there, the wrapper copies a transposed view first.  Ragged edges are
handled in the kernels, not padded (see the source note).

:func:`gemm_plain` is the same function in fp32 PyTorch, cast to
``a.dtype``, as the reference's ``gemm_ref``; the CPU path and the on-card
checks use it.  :func:`gemm_decode_plain` composes the decode route's split
in PyTorch: the same K slices, summed in the same order.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

#: launches of the CUDA kernels since this count was last set to 0
launches = 0
#: of those, the launches made for a gradient (``ops.gemm``'s backward, dA and dB) since this count was last set to 0
bwd_launches = 0
#: of those, the calls on the decode route (its two kernels) since this count was last set to 0
decode_launches = 0
#: transposed operands the wrapper made contiguous (on the routes that read one layout only) since this count was
#: last set to 0
copies = 0
#: gemm_fwd's own error codes (csrc/gemm.cu): no tensor-map encoder; a refused map (+ CUresult)
_NO_ENCODER, _TENSOR_MAP_ERROR = 9999, 10000

#: an operand's major: the dim of unit stride.  A [M, K] is K-major as it is stored for the forward, MN-major
#: as Aᵀ of a stored [K, M]; B [K, N] is MN-major as stored, K-major as Bᵀ of a stored [N, K].
K_MAJOR, MN_MAJOR = "K", "MN"

#: the deepest reduction that runs the wgmma kernel's short schedule (a persistent grid whose stores drain by TMA
#: under the next tile's products) rather than the long one (one block a tile, stores from registers).  At
#: phi3.5-moe's dB (K 320) the short schedule took 0.455 and 0.499 ms where the long one took 1.50 and 1.46; at the
#: K 4096-8192 products (the MoE forward, dA) it took 0.96-1.13x the long one's time (``scripts/gemm_probe.py``,
#: NVIDIA H100 80GB HBM3, 700 W).  K between was not measured.
SHORT_K = 1024

#: the kernels of ``csrc/gemm.cu``, indexed by the route code ``gemm_fwd`` takes.  The wgmma kernel's template
#: arguments are its cluster size (1 or 2, picked at launch), A's and B's majors as wgmma's transpose bits (0
#: K-major, 1 MN-major) and its schedule (0 a long reduction, 1 a short one: K <= SHORT_K), as the profiler names it.
KERNELS = (
    "gemm_fma_f32_kernel",  # fp32
    "gemm_decode_bf16_kernel<MT>",  # bf16, M <= 16, TMA rows: with gemm_decode_sum_kernel<MT> (decode_kernels)
    "gemm_mma_bf16_kernel<16, 128> masked",  # bf16, M <= 16, rows not 16-byte aligned
    "gemm_mma_bf16_kernel<64, 256> masked",  # bf16, M > 16, rows not 16-byte aligned
    # bf16, M > 16, TMA rows: A K-major, B MN-major (the forward); B K-major (dA = dC·Bᵀ); A MN-major (dB = Aᵀ·dC);
    # both transposed; each on the long schedule, then the short
    *(f"gemm_wgmma_bf16_kernel<C, {a}, {b}, {short}>" for a, b in ((0, 1), (0, 0), (1, 1), (1, 0)) for short in (0, 1)),
)
_WGMMA = {(K_MAJOR, MN_MAJOR): 4, (K_MAJOR, K_MAJOR): 6, (MN_MAJOR, MN_MAJOR): 8, (MN_MAJOR, K_MAJOR): 10}


#: the decode route's unit: a tile of this many columns by this many rows of K (``csrc/gemm.cu``'s DNT and DKS)
DECODE_TILE, DECODE_STEP = 256, 64


class Route(NamedTuple):
    """The kernel a product runs (index in :data:`KERNELS`) and whether the
    wrapper copies A or B to the layout that kernel reads first."""

    kernel: int
    copy_a: bool
    copy_b: bool


def route(dtype: torch.dtype, m: int, k: int, n: int, aligned: bool, a_major: str = K_MAJOR,
          b_major: str = MN_MAJOR) -> Route:
    """The kernel that computes a [m, k] · [k, n] product, by shape, type,
    the operands' majors and alignment alone.  ``aligned``: every row of a,
    b and the output starts 16-byte aligned (:func:`_aligned`).  bf16 rows
    the TMA can address need that and K, N multiples of 8; there M <= 16
    (decode) takes the decode kernels (route 1), and M > 16 the wgmma
    instantiation of the two majors, which reads both operands as they lie,
    on the short schedule where K <= :data:`SHORT_K`.  The fp32, decode and
    unaligned routes read A K-major and B MN-major only, so a transposed
    operand is copied first there, and only there."""
    if (a_major, b_major) not in _WGMMA:
        raise ValueError(f"majors {a_major}, {b_major}: want {K_MAJOR} or {MN_MAJOR} each")
    if dtype == torch.float32:
        kernel = 0
    elif dtype != torch.bfloat16:
        raise TypeError(f"gemm takes float32 or bfloat16, got {dtype}")
    elif not (aligned and k % 8 == 0 and n % 8 == 0):
        kernel = 2 if m <= 16 else 3
    elif m <= 16:
        kernel = 1
    else:
        return Route(_WGMMA[a_major, b_major] + (k <= SHORT_K), False, False)
    return Route(kernel, a_major != K_MAJOR, b_major != MN_MAJOR)


def decode_mt(m: int) -> int:
    """The decode kernels' row tile (wgmma's N) for M rows: 8 up to 8, else 16."""
    return 8 if m <= 8 else 16


def decode_kernels(m: int) -> tuple[str, str]:
    """The two kernels one decode call (route 1) launches at M rows, in
    launch order, as the profiler names them."""
    mt = decode_mt(m)
    return f"gemm_decode_bf16_kernel<{mt}>", f"gemm_decode_sum_kernel<{mt}>"


class DecodePlan(NamedTuple):
    """The decode route's split of E x [M, K] · [K, N]: ``units`` =
    E · ``ntiles`` · ``steps`` units (expert, 256-column tile, 64-row K
    step), in that order with the K step fastest, walked by ``blocks``
    blocks, block i taking units ``start(i)`` .. ``start(i + 1) - 1``."""

    ntiles: int
    steps: int
    units: int
    blocks: int

    def start(self, i: int) -> int:
        return i * self.units // self.blocks


class Piece(NamedTuple):
    """A block's run of units within one tile: expert ``e``, columns from
    ``n0``, K rows ``k0`` .. ``k1 - 1``; ``slot`` is None for a whole tile
    (stored by its block), else 0 (the block's first piece) or 1 (its last),
    where its fp32 partial waits for the sum."""

    block: int
    tile: int
    e: int
    n0: int
    k0: int
    k1: int
    slot: int | None


def decode_plan(e: int, n: int, k: int, sms: int) -> DecodePlan:
    """The split the decode kernel runs for E = ``e`` experts of [K, N]
    weights on a card of ``sms`` SMs: one block an SM, fewer where there are
    fewer units, the SMs' shares within one unit of each other."""
    ntiles, steps = -(-n // DECODE_TILE), -(-k // DECODE_STEP)
    units = e * ntiles * steps
    return DecodePlan(ntiles, steps, units, max(1, min(sms, units)))


def decode_pieces(plan: DecodePlan, k: int) -> list[Piece]:
    """Every piece of ``plan`` in block order (within a block in K order),
    as the kernel walks them; ``k`` cuts the last step's rows."""
    out = []
    for i in range(plan.blocks):
        u0, u1 = plan.start(i), plan.start(i + 1)
        u = u0
        while u < u1:
            tile = u // plan.steps
            lo, hi = tile * plan.steps, (tile + 1) * plan.steps
            end = min(u1, hi)
            whole = u == lo and u1 >= hi
            out.append(Piece(i, tile, tile // plan.ntiles, tile % plan.ntiles * DECODE_TILE,
                             (u - lo) * DECODE_STEP, min((end - lo) * DECODE_STEP, k),
                             None if whole else 0 if u == u0 else 1))
            u = end
    return out


def gemm_decode_plain(a: torch.Tensor, b: torch.Tensor, sms: int) -> torch.Tensor:
    """The decode route's function composed in PyTorch: a [E, M, K] ·
    b [E, K, N] -> [E, M, N] in ``a.dtype``, each piece of
    :func:`decode_plan`'s split an fp32 product over its K rows, the pieces
    of a tile summed in fp32 in block order (from 0, as the sum kernel
    adds), each tile rounded once."""
    _check_shapes(a, b)
    E, M, K = a.shape
    N = b.shape[2]
    plan = decode_plan(E, N, K, sms)
    out = torch.zeros((E, M, N), dtype=torch.float32, device=a.device)
    af, bf = a.float(), b.float()
    sums: dict[int, torch.Tensor] = {}
    for pc in decode_pieces(plan, K):
        n1 = min(pc.n0 + DECODE_TILE, N)
        part = af[pc.e, :, pc.k0:pc.k1] @ bf[pc.e, pc.k0:pc.k1, pc.n0:n1]
        if pc.slot is None:
            out[pc.e, :, pc.n0:n1] = part
        else:
            sums[pc.tile] = sums.get(pc.tile, torch.zeros_like(part)) + part
    for tile, total in sums.items():
        e, n0 = tile // plan.ntiles, tile % plan.ntiles * DECODE_TILE
        out[e, :, n0:n0 + total.shape[1]] = total
    return out.to(a.dtype)


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


def _unit_dim(t: torch.Tensor) -> int | None:
    """Which of the last two dims has unit stride (-1 first; a dim of one
    element counts as unit), or None."""
    for dim in (-1, -2):
        if t.stride(dim) == 1 or t.shape[dim] == 1:
            return dim
    return None


def majors(a: torch.Tensor, b: torch.Tensor) -> tuple[str, str]:
    """(A's major, B's major) of a [(E,) M, K] · [(E,) K, N] product; raises
    where an operand has unit stride over neither of its last two dims."""
    ua, ub = _unit_dim(a), _unit_dim(b)
    if ua is None or ub is None:
        raise ValueError(f"gemm needs unit stride over one of the last two dims of a and of b; got strides "
                         f"{a.stride()}, {b.stride()}")
    return (K_MAJOR if ua == -1 else MN_MAJOR), (MN_MAJOR if ub == -1 else K_MAJOR)


def _aligned(t: torch.Tensor) -> bool:
    """Every row starts 16-byte aligned (bf16: every stride but the unit
    one, over a dim of more than one element, a multiple of 8 elements)."""
    unit = t.dim() + (_unit_dim(t) or -1)
    return t.data_ptr() % 16 == 0 and all(
        st % 8 == 0 for d, (st, size) in enumerate(zip(t.stride(), t.shape)) if d != unit and size > 1)


def gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A·B on the CUDA kernel.  a: [M, K] and b: [K, N], or a: [E, M, K]
    and b: [E, K, N] (one launch for the whole batch); float32 or bfloat16
    alike, on the current CUDA device, unit stride over either of the last
    two dims of each (other strides free) -> [(E,) M, N] contiguous in
    ``a.dtype``.  A transposed view is read in place on the wgmma routes
    and copied first on the others (:func:`route`).

    Launches on the current stream without synchronising; raises if the
    inputs are not what the kernel takes or the launch is refused.
    """
    global launches, copies, decode_launches
    if not (a.is_cuda and b.is_cuda):
        raise ValueError(f"gemm needs CUDA tensors, got {a.device}, {b.device}")
    if a.device != b.device or a.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {a.device}/{b.device}, current device cuda:{torch.cuda.current_device()}")
    if a.dtype not in (torch.float32, torch.bfloat16) or b.dtype != a.dtype:
        raise TypeError(f"gemm takes float32 or bfloat16 alike, got {a.dtype}, {b.dtype}")
    _check_shapes(a, b)
    a_major, b_major = majors(a, b)
    batched = a.dim() == 3
    a3, b3 = (a, b) if batched else (a[None], b[None])
    E, M, K = a3.shape
    N = b3.shape[2]
    if min(E, M, N, K) == 0:
        raise ValueError(f"empty gemm: a {tuple(a.shape)}, b {tuple(b.shape)}")
    if E > 65535 or -(-M // 16) > 65535:
        raise ValueError(f"gemm too large for the kernel's grid: a {tuple(a.shape)}, b {tuple(b.shape)}")
    kernel, copy_a, copy_b = route(a.dtype, M, K, N, _aligned(a3) and _aligned(b3), a_major, b_major)
    if copy_a:
        a3 = a3.contiguous()
    if copy_b:
        b3 = b3.contiguous()
    copies += copy_a + copy_b
    c = torch.empty((E, M, N), dtype=a.dtype, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    if kernel == 1:
        plan = decode_plan(E, N, K, _sm_count(a.device.index))
        ws = torch.empty(plan.blocks * 2 * (DECODE_TILE // 64) * 128 * decode_mt(M) // 2, dtype=torch.float32,
                         device=a.device)
        sab, sam, _ = a3.stride()
        sbb, sbk, _ = b3.stride()
        err = _decode_kernel()(a3.data_ptr(), b3.data_ptr(), c.data_ptr(), ws.data_ptr(), plan.blocks, E, M, N, K,
                               sab, sam, sbb, sbk, c.stride(0), c.stride(1), stream)
    else:
        err = _kernel()(a3.data_ptr(), b3.data_ptr(), c.data_ptr(), kernel, E, M, N, K, *a3.stride(), *b3.stride(),
                        c.stride(0), c.stride(1), stream)
    if err >= _TENSOR_MAP_ERROR:
        raise RuntimeError(f"gemm: {KERNELS[kernel]}: the driver refused a tensor map (CUresult {err - _TENSOR_MAP_ERROR})")
    if err == _NO_ENCODER:
        raise RuntimeError(f"gemm: {KERNELS[kernel]}: no cuTensorMapEncodeTiled in the loaded CUDA driver")
    if err != 0:
        raise RuntimeError(f"gemm: {KERNELS[kernel]} launch failed: cudaError {err}")
    launches += 1
    decode_launches += kernel == 1
    return c if batched else c[0]


@functools.cache
def _kernel():
    from .build import library

    fn = library("gemm").gemm_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _decode_kernel():
    """The C entry ``gemm_decode``, typed."""
    from .build import library

    fn = library("gemm").gemm_decode
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_occupancy(mt: int) -> int:
    """Blocks of ``gemm_decode_bf16_kernel<mt>`` one SM of the current card holds at once."""
    from .build import library

    fn = library("gemm").gemm_decode_occupancy
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    got = fn(mt)
    if got < 0:
        raise RuntimeError(f"gemm_decode_bf16_kernel<{mt}> occupancy: cudaError {-got}")
    return got


# ---------------------------------------------------------------------------
# Work and traffic of one call (the bounds of chip_smoke.py, the dry run's counts)
# ---------------------------------------------------------------------------


def cost(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """FLOPs and bytes of C = A·B: 2·M·K·N a batch entry; A, B and C once."""
    *batch, m, k = a.shape
    n = b.shape[-1]
    e = 1
    for x in batch:
        e *= x
    return 2.0 * e * m * k * n, float(a.element_size() * (a.numel() + b.numel() + e * m * n))


def bwd_cost(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """FLOPs and bytes of the backward, dA = dC·Bᵀ and dB = Aᵀ·dC: twice the
    forward's products; dC, A, B, dA and dB once."""
    *batch, m, k = a.shape
    n = b.shape[-1]
    e = 1
    for x in batch:
        e *= x
    return 2 * 2.0 * e * m * k * n, float(a.element_size() * (e * m * n + 2 * a.numel() + 2 * b.numel()))
