"""Im2Col + GEMM convolution: the CUDA kernel's wrapper, its plan and its plain version.

Replaces ``repro/kernels/im2col_conv.py::conv2d_im2col`` (Pallas
``_conv_kernel``), the GEMM-based conv operator the paper simulates (§6).
The kernel, ``csrc/conv2d_im2col.cu``, is an implicit GEMM over
``M = N·HO·WO`` output pixels, ``K`` output channels and an ``R·S·C``
reduction, in full fp32 on the FMA pipes.  It is bound by operations at the
shapes of the paper's CNNs.  :func:`plan` picks, from the shape and the SM
count alone, the output tile of each block, the copy width and how many
contiguous ranges the reduction is split into; a split's partials are
summed by a second kernel in a fixed order, so a shape always gives the
same bits (see the source note).

:func:`conv2d_im2col_plain` computes the same function in PyTorch with the
Pallas kernel's arithmetic (a sum of R·S shifted ``[HO·WO, C] × [C, K]``
products); the CPU path and the on-card checks use it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

#: calls that launched the CUDA kernels since this count was last set to 0
#: (one per call, whether or not the call also ran the split sum)
launches = 0

_INT32_MAX = 2**31 - 1

#: reduction terms per slice, one stage of the kernel's copy ring
BK = 16
#: the output tiles ``csrc/conv2d_im2col.cu`` compiles, (rows, columns), 256 threads each
TILES = ((128, 128), (128, 96), (128, 64), (64, 128), (64, 96), (64, 64))
#: most contiguous ranges the reduction is split into, and fewest slices a range walks
MAX_SPLITS, MIN_SLICES = 16, 4
#: SMs of the H100 SXM
H100_SMS = 132
#: one SM's fp32 FMA peak, per ns (67 TFLOP/s over 132 SMs)
_SM_FMA_PER_NS = 67e12 / 2 / 132 / 1e9
#: share of that peak one SM reaches with each tile, with 16-byte and with
#: 4-byte copies, whether one block or several of the tile share the SM:
#: fitted to ``scripts/conv_probe.py``'s device times at SynthNet's shapes on
#: an H100 (see PERF.md)
RATE = {
    (128, 128): (0.646, 0.500), (128, 96): (0.618, 0.483), (128, 64): (0.576, 0.423),
    (64, 128): (0.550, 0.420), (64, 96): (0.519, 0.377), (64, 64): (0.496, 0.355),
}
#: a split's own cost in the same fit: the second kernel's ns, and the partials' bytes per ns
SPLIT_NS, SPLIT_BYTES_PER_NS = 5000.0, 5000.0


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """How the kernel computes one conv shape: each block's ``bm × bn``
    output tile (a ``tm × tn`` sub-tile a thread), 16-byte copies or 4-byte
    ones, and the reduction split into ``splits`` contiguous ranges of whole
    slices."""

    bm: int
    bn: int
    splits: int
    vector: bool  # C and K multiples of 4: 16-byte copies where x and w are 16-byte aligned
    m: int  # GEMM rows, N·HO·WO
    k: int  # output channels
    kr: int  # reduction length, R·S·C

    @property
    def tm(self) -> int:
        return self.bm // 16

    @property
    def tn(self) -> int:
        return self.bn // 16

    @property
    def slices(self) -> int:
        return -(-self.kr // BK)

    @property
    def grid(self) -> tuple[int, int, int]:
        return -(-self.m // self.bm), -(-self.k // self.bn), self.splits

    @property
    def blocks(self) -> int:
        gx, gy, gz = self.grid
        return gx * gy * gz

    def split_range(self, z: int) -> tuple[int, int]:
        """Reduction terms ``[lo, hi)`` of split ``z`` (the kernel's
        ``t_begin`` arithmetic, in slices of :data:`BK`)."""
        lo = z * self.slices // self.splits * BK
        return min(lo, self.kr), min((z + 1) * self.slices // self.splits * BK, self.kr)

    @property
    def workspace_shape(self) -> tuple[int, int, int] | None:
        """Shape of the fp32 partials, or None with one split (the kernel writes y)."""
        return (self.splits, self.m, self.k) if self.splits > 1 else None


def modelled_ns(m: int, k: int, kr: int, bm: int, bn: int, splits: int, vector: bool, sms: int) -> float:
    """Modelled time of one plan: the busiest SM's blocks, one after the
    other, each walking the longest split with padding included, at
    :data:`RATE`; plus the split sum."""
    blocks = -(-m // bm) * -(-k // bn) * splits
    slices = -(-kr // BK)
    work = bm * bn * BK * -(-slices // splits)
    ns = -(-blocks // sms) * work / (_SM_FMA_PER_NS * RATE[(bm, bn)][0 if vector else 1])
    if splits > 1:
        ns += SPLIT_NS + (splits + 1) * m * k * 4 / SPLIT_BYTES_PER_NS
    return ns


@functools.lru_cache(maxsize=1024)
def plan(x_shape: tuple[int, ...], w_shape: tuple[int, ...], stride: int, sms: int = H100_SMS) -> ConvPlan:
    """The plan for x ``[N, H, W, C]`` * w ``[R, S, C, K]`` at ``stride`` on
    a card of ``sms`` SMs: a pure function of these, so a shape always runs
    the same kernels in the same order.  Of the tiles in :data:`TILES` and
    1 .. :data:`MAX_SPLITS` splits (each at least :data:`MIN_SLICES` slices,
    the partials under 2**31 elements), the plans that launch a block on
    every SM come first, then the least :func:`modelled_ns`, then the
    earlier tile and the fewer splits.  Cached: the search takes the host
    longer than the kernels take the card at the small layers."""
    n, h, wd, c = x_shape
    r, s, c2, k = w_shape
    if c != c2:
        raise ValueError(f"channel mismatch: x {tuple(x_shape)}, w {tuple(w_shape)}")
    ho, wo = -(-h // stride), -(-wd // stride)
    m, kr = n * ho * wo, r * s * c
    slices = -(-kr // BK)
    vector = c % 4 == 0 and k % 4 == 0
    best = None
    for ti, (bm, bn) in enumerate(TILES):
        for splits in range(1, MAX_SPLITS + 1):
            if splits > 1 and (slices // splits < MIN_SLICES or splits * m * k > _INT32_MAX):
                break
            blocks = -(-m // bm) * -(-k // bn) * splits
            key = (blocks < sms, modelled_ns(m, k, kr, bm, bn, splits, vector, sms), ti, splits)
            if best is None or key < best[0]:
                best = (key, bm, bn, splits)
    _, bm, bn, splits = best
    return ConvPlan(bm, bn, splits, vector, m, k, kr)


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
    """SAME-padded conv on the CUDA kernels. x: [N, H, W, C] fp32 contiguous
    on the current CUDA device; w: [R, S, C, K] likewise -> [N, HO, WO, K].

    Runs :func:`plan`'s kernels on the current stream without
    synchronising; raises if the inputs are not what the kernel takes or a
    launch is refused.
    """
    _check(x, w, stride)
    return _launch(x, w, *_geometry(tuple(x.shape), tuple(w.shape), stride, x.device.index))


def run_plan(x: torch.Tensor, w: torch.Tensor, stride: int, p: ConvPlan, *, vector: bool = True) -> torch.Tensor:
    """Run the kernels as ``p`` says, which need not be :func:`plan`'s (the
    inputs checked as :func:`conv2d_im2col` checks them).  The 16-byte
    copies run where the plan allows them, ``vector`` is true, and x and w
    are 16-byte aligned; otherwise the 4-byte copies fill the same tiles,
    with the same bits."""
    _check(x, w, stride)
    own, _ = _geometry(tuple(x.shape), tuple(w.shape), stride, x.device.index)
    if (p.m, p.k, p.kr, p.vector) != (own.m, own.k, own.kr, own.vector):
        raise ValueError(f"plan {p} is not for x {tuple(x.shape)}, w {tuple(w.shape)}, stride {stride}")
    if (p.bm, p.bn) not in TILES or not 1 <= p.splits <= min(MAX_SPLITS, p.slices):
        raise ValueError(f"no kernel for plan {p}")
    if p.splits * p.m * p.k > _INT32_MAX:
        raise ValueError(f"plan {p}: partials above 2**31 elements")
    return _launch(x, w, p, _arguments(p, tuple(x.shape), tuple(w.shape), stride), vector)


def _check(x: torch.Tensor, w: torch.Tensor, stride: int) -> None:
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


@functools.lru_cache(maxsize=1024)
def _geometry(x_shape: tuple[int, ...], w_shape: tuple[int, ...], stride: int, index: int) -> tuple[ConvPlan, tuple]:
    """The plan of a checked shape on device ``index`` and its
    :func:`_arguments`."""
    if min(*x_shape, *w_shape) == 0:
        raise ValueError(f"empty conv: x {x_shape}, w {w_shape}")
    n, h, wd, c = x_shape
    r, s, _, k = w_shape
    ho, wo = -(-h // stride), -(-wd // stride)
    if max(n * h * wd * c, r * s * c * k, n * ho * wo * k) > _INT32_MAX:
        raise ValueError("conv2d_im2col indexes with int32; tensors above 2**31 elements are not supported")
    p = plan(x_shape, w_shape, stride, sms=_sm_count(index))
    return p, _arguments(p, x_shape, w_shape, stride)


def _arguments(p: ConvPlan, x_shape: tuple[int, ...], w_shape: tuple[int, ...], stride: int) -> tuple:
    """The kernel's 16 int arguments (shape, then plan) as C arrays, with
    4-byte copies and with 16-byte copies where the plan allows them."""
    n, h, wd, c = x_shape
    r, s, _, k = w_shape
    ho, wo, pt, _, pl, _ = same_padding(h, wd, r, s, stride)
    shape = (n, h, wd, c, r, s, k, stride, ho, wo, pt, pl, p.bm, p.bn)
    ints = ctypes.c_int * 16
    return ints(*shape, 0, p.splits), ints(*shape, int(p.vector), p.splits), (n, ho, wo, k)


def _launch(x: torch.Tensor, w: torch.Tensor, p: ConvPlan, args: tuple, vector: bool = True) -> torch.Tensor:
    global launches
    vec = vector and p.vector and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    y = torch.empty(args[2], dtype=torch.float32, device=x.device)
    # per call, on the caller's stream: concurrent stages never share
    # partials.  Freed on return, the block goes back to the caching
    # allocator's pool for this stream, so only work queued after these
    # kernels on this stream can be handed it.
    ws = None if p.splits == 1 else torch.empty(p.workspace_shape, dtype=torch.float32, device=x.device)
    # the current stream's handle as PyTorch's generated kernels take it,
    # without building a torch.cuda.Stream: at the small layers the host's
    # time to issue a call exceeds the card's
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    err = _kernel()(x.data_ptr(), w.data_ptr(), y.data_ptr(), 0 if ws is None else ws.data_ptr(), args[vec], stream)
    if err != 0:
        raise RuntimeError(f"conv2d_im2col launch failed ({p}): cudaError {err}")
    launches += 1
    return y


def occupancy(bm: int, bn: int, vector: bool) -> int:
    """Blocks of the tile's kernel one SM of the current card holds at once."""
    fn = library().conv2d_im2col_occupancy
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    got = fn(bm, bn, int(vector))
    if got < 0:
        raise RuntimeError(f"conv2d_im2col occupancy of {bm}x{bn}: cudaError {-got}")
    return got


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def library() -> ctypes.CDLL:
    from .build import library as load

    return load("conv2d_im2col")


@functools.cache
def _kernel():
    fn = library().conv2d_im2col_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# ---------------------------------------------------------------------------
# Work and traffic of one call (the bounds of chip_smoke.py, the dry run's counts)
# ---------------------------------------------------------------------------


def cost(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> tuple[float, float]:
    """FLOPs and bytes of one SAME conv: 2·N·HO·WO·K·R·S·C; x, w and the
    output once."""
    n, h, wd, c = x.shape
    r, s, _, k = w.shape
    ho, wo = same_padding(h, wd, r, s, stride)[:2]
    return 2.0 * n * ho * wo * k * r * s * c, float(x.element_size() * (x.numel() + w.numel() + n * ho * wo * k))
