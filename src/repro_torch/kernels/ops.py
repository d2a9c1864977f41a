"""Public kernel entry points: the device of the input picks the path.

A CUDA tensor goes to the hand-written kernel, which launches or raises; a
CPU tensor, which only a caller that asked for the CPU holds, goes to the
plain PyTorch version, under ordinary autograd.  There is no fallback from
one to the other.

What trains where.  The kernels fill tensors through ``ctypes`` and carry
no ``grad_fn``, so on a CUDA tensor under grad mode with an input that
requires grad:
- ``flash_attention`` runs through an autograd Function whose forward is
  the kernel with its log-sum-exp (with ``fp32_scores=False``, the
  bf16-score kernels with their (m, l) stats) and whose backward is the
  hand-written backward kernel (``flash_attention_bwd``);
- ``gemm`` runs through an autograd Function whose backward is two more
  ``gemm`` calls, dA = dC·Bᵀ and dB = Aᵀ·dC, on the transposed views as
  they lie (bf16: the wgmma instantiations that read B K-major and A
  MN-major; the routes that read one layout only copy them, ``gemm.route``);
- ``ssd_scan`` runs through an autograd Function whose forward is the scan
  kernel and whose backward is the hand-written backward kernel
  (``ssd_scan_bwd``), with no gradient of the final state where it is
  unused; inside :func:`keeping_scan_states` (a checkpointed layer) the
  forward keeps the chunk states its ``wgmma`` route wrote, and the
  backward reads them instead of rebuilding them;
- ``conv2d_im2col`` raises ``NotImplementedError``: the reference trains no
  CNN, so its backward kernel is not written, and a kernel output with no
  ``grad_fn`` must never reach a loss.
Without grad mode (serving, ``torch.inference_mode``) each is the plain
kernel call.  On the CPU, ``flash_attention(fp32_scores=False)`` under
grad runs an autograd Function too, over the plain forward and its
explicit backward (``flash_attention_bwd_plain``), which follows
``jax.grad`` of the reference's bf16 softmax op by op where torch's
autograd of the plain ops would round other intermediates.

A ``meta`` tensor (``launch/dryrun.py``) computes nothing: each entry point
returns outputs of the right shape and dtype (flash's log-sum-exp and the
scan's final state among them, kept for the backward as the kernels keep
them) and, while :func:`count_meta` is open, adds the call's FLOPs and bytes
by the kernel modules' ``cost`` / ``bwd_cost`` formulas, the ones
``chip_smoke.py``'s bounds use, forward and backward alike.
"""

from __future__ import annotations

import contextlib
import functools

import torch

from . import flash_attention as _fa
from . import gemm as _gemm
from . import im2col_conv
from . import ssd_scan as _ssd
from ..pipeline.hetero import H100_HBM_BW

_META: dict | None = None


def bound(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    """(ms, what bounds it): the larger of ``flops`` at ``peak`` FLOP/s and
    ``nbytes`` at the H100's HBM rate."""
    t_ops, t_bytes = flops / peak, nbytes / H100_HBM_BW
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


@contextlib.contextmanager
def count_meta():
    """While open, each kernel call on ``meta`` tensors adds to the yielded
    ``{kernel: {"calls", "flops", "bytes"}}`` (``"<kernel>_bwd"`` for a
    backward)."""
    global _META
    old, _META = _META, {}
    try:
        yield _META
    finally:
        _META = old


def _note(name: str, cost: tuple[float, float]) -> None:
    if _META is not None:
        row = _META.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        row["calls"] += 1
        row["flops"] += cost[0]
        row["bytes"] += cost[1]


class _MetaGemm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        _note("gemm", _gemm.cost(a, b))
        return a.new_empty((*a.shape[:-1], b.shape[-1]))

    @staticmethod
    def backward(ctx, dc):
        a, b = ctx.saved_tensors
        _note("gemm_bwd", _gemm.bwd_cost(a, b))
        return torch.empty_like(a), torch.empty_like(b)


class _MetaFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, fp32_scores):
        _note("flash_attention", _fa.cost(q, k, v, causal, window))
        o = torch.empty_like(q)
        lse = q.new_empty(q.shape[:-1] if fp32_scores else (2, *q.shape[:-1]), dtype=torch.float32)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, _, _ = ctx.saved_tensors
        _note("flash_attention_bwd", _fa.bwd_cost(q, k, ctx.causal, ctx.window))
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v), None, None, None


class _MetaSsd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        _note("ssd_scan", _ssd.cost(x, B, chunk))
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        b, _, h, p = x.shape
        return torch.empty_like(x, memory_format=torch.contiguous_format), \
            x.new_empty((b, h, p, B.shape[-1]), dtype=torch.float32)

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, B, C = ctx.saved_tensors
        _note("ssd_scan_bwd", _ssd.bwd_cost(x, B, ctx.chunk, dstate is not None))
        return (torch.empty_like(x), torch.empty_like(dt), torch.empty_like(A), torch.empty_like(B),
                torch.empty_like(C), None)


def _wants_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


class _Gemm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _gemm.gemm(a, b)

    @staticmethod
    def backward(ctx, dc):
        a, b = ctx.saved_tensors
        if _gemm._unit_dim(dc) is None:  # e.g. an expanded gradient: the kernels read rows or columns
            dc = dc.contiguous()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _gemm.gemm(dc, b.transpose(-1, -2))
            _gemm.bwd_launches += 1
        if ctx.needs_input_grad[1]:
            db = _gemm.gemm(a.transpose(-1, -2), dc)
            _gemm.bwd_launches += 1
        return da, db


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, fp32_scores):
        o, lse = _fa.flash_attention(q, k, v, causal=causal, window=window, return_lse=True, fp32_scores=fp32_scores)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window, ctx.fp32_scores = causal, window, fp32_scores
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if _fa._vector_strides(do) is None:  # e.g. an expanded gradient: the kernel reads rows
            do = do.contiguous()
        dq, dk, dv = _fa.flash_attention_bwd(q, k, v, o, lse, do, causal=ctx.causal, window=ctx.window,
                                             fp32_scores=ctx.fp32_scores)
        return dq, dk, dv, None, None, None


class _FlashAttentionBf16ScoresPlain(torch.autograd.Function):
    """The bf16-score mode on CPU tensors: the plain forward, and the plain
    backward's explicit formulas (``jax.grad``'s of the reference)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, stats = _fa.flash_attention_fwd_plain(q, k, v, causal=causal, window=window, fp32_scores=False)
        ctx.save_for_backward(q, k, v, o, stats)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, stats = ctx.saved_tensors
        dq, dk, dv = _fa.flash_attention_bwd_plain(q, k, v, o, stats, do, causal=ctx.causal, window=ctx.window,
                                                   fp32_scores=False)
        return dq, dk, dv, None, None


#: layers running under :func:`keeping_scan_states`
_KEEP_STATES = 0


def keeping_scan_states(fn):
    """``fn`` wrapped so that the SSD scans it runs on the card keep the
    states their forward's ``wgmma`` route wrote (H_in,
    ``ssd_scan.ssd_scan_states``) for their backward, which then reads them
    instead of rebuilding them.  Meant for a layer under
    ``torch.utils.checkpoint``, whose forward runs again just before its
    backward: the states live for one layer.  Kept in a plain forward they
    would stay alive at every layer until the backward reached it, 4·p·n /
    chunk bytes per (batch, position, head) (mamba2-130m: 25 MB a layer).
    The wrapper runs at the checkpoint's first forward and at its
    recomputation alike, so both save the same tensors."""

    @functools.wraps(fn)
    def run(*args, **kwargs):
        global _KEEP_STATES
        _KEEP_STATES += 1
        try:
            return fn(*args, **kwargs)
        finally:
            _KEEP_STATES -= 1

    return run


class _SsdScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        h_in = None
        if _KEEP_STATES:
            y, state, h_in = _ssd.ssd_scan_states(x, dt, A, B, C, chunk=chunk)
        else:
            y, state = _ssd.ssd_scan(x, dt, A, B, C, chunk=chunk)
        ctx.save_for_backward(x, dt, A, B, C, h_in)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)  # an unused final state's gradient stays None
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, B, C, h_in = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x, memory_format=torch.contiguous_format)
        elif dy.stride(-1) != 1:
            dy = dy.contiguous()
        if dstate is not None:
            dstate = dstate.contiguous()
        carried = {} if h_in is None else {"h_in": h_in}  # the forward's states, read instead of rebuilt
        dx, ddt, dA, dB, dC = _ssd.ssd_scan_bwd(x, dt, A, B, C, dy, dstate, chunk=ctx.chunk, **carried)
        return dx, ddt, dA, dB, dC, None


def gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A·B, fp32 sum, output in a's type. a: [(E,) M, K]; b: [(E,) K, N] -> [(E,) M, N]."""
    if a.is_cuda:
        return _Gemm.apply(a, b) if _wants_grad(a, b) else _gemm.gemm(a, b)
    if a.device.type == "cpu":
        return _gemm.gemm_plain(a, b)
    if a.device.type == "meta":
        return _MetaGemm.apply(a, b)
    raise ValueError(f"no gemm for device {a.device}")


def conv2d_im2col(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1) -> torch.Tensor:
    """SAME-padded conv. x: [N, H, W, C]; w: [R, S, C, K] -> [N, HO, WO, K]."""
    if x.is_cuda:
        if _wants_grad(x, w):
            raise NotImplementedError(
                "conv2d_im2col has no backward kernel (the reference trains no CNN): under autograd on the card "
                "it would drop every gradient upstream of it; run it on the CPU, or under torch.no_grad()"
            )
        return im2col_conv.conv2d_im2col(x, w, stride=stride)
    if x.device.type == "cpu":
        return im2col_conv.conv2d_im2col_plain(x, w, stride=stride)
    if x.device.type == "meta":
        _note("conv2d_im2col", im2col_conv.cost(x, w, stride))
        ho, wo = im2col_conv.same_padding(x.shape[1], x.shape[2], w.shape[0], w.shape[1], stride)[:2]
        return x.new_empty((x.shape[0], ho, wo, w.shape[-1]))
    raise ValueError(f"no conv2d_im2col for device {x.device}")


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True, window: int = 0,
    fp32_scores: bool = True,
) -> torch.Tensor:
    """Attention. q: [B, H, Sq, D]; k, v: [B, KVH, Skv, D] -> [B, H, Sq, D]
    (the causal mask top-left: key j visible to query i when j <= i).
    ``fp32_scores=False``: the reference's ``attn_fp32_scores=False``, bf16
    scores and a bf16 softmax."""
    if q.is_cuda:
        if _wants_grad(q, k, v):
            return _FlashAttention.apply(q, k, v, causal, window, fp32_scores)
        return _fa.flash_attention(q, k, v, causal=causal, window=window, fp32_scores=fp32_scores)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window, fp32_scores=fp32_scores)
    if q.device.type == "meta":
        return _MetaFlash.apply(q, k, v, causal, window, fp32_scores)
    raise ValueError(f"no flash_attention for device {q.device}")


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True, window: int = 0,
    fp32_scores: bool = True,
) -> torch.Tensor:
    """The plain version of :func:`flash_attention` on any device (the CPU
    path; ``chip_smoke.py``'s plain path on the card): in the bf16-score
    mode under autograd, an autograd Function whose backward is the explicit
    ``flash_attention_bwd_plain``; otherwise ``flash_attention_plain``."""
    if not fp32_scores and _wants_grad(q, k, v):
        return _FlashAttentionBf16ScoresPlain.apply(q, k, v, causal, window)
    return _fa.flash_attention_plain(q, k, v, causal=causal, window=window, fp32_scores=fp32_scores)


def ssd_scan(x, dt, A, B, C, *, chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD. x: [b, l, h, p]; dt: [b, l, h]; A: [h]; B, C: [b, l, n]
    -> (y [b, l, h, p], final state [b, h, p, n] fp32)."""
    if x.is_cuda:
        if _wants_grad(x, dt, A, B, C):
            return _SsdScan.apply(x, dt, A, B, C, chunk)
        return _ssd.ssd_scan(x, dt, A, B, C, chunk=chunk)
    if x.device.type == "cpu":
        return _ssd.ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
    if x.device.type == "meta":
        return _MetaSsd.apply(x, dt, A, B, C, chunk)
    raise ValueError(f"no ssd_scan for device {x.device}")
