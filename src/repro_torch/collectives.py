"""Collectives over the named axes of a mesh of ranks, and the autograd
functions of the sharded layout.

Below both ``models/`` and ``launch/`` (it imports only
:mod:`repro_torch.sharding`): the collectives the mesh paths run, each over
the named axes of a ``DeviceMesh`` (:func:`all_reduce_over`,
:func:`all_gather_dim`, :func:`reduce_scatter_dim`, :func:`gather_whole`),
and the autograd functions of the sharded layout: Megatron's pair for a
tensor-parallel region, :func:`enter_tp` (identity forward, sum backward)
and :func:`sum_tp` (sum forward, identity backward), :func:`psum_tp` (sum
both ways: a total every rank reads for a different block of its work,
such as the SSD gated norm's mean square over the ranks' heads),
:func:`mean_over` for a mean over the data axes whose backward gives each
rank its own share, and the FSDP pair :func:`gather_param` (all-gather
forward; reduce-scatter, slice or sum backward), which :func:`gather_act`
and :func:`gather_heads` use for activations.

The sequence-parallel residual stream (``models/layout.py``: each rank of
the tensor-parallel axis holds its block of the sequence between
sublayers) has four crossings, one pair for a tensor-parallel sublayer and
one for a sublayer every rank computes whole:

* :func:`sp_gather` (all-gather forward, reduce-scatter backward) and
  :func:`sp_scatter` (reduce-scatter forward, all-gather backward):
  Megatron's sequence-parallel pair, in place of :func:`enter_tp` and
  :func:`sum_tp` around a tensor-parallel product whose ranks' gradients
  are partial;
* :func:`gather_act` (all-gather forward, slice backward) and
  :func:`split_act` (the rank's block forward, all-gather backward): around
  a computation every rank repeats on the whole sequence, whose gradient
  is then the same on every rank.

Every collective issued here is recorded while :func:`count_collectives` is
open, with its ring wire bytes (:func:`wire_bytes`).  A gather's or a
reduce-scatter's result is allocated by :data:`new_result`;
``launch.mesh.join_fake_group`` sets it to ``torch.zeros``, since the ranks
of a fake group write nothing into it.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Sequence

import torch
import torch.distributed as dist

from .sharding import axes_of, axis_size, map2

_RECORD: list | None = None

#: allocates the result of an all-gather or a reduce-scatter
new_result = torch.empty


def wire_bytes(op: str, nbytes: float, group: int) -> float:
    """Ring wire bytes a device sends for one collective whose per-device
    result is ``nbytes`` over ``group`` ranks (the reference dry run's
    formulas): all-gather and all-to-all ``(g-1)/g`` of the result,
    all-reduce twice that, reduce-scatter ``g-1`` times its scattered
    result, a permute the result once."""
    g = max(group, 1)
    if op in ("all-gather", "all-to-all"):
        return nbytes * (group - 1) / g
    if op == "all-reduce":
        return 2 * nbytes * (group - 1) / g
    if op == "reduce-scatter":
        return nbytes * (group - 1)
    return nbytes


@contextlib.contextmanager
def count_collectives():
    """Record every collective this module issues while open: yields a list
    that fills with ``{"op", "bytes", "group", "axis", "wire_bytes"}``,
    ``bytes`` the per-device result, as the reference parses them from its
    HLO, ``axis`` the mesh axis the group runs along."""
    global _RECORD
    old, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = old


def _record(op: str, t: torch.Tensor, group: int, axis: str) -> None:
    if _RECORD is not None:
        nbytes = t.numel() * t.element_size()
        _RECORD.append({"op": op, "bytes": nbytes, "group": group, "axis": axis,
                        "wire_bytes": wire_bytes(op, nbytes, group)})


def all_gather_dim(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The ranks' ``t`` of ``axis`` joined along ``dim`` in rank order (a new
    tensor); ``t`` itself on a one-rank axis."""
    n = axis_size(mesh, axis)
    if n == 1:
        return t
    out = new_result((n * t.numel(),), dtype=t.dtype, device=t.device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, t.contiguous().view(-1), group=mesh.get_group(axis))
    _record("all-gather", out, n, axis)
    out = out.view(n, *t.shape)
    return out.movedim(0, dim).flatten(dim, dim + 1) if dim else out.flatten(0, 1)


def reduce_scatter_dim(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The sum of the ranks' ``t`` over ``axis``, this rank's block along
    ``dim``; ``t`` itself on a one-rank axis."""
    n = axis_size(mesh, axis)
    if n == 1:
        return t
    parts = t.unflatten(dim, (n, t.shape[dim] // n)).movedim(dim, 0).contiguous()
    out = new_result(parts.shape[1:], dtype=t.dtype, device=t.device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out.view(-1), parts.view(-1), group=mesh.get_group(axis))
    _record("reduce-scatter", out, n, axis)
    return out


def own_block(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` over ``axis`` (a view)."""
    n = axis_size(mesh, axis)
    size = t.shape[dim] // n
    return t.narrow(dim, mesh.get_local_rank(axis) * size, size)


def all_reduce_over(t: torch.Tensor, mesh, axes: Sequence[str],
                    op: dist.ReduceOp.RedOpType = dist.ReduceOp.SUM) -> torch.Tensor:
    """A copy of ``t`` reduced with ``op`` (SUM or MAX) over the ranks of
    ``axes``, one axis after another; every rank gets the same result."""
    out = t.clone()
    for a in axes:
        n = axis_size(mesh, a)
        if n > 1:
            dist.all_reduce(out, op=op, group=mesh.get_group(a))
            _record("all-reduce", out, n, a)
    return out


def gather_whole(mesh, tree, specs):
    """Every leaf whole on every rank, from each rank's
    ``sharding.local_shard``: all-gathered over the axes of each split dim,
    innermost axis first."""

    def join(t, spec):
        if not isinstance(t, torch.Tensor):
            return t
        for dim, el in enumerate(spec):
            for a in reversed(axes_of(el)):
                t = all_gather_dim(t, mesh, a, dim)
        return t

    return map2(join, tree, specs)


class _EnterTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_over(g, ctx.mesh, (ctx.axis,)), None, None


class _SumTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce_over(x, mesh, (axis,))

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.n = 1
        for a in axes:
            ctx.n *= axis_size(mesh, a)
        return all_reduce_over(x, mesh, axes) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


def enter_tp(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """``x`` unchanged; its gradient summed over ``axis`` in the backward
    (Megatron's f): for a tensor replicated over ``axis`` that feeds each
    rank's part of a tensor-parallel product."""
    return _EnterTP.apply(x, mesh, axis)


def sum_tp(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """The ranks' partial ``x`` summed over ``axis``; the gradient passes
    through unchanged (Megatron's g), since it is the same on every rank of
    ``axis``."""
    return _SumTP.apply(x, mesh, axis)


def psum_tp(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """The ranks' partial ``x`` summed over ``axis``, and in the backward
    the ranks' gradients of the sum summed too, as ``jax.lax.psum``
    transposes to itself: for a total each rank applies to its own block of
    the work, whose downstream, and so whose gradient, differs from rank to
    rank."""
    return enter_tp(sum_tp(x, mesh, axis), mesh, axis)


def mean_over(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """The mean of the ranks' ``x`` over ``axes``; in the backward each rank
    takes ``1 / n`` of the gradient for its own ``x``, so that summing the
    ranks' parameter gradients over ``axes`` gives the mean's gradient."""
    return _MeanOver.apply(x, mesh, tuple(axes))


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, gathers, sum_axes):
        ctx.mesh, ctx.gathers, ctx.sum_axes = mesh, gathers, sum_axes
        for dim, axis in gathers:
            x = all_gather_dim(x, mesh, axis, dim)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        for dim, axis in reversed(ctx.gathers):
            g = reduce_scatter_dim(g, mesh, axis, dim) if axis in ctx.sum_axes else own_block(g, mesh, axis, dim)
        done = {a for _, a in ctx.gathers}
        rest = [a for a in ctx.sum_axes if a not in done]
        return (all_reduce_over(g, mesh, rest) if rest else g.contiguous()), None, None, None


def gather_param(x: torch.Tensor, mesh, spec: Sequence, keep: Sequence[str] = (),
                 sum_axes: Sequence[str] = ()) -> torch.Tensor:
    """``x``, this rank's block of a leaf split as ``spec`` says (one entry
    per dim: ``None``, an axis or a tuple of axes, the first outermost),
    all-gathered over every axis but ``keep`` (innermost axis first): the
    FSDP gather of a layer's parameter before the layer reads it.  In the
    backward the gradient is summed over ``sum_axes``, the axes over whose
    ranks the compute was split (the batch axes; ``model`` where the ranks
    used different parts of the gathered leaf), and sliced back to the
    block: a reduce-scatter along a gathered dim, a slice along a gathered
    dim whose compute was replicated, an all-reduce over an axis the leaf is
    not split on.  One-rank axes are skipped."""
    gathers = tuple((dim, a) for dim, el in enumerate(spec) for a in reversed(axes_of(el))
                    if a not in keep and axis_size(mesh, a) > 1)
    sums = tuple(a for a in sum_axes if axis_size(mesh, a) > 1)
    if not gathers and not sums:
        return x
    return _Gather.apply(x, mesh, gathers, sums)


def gather_act(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """An activation's blocks over ``axis`` joined along ``dim``; the
    backward slices the rank's block."""
    if axis_size(mesh, axis) == 1:
        return x
    return _Gather.apply(x, mesh, ((dim, axis),), ())


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return reduce_scatter_dim(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return own_block(x, mesh, axis, dim).clone(memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g.contiguous(), ctx.mesh, ctx.axis, ctx.dim), None, None, None


def sp_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The ranks' blocks of ``x`` over ``axis`` joined along ``dim``, for a
    tensor-parallel computation; the backward sums the ranks' partial
    gradients and hands each its block (a reduce-scatter)."""
    if axis_size(mesh, axis) == 1:
        return x
    return _Gather.apply(x, mesh, ((dim, axis),), (axis,))


def sp_scatter(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The sum over ``axis`` of the ranks' partial ``x``, this rank's block
    along ``dim`` (a reduce-scatter); the backward all-gathers the blocks'
    gradients, so every rank gets the whole gradient of its partial."""
    if axis_size(mesh, axis) == 1:
        return x
    return _Scatter.apply(x, mesh, axis, dim)


def split_act(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` over ``axis``, a tensor of
    its own (the whole ``x`` can be freed); the backward all-gathers the
    blocks' gradients, so a computation every rank repeated on the whole
    ``x`` gets the same whole gradient on every rank."""
    if axis_size(mesh, axis) == 1:
        return x
    return _Split.apply(x, mesh, axis, dim)


def gather_heads(t: torch.Tensor, n: int, mesh, axis: str) -> torch.Tensor:
    """All ``n`` heads ``[b, s, n, d]`` from each rank's heads of ``axis``
    (dim 2), in rank order.  Where the ranks outnumber the heads, each head
    is held by a run of consecutive ranks (attention's ``"kv_one"`` plan in
    ``models/layout.py``), and one rank of each run is kept."""
    whole = gather_act(t, mesh, axis, 2)
    return whole[:, :, :: whole.shape[2] // n] if whole.shape[2] > n else whole
