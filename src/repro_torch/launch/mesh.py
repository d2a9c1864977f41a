"""Meshes of the port: stage streams on one device, and meshes of ranks.

The JAX package lays stages and shards on a ``Mesh`` of devices.  The port
has two kinds of mesh:

* :class:`StageMesh` (``make_stage_mesh(n, device)``): the stages of a
  pipeline share one device, each on a CUDA stream of its own, handing off
  through events (on the CPU there are no streams and the stages run in
  order).
* meshes of ranks, one process a rank, joined by :func:`join_group`:
  ``make_stage_mesh(n, device, ranks=True, per_stage=k)`` puts stage ``s``
  on ranks ``s * k .. s * k + k - 1`` (the reference's ``("stage",
  "inner")`` mesh; the ``inner`` ranks of a stage compute the same thing),
  and :func:`make_test_mesh` lays ranks out over ``("data", "model")``.
  Both are ``torch.distributed.device_mesh.DeviceMesh`` objects.

The collectives the mesh paths of ``models/`` run are here too, each over
the named axes of a mesh: :func:`all_reduce_over`, :func:`batch_shard` (the
counterpart of the reference's ``batch_sharding``) and :func:`gather_batch`,
and Megatron's pair of autograd functions for a tensor-parallel region,
:func:`enter_tp` (identity forward, sum backward) and :func:`sum_tp` (sum
forward, identity backward), with :func:`mean_over` for a mean over the data
axes whose backward gives each rank its own share.

Nothing here joins a group or touches a device at import.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


@dataclasses.dataclass(frozen=True)
class StageMesh:
    device: torch.device
    n_stages: int
    #: one stream per stage on CUDA; None on the CPU
    streams: tuple[torch.cuda.Stream, ...] | None


def join_group(world_size: int, rank: int, *, store: dist.Store | None = None, init_method: str | None = None,
               device: str = "cuda", backend: str | None = None) -> torch.device:
    """Join the default process group as ``rank`` of ``world_size`` and
    return this rank's device.  On ``"cuda"`` the rank takes card ``rank %
    device_count`` and the backend defaults to NCCL; on ``"cpu"`` to gloo.
    ``backend="gloo"`` on ``"cuda"`` lets several ranks share one card (NCCL
    refuses that): gloo then all-reduces and broadcasts CUDA tensors, and
    point-to-point hand-offs go through host memory
    (``pipeline.runtime.PipelineRunner``).  Rendezvous through ``store``
    (e.g. a ``FileStore``) or ``init_method`` (``tcp://host:port``); leave
    with ``torch.distributed.destroy_process_group()``."""
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("join_group(device='cuda'): no CUDA device")
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    elif kind == "cpu":
        dev = torch.device("cpu")
    else:
        raise ValueError(f"no process group on device {device}")
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, store=store, world_size=world_size, rank=rank)
    return dev


def make_stage_mesh(n_stages: int, device: str | torch.device = "cuda", *, ranks: bool = False,
                    per_stage: int = 1) -> StageMesh | DeviceMesh:
    """A pipeline's stage mesh.  By default one device with one CUDA stream
    per stage (no streams on the CPU).  With ``ranks=True``, a
    ``DeviceMesh`` ``("stage", "inner")`` of shape ``(n_stages,
    per_stage)`` over the first ``n_stages * per_stage`` ranks of the
    joined group, on ``device``'s type; a rank outside it has no
    coordinate.  Every rank of the group calls it."""
    if n_stages < 1:
        raise ValueError(f"need at least one stage, got {n_stages}")
    device = torch.device(device)
    if ranks:
        if per_stage < 1 or n_stages * per_stage > dist.get_world_size():
            raise ValueError(f"{n_stages} x {per_stage} ranks, the group has {dist.get_world_size()}")
        grid = torch.arange(n_stages * per_stage).reshape(n_stages, per_stage)
        return DeviceMesh(device.type, grid, mesh_dim_names=("stage", "inner"))
    if per_stage != 1:
        raise ValueError("per_stage > 1 needs a mesh of ranks (ranks=True)")
    if device.type == "cuda":
        streams = tuple(torch.cuda.Stream(device=device) for _ in range(n_stages))
        return StageMesh(device, n_stages, streams)
    if device.type == "cpu":
        return StageMesh(device, n_stages, None)
    raise ValueError(f"no stage mesh for device {device}")


def make_test_mesh(shape: Sequence[int] = (1, 1), axes: Sequence[str] = ("data", "model"),
                   device: str | torch.device = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` over the first ``prod(shape)`` ranks of
    the joined group (as the reference takes the first devices), with
    ``axes`` as its dim names, on ``device``'s type; a rank outside it has
    no coordinate.  Every rank of the group calls it."""
    n = math.prod(shape)
    if n > dist.get_world_size():
        raise ValueError(f"mesh {tuple(shape)} needs {n} ranks, the group has {dist.get_world_size()}")
    return DeviceMesh(torch.device(device).type, torch.arange(n).reshape(tuple(shape)), mesh_dim_names=tuple(axes))


def dp_axes_of(mesh: DeviceMesh) -> tuple[str, ...]:
    """Batch axes: everything except the TP axis."""
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def data_rank(mesh: DeviceMesh, dp_axes: Sequence[str]) -> tuple[int, int]:
    """(this rank's index along the data axes, their total size), the first
    axis outermost."""
    index, size = 0, 1
    for a in dp_axes:
        n = axis_size(mesh, a)
        index, size = index * n + mesh.get_local_rank(a), size * n
    return index, size


def batch_shard(mesh: DeviceMesh, batch, dp_axes: Sequence[str] = ("data",)):
    """This rank's slice along dim 0 of a tensor or of every tensor of a
    dict: the counterpart of the reference's ``batch_sharding``.  The batch
    must split evenly over the data axes."""
    index, size = data_rank(mesh, dp_axes)

    def cut(t: torch.Tensor) -> torch.Tensor:
        if t.shape[0] % size:
            raise ValueError(f"batch of {t.shape[0]} does not split over {size} data ranks")
        n = t.shape[0] // size
        return t[index * n : (index + 1) * n]

    return {k: cut(v) for k, v in batch.items()} if isinstance(batch, dict) else cut(batch)


def all_reduce_over(t: torch.Tensor, mesh: DeviceMesh, axes: Sequence[str],
                    op: dist.ReduceOp.RedOpType = dist.ReduceOp.SUM) -> torch.Tensor:
    """A copy of ``t`` reduced with ``op`` (SUM or MAX) over the ranks of
    ``axes``, one axis after another; every rank gets the same result."""
    out = t.clone()
    for a in axes:
        dist.all_reduce(out, op=op, group=mesh.get_group(a))
    return out


def gather_batch(mesh: DeviceMesh, t: torch.Tensor, dp_axes: Sequence[str] = ("data",)) -> torch.Tensor:
    """The whole batch from each data rank's slice along dim 0 (the inverse
    of :func:`batch_shard`), on every rank: each rank's slice placed in
    zeros and summed over the data axes (gloo all-reduces CUDA tensors but
    does not gather them)."""
    index, size = data_rank(mesh, dp_axes)
    n = t.shape[0]
    full = torch.zeros((n * size, *t.shape[1:]), dtype=t.dtype, device=t.device)
    full[index * n : (index + 1) * n] = t
    for a in dp_axes:
        dist.all_reduce(full, group=mesh.get_group(a))
    return full


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


def enter_tp(x: torch.Tensor, mesh: DeviceMesh, axis: str = "model") -> torch.Tensor:
    """``x`` unchanged; its gradient summed over ``axis`` in the backward
    (Megatron's f): for a tensor replicated over ``axis`` that feeds each
    rank's part of a tensor-parallel product."""
    return _EnterTP.apply(x, mesh, axis)


def sum_tp(x: torch.Tensor, mesh: DeviceMesh, axis: str = "model") -> torch.Tensor:
    """The ranks' partial ``x`` summed over ``axis``; the gradient passes
    through unchanged (Megatron's g), since it is the same on every rank of
    ``axis``."""
    return _SumTP.apply(x, mesh, axis)


def mean_over(x: torch.Tensor, mesh: DeviceMesh, axes: Sequence[str]) -> torch.Tensor:
    """The mean of the ranks' ``x`` over ``axes``; in the backward each rank
    takes ``1 / n`` of the gradient for its own ``x``, so that summing the
    ranks' parameter gradients over ``axes`` gives the mean's gradient."""
    return _MeanOver.apply(x, mesh, tuple(axes))
