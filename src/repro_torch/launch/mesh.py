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

The batch's split over the data axes is here too: :func:`batch_shard` (the
counterpart of the reference's ``batch_sharding``) and :func:`gather_batch`;
the collectives and the autograd functions the mesh paths run are in
:mod:`repro_torch.collectives`, the specs and blocks in
:mod:`repro_torch.sharding`.

:func:`make_production_mesh` is the reference's ``(16, 16)`` /
``(2, 16, 16)`` mesh over the joined group's first ranks, and
:func:`join_fake_group` joins a group of ``fake`` ranks for a dry run
(``launch/dryrun.py``): collectives on it return at once and move nothing.

Nothing here joins a group or touches a device at import.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .. import collectives
from ..collectives import all_reduce_over
from ..sharding import axis_size


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


def make_production_mesh(*, multi_pod: bool = False, device: str | torch.device = "cuda") -> DeviceMesh:
    """The reference's production mesh: ``(16, 16)`` over ``("data",
    "model")``, or ``(2, 16, 16)`` over ``("pod", "data", "model")``, over
    the joined group's first 256 or 512 ranks, on ``device``'s type.  For a
    dry run, join a group of that many fake ranks first
    (:func:`join_fake_group`)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(f"need {n} ranks for mesh {shape}, the group has {have} — "
                           f"join_group them, or join_fake_group({n}) for a dry run")
    kind = torch.device(device).type
    return DeviceMesh("cpu" if kind == "meta" else kind, torch.arange(n).reshape(shape), mesh_dim_names=axes)


def join_fake_group(world_size: int, rank: int = 0) -> None:
    """Join the default group as ``rank`` of ``world_size`` ranks of the
    ``fake`` backend (``torch.testing``'s ``FakeStore``): no other process
    exists, and every collective returns at once without touching its
    tensors.  The dry run's group, as the reference's dry run runs on fake
    host devices.  Gathers and reduce-scatters then allocate their results
    as zeros (``collectives.new_result``), the other ranks' part of a result
    the group leaves unwritten; that stays so for the process.  Leave with
    ``torch.distributed.destroy_process_group()``."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)
    collectives.new_result = torch.zeros


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


def gather_batch(mesh: DeviceMesh, t: torch.Tensor, dp_axes: Sequence[str] = ("data",)) -> torch.Tensor:
    """The whole batch from each data rank's slice along dim 0 (the inverse
    of :func:`batch_shard`), on every rank: each rank's slice placed in
    zeros and summed over the data axes (gloo all-reduces CUDA tensors but
    does not gather them)."""
    index, size = data_rank(mesh, dp_axes)
    n = t.shape[0]
    full = torch.zeros((n * size, *t.shape[1:]), dtype=t.dtype, device=t.device)
    full[index * n : (index + 1) * n] = t
    return all_reduce_over(full, mesh, dp_axes)
