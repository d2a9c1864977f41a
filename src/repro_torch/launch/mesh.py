"""The stage mesh of the pipeline runtime on one device.

The JAX package lays stages on a ``Mesh`` of devices with a ``stage`` axis.
On one card the stages share the device: each stage gets a CUDA stream of
its own, so stages run concurrently and hand off through events.  On the
CPU there are no streams and the stages run in order.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class StageMesh:
    device: torch.device
    n_stages: int
    #: one stream per stage on CUDA; None on the CPU
    streams: tuple[torch.cuda.Stream, ...] | None


def make_stage_mesh(n_stages: int, device: str | torch.device = "cuda") -> StageMesh:
    """Device plus one CUDA stream per stage (no streams on the CPU)."""
    if n_stages < 1:
        raise ValueError(f"need at least one stage, got {n_stages}")
    device = torch.device(device)
    if device.type == "cuda":
        streams = tuple(torch.cuda.Stream(device=device) for _ in range(n_stages))
        return StageMesh(device, n_stages, streams)
    if device.type == "cpu":
        return StageMesh(device, n_stages, None)
    raise ValueError(f"no stage mesh for device {device}")
