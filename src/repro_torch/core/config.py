"""Pipeline configuration: the point in Shisha's design space.

A configuration is (paper §5):
  1. ``stages`` — how many consecutive layers each pipeline stage owns
     (a composition of L into N positive parts; contiguity respects the
     chain DAG of the CNN).
  2. ``eps``    — which EP each stage is mapped to (injective: each stage
     owns its EP exclusively, as in the paper's chiplet setting).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    stages: tuple[int, ...]  # layers per stage, sum == L
    eps: tuple[int, ...]  # EP index per stage, len == len(stages)

    def __post_init__(self):
        if len(self.stages) != len(self.eps):
            raise ValueError(f"{len(self.stages)} stages but {len(self.eps)} EP slots")
        if any(s <= 0 for s in self.stages):
            raise ValueError(f"empty stage in {self.stages}")
        if len(set(self.eps)) != len(self.eps):
            raise ValueError(f"EP assigned to two stages: {self.eps}")

    @property
    def depth(self) -> int:
        return len(self.stages)

    @property
    def n_layers(self) -> int:
        return sum(self.stages)

    def boundaries(self) -> list[tuple[int, int]]:
        """[start, end) layer range per stage."""
        out, start = [], 0
        for s in self.stages:
            out.append((start, start + s))
            start += s
        return out

    def stage_of_layer(self, layer: int) -> int:
        for i, (a, b) in enumerate(self.boundaries()):
            if a <= layer < b:
                return i
        raise IndexError(layer)

    def move_layer(self, src: int, dst: int) -> "PipelineConfig":
        """Move one boundary layer from stage ``src`` to adjacent stage ``dst``.

        Contiguity allows moves only between neighbouring stages; the layer
        moved is the one at the shared boundary.  If src would become empty
        the move is rejected (returns self).
        """
        if abs(src - dst) != 1:
            raise ValueError(f"stages {src} and {dst} are not adjacent")
        if self.stages[src] <= 1:
            return self  # cannot empty a stage
        stages = list(self.stages)
        stages[src] -= 1
        stages[dst] += 1
        return dataclasses.replace(self, stages=tuple(stages))

    def swap_eps(self, i: int, j: int) -> "PipelineConfig":
        eps = list(self.eps)
        eps[i], eps[j] = eps[j], eps[i]
        return dataclasses.replace(self, eps=tuple(eps))

    def neighbours(self) -> Iterator["PipelineConfig"]:
        """Local-move neighbourhood used by Hill Climbing / SA baselines."""
        for i in range(self.depth - 1):
            if self.stages[i] > 1:
                yield self.move_layer(i, i + 1)
            if self.stages[i + 1] > 1:
                yield self.move_layer(i + 1, i)
        for i in range(self.depth):
            for j in range(i + 1, self.depth):
                yield self.swap_eps(i, j)

    def pretty(self, ep_names: Sequence[str] | None = None) -> str:
        cells = []
        for s, e in zip(self.stages, self.eps):
            en = ep_names[e] if ep_names else f"EP{e}"
            cells.append(f"{s}L@{en}")
        return " | ".join(cells)
