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
from typing import Sequence


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

    def boundaries(self) -> list[tuple[int, int]]:
        """[start, end) layer range per stage."""
        out, start = [], 0
        for s in self.stages:
            out.append((start, start + s))
            start += s
        return out

    def pretty(self, ep_names: Sequence[str] | None = None) -> str:
        cells = []
        for s, e in zip(self.stages, self.eps):
            en = ep_names[e] if ep_names else f"EP{e}"
            cells.append(f"{s}L@{en}")
        return " | ".join(cells)
