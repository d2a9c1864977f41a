"""Design-space accounting and enumeration.

A point is (composition of L layers into N contiguous stages) × (injective
assignment of the N stages to the platform's EPs).  Sizes:

    |space| = sum_{N=1..min(L,E)}  C(L-1, N-1) * P(E, N)

where P(E,N) = E!/(E-N)! — each stage owns its EP exclusively.  This is the
denominator behind the paper's "Shisha explores ~0.1% of the design space".
"""

from __future__ import annotations

import itertools
import math
from typing import Iterator

from .config import PipelineConfig


def n_compositions(n_layers: int, depth: int) -> int:
    return math.comb(n_layers - 1, depth - 1)


def n_assignments(n_eps: int, depth: int) -> int:
    return math.perm(n_eps, depth)


def space_size(n_layers: int, n_eps: int, max_depth: int | None = None) -> int:
    top = min(n_layers, n_eps, max_depth or n_eps)
    return sum(n_compositions(n_layers, d) * n_assignments(n_eps, d) for d in range(1, top + 1))


def compositions(n_layers: int, depth: int) -> Iterator[tuple[int, ...]]:
    """All ways to split n_layers into `depth` positive contiguous parts."""
    for cuts in itertools.combinations(range(1, n_layers), depth - 1):
        prev, parts = 0, []
        for c in cuts:
            parts.append(c - prev)
            prev = c
        parts.append(n_layers - prev)
        yield tuple(parts)


def enumerate_configs(
    n_layers: int, n_eps: int, depth: int | None = None, max_depth: int | None = None
) -> Iterator[PipelineConfig]:
    depths = [depth] if depth else range(1, min(n_layers, n_eps, max_depth or n_eps) + 1)
    for d in depths:
        for stages in compositions(n_layers, d):
            for eps in itertools.permutations(range(n_eps), d):
                yield PipelineConfig(stages=stages, eps=eps)
