"""Algorithm 1 — seed generation.

Input:  W_l (per-layer weights, Eq. 1), H_e (EPs ranked fast-to-slow),
        N (target pipeline depth), L (layer count), C (assignment choice).
Output: seed = layers-per-stage composition, E = EP per stage.

Phase 1 (lines 3–8): repeat L-N times — find the lightest group, merge it
with its *lighter* adjacent neighbour (chain DAG => only consecutive merges
are legal).

Phase 2 (lines 9–11): rank stages (by layer count ``Rank_l``, by aggregate
weight ``Rank_w``, or ``random`` for the H5/H6 ablation) and assign them to
the ranked EP list.  Under ``Rank_w`` heavy stages go to fast EPs; under
``Rank_l`` many-layer stages go to *slow* EPs (§5.1), so that online tuning
can later drain layers from them toward fast EPs.
"""

from __future__ import annotations

import dataclasses
import random as _random
from typing import Literal, Sequence

from .config import PipelineConfig
from .platform import Platform

Assignment = Literal["rank_l", "rank_w", "random"]


@dataclasses.dataclass(frozen=True)
class Seed:
    conf: PipelineConfig
    #: group -> constituent layer indices (diagnostics)
    groups: tuple[tuple[int, ...], ...]


def merge_layers(weights: Sequence[float], n_stages: int) -> list[list[int]]:
    """Phase 1: merge lightest group with its lighter adjacent neighbour."""
    if n_stages < 1:
        raise ValueError("need at least one stage")
    if n_stages > len(weights):
        raise ValueError(f"cannot make {n_stages} stages out of {len(weights)} layers")
    groups = [[i] for i in range(len(weights))]
    w = list(map(float, weights))
    for _ in range(len(weights) - n_stages):
        i = min(range(len(w)), key=w.__getitem__)  # lightest group (line 4)
        # lighter adjacent neighbour (line 5): min(w[i-1], w[i+1])
        if i == 0:
            j = 1
        elif i == len(w) - 1:
            j = i - 1
        else:
            j = i - 1 if w[i - 1] <= w[i + 1] else i + 1
        a, b = min(i, j), max(i, j)
        groups[a] = groups[a] + groups[b]
        w[a] = w[a] + w[b]
        del groups[b], w[b]
    return groups


def assign_eps(
    group_weights: Sequence[float],
    group_sizes: Sequence[int],
    platform: Platform,
    choice: Assignment,
    rng: _random.Random | None = None,
) -> list[int]:
    """Phase 2: rank stages, walk the ranked-EP list H_e."""
    n = len(group_weights)
    ranked_eps = platform.ranked()[:n]
    if choice == "rank_w":
        # heaviest stage -> fastest EP
        order = sorted(range(n), key=lambda i: -group_weights[i])
    elif choice == "rank_l":
        # most-layers stage -> ranked *last* (slow EPs), per §5.1
        order = sorted(range(n), key=lambda i: group_sizes[i])
    elif choice == "random":
        order = list(range(n))
        (rng or _random.Random(0)).shuffle(order)
    else:
        raise ValueError(f"unknown assignment choice {choice!r}")
    eps = [0] * n
    for rank, stage in enumerate(order):
        eps[stage] = ranked_eps[rank]
    return eps


def generate_seed(
    weights: Sequence[float],
    platform: Platform,
    n_stages: int | None = None,
    choice: Assignment = "rank_w",
    rng: _random.Random | None = None,
) -> Seed:
    """Algorithm 1 end-to-end.  Default depth = one stage per EP."""
    n = n_stages if n_stages is not None else min(platform.n_eps, len(weights))
    groups = merge_layers(weights, n)
    gw = [sum(weights[i] for i in g) for g in groups]
    gs = [len(g) for g in groups]
    eps = assign_eps(gw, gs, platform, choice, rng)
    conf = PipelineConfig(stages=tuple(gs), eps=tuple(eps))
    return Seed(conf=conf, groups=tuple(tuple(g) for g in groups))
