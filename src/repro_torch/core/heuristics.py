"""Shisha heuristics H1–H6 (paper Table 2): assignment × balancing."""

from __future__ import annotations

import dataclasses
import random as _random
from typing import Sequence

from .evaluator import Trace
from .seed import Assignment, generate_seed
from .tuner import Balancing, TuneResult, tune

HEURISTICS: dict[str, tuple[Assignment, Balancing]] = {
    "H1": ("rank_l", "nlfep"),
    "H2": ("rank_l", "nfep"),
    "H3": ("rank_w", "nlfep"),  # recommended by the paper (§7.5)
    "H4": ("rank_w", "nfep"),
    "H5": ("random", "nlfep"),
    "H6": ("random", "nfep"),
}


@dataclasses.dataclass
class ShishaResult:
    heuristic: str
    result: TuneResult
    trace: Trace


def run_shisha(
    weights: Sequence[float],
    trace: Trace,
    heuristic: str = "H3",
    n_stages: int | None = None,
    alpha: int = 10,
    rng: _random.Random | None = None,
    placement: bool = False,
) -> ShishaResult:
    """Seed (Alg. 1) + tune (Alg. 2) under one of H1..H6.

    ``placement=True`` enables the fabric-aware EP-relocation moves of
    :func:`~repro_torch.core.tuner.tune` (extra trials, charged to ``trace``).
    """
    assignment, balancing = HEURISTICS[heuristic]
    seed = generate_seed(weights, trace.evaluator.platform, n_stages, assignment, rng)
    result = tune(seed, trace, alpha=alpha, balancing=balancing, placement=placement)
    return ShishaResult(heuristic=heuristic, result=result, trace=trace)
