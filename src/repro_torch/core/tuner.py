"""Algorithm 2 — Shisha online tuning.

Starting from the seed, repeatedly:
  1. find the slowest pipeline stage (the throughput bottleneck),
  2. pick a *target* stage on a fast EP — nearest (``nFEP``) or nearest
     lightest (``nlFEP``, recommended: H3) —
  3. move one boundary layer from the slowest stage one hop toward the
     target (contiguity: layers travel between adjacent stages),
  4. re-measure; after α consecutive non-improving configurations, stop.

The tuner never enumerates the space — each step visits exactly one new
configuration, which is what makes it *online-viable* (every trial costs
real pipeline time, accounted by ``Trace``).  When the slowest stage is down
to one layer, the directional move would empty it; the stage collapses
instead (depth shrinks by one, its EP is freed).
"""

from __future__ import annotations

import dataclasses
from typing import Literal

from .config import PipelineConfig
from .evaluator import Trace
from .seed import Seed

Balancing = Literal["nfep", "nlfep"]


def _move_toward(conf: PipelineConfig, src: int, direction: int) -> PipelineConfig | None:
    """Move one boundary layer of stage ``src`` one hop in ``direction``.

    Collapses ``src`` (dropping its EP) if it would become empty.  Returns
    None when the move is impossible (src at pipeline edge).
    """
    dst = src + direction
    if dst < 0 or dst >= conf.depth:
        return None
    stages = list(conf.stages)
    eps = list(conf.eps)
    stages[src] -= 1
    stages[dst] += 1
    if stages[src] == 0:
        del stages[src], eps[src]
    return PipelineConfig(stages=tuple(stages), eps=tuple(eps))


def pick_target(
    conf: PipelineConfig,
    stage_times: list[float],
    slowest: int,
    platform,
    balancing: Balancing,
) -> int | None:
    """Choose the target stage (line 6 of Alg. 2).

    Candidates: stages other than the slowest whose current beat is lower,
    preferring FEPs.  ``nfep``: minimal pipeline distance;  ``nlfep``:
    lightest load.  Ties are broken deterministically: ``nfep`` by
    (distance, beat, stage index), ``nlfep`` by (beat, distance, stage
    index).
    """
    fep_set = set(platform.feps)
    cands = [
        s
        for s in range(conf.depth)
        if s != slowest and stage_times[s] < stage_times[slowest]
    ]
    if not cands:
        return None
    fast_cands = [s for s in cands if conf.eps[s] in fep_set]
    pool = fast_cands or cands
    if balancing == "nfep":
        return min(pool, key=lambda s: (abs(s - slowest), stage_times[s], s))
    if balancing == "nlfep":
        return min(pool, key=lambda s: (stage_times[s], abs(s - slowest), s))
    raise ValueError(f"unknown balancing {balancing!r}")


@dataclasses.dataclass
class TuneResult:
    best_conf: PipelineConfig
    best_throughput: float
    n_explored: int
    final_conf: PipelineConfig


def tune(
    seed: Seed | PipelineConfig,
    trace: Trace,
    alpha: int = 10,
    balancing: Balancing = "nlfep",
    max_steps: int = 10_000,
) -> TuneResult:
    """Algorithm 2.  ``trace`` wraps the evaluator and accounts cost."""
    conf = seed.conf if isinstance(seed, Seed) else seed
    platform = trace.evaluator.platform
    throughput = trace.execute(conf)
    best_conf, best_tp = conf, throughput
    gamma = 0
    steps = 0
    while gamma < alpha and steps < max_steps:
        steps += 1
        stage_times = trace.evaluator.stage_times(conf)
        slowest = max(range(conf.depth), key=stage_times.__getitem__)
        target = pick_target(conf, stage_times, slowest, platform, balancing)
        if target is None:
            break  # perfectly balanced or single stage
        nxt = _move_toward(conf, slowest, 1 if target > slowest else -1)
        if nxt is None or nxt == conf:
            break  # nowhere to move
        tp = trace.execute(nxt)
        conf = nxt
        if tp <= throughput:
            gamma += 1
        else:
            gamma = 0
            throughput = tp
        if tp > best_tp:
            best_conf, best_tp = conf, tp
    return TuneResult(
        best_conf=best_conf,
        best_throughput=best_tp,
        n_explored=trace.n_trials,
        final_conf=conf,
    )
