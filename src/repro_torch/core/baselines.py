"""Baseline exploration algorithms Shisha is compared against (paper §7).

All baselines consume the same :class:`Trace` accounting as Shisha — every
``execute`` costs simulated pipeline time — so Fig.-4-style convergence
curves are directly comparable.  Each stops when its simulated wall clock
exceeds ``budget_s`` (the online time budget) or its own termination rule
fires.

* Hill Climbing (HC) — first-improvement over the local-move neighbourhood
  (boundary-layer moves + EP swaps); restarts from a random config when
  stuck.
* Simulated Annealing (SA) — random neighbour, Metropolis acceptance on
  relative throughput, geometric cooling (the schedule TVM/Ansor-style
  tuners use).
* Random Walk (RW) — independent uniform configurations, keep the best.
* Exhaustive Search (ES) — enumerate everything; pays an up-front
  database-generation cost like the paper's ES/Pipe-Search setup.
* Pipe-Search (PS) — generates the full configuration database, *sorts* it
  by workload-balance variance (its "sorted w.r.t. distribution of workload"
  ordering), then tests configurations in that order until the time limit.
"""

from __future__ import annotations

import dataclasses
import math
import random as _random
from typing import Sequence

from .config import PipelineConfig
from .evaluator import Trace
from .space import compositions, enumerate_configs, space_size


@dataclasses.dataclass
class SearchResult:
    name: str
    best_conf: PipelineConfig
    best_throughput: float
    n_explored: int


def random_config(rng: _random.Random, n_layers: int, n_eps: int, depth: int | None = None) -> PipelineConfig:
    d = depth or rng.randint(1, min(n_layers, n_eps))
    cuts = sorted(rng.sample(range(1, n_layers), d - 1))
    stages, prev = [], 0
    for c in cuts:
        stages.append(c - prev)
        prev = c
    stages.append(n_layers - prev)
    eps = rng.sample(range(n_eps), d)
    return PipelineConfig(stages=tuple(stages), eps=tuple(eps))


# ---------------------------------------------------------------------------


def hill_climbing(
    trace: Trace,
    n_layers: int,
    budget_s: float,
    start: PipelineConfig | None = None,
    seed: int = 0,
    max_stall_restarts: int = 50,
) -> SearchResult:
    rng = _random.Random(seed)
    n_eps = trace.evaluator.platform.n_eps
    conf = start or random_config(rng, n_layers, n_eps)
    best_tp = trace.execute(conf)
    best_conf = conf
    restarts = 0
    while trace.wall < budget_s and restarts <= max_stall_restarts:
        cur_tp = trace.evaluator.throughput(conf)
        improved = False
        neigh = list(conf.neighbours())
        rng.shuffle(neigh)
        for cand in neigh:
            if trace.wall >= budget_s:
                break
            tp = trace.execute(cand)
            if tp > best_tp:
                best_tp, best_conf = tp, cand
            if tp > cur_tp:  # first improvement
                conf, improved = cand, True
                break
        if not improved:
            restarts += 1
            conf = random_config(rng, n_layers, n_eps)
            if trace.wall < budget_s:
                tp = trace.execute(conf)
                if tp > best_tp:
                    best_tp, best_conf = tp, conf
    return SearchResult("HC", best_conf, best_tp, trace.n_trials)


def simulated_annealing(
    trace: Trace,
    n_layers: int,
    budget_s: float,
    start: PipelineConfig | None = None,
    seed: int = 0,
    t0: float = 0.30,
    cooling: float = 0.97,
) -> SearchResult:
    rng = _random.Random(seed)
    n_eps = trace.evaluator.platform.n_eps
    conf = start or random_config(rng, n_layers, n_eps)
    cur_tp = trace.execute(conf)
    best_conf, best_tp = conf, cur_tp
    temp = t0
    while trace.wall < budget_s and temp > 1e-4:
        neigh = list(conf.neighbours())
        if not neigh:
            break
        cand = rng.choice(neigh)
        tp = trace.execute(cand)
        if tp > best_tp:
            best_conf, best_tp = cand, tp
        # relative throughput delta drives acceptance
        delta = (tp - cur_tp) / max(cur_tp, 1e-30)
        if delta >= 0 or rng.random() < math.exp(delta / temp):
            conf, cur_tp = cand, tp
        temp *= cooling
    return SearchResult("SA", best_conf, best_tp, trace.n_trials)


def random_walk(
    trace: Trace, n_layers: int, budget_s: float, seed: int = 0
) -> SearchResult:
    rng = _random.Random(seed)
    n_eps = trace.evaluator.platform.n_eps
    best_conf, best_tp = None, -1.0
    while trace.wall < budget_s:
        conf = random_config(rng, n_layers, n_eps)
        tp = trace.execute(conf)
        if tp > best_tp:
            best_conf, best_tp = conf, tp
    if best_conf is None:
        best_conf = random_config(rng, n_layers, n_eps)
        best_tp = trace.execute(best_conf)
    return SearchResult("RW", best_conf, best_tp, trace.n_trials)


def exhaustive_search(
    trace: Trace,
    n_layers: int,
    budget_s: float = math.inf,
    max_depth: int | None = None,
) -> SearchResult:
    n_eps = trace.evaluator.platform.n_eps
    best_conf, best_tp = None, -1.0
    for conf in enumerate_configs(n_layers, n_eps, max_depth=max_depth):
        if trace.wall >= budget_s:
            break
        tp = trace.execute(conf)
        if tp > best_tp:
            best_conf, best_tp = conf, tp
    assert best_conf is not None
    return SearchResult("ES", best_conf, best_tp, trace.n_trials)


# ---------------------------------------------------------------------------
# Pipe-Search (Soomro et al., CF'21) re-implementation
# ---------------------------------------------------------------------------


def database_generation_cost(n_layers: int, n_eps: int, max_depth: int | None = None, per_entry_s: float = 2e-4) -> float:
    """Up-front cost of building the sorted configuration database.

    Pipe-Search (and ES, which shares the enumeration) must materialize and
    sort the whole space before exploring — ~1200 s in the paper's Fig. 4.
    We charge a per-entry generation cost; the default reproduces that order
    of magnitude for the SynthNet/8-EP space.
    """
    return space_size(n_layers, n_eps, max_depth) * per_entry_s


def pipe_search(
    trace: Trace,
    weights: Sequence[float],
    budget_s: float,
    max_depth: int | None = None,
    max_db: int = 200_000,
) -> SearchResult:
    """Database of configurations ordered by workload-balance variance.

    Pipe-Search is heterogeneity-blind (paper §7.1): its ordering considers
    only the workload split across stages, not which EP a stage lands on —
    so it converges before trying high-variance splits that heterogeneous
    platforms actually want.
    """
    n_eps = trace.evaluator.platform.n_eps
    n_layers = len(weights)
    total = sum(weights)

    def imbalance(stages: tuple[int, ...]) -> float:
        bounds, start = [], 0
        means = total / len(stages)
        var = 0.0
        for s in stages:
            w = sum(weights[start : start + s])
            var += (w - means) ** 2
            start += s
        return var

    db: list[PipelineConfig] = []
    for d in range(1, min(n_layers, n_eps, max_depth or n_eps) + 1):
        for stages in compositions(n_layers, d):
            if len(db) >= max_db:
                break
            # heterogeneity-blind: EPs assigned in fixed platform order
            db.append(PipelineConfig(stages=stages, eps=tuple(range(d))))
        if len(db) >= max_db:
            break
    db.sort(key=lambda c: imbalance(c.stages))

    best_conf, best_tp = None, -1.0
    for conf in db:
        if trace.wall >= budget_s:
            break
        tp = trace.execute(conf)
        if tp > best_tp:
            best_conf, best_tp = conf, tp
    if best_conf is None:
        best_conf = db[0]
        best_tp = trace.execute(best_conf)
    return SearchResult("PS", best_conf, best_tp, trace.n_trials)
