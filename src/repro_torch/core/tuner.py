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

With ``placement=True`` each step additionally proposes *which EP hosts the
slowest stage*: the stage is trial-relocated onto the best free EP (fastest
class first, then lowest fabric-routed latency to its pipeline neighbours,
then FLOPs, then index).  On a platform with an interconnect fabric this is
what lets the tuner route around congested links — placement on the chiplet
fabric becomes a first-class decision, not just stage sizing.  The extra
candidate is charged to the trace like any online trial — at its *routed*
price: relocating a stage ships its resident weights over the fabric, so
the trial pays ``reconfig_overhead`` plus a store-and-forward ship of the
stage's weight bytes across every routed hop beyond the first
(:func:`placement_reconfig_cost`; a distant EP is expensive to even *try*,
exactly the online-cost asymmetry Shisha exploits).  With
``placement=False`` the loop is exactly the paper's Algorithm 2, trial for
trial.
"""

from __future__ import annotations

import dataclasses
import math
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

    Candidates: stages other than the slowest whose EP class is at least as
    fast as the slowest stage's and whose current beat is lower — preferring
    FEPs.  ``nfep``: minimal pipeline distance;  ``nlfep``: lightest load.

    Ties are broken deterministically: ``nfep`` by (distance, beat, stage
    index), ``nlfep`` by (beat, distance, stage index) — so equal-distance
    equal-load candidates always resolve to the lowest stage index,
    independent of candidate enumeration order.
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


def _relocate(conf: PipelineConfig, stage: int, new_ep: int) -> PipelineConfig:
    eps = list(conf.eps)
    eps[stage] = new_ep
    return PipelineConfig(stages=conf.stages, eps=tuple(eps))


def placement_reconfig_cost(
    trace: Trace, conf: PipelineConfig, stage: int, new_ep: int
) -> float:
    """Wall-clock price of trial-relocating ``stage`` onto ``new_ep``.

    A boundary move ships one layer's weights to an adjacent EP — the flat
    ``reconfig_overhead`` has always modelled that single-link transfer.  A
    *relocation* ships the whole stage's resident weights across the fabric,
    so it pays the flat overhead **plus** a store-and-forward ship of the
    stage's ``weight_bytes`` over every routed hop beyond the first:

        ``overhead + sum_{hops 2..H} (stage_weight_bytes / bw_hop + lat_hop)``

    Weights ship once, as a bulk transfer outside the steady-state flow set,
    so the *static* route prices it (deterministic, congestion-free).  On a
    fully-connected fabric every route is one hop and the extra term
    vanishes — relocation trials cost exactly the old flat overhead, which
    is the regression pin keeping all pre-fabric placement results
    bit-for-bit.  Without a fabric there is nothing to route: flat cost.
    """
    fabric = trace.evaluator.platform.fabric
    flat = trace.reconfig_overhead
    if fabric is None:
        return flat
    if not math.isfinite(fabric.latency_ep(conf.eps[stage], new_ep)):
        # link faults severed the shipping route: the relocation cannot be
        # performed at all (the caller must skip the candidate)
        return math.inf
    route = fabric.route_ep(conf.eps[stage], new_ep)
    if len(route) <= 1:
        return flat
    a, b = conf.boundaries()[stage]
    wbytes = sum(trace.evaluator.layers[i].weight_bytes for i in range(a, b))
    links = fabric.effective_topology().links
    extra = sum(wbytes / links[k].bw + links[k].latency for k in route[1:])
    return flat + extra


def placement_candidate(
    conf: PipelineConfig,
    slowest: int,
    platform,
    exclude: frozenset = frozenset(),
) -> int | None:
    """Best free EP to rehost the slowest stage on, or None.

    Deterministic preference: fastest perf class, then smallest
    fabric-routed latency to the stage's pipeline neighbours (0 without a
    fabric), then highest aggregate FLOPs, then lowest index.  Only unused
    EPs are proposed (the EP assignment is injective), so when the pipeline
    occupies every EP there is nothing to propose.  ``exclude`` removes EPs
    that must never host a stage (e.g. dead EPs in a drifted model, whose
    near-zero sentinel specs would make the relocation trial absurdly
    expensive).
    """
    used = set(conf.eps) | set(exclude)
    free = [e for e in range(platform.n_eps) if e not in used]
    if not free:
        return None
    fabric = platform.fabric

    def neighbour_latency(e: int) -> float:
        if fabric is None:
            return 0.0
        tot = 0.0
        if slowest > 0:
            tot += fabric.latency_ep(conf.eps[slowest - 1], e)
        if slowest < conf.depth - 1:
            tot += fabric.latency_ep(e, conf.eps[slowest + 1])
        return tot

    return min(
        free,
        key=lambda e: (
            platform.eps[e].perf_class,
            neighbour_latency(e),
            -platform.eps[e].flops,
            e,
        ),
    )


@dataclasses.dataclass
class TuneResult:
    best_conf: PipelineConfig
    best_throughput: float
    n_explored: int
    final_conf: PipelineConfig
    #: per-EP DVFS level vector adopted with ``best_conf`` when the tuner
    #: ran with ``dvfs=True`` on a powered platform; None otherwise
    dvfs_levels: tuple[int, ...] | None = None


def _dvfs_candidate(pm, conf: PipelineConfig, slowest: int):
    """One DVFS knob to try this step: ``(ep, new_level)`` or None.

    Preference order mirrors the boundary heuristic's bottleneck focus:
    step the slowest stage's EP *up* a level when the package cap still
    admits it; otherwise free headroom by stepping *down* the hungriest
    other in-use EP.  Deterministic — ties on watts resolve to the lowest
    EP index.
    """
    slow_ep = conf.eps[slowest]
    if pm.can_step_up(slow_ep):
        prev = pm.level(slow_ep)
        pm.set_level(slow_ep, prev - 1)
        feasible = pm.cap_feasible(conf.eps)
        pm.set_level(slow_ep, prev)
        if feasible:
            return (slow_ep, prev - 1)
    others = [e for e in sorted(set(conf.eps)) if e != slow_ep and pm.can_step_down(e)]
    if others:
        victim = max(others, key=lambda e: (pm.dynamic_w(e), -e))
        return (victim, pm.level(victim) + 1)
    return None


def tune(
    seed: Seed | PipelineConfig,
    trace: Trace,
    alpha: int = 10,
    balancing: Balancing = "nlfep",
    max_steps: int = 10_000,
    placement: bool = False,
    placement_exclude: frozenset = frozenset(),
    dvfs: bool = False,
) -> TuneResult:
    """Algorithm 2.  ``trace`` wraps the evaluator and accounts cost.

    ``placement=True`` adds one extra trial per step — relocating the
    slowest stage onto the best free EP (never one in
    ``placement_exclude``) — and adopts whichever measured candidate
    (boundary move or relocation) is fastest.  Off by default: the paper's
    loop is reproduced move for move.

    ``dvfs=True`` (requires a :class:`~repro_torch.power.PowerModel` attached to
    the platform) makes per-EP frequency levels tuned state alongside the
    boundary/placement moves: before the loop, in-use EPs are stepped down
    until the package power cap is satisfied (each enforced level is a paid
    trial — the runtime must re-measure at the new clocks); each step then
    adds one DVFS candidate (up-shift the bottleneck EP if the cap admits
    it, else down-shift the hungriest non-bottleneck EP), applied only for
    its own trial and re-applied if adopted.  Candidates whose EP set would
    break the cap are rejected before being paid.  The best level vector is
    left applied on the power model and returned in ``dvfs_levels``.
    """
    conf = seed.conf if isinstance(seed, Seed) else seed
    platform = trace.evaluator.platform
    pm = platform.power if dvfs else None
    if pm is not None and not pm.tunable and pm.cap_feasible(conf.eps):
        pm = None  # single-level ladders under a satisfied cap: nothing to tune
    if pm is not None:
        # cap enforcement: walk the hungriest in-use EPs down until the
        # package fits (or every ladder bottoms out); each enforced level
        # is a paid measurement at the new clocks
        while not pm.cap_feasible(conf.eps):
            cands = [e for e in sorted(set(conf.eps)) if pm.can_step_down(e)]
            if not cands:
                break
            victim = max(cands, key=lambda e: (pm.dynamic_w(e), -e))
            pm.set_level(victim, pm.level(victim) + 1)
            trace.execute(conf)
    throughput = trace.execute(conf)
    best_conf, best_tp = conf, throughput
    best_levels = pm.snapshot() if pm is not None else None
    gamma = 0
    steps = 0
    while gamma < alpha and steps < max_steps:
        steps += 1
        stage_times = trace.evaluator.stage_times(conf)
        slowest = max(range(conf.depth), key=stage_times.__getitem__)
        #: (candidate, per-trial reconfig cost — None = flat overhead,
        #:  DVFS change (ep, new_level) or None)
        candidates: list[
            tuple[PipelineConfig, float | None, tuple[int, int] | None]
        ] = []
        target = pick_target(conf, stage_times, slowest, platform, balancing)
        if target is not None:
            direction = 1 if target > slowest else -1
            nxt = _move_toward(conf, slowest, direction)
            if nxt is not None and nxt != conf:
                candidates.append((nxt, None, None))
        if placement:
            new_ep = placement_candidate(conf, slowest, platform, placement_exclude)
            if new_ep is not None:
                # relocation ships the stage's weights across the fabric:
                # the trial is charged its routed weight-shipping cost, not
                # the flat boundary-move overhead.  An infinite cost means
                # link faults severed the shipping route — unperformable
                rc = placement_reconfig_cost(trace, conf, slowest, new_ep)
                if math.isfinite(rc):
                    candidates.append((_relocate(conf, slowest, new_ep), rc, None))
        if pm is not None:
            # reject cap-infeasible boundary/placement candidates before
            # they are paid (a move onto a hungrier EP set may break the
            # cap at the current levels)
            candidates = [
                c for c in candidates if pm.cap_feasible(c[0].eps)
            ]
            dv = _dvfs_candidate(pm, conf, slowest)
            if dv is not None:
                candidates.append((conf, None, dv))
        if not candidates:
            break  # perfectly balanced, single stage, or nowhere to move
        # every candidate is a paid online trial; ties resolve to the first
        # (boundary move before relocation before DVFS), keeping the
        # no-placement, no-DVFS path identical to the paper's loop
        measured = []
        for c, rc, change in candidates:
            if change is not None:
                prev_level = pm.level(change[0])
                pm.set_level(change[0], change[1])
            measured.append((trace.execute(c, reconfig_cost=rc), c))
            if change is not None:
                pm.set_level(change[0], prev_level)
        chosen = max(range(len(measured)), key=lambda i: (measured[i][0], -i))
        tp, conf = measured[chosen]
        change = candidates[chosen][2]
        if change is not None:
            pm.set_level(change[0], change[1])
        if tp <= throughput:
            gamma += 1
        else:
            gamma = 0
            throughput = tp
        if tp > best_tp:
            best_conf, best_tp = conf, tp
            if pm is not None:
                best_levels = pm.snapshot()
    if pm is not None:
        pm.restore(best_levels)
    return TuneResult(
        best_conf=best_conf,
        best_throughput=best_tp,
        n_explored=trace.n_trials,
        final_conf=conf,
        dvfs_levels=best_levels,
    )
