"""Multi-tenant co-scheduling: several CNN pipelines on one platform.

The paper schedules one network onto one chiplet platform; a serving
deployment runs many.  Because Shisha's EP assignment is injective (each
stage owns its EP), the natural multi-tenant form is a *disjoint partition*
of the platform's EPs: each tenant receives a sub-platform and is seeded
and tuned independently (Algorithms 1+2 unchanged).

Launch-time partition strategies over the H_e ranking (``Platform.ranked()``):

  * ``interleaved``   — deal ranked EPs round-robin, so every tenant gets a
                        fair FEP/SEP mix (heterogeneity-preserving).
  * ``blocked``       — contiguous chunks of the ranking: tenant 0 gets the
                        fastest block (priority tiers).
  * ``proportional``  — deal each ranked EP to the tenant with the largest
                        unmet ``share`` (weighted fairness).

Beyond the launch-time split, this module co-simulates all tenants on one
**shared clock** (:class:`SharedClockCoSimulator` / :func:`co_serve`): every
tenant's stage queues advance on a single discrete-event timeline over the
global platform, scripted faults hit *global* EP indices so whichever
tenant owns the EP sees the drift, and — in elastic mode — an
:class:`ElasticPartitioner` re-runs the partition mid-flight: a tenant
whose partition lost an EP steals the lowest-marginal-value EP from donor
tenants (priced by each donor's model throughput and SLO pressure), after
which every affected tenant re-tunes via its
:class:`~repro_torch.serve.autotuner.ContinuousShisha`, paying the full
``Trace.wall`` exploration cost on the shared clock.  Revivals are elastic
too: a dead EP that comes back is granted to the highest-surplus tenant by
the same pricing.  When the global platform carries an interconnect fabric,
the co-simulator additionally injects every lane's live activation flows
into the other lanes each monitor window, so co-tenant traffic congests the
links it shares (§6's contention effect, live on the event loop).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

from ..core.cost_model import Layer, weights as layer_weights
from ..core.evaluator import AnalyticEvaluator, DatabaseEvaluator, Trace
from ..core.heuristics import run_shisha
from ..core.platform import Platform
from ..interconnect import Flow
from ..pipeline.hetero import EPDerates
from ..telemetry import live
from .autotuner import ContinuousShisha, drifted_platform, tune_batch_policy
from .simulator import (
    _MONITOR,
    _PLATFORM,
    _RECONFIG,
    EventLoop,
    Replatform,
    ServingSimulator,
    SimResult,
)
from .traffic import TrafficGenerator

PARTITION_STRATEGIES = ("interleaved", "blocked", "proportional")


@dataclasses.dataclass(frozen=True)
class Tenant:
    """One hosted pipeline: a network, its traffic, and its SLO."""

    name: str
    layers: tuple[Layer, ...]
    traffic: TrafficGenerator
    #: latency SLO in simulated seconds
    slo: float = 1.0
    #: relative EP share under the "proportional" strategy
    share: float = 1.0


def partition_eps(
    platform: Platform,
    n_parts: int,
    strategy: str = "interleaved",
    shares: Sequence[float] | None = None,
) -> list[tuple[int, ...]]:
    """Split the platform's EP indices into ``n_parts`` disjoint groups."""
    if n_parts < 1 or n_parts > platform.n_eps:
        raise ValueError(f"cannot split {platform.n_eps} EPs into {n_parts} parts")
    ranked = platform.ranked()
    shares = list(shares) if shares is not None else [1.0] * n_parts
    if len(shares) != n_parts or any(s <= 0 for s in shares):
        raise ValueError(f"need {n_parts} positive shares, got {shares}")
    parts: list[list[int]] = [[] for _ in range(n_parts)]
    if strategy == "interleaved":
        for i, ep in enumerate(ranked):
            parts[i % n_parts].append(ep)
    elif strategy == "blocked":
        total = sum(shares)
        sizes = [max(1, round(platform.n_eps * s / total)) for s in shares]
        while sum(sizes) > platform.n_eps:
            # rebalance by shrinking the largest *shrinkable* size: taking a
            # tenant to 0 would trip the no-EPs invariant below under
            # sufficiently skewed shares
            i = max(range(n_parts), key=lambda p: (sizes[p] > 1, sizes[p], -p))
            if sizes[i] <= 1:
                raise ValueError(
                    f"cannot fit {n_parts} tenants with shares {shares} "
                    f"onto {platform.n_eps} EPs"
                )
            sizes[i] -= 1
        while sum(sizes) < platform.n_eps:
            sizes[sizes.index(min(sizes))] += 1
        start = 0
        for p, size in enumerate(sizes):
            parts[p] = ranked[start : start + size]
            start += size
    elif strategy == "proportional":
        got = [0.0] * n_parts
        for ep in ranked:
            # largest unmet share takes the next-fastest EP (ties: lower idx)
            p = max(range(n_parts), key=lambda i: (shares[i] - got[i], -i))
            parts[p].append(ep)
            got[p] += 1.0 * sum(shares) / platform.n_eps
    else:
        raise ValueError(f"unknown strategy {strategy!r}; have {PARTITION_STRATEGIES}")
    if any(not p for p in parts):
        raise ValueError(f"strategy {strategy!r} left a tenant with no EPs: {parts}")
    return [tuple(p) for p in parts]


def subplatform(platform: Platform, ep_idxs: Sequence[int], name: str) -> Platform:
    """A tenant's private view: the selected EPs, reindexed from 0.

    An attached fabric is restricted, not rebuilt: the tenant's transfers
    still route over the *global* topology (through routers of chiplets it
    does not own), which is exactly what lets co-tenant flows contend.

    An attached power model is restricted to a per-lane copy carrying the
    owned EPs' current DVFS levels.  Two documented simplifications: each
    lane enforces the whole-package cap against its own draw (conservative
    — the sum of lane draws may still exceed what any single lane sees),
    and a lane rebuilt after a repartition restarts from the global model's
    levels and ambient thermal state.
    """
    fabric = platform.fabric.restrict(ep_idxs) if platform.fabric is not None else None
    power = platform.power.restrict(ep_idxs) if platform.power is not None else None
    return Platform(
        name=name,
        eps=tuple(platform.eps[i] for i in ep_idxs),
        fabric=fabric,
        power=power,
    )


@dataclasses.dataclass
class TenantResult:
    tenant: Tenant
    ep_idxs: tuple[int, ...]  # global EP indices owned by this tenant (final)
    conf_pretty: str
    model_throughput: float
    n_trials: int
    sim: SimResult
    #: per-stage max micro-batch installed at launch (batch-knob search)
    batch_policy: tuple[int, ...] | None = None


@dataclasses.dataclass
class RepartitionEvent:
    """One elastic re-allocation, as recorded by the co-simulator.

    ``kind`` distinguishes a ``"dropout"`` steal (an EP died, the victim
    stole a replacement) from a ``"revival"`` grant (a dead EP came back and
    was offered to the highest-surplus tenant: ``victim`` is the *receiving*
    tenant, ``stolen_ep`` the revived EP, ``price`` its winning gain,
    ``donor`` None).
    """

    t: float
    dead_ep: int  # global EP index whose death/revival triggered the event
    victim: str  # tenant that lost the EP (dropout) / received it (revival)
    donor: str | None  # tenant that gave one up (None: nobody could)
    stolen_ep: int | None  # global EP index moved donor -> victim
    price: float | None  # donor's marginal value of the stolen EP
    #: post-event global partitions (alive EPs only), tenant name -> indices
    partitions: dict[str, tuple[int, ...]]
    #: tenant name -> Trace.wall exploration seconds charged on the shared
    #: clock for the forced re-tune this event caused
    retune_costs: dict[str, float]
    kind: str = "dropout"
    #: the full package deal, one pricing-breakdown dict per steal (first
    #: entry mirrors donor/stolen_ep/price); a single-steal rebalance has
    #: exactly one entry, so pre-bundle consumers keep working unchanged
    bundle: tuple[dict, ...] = ()


class ElasticPartitioner:
    """Mid-flight EP re-allocation across tenants.

    When a global EP dies, the tenant owning it loses capacity its schedule
    was tuned for.  Rather than leaving the victim to shrink, the
    partitioner re-runs the partition: every *donor* tenant (anyone holding
    at least two alive EPs) offers each of its EPs, and offers are valued
    in the one currency the aggregate SLO metric is measured in —
    **requests/second of demand put at risk**:

        ``at_risk(tenant, C) = max(0, headroom * demand + urgency - C)``

    where ``C`` is the *tuned* model throughput of a full Shisha re-tune
    on the candidate EP set (Algorithm 1 seeds undervalue what tuning can
    extract, so pricing re-tunes — pure model-side arithmetic, the
    scheduler thinking rather than measuring, so it costs no simulated
    time), ``demand`` is the tenant's observed arrival rate, ``headroom``
    covers burstiness/queueing slack, and ``urgency = backlog / slo`` is
    the SLO pressure of requests already waiting.  An offer's *price* is
    the donor's at-risk increase from giving the EP up; the victim's
    *gain* is its at-risk decrease from receiving it.  The victim steals
    the offer with the largest positive surplus (gain minus price): a
    donor with real headroom gives up even a fast EP almost for free, a
    donor near saturation prices it high and keeps its partition, and an
    EP the victim's pipeline cannot exploit (its bottleneck lies
    elsewhere) is never stolen just because it is cheap.  Only the
    re-tunes that follow a steal charge ``Trace.wall`` to the clock.
    """

    def __init__(
        self,
        platform: Platform,
        make_evaluator: Callable[[Platform, Sequence[Layer]], AnalyticEvaluator],
        heuristic: str = "H3",
        headroom: float = 2.0,
    ):
        self.platform = platform
        self.make_evaluator = make_evaluator
        self.heuristic = heuristic
        self.headroom = headroom
        self._tp_cache: dict[tuple[str, tuple[int, ...]], float] = {}

    def tuned_throughput(self, tenant: Tenant, part: Sequence[int]) -> float:
        """Model throughput of a full Shisha re-tune of ``tenant`` on ``part``.

        Cached per (tenant, EP set); ``use_cache`` also dedups revisits
        inside the throwaway pricing trace.
        """
        key = (tenant.name, tuple(sorted(part)))
        if key not in self._tp_cache:
            if not part:
                self._tp_cache[key] = 0.0
            else:
                sub = subplatform(self.platform, part, f"{self.platform.name}/price")
                ev = self.make_evaluator(sub, tenant.layers)
                sh = run_shisha(
                    layer_weights(tenant.layers), Trace(ev, use_cache=True), self.heuristic
                )
                self._tp_cache[key] = sh.result.best_throughput
        return self._tp_cache[key]

    def _at_risk(self, capacity: float, demand: float, urgency: float) -> float:
        return max(0.0, self.headroom * demand + urgency - capacity)

    def price(
        self, tenant: Tenant, part: Sequence[int], ep: int, demand: float, urgency: float
    ) -> float:
        """Donor-side price: req/s of demand put at risk by giving ``ep`` up."""
        c_with = self.tuned_throughput(tenant, part)
        c_without = self.tuned_throughput(tenant, [e for e in part if e != ep])
        return self._at_risk(c_without, demand, urgency) - self._at_risk(
            c_with, demand, urgency
        )

    def gain(
        self, tenant: Tenant, part: Sequence[int], ep: int, demand: float, urgency: float
    ) -> float:
        """Victim-side value: req/s of at-risk demand recovered by ``ep``."""
        c_now = self.tuned_throughput(tenant, part)
        c_plus = self.tuned_throughput(tenant, list(part) + [ep])
        if c_now <= 0 < c_plus:
            return math.inf  # a tenant with no EPs must be re-housed
        return self._at_risk(c_now, demand, urgency) - self._at_risk(
            c_plus, demand, urgency
        )

    def rebalance(
        self,
        partitions: dict[str, tuple[int, ...]],
        victim: str,
        tenants: dict[str, Tenant],
        loads: dict[str, tuple[float, float]],
    ) -> tuple[str, int, float] | None:
        """Pick (donor, ep, price) for ``victim`` to steal, or None.

        ``loads`` maps tenant name to (observed demand req/s, urgency
        req/s).  Returns the offer with the largest positive surplus
        (victim gain minus donor price); None when no transfer is worth
        it.  Deterministic: ties resolve to the lower price, then the
        lower global EP index, then the donor name.
        """
        offers: list[tuple[float, float, int, str]] = []
        v_part = partitions[victim]
        v_demand, v_urgency = loads[victim]
        # iterate donors by name, not dict insertion order: the offer sort
        # key below is total anyway, but pinning the scan order keeps the
        # pricing cache fill (and any future early-exit) independent of
        # the order a caller happened to assemble `partitions` in
        for name, part in sorted(partitions.items()):
            if name == victim or len(part) < 2:
                continue
            d_demand, d_urgency = loads[name]
            for ep in part:
                price = self.price(tenants[name], part, ep, d_demand, d_urgency)
                gain = self.gain(tenants[victim], v_part, ep, v_demand, v_urgency)
                offers.append((gain - price, price, ep, name))
        if not offers:
            return None
        offers.sort(key=lambda o: (-o[0], o[1], o[2], o[3]))
        surplus, price, ep, donor = offers[0]
        if surplus <= 0:
            return None  # every offer hurts the donor more than it helps
        return donor, ep, price

    def rebalance_bundle(
        self,
        partitions: dict[str, tuple[int, ...]],
        victim: str,
        tenants: dict[str, Tenant],
        loads: dict[str, tuple[float, float]],
        max_bundle: int = 1,
    ) -> tuple[list[dict], dict[str, tuple[int, ...]]]:
        """Package deal: up to ``max_bundle`` priced steals for ``victim``.

        A tenant under *extreme pressure* — at-risk demand exceeding its own
        arrival rate even after a steal, i.e. more than the burst headroom's
        worth of traffic still uncovered — may need several EPs at once; a
        one-EP-per-monitor-window drip would leave it violating its SLO for
        windows on end while paying a full exploration wall per EP.  So the
        rebalance is iterated *at decision time*: each round re-prices every
        donor offer against the updated partitions (a donor that just gave
        an EP up prices its next one higher) and stops at ``max_bundle``
        steals, when no offer has positive surplus, or as soon as the
        victim's residual at-risk demand drops to its arrival rate —
        whichever comes first.  With ``max_bundle=1`` the deal is exactly
        :meth:`rebalance`.

        Returns ``(deals, new_partitions)``: one pricing-breakdown dict per
        steal (``inf`` gains serialized as ``None`` for strict JSON) and the
        partitions after the whole bundle moved.  Does not mutate
        ``partitions``.
        """
        parts = {k: tuple(v) for k, v in partitions.items()}
        deals: list[dict] = []
        v_demand, v_urgency = loads[victim]
        for _ in range(max(1, max_bundle)):
            deal = self.rebalance(parts, victim, tenants, loads)
            if deal is None:
                break
            donor, ep, price = deal
            gain = self.gain(tenants[victim], parts[victim], ep, v_demand, v_urgency)
            parts[donor] = tuple(e for e in parts[donor] if e != ep)
            parts[victim] = parts[victim] + (ep,)
            at_risk_after = self._at_risk(
                self.tuned_throughput(tenants[victim], parts[victim]),
                v_demand,
                v_urgency,
            )
            deals.append(
                {
                    "donor": donor,
                    "ep": ep,
                    "price": price,
                    "gain": None if math.isinf(gain) else gain,
                    "surplus": None if math.isinf(gain) else gain - price,
                    "victim_at_risk_after": at_risk_after,
                }
            )
            if at_risk_after <= v_demand:
                break  # pressure back within burst headroom: stop stealing
        return deals, parts


class SharedClockCoSimulator:
    """All tenants' stage queues on one discrete-event timeline.

    Each tenant is a *lane*: a :class:`ServingSimulator` over its
    sub-platform, bound to the shared :class:`EventLoop`.  Lanes never touch
    each other's queues — the cross-tenant channels are exactly (a) the
    partition, which the :class:`ElasticPartitioner` may rewrite mid-flight
    (dropout steals *and* revival grants), (b) the global fault script,
    which hits global EP indices and lands on whichever lane owns the EP at
    fault time, and (c) the interconnect fabric, when the global platform
    carries one: every monitor window each lane's live activation flows are
    injected into the other lanes' evaluators (and, when
    ``contention_aware``, their tuners), so co-tenant traffic fair-shares
    the links it crosses.

    The co-simulator's own monitor tick runs *before* the lanes' ticks at
    equal timestamps (it is pushed first), so a re-partition decision
    pre-empts a lane-local dropout re-seed that would otherwise pay a
    redundant exploration window.
    """

    def __init__(
        self,
        platform: Platform,
        tenants: Sequence[Tenant],
        *,
        strategy: str = "interleaved",
        make_evaluator: Callable[[Platform, Sequence[Layer]], AnalyticEvaluator] | None = None,
        heuristic: str = "H3",
        max_batch: int = 4,
        batch_efficiency: float = 0.7,
        elastic: bool = True,
        batch_policy_search: bool = False,
        monitor_interval: float = 0.5,
        measure_batches: int = 8,
        alpha: int = 10,
        contention_aware: bool = True,
        placement: bool = False,
        dvfs: bool = False,
        telemetry=None,
        max_bundle: int = 1,
        loop: EventLoop | None = None,
        chaos=None,
        resilience=None,
    ):
        if make_evaluator is None:
            make_evaluator = lambda p, layers: DatabaseEvaluator(p, layers)
        self.platform = platform
        self.tenants = list(tenants)
        self.make_evaluator = make_evaluator
        self.heuristic = heuristic
        self.max_batch = max_batch
        self.batch_efficiency = batch_efficiency
        self.elastic = elastic
        self.batch_policy_search = batch_policy_search
        self.monitor_interval = monitor_interval
        #: ground truth always prices co-tenant flows (physics); this knob
        #: decides whether the lanes' *tuners* also see them (scheduler
        #: knowledge) — the contention-blind/-aware comparison of
        #: benchmarks/fig9_interconnect.py
        self.contention_aware = contention_aware
        #: enable Algorithm 2's placement moves in every lane re-tune
        self.placement = placement
        #: explore per-EP DVFS levels in every lane re-tune (needs a
        #: platform power model; lanes see restricted per-lane copies)
        self.dvfs = dvfs
        #: exploration-cost knobs for the lanes' mid-flight re-tunes: fewer
        #: measurement batches / a smaller α shorten the window the old
        #: (degraded) configuration keeps serving — the Shisha trade-off
        self.measure_batches = measure_batches
        self.alpha = alpha
        #: live telemetry session or None, shared by every lane, the shared
        #: loop and the (restricted) fabrics — one timeline for the whole run
        self.telemetry = live(telemetry)
        #: max EPs a victim under extreme pressure may receive per
        #: repartition (package deal); 1 = classic single steal
        self.max_bundle = max(1, max_bundle)
        #: seeded :class:`~repro_torch.faults.FaultModel` expanded over the
        #: *global* platform at run() time, or None (no chaos)
        self.chaos = chaos
        #: request-level :class:`~repro_torch.faults.ResiliencePolicy` installed
        #: in every lane, or None (blind lanes)
        self.resilience = resilience

        #: the shared event engine; injectable so the old-vs-new
        #: equivalence suite can drive a whole co-simulation on the legacy
        #: :class:`~repro_torch.serve.simulator.HeapEventLoop` reference engine
        self.loop = loop if loop is not None else EventLoop(self.telemetry)
        parts = partition_eps(
            platform, len(tenants), strategy, shares=[t.share for t in tenants]
        )
        #: tenant name -> global EP indices (alive only; maintained elastically)
        self.partitions: dict[str, tuple[int, ...]] = {}
        self.lanes: dict[str, ServingSimulator] = {}
        self._launch: dict[str, dict] = {}
        for tenant, ep_idxs in zip(self.tenants, parts):
            self.partitions[tenant.name] = tuple(ep_idxs)
            self.lanes[tenant.name] = self._build_lane(tenant, ep_idxs)
        #: what each lane is *currently serving on* — lags ``partitions``
        #: by the exploration window while a re-partition is in flight, and
        #: is the mapping runtime fault effects must use
        self._installed: dict[str, tuple[int, ...]] = dict(self.partitions)

        self.elastic_partitioner = ElasticPartitioner(platform, make_evaluator, heuristic)
        self.repartitions: list[RepartitionEvent] = []
        self.global_drift: list[float] = [1.0] * platform.n_eps
        self.global_dead: set[int] = set()
        self._unhandled_dead: list[int] = []
        self._unhandled_revived: list[int] = []
        self._scripted: list[tuple[float, Callable]] = []

    # -- lane construction --------------------------------------------------

    def _sub(self, tenant: Tenant, ep_idxs: Sequence[int]) -> Platform:
        return subplatform(
            self.platform, ep_idxs, f"{self.platform.name}/{tenant.name}"
        )

    def _build_lane(self, tenant: Tenant, ep_idxs: Sequence[int]) -> ServingSimulator:
        sub = self._sub(tenant, ep_idxs)
        ev = self.make_evaluator(sub, tenant.layers)
        trace = Trace(ev)
        sh = run_shisha(
            layer_weights(tenant.layers), trace, self.heuristic, placement=self.placement
        )
        conf = sh.result.best_conf
        policy = None
        if self.batch_policy_search:
            policy = tune_batch_policy(
                trace,
                conf,
                tenant.slo,
                batch_efficiency=self.batch_efficiency,
                max_batch_cap=self.max_batch,
            )
        tuner = ContinuousShisha(
            sub,
            tenant.layers,
            make_evaluator=lambda p, L=tenant.layers: self.make_evaluator(p, L),
            slo=tenant.slo,
            batch_policy_search=self.batch_policy_search,
            max_batch_cap=self.max_batch,
            batch_efficiency=self.batch_efficiency,
            measure_batches=self.measure_batches,
            alpha=self.alpha,
            placement=self.placement,
            dvfs=self.dvfs,
        )
        self._launch[tenant.name] = {
            "conf_pretty": conf.pretty([ep.name for ep in sub.eps]),
            "model_throughput": sh.result.best_throughput,
            "n_trials": trace.n_trials,
            "batch_policy": policy,
        }
        return ServingSimulator(
            ev,
            conf,
            slo=tenant.slo,
            max_batch=self.max_batch,
            batch_efficiency=self.batch_efficiency,
            batch_policy=policy,
            monitor_interval=self.monitor_interval,
            autotuner=tuner,
            loop=self.loop,
            telemetry=self.telemetry,
            label=tenant.name,
            resilience=self.resilience,
        )

    # -- global fault script (global EP indices) ----------------------------

    def schedule_slowdown(self, t: float, ep_idx: int, factor: float) -> None:
        """At ``t`` global EP ``ep_idx`` derates; its owner lane sees it."""

        def apply(sim: "SharedClockCoSimulator", now: float) -> None:
            sim.global_drift[ep_idx] *= factor
            owner = sim._serving_owner_of(ep_idx)
            if owner is not None:
                local = sim._installed[owner].index(ep_idx)
                sim.lanes[owner].apply_slowdown(local, factor)

        self._scripted.append((t, apply))

    def schedule_dropout(self, t: float, ep_idx: int) -> None:
        """At ``t`` global EP ``ep_idx`` dies; elastic mode re-partitions."""

        def apply(sim: "SharedClockCoSimulator", now: float) -> None:
            if ep_idx in sim.global_dead:
                return
            sim.global_dead.add(ep_idx)
            # runtime effect lands on whoever is *serving* on the EP ...
            serving = sim._serving_owner_of(ep_idx)
            if serving is not None:
                local = sim._installed[serving].index(ep_idx)
                sim.lanes[serving].apply_dropout(local)
            # ... while the allocation response follows ownership
            if sim.elastic and sim._owner_of(ep_idx) is not None:
                sim._unhandled_dead.append(ep_idx)
            # non-elastic mode: the owner's own ContinuousShisha re-seeds
            # within its (shrunken) partition at its next monitor tick

        self._scripted.append((t, apply))

    def schedule_revival(self, t: float, ep_idx: int) -> None:
        """At ``t`` dead global EP ``ep_idx`` comes back.

        If some lane still serves on it (static partitions, or a dropout
        whose re-partition has not landed yet), the revival is a lane-local
        recovery.  Otherwise — elastic mode, the EP was rebalanced out of
        every partition — it is offered to the highest-surplus tenant via
        the ElasticPartitioner pricing at the next co-monitor tick.
        """

        def apply(sim: "SharedClockCoSimulator", now: float) -> None:
            if ep_idx not in sim.global_dead:
                return
            sim.global_dead.discard(ep_idx)
            # runtime effect: a lane still serving on the EP (static mode,
            # or an elastic re-partition whose install has not landed yet)
            # resumes its stages immediately ...
            serving = sim._serving_owner_of(ep_idx)
            if serving is not None:
                local = sim._installed[serving].index(ep_idx)
                sim.lanes[serving].apply_revival(local, now)
            # ... while the allocation response follows ownership, exactly
            # like schedule_dropout: if the partitions no longer contain the
            # EP (it was rebalanced away), it must be re-granted even when
            # some lane transiently serves on it during its install window
            if sim.elastic and sim._owner_of(ep_idx) is None:
                sim._unhandled_revived.append(ep_idx)

        self._scripted.append((t, apply))

    def schedule_link_fault(self, t: float, u: int, v: int, factor: float) -> None:
        """At ``t`` the global fabric link (u, v) fails/degrades/heals.

        Link state is shared by reference between the global fabric and
        every lane's restricted copy, so one mutation is instantly visible
        to all tenants; each lane then re-prices its stage times under the
        new effective topology and gets its stages kicked (a healed link
        may unblock a boundary that priced ``inf``).
        """

        def apply(sim: "SharedClockCoSimulator", now: float) -> None:
            fabric = sim.platform.fabric
            if fabric is None:
                return
            fabric.set_link_state(u, v, factor)
            for name in sorted(sim.lanes):
                sim._refresh_lane_links(name, now, kick=factor > 0.0)

        self._scripted.append((t, apply))

    def _refresh_lane_links(self, name: str, now: float, kick: bool) -> None:
        lane = self.lanes[name]
        lane._base_times = list(lane.evaluator.stage_times(lane.conf))
        if kick:
            for s in range(lane.conf.depth):
                lane._try_start(s, now)

    # -- chaos (seeded stochastic fault model over the global platform) ------

    def _expand_chaos(self, horizon: float) -> None:
        """Turn the attached fault model into global scripted events.

        Dropouts/revivals reuse the global-index fault script (so the
        elastic partitioner responds exactly as it would to a scripted
        death); link events go through :meth:`schedule_link_fault`; each
        lane additionally draws transient batch errors from its own
        tenant-name-keyed stream.
        """
        from ..faults import FaultInjector

        fabric = self.platform.fabric
        if fabric is not None and fabric.link_state:
            # chaos traces start from a healthy fabric: reset leftovers a
            # previous run on the same platform object left behind
            fabric.link_state.clear()
            for name in sorted(self.lanes):
                self._refresh_lane_links(name, 0.0, kick=False)
        inj = FaultInjector(self.chaos)
        for ev in inj.trace(self.platform, horizon):
            if ev.kind == "dropout":
                self.schedule_dropout(ev.t, ev.ep)
                self._mark_chaos(ev.t, "dropouts", {"ep": ev.ep})
            elif ev.kind == "revival":
                self.schedule_revival(ev.t, ev.ep)
                self._mark_chaos(ev.t, "revivals", {"ep": ev.ep})
            else:
                self.schedule_link_fault(ev.t, ev.link[0], ev.link[1], ev.factor)
                self._mark_chaos(
                    ev.t, "link_faults", {"link": list(ev.link), "factor": ev.factor}
                )
        for tenant in self.tenants:
            bf = inj.batch_failures(tenant.name)
            if bf is not None:
                self.lanes[tenant.name]._batch_faults = bf

    def _mark_chaos(self, t: float, counter: str, args: dict) -> None:
        # pushed after the effect closure at the same timestamp, so the
        # instant lands once the fault has actually been applied
        def apply(sim: "SharedClockCoSimulator", now: float) -> None:
            tl = sim.telemetry
            if tl is not None:
                tl.counter(f"chaos.{counter}").inc()
                tl.instant(
                    f"chaos:{counter}", now, cat="chaos", pid="coserve", tid="chaos",
                    args=args,
                )

        self._scripted.append((t, apply))

    def _owner_of(self, ep_idx: int) -> str | None:
        """Allocation truth: which tenant the EP is assigned to."""
        for name, part in self.partitions.items():
            if ep_idx in part:
                return name
        return None

    def _serving_owner_of(self, ep_idx: int) -> str | None:
        """Runtime truth: which lane's *installed* platform contains the EP."""
        for name, part in self._installed.items():
            if ep_idx in part:
                return name
        return None

    # -- elastic re-partitioning --------------------------------------------

    def _load(self, name: str, t: float) -> tuple[float, float]:
        """(observed demand req/s, urgency req/s) for the pricing model.

        Urgency is the service rate needed to clear the requests already
        in the lane within one SLO window — the SLO pressure of the
        backlog a fault (or an exploration stall) has built up.
        """
        lane = self.lanes[name]
        tenant = next(x for x in self.tenants if x.name == name)
        demand = lane._n_arrived / t if t > 0 else 0.0
        in_system = sum(len(st.queue) for st in lane._stages) + sum(
            len(st.batch or []) for st in lane._stages if st.busy
        )
        urgency = in_system / tenant.slo if tenant.slo > 0 else 0.0
        return demand, urgency

    def _pricer(self) -> ElasticPartitioner:
        """Decision-time pricer over the drift-adjusted platform.

        Price on what the hardware can do *now*: a derated EP must not be
        valued as if healthy, so the pricer sees the drift-adjusted
        platform (fresh per decision — its cache is drift-specific).
        """
        return ElasticPartitioner(
            drifted_platform(
                self.platform, EPDerates(factors=tuple(self.global_drift))
            ),
            self.make_evaluator,
            self.heuristic,
            self.elastic_partitioner.headroom,
        )

    def _repartition(self, t: float, dead_ep: int) -> None:
        victim = self._owner_of(dead_ep)
        if victim is None:  # already rebalanced away (duplicate dropout)
            return
        tenants = {x.name: x for x in self.tenants}
        # dead EPs leave every partition: the invariant is that partitions
        # stay disjoint and cover only alive EPs
        self.partitions[victim] = tuple(
            e for e in self.partitions[victim] if e != dead_ep
        )
        loads = {name: self._load(name, t) for name in self.partitions}
        deals, new_parts = self._pricer().rebalance_bundle(
            self.partitions, victim, tenants, loads, max_bundle=self.max_bundle
        )
        donor = stolen = price = None
        affected = [victim]
        gains_lost: dict[str, tuple[list, list]] = {victim: ([], [dead_ep])}
        if deals:
            donor, stolen, price = deals[0]["donor"], deals[0]["ep"], deals[0]["price"]
            for d in deals:
                if d["donor"] not in affected:
                    affected.append(d["donor"])
                gains_lost[victim][0].append(d["ep"])
                gains_lost.setdefault(d["donor"], ([], []))[1].append(d["ep"])
                self.partitions[d["donor"]] = new_parts[d["donor"]]
            self.partitions[victim] = new_parts[victim]
        retune_costs = self._stage_retunes(t, affected, gains_lost)
        event = RepartitionEvent(
            t=t,
            dead_ep=dead_ep,
            victim=victim,
            donor=donor,
            stolen_ep=stolen,
            price=price,
            partitions={k: tuple(v) for k, v in self.partitions.items()},
            retune_costs=retune_costs,
            kind="dropout",
            bundle=tuple(deals),
        )
        self.repartitions.append(event)
        tl = self.telemetry
        if tl is not None:
            tl.counter("coserve.repartitions.dropout").inc()
            tl.counter("coserve.eps_stolen").inc(len(deals))
            tl.instant(
                "repartition",
                t,
                cat="coserve",
                pid="coserve",
                tid="partitioner",
                args={
                    "dead_ep": dead_ep,
                    "victim": victim,
                    "bundle": list(deals),
                    "partitions": {k: list(v) for k, v in self.partitions.items()},
                    "retune_costs": retune_costs,
                },
            )

    def _stage_retunes(
        self,
        t: float,
        affected: Sequence[str],
        gains_lost: dict[str, tuple[list, list]],
    ) -> dict[str, float]:
        """Force-retune every affected lane onto its new partition.

        Shared tail of every partition change (dropout steal or revival
        grant): each lane retargets its tuner, pays a full exploration
        window, and installs atomically — every affected lane installs when
        the *slowest* exploration finishes, so a moved EP is never part of
        two serving platforms at once (the donor keeps it exactly until the
        receiver takes it over).
        """
        tenants = {x.name: x for x in self.tenants}
        retune_costs: dict[str, float] = {}
        staged: list[tuple[str, object, Replatform, dict]] = []
        for name in affected:
            part = self.partitions[name]
            if not part:
                continue  # victim starved and nobody could donate
            lane = self.lanes[name]
            tenant = tenants[name]
            sub = self._sub(tenant, part)
            ldrift = EPDerates(
                factors=tuple(self.global_drift[g] for g in part)
            )
            lane.autotuner.retarget(
                sub, make_evaluator=lambda p, L=tenant.layers: self.make_evaluator(p, L)
            )
            retune = lane.autotuner.force_retune(
                t, ldrift, frozenset(), kind="repartition"
            )
            replat = Replatform(
                evaluator=self.make_evaluator(sub, tenant.layers),
                drift=ldrift,
                dead=frozenset(),
            )
            gained, lost = gains_lost.get(name, ([], []))
            extra = {
                "eps": list(part),
                "gained": gained,
                "lost": lost,
                "explore_wall_s": retune.tuning_cost,
            }
            staged.append((name, retune, replat, extra))
            retune_costs[name] = retune.tuning_cost
        window = max((r.tuning_cost for _, r, _, _ in staged), default=0.0)
        for name, retune, replat, extra in staged:
            synced = dataclasses.replace(retune, tuning_cost=window)
            self.lanes[name]._begin_reconfig(t, synced, replat, extra=extra)
            # same timestamp + kind as the lane's install event but pushed
            # after it, so the refresh runs once the new platform is live:
            # it re-bases the installed mapping and overwrites the decision-
            # time drift/dead snapshot with whatever faults landed during
            # the exploration window
            self.loop.push(
                t + window,
                _RECONFIG,
                self,
                lambda sim, now, n=name, p=self.partitions[name]: sim._finish_install(n, p),
            )
        return retune_costs

    def _revive(self, t: float, ep_idx: int) -> None:
        """Offer a revived global EP to the highest-surplus tenant.

        The revived EP belongs to nobody, so there is no donor side: every
        tenant's *gain* (req/s of at-risk demand the EP would recover,
        priced by the same ElasticPartitioner arithmetic as a dropout
        steal) is its bid, and exactly one tenant wins.  Ties — including
        the all-idle case where every gain is zero — resolve to the tenant
        with the fewest EPs, then the lexicographically first name, so the
        EP always rejoins exactly one partition deterministically.
        """
        if ep_idx in self.global_dead:
            return  # died again before the monitor got to it
        if any(ep_idx in part for part in self.partitions.values()):
            return  # already owned (duplicate revival)
        tenants = {x.name: x for x in self.tenants}
        loads = {name: self._load(name, t) for name in self.partitions}
        pricer = self._pricer()
        # bid tuples end in the unique tenant name, so the sort is total;
        # scanning in name order additionally pins cache-fill order
        bids = sorted(
            (
                -pricer.gain(tenants[name], part, ep_idx, *loads[name]),
                len(part),
                name,
            )
            for name, part in sorted(self.partitions.items())
        )
        neg_gain, _, winner = bids[0]
        # a starved tenant bids inf (it must be re-housed); record that as
        # an unpriced grant so serialized payloads stay strict-JSON clean
        gain = -neg_gain
        self.partitions[winner] = self.partitions[winner] + (ep_idx,)
        retune_costs = self._stage_retunes(
            t, [winner], {winner: ([ep_idx], [])}
        )
        self.repartitions.append(
            RepartitionEvent(
                t=t,
                dead_ep=ep_idx,
                victim=winner,
                donor=None,
                stolen_ep=ep_idx,
                price=None if math.isinf(gain) else gain,
                partitions={k: tuple(v) for k, v in self.partitions.items()},
                retune_costs=retune_costs,
                kind="revival",
            )
        )
        tl = self.telemetry
        if tl is not None:
            tl.counter("coserve.repartitions.revival").inc()
            tl.instant(
                "revival",
                t,
                cat="coserve",
                pid="coserve",
                tid="partitioner",
                args={
                    "ep": ep_idx,
                    "winner": winner,
                    "gain": None if math.isinf(gain) else gain,
                    "retune_costs": retune_costs,
                },
            )

    def _finish_install(self, name: str, part: tuple[int, ...]) -> None:
        self._installed[name] = tuple(part)
        lane = self.lanes[name]
        lane.drift = EPDerates(
            factors=tuple(self.global_drift[g] for g in part)
        )
        lane.dead = {i for i, g in enumerate(part) if g in self.global_dead}

    # -- event handling ------------------------------------------------------

    def _dispatch(self, t: float, kind: int, payload) -> None:
        if kind in (_PLATFORM, _RECONFIG):
            payload(self, t)
        elif kind == _MONITOR:
            self._on_monitor(t, payload)

    def _on_monitor(self, t: float, horizon: float) -> None:
        while self._unhandled_dead or self._unhandled_revived:
            # any lane mid-exploration (or mid-install) defers the decision:
            # a re-partition may touch any lane as donor, and overlapping
            # reconfig windows would install stale configurations
            if any(
                lane._retuning_until > t or lane._stall_until > t
                for lane in self.lanes.values()
            ):
                break
            if self._unhandled_dead:
                dead_ep = self._unhandled_dead.pop(0)
                if dead_ep in self.global_dead:  # not revived in the meantime
                    self._repartition(t, dead_ep)
            else:
                self._revive(t, self._unhandled_revived.pop(0))
        self._refresh_flows(t)
        nxt = t + self.monitor_interval
        if nxt < horizon:
            self.loop.push(nxt, _MONITOR, self, horizon)

    # -- live fabric contention ----------------------------------------------

    def _lane_flows(self, name: str) -> tuple[Flow, ...]:
        """The lane's current steady-state activation flows, in node space.

        A lane with nothing queued or in flight generates no traffic this
        window; otherwise every stage boundary of its serving configuration
        ships its activations once per beat over the global fabric.
        """
        lane = self.lanes[name]
        if not any(st.busy or st.queue for st in lane._stages):
            return ()
        part = self._installed[name]
        conf = lane.conf
        fabric = self.platform.fabric
        bounds = conf.boundaries()
        return tuple(
            Flow(
                src=fabric.node(part[conf.eps[s]]),
                dst=fabric.node(part[conf.eps[s + 1]]),
                nbytes=lane.evaluator.layers[bounds[s][1] - 1].act_bytes,
                nodes=True,
            )
            for s in range(conf.depth - 1)
        )

    def _refresh_flows(self, t: float = 0.0) -> None:
        """Per-window flow injection: each lane serves (and, when
        ``contention_aware``, tunes) against the other lanes' live flows."""
        if self.platform.fabric is None:
            return
        flows = {name: self._lane_flows(name) for name in self.lanes}
        tl = self.telemetry
        if tl is not None:
            tl.counter("coserve.flow_windows").inc()
            tl.gauge("coserve.live_flows").set(sum(len(f) for f in flows.values()))
            for name in sorted(flows):
                if flows[name]:
                    # one span per lane per monitor window: the flow set the
                    # other lanes contend against until the next refresh
                    tl.span(
                        "flow_window",
                        t,
                        self.monitor_interval,
                        cat="fabric",
                        pid=name,
                        tid="flows",
                        args={
                            "n": len(flows[name]),
                            "bytes": sum(f.nbytes for f in flows[name]),
                            "links": [[f.src, f.dst] for f in flows[name]],
                        },
                    )
        for name, lane in self.lanes.items():
            bg = tuple(
                f for other, fl in flows.items() if other != name for f in fl
            )
            lane.set_background_flows(bg)
            lane.autotuner.background_flows = bg if self.contention_aware else ()

    # -- main ---------------------------------------------------------------

    def run(self, horizon: float) -> "CoServeResult":
        # co-simulator monitor first: at equal tick times its re-partition
        # decision must precede (and thereby suppress) lane-local re-tunes
        if self.monitor_interval < horizon:
            self.loop.push(self.monitor_interval, _MONITOR, self, horizon)
        if self.chaos is not None and self.chaos.enabled:
            self._expand_chaos(horizon)
        for t, fn in self._scripted:
            self.loop.push(t, _PLATFORM, self, fn)
        for idx, tenant in enumerate(self.tenants):
            self.lanes[tenant.name].prime(
                tenant.traffic.arrivals(horizon), horizon, tenant=idx
            )
        self.loop.run(horizon)
        results = []
        for tenant in self.tenants:
            lane = self.lanes[tenant.name]
            launch = self._launch[tenant.name]
            results.append(
                TenantResult(
                    tenant=tenant,
                    ep_idxs=self.partitions[tenant.name],
                    conf_pretty=launch["conf_pretty"],
                    model_throughput=launch["model_throughput"],
                    n_trials=launch["n_trials"],
                    sim=lane.result(horizon),
                    batch_policy=launch["batch_policy"],
                )
            )
        return CoServeResult(
            results=results,
            repartitions=self.repartitions,
            partitions={k: tuple(v) for k, v in self.partitions.items()},
            dead=frozenset(self.global_dead),
        )


@dataclasses.dataclass
class CoServeResult:
    """Everything a shared-clock co-simulation run produced."""

    results: list[TenantResult]
    repartitions: list[RepartitionEvent]
    #: final global partitions (alive EPs only)
    partitions: dict[str, tuple[int, ...]]
    dead: frozenset

    @property
    def aggregate_slo_rate(self) -> float:
        arrived = sum(r.sim.n_arrived for r in self.results)
        viol = sum(r.sim.n_slo_violations for r in self.results)
        return viol / arrived if arrived else 0.0

    @property
    def aggregate_throughput_rps(self) -> float:
        return sum(r.sim.throughput_rps for r in self.results)

    @property
    def aggregate_energy_j(self) -> float | None:
        """Total package joules across tenants (None without power models)."""
        vals = [
            r.sim.power["energy_j"] for r in self.results if r.sim.power is not None
        ]
        return sum(vals) if vals else None

    @property
    def joules_per_request(self) -> float | None:
        energy = self.aggregate_energy_j
        done = sum(r.sim.n_completed for r in self.results)
        return energy / done if energy is not None and done else None


def co_serve(
    platform: Platform,
    tenants: Sequence[Tenant],
    *,
    strategy: str = "interleaved",
    horizon: float = 30.0,
    make_evaluator: Callable[[Platform, Sequence[Layer]], AnalyticEvaluator] | None = None,
    heuristic: str = "H3",
    max_batch: int = 4,
    batch_efficiency: float = 0.7,
    elastic: bool = True,
    batch_policy_search: bool = False,
    monitor_interval: float = 0.5,
    measure_batches: int = 8,
    alpha: int = 10,
    contention_aware: bool = True,
    placement: bool = False,
    dvfs: bool = False,
    faults: Sequence[tuple] | None = None,
    telemetry=None,
    max_bundle: int = 1,
    loop: EventLoop | None = None,
    chaos=None,
    resilience=None,
) -> CoServeResult:
    """Partition, tune and co-serve all tenants on one shared clock.

    ``faults`` is a script of ``("slowdown", t, global_ep, factor)``,
    ``("dropout", t, global_ep)``, ``("revival", t, global_ep)`` and
    ``("link", t, u, v, factor)`` entries applied to the global platform.
    ``chaos`` (a :class:`~repro_torch.faults.FaultModel`) additionally expands a
    seeded stochastic fault trace — EP deaths/repairs, correlated domain
    failures, link faults, transient batch errors — over the global
    platform; ``resilience`` (a :class:`~repro_torch.faults.ResiliencePolicy`)
    gives every lane deadlines, retries and load shedding.  ``telemetry``
    (a :class:`~repro_torch.telemetry.Telemetry` session; default off) records
    the whole run — tenants as trace processes, EPs/links as tracks.
    ``max_bundle`` allows a victim under extreme pressure to receive up to
    that many EPs in one priced package deal per repartition.
    """
    co = SharedClockCoSimulator(
        platform,
        tenants,
        strategy=strategy,
        make_evaluator=make_evaluator,
        heuristic=heuristic,
        max_batch=max_batch,
        batch_efficiency=batch_efficiency,
        elastic=elastic,
        batch_policy_search=batch_policy_search,
        monitor_interval=monitor_interval,
        measure_batches=measure_batches,
        alpha=alpha,
        contention_aware=contention_aware,
        placement=placement,
        dvfs=dvfs,
        telemetry=telemetry,
        max_bundle=max_bundle,
        loop=loop,
        chaos=chaos,
        resilience=resilience,
    )
    for fault in faults or ():
        if fault[0] == "slowdown":
            co.schedule_slowdown(fault[1], fault[2], fault[3])
        elif fault[0] == "dropout":
            co.schedule_dropout(fault[1], fault[2])
        elif fault[0] == "revival":
            co.schedule_revival(fault[1], fault[2])
        elif fault[0] == "link":
            co.schedule_link_fault(fault[1], fault[2], fault[3], fault[4])
        else:
            raise ValueError(f"unknown fault kind {fault[0]!r}")
    return co.run(horizon)


def co_schedule(
    platform: Platform,
    tenants: Sequence[Tenant],
    *,
    strategy: str = "interleaved",
    horizon: float = 30.0,
    make_evaluator: Callable[[Platform, Sequence[Layer]], AnalyticEvaluator] | None = None,
    heuristic: str = "H3",
    max_batch: int = 4,
    batch_efficiency: float = 0.7,
) -> list[TenantResult]:
    """Partition, tune each tenant with Shisha, and co-simulate its traffic.

    Fault-free, fixed-partition wrapper over :func:`co_serve` — with no
    faults and no elasticity the shared clock reproduces the per-tenant
    independent simulations exactly (disjoint partitions have no other
    interference channel), so this keeps its original contract.
    """
    return co_serve(
        platform,
        tenants,
        strategy=strategy,
        horizon=horizon,
        make_evaluator=make_evaluator,
        heuristic=heuristic,
        max_batch=max_batch,
        batch_efficiency=batch_efficiency,
        elastic=False,
        batch_policy_search=False,
    ).results


def compare_partitions(
    platform: Platform,
    tenants: Sequence[Tenant],
    strategies: Sequence[str] = PARTITION_STRATEGIES,
    **kwargs,
) -> dict[str, list[TenantResult]]:
    """Run ``co_schedule`` under each partition strategy (same traffic)."""
    return {s: co_schedule(platform, tenants, strategy=s, **kwargs) for s in strategies}
