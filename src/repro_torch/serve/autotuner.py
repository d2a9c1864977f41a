"""Continuous Shisha: drift detection + mid-flight re-tuning.

Static Shisha tunes once against a steady-state oracle and stops; this
module closes the loop the paper's "online" framing implies.  A
:class:`DriftDetector` watches the per-stage times a monitor observes and
classifies drift into the closed :data:`DRIFT_KINDS` set:

  * ``dropout``    — an EP the configuration uses has died (the paper's
                     elastic-rescale case, cf. ``runtime.fault.ElasticScheduler``);
  * ``slowdown``   — a runtime derate (:class:`~repro_torch.pipeline.hetero.EPDerates`)
                     on an in-use EP crossed a threshold (straggler, cf.
                     ``runtime.fault.StragglerMitigator``);
  * ``throttle``   — the derate on an in-use EP *oscillates* (engage /
                     release / re-engage): the signature of hysteretic
                     thermal throttling (:mod:`repro_torch.power.thermal`), not a
                     sick host.  The detector learns this from its bounded
                     per-EP derate history, so the first engagement is
                     conservatively classified as a slowdown;
  * ``link-loss``  — a stage-boundary transfer can no longer complete: an
                     observed stage time is *infinite* while its EP is alive,
                     the signature of fabric link faults severing the route
                     (the chaos layer's :mod:`repro_torch.faults` injects these).
                     Answered with a placement rescue: EPs marooned by the
                     partition are buried like dead ones and Algorithm 2
                     runs with relocation moves forced on, so the stranded
                     stage is re-hosted inside the surviving component;
  * ``imbalance``  — the bottleneck shifted: max/median observed stage time
                     exceeds a threshold even without an attributable derate.

A further kind, ``recovery``, is raised by :class:`ContinuousShisha` itself
when the drift state *eases* (a derate shrinks or a dead EP revives): the
detector only sees degradation, but recovered hardware is worth re-seeding
for — the current schedule was tuned around it.

Responses differ by kind: ``throttle`` takes a cheap fast path — a DVFS
step-down of the hot EPs (one paid measurement, configuration unchanged)
when the platform carries a :class:`~repro_torch.power.PowerModel` with frequency
headroom — because a full Algorithm 2 re-tune would chase a moving target:
the throttle clears as the chiplet cools and re-engages as it reheats.
Every other kind runs the full exploration below.

On drift, :class:`ContinuousShisha` rebuilds its *model* platform (original
EP specs scaled by the observed derates, dead EPs buried at the bottom of
the H_e ranking so Algorithm 1 never picks them), re-runs ``core.tune`` —
warm-starting from the current configuration for slowdowns exactly as the
paper's online regime intends, re-seeding via Algorithm 1 when the current
configuration references a dead EP — and returns a :class:`Retune` that
charges the **full simulated exploration wall-clock** (``Trace.wall``:
reconfiguration overhead plus ``measure_batches`` beats per trial) to the
simulated clock: the old configuration keeps serving, degraded, until the
exploration window elapses, then one reconfiguration ``downtime`` stalls
admission while the new configuration is installed.  Cheap exploration
(Shisha's whole point) translates directly into earlier recovery.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Callable, FrozenSet, Sequence

from ..core.config import PipelineConfig
from ..core.cost_model import Layer, weights as layer_weights
from ..core.evaluator import AnalyticEvaluator, Trace
from ..core.platform import Platform
from ..core.seed import generate_seed
from ..core.tuner import Balancing, TuneResult, tune
from ..pipeline.hetero import EPDerates

#: perf_class used to bury dead EPs at the bottom of Platform.ranked()
_DEAD_CLASS = 99


def drifted_platform(platform: Platform, drift: EPDerates, dead: FrozenSet[int] | set = frozenset()) -> Platform:
    """The scheduler's *model* of the drifted machine.

    Slowed EPs get their compute and bandwidth divided by the drift factor
    and, when slowed >1.25x, are demoted *below every healthy class* (not
    just one step, which would merely tie them with the SEPs when all FEPs
    throttle at once); dead EPs keep their index — so configurations stay
    comparable — but rank last and near-zero, so Algorithm 1 seeds around
    them.
    """
    worst_healthy = max(ep.perf_class for ep in platform.eps)
    eps = []
    for i, ep in enumerate(platform.eps):
        f = drift.factors[i] if i < len(drift.factors) else 1.0
        if i in dead:
            eps.append(
                dataclasses.replace(
                    ep, flops_per_core=1e-9, mem_bw=1e-9, perf_class=_DEAD_CLASS
                )
            )
        elif f > 1.0:
            eps.append(
                dataclasses.replace(
                    ep,
                    flops_per_core=ep.flops_per_core / f,
                    mem_bw=ep.mem_bw / f,
                    perf_class=worst_healthy + 1 if f > 1.25 else ep.perf_class,
                )
            )
        else:
            eps.append(ep)
    return dataclasses.replace(platform, name=f"{platform.name}~drift", eps=tuple(eps))


#: the closed set of drift classifications.  Validated in
#: :meth:`Drift.__post_init__`, so growing the taxonomy (as ``"throttle"``
#: did) is a checked change here rather than a stringly-typed drive-by.
DRIFT_KINDS = frozenset(
    {"dropout", "slowdown", "throttle", "imbalance", "recovery", "link-loss"}
)


@dataclasses.dataclass
class Drift:
    #: one of :data:`DRIFT_KINDS`
    kind: str
    detail: str
    #: EP indices implicated, when attributable per-EP (throttle/slowdown)
    eps: tuple[int, ...] = ()

    def __post_init__(self):
        if self.kind not in DRIFT_KINDS:
            raise ValueError(
                f"unknown drift kind {self.kind!r}; known: {sorted(DRIFT_KINDS)}"
            )


@dataclasses.dataclass
class DriftDetector:
    """Classifies observed stage times + derates into a drift event.

    Bottleneck shift is judged against *expected* stage times (the model's
    prediction for the current configuration), not against the other
    stages: a well-tuned heterogeneous pipeline is legitimately imbalanced
    (a single heavy layer on its own EP), and only deviation from the
    model indicates drift.
    """

    slowdown_threshold: float = 1.3
    imbalance_threshold: float = 1.5
    #: derate samples kept per EP for oscillation (throttle) classification
    throttle_window: int = 6

    def __post_init__(self):
        self._factor_history: dict[int, deque] = {}

    def _record(self, factors: Sequence[float]) -> None:
        for ep, f in enumerate(factors):
            h = self._factor_history.get(ep)
            if h is None:
                h = self._factor_history[ep] = deque(maxlen=self.throttle_window)
            h.append(f)

    def _oscillating(self, ep: int) -> bool:
        """The EP's derate history shows at least one rise AND one fall.

        A step slowdown only ever rises (then holds); hysteretic thermal
        throttling engages, releases, re-engages — the direction reversal
        is its fingerprint.  Needs three samples, so the first engagement
        is conservatively classified as a slowdown: the detector *learns*
        the oscillation.
        """
        h = self._factor_history.get(ep)
        if h is None or len(h) < 3:
            return False
        rose = fell = False
        prev = None
        for f in h:
            if prev is not None:
                if f > prev + 1e-9:
                    rose = True
                elif f < prev - 1e-9:
                    fell = True
            prev = f
        return rose and fell

    def detect(
        self,
        conf: PipelineConfig,
        observed_times: Sequence[float],
        drift: EPDerates,
        dead: FrozenSet[int],
        expected_times: Sequence[float] | None = None,
    ) -> Drift | None:
        self._record(drift.factors)
        dead_in_use = [ep for ep in conf.eps if ep in dead]
        if dead_in_use:
            return Drift("dropout", f"dead EPs in use: {dead_in_use}", eps=tuple(dead_in_use))
        # an infinite observed stage time on a *live* EP means the stage's
        # boundary transfer can never complete: a fabric link fault severed
        # the route (dead EPs were caught above, so this is unambiguous)
        severed = [
            s
            for s, obs in enumerate(observed_times)
            if math.isinf(obs) and conf.eps[s] not in dead
        ]
        if severed:
            return Drift(
                "link-loss",
                f"stage boundaries severed by link faults at stages {severed}",
                eps=tuple(conf.eps[s] for s in severed),
            )
        # a factors tuple may be shorter than the platform (e.g. a stale
        # monitor snapshot after an elastic re-partition grew the EP set);
        # missing entries mean "no derate observed", exactly like
        # drifted_platform's bounds check
        slowed = [
            ep
            for ep in conf.eps
            if (drift.factors[ep] if ep < len(drift.factors) else 1.0)
            > self.slowdown_threshold
        ]
        if slowed:
            throttling = [ep for ep in slowed if self._oscillating(ep)]
            if throttling and len(throttling) == len(slowed):
                return Drift(
                    "throttle",
                    f"oscillating derate on EPs {throttling} (thermal signature)",
                    eps=tuple(throttling),
                )
            return Drift("slowdown", f"derated EPs in use: {slowed}", eps=tuple(slowed))
        if expected_times is not None and len(expected_times) == len(observed_times):
            worst, stage = 1.0, None
            for s, (obs, exp) in enumerate(zip(observed_times, expected_times)):
                if math.isfinite(obs) and exp > 0 and obs / exp > worst:
                    worst, stage = obs / exp, s
            if worst > self.imbalance_threshold:
                return Drift("imbalance", f"stage {stage} at {worst:.2f}x its model time")
        return None


@dataclasses.dataclass
class Retune:
    """Decision handed to the simulator: new conf + its simulated-time cost.

    ``tuning_cost`` is Algorithm 2's exploration wall-clock (``Trace.wall``);
    during that window the pipeline keeps serving on the *old* configuration
    — the paper's measurement batches are real traffic — and only the final
    ``downtime`` (weights shipped to their new EPs) stalls admission.

    ``kind`` is the :data:`DRIFT_KINDS` classification that triggered the
    re-tune — ``"dropout"`` / ``"slowdown"`` / ``"throttle"`` /
    ``"imbalance"`` / ``"recovery"`` — or ``"repartition"`` when an elastic
    co-simulator forced it after moving the EP partition itself (no drift
    event; the schedule is simply for the wrong machine).  A ``"throttle"``
    retune keeps ``conf`` unchanged and carries the stepped-down
    ``dvfs_levels`` instead.
    """

    conf: PipelineConfig
    #: seconds of exploration during which the old conf keeps serving
    tuning_cost: float
    #: seconds of full stall while the new conf is installed
    downtime: float
    kind: str
    model_throughput: float
    tune_result: TuneResult
    #: per-stage max micro-batch found by the batch-knob search (None keeps
    #: the simulator's flat ``max_batch``)
    batch_policy: tuple[int, ...] | None = None
    #: per-EP DVFS level vector to install with the new configuration
    #: (None leaves the power model's current levels in force)
    dvfs_levels: tuple[int, ...] | None = None

    @property
    def cost(self) -> float:
        return self.tuning_cost + self.downtime


def tune_batch_policy(
    trace: Trace,
    conf: PipelineConfig,
    slo: float,
    *,
    batch_efficiency: float = 0.7,
    max_batch_cap: int = 8,
    latency_margin: float = 0.5,
) -> tuple[int, ...]:
    """Per-stage ``max_batch`` search, explored alongside Algorithm 2 moves.

    The simulator serves a batch of ``b`` in ``t_stage * (1 + (b-1) * eff)``,
    so a stage's effective per-request capacity is ``b / batched_t`` — larger
    batches amortise the beat exactly like larger measure batches amortise
    reconfiguration in :class:`~repro_torch.core.evaluator.Trace`, at the price of
    latency.  Starting from all-1, stages are visited bottleneck-first and
    each is granted the largest power-of-two batch whose *full-batch* pipeline
    latency stays within ``latency_margin * slo`` (the remaining margin is
    queueing headroom).  Every knob candidate tried is a real online trial:
    it is charged to ``trace`` (reconfig + fill + ``measure_batches`` beats)
    so the exploration shows up in ``Trace.wall`` like any Algorithm 2 move.
    """
    times = trace.evaluator.stage_times(conf)
    policy = [1] * conf.depth

    def batched(s: int, b: int) -> float:
        return times[s] * (1.0 + (b - 1) * batch_efficiency)

    candidates = []
    b = 2
    while b <= max_batch_cap:
        candidates.append(b)
        b *= 2
    # bottleneck-first: the slowest stage gets latency headroom before the
    # cheap stages spend it (ties broken by stage index for determinism)
    for s in sorted(range(conf.depth), key=lambda i: (-times[i], i)):
        for b in candidates:
            lat = sum(
                batched(i, b if i == s else policy[i]) for i in range(conf.depth)
            )
            if lat > latency_margin * slo:
                break
            trace.execute(conf)  # trying the knob online costs a measurement
            if b / batched(s, b) > policy[s] / batched(s, policy[s]):
                policy[s] = b
    return tuple(policy)


@dataclasses.dataclass
class ContinuousShisha:
    """The ``observe()`` hook a :class:`~repro_torch.serve.simulator.ServingSimulator` polls.

    Re-tunes at most once per distinct drift state (fingerprinted by the
    derate vector + dead set) and not more often than ``cooldown`` simulated
    seconds, so a persistent derate does not trigger a re-tune storm.
    """

    platform: Platform
    layers: Sequence[Layer]
    #: model-evaluator factory for the tuner's Trace (e.g. DatabaseEvaluator)
    make_evaluator: Callable[[Platform], AnalyticEvaluator] | None = None
    detector: DriftDetector = dataclasses.field(default_factory=DriftDetector)
    alpha: int = 10
    balancing: Balancing = "nlfep"
    #: charged once on top of Trace.wall when the new conf is installed
    reconfig_downtime: float = 0.05
    #: minimum simulated seconds between re-tunes
    cooldown: float = 1.0
    measure_batches: int = 8
    reconfig_overhead: float = 0.05
    #: when set, every re-tune also runs the per-stage batch-knob search
    #: (:func:`tune_batch_policy`) against this latency SLO, charging the
    #: extra trials to the same exploration window
    slo: float | None = None
    batch_policy_search: bool = False
    max_batch_cap: int = 8
    batch_efficiency: float = 0.7
    batch_latency_margin: float = 0.5
    #: enable Algorithm 2's fabric-aware EP-relocation moves in re-tunes
    placement: bool = False
    #: explore per-EP DVFS levels in re-tunes (needs a platform power
    #: model); independent of the throttle fast path, which only needs the
    #: power model itself
    dvfs: bool = False
    #: live co-tenant flow set (node-space) the *model* evaluator prices
    #: transfers against — set by a contention-aware co-simulator each
    #: monitor window; empty = contention-blind tuning
    background_flows: tuple = ()
    #: live telemetry session or None, normally attached by the owning
    #: :class:`~repro_torch.serve.simulator.ServingSimulator`; handed to every
    #: exploration :class:`~repro_torch.core.evaluator.Trace` so each paid trial
    #: records its charged wall cost and move kind
    telemetry: "object | None" = None

    def __post_init__(self):
        if self.make_evaluator is None:
            self.make_evaluator = lambda p: AnalyticEvaluator(p, self.layers)
        self._last_t = -math.inf
        # start from the no-drift state so the intrinsic imbalance of a
        # freshly tuned heterogeneous pipeline never triggers a re-tune
        self._handled: tuple = (
            (1.0,) * self.platform.n_eps,
            frozenset(),
            self._fabric_key(),
        )
        self._model_ev = self.make_evaluator(self.platform)
        self.history: list[Retune] = []
        #: kind of the last response issued; a throttle's subsequent easing
        #: is the step-down working, not hardware worth re-seeding for
        self._last_kind: str | None = None

    def _fabric_key(self) -> tuple:
        """Canonical link-fault state of the platform fabric (``()`` healthy).

        Folded into the drift fingerprint: a link failure changes neither
        the derate vector nor the dead set, so without this the tuner would
        be blind to the one drift class that lives in the fabric.
        """
        fabric = self.platform.fabric
        return fabric.fault_fingerprint() if fabric is not None else ()

    def observe(
        self,
        t: float,
        conf: PipelineConfig,
        observed_times: Sequence[float],
        drift: EPDerates,
        dead: FrozenSet[int],
    ) -> Retune | None:
        fingerprint = (drift.factors, frozenset(dead), self._fabric_key())
        if fingerprint == self._handled:
            return None
        expected = self._model_ev.stage_times(conf)
        event = self.detector.detect(conf, observed_times, drift, dead, expected)
        if event is None:
            # the detector only sees degradation; an *easing* fingerprint
            # (derate shrank, dead EP revived, link healed) is a chance to
            # reclaim hardware the current schedule tuned around
            prev_factors, prev_dead, prev_links = self._handled
            eased = any(
                f < pf - 1e-9 for f, pf in zip(drift.factors, prev_factors)
            )
            revived = bool(set(prev_dead) - set(dead))
            cur_links = dict(fingerprint[2])
            healed = any(
                cur_links.get(k, 1.0) > f for k, f in sorted(dict(prev_links).items())
            )
            if (eased or revived) and self._last_kind == "throttle" and not revived:
                # expected easing: the DVFS step-down (or the cooling it
                # bought) cleared the throttle derate — re-seeding for it
                # would thrash against the thermal cycle
                self._handled = fingerprint
                return None
            if eased or revived or healed:
                event = Drift("recovery", "platform sped up; re-seeding to reclaim it")
        if event is None:
            # benign drift (e.g. an unused EP derated): remember and move on
            self._handled = fingerprint
            return None
        if t - self._last_t < self.cooldown:
            return None
        if event.kind == "throttle":
            retune = self._dvfs_stepdown(event, drift, dead, conf)
            if retune is not None:
                self._last_t = t
                self._handled = fingerprint
                self._last_kind = "throttle"
                return retune
            # no power model or no frequency headroom left: fall through to
            # the full re-tune, which can move work off the hot chiplet
        explore_dead = frozenset(dead)
        if event.kind == "link-loss" and self.platform.fabric is not None:
            # placement rescue: EPs marooned outside the main fabric
            # component are buried like dead ones, so the seed and every
            # relocation move avoid them until the link heals
            explore_dead = explore_dead | frozenset(self.platform.fabric.marooned_eps())
        retune = self._explore(drift, explore_dead, event.kind, warm_conf=conf)
        self._last_t = t
        self._handled = fingerprint
        self._last_kind = event.kind
        return retune

    def _dvfs_stepdown(
        self,
        event: Drift,
        drift: EPDerates,
        dead: FrozenSet[int],
        warm_conf: PipelineConfig,
    ) -> Retune | None:
        """Throttle fast path: drop the hot EPs one DVFS level.

        One paid measurement at the new clocks instead of a full Algorithm 2
        exploration — the configuration is untouched, only the frequency
        vector moves.  Returns None (caller escalates to :meth:`_explore`)
        when the platform has no power model or every implicated EP is
        already at its floor.
        """
        pm = self.platform.power
        if pm is None:
            return None
        hot = [ep for ep in event.eps if ep < pm.n_eps and pm.can_step_down(ep)]
        if not hot:
            return None
        # price the step-down on a model where the throttle derate on the
        # stepped EPs is cleared — removing it is the point of stepping down
        hot_set = set(hot)
        relieved = EPDerates(
            factors=tuple(
                1.0 if i in hot_set else f for i, f in enumerate(drift.factors)
            )
        )
        model = drifted_platform(self.platform, relieved, dead)
        model_ev = self.make_evaluator(model)
        if self.background_flows and model.fabric is not None:
            model_ev.background_flows = tuple(self.background_flows)
        trace = Trace(
            model_ev,
            measure_batches=self.measure_batches,
            reconfig_overhead=self.reconfig_overhead,
            telemetry=self.telemetry,
        )
        for ep in hot:
            pm.set_level(ep, pm.level(ep) + 1)
        tp = trace.execute(warm_conf)  # one paid measurement at the new clocks
        tl = self.telemetry
        if tl is not None and tl.enabled:
            tl.counter("tune.moves.dvfs_down").inc(len(hot))
        levels = pm.snapshot()
        result = TuneResult(
            best_conf=warm_conf,
            best_throughput=tp,
            n_explored=trace.n_trials,
            final_conf=warm_conf,
            dvfs_levels=levels,
        )
        self._model_ev = model_ev
        retune = Retune(
            conf=warm_conf,
            tuning_cost=trace.wall,
            downtime=self.reconfig_downtime,
            kind="throttle",
            model_throughput=tp,
            tune_result=result,
            dvfs_levels=levels,
        )
        self.history.append(retune)
        return retune

    def _explore(
        self,
        drift: EPDerates,
        dead: FrozenSet[int],
        kind: str,
        warm_conf: PipelineConfig | None = None,
    ) -> Retune:
        """Run Algorithm 2 (plus the batch-knob search) on the drift model."""
        model = drifted_platform(self.platform, drift, dead)
        model_ev = self.make_evaluator(model)
        if self.background_flows and model.fabric is not None:
            # contention-aware: the model prices transfers under the live
            # co-tenant flow set, so exploration sees congested links as
            # slow and routes/places around them
            model_ev.background_flows = tuple(self.background_flows)
        trace = Trace(
            model_ev,
            measure_batches=self.measure_batches,
            reconfig_overhead=self.reconfig_overhead,
            telemetry=self.telemetry,
        )
        # a link-loss rescue *must* be allowed to relocate stages — boundary
        # moves alone can never re-host a stage marooned across a dead link
        placement = self.placement or kind == "link-loss"
        if kind in ("dropout", "recovery", "repartition", "link-loss") or warm_conf is None:
            # re-seed via Algorithm 1: a warm start cannot drop a dead (or
            # marooned) EP's stage by itself, nor grow stages onto recovered
            # (or newly granted) hardware
            n_alive = model.n_eps - len(dead)
            if n_alive < 1:
                raise RuntimeError("all EPs dead; nothing to schedule onto")
            seed = generate_seed(
                layer_weights(self.layers),
                model,
                n_stages=min(n_alive, len(self.layers)),
                choice="rank_w",
            )
            result = tune(
                seed,
                trace,
                alpha=self.alpha,
                balancing=self.balancing,
                placement=placement,
                placement_exclude=frozenset(dead),
                dvfs=self.dvfs,
            )
        else:
            # warm start from the serving configuration (paper's online mode)
            result = tune(
                warm_conf,
                trace,
                alpha=self.alpha,
                balancing=self.balancing,
                placement=placement,
                placement_exclude=frozenset(dead),
                dvfs=self.dvfs,
            )
        policy = None
        if self.batch_policy_search and self.slo is not None:
            policy = tune_batch_policy(
                trace,
                result.best_conf,
                self.slo,
                batch_efficiency=self.batch_efficiency,
                max_batch_cap=self.max_batch_cap,
                latency_margin=self.batch_latency_margin,
            )
        self._model_ev = trace.evaluator  # new model baseline for drift checks
        retune = Retune(
            conf=result.best_conf,
            tuning_cost=trace.wall,
            downtime=self.reconfig_downtime,
            kind=kind,
            model_throughput=result.best_throughput,
            tune_result=result,
            batch_policy=policy,
            dvfs_levels=result.dvfs_levels,
        )
        self.history.append(retune)
        return retune

    def retarget(
        self,
        platform: Platform,
        make_evaluator: Callable[[Platform], AnalyticEvaluator] | None = None,
    ) -> None:
        """Point the tuner at a new (sub-)platform after a re-partition.

        The drift fingerprint baseline resets to the new platform's no-drift
        state; callers that immediately :meth:`force_retune` will overwrite
        it with the actual observed state.
        """
        self.platform = platform
        if make_evaluator is not None:
            self.make_evaluator = make_evaluator
        self._handled = ((1.0,) * platform.n_eps, frozenset(), self._fabric_key())
        self._model_ev = self.make_evaluator(platform)

    def force_retune(
        self,
        t: float,
        drift: EPDerates,
        dead: FrozenSet[int],
        kind: str = "repartition",
    ) -> Retune:
        """Unconditional re-seed + tune, bypassing the detector and cooldown.

        Used by the elastic multi-tenant co-simulator after a partition
        change: the EP set itself moved, so there is no drift *event* to
        detect — the schedule is simply for the wrong machine.  The full
        ``Trace.wall`` exploration cost is returned on the Retune for the
        caller to charge to its clock.
        """
        retune = self._explore(drift, dead, kind)
        self._last_t = t
        self._handled = (drift.factors, frozenset(dead), self._fabric_key())
        self._last_kind = kind
        return retune
