"""Discrete-event serving simulator for Shisha-scheduled pipelines.

The simulator drives a pipeline *configuration* (``PipelineConfig`` mapped
onto a ``Platform``) under live traffic and measures what the steady-state
oracle cannot: queueing delay, tail latency, SLO violations and the cost of
re-tuning while requests are in flight.

Model (paper terms in parentheses):

  * Each stage is a FIFO queue in front of its EP (chiplet).  Serving one
    request through a stage takes the evaluator's ``stage_times(conf)[s]``
    (the stage's share of the pipeline *beat*), optionally scaled by a
    runtime drift factor per EP (:class:`~repro_torch.pipeline.hetero.EPDerates`
    — thermal throttling, sick host, shared-link neighbour).
  * Micro-batching: a stage may serve up to ``max_batch`` queued requests
    in one go; a batch of ``b`` takes ``t_stage * (1 + (b-1) *
    batch_efficiency)`` — ``batch_efficiency=1`` is pure serialisation,
    smaller values model amortised weight-streaming exactly like larger
    measure batches amortise reconfiguration in ``Trace``.
  * Faults are scripted on the simulated clock: ``schedule_slowdown`` (EP
    derate, the Fig. 9-style heterogeneity drift) and ``schedule_dropout``
    (EP death — its stage blocks and queues grow until a re-tune).
  * When the platform carries an interconnect fabric
    (:class:`~repro_torch.interconnect.Fabric`), stage times include routed,
    contention-priced transfers; a co-simulator feeds each lane the other
    tenants' live activation flows every monitor window
    (:meth:`ServingSimulator.set_background_flows`), so co-tenant traffic
    congests shared links *on the event loop*, not just at tuning time.
  * Re-tuning (continuous Shisha, ``autotuner.py``) is observed through
    periodic monitor events.  When the autotuner decides to re-tune, the
    simulator *charges the full exploration wall-clock of Algorithm 2*
    (``Trace.wall`` — reconfiguration overhead plus ``measure_batches``
    beats per trial) to the simulated clock: the old configuration keeps
    serving (degraded) for that window, because the paper's measurement
    batches are real traffic, then the new configuration is installed
    under a short admission stall during which in-flight work is cancelled
    and mid-pipeline requests restart from stage 0 (drain-and-restart).
    This is exactly the online-cost regime Shisha is designed for — an
    expensive explorer would serve degraded for far longer before
    recovering.

  * When the platform carries a power model
    (:class:`~repro_torch.power.PowerModel`), the simulator integrates energy on
    the simulated clock — dynamic joules over each EP's busy time, static
    leakage over the whole window — and, if a thermal model is attached,
    steps the per-chiplet RC nodes once per monitor window.  A chiplet that
    crosses its hot threshold throttles (stage times derate) until it
    cools; the throttle derate composes with the fault drift in the vector
    the autotuner observes, which is how ``"throttle"`` drift reaches the
    :class:`~repro_torch.serve.autotuner.DriftDetector`.  Results gain a
    ``power`` block (joules/request, peak package watts); telemetry gains
    ``power.*``/``thermal.*`` metrics and per-chiplet temperature counter
    tracks.

Determinism: the simulator owns no randomness at all; all stochasticity
lives in the seeded ``traffic`` generators, so a (traffic, scenario) pair
replays bit-identically.

Event engine: :class:`EventLoop` is a drain-sorted engine (sort-once
buffers consumed in place, a small near heap for in-flight completions,
bulk arrival priming) that dispatches ~5x faster than the legacy binary
heap while preserving the ``(time, kind, push-order)`` contract exactly;
:class:`HeapEventLoop` keeps the legacy engine as the executable
reference and ``tests/test_torch_serve.py`` pins the two bit-for-bit.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from bisect import bisect_right
from collections import deque
from typing import Callable, Sequence

from ..core.config import PipelineConfig
from ..core.evaluator import AnalyticEvaluator
from ..pipeline.hetero import EPDerates
from ..telemetry import live
from ..telemetry.tracer import TraceEvent

# event kinds, in tie-break priority order at equal timestamps
_ARRIVAL, _DONE, _PLATFORM, _MONITOR, _RECONFIG = range(5)


class EventLoop:
    """Drain-sorted discrete-event engine, shareable by several pipelines.

    Every event carries its *owner* (the pipeline — or co-simulator — whose
    ``_dispatch`` handles it), so N tenants can advance on one clock: this
    is what makes the multi-tenant simulation a true co-simulation rather
    than N independent replays.  The monotonically increasing sequence
    number both breaks timestamp ties deterministically (push order) and
    guarantees owners are never compared by tuple ordering.

    Engine: events are plain ``(t, kind, seq, owner, payload)`` tuples in
    three structures instead of one big binary heap —

      * ``_staged`` — unsorted append-only list of events at or past the
        drain buffer's tail.  Every pre-run push lands here, and a bulk
        :meth:`push_batch` (arrival priming) is one C-level ``extend``.
      * ``_drain``  — the staged list, sorted **once** when the previous
        drain empties and then consumed *in place* by index (``_i``): a
        dispatch costs one list index instead of a log-N heap sift, and
        the records themselves are reused as the buffer (no copy).
      * ``_near``   — a small binary heap for events that sort *below* the
        drain tail, pushed while the drain is being consumed (in-flight
        ``_DONE`` completions, chained monitor ticks).  The hot loop
        interleaves it with the drain at one tuple compare per dispatch;
        with nothing in flight the check is a single truthiness test.

    Dispatch order is exactly the legacy heap engine's ``(time, kind,
    push-order)`` contract: at every step the dispatched event is the
    minimum over all live events, because staged events are by
    construction ``>=`` the whole undispatched drain and ``_near`` holds
    everything smaller.  :class:`HeapEventLoop` keeps the old engine as
    the executable reference; ``tests/test_torch_serve.py`` pins the two
    bit-for-bit against each other on every simulator layer.

    Windowed runs: ``run(h)`` *peeks* before consuming, so an event past
    the horizon stays queued and successive ``run(h1), run(h2), ...``
    calls dispatch exactly what a single ``run(h_max)`` would.  (The
    legacy engine popped the first beyond-horizon event before breaking,
    silently dropping it for windowed callers — fixed in both engines.)
    """

    def __init__(self, telemetry=None):
        self._seq = 0
        self._staged: list = []
        self._drain: list = []
        self._i = 0  # next undispatched index into _drain
        self._near: list = []
        #: events dispatched over the loop's lifetime — the denominator of
        #: ``benchmarks/selfbench.py``'s simulated-events/sec figure
        self.n_dispatched = 0
        #: live telemetry session or None; when live, ``run`` keeps
        #: ``telemetry.now`` on the simulated clock and wall-profiles the
        #: dispatch loop under the ``event_loop.run`` scope
        self.telemetry = live(telemetry)

    def push(self, t: float, kind: int, owner, payload) -> None:
        self._seq += 1
        ev = (t, kind, self._seq, owner, payload)
        drain = self._drain
        # an event sorting below the active drain's tail must interleave
        # with it (the near heap); anything else waits in staged until the
        # next refill sort.  seq is unique, so the tuple compare never
        # reaches `owner`.
        if self._i < len(drain) and ev < drain[-1]:
            heapq.heappush(self._near, ev)
        else:
            self._staged.append(ev)

    def push_batch(self, times: Sequence[float], kind: int, owner, payloads: Sequence) -> None:
        """Push ``zip(times, payloads)`` sharing one kind/owner, in order.

        Equivalent to ``len(payloads)`` sequential :meth:`push` calls —
        same contiguous seq numbering, same dispatch order — minus the
        per-call overhead: outside an active drain (the arrival-priming
        case) the whole batch is one list ``extend``.
        """
        if self._i < len(self._drain):
            for t, p in zip(times, payloads):
                self.push(t, kind, owner, p)
            return
        seq = self._seq
        self._staged.extend(
            (t, kind, s, owner, p)
            for s, (t, p) in enumerate(zip(times, payloads), seq + 1)
        )
        self._seq = seq + len(payloads)

    def __len__(self) -> int:
        """Events still queued (staged + undispatched drain + near)."""
        return len(self._staged) + (len(self._drain) - self._i) + len(self._near)

    def run(self, horizon: float) -> None:
        """Dispatch events in (time, kind, push-order) order up to horizon.

        Peeks before consuming: an event past ``horizon`` stays queued, so
        windowed/incremental callers never lose it.
        """
        tl = self.telemetry
        if tl is None:
            self._advance(horizon, None)
            return
        with tl.timed("event_loop.run"):
            self._advance(horizon, tl)

    def _advance(self, horizon: float, tl) -> None:
        near = self._near
        heappop = heapq.heappop
        dispatched = 0
        try:
            while True:
                drain = self._drain
                i = self._i
                if i >= len(drain):
                    staged = self._staged
                    if staged:
                        # the staged list *becomes* the drain in place:
                        # one sort, no copy, no per-event bookkeeping
                        staged.sort()
                        self._drain = drain = staged
                        self._staged = []
                        self._i = i = 0
                    elif near:
                        # stragglers routed behind a now-exhausted drain
                        if near[0][0] > horizon:
                            break
                        t, kind, _seq, owner, payload = heappop(near)
                        dispatched += 1
                        if tl is not None:
                            tl.now = t
                        owner._dispatch(t, kind, payload)
                        continue
                    else:
                        break
                cut = (
                    len(drain)
                    if horizon == math.inf
                    else bisect_right(drain, (horizon, math.inf))
                )
                if cut <= i:
                    # rest of the drain is beyond the horizon: flush near
                    # events still inside it (all sort below drain[i]),
                    # then leave everything else queued
                    while near and near[0][0] <= horizon:
                        t, kind, _seq, owner, payload = heappop(near)
                        dispatched += 1
                        if tl is not None:
                            tl.now = t
                        owner._dispatch(t, kind, payload)
                    break
                if tl is None:
                    try:
                        while i < cut:
                            ev = drain[i]
                            if near and near[0] < ev:
                                ev = heappop(near)
                            else:
                                i += 1
                            t, kind, _seq, owner, payload = ev
                            owner._dispatch(t, kind, payload)
                            dispatched += 1
                    finally:
                        self._i = i
                else:
                    try:
                        while i < cut:
                            ev = drain[i]
                            if near and near[0] < ev:
                                ev = heappop(near)
                            else:
                                i += 1
                            t, kind, _seq, owner, payload = ev
                            tl.now = t
                            owner._dispatch(t, kind, payload)
                            dispatched += 1
                    finally:
                        self._i = i
        finally:
            self.n_dispatched += dispatched


class HeapEventLoop:
    """The legacy binary-heap engine, kept as the executable reference.

    Same API and — pinned by the equivalence suite — the same dispatch
    sequence as :class:`EventLoop`, paying one heap sift per event.  Use
    it to cross-check engine changes bit-for-bit
    (``tests/test_torch_serve.py``, ``benchmarks/selfbench.py``'s legacy
    arms) or to bisect a suspected engine bug.  The historical
    beyond-horizon bug is fixed here too: ``run`` peeks at the heap head
    before popping, so windowed callers never lose an event.
    """

    def __init__(self, telemetry=None):
        self._heap: list = []
        self._seq = 0
        self.n_dispatched = 0
        self.telemetry = live(telemetry)

    def push(self, t: float, kind: int, owner, payload) -> None:
        self._seq += 1
        heapq.heappush(self._heap, (t, kind, self._seq, owner, payload))

    def push_batch(self, times: Sequence[float], kind: int, owner, payloads: Sequence) -> None:
        for t, p in zip(times, payloads):
            self.push(t, kind, owner, p)

    def __len__(self) -> int:
        return len(self._heap)

    def run(self, horizon: float) -> None:
        """Dispatch events in (time, kind, push-order) order up to horizon."""
        tl = self.telemetry
        heap = self._heap
        heappop = heapq.heappop
        if tl is None:
            while heap and heap[0][0] <= horizon:
                t, kind, _seq, owner, payload = heappop(heap)
                self.n_dispatched += 1
                owner._dispatch(t, kind, payload)
            return
        with tl.timed("event_loop.run"):
            while heap and heap[0][0] <= horizon:
                t, kind, _seq, owner, payload = heappop(heap)
                self.n_dispatched += 1
                tl.now = t
                owner._dispatch(t, kind, payload)


# slots: requests and stages are the per-event hot allocations (one Request
# per arrival, its fields written on every stage hop) — no per-instance dict
@dataclasses.dataclass(slots=True)
class Request:
    rid: int
    t_arrival: float
    tenant: int = 0
    t_start: float = math.nan  # first time any stage began serving it
    t_done: float = math.nan
    #: times this request's batch has errored and been re-served (chaos)
    attempts: int = 0

    @property
    def latency(self) -> float:
        return self.t_done - self.t_arrival


@dataclasses.dataclass(slots=True)
class _Stage:
    queue: deque
    busy: bool = False
    token: int = 0  # bumped to invalidate in-flight completions (cancel)
    batch: list | None = None
    service_dt: float = 0.0


def percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Deterministic nearest-rank percentile (q in [0,1])."""
    if not sorted_vals:
        return math.nan
    idx = max(0, math.ceil(q * len(sorted_vals)) - 1)
    return sorted_vals[idx]


def slo_violation_rate(latencies: Sequence[float], slo: float) -> float:
    """Fraction of completed requests whose latency exceeds ``slo``."""
    if not latencies:
        return 0.0
    return sum(1 for l in latencies if l > slo) / len(latencies)


def _requeue(stage: int, r: Request) -> Callable:
    """Platform-event closure re-admitting ``r`` after a retry backoff.

    If a reconfiguration shrank the pipeline while the retry waited, the
    original stage index may no longer exist — the request then restarts
    from stage 0, exactly like drain-and-restart displaces it.
    """

    def apply(sim: "ServingSimulator", now: float) -> None:
        s = stage if stage < len(sim._stages) else 0
        sim._stages[s].queue.append(r)
        sim._try_start(s, now)

    return apply


def _chaos_event(ev) -> Callable:
    """Bind a :class:`~repro_torch.faults.FaultEvent` to its simulator effect."""
    if ev.kind == "dropout":
        return lambda sim, now: sim._chaos_dropout(ev.ep, now)
    if ev.kind == "revival":
        return lambda sim, now: sim._chaos_revival(ev.ep, now)
    return lambda sim, now: sim._chaos_link(ev.link[0], ev.link[1], ev.factor, now)


@dataclasses.dataclass
class SimResult:
    horizon: float
    slo: float
    n_arrived: int
    n_completed: int
    n_in_flight: int
    n_queued: int
    latencies: list[float]
    throughput_rps: float
    #: nearest-rank latency percentiles; None (not NaN — results must stay
    #: strict-JSON) when nothing completed, e.g. every EP dead at t=0
    p50: float | None
    p95: float | None
    p99: float | None
    #: p95 of time from arrival to first service start (pure queueing delay)
    p95_wait: float | None
    #: completed-late requests PLUS requests still in the system at the
    #: horizon that have already outlived the SLO — censoring the backlog
    #: would flatter an arm that stalls and completes nothing
    n_slo_violations: int
    #: n_slo_violations / n_arrived
    slo_rate: float
    #: EP name -> fraction of the horizon the EP spent serving
    occupancy: dict[str, float]
    #: one entry per re-tune: {t, kind, cost_s, new_depth, model_throughput}
    reconfigs: list[dict]
    #: (t, queued + in-flight) sampled at every monitor tick
    load_samples: list[tuple[float, int]]
    #: energy/thermal accounting when the platform carries a power model
    #: (energy_j, joules_per_request, peak_package_w, avg_package_w, cap_w,
    #: throttle_events, max_temp_c, dvfs_levels); None otherwise
    power: dict | None = None
    #: completions that also met their deadline, per second — equals
    #: ``throughput_rps`` when no resilience policy sets a deadline
    goodput_rps: float = 0.0
    #: arrivals turned away or expired in queue (load shedding)
    n_shed: int = 0
    #: requests dropped after exhausting their retry budget
    n_failed: int = 0
    #: batch-error re-serves (each member request counts once per re-serve)
    n_retries: int = 0
    #: 1 - (shed + failed) / arrived — the fraction of offered load the
    #: service answered at all
    availability: float = 1.0

    def summary(self) -> str:
        def ms(x: float | None) -> str:
            return "n/a" if x is None else f"{x * 1e3:.0f}ms"

        return (
            f"arrived={self.n_arrived} done={self.n_completed} "
            f"tp={self.throughput_rps:.1f}/s p50={ms(self.p50)} "
            f"p95={ms(self.p95)} p99={ms(self.p99)} "
            f"slo_viol={self.slo_rate * 100:.1f}% reconfigs={len(self.reconfigs)}"
        )


class ServingSimulator:
    """Event-driven pipeline server over an evaluator's stage-time model.

    ``evaluator`` is the ground truth (the "hardware"): stage times come
    from it and are scaled by the runtime drift factors the fault scenario
    injects.  The autotuner never sees the ground truth directly — only
    the observed per-stage times at monitor ticks, mirroring the paper's
    online measure-then-move loop.
    """

    def __init__(
        self,
        evaluator: AnalyticEvaluator,
        conf: PipelineConfig,
        *,
        max_batch: int = 4,
        batch_efficiency: float = 0.7,
        slo: float = 1.0,
        monitor_interval: float = 0.5,
        autotuner=None,
        batch_policy: Sequence[int] | None = None,
        loop: EventLoop | None = None,
        telemetry=None,
        label: str = "serve",
        resilience=None,
    ):
        self.evaluator = evaluator
        self.conf = conf
        self.max_batch = max(1, max_batch)
        self.batch_efficiency = batch_efficiency
        self.slo = slo
        self.monitor_interval = monitor_interval
        self.autotuner = autotuner
        #: per-stage max micro-batch; defaults to a flat ``max_batch``
        self.batch_policy = self._policy(batch_policy, conf.depth)
        #: the event heap — private by default, shared under co-simulation
        self.loop = loop if loop is not None else EventLoop()
        #: lane name: telemetry metric prefix and trace process (the tenant)
        self.label = label
        #: live telemetry session or None (``NULL`` normalizes to None, so
        #: every per-event guard below is one ``is not None`` check)
        self.telemetry = live(telemetry)
        if self.telemetry is not None:
            if self.loop.telemetry is None:
                self.loop.telemetry = self.telemetry
            fabric = evaluator.platform.fabric
            if fabric is not None:
                fabric.telemetry = self.telemetry
            if autotuner is not None and getattr(autotuner, "telemetry", None) is None:
                autotuner.telemetry = self.telemetry

        n_eps = evaluator.platform.n_eps
        self.drift = EPDerates(factors=(1.0,) * n_eps)
        self.dead: set[int] = set()
        self._base_times = list(evaluator.stage_times(conf))
        self._stages = [_Stage(queue=deque()) for _ in range(conf.depth)]
        self._stall_until = -math.inf
        self._retuning_until = -math.inf
        self._epoch = 0  # bumped per reconfig; invalidates pre-reconfig _DONEs
        self._busy_time = [0.0] * n_eps
        #: occupancy folded in from platforms served before a re-partition,
        #: keyed by EP name (names are global, indices are not)
        self._busy_prev: dict[str, float] = {}
        self._completed: list[Request] = []
        self._n_arrived = 0
        self._reconfigs: list[dict] = []
        self._load_samples: list[tuple[float, int]] = []
        self._scripted: list[tuple[float, Callable]] = []
        #: request-level :class:`~repro_torch.faults.ResiliencePolicy` or None
        #: (None = the pre-chaos blind lane, bit-for-bit)
        self.resilience = resilience
        #: seeded per-lane Bernoulli stream of transient batch errors,
        #: installed by ``prime`` when the platform carries a fault model
        self._batch_faults = None
        self._n_shed = 0
        self._n_failed = 0
        self._n_retries = 0
        #: attached power model or None; energy integrates over monitor
        #: windows (dynamic joules over busy seconds, leakage over the
        #: whole window), thermal nodes step on the same cadence
        self.power = evaluator.platform.power
        self._thermal_factors: list[float] | None = None
        self._init_power_state(n_eps)
        self._bind_metrics()

    def _init_power_state(self, n_eps: int) -> None:
        self._last_power_t = 0.0
        self._energy_j = 0.0
        self._peak_w = 0.0
        self._max_temp_c: float | None = None
        self._throttle_events = 0
        self._busy_since_tick = [0.0] * n_eps
        pm = self.power
        if pm is not None and pm.thermal is not None:
            self._thermal_factors = [pm.thermal.factor(e) for e in range(n_eps)]
        else:
            self._thermal_factors = None

    def _bind_metrics(self) -> None:
        """Pre-resolve the hot-path metric handles and track labels.

        The per-event cost of recording is then one attribute load + method
        call instead of an f-string build and a registry lookup — the serve
        benchmark's instrumented/bare ratio is pinned by a floor test on
        this staying cheap.  Handles are label-keyed and stable; the
        per-stage track labels depend on the configuration and are rebuilt
        on every install (see ``_apply_reconfig``).
        """
        tl = self.telemetry
        if tl is None:
            return
        label = self.label
        #: direct append target for the per-batch/per-request span rows —
        #: identical TraceEvent records, minus two delegation layers per
        #: event (Telemetry.span -> SpanTracer.span -> append)
        self._trace_append = tl.tracer.events.append
        self._m_batch_size = tl.histogram(f"{label}.batch_size")
        self._m_arrivals = tl.counter(f"{label}.arrivals")
        self._m_slo_hit = tl.counter(f"{label}.slo.hit")
        self._m_slo_miss = tl.counter(f"{label}.slo.miss")
        self._m_latency = tl.histogram(f"{label}.latency_s")
        self._m_queue_depth = tl.histogram(f"{label}.queue_depth")
        self._m_in_system = tl.gauge(f"{label}.in_system")
        self._bind_stage_tracks()

    def _bind_stage_tracks(self) -> None:
        #: (span name, EP track) per stage of the current configuration
        self._stage_tracks = [
            (f"stage{s}", f"ep{e}") for s, e in enumerate(self.conf.eps)
        ]

    def _policy(self, policy: Sequence[int] | None, depth: int) -> tuple[int, ...]:
        if policy is None:
            return (self.max_batch,) * depth
        if len(policy) != depth or any(b < 1 for b in policy):
            raise ValueError(f"need {depth} positive batch caps, got {policy}")
        return tuple(policy)

    # -- scenario scripting -------------------------------------------------

    def schedule_slowdown(self, t: float, ep_idx: int, factor: float) -> None:
        """At time ``t`` the EP becomes ``factor``x slower (drift derate)."""
        self._scripted.append(
            (t, lambda sim, now: sim.apply_slowdown(ep_idx, factor))
        )

    def schedule_dropout(self, t: float, ep_idx: int) -> None:
        """At time ``t`` the EP dies: its stage blocks, in-flight work is lost."""
        self._scripted.append((t, lambda sim, now: sim.apply_dropout(ep_idx)))

    def schedule_revival(self, t: float, ep_idx: int) -> None:
        """At time ``t`` a dead EP comes back; its stages may serve again."""
        self._scripted.append((t, lambda sim, now: sim.apply_revival(ep_idx, now)))

    def schedule_link_fault(self, t: float, u: int, v: int, factor: float) -> None:
        """At ``t`` fabric link (u, v) fails (0), degrades, or heals (1)."""
        self._scripted.append(
            (t, lambda sim, now: sim.apply_link_fault(u, v, factor, now))
        )

    # fault effects are methods (not closures) so a co-simulator can apply
    # *global* fault scripts to whichever tenant owns the EP at fault time

    def apply_slowdown(self, ep_idx: int, factor: float) -> None:
        f = list(self.drift.factors)
        f[ep_idx] = f[ep_idx] * factor
        self.drift = EPDerates(factors=tuple(f))

    def apply_dropout(self, ep_idx: int) -> None:
        self.dead.add(ep_idx)
        for s, st in enumerate(self._stages):
            if self.conf.eps[s] == ep_idx and st.busy:
                st.token += 1  # cancel the in-flight completion
                st.busy = False
                for r in st.batch or []:
                    # the aborted service never happened: keep the wait-time
                    # clock honest by letting the next real start restamp it
                    r.t_start = math.nan
                st.queue.extendleft(reversed(st.batch or []))
                st.batch = None

    def apply_revival(self, ep_idx: int, now: float) -> None:
        self.dead.discard(ep_idx)
        for s in range(self.conf.depth):
            if self.conf.eps[s] == ep_idx:
                self._try_start(s, now)

    def apply_link_fault(self, u: int, v: int, factor: float, now: float) -> None:
        """A fabric link's state changes: dead (0), degraded, or healed (1).

        Mutates the shared fabric link-state (visible to every tenant on
        the same fabric), re-prices this lane's stage times under the new
        effective topology, and — on heal/degrade — kicks every stage,
        since a boundary that priced ``inf`` may be serveable again.
        """
        fabric = self.evaluator.platform.fabric
        if fabric is None:
            return
        fabric.set_link_state(u, v, factor)
        self._base_times = list(self.evaluator.stage_times(self.conf))
        if factor > 0.0:
            for s in range(self.conf.depth):
                self._try_start(s, now)

    # chaos wrappers: telemetry lives here, NOT in the apply_* methods, so
    # scripted-fault runs (and their pinned telemetry exports) are untouched

    def _chaos_dropout(self, ep_idx: int, now: float) -> None:
        self.apply_dropout(ep_idx)
        tl = self.telemetry
        if tl is not None:
            tl.counter("chaos.dropouts").inc()
            tl.instant(
                "chaos:dropout", now, cat="chaos", pid=self.label, tid="chaos",
                args={"ep": ep_idx},
            )

    def _chaos_revival(self, ep_idx: int, now: float) -> None:
        self.apply_revival(ep_idx, now)
        tl = self.telemetry
        if tl is not None:
            tl.counter("chaos.revivals").inc()
            tl.instant(
                "chaos:revival", now, cat="chaos", pid=self.label, tid="chaos",
                args={"ep": ep_idx},
            )

    def _chaos_link(self, u: int, v: int, factor: float, now: float) -> None:
        self.apply_link_fault(u, v, factor, now)
        tl = self.telemetry
        if tl is not None:
            tl.counter("chaos.link_faults").inc()
            tl.instant(
                "chaos:link", now, cat="chaos", pid=self.label, tid="chaos",
                args={"link": [u, v], "factor": factor},
            )

    # -- live fabric contention ---------------------------------------------

    def set_background_flows(self, flows) -> None:
        """Install the current co-tenant flow set (fabric contention).

        A co-simulator calls this every monitor window with the *other*
        lanes' steady-state activation flows (node-space
        :class:`~repro_torch.interconnect.Flow`\\ s): the ground-truth evaluator
        re-prices every stage-boundary transfer under the shared-link
        fair-share model, so future service times on this lane reflect the
        congestion.  No-op when the flow set is unchanged or the platform
        has no fabric.
        """
        if self.evaluator.platform.fabric is None:
            return
        flows = tuple(flows)
        if flows == tuple(self.evaluator.background_flows):
            return
        self.evaluator.background_flows = flows
        self._base_times = list(self.evaluator.stage_times(self.conf))

    # -- internals ----------------------------------------------------------

    def _push(self, t: float, kind: int, payload) -> None:
        self.loop.push(t, kind, self, payload)

    def _effective_time(self, stage: int) -> float:
        ep = self.conf.eps[stage]
        t = self.drift.scale(ep, self._base_times[stage])
        tf = self._thermal_factors
        if tf is not None:
            t *= tf[ep]
        return t

    def observed_stage_times(self) -> list[float]:
        """What a monitor sees: drifted stage times, inf for dead EPs."""
        return [
            math.inf if self.conf.eps[s] in self.dead else self._effective_time(s)
            for s in range(self.conf.depth)
        ]

    def _try_start(self, stage: int, t: float) -> None:
        st = self._stages[stage]
        ep = self.conf.eps[stage]
        if st.busy or not st.queue or t < self._stall_until or ep in self.dead:
            return
        base = self._effective_time(stage)
        if not math.isfinite(base):
            return  # stage boundary severed by a link fault: cannot serve
        pol = self.resilience
        if pol is not None and pol.shed_expired and pol.deadline_s is not None:
            # a request that already missed its deadline would only burn
            # service time others still on budget could use — shed it now,
            # at whatever stage it is queued (an outage strands expired
            # work wherever the dead EP sat, not just at admission)
            while st.queue and pol.expired(st.queue[0].t_arrival, t):
                self._shed(st.queue.popleft(), t)
            if not st.queue:
                return
        b = min(len(st.queue), self.batch_policy[stage])
        batch = [st.queue.popleft() for _ in range(b)]
        dt = base * (1.0 + (b - 1) * self.batch_efficiency)
        for r in batch:
            if math.isnan(r.t_start):
                r.t_start = t
        st.busy, st.batch, st.service_dt = True, batch, dt
        if self.telemetry is not None:
            self._m_batch_size.observe(b)
        self._push(t + dt, _DONE, (stage, st.token, self._epoch))

    def _on_done(self, t: float, stage: int, token: int, epoch: int) -> None:
        if epoch != self._epoch:
            return  # batch belonged to a configuration that was replaced
        st = self._stages[stage]
        if token != st.token:
            return  # cancelled (dropout)
        st.busy = False
        ep = self.conf.eps[stage]
        self._busy_time[ep] += st.service_dt
        if self.power is not None:
            self._busy_since_tick[ep] += st.service_dt
        batch, st.batch = st.batch or [], None
        tl = self.telemetry
        if tl is not None and batch:
            # one span per served batch, on the hosting EP's track — the
            # "stage hop" leg of every member request's lifecycle
            span_name, ep_track = self._stage_tracks[stage]
            self._trace_append(
                TraceEvent(
                    t - st.service_dt,
                    span_name,
                    "request",
                    self.label,
                    ep_track,
                    st.service_dt,
                    {"stage": stage, "batch": len(batch)},
                )
            )
        bf = self._batch_faults
        if bf is not None and batch and bf.fails():
            # transient batch error: the work was done (busy time stands)
            # but the output is garbage and must be re-served
            self._on_batch_error(t, stage, batch)
            self._try_start(stage, t)
            return
        if stage == self.conf.depth - 1:
            for r in batch:
                r.t_done = t
                self._completed.append(r)
                if tl is not None:
                    ok = r.latency <= self.slo
                    (self._m_slo_hit if ok else self._m_slo_miss).inc()
                    self._m_latency.observe(r.latency)
                    self._trace_append(
                        TraceEvent(
                            r.t_arrival,
                            "request",
                            "request",
                            self.label,
                            "requests",
                            r.latency,
                            {
                                "rid": r.rid,
                                "wait_s": r.t_start - r.t_arrival,
                                "slo_ok": ok,
                            },
                        )
                    )
        else:
            self._stages[stage + 1].queue.extend(batch)
            self._try_start(stage + 1, t)
        self._try_start(stage, t)

    def _shed(self, r: Request, t: float) -> None:
        self._n_shed += 1
        tl = self.telemetry
        if tl is not None:
            tl.counter("chaos.shed").inc()
            tl.instant(
                "chaos:shed", t, cat="chaos", pid=self.label, tid="chaos",
                args={"rid": r.rid},
            )

    def _on_batch_error(self, t: float, stage: int, batch: list) -> None:
        """A served batch errored (chaos): retry, fail, or blindly re-serve."""
        pol = self.resilience
        tl = self.telemetry
        if tl is not None:
            tl.counter("chaos.batch_errors").inc()
            tl.instant(
                "chaos:batch_error", t, cat="chaos", pid=self.label, tid="chaos",
                args={"stage": stage, "batch": len(batch)},
            )
        if pol is None:
            # blind lane: immediate, unbounded head-of-line re-serve — the
            # failure mode the resilient arm is benchmarked against
            for r in reversed(batch):
                r.attempts += 1
                r.t_start = math.nan
                self._stages[stage].queue.appendleft(r)
            self._n_retries += len(batch)
            return
        for r in batch:
            r.attempts += 1
            if r.attempts > pol.max_retries:
                self._n_failed += 1
                if tl is not None:
                    tl.counter("chaos.failed").inc()
                continue
            self._n_retries += 1
            if tl is not None:
                tl.counter("chaos.retries").inc()
            r.t_start = math.nan
            self._push(t + pol.backoff(r.rid, r.attempts), _PLATFORM, _requeue(stage, r))

    def _begin_reconfig(self, t: float, retune, replatform: "Replatform | None" = None, extra: dict | None = None) -> None:
        # The old configuration keeps serving during the exploration window
        # (measurement batches are real traffic); the new conf lands at its
        # end and only then does the install downtime stall admission.
        self._retuning_until = t + retune.tuning_cost
        entry = {
            "t": t,
            "kind": retune.kind,
            "tuning_cost_s": retune.tuning_cost,
            "downtime_s": retune.downtime,
            "new_depth": retune.conf.depth,
            "model_throughput": retune.model_throughput,
        }
        if retune.batch_policy is not None:
            entry["batch_policy"] = list(retune.batch_policy)
        if extra:
            entry.update(extra)
        tl = self.telemetry
        if tl is not None:
            tl.counter(f"{self.label}.retunes.{retune.kind}").inc()
            tl.histogram(f"{self.label}.retune_cost_s").observe(retune.tuning_cost)
            # the Alg. 2 exploration window as a span: its dur is the charged
            # Trace.wall the old configuration serves degraded through
            tl.span(
                f"retune:{retune.kind}",
                t,
                retune.tuning_cost,
                cat="retune",
                pid=self.label,
                tid="tuner",
                args={k: v for k, v in entry.items() if k != "t"},
            )
        self._push(self._retuning_until, _RECONFIG, (retune, entry, replatform))

    def _fold_busy_time(self) -> None:
        """Accumulate current-platform occupancy into the name-keyed ledger."""
        for i, ep in enumerate(self.evaluator.platform.eps):
            if self._busy_time[i]:
                self._busy_prev[ep.name] = self._busy_prev.get(ep.name, 0.0) + self._busy_time[i]

    def _apply_reconfig(self, t: float, retune, entry: dict, replatform: "Replatform | None" = None) -> None:
        # logged here, not at decision time: a re-tune whose exploration
        # window runs past the horizon never installs and is not reported
        self._reconfigs.append(entry)
        # Drain-and-restart: cancel in-flight work, restart mid-pipeline
        # requests from stage 0 of the new configuration.
        displaced: list[Request] = []
        for st in self._stages:
            if st.busy:
                displaced.extend(st.batch or [])
            displaced.extend(st.queue)
        displaced.sort(key=lambda r: (r.t_arrival, r.rid))
        self._epoch += 1  # outstanding _DONE events of the old conf are void
        if replatform is not None:
            # elastic re-partition: the EP set itself changed, so swap the
            # ground-truth evaluator and re-base drift/dead/occupancy to the
            # new local index space
            self._fold_busy_time()
            if self.power is not None:
                # settle the energy window against the outgoing power model
                # (joules are package-level scalars, so they survive the
                # index-space change; thermal state restarts with the
                # incoming restricted model)
                self._step_power(t)
            self.evaluator = replatform.evaluator
            self.drift = replatform.drift
            self.dead = set(replatform.dead)
            self._busy_time = [0.0] * self.evaluator.platform.n_eps
            self.power = self.evaluator.platform.power
            self._busy_since_tick = [0.0] * self.evaluator.platform.n_eps
            pm = self.power
            if pm is not None and pm.thermal is not None:
                self._thermal_factors = [
                    pm.thermal.factor(e) for e in range(pm.n_eps)
                ]
            else:
                self._thermal_factors = None
            if self.telemetry is not None:
                # the swapped-in evaluator carries a freshly restricted
                # fabric: re-attach the session so routing passes keep
                # recording after the re-partition
                fabric = self.evaluator.platform.fabric
                if fabric is not None:
                    fabric.telemetry = self.telemetry
        old_policy = self.batch_policy
        self.conf = retune.conf
        if retune.dvfs_levels is not None and self.power is not None:
            # the tuner's adopted frequency vector takes force at install
            # time, with the new configuration (base times below are
            # recomputed under it); the energy window settles first so busy
            # seconds already served are priced at the old draw
            if len(retune.dvfs_levels) == self.power.n_eps:
                self._step_power(t)
                self.power.restore(retune.dvfs_levels)
        if retune.batch_policy is not None:
            policy = retune.batch_policy
        elif len(old_policy) == self.conf.depth:
            # no knob search ran: keep the caps currently in force rather
            # than silently resetting a caller-supplied per-stage policy
            policy = old_policy
        else:
            policy = None  # depth changed and nothing better known: flat default
        self.batch_policy = self._policy(policy, self.conf.depth)
        self._base_times = list(self.evaluator.stage_times(self.conf))
        self._stages = [_Stage(queue=deque()) for _ in range(self.conf.depth)]
        self._stages[0].queue.extend(displaced)
        self._stall_until = t + retune.downtime
        tl = self.telemetry
        if tl is not None:
            self._bind_stage_tracks()
            tl.instant(
                "install",
                t,
                cat="retune",
                pid=self.label,
                tid="tuner",
                args={
                    "kind": retune.kind,
                    "displaced": len(displaced),
                    "downtime_s": retune.downtime,
                    "new_depth": self.conf.depth,
                },
            )
        self._push(self._stall_until, _PLATFORM, lambda sim, now: sim._try_start(0, now))

    def _step_power(self, t: float) -> None:
        """Settle the energy/thermal window ``[_last_power_t, t]``.

        Dynamic joules accrue over each EP's busy seconds at its current
        DVFS level's draw (reduced while thermally throttled — the forced
        clock dip burns less); static leakage accrues over the whole
        window.  Thermal RC nodes step once with the window-average draw,
        and the resulting throttle derates take force for the next window.
        """
        pm = self.power
        window = t - self._last_power_t
        if window <= 0.0:
            return
        self._last_power_t = t
        th = pm.thermal
        tl = self.telemetry
        busy = self._busy_since_tick
        eps = self.evaluator.platform.eps
        throttles_before = th.throttle_events if th is not None else 0
        window_j = 0.0
        for ep in range(len(busy)):
            w = pm.dynamic_w(ep)
            if th is not None and th.throttled[ep]:
                w /= th.electrical_derate
            e = busy[ep] * w + pm.static_w(ep) * window
            window_j += e
            if th is not None:
                self._thermal_factors[ep] = th.step(ep, e / window, window)
                if tl is not None:
                    tl.counter_track(
                        f"thermal.temp_c:{eps[ep].name}",
                        t,
                        th.temps[ep],
                        pid=self.label,
                    )
            busy[ep] = 0.0
        self._energy_j += window_j
        w_avg = window_j / window
        if w_avg > self._peak_w:
            self._peak_w = w_avg
        if th is not None:
            hottest = max(th.temps)
            if self._max_temp_c is None or hottest > self._max_temp_c:
                self._max_temp_c = hottest
            self._throttle_events += th.throttle_events - throttles_before
        if tl is not None:
            tl.histogram("power.package_w").observe(w_avg)
            tl.counter("power.energy_j").inc(window_j)
            tl.counter_track("power.package_w", t, w_avg, pid=self.label)
            if th is not None and th.throttle_events > throttles_before:
                tl.counter("thermal.throttles").inc(
                    th.throttle_events - throttles_before
                )

    def _on_monitor(self, t: float, horizon: float) -> None:
        if self.power is not None:
            self._step_power(t)
        queued = sum(len(st.queue) for st in self._stages)
        in_system = queued + sum(
            len(st.batch or []) for st in self._stages if st.busy
        )
        self._load_samples.append((t, in_system))
        if self.telemetry is not None:
            self._m_queue_depth.observe(queued)
            self._m_in_system.set(in_system)
        if self.autotuner is not None and t >= self._stall_until and t >= self._retuning_until:
            drift = self.drift
            tf = self._thermal_factors
            if tf is not None:
                # the monitor cannot tell a hot chiplet from a sick one by
                # looking at one sample: the observed derate is the product
                # of fault drift and thermal throttle, and it is the
                # *detector's* job to classify the composite
                drift = drift.compose(EPDerates(factors=tuple(tf)))
            retune = self.autotuner.observe(
                t, self.conf, self.observed_stage_times(), drift, frozenset(self.dead)
            )
            if retune is not None:
                self._begin_reconfig(t, retune)
        nxt = t + self.monitor_interval
        if nxt < horizon:
            self._push(nxt, _MONITOR, horizon)

    # -- main loop ----------------------------------------------------------

    def prime(self, arrival_times: Sequence[float], horizon: float, tenant: int = 0) -> None:
        """Enqueue arrivals, scripted faults and the first monitor tick.

        Arrivals are primed as **one bulk batch**: traffic generators emit
        a whole seeded timestamp array per horizon, so the engine takes it
        in a single :meth:`EventLoop.push_batch` append instead of N
        per-event pushes (identical seq numbering and dispatch order).
        """
        self.loop.push_batch(
            arrival_times,
            _ARRIVAL,
            self,
            [
                Request(rid=rid, t_arrival=ta, tenant=tenant)
                for rid, ta in enumerate(arrival_times)
            ],
        )
        for t, fn in self._scripted:
            self._push(t, _PLATFORM, fn)
        fm = getattr(self.evaluator.platform, "faults", None)
        if fm is not None and fm.enabled:
            self._prime_chaos(fm, horizon)
        if self.monitor_interval < horizon:
            self._push(self.monitor_interval, _MONITOR, horizon)

    def _prime_chaos(self, fm, horizon: float) -> None:
        """Expand the platform's fault model into scheduled platform events.

        The whole chaos trace is a pure function of (model, seed, horizon):
        it is generated up front by :class:`~repro_torch.faults.FaultInjector` and
        pushed through the ordinary ``_PLATFORM`` path, so both event
        engines dispatch it identically.
        """
        from ..faults import FaultInjector

        fabric = self.evaluator.platform.fabric
        if fabric is not None and fabric.link_state:
            # the chaos trace is generated from a healthy t=0 baseline; a
            # previous run on the same platform object may have left link
            # faults behind — reset so reruns are bit-for-bit reproducible
            fabric.link_state.clear()
            self._base_times = list(self.evaluator.stage_times(self.conf))
        inj = FaultInjector(fm)
        for ev in inj.trace(self.evaluator.platform, horizon):
            self._push(ev.t, _PLATFORM, _chaos_event(ev))
        self._batch_faults = inj.batch_failures(self.label)

    def _dispatch(self, t: float, kind: int, payload) -> None:
        """Handle one event; called by whichever loop owns the clock."""
        if kind == _ARRIVAL:
            self._n_arrived += 1
            if self.telemetry is not None:
                self._m_arrivals.inc()
            pol = self.resilience
            if pol is not None and pol.queue_cap is not None:
                q = self._stages[0].queue
                if pol.shed_expired and pol.deadline_s is not None:
                    # expired requests don't get to hold admission slots
                    while q and pol.expired(q[0].t_arrival, t):
                        self._shed(q.popleft(), t)
                if len(q) >= pol.queue_cap:
                    self._shed(payload, t)
                    return
            self._stages[0].queue.append(payload)
            self._try_start(0, t)
        elif kind == _DONE:
            self._on_done(t, *payload)
        elif kind == _PLATFORM:
            payload(self, t)
        elif kind == _MONITOR:
            self._on_monitor(t, payload)
        elif kind == _RECONFIG:
            self._apply_reconfig(t, *payload)

    def run(self, arrival_times: Sequence[float], horizon: float, tenant: int = 0) -> SimResult:
        self.prime(arrival_times, horizon, tenant)
        self.loop.run(horizon)
        return self._result(horizon)

    def _power_result(self, horizon: float) -> dict | None:
        pm = self.power
        if pm is None:
            return None
        self._step_power(horizon)  # settle the final partial window
        done = len(self._completed)
        return {
            "energy_j": self._energy_j,
            "joules_per_request": self._energy_j / done if done else None,
            "peak_package_w": self._peak_w,
            "avg_package_w": self._energy_j / horizon if horizon > 0 else 0.0,
            # None (not inf) when uncapped, so the block stays strict-JSON
            "cap_w": pm.cap_w if math.isfinite(pm.cap_w) else None,
            "throttle_events": self._throttle_events,
            "max_temp_c": self._max_temp_c,
            "dvfs_levels": list(pm.snapshot()),
        }

    def _result(self, horizon: float) -> SimResult:
        power = self._power_result(horizon)
        lats = sorted(r.latency for r in self._completed)
        n_in_flight = sum(len(st.batch or []) for st in self._stages if st.busy)
        n_queued = sum(len(st.queue) for st in self._stages)
        pending = [
            r
            for st in self._stages
            for r in list(st.queue) + ((st.batch or []) if st.busy else [])
        ]
        n_viol = sum(1 for l in lats if l > self.slo) + sum(
            1 for r in pending if horizon - r.t_arrival > self.slo
        )
        occ = {name: busy / horizon for name, busy in self._busy_prev.items()}
        for i, ep in enumerate(self.evaluator.platform.eps):
            occ[ep.name] = occ.get(ep.name, 0.0) + self._busy_time[i] / horizon
        pol = self.resilience
        deadline = pol.deadline_s if pol is not None else None
        if deadline is None:
            n_good = len(self._completed)
        else:
            n_good = sum(1 for l in lats if l <= deadline)
        lost = self._n_shed + self._n_failed
        return SimResult(
            horizon=horizon,
            slo=self.slo,
            n_arrived=self._n_arrived,
            n_completed=len(self._completed),
            n_in_flight=n_in_flight,
            n_queued=n_queued,
            latencies=lats,
            throughput_rps=len(self._completed) / horizon if horizon > 0 else 0.0,
            p50=percentile(lats, 0.50) if lats else None,
            p95=percentile(lats, 0.95) if lats else None,
            p99=percentile(lats, 0.99) if lats else None,
            p95_wait=(
                percentile(sorted(r.t_start - r.t_arrival for r in self._completed), 0.95)
                if self._completed
                else None
            ),
            n_slo_violations=n_viol,
            slo_rate=n_viol / self._n_arrived if self._n_arrived else 0.0,
            occupancy=occ,
            reconfigs=self._reconfigs,
            load_samples=self._load_samples,
            power=power,
            goodput_rps=n_good / horizon if horizon > 0 else 0.0,
            n_shed=self._n_shed,
            n_failed=self._n_failed,
            n_retries=self._n_retries,
            availability=1.0 - lost / self._n_arrived if self._n_arrived else 1.0,
        )

    def result(self, horizon: float) -> SimResult:
        """Final accounting; used by co-simulators that drive a shared loop."""
        return self._result(horizon)


@dataclasses.dataclass(frozen=True)
class Replatform:
    """Install bundle for a re-partition: the lane's new ground truth.

    Carried alongside a :class:`~repro_torch.serve.autotuner.Retune` through the
    reconfig event so the evaluator/drift/dead swap happens at *install*
    time (end of the exploration window), not at decision time.
    """

    evaluator: AnalyticEvaluator
    drift: EPDerates
    dead: frozenset
