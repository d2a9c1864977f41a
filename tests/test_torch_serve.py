"""The port's serving layer against the JAX package's, at tolerance zero.

``repro_torch.serve`` (traffic, simulator, autotuner) is a copy of
``repro.serve``'s single-tenant half.  Fed the same seeds, platforms and
scripts, both must give the same arrivals, the same ``SimResult``
(``dataclasses.asdict``, compared with ``==``) and the same
``ContinuousShisha`` history (kinds, splits, ``tuning_cost``, DVFS levels),
on the drain and the heap event engines alike.  Each scenario is written
once and run through both packages (``_run``), on ``paper_platform``
SynthNet with ``DatabaseEvaluator``, as ``tests/test_serve.py`` builds it.
"""

import dataclasses
import math
import random
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")  # CI installs requirements-dev.txt, which has no torch

import repro.core as jcore
import repro.core.heuristics as jheuristics
import repro.faults as jfaults
import repro.interconnect as jinterconnect
import repro.models.cnn as jcnn
import repro.pipeline.hetero as jhetero
import repro.power as jpower
import repro.serve as jserve
import repro.serve.simulator as jsimulator
import repro.serve.traffic as jtraffic
import repro_torch.core as core
import repro_torch.core.heuristics as heuristics
import repro_torch.faults as faults
import repro_torch.interconnect as interconnect
import repro_torch.models.cnn as cnn
import repro_torch.pipeline.hetero as hetero
import repro_torch.power as power
import repro_torch.serve as serve
import repro_torch.serve.simulator as simulator
import repro_torch.serve.traffic as traffic

REF = SimpleNamespace(core=jcore, heuristics=jheuristics, faults=jfaults, interconnect=jinterconnect, cnn=jcnn,
                      hetero=jhetero, power=jpower, serve=jserve, simulator=jsimulator, traffic=jtraffic)
PORT = SimpleNamespace(core=core, heuristics=heuristics, faults=faults, interconnect=interconnect, cnn=cnn,
                       hetero=hetero, power=power, serve=serve, simulator=simulator, traffic=traffic)


def _run(fn, *args):
    """``fn(package, *args)`` through the port and the reference."""
    return fn(PORT, *args), fn(REF, *args)


def _history(tuner) -> list:
    return [(r.kind, r.conf.stages, r.conf.eps, r.tuning_cost, r.downtime, r.model_throughput, r.dvfs_levels,
             r.batch_policy, r.tune_result.n_explored, r.tune_result.best_throughput) for r in tuner.history]


# ---------------------------------------------------------------------------
# traffic
# ---------------------------------------------------------------------------

TRAFFIC = {
    "poisson": ("PoissonTraffic", dict(rate=5.0, seed=3)),
    "poisson_fast": ("PoissonTraffic", dict(rate=5000.0, seed=1)),
    "mmpp": ("MMPPTraffic", dict(rate_low=2.0, rate_high=20.0, seed=3)),
    "mmpp_bursty": ("MMPPTraffic", dict(rate_low=4.0, rate_high=40.0, mean_calm=6.0, mean_burst=1.5, seed=3)),
    "diurnal": ("DiurnalTraffic", dict(base_rate=1.0, peak_rate=10.0, period=30.0, seed=3)),
}


@pytest.mark.parametrize("horizon", [2.0, 60.0])
@pytest.mark.parametrize("name", sorted(TRAFFIC))
def test_arrivals_match_reference(name, horizon):
    cls, kw = TRAFFIC[name]
    ours, theirs = _run(lambda m: getattr(m.serve, cls)(**kw).arrivals(horizon))
    assert ours == theirs and len(ours) > 0


def test_replay_record_load_and_fit_mmpp_match_reference(tmp_path):
    def fn(m):
        gen = m.serve.MMPPTraffic(rate_low=4.0, rate_high=40.0, mean_calm=6.0, mean_burst=1.5, seed=3)
        rec = m.serve.ReplayTraffic.record(gen, 600.0)
        path = rec.save(tmp_path / f"{m.serve.__name__}.json")
        loaded = m.serve.ReplayTraffic.load(path)
        fits = [rec.fit_mmpp(horizon=600.0), rec.fit_mmpp(),
                m.serve.ReplayTraffic.record(m.serve.PoissonTraffic(rate=10.0, seed=1), 200.0).fit_mmpp(horizon=200.0),
                m.serve.ReplayTraffic(times=()).fit_mmpp(horizon=10.0),
                m.serve.ReplayTraffic(times=(0.5, 1.0, 1.5)).fit_mmpp(horizon=2.0),
                m.serve.ReplayTraffic(times=(1.0, 2.0, 3.0, 4.0, 5.0, 50.0)).fit_mmpp(horizon=5.5)]
        return (loaded.arrivals(600.0), rec.arrivals(100.0), m.serve.interarrival_cv2(rec.times),
                [dataclasses.asdict(f) for f in fits], [f.arrivals(50.0) for f in fits])

    ours, theirs = _run(fn)
    assert ours == theirs


@pytest.mark.parametrize("rate,seed,horizon", [(0.5, 0, 60.0), (120.0, 7, 40.0), (5000.0, 1, 2.0)])
def test_poisson_matches_the_scalar_loop_of_numpy_generator(rate, seed, horizon):
    """The port keeps numpy's Generator (``traffic._rng``), so the chunked
    draw equals the scalar ``t += rng.exponential(...)`` loop bit for bit."""
    rng = traffic._rng(seed)
    ref, t = [], 0.0
    while True:
        t += rng.exponential(1.0 / rate)
        if t >= horizon:
            break
        ref.append(t)
    assert serve.PoissonTraffic(rate=rate, seed=seed).arrivals(horizon) == ref


# ---------------------------------------------------------------------------
# event engines
# ---------------------------------------------------------------------------


class _Chainer:
    """Owner whose dispatches push seeded follow-ups (same-time, lower-kind,
    into the active drain), recording every dispatch."""

    def __init__(self, loop, seed):
        self.loop, self.rng, self.events = loop, random.Random(seed), []

    def _dispatch(self, t, kind, payload):
        self.events.append((t, kind, payload))
        r = self.rng.random()
        if r < 0.3 and payload < 4:
            self.loop.push(t + self.rng.choice([0.0, 1e-9, 0.001, 0.01, 0.5, 10.0]), self.rng.randrange(5), self,
                           payload + 1)
        if r < 0.05:
            self.loop.push(t, 0, self, payload + 1)


def _scripted(m, engine, seed, horizons):
    rng = random.Random(seed)
    loop = getattr(m.simulator, engine)()
    rec = _Chainer(loop, seed * 7 + 1)
    times = []
    for _ in range(rng.randrange(1, 200)):
        times.append(rng.choice([rng.uniform(0, 100), float(rng.randrange(10))]))
        loop.push(times[-1], rng.randrange(5), rec, 0)
    loop.push_batch(times[:5], 2, rec, [0] * len(times[:5]))
    for h in horizons:
        loop.run(h)
    return rec.events, loop.n_dispatched, len(loop)


@pytest.mark.parametrize("horizons", [(1e9,), (15.0, 15.0, 40.0, 99.0, 120.0)])
@pytest.mark.parametrize("engine", ["EventLoop", "HeapEventLoop"])
def test_event_engines_dispatch_as_the_reference(engine, horizons):
    for seed in range(12):
        ours, theirs = _run(_scripted, engine, seed, horizons)
        assert ours == theirs
        assert ours == _scripted(PORT, "HeapEventLoop" if engine == "EventLoop" else "EventLoop", seed, horizons)


# ---------------------------------------------------------------------------
# the simulator and continuous Shisha, scenario by scenario
# ---------------------------------------------------------------------------

SCENARIOS = ["underload", "overload", "slowdown", "dropout", "revival", "recovery", "batch_policy",
             "batch_search", "link_fault", "power", "thermal", "throttle", "placement", "same_time_faults"]


def _tuned(m, n_eps=8, platform=None):
    layers = m.cnn.network_layers("synthnet")
    plat = platform if platform is not None else m.core.paper_platform(n_eps)
    ev = m.core.DatabaseEvaluator(plat, layers)
    sh = m.heuristics.run_shisha(m.core.weights(layers), m.core.Trace(ev), "H3")
    conf = sh.result.best_conf
    times = ev.stage_times(conf)
    return SimpleNamespace(layers=layers, plat=plat, ev=ev, conf=conf, cap=sh.result.best_throughput,
                           slo=3.0 * sum(times), bad=conf.eps[max(range(conf.depth), key=times.__getitem__)])


def _tuner(m, t, platform=None, **kw):
    return m.serve.ContinuousShisha(platform if platform is not None else t.plat, t.layers,
                                    make_evaluator=lambda p: m.core.DatabaseEvaluator(p, t.layers), **kw)


def _serve(m, scenario, engine):
    """One scenario of ``tests/test_serve.py`` / ``test_power.py`` /
    ``test_chaos.py`` / ``test_event_engine.py``: (SimResult, history)."""
    t = _tuned(m, 4 if scenario in ("power", "thermal", "throttle") else 8)
    ev, conf, sim_kw, tuner, script = t.ev, t.conf, {}, None, []
    rate, horizon, seed = 0.5, 60.0, 5
    if scenario == "underload":
        rate = 0.4
    elif scenario == "overload":
        rate, horizon = 2.0, 30.0
    elif scenario == "slowdown":
        tuner, horizon = _tuner(m, t), 250.0
        script = [lambda s: s.schedule_slowdown(20.0, t.bad, 3.0)]
    elif scenario == "dropout":
        tuner, horizon, seed = _tuner(m, t), 300.0, 1
        script = [lambda s: s.schedule_dropout(60.0, t.bad)]
    elif scenario == "revival":
        tuner, horizon = _tuner(m, t), 400.0
        script = [lambda s: s.schedule_dropout(20.0, t.bad), lambda s: s.schedule_revival(200.0, t.bad)]
    elif scenario == "recovery":
        tuner, horizon = _tuner(m, t), 400.0
        script = [lambda s: s.schedule_slowdown(20.0, t.bad, 3.0),
                  lambda s: s.schedule_slowdown(200.0, t.bad, 1.0 / 3.0)]
    elif scenario == "batch_policy":
        rate, horizon = 2.0, 40.0
        sim_kw = dict(max_batch=1, batch_policy=(4,) * conf.depth)
    elif scenario == "batch_search":
        tuner = _tuner(m, t, slo=t.slo, batch_policy_search=True)
        script = [lambda s: s.schedule_dropout(10.0, conf.eps[0])]
    elif scenario == "link_fault":
        plat = m.core.paper_platform(4).with_fabric(
            m.interconnect.uniform_fabric(m.interconnect.mesh2d(1, 4, bw=1e9, latency=1e-6)))
        ev = m.core.DatabaseEvaluator(plat, t.layers)
        conf = m.core.PipelineConfig(stages=(len(t.layers) - 1, 1), eps=(1, 2))
        tuner = _tuner(m, t, platform=plat, measure_batches=2, alpha=4)
        sim_kw, rate, horizon = dict(slo=5.0), None, 40.0
        script = [lambda s: s.schedule_link_fault(5.0, 1, 2, 0.0), lambda s: s.schedule_link_fault(25.0, 1, 2, 1.0)]
    elif scenario in ("power", "thermal", "throttle"):
        if scenario == "power":
            pm = m.power.uniform_power(t.plat)
        elif scenario == "thermal":
            pm = m.power.uniform_power(t.plat, thermal=m.power.uniform_thermal(4, seed=3))
        else:
            pm = m.power.uniform_power(t.plat, thermal=m.power.ThermalModel(
                r_k_per_w=(4.0,) * 4, c_j_per_k=(1.0,) * 4, t_hot_c=80.0, t_cool_c=76.0))
        plat = t.plat.with_power(pm)
        ev = m.core.DatabaseEvaluator(plat, t.layers)
        rate, horizon = 0.6, 30.0
        if scenario == "throttle":
            tuner = _tuner(m, t, platform=plat, cooldown=1.0, alpha=2, measure_batches=2)
            rate, horizon = 0.7, 120.0
    elif scenario == "placement":
        plat = t.plat.with_fabric(m.interconnect.uniform_fabric(m.interconnect.mesh2d(2, 4, bw=1e8, latency=1e-6),
                                                               routing="adaptive"))
        ev = m.core.DatabaseEvaluator(plat, t.layers)
        tuner = _tuner(m, t, platform=plat, placement=True, measure_batches=2, alpha=4)
        script = [lambda s: s.schedule_slowdown(8.0, 1, 2.0), lambda s: s.schedule_dropout(15.0, 0)]
        horizon = 30.0
    elif scenario == "same_time_faults":
        ep = conf.eps[0]
        script = [lambda s: s.schedule_dropout(5.0, ep), lambda s: s.schedule_revival(12.0, ep),
                  lambda s: s.schedule_dropout(12.0, ep)]
        horizon = 30.0
    sim_kw.setdefault("slo", t.slo)
    sim = m.serve.ServingSimulator(ev, conf, autotuner=tuner, loop=getattr(m.simulator, engine)(), **sim_kw)
    for fn in script:
        fn(sim)
    arrivals = m.serve.PoissonTraffic(rate=5.0 if rate is None else rate * t.cap, seed=seed).arrivals(horizon)
    result = sim.run(arrivals, horizon)
    return dataclasses.asdict(result), (_history(tuner) if tuner is not None else None), sorted(sim.dead)


@pytest.mark.parametrize("engine", ["EventLoop", "HeapEventLoop"])
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_sim_result_and_history_match_reference(scenario, engine):
    ours, theirs = _run(_serve, scenario, engine)
    assert ours == theirs
    result, history, _ = ours
    assert result["n_arrived"] == result["n_completed"] + result["n_queued"] + result["n_in_flight"]
    if scenario in ("slowdown", "dropout", "revival", "recovery", "link_fault", "throttle", "placement",
                    "batch_search"):
        assert history, "the scenario must re-tune to pin anything"
    if engine == "EventLoop":
        assert ours == _serve(PORT, scenario, "HeapEventLoop")


def test_retune_kinds_of_the_drift_scenarios():
    """What the reference's own tests pin, on the port."""
    kinds = {s: [h[0] for h in _serve(PORT, s, "EventLoop")[1]] for s in
             ("slowdown", "dropout", "revival", "recovery", "link_fault", "throttle")}
    assert kinds["slowdown"] == ["slowdown"]
    assert kinds["dropout"] == ["dropout"]
    assert kinds["revival"] == ["dropout", "recovery"]
    assert kinds["recovery"] == ["slowdown", "recovery"]
    assert "link-loss" in kinds["link_fault"]
    assert "throttle" in kinds["throttle"]


# ---------------------------------------------------------------------------
# the autotuner's parts
# ---------------------------------------------------------------------------


def _conf_on(m, eps):
    return m.core.PipelineConfig(stages=(2,) * len(eps), eps=tuple(eps))


DETECTOR_SEQUENCES = {
    # (factors, dead) per observation; mirrors tests/test_power.py:307-369
    "step": [((1.0, 1.0), ()), *[((2.0, 1.0), ())] * 6],
    "oscillating": [((1.6, 1.0), ()), ((1.0, 1.0), ()), ((1.6, 1.0), ())],
    "mixed": [((1.6, 1.0), ()), ((1.0, 1.0), ()), ((1.6, 2.0), ())],
    "dropout_outranks": [((1.6, 1.0), ()), ((1.0, 1.0), ()), ((1.6, 1.0), (1,))],
    "short_factors": [((3.0,), ()), ((1.0,), ())],
    "severed": [((1.0, 1.0), ()), ((1.0, 1.0), ("inf",))],
}


@pytest.mark.parametrize("name", sorted(DETECTOR_SEQUENCES))
def test_drift_detector_classifies_as_the_reference(name):
    def fn(m):
        det, conf, out = m.serve.DriftDetector(), _conf_on(m, [0, 1]), []
        for factors, dead in DETECTOR_SEQUENCES[name]:
            observed = [math.inf if dead == ("inf",) and s == 1 else f for s, f in enumerate((*factors, 1.0)[:2])]
            drift = det.detect(conf, observed, m.hetero.EPDerates(factors=factors),
                               frozenset(d for d in dead if d != "inf"), expected_times=[1.0, 1.0])
            out.append(None if drift is None else dataclasses.asdict(drift))
        return out

    ours, theirs = _run(fn)
    assert ours == theirs
    with pytest.raises(ValueError):
        serve.Drift("meltdown", "nope")
    assert serve.DRIFT_KINDS == jserve.DRIFT_KINDS


@pytest.mark.parametrize("n_levels", [4, 2])
def test_throttle_fast_path_matches_reference(n_levels):
    """``tests/test_power.py``'s throttle step-down (4 levels) and its
    escalation to a full re-tune at the ladder's floor (2 levels)."""

    def fn(m):
        layers = m.cnn.network_layers("synthnet")
        plat = m.core.paper_platform(4)
        pm = m.power.uniform_power(plat, n_levels=n_levels)
        plat_p = plat.with_power(pm)
        conf = m.heuristics.run_shisha(m.core.weights(layers), m.core.Trace(m.core.DatabaseEvaluator(plat_p, layers)),
                                       "H3").result.best_conf
        tuner = m.serve.ContinuousShisha(platform=plat_p, layers=tuple(layers), cooldown=0.5,
                                         make_evaluator=lambda p: m.core.DatabaseEvaluator(p, layers))
        if n_levels == 2:
            pm.set_level(conf.eps[0], 1)
        factors = [1.0] * 4
        factors[conf.eps[0]] = 1.6
        hot, cool = m.hetero.EPDerates(factors=tuple(factors)), m.hetero.EPDerates(factors=(1.0,) * 4)
        times = m.core.DatabaseEvaluator(plat_p, layers).stage_times(conf)
        for t, d in ((1.0, hot), (2.0, cool), (4.0, hot), (6.0, cool)):
            tuner.observe(t, conf, times, d, frozenset())
        return _history(tuner), pm.snapshot()

    ours, theirs = _run(fn)
    assert ours == theirs
    assert [h[0] for h in ours[0]][-1] == "throttle"


def test_drifted_platform_batch_policy_and_force_retune_match_reference():
    def fn(m):
        t = _tuned(m)
        f = [1.0] * 8
        f[2] = 2.0
        model = m.serve.drifted_platform(t.plat, m.hetero.EPDerates(factors=tuple(f)), dead=frozenset({5}))
        policies = [m.serve.tune_batch_policy(m.core.Trace(t.ev), t.conf, slo=s, max_batch_cap=8)
                    for s in (100.0, t.slo, 1e-9)]
        tuner = _tuner(m, t, placement=True, measure_batches=2, alpha=4)
        rt = tuner.force_retune(0.0, m.hetero.EPDerates(factors=(1.0,) * 8), frozenset({0}), kind="dropout")
        return ([dataclasses.astuple(ep) for ep in model.eps], model.name, model.ranked(), policies,
                _history(tuner), rt.cost)

    ours, theirs = _run(fn)
    assert ours == theirs
    assert 0 not in ours[4][0][2]  # the re-tune keeps off the dead EP


def test_percentile_and_slo_violation_rate_match_reference():
    vals = sorted([0.7, 0.1, 3.2, 0.1, 2.5, 1.9, 0.4, 5.0, 0.9, 2.2, 0.3])
    for q in (0.0, 0.01, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert serve.percentile(vals, q) == jserve.percentile(vals, q)
    for slo in (0.0, 0.5, 2.0, 10.0):
        assert serve.slo_violation_rate(vals, slo) == jserve.slo_violation_rate(vals, slo)
    assert serve.slo_violation_rate([], 1.0) == jserve.slo_violation_rate([], 1.0)


def test_package_exports_the_single_tenant_half_of_the_reference():
    ours = set(serve.__all__)
    theirs = set(jserve.__all__)
    assert ours < theirs
    assert theirs - ours == {"CoServeResult", "ElasticPartitioner", "PARTITION_STRATEGIES", "RepartitionEvent",
                             "SharedClockCoSimulator", "Tenant", "TenantResult", "co_schedule", "co_serve",
                             "compare_partitions", "partition_eps", "subplatform"}
