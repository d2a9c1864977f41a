"""The port's serving layer against the JAX package's, at tolerance zero.

``repro_torch.serve`` (traffic, simulator, autotuner, multitenant) is a
copy of ``repro.serve``.  Fed the same seeds, platforms and scripts, both
must give the same arrivals, the same ``SimResult`` (``dataclasses.asdict``,
compared with ``==``) and the same ``ContinuousShisha`` history (kinds,
splits, ``tuning_cost``, DVFS levels), on the drain and the heap event
engines alike.  Each scenario is written once and run through both packages
(``_run``), on ``paper_platform`` SynthNet with ``DatabaseEvaluator``, as
``tests/test_serve.py`` builds it.  The partitioning and ``co_serve`` cases
of ``tests/test_serve.py`` and ``tests/test_event_engine.py`` are here, the
rest of the multi-tenant layer in ``tests/test_torch_multitenant.py``.
"""

import dataclasses
import math
import os
import random
import subprocess
import sys
from pathlib import Path
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
    """The single-tenant half and, since the multi-tenant layer was copied
    too, the rest: the port's ``serve.__all__`` is the reference's."""
    assert sorted(serve.__all__) == sorted(jserve.__all__)
    assert {"co_serve", "ElasticPartitioner", "SharedClockCoSimulator", "partition_eps"} <= set(serve.__all__)


# ---------------------------------------------------------------------------
# multi-tenancy: partitioning and co-serving (tests/test_serve.py,
# tests/test_event_engine.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["interleaved", "blocked", "proportional"])
@pytest.mark.parametrize("n_parts", [2, 3])
def test_partitions_match_reference_and_are_disjoint_and_cover(strategy, n_parts):
    ours, theirs = _run(lambda m: m.serve.partition_eps(m.core.paper_platform(8), n_parts, strategy))
    assert ours == theirs
    assert sorted(ep for p in ours for ep in p) == list(range(8))
    assert all(len(p) >= 1 for p in ours)


def test_interleaved_shares_feps_fairly_and_blocked_gives_tenant0_the_fast_block():
    plat = core.paper_platform(8)  # 4 FEPs, 4 SEPs
    feps = set(plat.feps)
    assert all(len(set(p) & feps) == 2 for p in serve.partition_eps(plat, 2, "interleaved"))
    assert set(serve.partition_eps(plat, 2, "blocked")[0]) == set(plat.ranked()[:4])


def test_subplatform_reindexes_as_the_reference():
    ours, theirs = _run(lambda m: m.serve.subplatform(m.core.paper_platform(8), (6, 1), "sub"))
    assert ours.n_eps == 2
    assert [dataclasses.asdict(e) for e in ours.eps] == [dataclasses.asdict(e) for e in theirs.eps]
    plat = core.paper_platform(8)
    assert (ours.eps[0].name, ours.eps[1].name) == (plat.eps[6].name, plat.eps[1].name)


@pytest.mark.parametrize("shares", [(1000.0, 1.0, 1.0), (1e6, 1e-6), (0.001, 5.0, 0.001, 5.0)])
def test_blocked_partition_skewed_shares_keeps_all_tenants(shares):
    ours, theirs = _run(lambda m: m.serve.partition_eps(m.core.paper_platform(8), len(shares), "blocked",
                                                        shares=list(shares)))
    assert ours == theirs
    assert sorted(ep for p in ours for ep in p) == list(range(8))
    assert all(len(p) >= 1 for p in ours)
    if shares[0] == 1000.0:
        assert len(ours[0]) > len(ours[1])  # the dominant share still gets the biggest block


def _two_tenants(m, plat, specs, rate_of):
    tenants = []
    for name, net, seed, slo in specs:
        layers = m.cnn.network_layers(net)
        cap = m.heuristics.run_shisha(m.core.weights(layers), m.core.Trace(m.core.DatabaseEvaluator(plat, layers)),
                                      "H3").result.best_throughput
        tenants.append(m.serve.Tenant(name=name, layers=tuple(layers),
                                      traffic=m.serve.PoissonTraffic(rate=rate_of(cap), seed=seed), slo=slo))
    return tenants


def test_co_serve_on_adaptive_fabric_matches_reference_and_diverges_from_static():
    """The co-simulator re-prices (and, adaptive, re-routes) every lane's
    transfers each monitor window: two adaptive runs are bit-identical and
    equal the reference's, and the routing reaches the served latencies."""

    def arm(m, routing):
        fab = m.interconnect.uniform_fabric(m.interconnect.mesh2d(2, 4, bw=1e8, latency=1e-6))
        plat = m.core.paper_platform(8).with_fabric(fab.with_routing(routing))
        tenants = _two_tenants(m, plat, (("a", "synthnet", 5, 2.5), ("b", "resnet50", 6, 1.0)), lambda c: 0.6 * c)
        return m.serve.co_serve(plat, tenants, horizon=20.0, elastic=False, measure_batches=2, alpha=4)

    adaptive, ref_adaptive = _run(arm, "adaptive")
    assert dataclasses.asdict(adaptive) == dataclasses.asdict(ref_adaptive)
    assert dataclasses.asdict(arm(PORT, "adaptive")) == dataclasses.asdict(adaptive)
    static, ref_static = _run(arm, "static")
    assert dataclasses.asdict(static) == dataclasses.asdict(ref_static)
    assert any(rs.sim.latencies != ra.sim.latencies for rs, ra in zip(static.results, adaptive.results))


@pytest.mark.parametrize("engine", ["EventLoop", "HeapEventLoop"])
def test_co_serve_result_bit_for_bit_across_engines_and_packages(engine):
    """Elastic, faulted shared-clock co-simulation: the drain and the heap
    engines give the same ``CoServeResult``, and each the reference's."""

    def arm(m, loop):
        plat = m.core.paper_platform(8)
        tenants = [
            m.serve.Tenant(name="synthnet", layers=tuple(m.cnn.network_layers("synthnet")),
                           traffic=m.serve.ReplayTraffic.record(m.serve.PoissonTraffic(rate=3.0, seed=11), 40.0),
                           slo=2.7),
            m.serve.Tenant(name="alexnet", layers=tuple(m.cnn.network_layers("alexnet")),
                           traffic=m.serve.ReplayTraffic.record(m.serve.PoissonTraffic(rate=2.0, seed=12), 40.0),
                           slo=2.0),
        ]
        return m.serve.co_serve(plat, tenants, horizon=40.0, elastic=True, measure_batches=2, alpha=4,
                                faults=[("dropout", 12.0, 0), ("slowdown", 20.0, 2, 3.0)],
                                loop=getattr(m.simulator, loop)())

    ours, theirs = _run(arm, engine)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours == arm(PORT, "HeapEventLoop" if engine == "EventLoop" else "EventLoop")
    assert ours.repartitions


def test_serve_traffic_twin_prints_what_the_reference_prints(tmp_path):
    """``examples/serve_traffic_torch.py`` against ``examples/serve_traffic.py``:
    all three acts (the straggler, elastic co-serving under an EP dropout,
    the telemetry lens) print the same lines, and both write the same
    Chrome trace, each run in a directory of its own."""
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root / "src"), "JAX_PLATFORMS": "cpu"}
    out, traces = {}, {}
    for name in ("serve_traffic.py", "serve_traffic_torch.py"):
        cwd = tmp_path / name.removesuffix(".py")
        cwd.mkdir()
        proc = subprocess.run([sys.executable, str(root / "examples" / name)], capture_output=True, text=True,
                              env=env, timeout=300, cwd=cwd)
        assert proc.returncode == 0, proc.stderr
        out[name] = proc.stdout.splitlines()
        traces[name] = (cwd / "experiments" / "telemetry" / "serve_traffic_trace.json").read_text()
    ours, theirs = out["serve_traffic_torch.py"], out["serve_traffic.py"]
    assert ours == theirs
    assert traces["serve_traffic_torch.py"] == traces["serve_traffic.py"]
    tags = {line[:7] for line in ours}
    assert {"[tune ]", "[serve]", "[retune", "[multi]", "[elast]", "[trace]", "[metr ]"} <= tags
    assert any("stole EP" in line for line in ours if line.startswith("[elast]"))
