"""The port's telemetry against the JAX package's, at tolerance zero.

``repro_torch.telemetry`` is a copy of ``repro.telemetry``, and the hooks
that feed it (``Trace.telemetry``, ``tune``'s move counters, the fabric's
routing passes and adaptive router) are the reference's.  With a live
session on the same run, ``metrics_snapshot()`` and both exports (JSONL,
Chrome trace) must be byte-equal to the reference's, for a ``Trace``, a
``tune`` with placement and DVFS moves, an adaptive fabric and a drifting
serve and a faulted elastic ``co_serve``; ``NULL`` or no session must
change nothing.  ``tests/test_telemetry.py`` is mirrored, but for its
wall-clock floors.
"""

import dataclasses
import json
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")  # CI installs requirements-dev.txt, which has no torch

import repro.core as jcore
import repro.core.heuristics as jheuristics
import repro.interconnect as jinterconnect
import repro.models.cnn as jcnn
import repro.power as jpower
import repro.serve as jserve
import repro.telemetry as jtelemetry
import repro_torch.core as core
import repro_torch.core.heuristics as heuristics
import repro_torch.interconnect as interconnect
import repro_torch.models.cnn as cnn
import repro_torch.power as power
import repro_torch.serve as serve
import repro_torch.telemetry as telemetry

REF = SimpleNamespace(core=jcore, heuristics=jheuristics, interconnect=jinterconnect, cnn=jcnn, power=jpower,
                      serve=jserve, telemetry=jtelemetry)
PORT = SimpleNamespace(core=core, heuristics=heuristics, interconnect=interconnect, cnn=cnn, power=power,
                       serve=serve, telemetry=telemetry)


def _run(fn, *args):
    return fn(PORT, *args), fn(REF, *args)


def _exports(tl) -> tuple:
    return tl.metrics_snapshot(), tl.export_jsonl(), json.dumps(tl.export_chrome_trace(), allow_nan=False)


def test_metrics_match_reference():
    vals = [0.7, 0.1, 3.2, 0.1, 2.5, 1.9, 0.4, 5.0, 0.9, 2.2, 0.3]

    def fn(m):
        tl = m.telemetry.Telemetry()
        h = tl.histogram("t")
        for v in vals:
            h.observe(v)
        c = tl.counter("x")
        c.inc()
        c.inc(2.5)
        tl.gauge("g").set(7)
        tl.span("s", 1.0, 0.5, cat="c", pid="p", tid="t", args={"a": 1})
        tl.instant("i", 2.0, cat="c", pid="p", tid="u")
        tl.counter_track("track", 3.0, 4.5, pid="p")
        with pytest.raises(TypeError):
            tl.histogram("x")
        quantiles = [h.quantile(q) for q in (0.0, 0.5, 0.9, 0.95, 0.99, 1.0)]
        return quantiles, h.snapshot(), tl.registry.names(), _exports(tl)

    ours, theirs = _run(fn)
    assert ours == theirs
    ref = sorted(vals)
    assert ours[0] == [serve.percentile(ref, q) for q in (0.0, 0.5, 0.9, 0.95, 0.99, 1.0)]


def test_live_normalizes_null_and_none():
    tl = telemetry.Telemetry()
    assert telemetry.live(tl) is tl
    assert telemetry.live(None) is None
    assert telemetry.live(telemetry.NULL) is None
    assert telemetry.live(telemetry.NullTelemetry()) is None


@pytest.mark.parametrize("network,n_eps", [("alexnet", 4), ("synthnet", 8)])
def test_trace_telemetry_matches_reference_and_leaves_the_wall(network, n_eps):
    def fn(m):
        layers = m.cnn.network_layers(network)
        plat = m.core.paper_platform(n_eps)
        bare = m.core.Trace(m.core.DatabaseEvaluator(plat, layers))
        tl = m.telemetry.Telemetry()
        traced = m.core.Trace(m.core.DatabaseEvaluator(plat, layers), telemetry=tl)
        r1 = m.heuristics.run_shisha(m.core.weights(layers), bare, "H3")
        r2 = m.heuristics.run_shisha(m.core.weights(layers), traced, "H3")
        assert (r2.result.best_conf, traced.wall) == (r1.result.best_conf, bare.wall)
        return bare.n_trials, _exports(tl)

    ours, theirs = _run(fn)
    assert ours == theirs
    snap = ours[1][0]
    assert snap["tune.trials"]["value"] == ours[0] == snap["tune.trial_cost_s"]["count"]


@pytest.mark.parametrize("routing", ["static", "adaptive"])
def test_tune_move_counters_match_reference(routing):
    """``tune(placement=True, dvfs=True)`` under a binding cap on a mesh:
    every move kind (boundary, relocation, DVFS up/down, the cap walk) and
    the fabric's routing passes land in the registry as the reference's."""

    def fn(m):
        layers = m.cnn.network_layers("synthnet")
        plat = m.core.paper_platform(8)
        fab = m.interconnect.uniform_fabric(m.interconnect.mesh2d(2, 4, bw=1e8, latency=1e-6), routing=routing)
        seed = m.core.generate_seed(m.core.weights(layers), plat, n_stages=4)
        pm = m.power.uniform_power(plat)
        pm.cap_w = 0.7 * pm.package_w(seed.conf.eps)
        plat = plat.with_fabric(fab).with_power(pm)
        tl = m.telemetry.Telemetry()
        plat.fabric.telemetry = tl
        trace = m.core.Trace(m.core.DatabaseEvaluator(plat, layers), telemetry=tl)
        res = m.core.tune(seed, trace, placement=True, dvfs=True)
        return res.best_conf, res.dvfs_levels, trace.wall, _exports(tl)

    ours, theirs = _run(fn)
    assert (ours[0].stages, ours[0].eps, ours[1:]) == (theirs[0].stages, theirs[0].eps, theirs[1:])
    snap = ours[3][0]
    assert "tune.moves.dvfs_cap" in snap and "fabric.routing_passes" in snap
    assert any(k.startswith("tune.moves.relocation") or k.startswith("tune.moves.boundary") for k in snap)


def test_adaptive_fabric_pricing_matches_reference_and_null_changes_nothing():
    def fn(m):
        topo = m.interconnect.mesh2d(3, 3)
        flows = [m.interconnect.Flow(0, 8, 4e6, nodes=True), m.interconnect.Flow(2, 6, 4e6, nodes=True),
                 m.interconnect.Flow(0, 6, 2e6, nodes=True)]
        bare = m.interconnect.uniform_fabric(topo, mc_bw=None, routing="adaptive", seed=1).flow_times(flows)
        out = []
        for sink in (None, m.telemetry.NULL, m.telemetry.Telemetry()):
            fab = m.interconnect.uniform_fabric(topo, mc_bw=None, routing="adaptive", seed=1)
            fab.telemetry = m.telemetry.live(sink)
            out.append(fab.flow_times(flows) == bare)
        return bare, out, _exports(sink), len(m.telemetry.NULL.registry), len(m.telemetry.NULL.tracer)

    ours, theirs = _run(fn)
    assert ours == theirs
    assert ours[1] == [True, True, True] and ours[3:] == (0, 0)
    snap = ours[2][0]
    assert snap["fabric.routing_passes"]["value"] == 1.0
    assert "fabric.adaptive_delta_s" in snap and snap["fabric.contention_factor"]["max"] >= 1.0


def _drift_serve(m, sink, scenario):
    """``tests/test_telemetry.py``'s drifting serve, and a thermal one."""
    layers = m.cnn.network_layers("synthnet")
    plat = m.core.paper_platform(8 if scenario == "drift" else 4)
    if scenario == "thermal":
        plat = plat.with_power(m.power.uniform_power(plat, thermal=m.power.uniform_thermal(4, seed=1)))
    ev = m.core.DatabaseEvaluator(plat, layers)
    sh = m.heuristics.run_shisha(m.core.weights(layers), m.core.Trace(ev), "H3")
    conf, cap = sh.result.best_conf, sh.result.best_throughput
    tuner = m.serve.ContinuousShisha(plat, layers, make_evaluator=lambda p: m.core.DatabaseEvaluator(p, layers),
                                     measure_batches=2, alpha=4)
    tl = {"none": None, "null": m.telemetry.NULL, "live": m.telemetry.Telemetry()}[sink]
    sim = m.serve.ServingSimulator(ev, conf, slo=3.0, autotuner=tuner, telemetry=tl)
    times = ev.stage_times(conf)
    sim.schedule_slowdown(10.0, conf.eps[max(range(conf.depth), key=times.__getitem__)], 3.0)
    res = sim.run(m.serve.PoissonTraffic(rate=0.5 * cap, seed=3).arrivals(40.0), 40.0)
    trials = sum(r.tune_result.n_explored for r in tuner.history)
    return dataclasses.asdict(res), trials, (_exports(tl) if sink == "live" else None)


@pytest.mark.parametrize("scenario", ["drift", "thermal"])
def test_serve_exports_match_reference_and_a_null_sink_changes_nothing(scenario):
    ours, theirs = _run(_drift_serve, "live", scenario)
    assert ours == theirs
    result, trials, (snap, jsonl, chrome) = ours
    if scenario == "drift":
        assert result["reconfigs"], "the scenario must re-tune to pin anything"
    assert snap["tune.trials"]["value"] == trials
    for sink in ("none", "null"):
        assert _drift_serve(PORT, sink, scenario)[:2] == (result, trials)
    assert len(telemetry.NULL.registry) == 0 and len(telemetry.NULL.tracer) == 0
    assert _drift_serve(PORT, "live", scenario) == ours  # byte-identical on a rerun
    if scenario == "thermal":
        rows = [json.loads(line) for line in jsonl.splitlines()]
        assert any(r["name"].startswith("thermal.temp_c:") and r["ph"] == "C" for r in rows)
        assert "power.energy_j" in snap


# ---------------------------------------------------------------------------
# co-serve: exports, the three layers, the NULL sink, package-deal steals
# ---------------------------------------------------------------------------


def _co_serve_run(m, sink):
    """``tests/test_telemetry.py``'s co-serve run: ResNet50 and AlexNet on a
    2x4 mesh, an EP dead at 2 s; ``sink`` is "none", "null" or "live"."""
    plat = m.core.paper_platform(8).with_fabric(m.interconnect.uniform_fabric(m.interconnect.mesh2d(2, 4)))
    horizon = 8.0
    tenants = [
        m.serve.Tenant(name="resnet50", layers=tuple(m.cnn.network_layers("resnet50")),
                       traffic=m.serve.ReplayTraffic.record(m.serve.PoissonTraffic(rate=30, seed=1), horizon), slo=1.0),
        m.serve.Tenant(name="alexnet", layers=tuple(m.cnn.network_layers("alexnet")),
                       traffic=m.serve.ReplayTraffic.record(m.serve.PoissonTraffic(rate=40, seed=2), horizon), slo=0.5),
    ]
    tl = {"none": None, "null": m.telemetry.NULL, "live": m.telemetry.Telemetry()}[sink]
    res = m.serve.co_serve(plat, tenants, horizon=horizon, measure_batches=2, alpha=4, faults=[("dropout", 2.0, 0)],
                           telemetry=tl)
    return res, tl


def test_seeded_co_serve_exports_match_reference_byte_for_byte():
    (ours, tl), (theirs, jtl) = _run(_co_serve_run, "live")
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert _exports(tl) == _exports(jtl)
    again, tl_b = _co_serve_run(PORT, "live")
    assert _exports(tl_b) == _exports(tl) and tl.export_jsonl()
    assert json.dumps(tl.metrics_snapshot(), sort_keys=True) == json.dumps(tl_b.metrics_snapshot(), sort_keys=True)


def test_chrome_trace_has_all_three_layers_and_tenant_processes():
    res, tl = _co_serve_run(PORT, "live")
    trace = tl.export_chrome_trace()
    events = json.loads(json.dumps(trace, allow_nan=False))["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"]
    assert {"request", "retune", "fabric"} <= {e.get("cat") for e in spans}
    assert all(isinstance(e["pid"], int) and isinstance(e["tid"], int) and e["dur"] >= 0 and e["ts"] >= 0
               for e in spans)
    meta = lambda kind: {e["args"]["name"] for e in events if e.get("ph") == "M" and e["name"] == kind}
    assert {"resnet50", "alexnet"} <= meta("process_name")
    tracks = meta("thread_name")
    assert any(t.startswith("ep") for t in tracks) and "flows" in tracks
    assert res.repartitions and any(e.get("ph") == "i" and e["name"] == "repartition" for e in events)
    lines = tl.export_jsonl().splitlines()
    assert len(lines) == len(tl.tracer.events)
    for line in lines:
        json.loads(line)


def test_nullsink_co_serve_matches_bare_run_and_the_reference():
    (null, _), (ref_null, _) = _run(_co_serve_run, "null")
    bare, _ = _co_serve_run(PORT, "none")
    assert dataclasses.asdict(null) == dataclasses.asdict(bare) == dataclasses.asdict(ref_null)
    assert len(telemetry.NULL.registry) == 0 and len(telemetry.NULL.tracer) == 0


def _bundle_run(m):
    plat = m.core.paper_platform(8)
    horizon = 12.0
    layers_v, layers_d = tuple(m.cnn.network_layers("synthnet")), tuple(m.cnn.network_layers("alexnet"))
    # victim demand ~3x what its launch partition can serve; donor idle
    parts = m.serve.partition_eps(plat, 2, "interleaved")
    cap = m.heuristics.run_shisha(m.core.weights(list(layers_v)), m.core.Trace(
        m.core.DatabaseEvaluator(m.serve.subplatform(plat, parts[0], "v"), list(layers_v))), "H3").result.best_throughput
    tenants = [
        m.serve.Tenant(name="victim", layers=layers_v, slo=1.0,
                       traffic=m.serve.ReplayTraffic.record(m.serve.PoissonTraffic(rate=3.0 * cap, seed=5), horizon)),
        m.serve.Tenant(name="donor", layers=layers_d, slo=5.0,
                       traffic=m.serve.ReplayTraffic.record(m.serve.PoissonTraffic(rate=0.5, seed=6), horizon)),
    ]
    tl = m.telemetry.Telemetry()
    res = m.serve.co_serve(plat, tenants, horizon=horizon, measure_batches=2, alpha=4,
                           faults=[("dropout", 3.0, parts[0][0])], telemetry=tl, max_bundle=3)
    return res, tl


def test_extreme_pressure_victim_steals_a_bundle_as_the_reference():
    (res, tl), (ref, jtl) = _run(_bundle_run)
    assert dataclasses.asdict(res) == dataclasses.asdict(ref)
    assert _exports(tl) == _exports(jtl)
    ev = next(e for e in res.repartitions if e.kind == "dropout")
    assert ev.victim == "victim" and len(ev.bundle) >= 2, f"expected a package deal, got {ev.bundle}"
    assert (ev.bundle[0]["donor"], ev.bundle[0]["ep"], ev.bundle[0]["price"]) == (ev.donor, ev.stolen_ep, ev.price)
    for deal in ev.bundle:
        assert deal["donor"] == "donor"
        assert set(deal) == {"donor", "ep", "price", "gain", "surplus", "victim_at_risk_after"}
        assert deal["surplus"] is None or deal["surplus"] > 0
    assert {d["ep"] for d in ev.bundle} <= set(ev.partitions["victim"])
    assert not set(ev.partitions["victim"]) & set(ev.partitions["donor"])
    json.dumps([dict(d) for d in ev.bundle], allow_nan=False)
    inst = next(e for e in tl.tracer.events if e.name == "repartition" and e.dur is None)
    assert len(inst.args["bundle"]) == len(ev.bundle)
    assert tl.metrics_snapshot()["coserve.eps_stolen"]["value"] == len(ev.bundle)


def test_single_bundle_is_the_single_steal_as_the_reference():
    """``max_bundle=1`` reproduces ``rebalance`` exactly."""

    def fn(m):
        plat = m.core.paper_platform(8)
        tenants = {name: m.serve.Tenant(name=name, layers=tuple(m.cnn.network_layers(net)),
                                        traffic=m.serve.PoissonTraffic(rate=1, seed=1), slo=1.0)
                   for name, net in (("a", "synthnet"), ("b", "alexnet"))}
        pricer = m.serve.ElasticPartitioner(plat, lambda p, L: m.core.DatabaseEvaluator(p, L), "H3")
        partitions = {"a": (0, 2, 4), "b": (1, 3, 5, 6, 7)}
        loads = {"a": (50.0, 20.0), "b": (0.1, 0.0)}
        single = pricer.rebalance(partitions, "a", tenants, loads)
        bundle = pricer.rebalance_bundle(partitions, "a", tenants, loads, max_bundle=1)
        return single, bundle, partitions

    ours, theirs = _run(fn)
    assert ours == theirs
    single, (deals, parts), partitions = ours
    assert single is not None and len(deals) == 1
    donor, ep, price = single
    assert (deals[0]["donor"], deals[0]["ep"], deals[0]["price"]) == (donor, ep, price)
    assert parts["a"] == partitions["a"] + (ep,)
    assert partitions == {"a": (0, 2, 4), "b": (1, 3, 5, 6, 7)}  # the input mapping was not mutated
