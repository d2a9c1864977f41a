"""The port's chaos layer against the JAX package's, at tolerance zero.

``repro_torch.faults`` is a copy of ``repro.faults``, and
``Platform.with_faults`` of the reference's.  The same fault model on the
same platform must give the same chaos trace and the same batch-failure
streams; the serving simulator driven by it (with and without a
``ResiliencePolicy`` and ``ContinuousShisha``) the same ``SimResult``, and
``co_serve`` with a fault model and a policy the same ``CoServeResult``.
``tests/test_chaos.py`` is mirrored.
"""

import dataclasses
import json
import math
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")  # CI installs requirements-dev.txt, which has no torch

import repro.core as jcore
import repro.faults as jfaults
import repro.faults.injector as jinjector
import repro.interconnect as jinterconnect
import repro.models.cnn as jcnn
import repro.serve as jserve
import repro.telemetry as jtelemetry
import repro_torch.core as core
import repro_torch.faults as faults
import repro_torch.faults.injector as injector
import repro_torch.interconnect as interconnect
import repro_torch.models.cnn as cnn
import repro_torch.serve as serve
import repro_torch.telemetry as telemetry

REF = SimpleNamespace(core=jcore, faults=jfaults, injector=jinjector, interconnect=jinterconnect, cnn=jcnn,
                      serve=jserve, telemetry=jtelemetry)
PORT = SimpleNamespace(core=core, faults=faults, injector=injector, interconnect=interconnect, cnn=cnn,
                       serve=serve, telemetry=telemetry)

#: the chaos spec of ``tests/test_chaos.py``
CHAOS = dict(seed=7, ep_mtbf={1: 8.0, 2: 8.0}, ep_mttr={1: 2.0, 2: 2.0}, link_mtbf=12.0, link_mttr=2.0,
             batch_error_p=0.03)
MODELS = {
    "chaos": CHAOS,
    "chaos_seed8": {**CHAOS, "seed": 8},
    "domains": dict(seed=3, ep_mtbf={1: 4.0}, ep_mttr={1: 2.0}, domains=((0, 1),), domain_mtbf=4.0,
                    domain_mttr=2.0),
    "links": dict(seed=5, link_mtbf=6.0, link_mttr=3.0, degrade_mtbf=4.0, degrade_mttr=4.0),
    "slow_class": dict(seed=2, ep_mtbf={1: 3.0, 2: 3.0}, ep_mttr={1: 4.0, 2: 4.0}),
    "doom": dict(seed=1, ep_mtbf={1: 1e-9, 2: 1e-9}, ep_mttr={1: 1e9, 2: 1e9}),
    "hot_batches": {**CHAOS, "batch_error_p": 0.6},
    "none": dict(),
}


def _run(fn, *args):
    return fn(PORT, *args), fn(REF, *args)


def _platform(m, n_eps=8, rows=2):
    return m.core.paper_platform(n_eps).with_fabric(
        m.interconnect.uniform_fabric(m.interconnect.mesh2d(rows, n_eps // rows, bw=1e9, latency=1e-6)))


@pytest.mark.parametrize("horizon", [30.0, 60.0])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_chaos_trace_and_batch_failures_match_reference(name, horizon):
    def fn(m):
        inj = m.faults.FaultInjector(m.faults.FaultModel(**MODELS[name]))
        trace = inj.trace(_platform(m), horizon)
        streams = []
        for label in ("serve", "a", "b"):
            s = inj.batch_failures(label)
            streams.append(None if s is None else [s.fails() for _ in range(64)])
        return [dataclasses.asdict(e) for e in trace], streams

    ours, theirs = _run(fn)
    assert ours == theirs
    if name not in ("none",):
        assert ours[0], "the model must inject something to pin anything"


def test_injector_helpers_match_reference():
    def fn(m):
        merged = m.injector._merge([(1.0, 4.0), (3.0, 6.0), (8.0, 9.0)])
        draws = [m.injector.stream(s, kind, key).random() for s in (1, 2) for kind, key in
                 (("ep", 0), ("ep", 1), ("link", (0, 1)), ("degrade", (0, 1)))]
        return merged, draws

    ours, theirs = _run(fn)
    assert ours == theirs
    assert ours[0] == [(1.0, 6.0), (8.0, 9.0)]
    assert faults.FAULT_KINDS == jfaults.FAULT_KINDS


def test_fault_event_model_and_platform_validation_match_reference():
    bad = [
        lambda m: m.faults.FaultEvent(t=1.0, kind="dropout"),
        lambda m: m.faults.FaultEvent(t=1.0, kind="link", link=(0, 1), factor=2.0),
        lambda m: m.faults.FaultEvent(t=-1.0, kind="dropout", ep=0),
        lambda m: m.faults.FaultEvent(t=1.0, kind="meltdown", ep=0),
        lambda m: m.faults.FaultModel(ep_mtbf={1: 5.0}),
        lambda m: m.faults.FaultModel(ep_mtbf={1: -5.0}, ep_mttr={1: 1.0}),
        lambda m: m.core.paper_platform(4).with_faults(
            m.faults.FaultModel(domains=((0, 9),), domain_mtbf=1.0, domain_mttr=1.0)),
        lambda m: m.faults.ResiliencePolicy(deadline_s=0.0),
        lambda m: m.faults.ResiliencePolicy(max_retries=-1),
        lambda m: m.faults.ResiliencePolicy(queue_cap=0),
    ]
    for make in bad:
        for m in (PORT, REF):
            with pytest.raises(ValueError):
                make(m)

    def fn(m):
        plat = m.core.paper_platform(4)
        fm = m.faults.FaultModel(**CHAOS)
        attached = plat.with_faults(fm)
        smaller = attached.without([3])
        pol = m.faults.ResiliencePolicy(backoff_s=0.1, jitter=0.5, seed=9)
        return (attached == plat, attached.faults is fm, smaller.faults, fm.enabled, m.faults.no_faults().enabled,
                dataclasses.asdict(m.faults.no_faults(3)), [pol.backoff(r, a) for r in (3, 4) for a in (1, 2, 3)],
                pol.expired(1.0, 2.0), m.faults.ResiliencePolicy(deadline_s=0.5).expired(1.0, 2.0))

    ours, theirs = _run(fn)
    assert ours == theirs
    assert ours[:3] == (True, True, None)


RUNS = {
    # (fault model or None for the bare platform, resilience policy kwargs or None, autotuner)
    "bare": (None, None, False),
    "no_faults": ("none", None, False),
    "chaos": ("chaos", None, False),
    "chaos_resilient": ("chaos", dict(deadline_s=1.0, max_retries=2, queue_cap=64), False),
    "chaos_tuned": ("chaos", dict(deadline_s=1.0), True),
    "queue_cap": ("slow_class", dict(deadline_s=0.5, max_retries=1, queue_cap=4), False),
    "retry_cap": ("hot_batches", dict(deadline_s=None, max_retries=0, backoff_s=0.01), False),
    "doom": ("doom", None, False),
    "inert_policy": (None, dict(deadline_s=1e9, max_retries=2, queue_cap=10_000), False),
}


def _chaos_serve(m, name, engine="EventLoop", live=False):
    """``tests/test_chaos.py``'s ``_run`` on its 2x4-mesh fixture."""
    model, pol, tuned = RUNS[name]
    layers = m.cnn.network_layers("synthnet")
    plat = _platform(m)
    ev0 = m.core.DatabaseEvaluator(plat, layers)
    res = m.core.tune(m.core.generate_seed(m.core.weights(layers), plat), m.core.Trace(ev0))
    if model is not None:
        plat = plat.with_faults(m.faults.FaultModel(**MODELS[model]))
    tuner = None
    if tuned:
        tuner = m.serve.ContinuousShisha(plat, layers, make_evaluator=lambda p: m.core.DatabaseEvaluator(p, layers),
                                         measure_batches=2, alpha=4)
    tl = m.telemetry.Telemetry() if live else None
    sim = m.serve.ServingSimulator(m.core.DatabaseEvaluator(plat, layers), res.best_conf, slo=1.0,
                                   resilience=None if pol is None else m.faults.ResiliencePolicy(**pol),
                                   autotuner=tuner, loop=getattr(m.serve, engine)(), telemetry=tl)
    result = sim.run(m.serve.PoissonTraffic(rate=10.0, seed=5).arrivals(30.0), 30.0)
    out = dataclasses.asdict(result)
    if tuner is not None:
        out["history"] = [(r.kind, r.conf.stages, r.conf.eps, r.tuning_cost) for r in tuner.history]
    if live:
        out["jsonl"] = tl.export_jsonl()
        out["metrics"] = tl.metrics_snapshot()
    return out


@pytest.mark.parametrize("engine", ["EventLoop", "HeapEventLoop"])
@pytest.mark.parametrize("name", sorted(RUNS))
def test_chaos_serving_matches_reference(name, engine):
    ours, theirs = _run(_chaos_serve, name, engine)
    assert ours == theirs
    json.dumps(ours, allow_nan=False)


def test_chaos_contracts_hold_on_the_port():
    """``tests/test_chaos.py``'s contracts, on the port's own runs."""
    run = {name: _chaos_serve(PORT, name) for name in RUNS}
    strip = lambda r: {k: v for k, v in r.items() if k not in ("history",)}
    assert strip(run["no_faults"]) == strip(run["bare"])
    assert run["chaos"]["n_retries"] > 0
    assert run["chaos"] == _chaos_serve(PORT, "chaos", "HeapEventLoop")
    assert run["inert_policy"]["latencies"] == run["bare"]["latencies"]
    assert run["inert_policy"]["n_shed"] == run["inert_policy"]["n_failed"] == 0
    assert run["queue_cap"]["n_shed"] > 0 and run["queue_cap"]["availability"] < 1.0
    assert run["retry_cap"]["n_failed"] > 0 and run["retry_cap"]["n_retries"] == 0
    assert run["doom"]["n_completed"] == 0 and run["doom"]["p50"] is None
    assert run["chaos_tuned"]["history"]
    live = [_chaos_serve(PORT, "chaos", live=True) for _ in range(2)]
    assert live[0] == live[1]
    assert '"chaos:' in live[0]["jsonl"]
    # the live session changes nothing but what it records
    assert {k: v for k, v in live[0].items() if k not in ("jsonl", "metrics")} == run["chaos"]
    bare_tl, degen_tl = _chaos_serve(PORT, "bare", live=True), _chaos_serve(PORT, "no_faults", live=True)
    assert bare_tl == degen_tl


def test_severed_boundary_and_link_state_match_reference():
    def fn(m):
        layers = m.cnn.network_layers("synthnet")
        plat = m.core.paper_platform(4).with_fabric(
            m.interconnect.uniform_fabric(m.interconnect.mesh2d(1, 4, bw=1e9, latency=1e-6)))
        fabric = plat.fabric
        before = fabric.latency_ep(0, 3)
        lane = fabric.restrict([2, 3])
        fabric.fail_link(1, 2)
        out = [fabric.latency_ep(0, 3), fabric.marooned_eps(), fabric.fault_fingerprint(), lane.latency_ep(0, 1)]
        trace = m.core.Trace(m.core.DatabaseEvaluator(plat, layers))
        out += [trace.execute(m.core.PipelineConfig(stages=(len(layers) - 1, 1), eps=(1, 2))), trace.wall]
        fabric.restore_link(1, 2)
        out += [fabric.latency_ep(0, 3) == before, fabric.fault_fingerprint()]
        return out

    ours, theirs = _run(fn)
    assert ours == theirs
    assert math.isinf(ours[0]) and ours[4] == 0.0


def test_co_serve_chaos_matches_reference_and_is_deterministic():
    """``co_serve(chaos=, resilience=)``: the seeded fault trace expanded over
    the global platform and every lane's policy give the reference's
    ``CoServeResult``, twice."""

    def go(m):
        layers = tuple(m.cnn.network_layers("synthnet"))
        tenants = [m.serve.Tenant(name="a", layers=layers, traffic=m.serve.PoissonTraffic(rate=4.0, seed=1)),
                   m.serve.Tenant(name="b", layers=layers, traffic=m.serve.PoissonTraffic(rate=4.0, seed=2))]
        chaos = m.faults.FaultModel(**{**CHAOS, "batch_error_p": 0.1})
        pol = m.faults.ResiliencePolicy(deadline_s=5.0, max_retries=2, queue_cap=256)
        return m.serve.co_serve(_platform(m), tenants, horizon=12.0, chaos=chaos, resilience=pol, measure_batches=2,
                                alpha=4)

    ours, theirs = _run(go)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert [r.sim for r in ours.results] == [r.sim for r in go(PORT).results]
    assert all(r.sim.goodput_rps <= r.sim.throughput_rps for r in ours.results)
    assert sum(r.sim.n_retries for r in ours.results) > 0
    json.dumps([dataclasses.asdict(r.sim) for r in ours.results], allow_nan=False)


def test_subplatform_drops_fault_spec():
    plat = core.paper_platform(4).with_faults(faults.FaultModel(**CHAOS))
    assert serve.subplatform(plat, [0, 1], "sub").faults is None
    assert plat.without([3]).faults is None
