"""The port's multi-tenant co-serving against the JAX package's, at tolerance zero.

``repro_torch.serve.multitenant`` is a copy of ``repro.serve.multitenant``:
EP partitioning, the ``ElasticPartitioner`` and the shared-clock elastic
co-simulator behind ``co_serve``.  Each of the 13 tests of
``tests/test_multitenant_serve.py`` is mirrored here.  Each runs the
reference's scenario through both packages (``_run``) on the reference's
fixture (``paper_platform(8)``, SynthNet and ResNet50 on an interleaved
partition over ``DatabaseEvaluator``), asserts the reference's claims on the
port's result, and holds the port's ``CoServeResult`` against the
reference's with ``==`` on ``dataclasses.asdict``: each tenant's
``SimResult``, ``ep_idxs``, ``conf_pretty``, ``n_trials``, ``batch_policy``
and model throughput, every ``RepartitionEvent``, the final partitions and
the dead set.
"""

import dataclasses
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")  # CI installs requirements-dev.txt, which has no torch

import repro.core as jcore
import repro.core.heuristics as jheuristics
import repro.models.cnn as jcnn
import repro.serve as jserve
import repro_torch.core as core
import repro_torch.core.heuristics as heuristics
import repro_torch.models.cnn as cnn
import repro_torch.serve as serve

REF = SimpleNamespace(core=jcore, heuristics=jheuristics, cnn=jcnn, serve=jserve)
PORT = SimpleNamespace(core=core, heuristics=heuristics, cnn=cnn, serve=serve)

HORIZON = 150.0
FAULT_T = HORIZON / 3.0


def _run(fn, *args):
    """``fn(package, *args)`` through the port and the reference."""
    return fn(PORT, *args), fn(REF, *args)


def assert_same(ours, theirs) -> None:
    """Every field of two ``CoServeResult``\\ s (tenants, their results and
    ``SimResult``\\ s, events, partitions, dead set), compared with ``==``."""
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def _plat(m):
    return m.core.paper_platform(8)


def _tenants(m):
    """Victim at 65% of its partition capacity, donor deeply headroomed;
    traffic recorded so both arms of any comparison replay one stream."""
    plat = _plat(m)
    parts = m.serve.partition_eps(plat, 2, "interleaved")
    caps, layer_sets = {}, {}
    for name, part in zip(("synthnet", "resnet50"), parts):
        layers = m.cnn.network_layers(name)
        ev = m.core.DatabaseEvaluator(m.serve.subplatform(plat, part, name), layers)
        caps[name] = m.heuristics.run_shisha(m.core.weights(layers), m.core.Trace(ev), "H3").result.best_throughput
        layer_sets[name] = layers
    return [
        m.serve.Tenant(
            name="synthnet",
            layers=tuple(layer_sets["synthnet"]),
            traffic=m.serve.ReplayTraffic.record(m.serve.PoissonTraffic(rate=0.65 * caps["synthnet"], seed=11),
                                                 HORIZON),
            slo=2.7,
        ),
        m.serve.Tenant(
            name="resnet50",
            layers=tuple(layer_sets["resnet50"]),
            traffic=m.serve.ReplayTraffic.record(
                m.serve.MMPPTraffic(rate_low=0.08 * caps["resnet50"], rate_high=0.30 * caps["resnet50"], seed=12),
                HORIZON),
            slo=0.8,
        ),
    ]


def _co_serve(m, *, elastic, faults=()):
    return m.serve.co_serve(_plat(m), _tenants(m), horizon=HORIZON, elastic=elastic, batch_policy_search=True,
                            measure_batches=2, alpha=4, faults=list(faults))


def _served(elastic, faults=()):
    """The port's and the reference's run of one scenario, held equal."""
    ours, theirs = _run(lambda m: _co_serve(m, elastic=elastic, faults=faults))
    assert_same(ours, theirs)
    return ours


def _conserved(r) -> bool:
    return r.sim.n_arrived == r.sim.n_completed + r.sim.n_in_flight + r.sim.n_queued


DROPOUT = [("dropout", FAULT_T, 0)]


def test_tenants_fixture_matches_reference():
    ours, theirs = _run(_tenants)
    for a, b in zip(ours, theirs):
        assert (a.name, a.slo, a.share) == (b.name, b.slo, b.share)
        assert [dataclasses.astuple(x) for x in a.layers] == [dataclasses.astuple(x) for x in b.layers]
        assert a.traffic.arrivals(HORIZON) == b.traffic.arrivals(HORIZON)


# ---------------------------------------------------------------------------
# invariants
# ---------------------------------------------------------------------------


def test_partitions_disjoint_and_cover_alive_after_every_repartition():
    res = _served(True, DROPOUT)
    plat = _plat(PORT)
    assert res.repartitions, "the dropout must trigger at least one re-partition"
    dead_so_far: set[int] = set()
    for event in res.repartitions:
        dead_so_far.add(event.dead_ep)
        owned = [ep for part in event.partitions.values() for ep in part]
        assert len(owned) == len(set(owned)), f"overlap at t={event.t}: {event.partitions}"
        assert set(owned) == set(range(plat.n_eps)) - dead_so_far
    assert res.partitions == res.repartitions[-1].partitions
    assert res.dead == frozenset(dead_so_far)


@pytest.mark.parametrize("elastic", [False, True])
def test_global_queue_conservation_at_horizon(elastic):
    res = _served(elastic, DROPOUT)
    assert all(_conserved(r) for r in res.results), f"a tenant leaked requests (elastic={elastic})"
    total_arrived = sum(r.sim.n_arrived for r in res.results)
    assert total_arrived == sum(r.sim.n_completed + r.sim.n_in_flight + r.sim.n_queued for r in res.results)
    assert total_arrived == sum(len(t.traffic.arrivals(HORIZON)) for t in _tenants(PORT))


def test_no_ep_oversubscription_across_tenants():
    res = _served(True, DROPOUT)
    assert res.repartitions
    total: dict[str, float] = {}
    for r in res.results:
        for name, occ in r.sim.occupancy.items():
            total[name] = total.get(name, 0.0) + occ
    assert all(v <= 1.0 + 1e-9 for v in total.values()), total


# ---------------------------------------------------------------------------
# behaviour
# ---------------------------------------------------------------------------


def test_co_serve_is_deterministic():
    runs = [_served(True, DROPOUT) for _ in range(2)]
    assert dataclasses.asdict(runs[0]) == dataclasses.asdict(runs[1])
    for a, b in zip(runs[0].results, runs[1].results):
        assert a.sim.latencies == b.sim.latencies
        assert a.sim.reconfigs == b.sim.reconfigs


def test_elastic_beats_static_under_fep_dropout():
    static = _served(False, DROPOUT)
    elastic = _served(True, DROPOUT)
    assert elastic.aggregate_slo_rate < static.aggregate_slo_rate
    assert static.repartitions == []
    assert len(elastic.repartitions) == 1
    event = elastic.repartitions[0]
    assert event.victim == "synthnet"
    assert event.stolen_ep is not None and event.donor == "resnet50"
    assert set(event.retune_costs) == {"synthnet", "resnet50"}
    assert all(c > 0 for c in event.retune_costs.values())


def test_fault_during_exploration_window_survives_install():
    res = _served(True, [("dropout", FAULT_T, 0), ("slowdown", FAULT_T + 5.0, 2, 3.0)])
    assert len(res.repartitions) == 1
    syn = next(r for r in res.results if r.tenant.name == "synthnet")
    assert _conserved(syn)
    kinds = [rc["kind"] for rc in syn.sim.reconfigs]
    assert "repartition" in kinds
    assert "slowdown" in kinds, f"post-install drift was lost: {kinds}"


def test_global_slowdown_lands_on_owner_lane():
    res = _served(True, [("slowdown", FAULT_T, 1, 3.0)])
    r50 = next(r for r in res.results if r.tenant.name == "resnet50")
    syn = next(r for r in res.results if r.tenant.name == "synthnet")
    assert any(rc["kind"] == "slowdown" for rc in r50.sim.reconfigs)
    assert syn.sim.reconfigs == []
    assert res.repartitions == []


def test_revived_ep_rejoins_exactly_one_tenant():
    res = _served(True, [("dropout", FAULT_T, 0), ("revival", 2 * FAULT_T, 0)])
    assert [e.kind for e in res.repartitions] == ["dropout", "revival"]
    revival = res.repartitions[-1]
    assert revival.stolen_ep == 0 and revival.donor is None
    owners = [name for name, part in res.partitions.items() if 0 in part]
    assert owners == [revival.victim]
    assert 0 not in res.dead
    assert set(revival.retune_costs) == {revival.victim}
    assert revival.retune_costs[revival.victim] > 0
    owned = [ep for part in res.partitions.values() for ep in part]
    assert len(owned) == len(set(owned)) and set(owned) == set(range(8))
    assert all(_conserved(r) for r in res.results)


def test_revival_inside_repartition_window_is_not_orphaned():
    res = _served(True, [("dropout", FAULT_T, 0), ("revival", FAULT_T + 2.0, 0)])
    assert 0 not in res.dead
    owned = [ep for part in res.partitions.values() for ep in part]
    assert len(owned) == len(set(owned))
    assert set(owned) == set(range(8)), f"revived EP was orphaned: partitions cover {sorted(owned)}"
    assert [e.kind for e in res.repartitions] == ["dropout", "revival"]


def test_co_schedule_keeps_fixed_partitions():
    ours, theirs = _run(lambda m: m.serve.co_schedule(_plat(m), _tenants(m), horizon=60.0))
    assert [dataclasses.asdict(r) for r in ours] == [dataclasses.asdict(r) for r in theirs]
    parts = serve.partition_eps(_plat(PORT), 2, "interleaved")
    for row, part in zip(ours, parts):
        assert row.ep_idxs == tuple(part)
        assert _conserved(row)


# ---------------------------------------------------------------------------
# pricing unit behaviour
# ---------------------------------------------------------------------------


def _pricer(m):
    return m.serve.ElasticPartitioner(_plat(m), lambda p, L: m.core.DatabaseEvaluator(p, L))


def test_partitioner_prices_headroomed_donor_near_zero():
    def fn(m):
        ep = _pricer(m)
        donor = _tenants(m)[1]  # resnet50, huge capacity
        part = (1, 3, 5, 7)
        cap = ep.tuned_throughput(donor, part)
        return ep.price(donor, part, 3, demand=1.0, urgency=0.0), cap, ep.price(donor, part, 3, demand=cap,
                                                                                 urgency=0.0)

    ours, theirs = _run(fn)
    assert ours == theirs
    free, _, dear = ours
    assert free == 0.0
    assert dear > 0.0


def test_rebalance_insensitive_to_partition_insertion_order():
    def fn(m):
        tmap = {t.name: t for t in _tenants(m)}
        base = {"synthnet": (0, 2, 4), "resnet50": (1, 3, 5, 7)}
        flipped = {"resnet50": (1, 3, 5, 7), "synthnet": (0, 2, 4)}
        pricer = _pricer(m)
        cap = pricer.tuned_throughput(tmap["synthnet"], base["synthnet"])
        loads = {"synthnet": (2.0 * cap, 3.0), "resnet50": (1.0, 0.0)}
        a = pricer.rebalance_bundle(base, "synthnet", tmap, loads, max_bundle=2)
        b = _pricer(m).rebalance_bundle(flipped, "synthnet", tmap, loads, max_bundle=2)
        again = pricer.rebalance_bundle(base, "synthnet", tmap, loads, max_bundle=2)
        return a, b, again

    ours, theirs = _run(fn)
    assert ours == theirs
    (deals_a, parts_a), (deals_b, parts_b), again = ours
    assert deals_a, "pressured victim with a headroomed donor must steal"
    assert deals_a == deals_b and parts_a == parts_b
    assert again == (deals_a, parts_a)


def test_partitioner_ignores_useless_ep_for_victim():
    def fn(m):
        ep = _pricer(m)
        victim = _tenants(m)[0]  # synthnet
        part = (2, 4, 6)
        cap = ep.tuned_throughput(victim, part)
        return (ep.gain(victim, part, 7, demand=2 * cap, urgency=5.0),
                ep.gain(victim, part, 1, demand=2 * cap, urgency=5.0))

    ours, theirs = _run(fn)
    assert ours == theirs
    slow_gain, fast_gain = ours
    assert slow_gain == 0.0
    assert fast_gain > 0.0
