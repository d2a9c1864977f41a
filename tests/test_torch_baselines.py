"""The port's comparison arms and design space against the JAX package's.

``repro_torch.core`` keeps its own copy of the paper's baselines (HC, SA,
RW, ES, Pipe-Search), the design-space enumeration, ``DatabaseEvaluator``,
``table3_platform`` and ``Trace``'s accounting.  Fed the same layer tables
and platforms, both packages must try the same configurations in the same
order with the same numbers, trial for trial: everything here is pure
Python, so the comparison is exact.
"""

import contextlib
import dataclasses
import io
import math
import random
import runpy
from pathlib import Path

import pytest

pytest.importorskip("torch")  # CI installs requirements-dev.txt, which has no torch
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

from repro import core as jcore
from repro.models.cnn import network_layers as j_network_layers
from repro_torch import core
from repro_torch.models.cnn import network_layers

ROOT = Path(__file__).resolve().parents[1]
NETWORKS = ["synthnet", "resnet50", "yolov3", "alexnet"]
#: simulated online budget of the budgeted arms, seconds (tens of trials)
BUDGET_S = 20.0
#: ES / Pipe-Search database depth (ES at depth 2 stays a few thousand trials)
ES_DEPTH, PS_DEPTH = 2, 3


def _confs(trials):
    return [(t.conf.stages, t.conf.eps, t.throughput, t.t_wall) for t in trials]


def _evaluators(kind: str, name: str, n_eps: int):
    if kind == "analytic":
        return (core.AnalyticEvaluator(core.paper_platform(n_eps), network_layers(name)),
                jcore.AnalyticEvaluator(jcore.paper_platform(n_eps), j_network_layers(name)))
    return (core.DatabaseEvaluator(core.paper_platform(n_eps), network_layers(name)),
            jcore.DatabaseEvaluator(jcore.paper_platform(n_eps), j_network_layers(name)))


def _arm(pkg, arm: str, trace, layers, n_eps: int):
    """Run one comparison arm of ``pkg`` (the port's core or the reference's)
    as ``benchmarks/fig4_convergence.py`` runs it."""
    n, ws = len(layers), pkg.weights(layers)
    seed_conf = pkg.generate_seed(ws, trace.evaluator.platform, choice="rank_w").conf
    db = pkg.database_generation_cost(n, n_eps, PS_DEPTH)
    return {
        "HC": lambda: pkg.hill_climbing(trace, n, BUDGET_S, seed=0),
        "HC_s": lambda: pkg.hill_climbing(trace, n, BUDGET_S, start=seed_conf, seed=0),
        "SA": lambda: pkg.simulated_annealing(trace, n, BUDGET_S, seed=1),
        "SA_s": lambda: pkg.simulated_annealing(trace, n, BUDGET_S, start=seed_conf, seed=0),
        "RW": lambda: pkg.random_walk(trace, n, BUDGET_S, seed=2),
        "ES": lambda: pkg.exhaustive_search(trace, n, max_depth=ES_DEPTH),
        "PS": lambda: pkg.pipe_search(trace, ws, budget_s=db + BUDGET_S, max_depth=PS_DEPTH),
    }[arm]()


@pytest.mark.parametrize("arm", ["HC", "HC_s", "SA", "SA_s", "RW", "ES", "PS"])
@pytest.mark.parametrize("kind", ["analytic", "database"])
@pytest.mark.parametrize("n_eps", [4, 8])
@pytest.mark.parametrize("name", NETWORKS)
def test_comparison_arm_matches_reference_trial_for_trial(name, n_eps, kind, arm):
    ev, jev = _evaluators(kind, name, n_eps)
    setup = core.database_generation_cost(len(ev.layers), n_eps, PS_DEPTH) if arm == "PS" else 0.0
    tr, jtr = core.Trace(ev, setup_cost=setup), jcore.Trace(jev, setup_cost=setup)
    res = _arm(core, arm, tr, ev.layers, n_eps)
    jres = _arm(jcore, arm, jtr, jev.layers, n_eps)
    assert (res.name, res.best_conf.stages, res.best_conf.eps) == (jres.name, jres.best_conf.stages, jres.best_conf.eps)
    assert res.best_throughput == jres.best_throughput
    assert res.n_explored == jres.n_explored == tr.n_trials == jtr.n_trials > 0
    assert tr.wall == jtr.wall
    assert _confs(tr.trials) == _confs(jtr.trials)
    assert tr.convergence_curve() == jtr.convergence_curve()
    if arm == "ES":
        assert tr.n_trials == core.space_size(len(ev.layers), n_eps, ES_DEPTH)


@pytest.mark.parametrize("max_depth", [None, 2, 3])
@pytest.mark.parametrize("n_eps", [4, 8])
@pytest.mark.parametrize("n_layers", [5, 18, 50])
def test_database_generation_cost_matches_reference(n_layers, n_eps, max_depth):
    for per_entry in (2e-4, 1e-3):
        assert core.database_generation_cost(n_layers, n_eps, max_depth, per_entry) == \
            jcore.database_generation_cost(n_layers, n_eps, max_depth, per_entry)


def test_es_is_the_optimum_of_every_arm():
    """The race's check: ES over the whole space bounds every other arm."""
    layers = network_layers("synthnet")
    ev = core.AnalyticEvaluator(core.paper_platform(4), layers)
    es = core.exhaustive_search(core.Trace(ev), len(layers))
    assert core.Trace(ev).evaluator is ev and es.n_explored == core.space_size(18, 4) == 19_792
    for arm in ("HC", "HC_s", "SA", "SA_s", "RW", "PS"):
        setup = core.database_generation_cost(18, 4, PS_DEPTH) if arm == "PS" else 0.0
        assert _arm(core, arm, core.Trace(ev, setup_cost=setup), layers, 4).best_throughput <= es.best_throughput
    sh = core.run_shisha(core.weights(layers), core.Trace(ev), "H3")
    assert sh.result.best_throughput <= es.best_throughput


# ---------------------------------------------------------------------------
# Design space (mirrors tests/test_space_and_config.py)
# ---------------------------------------------------------------------------


@given(st.integers(2, 10), st.integers(1, 5))
@settings(max_examples=60, deadline=None)
def test_compositions_count_validity_and_order_match_reference(L, d):
    d = min(d, L)
    comps = list(core.compositions(L, d))
    assert comps == list(jcore.compositions(L, d))
    assert len(comps) == math.comb(L - 1, d - 1) == core.space.n_compositions(L, d)
    for c in comps:
        assert sum(c) == L and all(x >= 1 for x in c)


@given(st.integers(2, 7), st.integers(2, 5), st.sampled_from([None, 1, 2, 3]))
@settings(max_examples=30, deadline=None)
def test_space_size_and_enumeration_match_reference(L, E, max_depth):
    ours = [(c.stages, c.eps) for c in core.enumerate_configs(L, E, max_depth=max_depth)]
    theirs = [(c.stages, c.eps) for c in jcore.enumerate_configs(L, E, max_depth=max_depth)]
    assert ours == theirs
    assert core.space_size(L, E, max_depth) == jcore.space_size(L, E, max_depth) == len(ours)
    assert core.space.n_assignments(E, 2) == math.perm(E, 2)


@given(st.integers(0, 10_000), st.integers(4, 30), st.integers(2, 6))
@settings(max_examples=100, deadline=None)
def test_random_config_matches_reference(seed, L, E):
    conf = core.random_config(random.Random(seed), L, E)
    jconf = jcore.random_config(random.Random(seed), L, E)
    assert (conf.stages, conf.eps) == (jconf.stages, jconf.eps)
    assert conf.n_layers == L
    assert len(set(conf.eps)) == conf.depth <= E


@given(st.integers(0, 5000))
@settings(max_examples=100, deadline=None)
def test_neighbours_match_reference_and_preserve_invariants(seed):
    conf = core.random_config(random.Random(seed), 12, 4)
    jconf = jcore.random_config(random.Random(seed), 12, 4)
    ours = [(c.stages, c.eps) for c in conf.neighbours()]
    assert ours == [(c.stages, c.eps) for c in jconf.neighbours()]
    for cand in conf.neighbours():
        assert cand.n_layers == 12
        assert len(set(cand.eps)) == cand.depth


def test_move_swap_and_stage_of_layer_match_reference():
    conf, jconf = core.PipelineConfig((2, 3, 1), (0, 1, 2)), jcore.PipelineConfig((2, 3, 1), (0, 1, 2))
    assert conf.boundaries() == jconf.boundaries() == [(0, 2), (2, 5), (5, 6)]
    assert [conf.stage_of_layer(i) for i in range(6)] == [jconf.stage_of_layer(i) for i in range(6)] == [0, 0, 1, 1, 1, 2]
    with pytest.raises(IndexError):
        conf.stage_of_layer(6)
    for src, dst in ((0, 1), (1, 0), (1, 2), (2, 1)):
        a, b = conf.move_layer(src, dst), jconf.move_layer(src, dst)
        assert (a.stages, a.eps) == (b.stages, b.eps)
    assert conf.move_layer(2, 1) is conf  # a one-layer stage is not emptied
    with pytest.raises(ValueError):
        conf.move_layer(0, 2)
    assert conf.swap_eps(0, 2).eps == jconf.swap_eps(0, 2).eps == (2, 1, 0)


# ---------------------------------------------------------------------------
# Platforms, evaluators and the trace
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("conf", ["C1", "C2", "C3", "C4", "C5"])
def test_table3_platform_matches_reference(conf):
    ours, theirs = core.table3_platform(conf), jcore.table3_platform(conf)
    assert [dataclasses.astuple(e) for e in ours.eps] == [dataclasses.astuple(e) for e in theirs.eps]
    assert ours.name == theirs.name
    assert ours.ranked() == theirs.ranked()
    assert (ours.feps, ours.seps) == (theirs.feps, theirs.seps)
    assert [e.is_fep for e in ours.eps] == [e.is_fep for e in theirs.eps]


def test_table3_platform_rejects_an_unknown_config():
    with pytest.raises(KeyError, match="Table-3"):
        core.table3_platform("C6")


def test_with_latency_matches_reference_on_the_scalar_path():
    layers, jlayers = network_layers("synthnet"), j_network_layers("synthnet")
    for lat in (1e-6, 1e-3, 1.0):
        plat, jplat = core.paper_platform(4).with_latency(lat), jcore.paper_platform(4).with_latency(lat)
        assert plat.name == jplat.name
        assert [dataclasses.astuple(e) for e in plat.eps] == [dataclasses.astuple(e) for e in jplat.eps]
        conf, jconf = core.PipelineConfig((5, 5, 4, 4), (0, 1, 2, 3)), jcore.PipelineConfig((5, 5, 4, 4), (0, 1, 2, 3))
        assert core.AnalyticEvaluator(plat, layers).throughput(conf) == \
            jcore.AnalyticEvaluator(jplat, jlayers).throughput(jconf)


@pytest.mark.parametrize("n_eps", [4, 8])
@pytest.mark.parametrize("name", NETWORKS)
def test_database_evaluator_matches_reference(name, n_eps):
    ev, jev = _evaluators("database", name, n_eps)
    assert ev._db == jev._db
    for i in range(len(ev.layers)):
        for e in range(n_eps):
            assert ev.layer_time_by_index(i, e) == jev.layer_time_by_index(i, e)
            assert ev.nominal_layer_time(ev.layers[i], e) == jev.nominal_layer_time(jev.layers[i], e)
    rng = random.Random(n_eps)
    for _ in range(20):
        conf = core.random_config(rng, len(ev.layers), n_eps)
        jconf = jcore.PipelineConfig(conf.stages, conf.eps)
        assert ev.stage_times(conf) == jev.stage_times(jconf)
        assert ev.throughput(conf) == jev.throughput(jconf)


def test_noise_matches_reference():
    from repro.core.evaluator import _noise as j_noise
    from repro_torch.core.evaluator import _noise

    for key in ("conv1|FEP0", "blk3|SEP1", ""):
        for sigma in (0.0, 0.08, 0.5):
            assert _noise(key, sigma) == j_noise(key, sigma)
            assert 1 - sigma <= _noise(key, sigma) <= 1 + sigma


@pytest.mark.parametrize("use_cache", [False, True])
def test_trace_accounting_matches_reference(use_cache):
    ev, jev = _evaluators("database", "synthnet", 4)
    tr = core.Trace(ev, setup_cost=5.0, use_cache=use_cache)
    jtr = jcore.Trace(jev, setup_cost=5.0, use_cache=use_cache)
    assert tr.wall == jtr.wall == 5.0
    with pytest.raises(RuntimeError):
        tr.best()
    for stages, eps in [((9, 9), (0, 1)), ((18,), (2,)), ((9, 9), (0, 1)), ((5, 5, 4, 4), (3, 2, 1, 0))]:
        assert tr.execute(core.PipelineConfig(stages, eps)) == jtr.execute(jcore.PipelineConfig(stages, eps))
        assert tr.wall == jtr.wall
    assert tr.n_trials == jtr.n_trials == (3 if use_cache else 4)
    best, jbest = tr.best(), jtr.best()
    assert (best.conf.stages, best.conf.eps, best.throughput, best.t_wall) == \
        (jbest.conf.stages, jbest.conf.eps, jbest.throughput, jbest.t_wall)
    curve = tr.convergence_curve()
    assert curve == jtr.convergence_curve()
    assert [b for _, b in curve] == sorted(b for _, b in curve) and curve[-1][1] == best.throughput


def test_trace_pays_only_the_reconfiguration_when_a_pipeline_cannot_flow():
    class Severed(core.AnalyticEvaluator):
        def stage_times(self, conf):
            return [math.inf] * conf.depth

    tr = core.Trace(Severed(core.paper_platform(4), network_layers("alexnet")))
    assert tr.execute(core.PipelineConfig((5,), (0,))) == 0.0
    assert tr.wall == tr.reconfig_overhead and tr.n_trials == 1


def test_quickstart_twin_prints_what_the_reference_prints():
    out = {}
    for name in ("quickstart.py", "quickstart_torch.py"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            runpy.run_path(str(ROOT / "examples" / name), run_name="__main__")
        out[name] = buf.getvalue()
    assert out["quickstart_torch.py"] == out["quickstart.py"]
    assert "Hill Climbing with a 35x larger online budget" in out["quickstart.py"]
