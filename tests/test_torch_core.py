"""The port's copy of the Shisha core against the JAX package's.

The port keeps its own trimmed copy of ``repro.core`` (the scalar-link path)
and of ``StragglerMitigator``.  Fed the same layer tables and platforms,
both must make the same decisions with the same numbers, trial for trial.
"""

import dataclasses

import pytest

pytest.importorskip("torch")  # CI installs requirements-dev.txt, which has no torch

from repro import core as jcore
from repro.models.cnn import network_layers as j_network_layers
from repro.runtime import StragglerMitigator as JStragglerMitigator
from repro_torch import core
from repro_torch.models.cnn import network_layers
from repro_torch.runtime import StragglerMitigator

NETWORKS = ["synthnet", "resnet50", "yolov3", "alexnet"]


def _confs(trials):
    return [(t.conf.stages, t.conf.eps, t.throughput, t.t_wall) for t in trials]


@pytest.mark.parametrize("n_eps", [4, 8])
@pytest.mark.parametrize("heuristic", sorted(core.HEURISTICS))
@pytest.mark.parametrize("name", NETWORKS)
def test_run_shisha_matches_reference(name, heuristic, n_eps):
    n_stages = min(n_eps, 4) if name == "alexnet" else n_eps
    ours = core.run_shisha(
        core.weights(network_layers(name)),
        core.Trace(core.AnalyticEvaluator(core.paper_platform(n_eps), network_layers(name))),
        heuristic,
        n_stages=n_stages,
    )
    theirs = jcore.run_shisha(
        jcore.weights(j_network_layers(name)),
        jcore.Trace(jcore.AnalyticEvaluator(jcore.paper_platform(n_eps), j_network_layers(name))),
        heuristic,
        n_stages=n_stages,
    )
    r, jr = ours.result, theirs.result
    assert (r.best_conf.stages, r.best_conf.eps) == (jr.best_conf.stages, jr.best_conf.eps)
    assert (r.final_conf.stages, r.final_conf.eps) == (jr.final_conf.stages, jr.final_conf.eps)
    assert r.best_throughput == jr.best_throughput
    assert r.n_explored == jr.n_explored == ours.trace.n_trials == theirs.trace.n_trials
    assert ours.trace.wall == theirs.trace.wall
    assert _confs(ours.trace.trials) == _confs(theirs.trace.trials)


def test_platform_copy_matches_reference():
    for n in (2, 4, 8):
        ours, theirs = core.paper_platform(n), jcore.paper_platform(n)
        assert [dataclasses.astuple(e) for e in ours.eps] == [dataclasses.astuple(e) for e in theirs.eps]
        assert ours.name == theirs.name
        assert ours.ranked() == theirs.ranked()
        assert ours.feps == theirs.feps


def test_evaluator_copy_matches_reference():
    layers, jlayers = network_layers("synthnet"), j_network_layers("synthnet")
    ev = core.AnalyticEvaluator(core.paper_platform(4), layers)
    jev = jcore.AnalyticEvaluator(jcore.paper_platform(4), jlayers)
    for stages, eps in [((5, 5, 5, 3), (0, 1, 2, 3)), ((1, 9, 6, 2), (3, 2, 0, 1)), ((18,), (2,))]:
        conf, jconf = core.PipelineConfig(stages, eps), jcore.PipelineConfig(stages, eps)
        assert ev.stage_times(conf) == jev.stage_times(jconf)
        assert ev.throughput(conf) == jev.throughput(jconf)
        assert ev.pipeline_latency(conf) == jev.pipeline_latency(jconf)


@pytest.mark.parametrize(
    "times",
    [
        [1.0, 4.0, 1.0, 1.0],  # straggler in stage 1
        [1.0, 1.1, 0.9, 1.0],  # balanced: no rebalance
        [0.5, 0.5, 0.5, 3.0],  # straggler in the last stage
        [2.0, 1.0, 1.0, 1.0],  # ratio 2 > 1.5
    ],
)
def test_straggler_rebalance_matches_reference(times):
    layers, jlayers = network_layers("synthnet"), j_network_layers("synthnet")
    platform, jplatform = core.paper_platform(4), jcore.paper_platform(4)
    seed = core.generate_seed(core.weights(layers), platform, n_stages=4).conf
    jseed = jcore.generate_seed(jcore.weights(jlayers), jplatform, n_stages=4).conf
    assert (seed.stages, seed.eps) == (jseed.stages, jseed.eps)
    mit = StragglerMitigator(platform, seed, lambda p: core.Trace(core.AnalyticEvaluator(p, layers)))
    jmit = JStragglerMitigator(jplatform, jseed, lambda p: jcore.Trace(jcore.AnalyticEvaluator(p, jlayers)))
    assert mit.check(times) == jmit.check(times)
    ours, theirs = mit.rebalance(times), jmit.rebalance(times)
    if theirs is None:
        assert ours is None
        return
    (conf, res), (jconf, jres) = ours, theirs
    assert (conf.stages, conf.eps) == (jconf.stages, jconf.eps)
    assert res.best_throughput == jres.best_throughput
    assert res.n_explored == jres.n_explored
    assert [dataclasses.astuple(e) for e in mit.platform.eps] == [dataclasses.astuple(e) for e in jmit.platform.eps]
    assert mit.platform.name == jmit.platform.name


def test_pipeline_config_rejects_what_the_reference_rejects():
    for stages, eps in [((1, 2), (0,)), ((0, 2), (0, 1)), ((1, 2), (1, 1))]:
        with pytest.raises(ValueError):
            core.PipelineConfig(stages, eps)
        with pytest.raises(ValueError):
            jcore.PipelineConfig(stages, eps)
