"""The port's copy of the Shisha core against the JAX package's.

The port keeps its own copy of ``repro.core`` and of ``StragglerMitigator``
and ``ElasticScheduler``.  Fed the same layer tables and platforms, with
and without a routed fabric and a capped power model, both must make the
same decisions with the same numbers, trial for trial.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")  # CI installs requirements-dev.txt, which has no torch

from repro import core as jcore
from repro import interconnect as jic
from repro import power as jpw
from repro.models.cnn import network_layers as j_network_layers
from repro.runtime import ElasticScheduler as JElasticScheduler
from repro.runtime import StragglerMitigator as JStragglerMitigator
from repro_torch import core
from repro_torch import interconnect as ic
from repro_torch import power as pw
from repro_torch.models.cnn import network_layers
from repro_torch.runtime import ElasticScheduler, StragglerMitigator

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


# ---------------------------------------------------------------------------
# the fabric and DVFS paths: placement and frequency moves over a routed mesh
# and a package power cap, against the reference trial for trial
# ---------------------------------------------------------------------------

FABRIC_PLATFORMS = ["paper8", "C1", "C2", "C3", "C4", "C5"]
#: the package cap as a share of the H3 seed's nominal package watts (binding)
CAP_SHARE = 0.7


def _bare(c, name):
    return c.paper_platform(8) if name == "paper8" else c.table3_platform(name)


def _side(c, icm, pwm, network_layers_fn, name, powered, fabric="mesh", spare=0):
    """One package's platform (2x4 mesh fabric; a capped DVFS model when
    ``powered``), layers and H3 seed on ``spare`` fewer stages than EPs
    (free EPs for relocations); ``fabric="scalar"`` attaches the degenerate
    fabric and power model instead."""
    layers = network_layers_fn("synthnet")
    bare = _bare(c, name)
    n_stages = max(1, bare.n_eps - spare)
    seed = c.generate_seed(c.weights(layers), bare, n_stages=n_stages, choice="rank_w").conf
    if fabric == "scalar":
        plat = bare.with_fabric(icm.scalar_fabric(bare)).with_power(pwm.degenerate_power(bare))
        return plat, layers, seed
    plat = bare.with_fabric(icm.uniform_fabric(icm.mesh2d(2, 4, bw=1e8, latency=1e-6), bare.n_eps))
    if powered:
        cap = CAP_SHARE * pwm.uniform_power(bare).package_w(seed.eps)
        plat = plat.with_power(pwm.uniform_power(bare, cap_w=cap))
    return plat, layers, seed


def _sides(name, powered, fabric="mesh", spare=0):
    return (_side(core, ic, pw, network_layers, name, powered, fabric, spare),
            _side(jcore, jic, jpw, j_network_layers, name, powered, fabric, spare))


def _tuned(result, trace, plat):
    return (_confs(trace.trials), trace.wall, (result.best_conf.stages, result.best_conf.eps),
            result.best_throughput, result.n_explored, (result.final_conf.stages, result.final_conf.eps),
            getattr(result, "dvfs_levels", None), plat.power.snapshot() if plat.power is not None else None)


MODES = {
    "placement": dict(placement=True),
    "dvfs": dict(dvfs=True),
    "placement+dvfs": dict(placement=True, dvfs=True),
}


@pytest.mark.parametrize("powered", [False, True])
@pytest.mark.parametrize("evaluator", ["AnalyticEvaluator", "DatabaseEvaluator"])
@pytest.mark.parametrize("name", FABRIC_PLATFORMS)
def test_fabric_and_power_stage_times_match_reference(name, evaluator, powered):
    (plat, layers, seed), (jplat, jlayers, jseed) = _sides(name, powered)
    ev, jev = getattr(core, evaluator)(plat, layers), getattr(jcore, evaluator)(jplat, jlayers)
    rng = np.random.default_rng(plat.n_eps)
    confs = [(seed.stages, seed.eps)]
    for _ in range(6):
        depth = int(rng.integers(1, plat.n_eps + 1))
        cuts = sorted(rng.choice(np.arange(1, len(layers)), size=depth - 1, replace=False).tolist())
        stages = tuple(b - a for a, b in zip([0] + cuts, cuts + [len(layers)]))
        confs.append((stages, tuple(int(e) for e in rng.permutation(plat.n_eps)[:depth])))
    for step in range(3):
        if powered and step:
            for pm in (plat.power, jplat.power):
                pm.set_level(step % plat.n_eps, step)
        for stages, eps in confs:
            conf, jconf = core.PipelineConfig(stages, eps), jcore.PipelineConfig(stages, eps)
            assert ev.stage_times(conf) == jev.stage_times(jconf)
            assert ev.throughput(conf) == jev.throughput(jconf)
            assert ev.pipeline_latency(conf) == jev.pipeline_latency(jconf)
            assert ev.transfer_times(conf) == jev.transfer_times(jconf)
    ev.background_flows = (ic.Flow(0, plat.n_eps - 1, 2e6, nodes=True),)
    jev.background_flows = (jic.Flow(0, plat.n_eps - 1, 2e6, nodes=True),)
    for stages, eps in confs:
        assert ev.stage_times(core.PipelineConfig(stages, eps)) == jev.stage_times(jcore.PipelineConfig(stages, eps))


@pytest.mark.parametrize("spare", [0, 2])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("powered", [False, True])
@pytest.mark.parametrize("evaluator", ["AnalyticEvaluator", "DatabaseEvaluator"])
@pytest.mark.parametrize("name", FABRIC_PLATFORMS)
def test_placement_and_dvfs_tune_matches_reference(name, evaluator, powered, mode, spare):
    (plat, layers, seed), (jplat, jlayers, jseed) = _sides(name, powered, spare=spare)
    trace, jtrace = core.Trace(getattr(core, evaluator)(plat, layers)), jcore.Trace(getattr(jcore, evaluator)(jplat, jlayers))
    ours = core.tune(seed, trace, **MODES[mode])
    theirs = jcore.tune(jseed, jtrace, **MODES[mode])
    assert _tuned(ours, trace, plat) == _tuned(theirs, jtrace, jplat)
    if powered and "dvfs" in mode:
        assert ours.dvfs_levels is not None and plat.power.cap_feasible(ours.best_conf.eps)
    if spare and mode == "placement":  # a free EP: every step pays a relocation trial
        assert any(set(t.conf.eps) - set(seed.eps) for t in trace.trials)


@pytest.mark.parametrize("spare", [0, 2])
@pytest.mark.parametrize("powered", [False, True])
@pytest.mark.parametrize("evaluator", ["AnalyticEvaluator", "DatabaseEvaluator"])
@pytest.mark.parametrize("name", FABRIC_PLATFORMS)
def test_run_shisha_with_placement_matches_reference(name, evaluator, powered, spare):
    (plat, layers, seed), (jplat, jlayers, _) = _sides(name, powered, spare=spare)
    ours = core.run_shisha(core.weights(layers), core.Trace(getattr(core, evaluator)(plat, layers)), "H3",
                           n_stages=seed.depth, placement=True)
    theirs = jcore.run_shisha(jcore.weights(jlayers), jcore.Trace(getattr(jcore, evaluator)(jplat, jlayers)), "H3",
                              n_stages=seed.depth, placement=True)
    assert _tuned(ours.result, ours.trace, plat) == _tuned(theirs.result, theirs.trace, jplat)


@pytest.mark.parametrize("spare", [0, 2])
@pytest.mark.parametrize("evaluator", ["AnalyticEvaluator", "DatabaseEvaluator"])
@pytest.mark.parametrize("name", FABRIC_PLATFORMS)
def test_degenerate_fabric_and_power_reproduce_the_bare_results(name, evaluator, spare):
    (plat, layers, seed), (jplat, jlayers, jseed) = _sides(name, False, fabric="scalar", spare=spare)
    bare = _bare(core, name)
    runs = []
    for p, kw in ((bare, dict(placement=True)), (plat, dict(placement=True, dvfs=True))):
        trace = core.Trace(getattr(core, evaluator)(p, layers))
        r = core.tune(seed, trace, **kw)
        runs.append(_tuned(r, trace, p)[:6])
    jtrace = jcore.Trace(getattr(jcore, evaluator)(jplat, jlayers))
    runs.append(_tuned(jcore.tune(jseed, jtrace, placement=True, dvfs=True), jtrace, jplat)[:6])
    assert runs[0] == runs[1] == runs[2]
    plain = core.run_shisha(core.weights(layers), core.Trace(getattr(core, evaluator)(bare, layers)), "H3")
    degen = core.run_shisha(core.weights(layers), core.Trace(getattr(core, evaluator)(plat, layers)), "H3")
    assert _tuned(plain.result, plain.trace, bare)[:6] == _tuned(degen.result, degen.trace, plat)[:6]


@pytest.mark.parametrize("times", [[1.0, 4.0, 1.0, 1.0], [0.5, 0.5, 0.5, 3.0]])
def test_straggler_mitigator_carries_fabric_and_power_as_the_reference(times):
    out = []
    for c, icm, pwm, nl, mit_cls in ((core, ic, pw, network_layers, StragglerMitigator),
                                      (jcore, jic, jpw, j_network_layers, JStragglerMitigator)):
        layers = nl("synthnet")
        bare = c.paper_platform(4)
        plat = bare.with_fabric(icm.uniform_fabric(icm.mesh2d(2, 2, bw=1e8, latency=1e-6)))
        plat = plat.with_power(pwm.uniform_power(bare))
        plat.power.set_level(3, 2)
        seed = c.generate_seed(c.weights(layers), plat, n_stages=4).conf
        mit = mit_cls(plat, seed, lambda p: c.Trace(c.AnalyticEvaluator(p, layers)))
        conf, res = mit.rebalance(times)
        assert mit.platform.fabric is plat.fabric and mit.platform.power is plat.power
        out.append((conf.stages, conf.eps, res.best_throughput, res.n_explored, mit.platform.name,
                    [dataclasses.astuple(e) for e in mit.platform.eps]))
    assert out[0] == out[1]


@pytest.mark.parametrize("dead", [[1], [0, 5], [7]])
def test_elastic_scheduler_carries_fabric_and_power_as_the_reference(dead):
    out = []
    for c, icm, pwm, nl, el_cls in ((core, ic, pw, network_layers, ElasticScheduler),
                                     (jcore, jic, jpw, j_network_layers, JElasticScheduler)):
        layers = nl("synthnet")
        bare = c.paper_platform(8)
        plat = bare.with_fabric(icm.uniform_fabric(icm.mesh2d(2, 4, bw=1e8, latency=1e-6)))
        plat = plat.with_power(pwm.uniform_power(bare))
        plat.power.set_level(6, 3)
        el = el_cls(plat, c.weights(layers), lambda p: c.Trace(c.AnalyticEvaluator(p, layers)))
        conf, res = el.on_topology_change(dead)
        keep = [i for i in range(8) if i not in dead]
        assert el.platform.fabric.ep_nodes == tuple(keep)
        assert el.platform.power.snapshot() == tuple(plat.power.level(i) for i in keep)
        out.append((conf.stages, conf.eps, res.best_throughput, res.n_explored, el.platform.name,
                    el.platform.power.snapshot(), el.platform.fabric.ep_nodes))
    assert out[0] == out[1]


def test_merge_layers_properties():
    """``tests/test_core_scheduler.py::test_merge_layers_properties`` on the
    port's exported ``merge_layers``, plus the reference's groups and
    ``assign_eps``'s EPs, over the same draws."""
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies

    @hyp.given(st.lists(st.floats(1.0, 1e6), min_size=2, max_size=40), st.integers(1, 8),
               st.sampled_from(["rank_l", "rank_w"]))
    @hyp.settings(max_examples=200, deadline=None)
    def check(ws, n, choice):
        n = min(n, len(ws))
        groups = core.merge_layers(ws, n)
        assert len(groups) == n
        assert [i for g in groups for i in g] == list(range(len(ws)))  # contiguity + completeness
        assert all(len(g) >= 1 for g in groups)
        assert groups == jcore.merge_layers(ws, n)
        gw = [sum(ws[i] for i in g) for g in groups]
        sizes = [len(g) for g in groups]
        assert core.assign_eps(gw, sizes, core.paper_platform(8), choice) == jcore.assign_eps(
            gw, sizes, jcore.paper_platform(8), choice)

    check()
    assert core.merge_layers([2.0, 1.0, 9.0, 9.0], 3)[0] == [0, 1]  # the lighter neighbour
    assert {"merge_layers", "assign_eps", "Evaluator"} <= set(core.__all__)


@pytest.mark.parametrize("case", [
    ("attention_layer", ("a", 2048, 32, 8, 512), dict(batch=4)),
    ("attention_layer", ("a", 5120, 40, 8, 4096), dict(window=1024, dtype_bytes=4)),
    ("ffn_layer", ("f", 2048, 8192), dict(seq=512, batch=4)),
    ("ffn_layer", ("f", 768, 3072), dict(seq=448, gated=False)),
    ("ffn_layer", ("m", 4096, 6400), dict(seq=512, n_experts=16, top_k=2)),
    ("ssd_layer", ("s", 768, 128), dict(seq=512, batch=4)),
    ("ssd_layer", ("s", 2560, 64), dict(seq=2048, expand=2, dtype_bytes=4)),
])
def test_lm_block_cost_formulas_equal_the_reference(case):
    fn, args, kw = case
    ours, theirs = getattr(core, fn)(*args, **kw), getattr(jcore, fn)(*args, **kw)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.weight == theirs.weight and ours.flops > 0


def test_fuse_and_total_flops_equal_the_reference():
    def parts(m):
        return [m.attention_layer("a", 2048, 32, 8, 512), m.ffn_layer("f", 2048, 8192, seq=512),
                m.ssd_layer("s", 2048, 128, seq=512)]

    ours, theirs = core.fuse("blk", parts(core), kind="hybrid"), jcore.fuse("blk", parts(jcore), kind="hybrid")
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.act_bytes == parts(core)[-1].act_bytes
    assert core.total_flops(parts(core)) == jcore.total_flops(parts(jcore)) == sum(p.flops for p in parts(core))
