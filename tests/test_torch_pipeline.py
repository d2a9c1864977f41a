"""The port's pipeline runtime on the CPU, against sequential execution and
against the JAX package's platform and derate model.

On the CPU the stage mesh has no streams and the runner runs the same
fill/steady/drain schedule in order; the stream path runs in
``tests/test_torch_gpu.py``.
"""

import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # CI installs requirements-dev.txt, which has no torch

import jax
import jax.numpy as jnp

from repro.core import paper_platform as j_paper_platform
from repro.models import cnn as jcnn
from repro.models.cnn import network_layers as j_network_layers
from repro.pipeline.hetero import EPDerates as JEPDerates, tpu_platform_from_mesh
from repro_torch.core import Trace, generate_seed, paper_platform, run_shisha, tune, weights
from repro_torch.launch.mesh import make_stage_mesh
from repro_torch.launch.serve_cnn import serve_cnn
from repro_torch.models.cnn import canonical_pipeline_apply, make_cnn, network_layers
from repro_torch.pipeline import (
    EPDerates,
    MeasuringEvaluator,
    PipelineRunner,
    h100_platform_from_streams,
    pipeline_throughput,
)
from repro_torch.pipeline import hetero

ROOT = Path(__file__).resolve().parents[1]
IN_SHAPE = (8, 8, 8)
H100_PROPS = SimpleNamespace(name="H100-stand-in", multi_processor_count=132, total_memory=80 * 2**30)


@pytest.fixture(scope="module")
def model():
    return make_cnn("synthnet", scale=0.1, device="cpu").init(torch.Generator().manual_seed(0))


def _seed_conf(n_stages=4):
    return generate_seed(weights(network_layers("synthnet")), paper_platform(4), n_stages=n_stages).conf


def _micro(n_micro, seed=1):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((n_micro, 2, *IN_SHAPE), dtype=np.float32))


@pytest.mark.parametrize("n_stages,n_micro", [(4, 5), (2, 3), (1, 2), (4, 1)])
def test_runner_matches_sequential(model, n_stages, n_micro):
    conf = _seed_conf(n_stages)
    runner = PipelineRunner(mesh=make_stage_mesh(n_stages, "cpu"), conf=conf, apply_layer=model.apply_layer,
                            n_micro=n_micro)
    micro = _micro(n_micro)
    out = runner.run(micro)
    ref = torch.stack([model(micro[i]) for i in range(n_micro)])
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    assert runner.ticks == n_micro + n_stages - 1


def test_runner_with_canonical_shapes_matches_sequential(model):
    apply_fn, to_canon, crop_out, _ = canonical_pipeline_apply(model, IN_SHAPE)
    runner = PipelineRunner(mesh=make_stage_mesh(4, "cpu"), conf=_seed_conf(), apply_layer=apply_fn, n_micro=5)
    micro = _micro(5)
    out = crop_out(runner.run(to_canon(micro)))
    ref = torch.stack([model(micro[i]) for i in range(5)])
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


def test_pipelined_port_matches_reference_model():
    """The slice end to end at small size: reference weights, port pipeline,
    reference sequential model."""
    jmodel = jcnn.make_cnn("synthnet", scale=0.1)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = make_cnn("synthnet", scale=0.1, device="cpu").params_from_numpy(
        [{k: np.asarray(v) for k, v in p.items()} for p in jparams]
    )
    runner = PipelineRunner(mesh=make_stage_mesh(4, "cpu"), conf=_seed_conf(), apply_layer=model.apply_layer,
                            n_micro=3)
    micro = _micro(3)
    out = runner.run(micro).numpy()
    want = np.stack([np.asarray(jmodel(jparams, jnp.asarray(micro[i].numpy()))) for i in range(3)])
    np.testing.assert_allclose(out, want, rtol=3e-4, atol=3e-4 * float(np.abs(want).max()))


def test_runner_rejects_mismatched_mesh_and_microbatches(model):
    with pytest.raises(ValueError, match="stages"):
        PipelineRunner(mesh=make_stage_mesh(3, "cpu"), conf=_seed_conf(4), apply_layer=model.apply_layer)
    runner = PipelineRunner(mesh=make_stage_mesh(4, "cpu"), conf=_seed_conf(4), apply_layer=model.apply_layer,
                            n_micro=4)
    with pytest.raises(ValueError, match="microbatches"):
        runner.run(_micro(3))


def test_stage_mesh_on_cpu_has_no_streams():
    mesh = make_stage_mesh(4, "cpu")
    assert mesh.n_stages == 4 and mesh.streams is None and mesh.device == torch.device("cpu")
    with pytest.raises(ValueError):
        make_stage_mesh(0, "cpu")


def test_measuring_evaluator_on_cpu_drives_shisha(model):
    layers = network_layers("synthnet")
    x = torch.zeros((2, *IN_SHAPE))
    fns = [lambda x, i=i: model.apply_layer(i, x) for i in range(len(model.specs))]
    platform = h100_platform_from_streams(4, props=H100_PROPS)
    ev = MeasuringEvaluator(platform, layers, layer_fns=fns, layer_args=[(x,)] * len(fns), reps=2, device="cpu")
    assert len(ev.measured) == 18 and all(t > 0 for t in ev.measured)
    conf = _seed_conf()
    times = ev.stage_times(conf)
    link = ev.transfer_times(conf)
    for s, (a, b) in enumerate(conf.boundaries()):
        own = sum(ev.derates.scale(conf.eps[s], ev.measured[i]) + ev.layer_overhead for i in range(a, b))
        assert times[s] == pytest.approx(own + (link[s] if s < 3 else 0.0), rel=1e-12)
    assert ev.layer_time(layers[0], 0) == ev.measured[0] + ev.layer_overhead
    res = run_shisha(weights(layers), Trace(ev), "H3", n_stages=4)
    assert res.result.best_throughput == max(t.throughput for t in res.trace.trials)


def test_measuring_evaluator_checks_its_inputs(model):
    with pytest.raises(ValueError, match="layer_fns"):
        MeasuringEvaluator(paper_platform(4), network_layers("synthnet"), layer_fns=[], layer_args=[], device="cpu")


def test_pipeline_throughput_on_cpu(model):
    runner = PipelineRunner(mesh=make_stage_mesh(4, "cpu"), conf=_seed_conf(), apply_layer=model.apply_layer,
                            n_micro=2)
    assert pipeline_throughput(runner, _micro(2), reps=1) > 0


def test_derates_match_reference():
    for n in (4, 8):
        assert EPDerates.from_platform(paper_platform(n)).factors == JEPDerates.from_platform(
            j_paper_platform(n)
        ).factors


@pytest.mark.parametrize("n_stages", [2, 4, 6])
def test_h100_platform_keeps_the_reference_heterogeneity(n_stages):
    ours = h100_platform_from_streams(n_stages, props=H100_PROPS)
    theirs = tpu_platform_from_mesh(n_stages, chips_per_stage=1)
    assert [e.perf_class for e in ours.eps] == [e.perf_class for e in theirs.eps]
    # same emulated SEP derate as the reference's TPU preset
    assert EPDerates.from_platform(ours).factors == pytest.approx(JEPDerates.from_platform(theirs).factors)
    sms = 132 // n_stages
    fast = ours.eps[0]
    assert fast.cores == sms and fast.flops == pytest.approx(hetero.H100_FP32_FLOPS * sms / 132)
    assert fast.mem_bw == pytest.approx(hetero.H100_HBM_BW / n_stages)
    assert ours.ranked() == list(range(n_stages))
    assert "80GiB" in ours.name


def test_h100_platform_rejects_more_stages_than_sms():
    with pytest.raises(ValueError, match="SMs"):
        h100_platform_from_streams(4, props=SimpleNamespace(name="x", multi_processor_count=3, total_memory=1))


def test_serve_cnn_on_cpu_runs_the_whole_loop():
    res = serve_cnn(device="cpu", scale=0.12, in_shape=IN_SHAPE, seed=0)
    assert res.out.shape == (8, 2, 4, 4, 46)
    assert torch.isfinite(res.out).all()
    torch.testing.assert_close(res.out, torch.stack([res.model(x) for x in res.micro]), rtol=1e-4, atol=1e-4)
    assert res.runner.ticks == 8 + res.conf.depth - 1
    assert res.measured_throughput > 0
    assert res.rebalanced is not None  # a 4x straggler crosses the 1.5x threshold
    assert any(line.startswith("[fault] straggler") for line in res.report())


def test_example_runs_on_cpu():
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "pipeline_serve_cnn_torch.py"),
         "--device", "cpu", "--scale", "0.12", "--in-shape", "8", "8", "8"],
        capture_output=True, text=True, timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )
    assert proc.returncode == 0, proc.stderr
    assert "[schedule]" in proc.stdout and "[serve] pipelined 8 microbatches" in proc.stdout


def _measured_oracles(model, powered_levels=(2, 0, 3, 1)):
    """The port's measured oracle on the CPU over the 4-EP platform of
    streams with a 2x2 mesh fabric (a slow link, so routes and contention
    would show) and a stepped-down power model, and the reference's
    ``MeasuringEvaluator`` on the same platform fed the same measured list
    (built without its JAX timing, which is not under test here)."""
    from repro import core as jcore
    from repro import interconnect as jic
    from repro import power as jpw
    from repro.pipeline.runtime import MeasuringEvaluator as JMeasuringEvaluator
    from repro_torch import interconnect as ic
    from repro_torch import power as pw

    layers = network_layers("synthnet")
    x = torch.zeros((2, *IN_SHAPE))
    fns = [lambda x, i=i: model.apply_layer(i, x) for i in range(len(model.specs))]
    bare = h100_platform_from_streams(4, props=H100_PROPS)
    plat = bare.with_fabric(ic.uniform_fabric(ic.mesh2d(2, 2, bw=1e6, latency=1e-3))).with_power(pw.uniform_power(bare))
    jbare = jcore.Platform(name=bare.name, eps=tuple(jcore.EP(**dataclasses.asdict(e)) for e in bare.eps))
    jplat = jbare.with_fabric(jic.uniform_fabric(jic.mesh2d(2, 2, bw=1e6, latency=1e-3)))
    jplat = jplat.with_power(jpw.uniform_power(jbare))
    for ep, level in enumerate(powered_levels):
        plat.power.set_level(ep, level)
        jplat.power.set_level(ep, level)
    ev = MeasuringEvaluator(plat, layers, layer_fns=fns, layer_args=[(x,)] * len(fns), reps=1, device="cpu")
    jev = JMeasuringEvaluator.__new__(JMeasuringEvaluator)
    jev.platform, jev.layers, jev.layer_overhead, jev.background_flows = jplat, j_network_layers("synthnet"), 2e-6, ()
    jev.layer_fns, jev.layer_args, jev.reps = fns, [(x,)] * len(fns), 1
    jev.derates, jev._measured = JEPDerates.from_platform(jplat), list(ev.measured)
    return ev, jev


def test_measuring_evaluator_keeps_the_scalar_link_and_no_dvfs_scale_on_a_fabric_and_a_power_model(model):
    """The reference's measured oracle prices every boundary from the scalar
    ``link_bw``/``link_latency`` and divides by no DVFS scale, even when the
    platform carries a fabric and a power model; the port's keeps that."""
    from repro import core as jcore

    ev, jev = _measured_oracles(model)
    layers = network_layers("synthnet")
    rng = np.random.default_rng(0)
    confs = [_seed_conf(n) for n in (1, 2, 3, 4)]
    for _ in range(12):
        depth = int(rng.integers(2, 5))
        cuts = sorted(rng.choice(np.arange(1, 18), size=depth - 1, replace=False).tolist())
        confs.append(type(confs[0])(tuple(b - a for a, b in zip([0] + cuts, cuts + [18])),
                                    tuple(int(e) for e in rng.permutation(4)[:depth])))
    routed = 0
    for conf in confs:
        jconf = jcore.PipelineConfig(conf.stages, conf.eps)
        assert ev.stage_times(conf) == jev.stage_times(jconf)
        assert ev.throughput(conf) == jev.throughput(jconf)
        assert ev.pipeline_latency(conf) == jev.pipeline_latency(jconf)
        # the fabric would have priced it otherwise: routes, hops, contention
        routed += ev.transfer_times(conf) != [
            layers[b - 1].act_bytes / ev.platform.eps[conf.eps[s]].link_bw + ev.platform.eps[conf.eps[s]].link_latency
            for s, (_, b) in enumerate(conf.boundaries()[:-1])]
    assert routed > 0
    for i, layer in enumerate(layers):
        for ep in range(4):  # unscaled, though EPs 0, 2 and 3 run below their nominal level
            assert ev.layer_time(layer, ep) == jev.layer_time(jev.layers[i], ep)
            assert ev.layer_time(layer, ep) == ev.derates.scale(ep, ev.measured[i]) + ev.layer_overhead


def test_placement_and_dvfs_tune_over_the_measured_oracle_match_the_reference(model):
    from repro import core as jcore

    ev, jev = _measured_oracles(model, powered_levels=(0, 0, 0, 0))
    seed = _seed_conf(3)
    for pm in (ev.platform.power, jev.platform.power):
        pm.cap_w = 0.7 * pm.package_w(seed.eps)
    trace, jtrace = Trace(ev), jcore.Trace(jev)
    ours = tune(seed, trace, placement=True, dvfs=True)
    theirs = jcore.tune(jcore.PipelineConfig(seed.stages, seed.eps), jtrace, placement=True, dvfs=True)
    assert [(t.conf.stages, t.conf.eps, t.throughput, t.t_wall) for t in trace.trials] == [
        (t.conf.stages, t.conf.eps, t.throughput, t.t_wall) for t in jtrace.trials]
    assert (ours.best_conf.stages, ours.best_conf.eps, ours.best_throughput, ours.dvfs_levels) == (
        theirs.best_conf.stages, theirs.best_conf.eps, theirs.best_throughput, theirs.dvfs_levels)
    assert ev.platform.power.cap_feasible(ours.best_conf.eps)
    assert any(set(t.conf.eps) - set(seed.eps) for t in trace.trials)  # relocations were tried


def test_measuring_evaluator_on_platform_measures_nothing_again(model):
    ev, _ = _measured_oracles(model)
    bare = h100_platform_from_streams(4, props=H100_PROPS)
    other = ev.on_platform(bare)
    assert other.platform is bare and other.measured is ev.measured and ev.platform.fabric is not None
    conf = _seed_conf(3)
    assert other.stage_times(conf) == ev.stage_times(conf)  # the measured oracle ignores both models
    with pytest.raises(ValueError, match="not distinct EPs"):
        ev.on_platform(paper_platform(4))


def test_chip_smoke_placement_phase_runs_on_cpu():
    """``chip_smoke.place_and_scale`` (phase 5b) at a tiny SynthNet on the
    CPU: its pins hold and both tuned splits equal the sequential model."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    res = serve_cnn(device="cpu", scale=0.12, in_shape=IN_SHAPE, seed=0)
    out = smoke.place_and_scale(res, torch.stack([res.model(x) for x in res.micro]))
    assert out["placed"]["relocation_trials"] > 0
    assert out["capped"]["package_w_modelled"] <= out["capped"]["cap_w_modelled"]
    assert out["capped"]["cap_w_modelled"] < out["capped"]["nominal_w_modelled"]
    assert out["placed"]["far_relocation_cost_s"] > out["placed"]["flat_overhead_s"]
    for name in ("placed", "capped"):
        assert out[name]["measured_micro_per_s"] > 0


@pytest.mark.parametrize("factors,dead", [((1.0, 2.0, 1.0, 1.0), ()), ((4.0, 4.0, 1.0, 1.0), ()),
                                          ((1.0, 1.0, 2.0, 0.5), ()), ((2.0, 1.0, 1.0, 1.0), (1,)),
                                          ((1.0, 1.0, 1.0, 1.0), (0, 3))])
def test_measuring_evaluator_serves_a_drifted_platform(model, factors, dead):
    """``on_platform`` of ``serve.autotuner.drifted_platform``: each EP's
    derate is the measured platform's fastest FLOP/s over the EP's own, so
    an EP drifted by ``f`` runs every layer ``f`` times slower, also when
    every fast EP has drifted (drifts by powers of two scale exactly); a
    dead EP gets a huge finite derate; nothing is measured again."""
    from repro_torch.serve import drifted_platform

    ev, _ = _measured_oracles(model)
    bare = h100_platform_from_streams(4, props=H100_PROPS)
    ev = ev.on_platform(bare)
    drifted = drifted_platform(bare, EPDerates(factors=factors), dead=frozenset(dead))
    other = ev.on_platform(drifted)
    assert other.measured is ev.measured and other.platform is drifted
    layers = network_layers("synthnet")
    for ep in range(4):
        for i, m in enumerate(ev.measured):
            if ep in dead:
                assert other.derates.scale(ep, m) > 1e15 * ev.derates.scale(ep, m)
                assert math.isfinite(other.layer_time(layers[i], ep))
            else:
                # drifted_platform speeds no EP up: a factor below 1 is no drift
                assert other.derates.scale(ep, m) == max(factors[ep], 1.0) * ev.derates.scale(ep, m)
    fast = [ep for ep in range(4) if bare.eps[ep].flops == max(e.flops for e in bare.eps)]
    if all(factors[ep] > 1.0 for ep in fast):
        # every fast EP drifted: the drifted platform's own fastest is the wrong base
        assert other.derates != EPDerates.from_platform(drifted)
    for conf in (_seed_conf(n) for n in (1, 2, 3, 4)):
        want = []
        for s, (a, b) in enumerate(conf.boundaries()):
            e = conf.eps[s]
            t = sum(other.derates.scale(e, ev.measured[i]) + ev.layer_overhead for i in range(a, b))
            if s < conf.depth - 1:
                t += layers[b - 1].act_bytes / bare.eps[e].link_bw + bare.eps[e].link_latency
            want.append(t)
        assert other.stage_times(conf) == want
    with pytest.raises(ValueError, match="not distinct EPs"):
        ev.on_platform(dataclasses.replace(bare, eps=(bare.eps[0], *bare.eps[:3])))


def test_measuring_evaluator_on_the_same_eps_keeps_its_derates(model):
    """What phase 5b calls: the same EPs with a fabric or a power model
    attached keep the measured platform's derates bit for bit."""
    ev, _ = _measured_oracles(model)
    for plat in (ev.platform, h100_platform_from_streams(4, props=H100_PROPS)):
        other = ev.on_platform(plat)
        assert other.derates == ev.derates == EPDerates.from_platform(plat)
        conf = _seed_conf(3)
        assert other.stage_times(conf) == ev.stage_times(conf)


@pytest.mark.parametrize("part", [(0, 2), (3, 1), (2,), (1, 3, 0, 2)])
@pytest.mark.parametrize("factors,dead", [((1.0, 1.0, 1.0, 1.0), ()), ((2.0, 1.0, 4.0, 1.0), ()),
                                          ((1.0, 2.0, 1.0, 1.0), (0,))])
def test_measuring_evaluator_serves_a_tenant_partition_and_its_drifted_copy(factors, dead, part):
    """``on_platform`` of one tenant's partition (``serve.subplatform``: the
    chosen EPs reindexed from 0, in any order) and of a drifted copy of it:
    each EP runs a layer at the measured speed it has in the whole platform,
    times its own drift; nothing is measured again.  Stage times are the
    measured layer times scaled by the derates, on CPU stand-in layers."""
    from repro_torch.serve import drifted_platform, subplatform

    layers = network_layers("synthnet")
    fns = [lambda x, i=i: x + i for i in range(len(layers))]
    bare = h100_platform_from_streams(4, props=H100_PROPS)
    ev = MeasuringEvaluator(bare, layers, layer_fns=fns, layer_args=[(torch.zeros(2),)] * len(fns), reps=1,
                            device="cpu")
    sub = subplatform(bare, part, "tenant")
    drift = EPDerates(factors=tuple(factors[g] for g in part))
    local_dead = frozenset(i for i, g in enumerate(part) if g in dead)
    for plat in (sub, drifted_platform(sub, drift, dead=local_dead)):
        other = ev.on_platform(plat)
        assert other.measured is ev.measured and other.platform is plat
        for i, g in enumerate(part):
            if plat is sub:
                assert other.derates.factors[i] == ev.derates.factors[g]
            elif i in local_dead:
                assert other.derates.factors[i] > 1e15 * ev.derates.factors[g]
            else:
                assert other.derates.factors[i] == factors[g] * ev.derates.factors[g]
        seed = generate_seed(weights(layers), plat, n_stages=len(part)).conf
        want = []
        for s, (a, b) in enumerate(seed.boundaries()):
            e = seed.eps[s]
            t = sum(other.derates.scale(e, ev.measured[i]) + ev.layer_overhead for i in range(a, b))
            if s < seed.depth - 1:
                t += layers[b - 1].act_bytes / plat.eps[e].link_bw + plat.eps[e].link_latency
            want.append(t)
        assert other.stage_times(seed) == want
    with pytest.raises(ValueError, match="not distinct EPs"):
        ev.on_platform(dataclasses.replace(sub, eps=(sub.eps[0], sub.eps[0])))
    with pytest.raises(ValueError, match="not distinct EPs"):
        ev.on_platform(dataclasses.replace(sub, eps=(dataclasses.replace(sub.eps[0], name="elsewhere"),)))


#: SynthNet's layer times (ms, microbatch of 2) as phase 4 of chip_smoke.py
#: measured them on an NVIDIA H100 80GB HBM3 at 700 W: the CPU rehearsal of
#: phase 5c serves the card's oracle, whatever the CPU's own times
CARD_LAYER_MS = (0.123, 0.5224, 0.3222, 0.3185, 0.3962, 0.9507, 0.3618, 0.332, 0.3515, 0.2998, 0.9504, 0.3252,
                 0.293, 0.3121, 0.3225, 0.9524, 0.4031, 0.35)


def test_chip_smoke_online_phase_runs_on_cpu(monkeypatch):
    """``chip_smoke.serve_online`` (phase 5c) on the card's layer times with a
    tiny SynthNet's pipelines on the CPU: its checks hold and every split a
    re-tune installed equals the sequential model."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.setattr(smoke, "pipeline_throughput", lambda runner, micro: float("nan"))  # CPU speed: no reading
    res = serve_cnn(device="cpu", scale=0.12, in_shape=IN_SHAPE, seed=0)
    ev = res.evaluator
    ev.measured[:] = [t * 1e-3 for t in CARD_LAYER_MS]
    conf = run_shisha(weights(ev.layers), Trace(ev), "H3", n_stages=4).result.best_conf
    online = SimpleNamespace(evaluator=ev, conf=conf, model=res.model, micro=res.micro)
    out = smoke.serve_online(online, torch.stack([res.model(x) for x in res.micro]), horizon=30.0)
    kinds = out["drift"]["kinds"]
    assert [k for k in kinds if k in ("slowdown", "dropout", "recovery")][:3] == ["slowdown", "dropout", "recovery"]
    assert out["drift"]["tune_trials_counted"] == sum(out["drift"]["trials"])
    assert "throttle" in out["thermal"]["kinds"] and out["thermal"]["throttle_events_modelled"] > 0
    assert out["chaos"]["n_retries"] > 0 and 0.0 < out["chaos"]["availability"] <= 1.0
    assert len(out["splits"]) >= 3


#: SynthNet's and ResNet50's layer times (ms, microbatch of 2, 220x220x3 and
#: 224x224x3) as phase 5d of chip_smoke.py measured them over 8 stream EPs on
#: an NVIDIA H100 80GB HBM3 at 700 W
CARD_CO_MS = {
    "synthnet": (0.0883, 0.4404, 0.4534, 0.3704, 0.4896, 0.9534, 0.4076, 0.3785, 0.4785, 0.385, 0.9529, 0.4892,
                 0.395, 0.3795, 0.4611, 0.9526, 0.396, 0.4938),
    "resnet50": (0.1033, 0.4796, 0.4871, 0.4891, 0.5514, 0.5252, 0.4947, 0.4182, 0.4073, 0.4147, 0.4907, 0.474,
                 0.4515, 0.4652, 0.4748, 0.4593, 0.5296, 0.4975, 0.4859, 0.4898, 0.4794, 0.459, 0.4927, 0.4838,
                 0.4929, 0.4845, 0.446, 0.4495, 0.4637, 0.4559, 0.4576, 0.444, 0.4541, 0.4332, 0.4477, 0.4426,
                 0.449, 0.4591, 0.4484, 0.4525, 0.4429, 0.4462, 0.4633, 0.4552, 0.4461, 0.4463, 0.4449, 0.4394,
                 0.4431, 0.4619),
}


def test_chip_smoke_co_serve_phase_runs_on_cpu(monkeypatch):
    """``chip_smoke.co_serve_online`` (phase 5d) on the card's SynthNet and
    ResNet50 layer times with tiny models' pipelines on the CPU: its checks
    hold, the dropout is answered by a steal and the revival by a grant, and
    every installed split equals its sequential model."""
    import importlib.util

    from repro_torch.launch.serve_cnn import BATCH, N_MICRO, measure_cnn

    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.setattr(smoke, "pipeline_throughput", lambda runner, micro: float("nan"))  # CPU speed: no reading
    plat = smoke.co_platform(H100_PROPS)
    tenants, oracles = {}, {}
    for net, card_ms in CARD_CO_MS.items():
        m = measure_cnn(net, plat, device="cpu", in_shape=IN_SHAPE, seed=smoke.CO_TENANTS[net][1], scale=0.12)
        m.evaluator.measured[:] = [t * 1e-3 for t in card_ms]
        tenants[net] = (m.model, torch.randn((N_MICRO, BATCH, *IN_SHAPE), generator=m.gen))
        oracles[net] = m.evaluator
    out = smoke.co_serve_online(tenants, oracles, horizon=30.0, props=H100_PROPS)
    events = out["events"]
    assert [e["kind"] for e in events] == ["dropout", "revival"]
    assert events[0]["victim"] == "synthnet" and events[0]["donor"] == "resnet50"
    assert events[1]["victim"] == "synthnet" and events[1]["stolen"] == events[0]["dead"]
    assert out["static"]["tenants"]["synthnet"]["retunes"][0][0] == "dropout"
    assert out["elastic_beats_static"]
    assert any(out["chaos"]["retunes"].values()) and out["chaos"]["strict_json_bytes"] > 0
    assert len(out["splits"]) >= 4


def _co_specs(m, plat_of, scale_r50=1.0):
    """Phase 5d's tenants in package ``m`` (``repro`` or ``repro_torch``):
    the card's measured oracles, their caps on the interleaved partition, the
    reference fixture's recorded loads and 3x-latency SLOs."""
    from repro_torch.launch.serve_cnn import measure_cnn

    plat = plat_of()
    oracles = {}
    for net, card_ms in CARD_CO_MS.items():
        ev = measure_cnn(net, h100_platform_from_streams(8, props=H100_PROPS), device="cpu", in_shape=IN_SHAPE,
                         scale=0.12).evaluator
        ev.measured[:] = [t * 1e-3 * (scale_r50 if net == "resnet50" else 1.0) for t in card_ms]
        oracles[tuple(layer.name for layer in ev.layers)] = ev

    def make_evaluator(p, layers):
        return oracles[tuple(layer.name for layer in layers)].on_platform(p)

    tenants, slos = [], {}
    for net, part in zip(CARD_CO_MS, m.serve.partition_eps(plat, 2, "interleaved")):
        layers = m.cnn.network_layers(net)
        ev = make_evaluator(m.serve.subplatform(plat, part, net), layers)
        sh = m.heuristics.run_shisha(m.core.weights(layers), m.core.Trace(ev), "H3")
        cap, slos[net] = sh.result.best_throughput, 3.0 * sum(ev.stage_times(sh.result.best_conf))
        gen = (m.serve.PoissonTraffic(rate=0.65 * cap, seed=11) if net == "synthnet"
               else m.serve.MMPPTraffic(rate_low=0.08 * cap, rate_high=0.30 * cap, seed=12))
        tenants.append(m.serve.Tenant(name=net, layers=tuple(layers), traffic=m.serve.ReplayTraffic.record(gen, 60.0),
                                      slo=slos[net]))
    return tenants, make_evaluator, slos


def _co_packages():
    from types import SimpleNamespace

    import repro.core as jcore
    import repro.core.heuristics as jheuristics
    import repro.faults as jfaults
    import repro.serve as jserve
    import repro_torch.core as tcore
    import repro_torch.core.heuristics as theuristics
    import repro_torch.faults as tfaults
    import repro_torch.serve as tserve
    from repro_torch.models import cnn as tcnn

    def jplat():
        p = h100_platform_from_streams(8, props=H100_PROPS)
        return jcore.Platform(name=p.name, eps=tuple(jcore.EP(**dataclasses.asdict(e)) for e in p.eps))

    port = SimpleNamespace(core=tcore, heuristics=theuristics, cnn=tcnn, serve=tserve, faults=tfaults,
                           plat=lambda: h100_platform_from_streams(8, props=H100_PROPS))
    ref = SimpleNamespace(core=jcore, heuristics=jheuristics, cnn=jcnn, serve=jserve, faults=jfaults, plat=jplat)
    return port, ref


@pytest.mark.parametrize("elastic", [True, False])
def test_measured_co_serve_matches_the_reference_co_simulator(elastic):
    """Phase 5d's scenario (a) on the card's measured oracles, co-served by
    the port and by the JAX package's co-simulator over the same oracles:
    the same ``CoServeResult``s (``dataclasses.asdict``)."""
    faults = [("dropout", 20.0, 0), ("revival", 40.0, 0)]
    out = []
    for m in _co_packages():
        tenants, make_evaluator, _ = _co_specs(m, m.plat)
        res = m.serve.co_serve(m.plat(), tenants, horizon=60.0, make_evaluator=make_evaluator, elastic=elastic,
                               faults=faults, batch_policy_search=True, measure_batches=2, alpha=4)
        out.append(dataclasses.asdict(res))
    assert out[0] == out[1]
    assert [e["kind"] for e in out[0]["repartitions"]] == (["dropout", "revival"] if elastic else [])


def _co_chaos(m):
    """Phase 5d (b)'s chaos over ``_co_specs`` (ResNet50 x1.2), as
    ``co_serve``'s keywords."""
    tenants, make_evaluator, slos = _co_specs(m, m.plat, scale_r50=1.2)
    chaos = m.faults.FaultModel(seed=7, ep_mtbf={2: 9.0}, ep_mttr={2: 2.4}, batch_error_p=0.03)
    pol = m.faults.ResiliencePolicy(deadline_s=max(slos.values()), max_retries=2, queue_cap=256)
    return tenants, dict(horizon=60.0, make_evaluator=make_evaluator, chaos=chaos, resilience=pol,
                         batch_policy_search=True, measure_batches=2, alpha=4)


def test_known_defect_elastic_chaos_drains_a_lane_and_raises_all_eps_dead_in_both_packages():
    """The open defect of ``ROADMAP.md`` queue 3, recorded: elastic chaos on
    the SEPs can drain a tenant down to one SEP; when it dies while the
    other lane explores, the co-simulator defers the re-partition and the
    lane's own re-tune finds every EP dead and raises, in the JAX package as
    in the port.  A fix (in both, to keep them equal) makes this test fail:
    then it becomes a check that both serve this run to its end alike."""
    for m in _co_packages():
        tenants, kw = _co_chaos(m)
        with pytest.raises(RuntimeError, match="all EPs dead"):
            m.serve.co_serve(m.plat(), tenants, elastic=True, **kw)


def test_chaos_on_the_launch_partitions_is_served_alike_in_both_packages():
    """Phase 5d (b) serves its chaos on the launch partitions, where each
    lane keeps its FEPs: both packages serve it to the end, alike."""
    got = {}
    for name, m in zip(("port", "ref"), _co_packages()):
        tenants, kw = _co_chaos(m)
        got[name] = dataclasses.asdict(m.serve.co_serve(m.plat(), tenants, elastic=False, **kw))
    assert got["port"] == got["ref"]
