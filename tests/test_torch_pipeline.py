"""The port's pipeline runtime on the CPU, against sequential execution and
against the JAX package's platform and derate model.

On the CPU the stage mesh has no streams and the runner runs the same
fill/steady/drain schedule in order; the stream path runs in
``tests/test_torch_gpu.py``.
"""

import dataclasses
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
    with pytest.raises(ValueError, match="other EPs"):
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
