"""The port's pipeline runtime on the CPU, against sequential execution and
against the JAX package's platform and derate model.

On the CPU the stage mesh has no streams and the runner runs the same
fill/steady/drain schedule in order; the stream path runs in
``tests/test_torch_gpu.py``.
"""

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
from repro.pipeline.hetero import EPDerates as JEPDerates, tpu_platform_from_mesh
from repro_torch.core import Trace, generate_seed, paper_platform, run_shisha, weights
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
