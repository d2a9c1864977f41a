"""Tests of the port that need an NVIDIA GPU with the CUDA toolkit.

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Each test is marked ``gpu`` and skips, from a fixture, where no card is
visible.  The file imports no JAX (the machine with the card has none):
the plain PyTorch versions, held against the JAX package on the CPU by the
other ``test_torch_*`` files, are the references here.  fp32 throughout,
TF32 off; kernel-vs-plain tolerance 3e-4, the reference's conv tolerance.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # CI installs requirements-dev.txt, which has no torch

from repro_torch.core import generate_seed, paper_platform, weights
from repro_torch.kernels import im2col_conv, ops
from repro_torch.launch.mesh import make_stage_mesh
from repro_torch.models.cnn import NETWORKS, make_cnn, network_layers
from repro_torch.pipeline import MeasuringEvaluator, PipelineRunner, h100_platform_from_streams

pytestmark = pytest.mark.gpu

TOL = dict(rtol=3e-4, atol=3e-4)


@pytest.fixture(scope="module", autouse=True)
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(xs, ws, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(xs, dtype=np.float32)
    w = rng.standard_normal(ws, dtype=np.float32) / np.float32(np.sqrt(np.prod(ws[:3])))
    return torch.from_numpy(x).cuda(), torch.from_numpy(w).cuda()


SMALL = [((2, 12, 12, 8), (r, r, 8, 24), st) for r in (1, 3, 5) for st in (1, 2)] + [
    ((2, 20, 20, 8), (11, 11, 8, 16), 4),
    ((2, 23, 21, 6), (11, 11, 6, 17), 4),
    ((3, 13, 11, 5), (3, 3, 5, 17), 1),
    ((1, 1, 1, 3), (1, 1, 3, 1), 1),
]
#: every distinct layer shape of the paper's networks, at a microbatch of 2
PAPER = sorted(
    {((2, sp.h_out * sp.stride, sp.h_out * sp.stride, sp.c_in), (sp.r, sp.s, sp.c_in, sp.k), sp.stride)
     for name in sorted(NETWORKS) for sp in NETWORKS[name]()}
)


@pytest.mark.parametrize("xs,ws,stride", SMALL + PAPER)
def test_kernel_matches_plain(xs, ws, stride):
    x, w = _inputs(xs, ws)
    y = im2col_conv.conv2d_im2col(x, w, stride=stride)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, im2col_conv.conv2d_im2col_plain(x, w, stride=stride), **TOL)


def test_each_launch_counts_once_and_ops_routes_cuda_to_the_kernel():
    x, w = _inputs((2, 12, 12, 8), (3, 3, 8, 24))
    before = im2col_conv.launches
    im2col_conv.conv2d_im2col(x, w)
    ops.conv2d_im2col(x, w, stride=2)
    im2col_conv.conv2d_im2col_plain(x, w)
    assert im2col_conv.launches == before + 2


@pytest.mark.parametrize(
    "mutate,err",
    [
        (lambda x, w: (x.double(), w.double()), TypeError),
        (lambda x, w: (x, w.cpu()), ValueError),
        (lambda x, w: (x.transpose(1, 2), w), ValueError),
        (lambda x, w: (x, w[:, :, :4]), ValueError),
    ],
)
def test_wrapper_refuses_what_the_kernel_does_not_take(mutate, err):
    x, w = _inputs((2, 12, 12, 8), (3, 3, 8, 24))
    before = im2col_conv.launches
    with pytest.raises(err):
        im2col_conv.conv2d_im2col(*mutate(x, w))
    assert im2col_conv.launches == before


def test_kernel_runs_on_the_current_stream():
    x, w = _inputs((2, 27, 27, 96), (5, 5, 96, 256))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        y = im2col_conv.conv2d_im2col(x, w)
        done = torch.cuda.Event()
        done.record()
    done.synchronize()
    torch.testing.assert_close(y, im2col_conv.conv2d_im2col_plain(x, w), **TOL)


@pytest.fixture(scope="module")
def model(cuda):
    return make_cnn("synthnet", scale=0.1, device="cuda").init(torch.Generator(device="cuda").manual_seed(0))


@pytest.mark.parametrize("n_stages,n_micro", [(4, 5), (2, 3), (4, 1)])
def test_stream_pipeline_equals_sequential(model, n_stages, n_micro):
    conf = generate_seed(weights(network_layers("synthnet")), paper_platform(4), n_stages=n_stages).conf
    mesh = make_stage_mesh(n_stages, "cuda")
    assert len(mesh.streams) == n_stages
    runner = PipelineRunner(mesh=mesh, conf=conf, apply_layer=model.apply_layer, n_micro=n_micro)
    micro = torch.randn((n_micro, 2, 8, 8, 8), generator=torch.Generator(device="cuda").manual_seed(1),
                        device="cuda")
    out = runner.run(micro)
    ref = torch.stack([model(micro[i]) for i in range(n_micro)])
    assert torch.equal(out, ref)  # same kernels on the same inputs
    assert runner.ticks == n_micro + n_stages - 1
    plain = []
    for x in micro:
        for i, sp in enumerate(model.specs):
            x = torch.relu(im2col_conv.conv2d_im2col_plain(model.layer_input(i, x), model.w[i], stride=sp.stride)
                           + model.b[i])
        plain.append(x)
    plain = torch.stack(plain)
    torch.testing.assert_close(out, plain, rtol=1e-3, atol=1e-3 * float(plain.abs().max()))


def test_measuring_evaluator_times_with_events(model):
    x = torch.zeros((2, 8, 8, 8), device="cuda")
    fns = [lambda x, i=i: model.apply_layer(i, x) for i in range(len(model.specs))]
    before = im2col_conv.launches
    ev = MeasuringEvaluator(h100_platform_from_streams(4), network_layers("synthnet"), layer_fns=fns,
                            layer_args=[(x,)] * len(fns), reps=2, device="cuda")
    assert im2col_conv.launches == before + 3 * len(fns)  # warm-up + 2 reps per layer
    assert all(0 < t < 1 for t in ev.measured)


def test_h100_platform_reads_the_card():
    props = torch.cuda.get_device_properties(0)
    p = h100_platform_from_streams(4)
    assert p.eps[0].cores == props.multi_processor_count // 4
