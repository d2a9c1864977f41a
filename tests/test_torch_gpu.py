"""Tests of the port that need an NVIDIA GPU with the CUDA toolkit.

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Each test is marked ``gpu`` and skips, from a fixture, where no card is
visible.  The file imports no JAX (the machine with the card has none):
the plain PyTorch versions, held against the JAX package on the CPU by the
other ``test_torch_*`` files, are the references here.  TF32 off.
Kernel-vs-plain tolerances: in fp32 the reference's (conv 3e-4, attention
2e-4, SSD 2e-3, GEMM 2e-4); in bf16 max |kernel - plain| within 1e-2 of max
|plain| (both keep fp32 inside and differ by where the output, and for
attention p, is rounded to bf16, 2^-8 relative each), and for the GEMM the
reference's bf16 tolerance, 6e-2.  The smoke LM path on the card is held
against itself on the CPU at 3e-4 relative to the largest |logit| in fp32
(the reference's prefill-vs-decode tolerance).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # CI installs requirements-dev.txt, which has no torch

from repro_torch.core import generate_seed, paper_platform, weights
import dataclasses

from repro_torch.configs import get_smoke
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gemm as gm
from repro_torch.kernels import im2col_conv, ops
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.launch.serve import serve
from repro_torch.models import transformer
from repro_torch.models.lm_common import init_params
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


#: SynthNet's 13x13 layer (3x3x384 -> 384), which the plan splits over the reduction
SPLIT_SHAPE = ((2, 13, 13, 384), (3, 3, 384, 384))


def _plan(x, w, stride=1):
    return im2col_conv.plan(tuple(x.shape), tuple(w.shape), stride,
                            sms=torch.cuda.get_device_properties(0).multi_processor_count)


def test_split_shape_gives_the_same_bits_twice_and_counts_one_launch():
    x, w = _inputs(*SPLIT_SHAPE)
    assert _plan(x, w).splits > 1
    before = im2col_conv.launches
    a = im2col_conv.conv2d_im2col(x, w)
    b = im2col_conv.conv2d_im2col(x, w)
    torch.cuda.synchronize()
    assert im2col_conv.launches == before + 2  # the split sum is not a second count
    assert torch.equal(a, b)
    torch.testing.assert_close(a, im2col_conv.conv2d_im2col_plain(x, w), **TOL)


def test_two_streams_at_once_equal_the_same_calls_in_turn():
    """Each call's partials live in its own workspace on its own stream."""
    (x1, w1), (x2, w2) = _inputs(*SPLIT_SHAPE, seed=1), _inputs((2, 27, 27, 96), (5, 5, 96, 256), seed=2)
    seq = [im2col_conv.conv2d_im2col(x1, w1), im2col_conv.conv2d_im2col(x2, w2)]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    for st, (x, w) in zip(streams, ((x1, w1), (x2, w2))):
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            outs.append([im2col_conv.conv2d_im2col(x, w) for _ in range(4)])
    torch.cuda.synchronize()
    for want, got in zip(seq, outs):
        for y in got:
            assert torch.equal(y, want)


@pytest.mark.parametrize(
    "xs,ws,stride,splits",
    [
        ((2, 13, 13, 40), (3, 3, 40, 72), 1, 3),  # 23 slices in 3 splits: 7, 8, 8
        ((2, 13, 13, 40), (3, 3, 40, 72), 1, 5),
        ((2, 40, 44, 6), (11, 11, 6, 40), 4, 7),  # 11x11 stride 4, C % 4 != 0: 4-byte copies
        ((2, 40, 44, 6), (11, 11, 6, 40), 4, 1),
    ],
)
def test_uneven_splits_and_4_byte_copies_match_plain(xs, ws, stride, splits):
    x, w = _inputs(xs, ws)
    want = im2col_conv.conv2d_im2col_plain(x, w, stride=stride)
    torch.testing.assert_close(im2col_conv.conv2d_im2col(x, w, stride=stride), want, **TOL)
    p = dataclasses.replace(_plan(x, w, stride), splits=splits)
    assert p.slices % splits != 0 or splits == 1
    for bm, bn in im2col_conv.TILES:
        y = im2col_conv.run_plan(x, w, stride, dataclasses.replace(p, bm=bm, bn=bn))
        torch.cuda.synchronize()
        torch.testing.assert_close(y, want, **TOL)


@pytest.mark.parametrize("xs,ws,stride", [((2, 27, 27, 96), (5, 5, 96, 256), 1), (*SPLIT_SHAPE, 1),
                                          ((2, 20, 20, 8), (11, 11, 8, 16), 4)])
def test_misaligned_input_takes_4_byte_copies_with_the_same_bits(xs, ws, stride):
    x, w = _inputs(xs, ws)
    assert _plan(x, w, stride).vector
    x_off = torch.empty(x.numel() + 1, device="cuda")[1:].view(x.shape)  # contiguous, 4 bytes past 16
    w_off = torch.empty(w.numel() + 3, device="cuda")[3:].view(w.shape)
    x_off.copy_(x)
    w_off.copy_(w)
    assert x_off.is_contiguous() and x_off.data_ptr() % 16 == 4 and w_off.data_ptr() % 16 == 12
    want = im2col_conv.conv2d_im2col(x, w, stride=stride)
    for got in (im2col_conv.conv2d_im2col(x_off, w, stride=stride), im2col_conv.conv2d_im2col(x, w_off, stride=stride),
                im2col_conv.run_plan(x, w, stride, _plan(x, w, stride), vector=False)):
        torch.cuda.synchronize()
        assert torch.equal(got, want)


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


# ---------------------------------------------------------------------------
# LM serving kernels: flash attention and the SSD chunk scan
# ---------------------------------------------------------------------------

BF16_REL = 1e-2


def _agree(got, want, tol, fp32):
    """fp32: allclose at ``tol``; bf16: within BF16_REL of max |want| (``tol`` unused)."""
    if fp32:
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    else:
        assert (got.float() - want.float()).abs().max().item() <= BF16_REL * want.float().abs().max().item()


def _attn(b, h, kvh, s, d, dtype, seed=0, bshd=False):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, s, h, d) if bshd else (b, h, s, d), generator=g, device="cuda").to(dtype)
    k = torch.randn((b, kvh, s, d), generator=g, device="cuda").to(dtype)
    v = torch.randn((b, kvh, s, d), generator=g, device="cuda").to(dtype)
    return (q.transpose(1, 2) if bshd else q), k, v


ATTN_CASES = (
    [(2, h, kvh, s, 32, torch.float32, c, 0) for c in (True, False) for h, kvh in ((4, 4), (4, 2), (8, 1)) for s in (64, 128)]
    + [
        (2, 4, 2, 200, 64, torch.float32, True, 0),  # ragged S
        (2, 4, 2, 100, 64, torch.float32, True, 16),  # window
        (1, 4, 4, 77, 128, torch.float32, False, 9),  # non-causal window, D 128
        (1, 7, 1, 33, 64, torch.float32, True, 0),  # qwen2-like grouping, ragged
        (4, 32, 8, 512, 64, torch.bfloat16, True, 0),  # granite-3-2b prefill
        (4, 32, 8, 512, 64, torch.float32, True, 0),
        (1, 64, 8, 256, 128, torch.bfloat16, True, 0),  # qwen3-32b heads
        (2, 8, 2, 300, 128, torch.bfloat16, True, 50),  # bf16, ragged, window
        # the tensor-core kernel's branches: every head dim, GQA groups 1 / 4 / 5,
        # S of one row, under one fragment, one key past a tile and ragged long,
        # a window narrower than a 16-row fragment, and no causal mask
        (2, 4, 4, 65, 16, torch.bfloat16, True, 0),
        (2, 8, 2, 15, 32, torch.bfloat16, True, 0),
        (1, 8, 2, 1, 64, torch.bfloat16, True, 0),
        (2, 40, 8, 1000, 128, torch.bfloat16, True, 0),  # llama4-scout's grouping
        (2, 10, 2, 65, 128, torch.bfloat16, False, 0),
        (2, 4, 4, 200, 64, torch.bfloat16, True, 7),
        (1, 10, 2, 130, 32, torch.bfloat16, False, 7),
        (2, 8, 2, 1000, 16, torch.bfloat16, False, 0),
        # head dims 80 (zamba2-2.7b, MHA) and 192 (nemotron-4-340b, GQA group 12), both kernels:
        # the served prefill shapes, a ragged S, a window and no causal mask
        (4, 32, 32, 512, 80, torch.bfloat16, True, 0),
        (1, 96, 8, 512, 192, torch.bfloat16, True, 0),
        (2, 8, 8, 200, 80, torch.bfloat16, True, 7),
        (2, 24, 2, 130, 192, torch.bfloat16, True, 50),
        (1, 12, 1, 65, 80, torch.bfloat16, False, 0),
        (2, 12, 1, 300, 192, torch.bfloat16, False, 0),
        (1, 12, 1, 1, 192, torch.bfloat16, True, 0),
        (2, 4, 2, 200, 80, torch.float32, True, 0),
        (1, 12, 1, 77, 80, torch.float32, False, 9),
        (2, 24, 2, 200, 192, torch.float32, True, 0),
        (1, 24, 2, 100, 192, torch.float32, True, 16),
        (1, 12, 1, 65, 192, torch.float32, False, 0),
    ]
)


@pytest.mark.parametrize("b,h,kvh,s,d,dtype,causal,window", ATTN_CASES)
def test_flash_attention_matches_plain(b, h, kvh, s, d, dtype, causal, window):
    q, k, v = _attn(b, h, kvh, s, d, dtype, bshd=s % 2 == 0)
    y = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert y.stride() == q.stride() and y.dtype == dtype
    _agree(y, fa.flash_attention_plain(q, k, v, causal=causal, window=window), 2e-4, dtype == torch.float32)


def test_flash_attention_takes_bf16_rows_aligned_to_8_bytes():
    """Strides that are multiples of 4 elements but not 8 (bf16 rows 8-byte
    aligned) take the tensor-core kernel's 8-byte copies."""
    g = torch.Generator(device="cuda").manual_seed(0)
    b, h, kvh, s, d = 2, 8, 2, 77, 64
    q, k, v = (torch.randn((b, s, n * d + 4), generator=g, device="cuda").bfloat16()[..., : n * d]
               .unflatten(-1, (n, d)).transpose(1, 2) for n in (h, kvh, kvh))
    assert q.stride(2) % 8 == 4
    y = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    _agree(y, fa.flash_attention_plain(q, k, v), 2e-4, False)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_is_deterministic(dtype):
    q, k, v = _attn(4, 32, 8, 512, 64, dtype, bshd=True)
    assert torch.equal(fa.flash_attention(q, k, v), fa.flash_attention(q, k, v))


def test_flash_attention_runs_the_kernel_of_its_type():
    """bf16 on the tensor-core kernel, fp32 on the SIMT kernel, and never the other."""
    from torch.profiler import ProfilerActivity, profile

    for dtype, want, other in ((torch.bfloat16, "flash_fwd_mma_bf16_kernel", "flash_fwd_kernel"),
                               (torch.float32, "flash_fwd_kernel", "flash_fwd_mma_bf16_kernel")):
        q, k, v = _attn(1, 4, 2, 128, 64, dtype)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fa.flash_attention(q, k, v)
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        assert any(want in n for n in names), names
        assert not any(other in n for n in names), names


def _ssd(b, l, h, p, n, dtype, seed=0, strided=False):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if strided:
        proj = torch.randn((b, l, h * p + 2 * n), generator=g, device="cuda").to(dtype)
        x, B, C = proj[..., : h * p].reshape(b, l, h, p), proj[..., h * p : h * p + n], proj[..., h * p + n :]
    else:
        x = torch.randn((b, l, h, p), generator=g, device="cuda").to(dtype)
        B = torch.randn((b, l, n), generator=g, device="cuda").to(dtype)
        C = torch.randn((b, l, n), generator=g, device="cuda").to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((b, l, h), generator=g, device="cuda"))
    A = -torch.exp(0.5 * torch.randn((h,), generator=g, device="cuda"))
    return x, dt, A, B, C


SSD_CASES = (
    [(2, 128, h, p, n, c, torch.float32, False) for c in (16, 32) for h, p, n in ((2, 16, 8), (3, 8, 16))]
    + [
        (2, 256, 3, 100, 32, 64, torch.float32, False),  # ragged p tile
        (2, 64, 4, 16, 16, 8, torch.float32, True),  # mamba2 smoke, strided like ssd_block
        (4, 512, 24, 64, 128, 64, torch.bfloat16, True),  # mamba2-130m prefill
        (4, 512, 24, 64, 128, 64, torch.float32, False),
        (4, 512, 80, 64, 64, 64, torch.bfloat16, True),  # zamba2-2.7b prefill
        # the tensor-core kernel's branches: chunk 16 / 32 / 64, state 64 / 128,
        # p 64 and 48, one chunk, contiguous and strided; and bf16 at chunk 8 (SIMT)
        (2, 128, 4, 64, 128, 16, torch.bfloat16, True),
        (2, 96, 3, 48, 64, 32, torch.bfloat16, False),
        (1, 64, 2, 48, 128, 64, torch.bfloat16, True),
        (3, 32, 5, 16, 64, 32, torch.bfloat16, True),
        (2, 64, 4, 16, 16, 8, torch.bfloat16, True),
    ]
)


@pytest.mark.parametrize("b,l,h,p,n,chunk,dtype,strided", SSD_CASES)
def test_ssd_scan_matches_plain(b, l, h, p, n, chunk, dtype, strided):
    args = _ssd(b, l, h, p, n, dtype, strided=strided)
    y, state = ssd.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    yp, sp = ssd.ssd_scan_plain(*args, chunk=chunk)
    assert y.dtype == dtype and state.dtype == torch.float32 and y.is_contiguous()
    _agree(y, yp, 2e-3, dtype == torch.float32)
    _agree(state, sp, 2e-3, dtype == torch.float32)


@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("p", [48, 64])
def test_every_ssd_mma_plan_matches_plain(n, p):
    """Every p tile (16, 32, 64: ragged at p 48) of the tensor-core kernel,
    at chunk 64 over four chunks."""
    args = _ssd(2, 256, 3, p, n, torch.bfloat16, strided=True)
    yp, sp = ssd.ssd_scan_plain(*args, chunk=64)
    for plan in ssd.mma_plans(2, 3, p, n, 64):
        y, state = ssd.run_plan(*args, 64, plan)
        torch.cuda.synchronize()
        _agree(y, yp, None, False)
        _agree(state, sp, None, False)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_scan_gives_the_same_bits_twice_and_on_two_streams(dtype):
    args = [_ssd(4, 512, 24, 64, 128, dtype, seed=s, strided=True) for s in (1, 2)]
    seq = [ssd.ssd_scan(*a, chunk=64) for a in args]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    for st, a in zip(streams, args):
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            outs.append([ssd.ssd_scan(*a, chunk=64) for _ in range(3)])
    torch.cuda.synchronize()
    for want, got in zip(seq, outs):
        for y, state in got:
            assert torch.equal(y, want[0]) and torch.equal(state, want[1])


@pytest.mark.parametrize(
    "shape,dtype,strided,want,other",
    [
        ((4, 512, 24, 64, 128, 64), torch.bfloat16, True, "ssd_scan_mma_bf16_kernel", "ssd_scan_kernel"),  # mamba2
        ((2, 64, 4, 16, 16, 8), torch.bfloat16, True, "ssd_scan_kernel", "ssd_scan_mma_bf16_kernel"),  # chunk 8
        ((4, 512, 24, 64, 128, 64), torch.float32, False, "ssd_scan_kernel", "ssd_scan_mma_bf16_kernel"),
    ],
)
def test_ssd_scan_runs_the_kernel_of_its_route(shape, dtype, strided, want, other):
    """mamba2-130m's bf16 prefill scan on the tensor cores; chunk 8 and fp32 on the SIMT kernel, never the other."""
    from torch.profiler import ProfilerActivity, profile

    b, l, h, p, n, chunk = shape
    args = _ssd(b, l, h, p, n, dtype, strided=strided)
    ssd.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ssd.ssd_scan(*args, chunk=chunk)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert any(want in k for k in names), names
    assert not any(other in k for k in names), names


def test_ssd_unaligned_bf16_takes_the_simt_kernel():
    """x rows 2 elements past a 16-byte boundary: the SIMT kernel, same function."""
    g = torch.Generator(device="cuda").manual_seed(3)
    b, l, h, p, n = 2, 128, 3, 64, 64
    proj = torch.randn((b, l, h * p + 2 * n + 2), generator=g, device="cuda").bfloat16()[..., 2:]
    x, B, C = proj[..., : h * p].reshape(b, l, h, p), proj[..., h * p : h * p + n], proj[..., h * p + n :]
    dt = torch.nn.functional.softplus(torch.randn((b, l, h), generator=g, device="cuda"))
    A = -torch.exp(0.5 * torch.randn((h,), generator=g, device="cuda"))
    assert not ssd._aligned(x)
    assert ssd.plan(torch.bfloat16, b, h, p, n, 64, False).route == ssd.KERNELS.index("ssd_scan_kernel<__nv_bfloat16>")
    y, state = ssd.ssd_scan(x, dt, A, B, C, chunk=64)
    torch.cuda.synchronize()
    yp, sp = ssd.ssd_scan_plain(x, dt, A, B, C, chunk=64)
    _agree(y, yp, None, False)
    _agree(state, sp, None, False)


def test_lm_kernel_launches_count_once_and_ops_routes_cuda_to_them():
    q, k, v = _attn(1, 4, 2, 64, 32, torch.float32)
    args = _ssd(1, 32, 2, 8, 8, torch.float32)
    before = fa.launches, ssd.launches
    ops.flash_attention(q, k, v)
    fa.flash_attention_plain(q, k, v)
    ops.ssd_scan(*args, chunk=8)
    ssd.ssd_scan_plain(*args, chunk=8)
    assert (fa.launches, ssd.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize(
    "mutate,err",
    [
        (lambda q, k, v: (q.double(), k.double(), v.double()), TypeError),
        (lambda q, k, v: (q, k.bfloat16(), v), TypeError),
        (lambda q, k, v: (q, k.cpu(), v), ValueError),
        (lambda q, k, v: (q[..., :48], k[..., :48], v[..., :48]), ValueError),  # D 48, and strided rows
        (lambda q, k, v: (q.transpose(2, 3), k, v), ValueError),  # D not unit-stride
        (lambda q, k, v: (q[:, :3], k, v), ValueError),  # heads not a multiple of kv heads
    ],
)
def test_flash_wrapper_refuses_what_the_kernel_does_not_take(mutate, err):
    q, k, v = _attn(1, 4, 2, 64, 64, torch.float32)
    before = fa.launches
    with pytest.raises(err):
        fa.flash_attention(*mutate(q, k, v))
    assert fa.launches == before


@pytest.mark.parametrize(
    "mutate,err",
    [
        (lambda x, dt, A, B, C: (x.double(), dt, A, B, C), TypeError),
        (lambda x, dt, A, B, C: (x, dt.bfloat16(), A, B, C), TypeError),
        (lambda x, dt, A, B, C: (x, dt, A, B.cpu(), C), ValueError),
        (lambda x, dt, A, B, C: (x.transpose(2, 3).contiguous().transpose(2, 3), dt, A, B, C), ValueError),
        (lambda x, dt, A, B, C: (x[:, :20], dt[:, :20], A, B[:, :20], C[:, :20]), ValueError),  # ragged chunk
    ],
)
def test_ssd_wrapper_refuses_what_the_kernel_does_not_take(mutate, err):
    args = _ssd(1, 32, 2, 8, 8, torch.float32)
    before = ssd.launches
    with pytest.raises(err):
        ssd.ssd_scan(*mutate(*args), chunk=8)
    assert ssd.launches == before


def test_ssd_wrapper_refuses_a_chunk_beyond_shared_memory():
    args = _ssd(1, 256, 2, 64, 256, torch.float32)
    with pytest.raises(ValueError, match="shared memory"):
        ssd.ssd_scan(*args, chunk=256)


@pytest.mark.parametrize(
    "plan",
    [
        ssd.SsdPlan(2, 16, 32, ssd.mma_smem_bytes(64, 128, 16) + 16),  # shared memory the kernel does not ask
        ssd.SsdPlan(2, 8, 64, ssd.mma_smem_bytes(64, 128, 8)),  # a p tile not compiled
        ssd.SsdPlan(1, 64, 8, ssd.simt_smem_bytes(64, 128, 64)),  # the SIMT kernel where the route says mma
        ssd.SsdPlan(2, 16, 99, ssd.mma_smem_bytes(64, 128, 16)),  # blocks that are not this shape's
    ],
)
def test_ssd_run_plan_refuses_a_plan_the_kernels_do_not_have(plan):
    args = _ssd(2, 128, 4, 64, 128, torch.bfloat16, strided=True)
    before = ssd.launches
    with pytest.raises(ValueError, match="plan"):
        ssd.run_plan(*args, 64, plan)
    assert ssd.launches == before


# ---------------------------------------------------------------------------
# Batched GEMM (the MoE expert products)
# ---------------------------------------------------------------------------

GEMM_TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4), torch.bfloat16: dict(rtol=6e-2, atol=6e-2)}


def _gemm_inputs(sa, sb, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn(sa, generator=g, device="cuda").to(dtype)
    b = (torch.randn(sb, generator=g, device="cuda") / sb[-2] ** 0.5).to(dtype)
    return a, b


GEMM_CASES = (
    [((m, k), (k, n), dt) for m, k, n in ((64, 64, 64), (200, 300, 150), (128, 512, 256), (33, 65, 17))
     for dt in (torch.float32, torch.bfloat16)]  # tests/test_kernels.py grid
    + [
        ((4, 24, 40), (4, 40, 56), torch.bfloat16),  # batched, aligned
        ((3, 33, 65), (3, 65, 17), torch.bfloat16),  # batched, ragged everywhere
        ((3, 33, 65), (3, 65, 17), torch.float32),
        ((16, 8, 4096), (16, 4096, 6400), torch.bfloat16),  # phi3.5-moe decode, M = 8
        ((16, 8, 6400), (16, 6400, 4096), torch.bfloat16),
        ((16, 320, 512), (16, 512, 640), torch.bfloat16),  # prefill capacity 320, narrow
        ((16, 160, 520), (16, 520, 136), torch.bfloat16),  # llama4-scout capacity 160, K and N not whole tiles
        ((2, 256, 96), (2, 96, 200), torch.bfloat16),  # whole 64-row tiles
        ((2, 130, 64), (2, 64, 600), torch.bfloat16),  # ragged 64 x 256 tiles in M and N
        ((2, 12, 40), (2, 40, 72), torch.float32),
    ]
)


@pytest.mark.parametrize("sa,sb,dtype", GEMM_CASES)
def test_gemm_matches_plain(sa, sb, dtype):
    a, b = _gemm_inputs(sa, sb, dtype)
    y = gm.gemm(a, b)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.is_contiguous() and tuple(y.shape) == (*sa[:-1], sb[-1])
    torch.testing.assert_close(y.float(), gm.gemm_plain(a, b).float(), **GEMM_TOL[dtype])


def test_gemm_takes_strided_views_of_the_expert_stacks():
    """The model passes layer slices of [L, E, K, N] stacks and sliced rows."""
    a, w = _gemm_inputs((4, 16, 64), (3, 4, 64, 48), torch.bfloat16)
    a = a[:, ::2]  # row stride 128
    for layer in range(3):
        y = ops.gemm(a, w[layer])
        torch.testing.assert_close(y.float(), gm.gemm_plain(a, w[layer]).float(), **GEMM_TOL[torch.bfloat16])
    a2 = torch.randn((8, 80), device="cuda").bfloat16()[:, 3:67]  # rows not 16-byte aligned
    b2 = torch.randn((64, 24), device="cuda").bfloat16()
    torch.testing.assert_close(gm.gemm(a2, b2).float(), gm.gemm_plain(a2, b2).float(), **GEMM_TOL[torch.bfloat16])


def test_gemm_launch_counts_once_and_ops_routes_cuda_to_it():
    a, b = _gemm_inputs((2, 8, 32), (2, 32, 16), torch.bfloat16)
    before = gm.launches
    gm.gemm(a, b)
    ops.gemm(a, b)
    gm.gemm_plain(a, b)
    assert gm.launches == before + 2


@pytest.mark.parametrize("batch,n", [(1, 6408), (16, 6392)])
@pytest.mark.parametrize("m", [17, 64, 100, 160, 320, 321])
def test_gemm_wgmma_matches_plain_past_whole_tiles(m, batch, n):
    """The wgmma route at every capacity that matters and its neighbours, K
    and N not whole tiles (64 and 128): TMA's zero fill and the masked
    stores at every edge, inside each expert.  N 6408 makes 51 column tiles
    (one block a cluster), 6392 makes 50 (two-block clusters sharing A)."""
    a, b = _gemm_inputs((batch, m, 4104), (batch, 4104, n), torch.bfloat16)
    assert gm.route(a.dtype, m, 4104, n, gm._aligned(a) and gm._aligned(b)) == gm.KERNELS.index(
        "gemm_wgmma_bf16_kernel")
    y = gm.gemm(a, b)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and y.is_contiguous() and tuple(y.shape) == (batch, m, n)
    torch.testing.assert_close(y.float(), gm.gemm_plain(a, b).float(), **GEMM_TOL[torch.bfloat16])


def test_gemm_wgmma_takes_layer_slices_of_the_expert_stacks():
    """Tensor maps over strided views: a layer slice of an [L, E, K, N] stack
    (a base offset per layer) and every other row of the capacity buffer."""
    a, w = _gemm_inputs((4, 200, 264), (3, 4, 264, 136), torch.bfloat16)
    a = a[:, ::2]  # 100 rows, row stride 528
    wgmma = gm.KERNELS.index("gemm_wgmma_bf16_kernel")
    for layer in (1, 2):
        assert w[layer].storage_offset() > 0
        assert gm.route(a.dtype, 100, 264, 136, gm._aligned(a) and gm._aligned(w[layer])) == wgmma
        y = ops.gemm(a, w[layer])
        torch.cuda.synchronize()
        torch.testing.assert_close(y.float(), gm.gemm_plain(a, w[layer]).float(), **GEMM_TOL[torch.bfloat16])


@pytest.mark.parametrize(
    "sa,sb,view,want,other",
    [
        ((16, 8, 4096), (16, 4096, 640), None, "gemm_mma_bf16_kernel", "gemm_wgmma_bf16_kernel"),  # decode, M = 8
        ((2, 16, 64), (2, 64, 128), None, "gemm_mma_bf16_kernel", "gemm_wgmma_bf16_kernel"),  # M = 16
        ((2, 100, 80), (2, 80, 72), "unaligned", "gemm_mma_bf16_kernel", "gemm_wgmma_bf16_kernel"),
        ((2, 100, 65), (2, 65, 72), None, "gemm_mma_bf16_kernel", "gemm_wgmma_bf16_kernel"),  # K not a multiple of 8
        ((2, 17, 64), (2, 64, 128), None, "gemm_wgmma_bf16_kernel", "gemm_mma_bf16_kernel"),  # M = 17
        ((16, 320, 512), (16, 512, 640), None, "gemm_wgmma_bf16_kernel", "gemm_mma_bf16_kernel"),
    ],
)
def test_gemm_runs_the_kernel_of_its_route(sa, sb, view, want, other):
    """Decode's M <= 16 and rows the TMA cannot address stay on mma.sync;
    aligned bf16 past 16 rows runs wgmma, and never the other."""
    from torch.profiler import ProfilerActivity, profile

    a, b = _gemm_inputs(sa, sb, torch.bfloat16)
    if view == "unaligned":  # rows start 6 bytes past a 16-byte boundary
        a = torch.cat([a, a[..., :8]], -1)[..., 3 : 3 + sa[-1]]
    y = gm.gemm(a, b)  # warm: the profiler below sees steady launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            gm.gemm(a, b)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert any(want in n for n in names), names
    assert not any(other in n for n in names), names
    torch.testing.assert_close(y.float(), gm.gemm_plain(a, b).float(), **GEMM_TOL[torch.bfloat16])


@pytest.mark.parametrize(
    "mutate,err",
    [
        (lambda a, b: (a.int(), b.int()), TypeError),
        (lambda a, b: (a.half(), b.half()), TypeError),
        (lambda a, b: (a, b.float()), TypeError),
        (lambda a, b: (a, b.cpu()), ValueError),
        (lambda a, b: (a, b[:, :-1]), ValueError),  # mismatched K
        (lambda a, b: (a, b[:1]), ValueError),  # mismatched batch
        (lambda a, b: (a.transpose(1, 2), b[:, :8]), ValueError),  # K not unit-stride
        (lambda a, b: (a[:, :0], b), ValueError),  # empty
    ],
)
def test_gemm_refuses_what_the_kernel_does_not_take(mutate, err):
    a, b = _gemm_inputs((2, 8, 32), (2, 32, 16), torch.bfloat16)
    before = gm.launches
    with pytest.raises(err):
        gm.gemm(*mutate(a, b))
    assert gm.launches == before


@pytest.mark.parametrize("arch,over", [("granite-3-2b", {}), ("qwen3-32b", {}), ("nemotron-4-340b", {}),
                                       ("granite-3-2b", {"sliding_window": 6}), ("mamba2-130m", {}),
                                       ("phi3.5-moe-42b", {}), ("llama4-scout-17b", {}), ("zamba2-2.7b", {}),
                                       ("zamba2-2.7b", {"sliding_window": 6}),
                                       ("nemotron-4-340b", {"head_dim": 192})])  # nemotron's head dim, GQA group 2
def test_smoke_lm_path_on_the_card_matches_the_cpu(arch, over):
    cfg = dataclasses.replace(get_smoke(arch), dtype=torch.float32, **over)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    on_card = {k: ({kk: vv.cuda() for kk, vv in v.items()} if isinstance(v, dict) else v.cuda()) for k, v in params.items()}
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 24)))
    logits = {}
    for dev, p in (("cpu", params), ("cuda", on_card)):
        before = fa.launches + ssd.launches + gm.launches
        with torch.inference_mode():
            lg, cache = transformer.prefill_step(cfg, p, {"tokens": toks[:, :16].to(dev)}, max_len=24)
            out = [lg]
            for t in range(16, 24):
                lg, cache = transformer.serve_step(cfg, p, cache, toks[:, t : t + 1].to(dev))
                out.append(lg)
        logits[dev] = torch.stack(out, 1).cpu()
        assert (fa.launches + ssd.launches + gm.launches - before > 0) == (dev == "cuda")
    scale = float(logits["cpu"].abs().max())
    torch.testing.assert_close(logits["cuda"], logits["cpu"], rtol=3e-4, atol=3e-4 * scale)


def test_serve_on_the_card_runs_the_smoke_models():
    for arch in ("granite-3-2b", "mamba2-130m", "phi3.5-moe-42b", "llama4-scout-17b", "zamba2-2.7b"):
        out = serve(get_smoke(arch), batch=2, prompt_len=16, gen=4, device="cuda")
        assert tuple(out["tokens"].shape) == (2, 4) and out["tokens"].is_cuda
