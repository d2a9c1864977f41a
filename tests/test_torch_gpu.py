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
from repro_torch.data import DataConfig, make_batch_iterator
from repro_torch.launch.serve import make_batch, serve
from repro_torch.launch.train import train
from repro_torch.models import transformer
from repro_torch.models.lm_common import init_params
from repro_torch.optim import AdamW, AdamWConfig
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


def test_placement_and_dvfs_phase_on_the_card():
    """``chip_smoke.place_and_scale`` (phase 5b: the degenerate pins, a
    relocation paid on the routed mesh, the capped levels meeting the cap,
    both splits as stream pipelines equal to the sequential model) at a
    small SynthNet on the card, where its pipelines launch the conv."""
    import importlib.util
    from pathlib import Path

    from repro_torch.launch.serve_cnn import serve_cnn

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    res = serve_cnn(device="cuda", scale=0.12, in_shape=(16, 16, 8), seed=0)
    seq = torch.stack([res.model(x) for x in res.micro])
    before = im2col_conv.launches
    out = smoke.place_and_scale(res, seq)
    torch.cuda.synchronize()
    assert im2col_conv.launches > before
    assert out["placed"]["relocation_trials"] > 0
    assert out["capped"]["package_w_modelled"] <= out["capped"]["cap_w_modelled"]
    assert all(out[k]["measured_micro_per_s"] > 0 for k in ("placed", "capped"))


def test_online_phase_on_the_card():
    """``chip_smoke.serve_online`` (phase 5c: scripted drift, chaos and
    thermal throttling served on the measured oracle, every installed split
    as a stream pipeline equal to the sequential model) at a small SynthNet
    and a short horizon on the card, where its pipelines launch the conv."""
    import importlib.util
    from pathlib import Path

    from repro_torch.launch.serve_cnn import serve_cnn

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    res = serve_cnn(device="cuda", scale=0.12, in_shape=(16, 16, 8), seed=0)
    seq = torch.stack([res.model(x) for x in res.micro])
    before = im2col_conv.launches
    out = smoke.serve_online(res, seq, horizon=30.0)
    torch.cuda.synchronize()
    assert im2col_conv.launches > before
    assert out["drift"]["tune_trials_counted"] == sum(out["drift"]["trials"])
    assert all(row["measured_micro_per_s"] > 0 for row in out["splits"].values())


def test_co_serve_phase_on_the_card():
    """``chip_smoke.co_serve_online`` (phase 5d: SynthNet and ResNet50
    co-served on their measured oracles, elastic against static under a
    dropout and a revival, chaos, every installed split as a stream
    pipeline and both final splits as CUDA graphs alone and together, each
    equal to its sequential model) at small widths and a short horizon on
    the card, where its pipelines launch the conv."""
    import importlib.util
    from pathlib import Path

    from repro_torch.launch.serve_cnn import BATCH, N_MICRO, measure_cnn

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    plat = smoke.co_platform()
    tenants, oracles = {}, {}
    for net, (_, seed) in smoke.CO_TENANTS.items():
        m = measure_cnn(net, plat, device="cuda", in_shape=(16, 16, 8), seed=seed, scale=0.12)
        tenants[net] = (m.model, torch.randn((N_MICRO, BATCH, 16, 16, 8), generator=m.gen, device="cuda"))
        oracles[net] = m.evaluator
    before = im2col_conv.launches
    out = smoke.co_serve_online(tenants, oracles, horizon=20.0)
    torch.cuda.synchronize()
    assert im2col_conv.launches > before
    assert [e["kind"] for e in out["events"]] == ["dropout", "revival"]
    assert all(row["measured_micro_per_s"] > 0 for row in out["splits"].values())
    for row in out["together"].values():
        assert row["alone_issued_micro_per_s"] > 0 and row["alone_micro_per_s"] > 0
        assert row["together_micro_per_s"] > 0 and row["back_to_back_micro_per_s"] < row["alone_micro_per_s"]


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


def _attn(b, h, kvh, s, d, dtype, seed=0, bshd=False, skv=None):
    """q [b, h, s, d] (a transposed [b, s, h, d] view with ``bshd``); k, v
    [b, kvh, skv, d], ``skv`` defaulting to ``s``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    skv = skv or s
    q = torch.randn((b, s, h, d) if bshd else (b, h, s, d), generator=g, device="cuda").to(dtype)
    k = torch.randn((b, kvh, skv, d), generator=g, device="cuda").to(dtype)
    v = torch.randn((b, kvh, skv, d), generator=g, device="cuda").to(dtype)
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


#: a key length other than the query's (b, h, kvh, sq, skv, d, dtype, causal, window): whisper's cross
#: attention, then Sq of 1, 15, 448, 1500 against Skv of 1, 15, 65, 448, 1500, longer and shorter, causal
#: (top-left) with and without a window, D 64 and 128, GQA 1 and 8, in bf16 and fp32
FLASH_KV_CASES = [
    (4, 12, 12, 448, 1500, 64, torch.bfloat16, False, 0),  # whisper-small prefill cross attention
    (2, 8, 1, 1, 1500, 64, torch.bfloat16, False, 0),
    (2, 8, 8, 15, 65, 128, torch.bfloat16, True, 7),
    (2, 8, 1, 448, 65, 64, torch.bfloat16, False, 0),
    (2, 12, 12, 448, 1, 128, torch.bfloat16, False, 0),
    (1, 16, 2, 448, 1500, 128, torch.bfloat16, True, 0),
    (2, 4, 4, 65, 15, 64, torch.bfloat16, True, 64),
    (2, 8, 1, 1500, 448, 64, torch.bfloat16, True, 0),
    (1, 8, 8, 15, 1500, 64, torch.bfloat16, False, 0),
    (2, 4, 2, 20, 8, 32, torch.float32, True, 16),
    (2, 4, 4, 8, 20, 64, torch.float32, False, 0),
    (1, 8, 1, 100, 300, 128, torch.float32, True, 0),
    (2, 4, 2, 77, 33, 64, torch.float32, False, 50),
    (1, 12, 1, 1, 1500, 64, torch.float32, False, 0),
]


@pytest.mark.parametrize("b,h,kvh,sq,skv,d,dtype,causal,window", FLASH_KV_CASES)
def test_flash_attention_over_another_key_length_matches_plain(b, h, kvh, sq, skv, d, dtype, causal, window):
    q, k, v = _attn(b, h, kvh, sq, d, dtype, seed=sq + skv, bshd=True, skv=skv)
    y = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tuple(y.shape) == (b, h, sq, d) and y.stride() == q.stride()
    _agree(y, fa.flash_attention_plain(q, k, v, causal=causal, window=window), 2e-4, dtype == torch.float32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_row_that_sees_no_key_is_nan_as_plain(dtype):
    """Sq 100 against Skv 8 under a causal window of 5: rows 12 and on see no key."""
    q, k, v = _attn(1, 4, 2, 100, 64, dtype, skv=8)
    y = fa.flash_attention(q, k, v, causal=True, window=5)
    yp = fa.flash_attention_plain(q, k, v, causal=True, window=5)
    torch.cuda.synchronize()
    assert y[:, :, 12:].isnan().all() and yp[:, :, 12:].isnan().all() and not y[:, :, :12].isnan().any()
    _agree(y[:, :, :12], yp[:, :, :12], 2e-4, dtype == torch.float32)


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


def _device_kernel_names(fn) -> list[str]:
    """The device kernels ``fn`` runs, by the profiler's names.  The
    profiler on the card can keep none of a window's device records, so an
    empty window is taken again after a pause, up to 8 windows in all (as
    ``chip_smoke._device_ms`` does)."""
    import time

    from torch.profiler import ProfilerActivity, profile

    for _ in range(8):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
        time.sleep(0.1)
    return names


def test_flash_attention_runs_the_kernel_of_its_type():
    """bf16 on the tensor-core kernel, fp32 on the SIMT kernel, and never the other."""
    for dtype, want, other in ((torch.bfloat16, "flash_fwd_mma_bf16_kernel", "flash_fwd_kernel"),
                               (torch.float32, "flash_fwd_kernel", "flash_fwd_mma_bf16_kernel")):
        q, k, v = _attn(1, 4, 2, 128, 64, dtype)
        names = _device_kernel_names(lambda: fa.flash_attention(q, k, v))
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
    b, l, h, p, n, chunk = shape
    args = _ssd(b, l, h, p, n, dtype, strided=strided)
    ssd.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    names = _device_kernel_names(lambda: ssd.ssd_scan(*args, chunk=chunk))
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
    assert gm.route(a.dtype, m, 4104, n, gm._aligned(a) and gm._aligned(b)).kernel == gm.KERNELS.index(
        "gemm_wgmma_bf16_kernel<C, 0, 1, 0>")
    y = gm.gemm(a, b)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and y.is_contiguous() and tuple(y.shape) == (batch, m, n)
    torch.testing.assert_close(y.float(), gm.gemm_plain(a, b).float(), **GEMM_TOL[torch.bfloat16])


def test_gemm_wgmma_takes_layer_slices_of_the_expert_stacks():
    """Tensor maps over strided views: a layer slice of an [L, E, K, N] stack
    (a base offset per layer) and every other row of the capacity buffer."""
    a, w = _gemm_inputs((4, 200, 264), (3, 4, 264, 136), torch.bfloat16)
    a = a[:, ::2]  # 100 rows, row stride 528
    wgmma = gm.KERNELS.index("gemm_wgmma_bf16_kernel<C, 0, 1, 1>")  # K 264: the short schedule
    for layer in (1, 2):
        assert w[layer].storage_offset() > 0
        assert gm.route(a.dtype, 100, 264, 136, gm._aligned(a) and gm._aligned(w[layer])).kernel == wgmma
        y = ops.gemm(a, w[layer])
        torch.cuda.synchronize()
        torch.testing.assert_close(y.float(), gm.gemm_plain(a, w[layer]).float(), **GEMM_TOL[torch.bfloat16])


def _gemm_operand(shape, dtype, seed, transposed):
    """An operand of ``shape``: as stored, or the transposed view of one
    stored with its last two dims swapped (the backward's Bᵀ and Aᵀ)."""
    stored = (*shape[:-2], shape[-1], shape[-2]) if transposed else shape
    t = torch.randn(stored, generator=torch.Generator(device="cuda").manual_seed(seed), device="cuda").to(dtype)
    return t.transpose(-1, -2) if transposed else t


@pytest.mark.parametrize("ta,tb", [(False, True), (True, False), (True, True)])
@pytest.mark.parametrize("m", [8, 16, 17, 160, 320, 321])
@pytest.mark.parametrize("k,n", [(200, 264), (4104, 136)])  # K and N ragged against 64 and 128
def test_gemm_reads_transposed_views_as_its_route_says(m, k, n, ta, tb):
    """Each instantiation that reads a transposed operand in place (both
    schedules: K 200 short, 4104 long), at every capacity as M: the wgmma
    route copies nothing; M <= 16, and a transposed A whose M is not a
    multiple of 8 (its rows, stored [K, M], not 16-byte aligned), copy the
    transposed operands for the mma.sync tiles; two calls give the same
    bits."""
    a = _gemm_operand((3, m, k), torch.bfloat16, 0, ta)
    b = _gemm_operand((3, k, n), torch.bfloat16, 1, tb) / k**0.5
    r = gm.route(a.dtype, m, k, n, gm._aligned(a) and gm._aligned(b), *gm.majors(a, b))
    layout = {(False, True): "0, 0", (True, False): "1, 1", (True, True): "1, 0"}[ta, tb]
    on_wgmma = m > 16 and (not ta or m % 8 == 0)
    assert gm.KERNELS[r.kernel] == (f"gemm_wgmma_bf16_kernel<C, {layout}, {int(k <= gm.SHORT_K)}>" if on_wgmma
                                    else "gemm_mma_bf16_kernel<16, 128> 16-byte rows" if m <= 16
                                    else "gemm_mma_bf16_kernel<64, 256> masked")
    before = gm.copies
    y = gm.gemm(a, b)
    assert gm.copies - before == (0 if on_wgmma else ta + tb) == r.copy_a + r.copy_b
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and y.is_contiguous() and tuple(y.shape) == (3, m, n)
    torch.testing.assert_close(y.float(), gm.gemm_plain(a, b).float(), **GEMM_TOL[torch.bfloat16])
    assert torch.equal(y, gm.gemm(a, b))


@pytest.mark.parametrize("cap", [8, 16, 17, 160, 320, 321])
def test_gemm_gradient_at_every_capacity_with_a_layer_slice_of_the_stacked_weights(cap):
    """dA = dC·Bᵀ (capacity as M) and dB = Aᵀ·dC (capacity as K) through
    ``ops.gemm``'s backward, B a layer slice of an [E, L, K, N] stack (batch
    stride L·K·N, not K·N) and A every other row of a capacity buffer: each
    product copies only where its route says, agrees with the plain
    version and gives the same bits twice."""
    a = torch.randn((4, 2 * cap, 264), device="cuda").to(torch.bfloat16)[:, ::2].requires_grad_()
    stack = (torch.randn((4, 3, 264, 200), device="cuda") / 264**0.5).to(torch.bfloat16)
    w = stack[:, 1].requires_grad_()
    assert w.stride(0) == 3 * 264 * 200 and w.storage_offset() > 0
    dc = torch.randn((4, cap, 200), device="cuda").to(torch.bfloat16)
    c = ops.gemm(a, w)
    routes = [gm.route(torch.bfloat16, x.shape[-2], x.shape[-1], y.shape[-1], gm._aligned(x) and gm._aligned(y),
                       *gm.majors(x, y)) for x, y in ((dc, w.transpose(1, 2)), (a.transpose(1, 2), dc))]
    before = gm.copies, gm.bwd_launches
    da, dw = torch.autograd.grad(c, (a, w), dc, retain_graph=True)
    assert gm.copies - before[0] == sum(r.copy_a + r.copy_b for r in routes)
    assert gm.bwd_launches == before[1] + 2
    assert (routes[0].kernel == gm.KERNELS.index("gemm_wgmma_bf16_kernel<C, 0, 0, 1>")) == (cap > 16)
    assert (routes[1].kernel == gm.KERNELS.index("gemm_wgmma_bf16_kernel<C, 1, 1, 1>")) == (cap % 8 == 0)
    torch.testing.assert_close(da, gm.gemm_plain(dc, w.detach().transpose(1, 2)), **GEMM_TOL[torch.bfloat16])
    torch.testing.assert_close(dw, gm.gemm_plain(a.detach().transpose(1, 2), dc), **GEMM_TOL[torch.bfloat16])
    again = torch.autograd.grad(c, (a, w), dc)
    assert torch.equal(da, again[0]) and torch.equal(dw, again[1])


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
    a, b = _gemm_inputs(sa, sb, torch.bfloat16)
    if view == "unaligned":  # rows start 6 bytes past a 16-byte boundary
        a = torch.cat([a, a[..., :8]], -1)[..., 3 : 3 + sa[-1]]
    y = gm.gemm(a, b)  # warm: the profiler below sees steady launches
    torch.cuda.synchronize()
    names = _device_kernel_names(lambda: [gm.gemm(a, b) for _ in range(3)])
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
        (lambda a, b: (a[:, :, ::2], b[:, ::2]), ValueError),  # unit stride over neither of a's last two dims
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
                                       ("nemotron-4-340b", {"head_dim": 192}),  # nemotron's head dim, GQA group 2
                                       ("whisper-small", {}),
                                       ("whisper-small", {"max_decoder_len": 20, "enc_frames": 24}),  # wraps; Sq != Skv
                                       ("internvl2-76b", {})])
def test_smoke_lm_path_on_the_card_matches_the_cpu(arch, over):
    cfg = dataclasses.replace(get_smoke(arch), dtype=torch.float32, **over)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    on_card = {k: ({kk: vv.cuda() for kk, vv in v.items()} if isinstance(v, dict) else v.cuda()) for k, v in params.items()}
    inputs = make_batch(cfg, 2, 24, 0, "cpu")  # with whisper's frames or internvl's patches
    toks = inputs["tokens"]
    logits = {}
    for dev, p in (("cpu", params), ("cuda", on_card)):
        before = fa.launches + ssd.launches + gm.launches
        with torch.inference_mode():
            prompt = {k: (t[:, :16] if k == "tokens" else t).to(dev) for k, t in inputs.items()}
            lg, cache = transformer.prefill_step(cfg, p, prompt, max_len=24)
            out = [lg]
            for t in range(16, 24):
                lg, cache = transformer.serve_step(cfg, p, cache, toks[:, t : t + 1].to(dev))
                out.append(lg)
        logits[dev] = torch.stack(out, 1).cpu()
        assert (fa.launches + ssd.launches + gm.launches - before > 0) == (dev == "cuda")
    scale = float(logits["cpu"].abs().max())
    torch.testing.assert_close(logits["cuda"], logits["cpu"], rtol=3e-4, atol=3e-4 * scale)


def test_serve_on_the_card_runs_the_smoke_models():
    for arch in ("granite-3-2b", "mamba2-130m", "phi3.5-moe-42b", "llama4-scout-17b", "zamba2-2.7b", "whisper-small",
                 "internvl2-76b"):
        out = serve(get_smoke(arch), batch=2, prompt_len=16, gen=4, device="cuda")
        assert tuple(out["tokens"].shape) == (2, 4) and out["tokens"].is_cuda


# ---------------------------------------------------------------------------
# Training: the flash backward, the gemm gradient, the guards, a smoke step
# ---------------------------------------------------------------------------

FLASH_BWD_CASES = (
    [(2, 8, 2, 130, None, d, dt, True, 0) for d in fa.HEAD_DIMS for dt in (torch.float32, torch.bfloat16)]
    + [
        (1, 10, 2, 65, None, 64, torch.bfloat16, False, 7),
        (2, 4, 4, 200, None, 128, torch.float32, True, 7),
        (2, 8, 1, 15, 70, 64, torch.bfloat16, False, 0),  # Skv != Sq, both ways
        (2, 8, 8, 70, 15, 32, torch.float32, True, 0),
        (1, 24, 2, 100, None, 192, torch.bfloat16, True, 0),  # GQA group 12
        (4, 32, 8, 512, None, 64, torch.bfloat16, True, 0),  # granite-3-2b's training shape
        (4, 32, 8, 512, None, 128, torch.bfloat16, True, 0),  # phi3.5-moe's
        (4, 32, 32, 512, None, 80, torch.bfloat16, True, 0),  # zamba2-2.7b's shared block
        (2, 10, 2, 100, 400, 128, torch.bfloat16, True, 32),  # key tiles past Sq: clusters that see no query
    ]
    # GQA groups 5, 7 and 12: clusters of 5, 7 and 6 blocks on the wgmma route
    + [(1, h, 2, 130, None, d, torch.bfloat16, True, 0) for d in (64, 128) for h in (10, 14, 24)]
)


def _rel_err(got, want):
    scale = want.float().abs().max().item()
    return (got.float() - want.float()).abs().max().item() / scale


@pytest.mark.parametrize("b,h,kvh,s,skv,d,dtype,causal,window", FLASH_BWD_CASES)
def test_flash_backward_matches_plain_and_gives_the_same_bits_twice(b, h, kvh, s, skv, d, dtype, causal, window):
    q, k, v = _attn(b, h, kvh, s, d, dtype, bshd=True, skv=skv)
    do = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(1), device="cuda").to(dtype)
    kw = dict(causal=causal, window=window)
    o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    want_route = "simt" if dtype == torch.float32 else "wgmma" if d in fa.WGMMA_HEAD_DIMS else "mma"
    assert fa.bwd_route(q, k, v, o, do) == want_route
    before = fa.bwd_launches
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert fa.bwd_launches == before + 1
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == dtype and g.stride() == t.stride()
        assert _rel_err(g, w) <= (2e-4 if dtype == torch.float32 else 1e-2)
    assert all(torch.equal(x, y) for x, y in zip(got, fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)))
    torch.testing.assert_close(lse, fa.flash_attention_fwd_plain(q, k, v, **kw)[1], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("d", [64, 128])
def test_flash_backward_on_rows_only_8_byte_aligned_takes_the_mma_route(d):
    """Rows of d + 4 elements: strides the kernels' 8-byte copies read, but
    not TMA, so the bf16 backward runs the mma.sync kernels."""
    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v, do = (torch.randn((2, 130, h, d + 4), generator=g, device="cuda").to(torch.bfloat16)[..., :d]
                   .transpose(1, 2) for h in (8, 2, 2, 8))
    o, lse = fa.flash_attention(q, k, v, return_lse=True)
    assert fa.bwd_route(q, k, v, o, do) == "mma"
    got = fa.flash_attention_bwd(q, k, v, o, lse, do)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    assert all(_rel_err(g_, w) <= 1e-2 for g_, w in zip(got, want))
    assert all(torch.equal(x, y) for x, y in zip(got, fa.flash_attention_bwd(q, k, v, o, lse, do)))


def test_ops_flash_attention_trains_through_the_kernels():
    q, k, v = (t.requires_grad_() for t in _attn(2, 8, 2, 64, 64, torch.bfloat16, bshd=True))
    do = torch.randn(q.shape, device="cuda").to(torch.bfloat16)
    before = fa.launches, fa.bwd_launches
    got = torch.autograd.grad(ops.flash_attention(q, k, v), (q, k, v), do)
    assert (fa.launches, fa.bwd_launches) == (before[0] + 1, before[1] + 1)
    want = torch.autograd.grad(fa.flash_attention_plain(q, k, v), (q, k, v), do)
    assert all(_rel_err(g, w) <= 1e-2 for g, w in zip(got, want))
    with torch.no_grad():
        assert ops.flash_attention(q, k, v).grad_fn is None
    assert fa.bwd_launches == before[1] + 1


def test_flash_backward_refuses_rows_that_see_no_key():
    q, k, v = _attn(1, 2, 1, 20, 64, torch.bfloat16, skv=8)
    o, lse = fa.flash_attention(q, k, v, window=5, return_lse=True)
    with pytest.raises(ValueError, match="see no key"):
        fa.flash_attention_bwd(q, k, v, o, lse, torch.ones_like(q), window=5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_gradient_runs_the_kernel_twice_and_matches_plain(dtype):
    a, b = _gemm_inputs((3, 40, 64), (3, 64, 48), dtype)
    a.requires_grad_()
    b.requires_grad_()
    dc = torch.randn((3, 40, 48), device="cuda").to(dtype)
    c = ops.gemm(a, b)
    before = gm.launches, gm.bwd_launches, gm.copies
    da, db = torch.autograd.grad(c, (a, b), dc)
    assert (gm.launches, gm.bwd_launches) == (before[0] + 2, before[1] + 2)
    # bf16 reads Bᵀ and Aᵀ in place on wgmma; fp32's FMA kernel reads one layout, so both are copied
    assert gm.copies == before[2] + (2 if dtype == torch.float32 else 0)
    torch.testing.assert_close(da, gm.gemm_plain(dc, b.detach().transpose(1, 2)), **GEMM_TOL[dtype])
    torch.testing.assert_close(db, gm.gemm_plain(a.detach().transpose(1, 2), dc), **GEMM_TOL[dtype])


def test_ssd_scan_and_conv_raise_under_autograd_on_the_card():
    """Only the conv raises under autograd on the card now: the SSD scan runs
    its forward kernel and its backward kernel, and a smoke mamba2 trains."""
    x, dt, A, B, C = _ssd(1, 32, 2, 16, 8, torch.float32)
    before = ssd.launches, ssd.bwd_launches
    y, _ = ops.ssd_scan(x.requires_grad_(), dt, A, B, C, chunk=8)
    y.sum().backward()
    assert (ssd.launches, ssd.bwd_launches) == (before[0] + 1, before[1] + 1) and torch.isfinite(x.grad).all()
    with torch.no_grad():
        assert ops.ssd_scan(x, dt, A, B, C, chunk=8)[0].shape == x.shape
    xc, wc = _inputs((1, 8, 8, 4), (3, 3, 4, 8))
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        ops.conv2d_im2col(xc, wc.requires_grad_())
    losses = train(get_smoke("mamba2-130m"), steps=2, batch=2, seq=16, log_every=0, device="cuda")["losses"]
    assert len(losses) == 2 and all(np.isfinite(losses))


SSD_BWD_CASES = [
    (4, 512, 24, 64, 128, 64, torch.bfloat16, True, False),  # mamba2-130m's training shape
    (4, 512, 80, 64, 64, 64, torch.bfloat16, True, False),  # zamba2-2.7b's
    (4, 512, 24, 64, 128, 64, torch.float32, False, True),
    (2, 128, 3, 100, 32, 64, torch.float32, False, True),  # a ragged p tile
    (2, 64, 4, 16, 16, 8, torch.bfloat16, True, True),  # the smoke configs' chunk 8
    (2, 128, 2, 16, 8, 16, torch.float32, True, False),
    (3, 96, 5, 48, 64, 32, torch.bfloat16, False, True),
]


@pytest.mark.parametrize("b,l,h,p,n,chunk,dtype,strided,with_state", SSD_BWD_CASES)
def test_ssd_backward_matches_plain_and_gives_the_same_bits_twice(b, l, h, p, n, chunk, dtype, strided, with_state):
    x, dt, A, B, C = _ssd(b, l, h, p, n, dtype, strided=strided)
    g = torch.Generator(device="cuda").manual_seed(3)
    dy = torch.randn(x.shape, generator=g, device="cuda").to(dtype)
    dstate = torch.randn((b, h, p, n), generator=g, device="cuda") if with_state else None
    before = ssd.bwd_launches
    got = ssd.ssd_scan_bwd(x, dt, A, B, C, dy, dstate, chunk=chunk)
    again = ssd.ssd_scan_bwd(x, dt, A, B, C, dy, dstate, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.bwd_launches == before + 2
    want = ssd.ssd_scan_bwd_plain(x, dt, A, B, C, dy, dstate, chunk=chunk)
    assert [t.dtype for t in got] == [dtype, torch.float32, torch.float32, dtype, dtype]
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for gt, w in zip(got, want):
        _agree(gt, w, 2e-3, dtype == torch.float32 or gt.dtype == torch.float32)


SSD_TRAIN_SHAPES = [(4, 512, 24, 64, 128), (4, 512, 80, 64, 64)]  # mamba2-130m's, zamba2-2.7b's


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("b,l,h,p,n", SSD_TRAIN_SHAPES)
def test_ssd_backward_mma_kernels_each_match_their_plain_versions(b, l, h, p, n, with_state):
    """The ``"mma"`` route at the training shapes (bf16, B and C strided as
    ``ssd_block`` passes them), kernel by kernel: the states kernel's H_in
    and dH_out against ``bwd_states_plain``; the chunk kernel's dx, ddt and
    parts against ``bwd_chunk_plain`` on the kernel's own states; the sum
    against ``bwd_sum_plain`` on the kernel's own parts (the same bits:
    the same fp32 adds in the same order, then one rounding); the whole
    against ``ssd_scan_bwd_plain``."""
    x, dt, A, B, C = _ssd(b, l, h, p, n, torch.bfloat16, strided=True)
    g = torch.Generator(device="cuda").manual_seed(4)
    dy = torch.randn(x.shape, generator=g, device="cuda").to(torch.bfloat16)
    dstate = torch.randn((b, h, p, n), generator=g, device="cuda") if with_state else None
    assert ssd.bwd_route(torch.bfloat16, p, n, 64, all(ssd._aligned(t) for t in (x, B, C, dy))) == "mma"
    parts = {}
    got = ssd.run_bwd_route(x, dt, A, B, C, dy, dstate, chunk=64, route="mma", parts=parts)
    torch.cuda.synchronize()
    h_in, dh_out = ssd.bwd_states_plain(x, dt, A, B, C, dy, dstate, chunk=64)
    _agree(parts["h_in"][:, :, 1:], h_in[:, :, 1:], 1e-4, True)
    _agree(parts["dh_out"][:, :, :-1], dh_out[:, :, :-1], 1e-4, True)
    h_k, dh_k = parts["h_in"].clone(), parts["dh_out"].clone()
    h_k[:, :, 0], dh_k[:, :, -1] = 0.0, (0.0 if dstate is None else dstate)
    dx, ddt, pdA, pdB, pdC = ssd.bwd_chunk_plain(x, dt, A, B, C, dy, h_k, dh_k, chunk=64,
                                                 head_group=ssd.bwd_head_group(b, l, h))
    _agree(got[0], dx, None, False)
    for kern, plain in ((got[1], ddt), (parts["pdA"], pdA), (parts["pdB"], pdB), (parts["pdC"], pdC)):
        assert _rel_err(kern, plain) <= 1e-4
    dB, dC, dA = ssd.bwd_sum_plain(parts["pdB"], parts["pdC"], parts["pdA"], torch.bfloat16)
    assert torch.equal(got[3], dB) and torch.equal(got[4], dC) and torch.equal(got[2], dA)
    for gt, w in zip(got, ssd.ssd_scan_bwd_plain(x, dt, A, B, C, dy, dstate, chunk=64)):
        assert _rel_err(gt, w) <= BF16_REL


@pytest.mark.parametrize("b,l,h,p,n", SSD_TRAIN_SHAPES)
def test_ssd_backward_mma_gives_the_same_bits_twice_and_on_two_streams(b, l, h, p, n):
    args = [(*_ssd(b, l, h, p, n, torch.bfloat16, seed=s, strided=True),
             torch.randn((b, l, h, p), generator=torch.Generator(device="cuda").manual_seed(s), device="cuda")
             .to(torch.bfloat16)) for s in (1, 2)]
    seq = [ssd.ssd_scan_bwd(*a, chunk=64) for a in args]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    for st, a in zip(streams, args):
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            outs.append([ssd.ssd_scan_bwd(*a, chunk=64) for _ in range(3)])
    torch.cuda.synchronize()
    for want, got in zip(seq, outs):
        for grads in got:
            assert all(torch.equal(u, v) for u, v in zip(grads, want))


@pytest.mark.parametrize("b,l,h,p,n,chunk,dtype", [
    (4, 512, 24, 64, 128, 64, torch.bfloat16), (4, 512, 80, 64, 64, 64, torch.bfloat16),  # the training shapes
    (4, 512, 24, 64, 128, 64, torch.float32), (2, 64, 4, 16, 16, 8, torch.bfloat16),
])
def test_ssd_backward_runs_exactly_the_kernels_of_its_route(b, l, h, p, n, chunk, dtype):
    """A profiled backward runs :func:`bwd_kernels` of :func:`bwd_route`'s route and nothing else."""
    import re

    x, dt, A, B, C = _ssd(b, l, h, p, n, dtype, strided=True)
    dy = torch.randn(x.shape, device="cuda").to(dtype)
    route = ssd.bwd_route(dtype, p, n, chunk, all(ssd._aligned(t) for t in (x, B, C, dy)))
    assert route == ("mma" if dtype == torch.bfloat16 and chunk == 64 else "simt")
    ssd.ssd_scan_bwd(x, dt, A, B, C, dy, chunk=chunk)
    torch.cuda.synchronize()
    names = _device_kernel_names(lambda: ssd.ssd_scan_bwd(x, dt, A, B, C, dy, chunk=chunk))
    ran = [m.group(1) if (m := re.search(r"(ssd_scan_bwd\w*_kernel<[^>]*>)", k)) else k for k in names]
    assert sorted(ran) == sorted(ssd.bwd_kernels(route, dtype, n))


@pytest.mark.parametrize("use_state", [False, True])
def test_ssd_scan_gradient_runs_both_kernels_and_matches_the_plain_path(use_state):
    x, dt, A, B, C = _ssd(2, 128, 4, 64, 64, torch.bfloat16, strided=True)
    ins = [t.detach().clone().requires_grad_() for t in (x, dt, A, B, C)]
    dy = torch.randn(x.shape, device="cuda").to(torch.bfloat16)
    before = ssd.launches, ssd.bwd_launches
    y, state = ops.ssd_scan(*ins, chunk=64)
    loss = (y.float() * dy.float()).sum() + (state.sum() if use_state else 0.0)
    got = torch.autograd.grad(loss, ins)
    assert (ssd.launches, ssd.bwd_launches) == (before[0] + 1, before[1] + 1)
    want = ssd.ssd_scan_bwd_plain(x, dt, A, B, C, dy, torch.ones_like(state) if use_state else None, chunk=64)
    assert all(_rel_err(gt, w) <= 1e-2 for gt, w in zip(got, want))


@pytest.mark.parametrize("arch", ["granite-3-2b", "phi3.5-moe-42b", "whisper-small", "internvl2-76b",
                                  "mamba2-130m", "zamba2-2.7b"])
def test_smoke_train_step_on_the_card_matches_the_cpu(arch):
    """One ``make_train_step`` (AdamW, fp32 moments) in fp32 on each device,
    the same weights and batch: the losses within LM_TOL's fp32 1e-3."""
    cfg = dataclasses.replace(get_smoke(arch), dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = next(make_batch_iterator(cfg, DataConfig(batch=2, seq=16, vocab=cfg.vocab), device="cpu"))
    out = {}
    for dev in ("cpu", "cuda"):
        p = {k: ({kk: vv.to(dev, copy=True) for kk, vv in v.items()} if isinstance(v, dict) else v.to(dev, copy=True))
             for k, v in params.items()}
        opt = AdamW(AdamWConfig(moment_dtype=torch.float32, total_steps=4, warmup=1))
        before = fa.bwd_launches, ssd.bwd_launches
        _, _, m = transformer.make_train_step(cfg, opt)(p, opt.init(p), {k: v.to(dev) for k, v in batch.items()})
        out[dev] = float(m["loss"])
        attn, scan = cfg.block_kind != "ssd", cfg.block_kind != "attn"
        assert (fa.bwd_launches > before[0]) == (dev == "cuda" and attn)
        assert (ssd.bwd_launches > before[1]) == (dev == "cuda" and scan)
    assert abs(out["cuda"] - out["cpu"]) <= 1e-3 * abs(out["cpu"])
