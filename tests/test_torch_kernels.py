"""The port's conv kernel module against the JAX package's (CPU), the
conv's plan (tile, copies, splits of the reduction), the kernel build, and
the batched GEMM's choice of kernel.

Inputs come from numpy with a seed and go to both packages.  The plain
PyTorch version (what a CPU tensor runs) is held against the Pallas kernel in
interpret mode and against ``lax.conv``, at the reference's tolerance 3e-4.
The CUDA kernels themselves run only on the card: ``tests/test_torch_gpu.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # CI installs requirements-dev.txt, which has no torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build, im2col_conv, ops

TOL = dict(rtol=3e-4, atol=3e-4)

CASES = [((2, 12, 12, 8), (r, r, 8, 24), st) for r in (1, 3, 5) for st in (1, 2)] + [
    ((2, 20, 20, 8), (11, 11, 8, 16), 4),  # AlexNet's conv1 geometry: asymmetric SAME pad
    ((2, 23, 21, 6), (11, 11, 6, 17), 4),  # same, ragged K and non-square input
    ((3, 13, 11, 5), (3, 3, 5, 17), 1),  # ragged K, M and C
]


def _inputs(xs, ws, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(xs, dtype=np.float32)
    w = rng.standard_normal(ws, dtype=np.float32) / np.float32(np.sqrt(np.prod(ws[:3])))
    return x, w


@pytest.mark.parametrize("xs,ws,stride", CASES)
def test_plain_matches_pallas_and_oracle(xs, ws, stride):
    x, w = _inputs(xs, ws)
    y = im2col_conv.conv2d_im2col_plain(torch.from_numpy(x), torch.from_numpy(w), stride=stride).numpy()
    y_pallas = np.asarray(jops.conv2d_im2col(jnp.asarray(x), jnp.asarray(w), stride=stride, bk=16))
    y_ref = np.asarray(jref.conv2d_ref(jnp.asarray(x), jnp.asarray(w), stride=stride))
    assert y.shape == y_ref.shape
    np.testing.assert_allclose(y, y_pallas, **TOL)
    np.testing.assert_allclose(y, y_ref, **TOL)


@pytest.mark.parametrize(
    "h,r,stride,expect",
    [
        (220, 11, 4, (55, 55, 3, 4, 3, 4)),  # SynthNet conv1: 3 rows before, 4 after
        (12, 3, 1, (12, 12, 1, 1, 1, 1)),
        (12, 1, 2, (6, 6, 0, 0, 0, 0)),
        (12, 5, 2, (6, 6, 1, 2, 1, 2)),
    ],
)
def test_same_padding_is_the_references(h, r, stride, expect):
    assert im2col_conv.same_padding(h, h, r, r, stride) == expect


def test_ops_runs_cpu_tensors_on_the_plain_version_without_counting():
    x, w = _inputs((2, 12, 12, 8), (3, 3, 8, 24))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    before = im2col_conv.launches
    y = ops.conv2d_im2col(xt, wt, stride=2)
    assert im2col_conv.launches == before
    assert torch.equal(y, im2col_conv.conv2d_im2col_plain(xt, wt, stride=2))


def test_cuda_wrapper_refuses_cpu_tensors():
    x, w = _inputs((2, 12, 12, 8), (3, 3, 8, 24))
    before = im2col_conv.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        im2col_conv.conv2d_im2col(torch.from_numpy(x), torch.from_numpy(w))
    assert im2col_conv.launches == before


def test_plain_rejects_channel_mismatch():
    with pytest.raises(ValueError, match="channel mismatch"):
        im2col_conv.conv2d_im2col_plain(torch.zeros(1, 4, 4, 3), torch.zeros(3, 3, 4, 8))


def test_build_targets_sm90a_from_repo_sources(monkeypatch):
    import torch.utils.cpp_extension as cpp

    assert build.sources() == ["conv2d_im2col", "flash_attention", "gemm", "ssd_scan"]
    monkeypatch.setattr(cpp, "CUDA_HOME", "/toolkit")
    out = build.library_path("conv2d_im2col")
    cmd = build.nvcc_command("conv2d_im2col", out)
    assert cmd[0] == "/toolkit/bin/nvcc"
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    for flag in ("-O3", "-shared", "-fPIC", "-std=c++17"):
        assert flag in cmd
    assert cmd[-1] == str(build.CSRC / "conv2d_im2col.cu")
    assert out.parent == build.BUILD_DIR and out.parent.parts[-2:] == ("build", "kernels")
    assert out.name.startswith("conv2d_im2col-") and out.suffix == ".so"


def test_build_digest_covers_the_shared_headers(monkeypatch, tmp_path):
    """An edit to any csrc/*.cuh header names a new library, never a stale one."""
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text("// a\n")
    (tmp_path / "b.cuh").write_text("// b\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build.library_path("k")
    assert build.library_path("k") == first
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    second = build.library_path("k")
    assert second != first and second.name.startswith("k-")
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n// edited\n')
    assert build.library_path("k") not in (first, second)


def test_build_without_a_toolkit_raises(monkeypatch):
    import torch.utils.cpp_extension as cpp

    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="no CUDA toolkit"):
        build.nvcc_command("conv2d_im2col", build.library_path("conv2d_im2col"))


# ---------------------------------------------------------------------------
# The batched GEMM's choice of kernel (shape, type and alignment alone)
# ---------------------------------------------------------------------------

from repro_torch.kernels import gemm as gm  # noqa: E402

WGMMA, WGMMA_SHORT, DECODE, MMA16_MASKED, MMA64_MASKED, FMA = (gm.KERNELS.index(n) for n in (
    "gemm_wgmma_bf16_kernel<C, 0, 1, 0>", "gemm_wgmma_bf16_kernel<C, 0, 1, 1>",
    "gemm_decode_bf16_kernel<MT>", "gemm_mma_bf16_kernel<16, 128> masked",
    "gemm_mma_bf16_kernel<64, 256> masked", "gemm_fma_f32_kernel"))
#: the long-schedule wgmma instantiation of each transposed layout; the short one follows it in KERNELS
WGMMA_KK, WGMMA_NN, WGMMA_NK = (gm.KERNELS.index(f"gemm_wgmma_bf16_kernel<C, {t}, 0>") for t in ("0, 0", "1, 1", "1, 0"))
K, MN = gm.K_MAJOR, gm.MN_MAJOR


@pytest.mark.parametrize(
    "dtype,m,k,n,aligned,want",
    [
        (torch.bfloat16, 320, 4096, 6400, True, WGMMA),  # phi3.5-moe prefill gate/up
        (torch.bfloat16, 320, 6400, 4096, True, WGMMA),  # ... down
        (torch.bfloat16, 160, 5120, 8192, True, WGMMA),  # llama4-scout prefill
        (torch.bfloat16, 17, 4104, 6408, True, WGMMA),  # the first M past decode's tile, ragged K and N
        (torch.bfloat16, 321, 8, 8, True, WGMMA_SHORT),  # a reduction of one stage: the short schedule
        (torch.bfloat16, 4096, 1024, 6400, True, WGMMA_SHORT),
        (torch.bfloat16, 4096, 1032, 6400, True, WGMMA),
        (torch.bfloat16, 16, 4096, 6400, True, DECODE),  # decode with TMA rows: the equal-share split
        (torch.bfloat16, 8, 6400, 4096, True, DECODE),
        (torch.bfloat16, 8, 65, 17, True, MMA16_MASKED),
        (torch.bfloat16, 8, 64, 64, False, MMA16_MASKED),
        (torch.bfloat16, 320, 4100, 6400, True, MMA64_MASKED),  # K not a multiple of 8: no TMA
        (torch.bfloat16, 320, 4096, 6404, True, MMA64_MASKED),  # N not a multiple of 8
        (torch.bfloat16, 320, 4096, 6400, False, MMA64_MASKED),  # a row not 16-byte aligned
        (torch.float32, 320, 4096, 6400, True, FMA),  # fp32 never leaves the FMA pipes
        (torch.float32, 8, 64, 64, False, FMA),
    ],
)
def test_gemm_route_is_picked_by_shape_type_and_alignment(dtype, m, k, n, aligned, want):
    """Operands as the forward stores them (A K-major, B MN-major): nothing is copied."""
    assert gm.route(dtype, m, k, n, aligned) == (want, False, False)
    assert gm.route(dtype, m, k, n, aligned, K, MN) == gm.route(dtype, m, k, n, aligned)  # deterministic


#: every (type, M, alignment) case of a transposed operand: (dtype, m, k, n, aligned) -> the kernel that reads
#: A K-major and B MN-major only (its operands copied there), or None where a wgmma instantiation reads them
ROUTE_CASES = [
    (torch.bfloat16, 320, 6400, 4096, True, None),  # phi3.5-moe training dA (B K-major)
    (torch.bfloat16, 4096, 320, 6400, True, None),  # ... dB (A MN-major)
    (torch.bfloat16, 17, 64, 128, True, None),
    (torch.bfloat16, 16, 320, 6400, True, DECODE),  # M <= 16: copied
    (torch.bfloat16, 8, 320, 6400, True, DECODE),
    (torch.bfloat16, 8, 321, 6400, True, MMA16_MASKED),
    (torch.bfloat16, 8, 320, 6400, False, MMA16_MASKED),
    (torch.bfloat16, 4096, 321, 6400, True, MMA64_MASKED),  # a capacity not a multiple of 8 as dB's K
    (torch.bfloat16, 4096, 320, 6404, True, MMA64_MASKED),
    (torch.bfloat16, 4096, 320, 6400, False, MMA64_MASKED),  # unaligned rows: copied
    (torch.float32, 4096, 320, 6400, True, FMA),  # fp32: copied
    (torch.float32, 8, 320, 6400, False, FMA),
]


@pytest.mark.parametrize("a_major,b_major,wgmma", [(K, K, WGMMA_KK), (MN, MN, WGMMA_NN), (MN, K, WGMMA_NK)])
@pytest.mark.parametrize("dtype,m,k,n,aligned,kernel", ROUTE_CASES)
def test_gemm_route_reads_transposed_views_in_place_and_copies_them_only_off_wgmma(
        dtype, m, k, n, aligned, kernel, a_major, b_major, wgmma):
    got = gm.route(dtype, m, k, n, aligned, a_major, b_major)
    if kernel is None:  # the instantiation of these majors, its schedule by K; no copy
        assert got == (wgmma + (k <= gm.SHORT_K), False, False)
    else:
        assert got == (kernel, a_major == MN, b_major == K)  # the one layout the kernel reads: A K-, B MN-major


def test_gemm_route_lists_each_kernel_once_and_refuses_other_types():
    assert len(set(gm.KERNELS)) == len(gm.KERNELS) == 12
    assert {gm.route(dt, m, k, 64, al, am, bm).kernel for dt in (torch.float32, torch.bfloat16) for m in (8, 64)
            for k in (64, 4096) for al in (True, False) for am in (K, MN) for bm in (K, MN)} \
        == set(range(len(gm.KERNELS)))
    with pytest.raises(TypeError):
        gm.route(torch.float16, 64, 64, 64, True)
    with pytest.raises(ValueError):
        gm.route(torch.bfloat16, 64, 64, 64, True, "M", MN)


def test_gemm_alignment_reads_every_row_start():
    x = torch.zeros((3, 40, 72), dtype=torch.bfloat16)
    assert gm._aligned(x) and gm._aligned(x[1]) and gm._aligned(x[:, ::2])
    assert not gm._aligned(x[:, :, 3:67])  # row starts 6 bytes past 16-byte boundaries
    assert not gm._aligned(torch.zeros((4, 36), dtype=torch.bfloat16)[:, :32])  # row stride 72 bytes
    # a transposed view: its rows are the stored tensor's columns
    assert gm._aligned(x.transpose(1, 2)) and gm._aligned(x[1].T) and gm._aligned(x[:, ::2].transpose(1, 2))
    assert not gm._aligned(torch.zeros((4, 36), dtype=torch.bfloat16)[:, :32].T)
    assert not gm._aligned(x[:, :, 4:68].transpose(1, 2))  # columns start 8 bytes past 16-byte boundaries


@pytest.mark.parametrize(
    "a,b,want",
    [
        (lambda: torch.zeros(3, 40, 64), lambda: torch.zeros(3, 64, 48), (K, MN)),  # the forward, as stored
        (lambda: torch.zeros(3, 40, 48), lambda: torch.zeros(3, 64, 48).transpose(1, 2), (K, K)),  # dC·Bᵀ
        (lambda: torch.zeros(3, 40, 64).transpose(1, 2), lambda: torch.zeros(3, 40, 48), (MN, MN)),  # Aᵀ·dC
        (lambda: torch.zeros(40, 64).T, lambda: torch.zeros(48, 40).T, (MN, K)),
        (lambda: torch.zeros(4, 2, 64, 48)[:, 1], lambda: torch.zeros(4, 2, 48, 32)[:, 0], (K, MN)),  # layer slices
        (lambda: torch.zeros(8, 1), lambda: torch.zeros(1, 8), (K, MN)),  # a dim of one counts as unit
    ],
)
def test_gemm_majors_name_the_unit_stride_dim(a, b, want):
    assert gm.majors(a(), b()) == want


def test_gemm_majors_refuse_operands_with_no_unit_stride_in_their_last_two_dims():
    a = torch.zeros(3, 40, 64)
    with pytest.raises(ValueError, match="unit stride"):
        gm.majors(a[:, :, ::2], torch.zeros(3, 32, 8))
    with pytest.raises(ValueError, match="unit stride"):
        gm.majors(a, torch.zeros(3, 64, 96)[:, :, ::2].expand(3, 64, 48))


# ---------------------------------------------------------------------------
# The conv's plan (tile, copies, splits): a pure function of shape and SM count
# ---------------------------------------------------------------------------

from repro_torch.models.cnn import NETWORKS  # noqa: E402

H100 = im2col_conv.H100_SMS
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
#: SynthNet's six shapes and the plan each gets on 132 SMs: (tile, splits, blocks)
SYNTHNET = {
    ((2, 220, 220, 3), (11, 11, 3, 96), 4): ((128, 96), 5, 240),
    ((2, 27, 27, 96), (5, 5, 96, 256), 1): ((128, 128), 11, 264),
    ((2, 13, 13, 256), (3, 3, 256, 384), 1): ((128, 96), 11, 132),
    ((2, 13, 13, 384), (3, 3, 384, 384), 1): ((128, 96), 11, 132),
    ((2, 13, 13, 384), (3, 3, 384, 256), 1): ((128, 64), 11, 132),
    ((2, 220, 220, 256), (11, 11, 256, 96), 4): ((128, 96), 11, 528),
}


def _ranges(p):
    return [p.split_range(z) for z in range(p.splits)]


def test_synthnet_shapes_are_the_networks():
    specs = NETWORKS["synthnet"]()
    assert {((2, sp.h_out * sp.stride, sp.h_out * sp.stride, sp.c_in), (sp.r, sp.s, sp.c_in, sp.k), sp.stride)
            for sp in specs} == set(SYNTHNET)


@pytest.mark.parametrize("xs,ws,stride", SMALL + PAPER)
def test_every_shape_gets_a_plan_the_kernel_has(xs, ws, stride):
    p = im2col_conv.plan(xs, ws, stride, sms=H100)
    n, h, wd, c = xs
    r, s, _, k = ws
    ho, wo = -(-h // stride), -(-wd // stride)
    assert (p.m, p.k, p.kr) == (n * ho * wo, k, r * s * c)
    assert (p.bm, p.bn) in im2col_conv.TILES and (p.tm, p.tn) == (p.bm // 16, p.bn // 16)
    assert 1 <= p.splits <= min(im2col_conv.MAX_SPLITS, p.slices)
    assert p.splits == 1 or p.slices // p.splits >= im2col_conv.MIN_SLICES
    assert p.vector == (c % 4 == 0 and k % 4 == 0)
    assert p.grid == (-(-p.m // p.bm), -(-k // p.bn), p.splits) and p.blocks == p.grid[0] * p.grid[1] * p.splits
    if p.blocks < H100:  # only where no tile at any allowed split fills the card
        most = max(1, min(im2col_conv.MAX_SPLITS, p.slices // im2col_conv.MIN_SLICES))
        assert all(-(-p.m // bm) * -(-k // bn) * most < H100 for bm, bn in im2col_conv.TILES)


@pytest.mark.parametrize("xs,ws,stride", SMALL + PAPER)
def test_plan_is_a_pure_function_of_shape_stride_and_sms(xs, ws, stride):
    p = im2col_conv.plan(xs, ws, stride, sms=H100)
    im2col_conv.plan.cache_clear()
    assert im2col_conv.plan(tuple(xs), tuple(ws), stride, sms=H100) == p  # recomputed, not cached
    assert im2col_conv.plan(xs, ws, stride) == p  # 132 SMs by default
    n, h, wd, c = xs
    k = ws[3]
    # the shape's own numbers decide, not the values or where they came from
    assert im2col_conv.plan((n, h, wd, c), (*ws[:3], k), stride, sms=H100) == p


@pytest.mark.parametrize("xs,ws,stride", list(SYNTHNET))
def test_synthnet_plans_fill_the_h100(xs, ws, stride):
    p = im2col_conv.plan(xs, ws, stride, sms=H100)
    assert ((p.bm, p.bn), p.splits, p.blocks) == SYNTHNET[(xs, ws, stride)]
    assert p.blocks >= H100  # at least one block per SM
    assert p.vector == (xs[3] != 3)  # the first layer (C = 3) takes 4-byte copies


@pytest.mark.parametrize("xs,ws,stride", [s for s in SMALL + PAPER if s[1][3] == 96])
def test_no_column_tile_is_mostly_padding_at_k96(xs, ws, stride):
    p = im2col_conv.plan(xs, ws, stride, sms=H100)
    last = p.k - (p.grid[1] - 1) * p.bn  # real columns of the last column tile
    assert 2 * last > p.bn


def test_more_sms_never_give_fewer_blocks_at_synthnet():
    for xs, ws, stride in SYNTHNET:
        small, big = (im2col_conv.plan(xs, ws, stride, sms=n) for n in (66, 132))
        assert big.blocks >= 132 and small.blocks >= 66


@pytest.mark.parametrize(
    "xs,ws,stride,splits",
    [(xs, ws, st, None) for xs, ws, st in SMALL + PAPER]
    + [
        ((2, 13, 13, 40), (3, 3, 40, 72), 1, 3),  # 23 slices in 3 splits: 7, 8, 8
        ((2, 13, 13, 40), (3, 3, 40, 72), 1, 5),
        ((2, 40, 44, 6), (11, 11, 6, 40), 4, 7),  # 46 slices in 7
        ((2, 13, 11, 5), (3, 3, 5, 17), 1, 2),  # 45 terms: a ragged last slice
    ],
)
def test_split_ranges_cover_the_reduction_once(xs, ws, stride, splits):
    p = im2col_conv.plan(xs, ws, stride, sms=H100)
    if splits is not None:
        p = dataclasses.replace(p, splits=splits)
        assert p.slices % splits != 0  # uneven on purpose
    ranges = _ranges(p)
    assert ranges[0][0] == 0 and ranges[-1][1] == p.kr
    for (lo, hi), (nxt, _) in zip(ranges, ranges[1:]):
        assert lo < hi == nxt  # contiguous, no gap, no overlap, none empty
    assert all(lo % im2col_conv.BK == 0 for lo, _ in ranges)  # whole slices
    sizes = [hi - lo for lo, hi in ranges[:-1]]
    assert not sizes or max(sizes) - min(sizes) <= im2col_conv.BK  # within one slice of even
    covered = np.zeros(p.kr, dtype=int)
    for lo, hi in ranges:
        covered[lo:hi] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize(
    "xs,ws,stride",
    SMALL + PAPER + [((8, 224, 224, 64), (3, 3, 64, 64), 1), ((1, 1, 1, 4096), (1, 1, 4096, 2**18), 1),
                     ((1, 4, 4, 2**16), (1, 1, 2**16, 8192), 1)],
)
def test_workspace_index_fits_int32(xs, ws, stride):
    p = im2col_conv.plan(xs, ws, stride, sms=H100)
    shape = p.workspace_shape
    assert shape is None if p.splits == 1 else shape == (p.splits, p.m, p.k)
    assert p.splits * p.m * p.k <= 2**31 - 1
    # the kernel's split offset z * M * K, for the last split, and the last element
    assert (p.splits - 1) * p.m * p.k + p.m * p.k - 1 <= 2**31 - 1


def test_plan_refuses_a_channel_mismatch():
    with pytest.raises(ValueError, match="channel mismatch"):
        im2col_conv.plan((1, 4, 4, 3), (3, 3, 4, 8), 1)


def test_modelled_time_charges_a_second_round_of_blocks():
    m, k, kr = 6050, 96, 30976  # SynthNet's 11x11 C=256 layer
    one = im2col_conv.modelled_ns(m, k, kr, 128, 96, 2, True, H100)  # 96 blocks, one round
    over = im2col_conv.modelled_ns(m, k, kr, 128, 96, 3, True, H100)  # 144 blocks: 12 SMs take two
    assert over > one
    assert im2col_conv.modelled_ns(m, k, kr, 128, 96, 1, False, H100) > im2col_conv.modelled_ns(
        m, k, kr, 128, 96, 1, True, H100)  # 4-byte copies are modelled slower
