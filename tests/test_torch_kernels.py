"""The port's conv kernel module against the JAX package's (CPU), the
kernel build, and the batched GEMM's choice of kernel.

Inputs come from numpy with a seed and go to both packages.  The plain
PyTorch version (what a CPU tensor runs) is held against the Pallas kernel in
interpret mode and against ``lax.conv``, at the reference's tolerance 3e-4.
The CUDA kernels themselves run only on the card: ``tests/test_torch_gpu.py``.
"""

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

WGMMA, MMA16, MMA16_MASKED, MMA64_MASKED, FMA = (gm.KERNELS.index(n) for n in (
    "gemm_wgmma_bf16_kernel", "gemm_mma_bf16_kernel<16, 128> 16-byte rows", "gemm_mma_bf16_kernel<16, 128> masked",
    "gemm_mma_bf16_kernel<64, 256> masked", "gemm_fma_f32_kernel"))


@pytest.mark.parametrize(
    "dtype,m,k,n,aligned,want",
    [
        (torch.bfloat16, 320, 4096, 6400, True, WGMMA),  # phi3.5-moe prefill gate/up
        (torch.bfloat16, 320, 6400, 4096, True, WGMMA),  # ... down
        (torch.bfloat16, 160, 5120, 8192, True, WGMMA),  # llama4-scout prefill
        (torch.bfloat16, 17, 4104, 6408, True, WGMMA),  # the first M past decode's tile, ragged K and N
        (torch.bfloat16, 321, 8, 8, True, WGMMA),
        (torch.bfloat16, 16, 4096, 6400, True, MMA16),  # decode keeps the 16-row mma.sync tile
        (torch.bfloat16, 8, 6400, 4096, True, MMA16),
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
    assert gm.route(dtype, m, k, n, aligned) == want
    assert gm.route(dtype, m, k, n, aligned) == want  # deterministic


def test_gemm_route_lists_each_kernel_once_and_refuses_other_types():
    assert len(set(gm.KERNELS)) == len(gm.KERNELS) == 5
    assert {gm.route(dt, m, 64, 64, al) for dt in (torch.float32, torch.bfloat16) for m in (8, 64)
            for al in (True, False)} == set(range(len(gm.KERNELS)))
    with pytest.raises(TypeError):
        gm.route(torch.float16, 64, 64, 64, True)


def test_gemm_alignment_reads_every_row_start():
    x = torch.zeros((3, 40, 72), dtype=torch.bfloat16)
    assert gm._aligned(x) and gm._aligned(x[1]) and gm._aligned(x[:, ::2])
    assert not gm._aligned(x[:, :, 3:67])  # row starts 6 bytes past 16-byte boundaries
    assert not gm._aligned(torch.zeros((4, 36), dtype=torch.bfloat16)[:, :32])  # row stride 72 bytes
