"""The SSD scan's route, plan and bf16 arithmetic (CPU).

``kernels/ssd_scan.route`` and ``plan`` are pure functions of type, shape,
alignment and SM count, so they are pinned here: mamba2-130m's and
zamba2-2.7b's bf16 prefill scans (x, B and C strided as ``ssd_block``
passes them) take the ``wgmma`` route, the ``mma.sync`` kernel's plan there
launches a block per SM at least, and fp32, chunk 8 and unaligned rows take
the SIMT kernel.  The tensor-core kernel's
bf16 roundings (the source note of ``csrc/ssd_scan.cu``) are modelled in
plain PyTorch and held against the JAX package's ``blocks.ssd_chunked`` at
a small shape, and against ``ssd_scan_plain`` at mamba2-130m's shape,
within 1e-2 of max |y| and of max |state| (``chip_smoke.py``'s
``BF16_REL_TOL``, what the card's kernel is held to).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # CI installs requirements-dev.txt, which has no torch

import jax.numpy as jnp

from repro.models import blocks as jblocks
from repro_torch.kernels import ssd_scan as ssd

BF16_REL_TOL = 1e-2
MMA = ssd.KERNELS.index("ssd_scan_mma_bf16_kernel")
WGMMA = ssd.KERNELS.index("ssd_scan_fwd_chunk_kernel")
SIMT_F32 = ssd.KERNELS.index("ssd_scan_kernel<float>")
SIMT_BF16 = ssd.KERNELS.index("ssd_scan_kernel<__nv_bfloat16>")
#: (b, l, h, p, n, chunk) of the served Mamba2-family prefill scans at batch 4, prompt 512
MAMBA2, ZAMBA2 = (4, 512, 24, 64, 128, 64), (4, 512, 80, 64, 64, 64)


def _inputs(b, l, h, p, n, seed=0, strided=True):
    """x, dt, A, B, C from numpy with a seed; x, B, C bf16 (slices of one
    projection where ``strided``, as ``ssd_block`` passes them)."""
    rng = np.random.default_rng(seed)
    proj = torch.from_numpy(rng.standard_normal((b, l, h * p + 2 * n), dtype=np.float32)).bfloat16()
    x, B, C = proj[..., : h * p].reshape(b, l, h, p), proj[..., h * p : h * p + n], proj[..., h * p + n :]
    if not strided:
        x, B, C = x.contiguous(), B.contiguous(), C.contiguous()
    dt = torch.from_numpy(np.logaddexp(rng.standard_normal((b, l, h), dtype=np.float32), 0).astype(np.float32))
    A = torch.from_numpy(-np.exp(0.5 * rng.standard_normal(h, dtype=np.float32)))
    return x, dt, A, B, C


def _terms(v, k):
    """``v`` as the sum of ``k`` bf16 values, each the rounding of what the earlier ones left."""
    out = torch.zeros_like(v)
    for _ in range(k):
        out = out + (v - out).to(torch.bfloat16).float()
    return out


def _kernel_model(x, dt, A, B, C, chunk, terms=ssd.MMA_TERMS):
    """The tensor-core kernel's arithmetic in plain PyTorch: fp32 sums, the
    state carried in fp32, the product operands that are not exact in bf16
    (C.B^T o L o dt, w o B with w[s] = exp(cum_last - cum_s) dt_s, and the
    state that feeds C.S^T) as ``terms`` bf16 terms each, and y rounded to
    bf16."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    idx = torch.arange(chunk)
    causal = (idx[:, None] >= idx[None, :])[None, None]
    state = torch.zeros((b, h, p, n))
    ys = []
    for c in range(l // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        xc, dtc = x[:, sl].float(), dt[:, sl].float().permute(0, 2, 1)  # [b, s, h, p], [b, h, s]
        Bc, Cc = B[:, sl].float(), C[:, sl].float()
        cum = torch.cumsum(dtc * A[None, :, None], dim=-1)  # [b, h, s]
        g = torch.einsum("bln,bsn->bls", Cc, Bc)[:, None]  # [b, 1, l, s]
        gl = g * torch.exp(cum[..., :, None] - cum[..., None, :]) * dtc[..., None, :]
        gs = _terms(torch.where(causal, gl, torch.zeros(())), terms)
        inter = torch.exp(cum)[..., None] * torch.einsum("bln,bhpn->bhlp", Cc, _terms(state, terms))
        y = inter + torch.einsum("bhls,bshp->bhlp", gs, xc)
        ys.append(y.permute(0, 2, 1, 3).to(torch.bfloat16))
        w = torch.exp(cum[..., -1:] - cum) * dtc  # [b, h, s]
        bw = _terms(Bc[:, None] * w[..., None], terms)  # [b, h, s, n]
        state = state * torch.exp(cum[..., -1])[..., None, None] + torch.einsum("bshp,bhsn->bhpn", xc, bw)
    return torch.cat(ys, dim=1), state


def _rel(got, want):
    return (got.float() - want.float()).abs().max().item() / want.float().abs().max().item()


@pytest.mark.parametrize(
    "dtype,shape,strided,want",
    [
        (torch.bfloat16, MAMBA2, True, WGMMA),
        (torch.bfloat16, ZAMBA2, True, WGMMA),
        (torch.bfloat16, MAMBA2, False, WGMMA),
        (torch.float32, MAMBA2, False, SIMT_F32),
        (torch.bfloat16, (2, 64, 4, 16, 16, 8), True, SIMT_BF16),  # mamba2 smoke: chunk 8, state 16
        (torch.bfloat16, (2, 256, 3, 48, 64, 32), False, MMA),  # p 48: a ragged p tile
        (torch.bfloat16, (2, 256, 3, 40, 64, 32), False, SIMT_BF16),  # p not a multiple of 16
        (torch.bfloat16, (2, 256, 3, 64, 96, 32), False, SIMT_BF16),  # a state width not compiled
        (torch.bfloat16, (1, 256, 2, 64, 64, 128), False, SIMT_BF16),  # chunk 128
    ],
)
def test_route_picks_the_kernel_by_type_shape_and_alignment(dtype, shape, strided, want):
    b, l, h, p, n, chunk = shape
    x, _, _, B, C = _inputs(b, l, h, p, n, strided=strided)
    x, B, C = x.to(dtype), B.to(dtype), C.to(dtype)
    aligned = ssd._aligned(x) and ssd._aligned(B) and ssd._aligned(C)
    assert aligned
    assert ssd.route(dtype, p, n, chunk, aligned) == want
    assert ssd.plan(dtype, b, h, p, n, chunk, aligned).route == want


def test_route_sends_unaligned_bf16_rows_to_the_simt_kernel():
    """Rows that start 4 bytes past a 16-byte boundary (a projection sliced at column 2)."""
    b, l, h, p, n = 2, 128, 3, 64, 64
    proj = torch.zeros((b, l, h * p + 2 * n + 2), dtype=torch.bfloat16)[..., 2:]
    x, B = proj[..., : h * p].reshape(b, l, h, p), proj[..., h * p : h * p + n]
    assert not ssd._aligned(x) and not ssd._aligned(B)
    assert ssd.route(torch.bfloat16, p, n, 64, False) == SIMT_BF16
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ssd.route(torch.float16, p, n, 64, True)


@pytest.mark.parametrize(
    "shape,p_tile,blocks",
    [(MAMBA2, 32, 192), (ZAMBA2, 64, 320)],
    ids=["mamba2-130m", "zamba2-2.7b"],
)
def test_plan_of_the_served_prefill_scans(shape, p_tile, blocks):
    """The ``mma.sync`` plan scripts/ssd_probe.py measured fastest among those
    that launch a block on every SM of an H100 (PERF.md): mamba2 at p tiles
    of 32 (a 64-row tile would leave 36 SMs idle), zamba2 at 64.  It is the
    one timed beside the ``wgmma`` route, which :func:`plan` picks there."""
    b, _, h, p, n, chunk = shape
    chosen = ssd.mma_plan(b, h, p, n, chunk, sms=132)
    assert (chosen.route, chosen.p_tile, chosen.blocks) == (MMA, p_tile, blocks)
    assert chosen.blocks >= 132
    assert 48 * 1024 < chosen.smem <= ssd.MAX_SMEM_BYTES
    assert ssd.mma_plan(b, h, p, n, chunk, sms=132) is chosen  # cached
    assert ssd.plan(torch.bfloat16, b, h, p, n, chunk, True, sms=132).route == WGMMA


@pytest.mark.parametrize("shape", [MAMBA2, ZAMBA2, (2, 128, 3, 48, 64, 16)])
def test_every_tensor_core_plan_fits_shared_memory(shape):
    b, _, h, p, n, chunk = shape
    plans = ssd.mma_plans(b, h, p, n, chunk)
    assert [q.p_tile for q in plans] == list(ssd.MMA_P_TILES)
    for q in plans:
        assert q.route == MMA and q.blocks == b * h * -(-p // q.p_tile)
        assert q.smem == ssd.mma_smem_bytes(chunk, n, q.p_tile) <= ssd.MAX_SMEM_BYTES


def test_mma_shared_memory_is_the_sources_count():
    """Ring (x [64][32+8], B, C [64][128+8] bf16, dt [64] fp32) x 2, the
    state [32][128] fp32, the 10 tiles of 16 x 16 of the scaled C.B^T on and
    below the diagonal in fp32, and 8 warps x 3 x 64 fp32 factors, at
    mamba2's plan: two blocks an SM."""
    stage = 64 * (40 + 2 * 136) * 2 + 64 * 4
    assert ssd.mma_smem_bytes(64, 128, 32) == 2 * stage + 32 * 128 * 4 + 10 * 256 * 4 + 8 * 3 * 64 * 4 == 113_152
    assert 2 * (113_152 + 1024) <= 228 * 1024


def test_smaller_shapes_plan_the_smallest_p_tile():
    """Under a block per SM at any tile, the most blocks: p tiles of 16."""
    chosen = ssd.plan(torch.bfloat16, 2, 3, 48, 64, 32, True, sms=132)
    assert (chosen.route, chosen.p_tile, chosen.blocks) == (MMA, 16, 18)
    assert ssd.plan(torch.float32, 4, 24, 64, 128, 64, True).p_tile == ssd.SIMT_P_TILE


def test_bf16_model_of_the_kernel_matches_ssd_chunked():
    """The kernel's roundings at a small shape against the JAX package's
    blocks.ssd_chunked (fp32 on the same bf16 inputs), output and final state."""
    x, dt, A, B, C = _inputs(2, 128, 3, 32, 64, seed=1)
    y, state = _kernel_model(x, dt, A, B, C, 32)
    jx = [jnp.asarray(t.float().numpy()) for t in (x, dt, A, B, C)]
    y_ref, state_ref = jblocks.ssd_chunked(*jx, 32, return_state=True)
    y_ref, state_ref = torch.from_numpy(np.array(y_ref)), torch.from_numpy(np.array(state_ref))
    assert y.shape == y_ref.shape and state.shape == state_ref.shape
    assert _rel(y, y_ref) <= BF16_REL_TOL
    assert _rel(state, state_ref) <= BF16_REL_TOL


@pytest.mark.parametrize("shape", [MAMBA2, ZAMBA2], ids=["mamba2-130m", "zamba2-2.7b"])
def test_bf16_model_of_the_kernel_matches_plain_at_the_served_widths(shape):
    """At the served shapes the kernel's roundings stay within the card's
    bf16 tolerance of ssd_scan_plain (fp32 inside, y rounded once)."""
    b, l, h, p, n, chunk = shape
    x, dt, A, B, C = _inputs(b, l, h, p, n, seed=2)
    y, state = _kernel_model(x, dt, A, B, C, chunk)
    yp, sp = ssd.ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
    assert _rel(y, yp) <= BF16_REL_TOL
    assert _rel(state, sp) <= BF16_REL_TOL


def test_split_operands_give_the_plain_versions_bits():
    """Why the kernel splits its inexact operands into bf16 terms: with one
    term (each rounded to bf16) about a third of the bf16 outputs differ from
    the plain version's by a rounding, and a deep bf16 model carries that
    far (PERF.md, scripts/ssd_lm_sensitivity.py); with the shipped terms the
    state agrees to fp32 rounding and almost every output bit for bit."""
    x, dt, A, B, C = _inputs(2, 256, 3, 64, 128, seed=3)
    yp, sp = ssd.ssd_scan_plain(x, dt, A, B, C, chunk=64)
    y1, s1 = _kernel_model(x, dt, A, B, C, 64, terms=1)
    y, state = _kernel_model(x, dt, A, B, C, 64)
    assert (y1 != yp).float().mean().item() > 0.1 and _rel(s1, sp) > 1e-3
    assert (y != yp).float().mean().item() < 1e-3
    assert _rel(state, sp) < 1e-6
