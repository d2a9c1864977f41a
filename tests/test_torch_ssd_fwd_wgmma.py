"""The bf16 SSD forward's ``wgmma`` route on the CPU: its route, its launches,
its shared-memory plan, the plain version of each of its steps and a model
of its bf16 term splits.

``kernels/ssd_scan.route`` sends bf16 at chunk 64, p a multiple of 64,
state width 64 or 128 and rows TMA can address to route 3, whose two
kernels (``fwd_kernels``) are parallel over chunks: the chunk states carried
along the chunks, then every chunk's output.  The steps' plain versions
(``fwd_states_plain``, ``fwd_pass_plain``, ``fwd_chunk_plain``) compose to
``ssd_scan_plain`` and are held against the JAX package's
``blocks.ssd_chunked`` and the Pallas ``ssd_scan`` (interpret mode) at the
SSD tests' tolerance, 2e-3.  The kernels' bf16 roundings (3 bf16 terms of
each operand that is not exact in bf16, each term's products in fp32
accumulators of their own, summed smallest first, y rounded once) are
modelled in plain PyTorch and held
against ``ssd_scan_plain`` at mamba2-130m's and zamba2-2.7b's widths within
``chip_smoke.py``'s bf16 tolerance, 1e-2 of max |y| and of max |state|.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # CI installs requirements-dev.txt, which has no torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.models import blocks as jblocks
from repro_torch.kernels import ssd_scan as ssd

SSD_TOL = dict(rtol=2e-3, atol=2e-3)
BF16_REL_TOL = 1e-2
WGMMA, MMA = ssd.KERNELS.index("ssd_scan_fwd_chunk_kernel"), ssd.KERNELS.index("ssd_scan_mma_bf16_kernel")
SIMT_F32 = ssd.KERNELS.index("ssd_scan_kernel<float>")
SIMT_BF16 = ssd.KERNELS.index("ssd_scan_kernel<__nv_bfloat16>")
#: (b, l, h, p, n) of the served prefill scans (batch 4, prompt 512) and of the mesh ranks' scans: mamba2
#: and zamba2 on a (1, 2) mesh, zamba2 x train_4k as rank 0 of (16, 16)
SERVED = {"mamba2-130m": (4, 512, 24, 64, 128), "zamba2-2.7b": (4, 512, 80, 64, 64)}
RANKS = {"mamba2 (1, 2)": (4, 512, 12, 64, 128), "zamba2 (1, 2)": (4, 512, 40, 64, 64),
         "zamba2 train_4k": (16, 4096, 5, 64, 64)}


def _inputs(b, l, h, p, n, seed=0, dtype=torch.bfloat16, strided=True):
    """x, dt, A, B, C from numpy with a seed; x, B, C of ``dtype``, slices of
    one projection where ``strided`` (as ``ssd_block`` passes them)."""
    rng = np.random.default_rng(seed)
    proj = torch.from_numpy(rng.standard_normal((b, l, h * p + 2 * n), dtype=np.float32)).to(dtype)
    x, B, C = proj[..., : h * p].reshape(b, l, h, p), proj[..., h * p : h * p + n], proj[..., h * p + n :]
    if not strided:
        x, B, C = x.contiguous(), B.contiguous(), C.contiguous()
    dt = torch.from_numpy(np.logaddexp(rng.standard_normal((b, l, h), dtype=np.float32), 0).astype(np.float32))
    A = torch.from_numpy(-np.exp(0.5 * rng.standard_normal(h, dtype=np.float32)))
    return x, dt, A, B, C


def _steps(x, dt, A, B, C, chunk):
    """y and the last state by the three steps' plain versions."""
    ds, dec = ssd.fwd_states_plain(x, dt, A, B, chunk=chunk)
    h_in, last = ssd.fwd_pass_plain(ds, dec)
    return ssd.fwd_chunk_plain(x, dt, A, B, C, h_in, chunk=chunk), last


def _rel(got, want):
    return (got.float() - want.float()).abs().max().item() / want.float().abs().max().item()


@pytest.mark.parametrize("shape", [*SERVED.values(), *RANKS.values()], ids=[*SERVED, *RANKS])
def test_served_and_rank_scans_take_the_wgmma_route(shape):
    b, l, h, p, n = shape
    x, _, _, B, C = _inputs(b, 128, h, p, n)  # the route reads strides and alignment, not l
    assert ssd.fwd_aligned(x, B, C)
    chosen = ssd.plan(torch.bfloat16, b, h, p, n, 64, True)
    assert ssd.route(torch.bfloat16, p, n, 64, True) == chosen.route == WGMMA
    assert ssd.fwd_kernels(chosen, n) == (f"ssd_scan_fwd_states_kernel<{n}>", f"ssd_scan_fwd_chunk_kernel<{n}>")
    assert chosen.blocks == b * h * (p // 64) * (n // 64)
    # the mma.sync kernel still takes the shape, so the two can be timed side by side
    assert ssd.mma_plan(b, h, p, n, 64).route == MMA
    assert ssd.fwd_kernels(ssd.mma_plan(b, h, p, n, 64), n)[0].startswith(f"ssd_scan_mma_bf16_kernel<{n}, ")


@pytest.mark.parametrize(
    "dtype,p,n,chunk,aligned,want",
    [
        (torch.bfloat16, 64, 128, 16, True, MMA),  # chunk 16
        (torch.bfloat16, 64, 64, 32, True, MMA),  # chunk 32
        (torch.bfloat16, 48, 64, 64, True, MMA),  # p not a multiple of 64
        (torch.bfloat16, 128, 64, 64, True, WGMMA),  # two 64-row tiles of p
        (torch.bfloat16, 64, 96, 64, True, SIMT_BF16),  # a state width not compiled
        (torch.bfloat16, 64, 128, 64, False, SIMT_BF16),  # rows TMA cannot address
        (torch.bfloat16, 16, 16, 8, True, SIMT_BF16),  # the smoke configs' chunk 8
        (torch.float32, 64, 128, 64, True, SIMT_F32),
        # 16-byte rows TMA cannot address (a zero stride): cp.async reads them on mma.sync
        (torch.bfloat16, 64, 128, 64, (True, False), MMA),
    ],
)
def test_other_scans_keep_their_routes(dtype, p, n, chunk, aligned, want):
    """``aligned``: one flag for both of route's, or (aligned, tma)."""
    aligned, tma = aligned if isinstance(aligned, tuple) else (aligned, aligned)
    assert ssd.route(dtype, p, n, chunk, aligned, tma) == want
    chosen = ssd.plan(dtype, 4, 24, p, n, chunk, aligned, tma)
    assert chosen.route == want
    assert ("ssd_scan_fwd_chunk_kernel" in " ".join(ssd.fwd_kernels(chosen, n))) == (want == WGMMA)


def test_unaligned_rows_and_zero_strides_are_not_tma_rows():
    b, l, h, p, n = 2, 128, 3, 64, 64
    proj = torch.zeros((b, l, h * p + 2 * n + 2), dtype=torch.bfloat16)[..., 2:]
    x, B, C = proj[..., : h * p].reshape(b, l, h, p), proj[..., h * p : h * p + n], proj[..., h * p + n :]
    assert not ssd.fwd_aligned(x, B, C)
    x, _, _, B, C = _inputs(b, l, h, p, n)
    assert ssd.fwd_aligned(x, B, C)
    zero = B.expand(b, l, n).as_strided((b, l, n), (0, B.stride(1), 1))
    assert not ssd.fwd_aligned(x, zero, C)
    assert ssd.alignment(x, zero, C) == (True, False)
    assert ssd.fwd_aligned(x[:1], B[:1].as_strided((1, l, n), (0, B.stride(1), 1)), C[:1])  # a dim of 1


@pytest.mark.parametrize("name", [*SERVED, *RANKS])
def test_the_shared_memory_plan_fits_a_block(name):
    """The source's bwd_states_smem / fwd_chunk_smem, mirrored: the states
    kernel the backward's (1 KB of slack, two stages of x, B and dt, 3
    planes and the warps' factors); the chunk kernel C and B, two x boxes,
    3 planes of the state, the output's box, barriers, the group's dt and
    the warps' factors.  The states kernel fits three blocks an SM, the
    chunk kernel two at state 128 and three at 64."""
    b, l, h, p, n = {**SERVED, **RANKS}[name]
    hg = ssd.bwd_head_group(b, l, h)
    states, chunk = ssd.fwd_smem_bytes(n, hg)
    box = 64 * 128
    assert states == ssd.mma_bwd_smem_bytes(n)[0] == 1024 + 2 * (2 * box + 1024) + 3 * box + 3072 == 63_488
    assert chunk == 1024 + (5 * (n // 64) + 3) * box + 32 + hg * 256 + 3072
    assert max(states, chunk) <= ssd.MAX_SMEM_BYTES
    per_sm = 228 * 1024
    assert per_sm // (states + 1024) == 3
    assert per_sm // (chunk + 1024) == (2 if n == 128 else 3)
    sb, cb = ssd.fwd_grid(b, l, h, p, n)
    assert (sb, cb) == (b * h * (p // 64) * (n // 64), b * (l // 64) * (h // hg))


def test_served_groups_and_grids():
    assert ssd.bwd_head_group(4, 512, 24) == 3 and ssd.fwd_grid(4, 512, 24, 64, 128) == (192, 256)
    assert ssd.bwd_head_group(4, 512, 80) == 10 and ssd.fwd_grid(4, 512, 80, 64, 64) == (320, 256)
    assert ssd.fwd_smem_bytes(128, 3) == (63_488, 111_392)
    assert ssd.fwd_smem_bytes(64, 10) == (63_488, 72_224)


@pytest.mark.parametrize("chunk,h,p,n", [(64, 2, 64, 64), (64, 3, 64, 128), (32, 2, 16, 8), (16, 3, 8, 16)])
def test_the_steps_compose_to_the_plain_scan_and_the_reference(chunk, h, p, n):
    """fp32 inputs: the steps against ssd_scan_plain, the JAX package's
    blocks.ssd_chunked (y and final state) and the Pallas ssd_scan in
    interpret mode (y)."""
    x, dt, A, B, C = _inputs(2, 128, h, p, n, seed=chunk + n, dtype=torch.float32, strided=False)
    y, last = _steps(x, dt, A, B, C, chunk)
    yp, sp = ssd.ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
    np.testing.assert_allclose(y.numpy(), yp.numpy(), **SSD_TOL)
    np.testing.assert_allclose(last.numpy(), sp.numpy(), **SSD_TOL)
    jx = [jnp.asarray(t.numpy()) for t in (x, dt, A, B, C)]
    y_ref, state_ref = jblocks.ssd_chunked(*jx, chunk, return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **SSD_TOL)
    np.testing.assert_allclose(last.numpy(), np.asarray(state_ref), **SSD_TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(jops.ssd_scan(*jx, chunk=chunk)), **SSD_TOL)


def test_each_step_is_what_the_next_takes():
    """The chunk states sum to the final state's chunk terms; the state
    entering chunk 0 is zero and each next one is the last one decayed plus
    the chunk's own part; the chunk outputs of chunk c see only chunk c."""
    x, dt, A, B, C = _inputs(1, 256, 2, 64, 64, seed=5, dtype=torch.float32, strided=False)
    ds, dec = ssd.fwd_states_plain(x, dt, A, B)
    assert ds.shape == (1, 2, 4, 64, 64) and dec.shape == (1, 2, 4)
    h_in, last = ssd.fwd_pass_plain(ds, dec)
    assert torch.equal(h_in[:, :, 0], torch.zeros_like(h_in[:, :, 0]))
    for c in range(3):
        torch.testing.assert_close(h_in[:, :, c + 1], h_in[:, :, c] * dec[:, :, c, None, None] + ds[:, :, c])
    torch.testing.assert_close(last, h_in[:, :, 3] * dec[:, :, 3, None, None] + ds[:, :, 3])
    y = ssd.fwd_chunk_plain(x, dt, A, B, C, h_in)
    x2 = x.clone()
    x2[:, :64] += 1.0  # chunk 0's inputs: with the states held, chunk 1's outputs do not move
    y2 = ssd.fwd_chunk_plain(x2, dt, A, B, C, h_in)
    assert torch.equal(y[:, 64:], y2[:, 64:]) and not torch.equal(y[:, :64], y2[:, :64])


def _terms(v, k):
    """``v`` as ``k`` bf16 values, each the rounding of what the earlier ones left (largest first)."""
    out, left = [], v
    for _ in range(k):
        t = left.to(torch.bfloat16).float()
        out.append(t)
        left = left - t
    return out


def _route_model(x, dt, A, B, C, terms=ssd.MMA_TERMS):
    """The wgmma route's arithmetic in plain PyTorch (chunk 64), fp32 sums:
    the states kernel's state in fp32, scaled by exp(cum_last) before each
    chunk's part adds to it, the part on ``terms`` bf16 terms of w∘B
    (w = exp(cum_last − cum)·dt) against x as stored; the chunk kernel's
    accumulators, one set a term: C·Hᵀ of each term of the state entering
    the chunk, summed smallest first and scaled by exp(cum) into term 0's,
    then (G∘L∘dt)·x of each term of G∘L∘dt added to its term's, and y
    their sum, smallest first, rounded to bf16 once."""
    chunk = 64
    b, l, h, p = x.shape
    n = B.shape[-1]
    nc = l // chunk
    xf = x.float().reshape(b, nc, chunk, h, p)
    dtf = dt.float().reshape(b, nc, chunk, h)
    Bf, Cf = B.float().reshape(b, nc, chunk, n), C.float().reshape(b, nc, chunk, n)
    cum = torch.cumsum(dtf * A.float(), dim=2)  # [b, c, cl, h]
    w = torch.exp(cum[:, :, -1:] - cum) * dtf
    state = torch.zeros((b, h, p, n))
    h_in = []
    for c in range(nc):
        h_in.append(state)
        part = sum(torch.einsum("blhp,bhln->bhpn", xf[:, c], t)
                   for t in reversed(_terms(w[:, c].permute(0, 2, 1)[..., None] * Bf[:, c, None], terms)))
        state = state * torch.exp(cum[:, c, -1])[..., None, None] + part
    idx = torch.arange(chunk)
    causal = (idx[:, None] >= idx[None, :])[:, :, None]
    ldec = torch.exp(torch.where(causal, cum[:, :, :, None, :] - cum[:, :, None, :, :], float("-inf")))  # [b,c,l,s,h]
    g = torch.einsum("bcln,bcsn->bcls", Cf, Bf)
    gl = g[..., None] * ldec * dtf[:, :, None]  # [b, c, l, s, h]
    ys = []
    for c in range(nc):
        inter = [torch.einsum("bln,bhpn->blhp", Cf[:, c], t) for t in _terms(h_in[c], terms)]
        acc = [torch.einsum("blsh,bshp->blhp", t, xf[:, c]) for t in _terms(gl[:, c], terms)]
        acc[0] = acc[0] + sum(reversed(inter)) * torch.exp(cum[:, c])[..., None]
        ys.append(sum(reversed(acc)).to(torch.bfloat16))
    return torch.stack(ys, dim=1).reshape(b, l, h, p), state


@pytest.mark.parametrize("name", list(SERVED))
def test_bf16_model_of_the_route_matches_plain_at_the_served_widths(name):
    """At the served widths (a quarter of the prompt, the same chunks) the
    route's roundings stay within the card's bf16 tolerance of
    ssd_scan_plain, and almost every output bit for bit: with 3 terms the
    state agrees to fp32 rounding and under 1e-3 of the bf16 outputs differ
    by a rounding (the mma.sync kernel's model, tests/test_torch_ssd_plan.py);
    with 1 term a third of them do."""
    b, l, h, p, n = SERVED[name]
    x, dt, A, B, C = _inputs(b, 128, h, p, n, seed=7)
    y, state = _route_model(x, dt, A, B, C)
    yp, sp = ssd.ssd_scan_plain(x, dt, A, B, C, chunk=64)
    assert _rel(y, yp) <= BF16_REL_TOL and _rel(state, sp) <= BF16_REL_TOL
    assert (y != yp).float().mean().item() < 1e-3
    assert _rel(state, sp) < 1e-6
    y1, s1 = _route_model(x, dt, A, B, C, terms=1)
    assert (y1 != yp).float().mean().item() > 0.1 and _rel(s1, sp) > 1e-3


def test_bf16_model_of_the_route_matches_ssd_chunked():
    """The route's roundings at a small shape against the JAX package's
    blocks.ssd_chunked (fp32 on the same bf16 inputs), output and final state."""
    x, dt, A, B, C = _inputs(2, 256, 3, 64, 64, seed=11)
    y, state = _route_model(x, dt, A, B, C)
    jx = [jnp.asarray(t.float().numpy()) for t in (x, dt, A, B, C)]
    y_ref, state_ref = jblocks.ssd_chunked(*jx, 64, return_state=True)
    assert _rel(y, torch.from_numpy(np.array(y_ref))) <= BF16_REL_TOL
    assert _rel(state, torch.from_numpy(np.array(state_ref))) <= BF16_REL_TOL
