"""The port's SSD-scan gradient against ``jax.grad`` of the reference's scan, on the CPU.

The reference has no backward kernel: it trains through XLA's gradient of
``blocks.ssd_chunked``, so that gradient is the specification of the
port's backward.  ``ssd_scan_bwd_plain`` (the explicit formulas the CUDA
backward computes) is held to it at the reference's SSD tolerance, 2e-3,
and to autograd through ``ssd_scan_plain`` to fp32 round-off (1e-4 of each
gradient's max).  Inputs are seeded numpy, fp32 on both sides (bf16 cases
round the inputs to bf16 first and give both sides the same values).  The
autograd Function that puts the kernels on the training path is run here
with both kernel calls swapped for their plain versions.  The CUDA kernels
themselves are held to ``ssd_scan_bwd_plain`` by ``tests/test_torch_gpu.py``
and ``chip_smoke.py`` on the card.
"""

import functools
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # CI installs requirements-dev.txt, which has no torch

import jax
import jax.numpy as jnp

from repro.models import blocks as jblocks
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd

SSD_TOL = dict(rtol=2e-3, atol=2e-3)
#: fp32 round-off: the two sides sum the same terms in other orders
ROUNDOFF = 1e-4
NAMES = ("dx", "ddt", "dA", "dB", "dC")

# (b, l, h, p, n, chunk): chunks 8, 16 and 64; p that the kernel's p tile
# (BWD_P_TILE, 64) divides and p that it does not (100); one chunk and several
GRID = [
    (2, 32, 3, 16, 16, 8),
    (2, 64, 2, 8, 16, 16),
    (1, 128, 2, 64, 32, 64),
    (1, 64, 2, 100, 8, 64),
    (2, 48, 4, 16, 8, 16),
]


def _inputs(b, l, h, p, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p), dtype=np.float32)
    dt = np.logaddexp(rng.standard_normal((b, l, h), dtype=np.float32), 0).astype(np.float32)  # softplus
    A = -np.exp(0.5 * rng.standard_normal(h, dtype=np.float32))
    B = rng.standard_normal((b, l, n), dtype=np.float32)
    C = rng.standard_normal((b, l, n), dtype=np.float32)
    dy = rng.standard_normal((b, l, h, p), dtype=np.float32)
    dstate = rng.standard_normal((b, h, p, n), dtype=np.float32)
    return x, dt, A, B, C, dy, dstate


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16, as fp32."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


@functools.cache
def _jax_grad_fn(chunk: int, with_state: bool):
    def loss(x, dt, A, B, C, dy, dstate):
        y, state = jblocks.ssd_chunked(x, dt, A, B, C, chunk, return_state=True)
        out = jnp.sum(y * dy)
        return out + jnp.sum(state * dstate) if with_state else out

    return jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))


def _jax_grads(x, dt, A, B, C, dy, dstate, chunk):
    """``jax.grad`` of <y, dy> (+ <final state, dstate>) through the reference's ``ssd_chunked``."""
    with_state = dstate is not None
    args = (x, dt, A, B, C, dy, dstate if with_state else np.zeros((1,), np.float32))
    return [np.asarray(g) for g in _jax_grad_fn(chunk, with_state)(*(jnp.asarray(a) for a in args))]


def _autograd(x, dt, A, B, C, dy, dstate, chunk):
    """Autograd through ``ssd_scan_plain`` of the same loss."""
    ins = [t.detach().float().requires_grad_() for t in (x, dt, A, B, C)]
    y, state = ssd.ssd_scan_plain(*ins, chunk=chunk)
    loss = (y * dy.float()).sum() + ((state * dstate).sum() if dstate is not None else 0.0)
    return torch.autograd.grad(loss, ins)


def _near(got, want, rel: float, what: str) -> None:
    for name, g, w in zip(NAMES, got, want, strict=True):
        g, w = g.float(), torch.as_tensor(w).float()
        err, scale = (g - w).abs().max().item(), w.abs().max().item()
        assert err <= rel * scale, f"{what}: {name} off by {err} (max |want| {scale})"


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("b,l,h,p,n,chunk", GRID)
def test_bwd_plain_matches_jax_grad_of_ssd_chunked(b, l, h, p, n, chunk, with_state):
    x, dt, A, B, C, dy, dstate = _inputs(b, l, h, p, n)
    dstate = dstate if with_state else None
    got = ssd.ssd_scan_bwd_plain(*_t(x, dt, A, B, C, dy), None if dstate is None else _t(dstate)[0], chunk=chunk)
    want = _jax_grads(x, dt, A, B, C, dy, dstate, chunk)
    assert [g.dtype for g in got] == [torch.float32] * 5
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for name, g, w in zip(NAMES, got, want):
        torch.testing.assert_close(g, torch.from_numpy(w), **SSD_TOL, msg=lambda m, name=name: f"{name}: {m}")


@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("b,l,h,p,n,chunk", GRID)
def test_bwd_plain_matches_autograd_through_the_plain_scan(b, l, h, p, n, chunk, with_state):
    x, dt, A, B, C, dy, dstate = _t(*_inputs(b, l, h, p, n, seed=1))
    dstate = dstate if with_state else None
    got = ssd.ssd_scan_bwd_plain(x, dt, A, B, C, dy, dstate, chunk=chunk)
    _near(got, _autograd(x, dt, A, B, C, dy, dstate, chunk), ROUNDOFF, "against autograd")


@pytest.mark.parametrize("chunk", [16, 64])
def test_bwd_plain_in_bf16_matches_jax_grad(chunk):
    """bf16 x, B, C and dy: dx, dB and dC come back in bf16, ddt and dA in
    fp32, within the reference's tolerance of ``jax.grad`` in fp32 on the
    same bf16 values; the bf16 outputs also within the one rounding to bf16
    they take last (2^-8 relative at most)."""
    x, dt, A, B, C, dy, dstate = _inputs(2, 128, 3, 32, 16, seed=2)
    x, B, C, dy = (_bf16(a) for a in (x, B, C, dy))
    bf = torch.bfloat16
    got = ssd.ssd_scan_bwd_plain(*(t.to(bf) for t in _t(x)), *_t(dt, A), *(t.to(bf) for t in _t(B, C, dy)),
                                 _t(dstate)[0], chunk=chunk)
    assert [g.dtype for g in got] == [bf, torch.float32, torch.float32, bf, bf]
    want = _jax_grads(x, dt, A, B, C, dy, dstate, chunk)
    for name, g, w in zip(NAMES, got, want):
        tol = dict(SSD_TOL, rtol=SSD_TOL["rtol"] + 2.0**-8) if g.dtype == bf else SSD_TOL
        torch.testing.assert_close(g.float(), torch.from_numpy(w), **tol, msg=lambda m, name=name: f"{name}: {m}")


def test_bwd_plain_takes_b_and_c_sliced_from_one_projection():
    """x, B and C as ``ssd_block`` passes them: strided views of one
    projection.  dB and dC come back contiguous, equal to the contiguous
    inputs' gradients."""
    b, l, h, p, n, chunk = 2, 64, 3, 16, 8, 16
    x, dt, A, B, C, dy, dstate = _inputs(b, l, h, p, n, seed=3)
    proj = torch.from_numpy(np.concatenate([x.reshape(b, l, h * p), B, C], axis=-1))
    xs, Bs, Cs = proj[..., : h * p].reshape(b, l, h, p), proj[..., h * p : h * p + n], proj[..., h * p + n :]
    assert not Bs.is_contiguous() and not Cs.is_contiguous()
    got = ssd.ssd_scan_bwd_plain(xs, *_t(dt, A), Bs, Cs, *_t(dy, dstate), chunk=chunk)
    want = ssd.ssd_scan_bwd_plain(*_t(x, dt, A, B, C, dy, dstate), chunk=chunk)
    assert got[3].is_contiguous() and got[4].is_contiguous()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    for name, g, w in zip(NAMES, got, _jax_grads(x, dt, A, B, C, dy, dstate, chunk)):
        torch.testing.assert_close(g, torch.from_numpy(w), **SSD_TOL, msg=lambda m, name=name: f"{name}: {m}")


@pytest.mark.parametrize("p,p_tile", [(64, 64), (100, 64), (48, 16)])
def test_partials_over_p_tiles_sum_to_the_whole(p, p_tile):
    """What the kernel's layout rests on: the state's rows over p are
    independent, so the backward of each p tile alone gives that tile's dx
    and partial dB, dC, ddt and dA, which sum over the tiles (the second
    kernel's fixed-order sum) to the whole."""
    x, dt, A, B, C, dy, dstate = _t(*_inputs(2, 64, 3, p, 16, seed=4))
    whole = ssd.ssd_scan_bwd_plain(x, dt, A, B, C, dy, dstate, chunk=16)
    parts = [ssd.ssd_scan_bwd_plain(x[..., r : r + p_tile], dt, A, B, C, dy[..., r : r + p_tile],
                                    dstate[:, :, r : r + p_tile], chunk=16) for r in range(0, p, p_tile)]
    joined = [torch.cat([q[0] for q in parts], dim=-1)] + [sum(q[i] for q in parts) for i in range(1, 5)]
    _near(joined, whole, ROUNDOFF, f"p tiles of {p_tile} over p {p}")


def test_plain_scan_gradient_is_finite_where_the_decay_spans_more_than_fp32():
    """Autograd through ``ssd_scan_plain`` at chunk 64 where the log decay
    over a chunk passes fp32's exponent range: the masked panel's
    exponentials above the diagonal overflow, and masking after the exp
    gave NaN gradients of dt and A where ``jax.grad`` of ``ssd_chunked``
    (which masks before) gives finite ones."""
    x, dt, A, B, C, dy, dstate = _inputs(1, 128, 2, 8, 16, seed=5)
    dt = dt * 4.0
    x_, dt_, A_, B_, C_, dy_, ds_ = _t(x, dt, A, B, C, dy, dstate)
    cum = torch.cumsum(dt_[0, :64] * A_, dim=0)
    assert (cum[0] - cum[-1]).max().item() > 88.7  # exp of it overflows fp32
    got = _autograd(x_, dt_, A_, B_, C_, dy_, ds_, 64)
    assert all(torch.isfinite(g).all() for g in got)
    for name, g, w in zip(NAMES, got, _jax_grads(x, dt, A, B, C, dy, dstate, 64)):
        torch.testing.assert_close(g, torch.from_numpy(w), **SSD_TOL, msg=lambda m, name=name: f"{name}: {m}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use", ["y and state", "y", "state"])
def test_autograd_function_matches_the_plain_path(use, dtype):
    """``ops._SsdScan`` with both kernel calls swapped for their plain
    versions: its gradients equal autograd through the plain scan, which
    catches a swapped output, a wrong cast or a dropped dstate; the
    backward gets dstate None where the final state is unused, and dy of
    zeros where only the state is."""
    x, dt, A, B, C, dy, dstate = _t(*_inputs(2, 32, 3, 16, 8, seed=6))
    x, B, C, dy = (t.to(dtype) for t in (x, B, C, dy))
    seen = []

    def bwd(*args, chunk):
        seen.append(args[-1])
        return ssd.ssd_scan_bwd_plain(*args, chunk=chunk)

    def loss(y, state):
        out = torch.zeros((), dtype=torch.float32)
        if "y" in use:
            out = out + (y.float() * dy.float()).sum()
        if "state" in use:
            out = out + (state * dstate).sum()
        return out

    ins = [t.clone().requires_grad_() for t in (x, dt, A, B, C)]
    with mock.patch.object(ssd, "ssd_scan", ssd.ssd_scan_plain), mock.patch.object(ssd, "ssd_scan_bwd", bwd):
        got = torch.autograd.grad(loss(*ops._SsdScan.apply(*ins, 8)), ins)
    assert (seen[0] is None) == (use == "y")
    ref = [t.clone().requires_grad_() for t in (x, dt, A, B, C)]
    want = torch.autograd.grad(loss(*ssd.ssd_scan_plain(*ref, chunk=8)), ref, allow_unused=True)
    want = [torch.zeros_like(t) if w is None else w for w, t in zip(want, ref)]  # the state alone does not read C
    assert [g.dtype for g in got] == [t.dtype for t in ins]
    # bf16: the Function rounds dx, dB and dC to bf16 once, autograd through the plain scan at each cast
    _near(got, want, ROUNDOFF if dtype == torch.float32 else 1e-2, f"{use}, {dtype}")


def test_ops_ssd_scan_on_the_cpu_stays_on_the_plain_path_under_autograd():
    x, dt, A, B, C, _, _ = _t(*_inputs(1, 16, 2, 8, 8, seed=7))
    x.requires_grad_()
    y, _ = ops.ssd_scan(x, dt, A, B, C, chunk=8)
    assert y.grad_fn is not None and "SsdScan" not in type(y.grad_fn).__name__


def test_bwd_wrapper_refuses_cpu_tensors():
    x, dt, A, B, C, dy, _ = _t(*_inputs(1, 16, 2, 8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        ssd.ssd_scan_bwd(x, dt, A, B, C, dy, chunk=8)


@pytest.mark.parametrize("arch_n", [128, 64])
def test_bwd_block_fits_shared_memory_at_the_training_shapes(arch_n):
    """mamba2-130m (state 128) and zamba2-2.7b (state 64) at chunk 64, p 64:
    one backward block's shared memory fits the H100's 227 KB."""
    assert ssd.bwd_smem_bytes(64, arch_n, min(64, ssd.BWD_P_TILE)) <= ssd.MAX_SMEM_BYTES


# (b, l, h, p, n, chunk, head group): chunks 16 and 64, one chunk and several, groups of 1 to all heads
DECOMPOSED = [
    (2, 64, 6, 16, 8, 16, 1),
    (2, 64, 6, 16, 8, 16, 3),
    (1, 128, 4, 32, 16, 64, 2),
    (2, 192, 3, 64, 32, 64, 3),
    (1, 64, 2, 64, 16, 64, 1),
]


@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("b,l,h,p,n,chunk,group", DECOMPOSED)
def test_the_mma_route_kernels_plain_versions_compose_to_the_backward(b, l, h, p, n, chunk, group, with_state):
    """What the ``"mma"`` route rests on: the states kernel's H_in and
    dH_out per chunk, each chunk's backward given them with dB and dC summed
    over a head group, and the fixed-order sum of the groups' and chunks'
    parts give ``ssd_scan_bwd_plain``'s gradients to fp32 round-off."""
    x, dt, A, B, C, dy, dstate = _t(*_inputs(b, l, h, p, n, seed=8))
    dstate = dstate if with_state else None
    h_in, dh_out = ssd.bwd_states_plain(x, dt, A, B, C, dy, dstate, chunk=chunk)
    nc = l // chunk
    assert h_in.shape == dh_out.shape == (b, h, nc, p, n)
    assert torch.equal(h_in[:, :, 0], torch.zeros_like(h_in[:, :, 0]))
    assert torch.equal(dh_out[:, :, -1], torch.zeros_like(dh_out[:, :, -1]) if dstate is None else dstate)
    dx, ddt, pdA, pdB, pdC = ssd.bwd_chunk_plain(x, dt, A, B, C, dy, h_in, dh_out, chunk=chunk, head_group=group)
    assert pdA.shape == (b, nc, h) and pdB.shape == pdC.shape == (b, l, h // group, n)
    dB, dC, dA = ssd.bwd_sum_plain(pdB, pdC, pdA, B.dtype)
    _near((dx, ddt, dA, dB, dC), ssd.ssd_scan_bwd_plain(x, dt, A, B, C, dy, dstate, chunk=chunk), ROUNDOFF,
          f"composed, head group {group}")


def test_the_states_are_the_forward_states_and_their_gradients():
    """H_in of the chunk after the last is the forward's final state, and
    dH_out is the gradient autograd gives the state leaving each chunk."""
    x, dt, A, B, C, dy, dstate = _t(*_inputs(1, 128, 2, 16, 8, seed=9))
    h_in, dh_out = ssd.bwd_states_plain(x, dt, A, B, C, dy, dstate, chunk=32)
    _, final = ssd.ssd_scan_plain(x, dt, A, B, C, chunk=32)
    # the last chunk's H_out: its H_in carried over it, plus what it adds (the forward over that chunk alone)
    cum = torch.cumsum(dt[:, 96:] * A, dim=1)
    _, own = ssd.ssd_scan_plain(x[:, 96:], dt[:, 96:], A, B[:, 96:], C[:, 96:], chunk=32)
    carried = h_in[:, :, -1] * torch.exp(cum[:, -1])[..., None, None] + own
    torch.testing.assert_close(carried, final, rtol=ROUNDOFF, atol=ROUNDOFF)
    # dH_out of chunk 2 is the gradient of the state entering chunk 3: the scan of chunk 3 from that state
    h3 = h_in[:, :, 3].clone().requires_grad_()
    y_state = torch.exp(cum)[..., None] * torch.einsum("bln,bhpn->blhp", C[:, 96:], h3)
    fin = h3 * torch.exp(cum[:, -1])[..., None, None]
    (grad,) = torch.autograd.grad((y_state * dy[:, 96:]).sum() + (fin * dstate).sum(), h3)
    torch.testing.assert_close(dh_out[:, :, 2], grad, rtol=ROUNDOFF, atol=ROUNDOFF)


@pytest.mark.parametrize("arch,h,n", [("mamba2-130m", 24, 128), ("zamba2-2.7b", 80, 64)])
def test_the_training_shapes_take_the_mma_route(arch, h, n):
    """Both training shapes (bf16, chunk 64, p 64, B and C strided slices
    with 16-byte-aligned rows) take a tensor-core route: ``"wgmma"``, which
    replaced ``"mma"`` there and keeps its states and sum kernels; the
    ``"mma"`` route, still run by ``run_bwd_route`` beside it, keeps its
    three kernels, its blocks fit the H100's shared memory and the chunk
    kernel's grid puts at least a block on each of the 132 SMs."""
    assert ssd.bwd_route(torch.bfloat16, 64, n, 64, True) == "wgmma"
    assert ssd.bwd_kernels("wgmma", torch.bfloat16, n)[::2] == ssd.bwd_kernels("mma", torch.bfloat16, n)[::2]
    assert ssd.bwd_kernels("mma", torch.bfloat16, n) == (
        f"ssd_scan_bwd_states_mma_kernel<{n}>", f"ssd_scan_bwd_chunk_mma_kernel<{n}>",
        "ssd_scan_bwd_mma_sum_kernel<__nv_bfloat16>")
    assert all(s <= ssd.MAX_SMEM_BYTES for s in ssd.mma_bwd_smem_bytes(n))
    states, chunks, _ = ssd.mma_bwd_grid(4, 512, h, n)
    assert chunks >= ssd.H100_SMS and states >= ssd.H100_SMS
    assert ssd.bwd_head_group(4, 512, h) == {"mamba2-130m": 3, "zamba2-2.7b": 10}[arch]


@pytest.mark.parametrize("dtype,p,n,chunk,aligned,want", [
    (torch.float32, 64, 128, 64, True, ("simt", ("ssd_scan_bwd_kernel<float>", "ssd_scan_bwd_sum_kernel<float>"))),
    (torch.bfloat16, 16, 16, 8, True,  # the smoke configs' chunk 8
     ("simt", ("ssd_scan_bwd_kernel<__nv_bfloat16>", "ssd_scan_bwd_sum_kernel<__nv_bfloat16>"))),
    (torch.bfloat16, 64, 128, 64, False,  # rows only 8-byte aligned
     ("simt", ("ssd_scan_bwd_kernel<__nv_bfloat16>", "ssd_scan_bwd_sum_kernel<__nv_bfloat16>"))),
    (torch.bfloat16, 64, 128, 32, True,
     ("simt", ("ssd_scan_bwd_kernel<__nv_bfloat16>", "ssd_scan_bwd_sum_kernel<__nv_bfloat16>"))),
    (torch.bfloat16, 48, 64, 64, True,
     ("simt", ("ssd_scan_bwd_kernel<__nv_bfloat16>", "ssd_scan_bwd_sum_kernel<__nv_bfloat16>"))),
    (torch.bfloat16, 64, 32, 64, True,
     ("simt", ("ssd_scan_bwd_kernel<__nv_bfloat16>", "ssd_scan_bwd_sum_kernel<__nv_bfloat16>"))),
])
def test_bwd_route_keeps_the_simt_kernel_outside_the_mma_shapes(dtype, p, n, chunk, aligned, want):
    route = ssd.bwd_route(dtype, p, n, chunk, aligned)
    assert (route, ssd.bwd_kernels(route, dtype, n)) == want


def test_bwd_route_and_kernels_refuse_what_they_do_not_have():
    with pytest.raises(TypeError):
        ssd.bwd_route(torch.float16, 64, 128, 64, True)
    with pytest.raises(ValueError, match="no backward route"):
        ssd.bwd_kernels("tma", torch.bfloat16, 128)


@pytest.mark.parametrize("b,l,h", [(4, 512, 24), (4, 512, 80), (1, 128, 6), (2, 256, 7), (8, 2048, 32)])
def test_bwd_head_group_divides_the_heads_and_fills_the_card_where_it_can(b, l, h):
    group = ssd.bwd_head_group(b, l, h)
    fits = [d for d in range(1, h + 1) if h % d == 0 and b * (l // 64) * (h // d) >= ssd.H100_SMS]
    assert h % group == 0 and (group in fits or not fits)


# ---------------------------------------------------------------------------
# The "wgmma" route: the forward's chunk states carried into the backward, its chunk kernel's order
# ---------------------------------------------------------------------------

#: (b, l, h, n) of the training shapes and the mesh ranks' (p 64, chunk 64): mamba2-130m and zamba2-2.7b
#: whole, each at a (1, 2) rank's heads, zamba2-2.7b x train_4k as rank 0 of (16, 16)
WGMMA_SHAPES = [(4, 512, 24, 128), (4, 512, 80, 64), (4, 512, 12, 128), (4, 512, 40, 64), (16, 4096, 5, 64)]


@pytest.mark.parametrize("b,l,h,p,n,chunk", [(2, 128, 3, 16, 8, 32), (1, 256, 2, 64, 32, 64), (2, 64, 2, 8, 16, 16)])
def test_the_forward_states_are_the_backward_states(b, l, h, p, n, chunk):
    """What the backward reading the forward's states rests on: H_in from
    the forward's steps (``fwd_states_plain`` then ``fwd_pass_plain``) is
    ``bwd_states_plain``'s H_in to fp32 round-off, chunk 0's zero included;
    carried across the last chunk it is the final state of the reference's
    ``ssd_chunked(return_state=True)`` at the reference's tolerance."""
    x, dt, A, B, C, dy, dstate = _inputs(b, l, h, p, n, seed=10)
    xt, dtt, At, Bt, Ct, dyt, dst = _t(x, dt, A, B, C, dy, dstate)
    h_fwd, last = ssd.fwd_pass_plain(*ssd.fwd_states_plain(xt, dtt, At, Bt, chunk=chunk))
    h_bwd, _ = ssd.bwd_states_plain(xt, dtt, At, Bt, Ct, dyt, dst, chunk=chunk)
    assert h_fwd.shape == h_bwd.shape == (b, h, l // chunk, p, n)
    assert torch.equal(h_fwd[:, :, 0], torch.zeros_like(h_fwd[:, :, 0]))
    torch.testing.assert_close(h_fwd, h_bwd, rtol=ROUNDOFF, atol=ROUNDOFF * h_bwd.abs().max().item())
    # the last chunk carried from its H_in: exp(cum_last) H_in + its own part
    ds, dec = ssd.fwd_states_plain(xt, dtt, At, Bt, chunk=chunk)
    carried = h_fwd[:, :, -1] * dec[:, :, -1, None, None] + ds[:, :, -1]
    torch.testing.assert_close(carried, last, rtol=0, atol=0)
    _, want = jblocks.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, B, C)), chunk, return_state=True)
    torch.testing.assert_close(carried, torch.from_numpy(np.asarray(want)), **SSD_TOL)


def _plain_states(x, dt, A, B, C, *, chunk):
    """What ``ssd_scan.ssd_scan_states`` returns on the ``wgmma`` route, by the forward's plain steps."""
    y, state = ssd.ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
    h_in, _ = ssd.fwd_pass_plain(*ssd.fwd_states_plain(x, dt, A, B, chunk=chunk))
    return y, state, h_in


@pytest.mark.parametrize("keep", [True, False])
@pytest.mark.parametrize("use", ["y and state", "y"])
def test_autograd_function_hands_its_backward_the_forward_states(use, keep):
    """``ops._SsdScan`` with its kernel calls swapped for plain versions,
    inside ``torch.utils.checkpoint`` as ``transformer._recompute`` runs a
    layer (``ops.keeping_scan_states``): the backward is handed the states
    of the forward that ran just before it (the recomputation), which equal
    ``bwd_states_plain``'s H_in, and its gradients equal autograd through
    the plain scan and ``jax.grad`` of ``ssd_chunked``.  Without the
    wrapper the forward keeps nothing and the backward rebuilds them."""
    from torch.utils.checkpoint import checkpoint

    b, l, h, p, n, chunk = 2, 64, 3, 16, 8, 16
    x, dt, A, B, C, dy, dstate = _inputs(b, l, h, p, n, seed=11)
    seen, fwd = [], []

    def states(*args, chunk):
        out = _plain_states(*args, chunk=chunk)
        fwd.append(out[2])
        return out

    def bwd(x_, dt_, A_, B_, C_, dy_, ds_, *, chunk, h_in=None):
        seen.append(h_in)
        return ssd.ssd_scan_bwd_plain(x_, dt_, A_, B_, C_, dy_, ds_, chunk=chunk)

    def layer(*ins):
        y, state = ops._SsdScan.apply(*ins, chunk)
        return (y * torch.from_numpy(dy)).sum() + ((state * torch.from_numpy(dstate)).sum() if "state" in use else 0.0)

    ins = [t.clone().requires_grad_() for t in _t(x, dt, A, B, C)]
    with mock.patch.object(ssd, "ssd_scan_states", states), mock.patch.object(ssd, "ssd_scan", ssd.ssd_scan_plain), \
            mock.patch.object(ssd, "ssd_scan_bwd", bwd):
        loss = checkpoint(ops.keeping_scan_states(layer) if keep else layer, *ins, use_reentrant=False)
        got = torch.autograd.grad(loss, ins)
    assert len(seen) == 1 and ops._KEEP_STATES == 0
    if keep:
        assert len(fwd) == 2 and seen[0] is fwd[1]  # the recomputed forward's, not the first one's
        h_bwd, _ = ssd.bwd_states_plain(*_t(x, dt, A, B, C, dy), None, chunk=chunk)
        torch.testing.assert_close(seen[0], h_bwd, rtol=ROUNDOFF, atol=ROUNDOFF * h_bwd.abs().max().item())
    else:
        assert fwd == [] and seen == [None]
    ref = [t.clone().requires_grad_() for t in _t(x, dt, A, B, C)]
    y, state = ssd.ssd_scan_plain(*ref, chunk=chunk)
    want_loss = (y * torch.from_numpy(dy)).sum() + ((state * torch.from_numpy(dstate)).sum() if "state" in use else 0)
    _near(got, torch.autograd.grad(want_loss, ref), ROUNDOFF, f"{use}, keep {keep}")
    for name, g, w in zip(NAMES, got, _jax_grads(x, dt, A, B, C, dy, dstate if "state" in use else None, chunk)):
        torch.testing.assert_close(g, torch.from_numpy(w), **SSD_TOL, msg=lambda m, name=name: f"{name}: {m}")


def test_a_plain_forward_keeps_no_states_for_its_backward():
    """Outside ``keeping_scan_states`` (a layer with no remat: its backward
    comes after every later layer's forward) ``_SsdScan`` saves its inputs
    alone; the wrapper's count is back at 0 after a layer that raised."""
    x, dt, A, B, C, _, _ = _t(*_inputs(1, 32, 2, 8, 8, seed=12))
    ins = [t.clone().requires_grad_() for t in (x, dt, A, B, C)]
    with mock.patch.object(ssd, "ssd_scan", ssd.ssd_scan_plain), \
            mock.patch.object(ssd, "ssd_scan_states", lambda *a, **k: pytest.fail("states kept")):
        y, _ = ops._SsdScan.apply(*ins, 8)
    assert [t is None for t in y.grad_fn.saved_tensors] == [False] * 5 + [True]

    def boom():
        raise RuntimeError("layer failed")

    with pytest.raises(RuntimeError, match="layer failed"):
        ops.keeping_scan_states(boom)()
    assert ops._KEEP_STATES == 0


@pytest.mark.parametrize("b,l,h,n", WGMMA_SHAPES)
def test_the_training_and_rank_shapes_take_the_wgmma_route(b, l, h, n):
    """The training shapes and the mesh ranks' take ``"wgmma"``; its
    launches are the states kernel, the wgmma chunk kernel (TMA loads where
    the rows allow, else cp.async) and the sum, in that order; the chunk
    kernel's shared memory fits the H100's 232,448 B at the shape's head
    group, its grid fills the 132 SMs, and given the forward's states the
    states kernel launches half the ``"mma"`` route's blocks, the
    gradients' direction alone."""
    bf = torch.bfloat16
    assert ssd.bwd_route(bf, 64, n, 64, True) == "wgmma"
    for tma in (True, False):
        assert ssd.bwd_kernels("wgmma", bf, n, tma) == (
            f"ssd_scan_bwd_states_mma_kernel<{n}>", f"ssd_scan_bwd_chunk_kernel<{n}, {'true' if tma else 'false'}>",
            "ssd_scan_bwd_mma_sum_kernel<__nv_bfloat16>")
    hg = ssd.bwd_head_group(b, l, h)
    assert ssd.wgmma_bwd_smem_bytes(n, hg) <= ssd.MAX_SMEM_BYTES
    states, chunks, sums = ssd.wgmma_bwd_grid(b, l, h, n)
    carried = ssd.wgmma_bwd_grid(b, l, h, n, carried=True)
    assert chunks >= ssd.H100_SMS and (states, chunks, sums) == ssd.mma_bwd_grid(b, l, h, n)
    assert carried == (states // 2, chunks, sums) and states == b * h * (n // 64) * 2


@pytest.mark.parametrize("n,hg,want", [(128, 3, 227_168), (64, 10, 163_424), (64, 5, 162_144), (128, 12, 229_472)])
def test_wgmma_chunk_kernel_shared_memory_by_its_parts(n, hg, want):
    """The chunk kernel's shared memory, counted by hand from the source
    note's parts: 1 KB of slack, (2 + 4 + 3 + 6 + 1) boxes of 8 KB at state
    64 and (4 + 4 + 3 + 12 + 1) at 128 (C and B, the x and dy ring, the
    planes of (C·Bᵀ)∘L, of H and dH, dx's tile), 16 KB of fp32 fragments,
    32 B of barriers, dt of the heads, 6 KB of factors and 6,208 B of
    partials."""
    assert ssd.wgmma_bwd_smem_bytes(n, hg) == want


def _terms(t: torch.Tensor, k: int = ssd.MMA_TERMS) -> list[torch.Tensor]:
    """``t`` (fp32) as ``k`` bf16 terms, largest first, each the rounding of what the earlier ones left."""
    out, rest = [], t
    for _ in range(k):
        q = rest.to(torch.bfloat16).float()
        out.append(q)
        rest = rest - q
    return out


def _smallest_first(eq: str, terms: list[torch.Tensor], other: torch.Tensor, first: bool = True) -> torch.Tensor:
    """Σ over ``terms`` of their products with ``other`` (``eq``), summed smallest term first, as each
    product of the wgmma chunk kernel accumulates its bf16 planes."""
    out = None
    for q in reversed(terms):
        part = torch.einsum(eq, q, other) if first else torch.einsum(eq, other, q)
        out = part if out is None else out + part
    return out


def _wgmma_chunk_model(x, dt, A, B, C, dy, h_in, dh_out, *, chunk, head_group):
    """``bwd_chunk_plain`` in the order of ``ssd_scan_bwd_chunk_kernel``:
    every fp32 operand ((C·Bᵀ)∘L, H, dH, Σ W) as 3 bf16 terms whose
    products sum smallest first; d(cum)'s per-step parts grouped as its
    warps write them (M's row sums per half of the columns, its column sums
    per 16 rows, exp(cum)∘(dy·H)∘C per 64 state columns, the dxdt and
    x∘(B·dHᵀ) sums per half of p, the carry per 8 warps' share) and
    summed in that order."""
    b, l, h, p = x.shape
    n, nc, groups = B.shape[-1], l // chunk, h // head_group
    xf, dyf, dtf, Bf, Cf, cum, ecum, wend = ssd._chunked(x, dt, A, B, C, dy, chunk)
    hin, dho = h_in.float().transpose(1, 2), dh_out.float().transpose(1, 2)
    idx = torch.arange(chunk)
    causal = (idx[:, None] >= idx[None, :])[:, :, None]
    ldec = torch.exp(torch.where(causal, cum[:, :, :, None, :] - cum[:, :, None, :, :], float("-inf")))
    g = torch.einsum("bcln,bcsn->bcls", Cf, Bf)
    w = ldec * torch.einsum("bclhp,bcshp->bclsh", dyf, xf) * dtf[:, :, None]
    m = g[..., None] * w
    gl = g[..., None] * ldec  # [b, c, l, s, h]
    dc = _smallest_first("bclsh,bclhp->bcshp", _terms(gl), dyf)
    dd = _smallest_first("bchpn,bcsn->bcshp", _terms(dho), Bf)
    dxdt = dc + wend[..., None] * dd
    e = _smallest_first("bchpn,bclhp->bclhn", _terms(hin), dyf)
    f = _smallest_first("bchpn,bcshp->bcshn", _terms(dho), xf)
    dc_inter, db_inter = ecum[..., None] * e, (wend * dtf)[..., None] * f
    half = chunk // 2
    rows = m[:, :, :, :half].sum(3) + m[:, :, :, half:].sum(3)
    cols = sum(m[:, :, r : r + 16].sum(2) for r in range(0, chunk, 16))
    yoff = sum((dc_inter * Cf[:, :, :, None])[..., k : k + 64].sum(-1) for k in range(0, n, 64))
    su = sum((xf * dd)[..., k : k + p // 2].sum(-1) for k in range(0, p, p // 2))
    ddir = sum((dxdt * xf)[..., k : k + p // 2].sum(-1) for k in range(0, p, p // 2))
    carry = torch.exp(cum[:, :, -1]) * (dho * hin).sum((-2, -1)) + (db_inter * Bf[:, :, :, None]).sum((2, 4))
    dcum = rows - cols + yoff - wend * dtf * su
    dcum[:, :, -1] += carry
    dla = torch.flip(torch.cumsum(torch.flip(dcum, [2]), dim=2), [2])
    ddt = dla * A.float() + ddir
    wsum = _terms(w.reshape(b, nc, chunk, chunk, groups, head_group).sum(-1))
    pdC = (_smallest_first("bclsg,bcsn->bclgn", wsum, Bf)
           + dc_inter.reshape(b, nc, chunk, groups, head_group, n).sum(4))
    pdB = (_smallest_first("bclsg,bcln->bcsgn", wsum, Cf)
           + db_inter.reshape(b, nc, chunk, groups, head_group, n).sum(4))
    dx = dxdt * dtf[..., None]
    return (dx.reshape(b, l, h, p).to(x.dtype), ddt.reshape(b, l, h), (dla * dtf).sum(2),
            pdB.reshape(b, l, groups, n), pdC.reshape(b, l, groups, n))


@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("b,l,h,n,group", [(1, 128, 4, 64, 2), (2, 192, 3, 128, 3), (1, 64, 2, 64, 1)])
def test_the_wgmma_chunk_kernels_order_composes_to_the_backward(b, l, h, n, group, with_state):
    """A plain model of the order the wgmma chunk kernel sums in (its bf16
    terms, smallest first; d(cum)'s partials as its warps group them), on
    the forward's states, composed with the states kernel's dH_out and the
    fixed-order sum, gives ``ssd_scan_bwd_plain``'s gradients to fp32
    round-off, and ``bwd_chunk_plain``'s chunk outputs likewise."""
    x, dt, A, B, C, dy, dstate = _t(*_inputs(b, l, h, 64, n, seed=13))
    dstate = dstate if with_state else None
    h_in, _ = ssd.fwd_pass_plain(*ssd.fwd_states_plain(x, dt, A, B, chunk=64))
    _, dh_out = ssd.bwd_states_plain(x, dt, A, B, C, dy, dstate, chunk=64)
    got = _wgmma_chunk_model(x, dt, A, B, C, dy, h_in, dh_out, chunk=64, head_group=group)
    plain = ssd.bwd_chunk_plain(x, dt, A, B, C, dy, h_in, dh_out, chunk=64, head_group=group)
    for name, u, v in zip(("dx", "ddt", "pdA", "pdB", "pdC"), got, plain):
        assert (u - v).abs().max().item() <= ROUNDOFF * v.abs().max().item(), name
    dB, dC, dA = ssd.bwd_sum_plain(got[3], got[4], got[2], B.dtype)
    _near((got[0], got[1], dA, dB, dC), ssd.ssd_scan_bwd_plain(x, dt, A, B, C, dy, dstate, chunk=64), ROUNDOFF,
          f"the wgmma chunk kernel's order, head group {group}")


@pytest.mark.parametrize("n", [64, 128])
def test_three_bf16_terms_carry_an_fp32_state(n):
    """What the planes rest on: the 3 bf16 terms of each fp32 state element
    (H, dH at the training shapes' widths, normal numbers) sum back to it
    exactly, and one or two terms do not."""
    x, dt, A, B, C, dy, dstate = _t(*_inputs(1, 256, 2, 64, n, seed=14))
    h_in, _ = ssd.fwd_pass_plain(*ssd.fwd_states_plain(x, dt, A, B, chunk=64))
    h = h_in[:, :, 1:]
    terms = _terms(h)
    assert torch.equal(terms[0] + terms[1] + terms[2], h)
    assert not torch.equal(terms[0] + terms[1], h) and not torch.equal(terms[0], h)
