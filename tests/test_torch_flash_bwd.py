"""The port's flash-attention gradient against ``jax.grad`` of the reference's attention, on the CPU.

The reference has no backward kernel: it trains through XLA's
``blocks._sdpa`` (its stand-in for the flash kernel), so the specification
of the port's backward is ``jax.grad`` of ``_sdpa`` (at ``q_offset`` 0), and
of ``kernels/ref.py::attention_ref`` where it applies (Sq = Skv, no window).
Both of the port's plain forms are held to it: autograd through
``flash_attention_plain``, and ``flash_attention_bwd_plain`` (the explicit
formulas the CUDA kernels compute, from the forward's o and log-sum-exp).
Inputs are seeded numpy, fp32 on both sides; tolerance 2e-4, the
reference's attention tolerance.  The CUDA kernels themselves are held to
``flash_attention_bwd_plain`` by ``tests/test_torch_gpu.py`` and
``chip_smoke.py`` on the card.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # CI installs requirements-dev.txt, which has no torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.kernels import ref as jref
from repro.models import blocks as jblocks
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gemm as gm
from repro_torch.kernels import ops

ATTN_TOL = dict(rtol=2e-4, atol=2e-4)

# (b, h, kvh, sq, skv, d, causal, window): every head dim, GQA groups 1 to 8,
# ragged lengths, Sq != Skv both ways, windows (1: every row sees one key)
GRID = [
    (2, 4, 4, 16, 16, 16, True, 0),
    (2, 4, 2, 20, 20, 32, True, 0),
    (1, 6, 2, 13, 13, 64, False, 0),
    (1, 5, 1, 24, 24, 80, True, 7),
    (1, 4, 2, 9, 9, 128, False, 5),
    (1, 2, 1, 12, 12, 192, True, 0),
    (2, 4, 2, 8, 20, 32, True, 0),
    (1, 4, 4, 20, 8, 16, True, 0),
    (1, 8, 1, 1, 20, 64, False, 0),
    (1, 4, 2, 20, 8, 32, False, 16),
    (1, 4, 2, 16, 16, 32, True, 1),
    (1, 8, 1, 12, 12, 16, True, 0),
]


def _inputs(b, h, kvh, sq, skv, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d), dtype=np.float32),
            rng.standard_normal((b, kvh, skv, d), dtype=np.float32),
            rng.standard_normal((b, kvh, skv, d), dtype=np.float32),
            rng.standard_normal((b, h, sq, d), dtype=np.float32))


@functools.cache
def _sdpa_grad_cached(key, causal, window):
    return _sdpa_grad_uncached(*(np.frombuffer(b, np.float32).reshape(sh) for b, sh in key), causal=causal,
                               window=window)


def _sdpa_grad(q, k, v, do, *, causal, window):
    """:func:`_sdpa_grad_uncached`, computed once for the same inputs."""
    return _sdpa_grad_cached(tuple((a.tobytes(), a.shape) for a in (q, k, v, do)), causal, window)


def _sdpa_grad_uncached(q, k, v, do, *, causal, window):
    """``jax.grad`` of <_sdpa(q, k, v), do> on [B, H, S, D] numpy arrays, q
    chunks of 4 (the chunked path runs where Sq divides), -> dq, dk, dv."""
    b, h, sq, d = q.shape
    cfg = dataclasses.replace(jconfigs.get_smoke("granite-3-2b"), dtype=jnp.float32, attn_q_block=4,
                              n_heads=h, n_kv_heads=k.shape[1], head_dim=d)
    t = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3))

    def f(q, k, v):
        out = jblocks._sdpa(cfg, q, k, v, causal=causal, window=window).reshape(b, sq, h, d)
        return jnp.sum(out * t(do))

    return [np.asarray(g).transpose(0, 2, 1, 3) for g in jax.grad(f, argnums=(0, 1, 2))(t(q), t(k), t(v))]


def _close(got, want):
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.detach().numpy(), w, **ATTN_TOL)


@pytest.mark.parametrize("form", ["autograd through plain", "bwd_plain"])
@pytest.mark.parametrize("b,h,kvh,sq,skv,d,causal,window", GRID)
def test_plain_gradients_match_jax_grad_of_sdpa(b, h, kvh, sq, skv, d, causal, window, form):
    q, k, v, do = _inputs(b, h, kvh, sq, skv, d)
    want = _sdpa_grad(q, k, v, do, causal=causal, window=window)
    if form == "bwd_plain":
        qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
        o, lse = fa.flash_attention_fwd_plain(qt, kt, vt, causal=causal, window=window)
        _close(fa.flash_attention_bwd_plain(qt, kt, vt, o, lse, dot, causal=causal, window=window), want)
    else:
        qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        out = fa.flash_attention_plain(qt, kt, vt, causal=causal, window=window)
        _close(torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do)), want)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kvh,s,d", [(4, 4, 16, 32), (4, 2, 24, 64), (8, 1, 12, 128), (6, 2, 10, 80)])
def test_bwd_plain_matches_jax_grad_of_attention_ref(h, kvh, s, d, causal):
    q, k, v, do = _inputs(2, h, kvh, s, s, d, seed=2)
    f = lambda q, k, v: jnp.sum(jref.attention_ref(q, k, v, causal=causal) * do)
    want = [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))]
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = fa.flash_attention_fwd_plain(qt, kt, vt, causal=causal)
    _close(fa.flash_attention_bwd_plain(qt, kt, vt, o, lse, dot, causal=causal), want)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 5), (False, 3)])
def test_fwd_plain_lse_is_the_logsumexp_of_the_scaled_masked_scores(causal, window):
    q, k, v, _ = _inputs(2, 4, 2, 11, 14, 16, seed=3)
    o, lse = fa.flash_attention_fwd_plain(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal, window=window)
    s = np.einsum("bkgqd,bksd->bkgqs", q.reshape(2, 2, 2, 11, 16).astype(np.float64), k) / 4.0
    i, j = np.arange(11)[:, None], np.arange(14)[None, :]
    mask = np.ones((11, 14), bool) & ((j <= i) if causal else True) & ((i - j < window) if window else True)
    s = np.where(mask, s, -np.inf)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0].reshape(2, 4, 11)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(o, fa.flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                                                   window=window))


def test_bwd_plain_rounds_the_probabilities_to_v_dtype_for_dv_as_the_forward_does():
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(1, 2, 1, 9, 9, 16, seed=4))
    o, lse = fa.flash_attention_fwd_plain(q, k, v)
    dv = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)[2]
    p = torch.softmax(fa._scores(q, k, True, 0), -1)
    want = torch.einsum("bkgqs,bkgqd->bksd", p.to(torch.bfloat16).float(), do.float().reshape(1, 1, 2, 9, 16))
    assert dv.dtype == torch.bfloat16
    assert torch.equal(dv, want.to(torch.bfloat16))


@pytest.mark.parametrize("sq,skv,window,blind", [(20, 8, 5, True), (13, 8, 5, True), (12, 8, 5, False),
                                                 (20, 20, 3, False), (8, 8, 0, False)])
def test_bwd_refuses_rows_that_see_no_key(sq, skv, window, blind):
    """A row sees no key only where Sq >= Skv + window: its output is NaN."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 2, 1, sq, skv, 16, seed=5))
    o, lse = fa.flash_attention_fwd_plain(q, k, v, window=window)
    assert bool(torch.isnan(o).any()) == blind
    if blind:
        with pytest.raises(ValueError, match="see no key"):
            fa.flash_attention_bwd_plain(q, k, v, o, lse, do, window=window)
    else:
        assert all(torch.isfinite(g).all() for g in fa.flash_attention_bwd_plain(q, k, v, o, lse, do, window=window))


def test_ops_trains_cpu_tensors_through_the_plain_versions_without_launches():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 10, 10, 32, seed=6))
    before = fa.launches, fa.bwd_launches, gm.launches, gm.bwd_launches
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    got = torch.autograd.grad(ops.flash_attention(qa, ka, va, window=4), (qa, ka, va), do)
    qb, kb, vb = (t.clone().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(fa.flash_attention_plain(qb, kb, vb, window=4), (qb, kb, vb), do)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    a = torch.randn(3, 5, 7, dtype=torch.float32, requires_grad=True)
    w = torch.randn(3, 7, 4, dtype=torch.float32, requires_grad=True)
    da, dw = torch.autograd.grad(ops.gemm(a, w).sum(), (a, w))
    torch.testing.assert_close(da, torch.ones(3, 5, 4) @ w.detach().transpose(1, 2))
    torch.testing.assert_close(dw, a.detach().transpose(1, 2) @ torch.ones(3, 5, 4))
    x = torch.randn(1, 16, 2, 8, requires_grad=True)
    dt = torch.rand(1, 16, 2) + 0.1
    B, C = torch.randn(1, 16, 8), torch.randn(1, 16, 8)
    y, _ = ops.ssd_scan(x, dt, -torch.ones(2), B, C, chunk=8)
    assert torch.isfinite(torch.autograd.grad(y.sum(), x)[0]).all()
    assert (fa.launches, fa.bwd_launches, gm.launches, gm.bwd_launches) == before


def test_bwd_wrapper_refuses_cpu_tensors():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 16, 16, 32, seed=7))
    o, lse = fa.flash_attention_fwd_plain(q, k, v)
    before = fa.bwd_launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_bwd(q, k, v, o, lse, do)
    assert fa.bwd_launches == before


# The backward's route (flash_attention.bwd_route), the wgmma route's
# clusters (bwd_cluster) and the kernels each route launches (bwd_kernels):
# functions of shapes, strides and dtype alone, so they run here.

#: GQA group -> (blocks a cluster, q-heads a block): the largest divisor of G up to 8
CLUSTERS = {1: (1, 1), 2: (2, 1), 3: (3, 1), 4: (4, 1), 5: (5, 1), 6: (6, 1), 7: (7, 1), 8: (8, 1), 9: (3, 3),
            10: (5, 2), 11: (1, 11), 12: (6, 2), 13: (1, 13), 14: (7, 2), 15: (5, 3), 16: (8, 2)}


@pytest.mark.parametrize("g", sorted(CLUSTERS))
def test_bwd_cluster_is_the_largest_divisor_of_the_group_up_to_eight(g):
    for kvh in (1, 8):
        c, per = fa.bwd_cluster(g * kvh, kvh)
        assert (c, per) == CLUSTERS[g]
        assert c * per == g and c <= fa.PORTABLE_CLUSTER


def _layout(layout, d, dtype, b=2, h=4, s=24):
    """[b, h, s, d] CPU tensor: contiguous, the model's transposed [b, s, h, d]
    view, or rows of d + 4 elements (strides a multiple of 4 elements, not 8)."""
    if layout == "contiguous":
        return torch.zeros((b, h, s, d), dtype=dtype)
    if layout == "bshd":
        return torch.zeros((b, s, h, d), dtype=dtype).transpose(1, 2)
    return torch.zeros((b, s, h, d + 4), dtype=dtype)[..., :d].transpose(1, 2)


@pytest.mark.parametrize("layout", ["contiguous", "bshd", "padded"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_bwd_route_by_head_dim_dtype_and_strides(d, dtype, layout):
    q = _layout(layout, d, dtype)
    k = _layout(layout, d, dtype, h=2)
    if dtype == torch.float32:
        want = "simt"
    elif d in fa.WGMMA_HEAD_DIMS and layout != "padded":
        want = "wgmma"
    else:
        want = "mma"
    assert fa.bwd_route(q, k, k, q, q) == want


@pytest.mark.parametrize("which", range(5))
def test_bwd_route_needs_every_row_tma_can_address(which):
    """One of q, k, v, o, dO with rows only 8-byte aligned, or a base 8
    bytes off 16-byte alignment, takes the whole backward to the mma.sync
    route."""
    ts = [_layout("bshd", 64, torch.bfloat16, h=4 if i in (0, 3, 4) else 2) for i in range(5)]
    assert fa.bwd_route(*ts) == "wgmma"
    bad = list(ts)
    bad[which] = _layout("padded", 64, torch.bfloat16, h=ts[which].shape[1])
    assert fa.bwd_route(*bad) == "mma"
    shifted = torch.zeros(ts[which].numel() + 4, dtype=torch.bfloat16)[4:].view(ts[which].shape)
    assert shifted.data_ptr() % 16 == 8
    bad[which] = shifted
    assert fa.bwd_route(*bad) == "mma"


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_bwd_kernels_a_backward_launches(d):
    """Two launches on the wgmma route (dQ with delta, one dK/dV pass); on
    mma.sync the delta pre-pass, dQ and one dK/dV pass up to D 80, a dV and
    a dK pass above; three on the SIMT pipes."""
    assert fa.bwd_kernels("wgmma", d) == (f"flash_bwd_dq_wgmma_kernel<{d}>", f"flash_bwd_dkdv_wgmma_kernel<{d}>")
    mma = fa.bwd_kernels("mma", d)
    assert mma[:2] == ("flash_bwd_delta_kernel<__nv_bfloat16>", f"flash_bwd_dq_mma_bf16_kernel<{d}>")
    assert mma[2:] == ((f"flash_bwd_dkdv_mma_bf16_kernel<{d}, 1>", f"flash_bwd_dkdv_mma_bf16_kernel<{d}, 2>")
                       if d >= 128 else (f"flash_bwd_dkdv_mma_bf16_kernel<{d}, 3>",))
    assert fa.bwd_kernels("simt", d) == ("flash_bwd_delta_kernel<float>", f"flash_bwd_dq_kernel<{d}>",
                                         f"flash_bwd_dkdv_kernel<{d}>")
    with pytest.raises(ValueError, match="no backward route"):
        fa.bwd_kernels("tpu", d)
