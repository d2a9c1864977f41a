"""The port's attention and SSD kernel modules against the JAX package's (CPU).

Inputs come from numpy with a seed and go to both packages.  The plain
PyTorch versions (what a CPU tensor runs) are held against the Pallas
kernels in interpret mode and the reference oracles at the reference's grid
and tolerances (2e-4 for attention, 2e-3 for SSD); the sliding window and a
ragged length, which the Pallas kernel does not take, against the
reference's ``blocks._sdpa``; the final SSD state against
``blocks.ssd_chunked(return_state=True)``.  The CUDA kernels run only on the
card: ``tests/test_torch_gpu.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # CI installs requirements-dev.txt, which has no torch

import jax.numpy as jnp

from repro.configs import get_smoke
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import blocks as jblocks
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd

ATTN_TOL = dict(rtol=2e-4, atol=2e-4)
SSD_TOL = dict(rtol=2e-3, atol=2e-3)


def _attn_inputs(b, h, kvh, s, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, s, d), dtype=np.float32)
    k = rng.standard_normal((b, kvh, s, d), dtype=np.float32)
    v = rng.standard_normal((b, kvh, s, d), dtype=np.float32)
    return q, k, v


def _ssd_inputs(b, l, h, p, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p), dtype=np.float32)
    dt = np.logaddexp(rng.standard_normal((b, l, h), dtype=np.float32), 0).astype(np.float32)  # softplus
    A = -np.exp(0.5 * rng.standard_normal(h, dtype=np.float32))
    B = rng.standard_normal((b, l, n), dtype=np.float32)
    C = rng.standard_normal((b, l, n), dtype=np.float32)
    return x, dt, A, B, C


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kvh", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("s", [64, 128])
def test_attention_plain_matches_pallas_and_oracle(causal, h, kvh, s):
    q, k, v = _attn_inputs(2, h, kvh, s, 32)
    y = fa.flash_attention_plain(*_t(q, k, v), causal=causal).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    y_pallas = np.asarray(jops.flash_attention(jq, jk, jv, causal=causal, bq=32, bk=32))
    y_ref = np.asarray(jref.attention_ref(jq, jk, jv, causal=causal))
    np.testing.assert_allclose(y, y_pallas, **ATTN_TOL)
    np.testing.assert_allclose(y, y_ref, **ATTN_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_plain_matches_pallas_and_oracle_at_group_5(causal):
    """llama4-scout's grouping: 5 q heads per kv head, head dim 128."""
    q, k, v = _attn_inputs(1, 10, 2, 64, 128)
    y = fa.flash_attention_plain(*_t(q, k, v), causal=causal).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    y_pallas = np.asarray(jops.flash_attention(jq, jk, jv, causal=causal, bq=32, bk=32))
    y_ref = np.asarray(jref.attention_ref(jq, jk, jv, causal=causal))
    np.testing.assert_allclose(y, y_pallas, **ATTN_TOL)
    np.testing.assert_allclose(y, y_ref, **ATTN_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,h,kvh", [(80, 4, 4), (80, 12, 1), (192, 12, 1), (192, 24, 2)])
def test_attention_plain_matches_pallas_and_oracle_at_head_dims_80_and_192(d, h, kvh, causal):
    """zamba2-2.7b's head dim (80, MHA) and nemotron-4-340b's (192, GQA group 12)."""
    q, k, v = _attn_inputs(1, h, kvh, 64, d, seed=d)
    y = fa.flash_attention_plain(*_t(q, k, v), causal=causal).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    y_pallas = np.asarray(jops.flash_attention(jq, jk, jv, causal=causal, bq=32, bk=32))
    y_ref = np.asarray(jref.attention_ref(jq, jk, jv, causal=causal))
    np.testing.assert_allclose(y, y_pallas, **ATTN_TOL)
    np.testing.assert_allclose(y, y_ref, **ATTN_TOL)


@pytest.mark.parametrize("d", [80, 192])
@pytest.mark.parametrize("s,window,causal", [(100, 16, True), (77, 9, False), (50, 0, True)])
def test_attention_plain_window_and_ragged_match_sdpa_at_head_dims_80_and_192(d, s, window, causal):
    """A window and a ragged S at GQA group 12 against the reference model's _sdpa."""
    cfg = dataclasses.replace(get_smoke("granite-3-2b"), dtype=jnp.float32, attn_q_block=16, n_heads=12,
                              n_kv_heads=1, head_dim=d)
    q, k, v = _attn_inputs(1, cfg.n_heads, cfg.n_kv_heads, s, d, seed=s + window + d)
    y = fa.flash_attention_plain(*_t(q, k, v), causal=causal, window=window)
    y = y.transpose(1, 2).reshape(1, s, -1).numpy()
    bshd = [jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v)]
    y_ref = np.asarray(jblocks._sdpa(cfg, *bshd, causal=causal, window=window))
    np.testing.assert_allclose(y, y_ref, **ATTN_TOL)


@pytest.mark.parametrize(
    "s,window,causal",
    [(50, 0, True), (200, 0, True), (64, 7, True), (100, 16, True), (37, 5, False), (64, 64, True)],
)
def test_attention_plain_window_and_ragged_match_sdpa(s, window, causal):
    """Window and ragged S against the reference model's blockwise _sdpa
    (q chunks of 16, so the chunked path runs where S divides)."""
    cfg = dataclasses.replace(get_smoke("granite-3-2b"), dtype=jnp.float32, attn_q_block=16)
    q, k, v = _attn_inputs(2, cfg.n_heads, cfg.n_kv_heads, s, cfg.hd, seed=s + window)
    y = fa.flash_attention_plain(*_t(q, k, v), causal=causal, window=window)
    y = y.transpose(1, 2).reshape(2, s, -1).numpy()
    bshd = [jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v)]
    y_ref = np.asarray(jblocks._sdpa(cfg, *bshd, causal=causal, window=window))
    np.testing.assert_allclose(y, y_ref, **ATTN_TOL)


def test_attention_plain_rounds_probabilities_to_v_dtype():
    """bf16 inputs: p is cast to v.dtype before P.V, as the Pallas kernel does."""
    q, k, v = _t(*_attn_inputs(1, 2, 1, 16, 32))
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    y = fa.flash_attention_plain(qb, kb, vb)
    assert y.dtype == torch.bfloat16
    s = torch.einsum("bhqd,bhsd->bhqs", qb.float(), kb.float().expand(1, 2, 16, 32)) / 32**0.5
    s = s.masked_fill(~torch.ones(16, 16, dtype=torch.bool).tril(), float("-inf"))
    p = torch.softmax(s, -1).bfloat16().float()
    expect = torch.einsum("bhqs,bhsd->bhqd", p, vb.float().expand(1, 2, 16, 32)).bfloat16()
    assert torch.equal(y, expect)


@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("h,p,n", [(2, 16, 8), (3, 8, 16)])
def test_ssd_plain_matches_pallas_and_oracle(chunk, h, p, n):
    x, dt, A, B, C = _ssd_inputs(2, 128, h, p, n)
    y, _ = ssd.ssd_scan_plain(*_t(x, dt, A, B, C), chunk=chunk)
    jx = [jnp.asarray(a) for a in (x, dt, A, B, C)]
    y_pallas = np.asarray(jops.ssd_scan(*jx, chunk=chunk))
    y_ref = np.asarray(jref.ssd_ref(*jx))
    np.testing.assert_allclose(y.numpy(), y_pallas, **SSD_TOL)
    np.testing.assert_allclose(y.numpy(), y_ref, **SSD_TOL)


@pytest.mark.parametrize("chunk,h,p,n", [(16, 2, 16, 8), (32, 3, 8, 16), (8, 4, 16, 16), (64, 2, 64, 128)])
def test_ssd_plain_final_state_matches_ssd_chunked(chunk, h, p, n):
    x, dt, A, B, C = _ssd_inputs(2, 128, h, p, n, seed=chunk)
    y, state = ssd.ssd_scan_plain(*_t(x, dt, A, B, C), chunk=chunk)
    y_ref, state_ref = jblocks.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, B, C)), chunk, return_state=True)
    assert state.dtype == torch.float32 and tuple(state.shape) == (2, h, p, n)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **SSD_TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(state_ref), **SSD_TOL)


def test_ssd_plain_takes_strided_slices_and_keeps_dtype():
    """B and C as slices of one projection (as ssd_block passes them)."""
    x, dt, A, B, C = _t(*_ssd_inputs(2, 32, 2, 8, 16))
    proj = torch.cat([B, C], dim=-1)
    y, state = ssd.ssd_scan_plain(x.bfloat16(), dt, A, proj[..., :16].bfloat16(), proj[..., 16:].bfloat16(), chunk=8)
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    y32, _ = ssd.ssd_scan_plain(x, dt, A, B, C, chunk=8)
    assert torch.equal(ssd.ssd_scan_plain(x, dt, A, proj[..., :16], proj[..., 16:], chunk=8)[0], y32)


@pytest.mark.parametrize("fn", ["flash_attention", "ssd_scan"])
def test_ops_runs_cpu_tensors_on_the_plain_version_without_counting(fn):
    if fn == "flash_attention":
        args, kw, mod, plain = _t(*_attn_inputs(1, 4, 2, 20, 32)), dict(causal=True, window=5), fa, fa.flash_attention_plain
    else:
        args, kw, mod, plain = _t(*_ssd_inputs(1, 16, 2, 8, 8)), dict(chunk=8), ssd, ssd.ssd_scan_plain
    before = mod.launches
    out = getattr(ops, fn)(*args, **kw)
    assert mod.launches == before
    expect = plain(*args, **kw)
    for a, b in zip(out if isinstance(out, tuple) else (out,), expect if isinstance(expect, tuple) else (expect,)):
        assert torch.equal(a, b)


def test_cuda_wrappers_refuse_cpu_tensors():
    q, k, v = _t(*_attn_inputs(1, 4, 2, 16, 32))
    before = fa.launches, ssd.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd.ssd_scan(*_t(*_ssd_inputs(1, 16, 2, 8, 8)), chunk=8)
    assert (fa.launches, ssd.launches) == before


@pytest.mark.parametrize(
    "shapes,err",
    [
        (((1, 4, 16, 32), (1, 3, 16, 32), (1, 3, 16, 32)), "multiple of kv heads"),
        (((1, 4, 16, 32), (2, 2, 8, 32), (2, 2, 8, 32)), "disagree"),  # batch (a key length of 8 is valid)
        (((1, 4, 16, 32), (1, 2, 16, 32), (1, 2, 16, 16)), "need q"),
    ],
)
def test_attention_plain_rejects_bad_shapes(shapes, err):
    with pytest.raises(ValueError, match=err):
        fa.flash_attention_plain(*(torch.zeros(s) for s in shapes))


def test_ssd_plain_rejects_ragged_chunk_and_bad_shapes():
    x, dt, A, B, C = _t(*_ssd_inputs(1, 20, 2, 8, 8))
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd.ssd_scan_plain(x, dt, A, B, C, chunk=8)
    with pytest.raises(ValueError, match="inconsistent"):
        ssd.ssd_scan_plain(x, dt[:, :, :1], A, B, C, chunk=4)


def test_ssd_block_of_the_mamba2_shape_fits_shared_memory():
    """The blocks of the kernels that mamba2-130m's bf16 prefill scan runs
    (the ``wgmma`` route at x [4, 512, 24, 64], state 128, chunk 64: its
    states and chunk kernels) need dynamic shared memory above 48 KB and
    within the H100's 227 KB; so do the ``mma.sync`` kernel's plan at that
    shape and the SIMT kernel's at the same state (the fp32 scan)."""
    plan = ssd.plan(torch.bfloat16, 4, 24, 64, 128, 64, True)
    assert plan.route == ssd.KERNELS.index("ssd_scan_fwd_chunk_kernel")
    for need in (plan.smem, *ssd.fwd_smem_bytes(128, ssd.bwd_head_group(4, 512, 24)),
                 ssd.mma_plan(4, 24, 64, 128, 64).smem):
        assert 48 * 1024 < need <= ssd.MAX_SMEM_BYTES
    need = ssd.simt_smem_bytes(64, 128, ssd.SIMT_P_TILE)
    assert 48 * 1024 < need <= ssd.MAX_SMEM_BYTES
