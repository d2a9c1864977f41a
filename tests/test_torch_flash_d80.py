"""The flash backward at head dim 80 (zamba2-2.7b's shared attention block)
on the wgmma route: its route and kernels, and the plain backward it is
held to on the card, against the JAX package's gradients (CPU).

At D 80 a tile is two 128-byte swizzle boxes, the second zero-filled past
column 79, so bf16 calls whose rows TMA can address take the wgmma route in
both score modes (``flash_attention.bwd_route``), two launches each
(``bwd_kernels``); zamba2's group of one q-head a kv-head makes its dK/dV
cluster one block.  The kernels run only on the card (``chip_smoke.py``
phases 11, 11b, 13 and 16); here the route, the kernels' names and the plain
versions at D 80 are held against ``jax.grad`` of the reference's
``_sdpa``, inputs from numpy with a seed.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # CI installs requirements-dev.txt, which has no torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import blocks as jblocks
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa

ATTN_TOL = dict(rtol=2e-4, atol=2e-4)


def _bshd(b, s, h, d, dtype=torch.bfloat16, pad=0):
    """The model's layout: a [b, h, s, d] transposed view of [b, s, h, d + pad]."""
    return torch.zeros((b, s, h, d + pad), dtype=dtype)[..., :d].transpose(1, 2)


@pytest.mark.parametrize("fp32_scores", [True, False])
def test_zamba2_training_shape_takes_the_wgmma_route_in_two_launches(fp32_scores):
    cfg = get_config("zamba2-2.7b")
    assert cfg.hd == 80 and cfg.n_heads == cfg.n_kv_heads == 32
    q = _bshd(4, 512, cfg.n_heads, 80)
    k = _bshd(4, 512, cfg.n_kv_heads, 80)
    assert fa.bwd_route(q, k, k, q, q, fp32_scores) == "wgmma"
    assert fa.bwd_cluster(cfg.n_heads, cfg.n_kv_heads) == (1, 1)  # a group of one: no cluster sum
    mode = "" if fp32_scores else "_bf16_scores"
    assert fa.bwd_kernels("wgmma", 80, fp32_scores) == (f"flash_bwd_dq_wgmma{mode}_kernel<80>",
                                                        f"flash_bwd_dkdv_wgmma{mode}_kernel<80>")


@pytest.mark.parametrize("fp32_scores", [True, False])
@pytest.mark.parametrize("h,kvh", [(4, 4), (8, 2), (32, 8)])
def test_d80_groups_take_the_wgmma_route_with_their_cluster(h, kvh, fp32_scores):
    q, k = _bshd(2, 65, h, 80), _bshd(2, 65, kvh, 80)
    assert fa.bwd_route(q, k, k, q, q, fp32_scores) == "wgmma"
    assert fa.bwd_cluster(h, kvh)[0] == h // kvh  # groups of 1 and 4: one q-head a block


@pytest.mark.parametrize("fp32_scores", [True, False])
@pytest.mark.parametrize("which", ["padded", "float32", "offset"])
def test_d80_stays_off_wgmma_where_tma_cannot_take_it(which, fp32_scores):
    """Rows only 8-byte aligned and bases 8 bytes off take mma.sync; fp32 the SIMT pipes."""
    if which == "float32":
        q = _bshd(2, 24, 4, 80, torch.float32)
        assert fa.bwd_route(q, q, q, q, q, fp32_scores) == "simt"
        return
    q = _bshd(2, 24, 4, 80, pad=4) if which == "padded" else \
        torch.zeros(2 * 4 * 24 * 80 + 4, dtype=torch.bfloat16)[4:].view(2, 4, 24, 80)
    k = _bshd(2, 24, 4, 80)
    assert fa.bwd_route(q, k, k, k, k, fp32_scores) == "mma"


def _inputs(b, h, kvh, sq, skv, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, 80), dtype=np.float32),
            rng.standard_normal((b, kvh, skv, 80), dtype=np.float32),
            rng.standard_normal((b, kvh, skv, 80), dtype=np.float32),
            rng.standard_normal((b, h, sq, 80), dtype=np.float32))


def _sdpa_grad(q, k, v, do, *, causal, window):
    """``jax.grad`` of <_sdpa(q, k, v), do> on [B, H, S, D] numpy arrays -> dq, dk, dv."""
    b, h, sq, d = q.shape
    cfg = dataclasses.replace(jconfigs.get_smoke("zamba2-2.7b"), dtype=jnp.float32, attn_q_block=4,
                              n_heads=h, n_kv_heads=k.shape[1], head_dim=d)
    t = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3))

    def f(q, k, v):
        return jnp.sum(jblocks._sdpa(cfg, q, k, v, causal=causal, window=window).reshape(b, sq, h, d) * t(do))

    return [np.asarray(g).transpose(0, 2, 1, 3) for g in jax.grad(f, argnums=(0, 1, 2))(t(q), t(k), t(v))]


#: (h, kvh, sq, skv, causal, window): groups 1 and 4, ragged S, Sq != Skv both ways, a window, non-causal
D80_GRID = [(4, 4, 20, 20, True, 0), (8, 2, 13, 13, True, 0), (4, 1, 16, 16, False, 0), (4, 4, 8, 20, True, 0),
            (8, 2, 20, 12, False, 0), (4, 4, 24, 24, True, 5), (8, 2, 1, 1, True, 0)]


@pytest.mark.parametrize("h,kvh,sq,skv,causal,window", D80_GRID)
def test_d80_bwd_plain_matches_jax_grad_of_sdpa(h, kvh, sq, skv, causal, window):
    q, k, v, do = _inputs(1, h, kvh, sq, skv, seed=sq + skv)
    want = _sdpa_grad(q, k, v, do, causal=causal, window=window)
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = fa.flash_attention_fwd_plain(qt, kt, vt, causal=causal, window=window)
    got = fa.flash_attention_bwd_plain(qt, kt, vt, o, lse, dot, causal=causal, window=window)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), w, **ATTN_TOL)
