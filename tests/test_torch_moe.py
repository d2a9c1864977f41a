"""The port's batched GEMM and MoE FFN against the JAX package's (CPU).

Inputs come from numpy with a seed and go to both packages; weights come
from the reference's ``init_params`` and cross through numpy
(``params_from_numpy``).  ``gemm_plain`` (what a CPU tensor runs) is held
against the Pallas ``gemm`` in interpret mode and ``gemm_ref`` at the
reference's grid and tolerances (2e-4 fp32, 6e-2 bf16,
``tests/test_kernels.py``).  ``moe_ffn_local`` / ``moe_ffn`` are held
against the reference in fp32 at 2e-4 (the per-block tolerance of
``tests/test_torch_lm.py``) and in bf16 at 6e-2 (the reference's bf16 GEMM
tolerance: the expert products round their outputs to bf16 in both), with
capacities that drop tokens, and with router ties.  The CUDA kernel runs
only on the card: ``tests/test_torch_gpu.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # CI installs requirements-dev.txt, which has no torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import blocks as jblocks
from repro.models import lm_common as jlm
from repro_torch import configs
from repro_torch.kernels import gemm as gm
from repro_torch.kernels import ops
from repro_torch.models import blocks, lm_common

GEMM_TOL = {np.float32: dict(rtol=2e-4, atol=2e-4), "bf16": dict(rtol=6e-2, atol=6e-2)}
BLOCK_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=6e-2, atol=6e-2)
MOE = ["phi3.5-moe-42b", "llama4-scout-17b"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------------------
# gemm
# ---------------------------------------------------------------------------


def _ab(shape_a, shape_b, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape_a, dtype=np.float32), rng.standard_normal(shape_b, dtype=np.float32)


def _both(a, dtype):
    """The same values in both packages (bf16: both round to nearest even)."""
    if dtype == "bf16":
        return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).bfloat16()
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("m,k,n", [(64, 64, 64), (200, 300, 150), (128, 512, 256), (33, 65, 17)])
@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_gemm_plain_matches_pallas_and_oracle(m, k, n, dtype):
    a, b = _ab((m, k), (k, n), seed=m)
    (ja, ta), (jb, tb) = _both(a, dtype), _both(b, dtype)
    y = gm.gemm_plain(ta, tb)
    assert y.dtype == ta.dtype and tuple(y.shape) == (m, n)
    np.testing.assert_allclose(_np(y), _np(jops.gemm(ja, jb, bm=64, bn=64, bk=128)), **GEMM_TOL[dtype])
    np.testing.assert_allclose(_np(y), _np(jref.gemm_ref(ja, jb)), **GEMM_TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_batched_gemm_plain_is_one_gemm_per_expert(dtype):
    a, b = _ab((4, 24, 40), (4, 40, 56), seed=3)
    (ja, ta), (jb, tb) = _both(a, dtype), _both(b, dtype)
    y = gm.gemm_plain(ta, tb)
    assert tuple(y.shape) == (4, 24, 56)
    for e in range(4):
        np.testing.assert_allclose(_np(y[e]), _np(jops.gemm(ja[e], jb[e], bm=16, bn=32, bk=32)), **GEMM_TOL[dtype])
    np.testing.assert_allclose(_np(y), _np(jnp.einsum("ecd,edf->ecf", ja, jb, preferred_element_type=jnp.float32)
                                           .astype(ja.dtype)), **GEMM_TOL[dtype])


#: (E, capacity, d, f) of the gradient tests: ragged against every tile (64, 128, 192), batched
GRAD_SHAPES = [(3, 17, 40, 72), (2, 33, 65, 17), (4, 8, 24, 56)]


@pytest.mark.parametrize("e,c,d,f", GRAD_SHAPES)
@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_gemm_plain_on_the_backwards_transposed_views_matches_pallas(e, c, d, f, dtype):
    """dA = dC·Bᵀ and dB = Aᵀ·dC as ``ops.gemm``'s backward passes them (views
    of the stored tensors), against the Pallas gemm in interpret mode on the
    transposed numpy arrays."""
    rng = np.random.default_rng(c)
    a, b, dc = (rng.standard_normal(s, dtype=np.float32) for s in ((e, c, d), (e, d, f), (e, c, f)))
    (_, ta), (_, tb), (_, tdc) = _both(a, dtype), _both(b, dtype), _both(dc, dtype)
    da = gm.gemm_plain(tdc, tb.transpose(-1, -2))
    db = gm.gemm_plain(ta.transpose(-1, -2), tdc)
    assert da.dtype == ta.dtype and tuple(da.shape) == (e, c, d) and tuple(db.shape) == (e, d, f)
    for i in range(e):
        (jdc, _), (jbt, _), (jat, _) = (_both(np.ascontiguousarray(x), dtype)
                                        for x in (dc[i], b[i].T, a[i].T))
        np.testing.assert_allclose(_np(da[i]), _np(jops.gemm(jdc, jbt, bm=16, bn=32, bk=32)), **GEMM_TOL[dtype])
        np.testing.assert_allclose(_np(db[i]), _np(jops.gemm(jat, jdc, bm=16, bn=32, bk=32)), **GEMM_TOL[dtype])


@pytest.mark.parametrize("spec", ["ecd,edf->ecf", "ecf,efd->ecd"])  # gate/up, down
@pytest.mark.parametrize("e,c,d,f", GRAD_SHAPES)
@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_gemm_gradient_through_the_plain_version_matches_jax_grad(spec, e, c, d, f, dtype):
    """Autograd through ``ops.gemm`` on CPU tensors (``gemm_plain``) against
    ``jax.grad`` of the reference's einsum, dA and dB, under one upstream
    gradient dC."""
    k, n = (d, f) if spec.startswith("ecd") else (f, d)
    rng = np.random.default_rng(k * n)
    a, b, dc = (rng.standard_normal(s, dtype=np.float32) for s in ((e, c, k), (e, k, n), (e, c, n)))
    (ja, ta), (jb, tb), (jdc, tdc) = _both(a, dtype), _both(b, dtype), _both(dc, dtype)
    ta.requires_grad_()
    tb.requires_grad_()
    da, db = torch.autograd.grad(ops.gemm(ta, tb), (ta, tb), tdc)

    def loss(x, w):
        y = jnp.einsum(spec, x, w, preferred_element_type=jnp.float32)
        return jnp.sum(y * jdc.astype(jnp.float32))

    jda, jdb = jax.grad(loss, argnums=(0, 1))(ja, jb)
    assert da.dtype == ta.dtype and db.dtype == tb.dtype
    np.testing.assert_allclose(_np(da), _np(jda), **GEMM_TOL[dtype])
    np.testing.assert_allclose(_np(db), _np(jdb), **GEMM_TOL[dtype])


def test_ops_gemm_runs_cpu_tensors_on_the_plain_version_without_counting():
    a, b = (torch.from_numpy(x) for x in _ab((3, 8, 16), (3, 16, 24)))
    before = gm.launches
    assert torch.equal(ops.gemm(a, b), gm.gemm_plain(a, b))
    assert gm.launches == before


def test_cuda_gemm_refuses_cpu_tensors():
    a, b = (torch.from_numpy(x) for x in _ab((8, 16), (16, 24)))
    before = gm.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        gm.gemm(a, b)
    assert gm.launches == before


@pytest.mark.parametrize("sa,sb", [((8, 16), (15, 24)), ((2, 8, 16), (3, 16, 24)), ((8, 16), (2, 16, 24)),
                                   ((16,), (16, 4))])
def test_gemm_plain_rejects_mismatched_shapes(sa, sb):
    with pytest.raises(ValueError):
        gm.gemm_plain(torch.zeros(sa), torch.zeros(sb))


# ---------------------------------------------------------------------------
# MoE FFN
# ---------------------------------------------------------------------------


def _pair(arch, dtype=None):
    jcfg, tcfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    if dtype != "bf16":
        jcfg, tcfg = dataclasses.replace(jcfg, dtype=jnp.float32), dataclasses.replace(tcfg, dtype=torch.float32)
    return jcfg, tcfg


def _layer0(jcfg, tcfg, seed=0, **override):
    """Layer 0 of the reference's init in both packages; ``override`` replaces
    leaves of the stacks (numpy, with the layer axis)."""
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    tree["blocks"] = {**tree["blocks"], **override}
    tp = lm_common.params_from_numpy(tcfg, tree, "cpu")
    jl = {k: jnp.asarray(v[0]).astype(jp["blocks"][k].dtype) for k, v in tree["blocks"].items()}
    return jl, lm_common.layer(tp["blocks"], 0)


def _x(cfg, b=2, s=16, seed=1):
    return np.random.default_rng(seed).standard_normal((b, s, cfg.d_model), dtype=np.float32)


@pytest.mark.parametrize("arch", MOE)
def test_moe_capacity_is_the_references(arch):
    for cfg_t, cfg_j in ((configs.get_smoke(arch), jconfigs.get_smoke(arch)),
                         (configs.get_config(arch), jconfigs.get_config(arch))):
        for tokens in list(range(1, 70)) + [100, 511, 512, 513, 2048, 4096, 32768]:
            assert blocks.moe_capacity(cfg_t, tokens) == jblocks.moe_capacity(cfg_j, tokens), tokens
    assert blocks.moe_capacity(configs.get_config("phi3.5-moe-42b"), 2048) == 320
    assert blocks.moe_capacity(configs.get_config("phi3.5-moe-42b"), 4) == 8


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("fn", ["moe_ffn_local", "moe_ffn"])
def test_moe_ffn_matches_the_reference(arch, fn):
    jcfg, tcfg = _pair(arch)
    jl, tl = _layer0(jcfg, tcfg)
    x = _x(jcfg)
    if fn == "moe_ffn":
        jy, jaux = jblocks.moe_ffn(jcfg, jl, jnp.asarray(x))
        ty, taux = blocks.moe_ffn(tcfg, tl, torch.from_numpy(x))
    else:
        cap = blocks.moe_capacity(tcfg, 32)
        jy, jaux = jblocks.moe_ffn_local(jcfg, jl, jnp.asarray(x), cap)
        ty, taux = blocks.moe_ffn_local(tcfg, tl, torch.from_numpy(x), cap)
    np.testing.assert_allclose(_np(ty), _np(jy), **BLOCK_TOL)
    np.testing.assert_allclose(_np(taux), _np(jaux), **BLOCK_TOL)
    assert taux.dtype == torch.float32 and taux.dim() == 0


@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_local_matches_the_reference_in_bf16(arch):
    jcfg, tcfg = _pair(arch, "bf16")
    jl, tl = _layer0(jcfg, tcfg)
    x = _x(jcfg)
    jx, tx = jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).bfloat16()
    cap = blocks.moe_capacity(tcfg, 32)
    jy, jaux = jblocks.moe_ffn_local(jcfg, jl, jx, cap)
    ty, taux = blocks.moe_ffn_local(tcfg, tl, tx, cap)
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(ty), _np(jy), **BF16_TOL)
    np.testing.assert_allclose(_np(taux), _np(jaux), **BLOCK_TOL)  # the router runs in fp32 in both


def _kept(cfg, tl, x, capacity):
    _, _, expert = blocks.route(cfg, tl, torch.from_numpy(x).reshape(-1, cfg.d_model))
    counts = torch.bincount(expert.reshape(-1), minlength=cfg.n_experts)
    return int(counts.clamp(max=capacity).sum()), expert.numel()


@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_local_drops_tokens_past_capacity_as_the_reference(arch):
    """Capacity 8 for 64 (token, expert) pairs over 4 experts: queues overflow,
    so ``keep``, the scratch row and the zeroed combine weights all act."""
    jcfg, tcfg = _pair(arch)
    jl, tl = _layer0(jcfg, tcfg)
    x = _x(jcfg, b=4, s=16, seed=5)
    kept, pairs = _kept(tcfg, tl, x, 8)
    assert kept < pairs
    jy, jaux = jblocks.moe_ffn_local(jcfg, jl, jnp.asarray(x), 8)
    ty, taux = blocks.moe_ffn_local(tcfg, tl, torch.from_numpy(x), 8)
    np.testing.assert_allclose(_np(ty), _np(jy), **BLOCK_TOL)
    np.testing.assert_allclose(_np(taux), _np(jaux), **BLOCK_TOL)


@pytest.mark.parametrize("arch", MOE)
def test_router_ties_go_to_the_lower_expert_as_in_the_reference(arch):
    """A zero router gives every expert the same probability: top-k must pick
    experts 0..k-1 for every token, as ``jax.lax.top_k`` does, and those
    queues overflow."""
    jcfg, tcfg = _pair(arch)
    zero = np.zeros((jcfg.n_layers, jcfg.d_model, jcfg.n_experts), np.float32)
    jl, tl = _layer0(jcfg, tcfg, router=zero)
    x = _x(jcfg)
    _, _, expert = blocks.route(tcfg, tl, torch.from_numpy(x).reshape(-1, tcfg.d_model))
    assert (expert == torch.arange(tcfg.top_k)).all()
    cap = blocks.moe_capacity(tcfg, 32)
    assert _kept(tcfg, tl, x, cap)[0] < 32 * tcfg.top_k
    jy, jaux = jblocks.moe_ffn_local(jcfg, jl, jnp.asarray(x), cap)
    ty, taux = blocks.moe_ffn_local(tcfg, tl, torch.from_numpy(x), cap)
    np.testing.assert_allclose(_np(ty), _np(jy), **BLOCK_TOL)
    np.testing.assert_allclose(_np(taux), _np(jaux), **BLOCK_TOL)


def test_route_top_k_equals_lax_top_k_with_and_without_ties():
    cfg = dataclasses.replace(configs.get_smoke("phi3.5-moe-42b"), dtype=torch.float32)
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((64, cfg.n_experts), dtype=np.float32)
    logits[::3, 1] = logits[::3, 2]  # exact ties between experts 1 and 2
    logits[::5] = 0.0  # all experts tied
    eye = np.eye(cfg.n_experts, dtype=np.float32)
    _, gate, expert = blocks.route(cfg, {"router": torch.from_numpy(eye)}, torch.from_numpy(logits))
    jgate, jexpert = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), axis=-1), cfg.top_k)
    assert np.array_equal(expert.numpy(), np.asarray(jexpert))
    np.testing.assert_allclose(gate.numpy(), np.asarray(jgate / jgate.sum(-1, keepdims=True)), **BLOCK_TOL)


def test_moe_ffn_with_a_mesh_raises():
    jcfg, tcfg = _pair("phi3.5-moe-42b")
    _, tl = _layer0(jcfg, tcfg)
    with pytest.raises(TypeError, match="make_test_mesh"):  # a mesh of ranks runs (tests/test_torch_distributed.py)
        blocks.moe_ffn(tcfg, tl, torch.from_numpy(_x(jcfg)), mesh=object())
