"""The flash kernel's bf16-score mode against the reference's ``attn_fp32_scores=False``, on the CPU.

The reference's knob (``repro/models/lm_common.py``, ``attn_fp32_scores``)
rounds the scores to bf16, divides them by ``math.sqrt(d)`` (a weakly typed
Python float, which JAX casts to bf16) and runs ``jax.nn.softmax`` in bf16;
``jax.grad`` differentiates that softmax op by op.  The port's plain
versions (``flash_attention_plain`` / ``flash_attention_fwd_plain`` /
``flash_attention_bwd_plain`` with ``fp32_scores=False``) follow each
rounding, and the order in which XLA's CPU backend adds a row
(``tree_sum``); the CUDA kernels are held to them on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).

The reference runs eagerly here: every primitive is compiled on its own, so
XLA fuses nothing and each bf16 step is rounded, as
``--xla_allow_excess_precision=false`` would have a jitted reference round
it (``attn_q_block`` is set above every length, so no ``lax.scan`` body is
compiled whole).

The kernel-level tests feed q, k, v and dO on a grid of 1/16 in [-1.5,
1.5] (five significant bits): every partial sum of q·kᵀ and of dO·Vᵀ is then
exact in fp32 whatever the order of its additions, so the tests see the
function's roundings and not the order of XLA's fp32 dot, which the port
does not follow (it flips a bf16-rounded score in about one element of
10,000 on normal inputs, 1e-4 of the output's max).  Tolerances (of each tensor's max |value|): the forward
1e-6; the gradient 1e-5 in fp32 and 2^-8 (one bf16 step) in bf16, where the
products' fp32 sums in other orders round the last bit apart.  The
fp32-score function misses both by 1e-3 to 3e-2 on the same inputs.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # CI installs requirements-dev.txt, which has no torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import blocks as jblocks
from repro.models import lm_common as jlm
from repro.models import transformer as jtf
from repro_torch import configs, tree
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gemm as gm
from repro_torch.kernels import ops
from repro_torch.models import blocks, lm_common, transformer

FWD_TOL = 1e-6
GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-8}
#: the fp32-score function must miss the mode's reference by at least this much of the max
CONTROL_MISS = 1e-3

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}

# (b, h, kvh, sq, skv, causal, window): causal, a window, Skv above and below Sq, ragged lengths
MASKS = [
    (2, 4, 2, 48, 48, True, 0),
    (1, 4, 1, 40, 40, True, 9),
    (1, 6, 2, 21, 70, False, 0),
    (2, 4, 4, 37, 20, True, 0),
]


def _grid(rng, shape):
    """Values k/16 for integers k in [-24, 24]: exact in bf16, q·kᵀ exact in fp32."""
    return (rng.integers(-24, 25, shape) / 16).astype(np.float32)


def _inputs(b, h, kvh, sq, skv, d, seed):
    """q, k, v and dO on the grid: q·kᵀ and dO·Vᵀ exact in fp32."""
    rng = np.random.default_rng(seed)
    return (_grid(rng, (b, h, sq, d)), _grid(rng, (b, kvh, skv, d)), _grid(rng, (b, kvh, skv, d)),
            _grid(rng, (b, h, sq, d)))


def _jcfg(h, kvh, d, fp32_scores, dtype=jnp.float32):
    return dataclasses.replace(jconfigs.get_smoke("granite-3-2b"), dtype=dtype, n_heads=h, n_kv_heads=kvh,
                               head_dim=d, attn_fp32_scores=fp32_scores, attn_q_block=4096)


def _reference(q, k, v, do, causal, window, dtype, fp32_scores=False):
    """The reference's ``_sdpa`` and its ``jax.vjp`` on [B, H, S, D] numpy
    inputs cast to ``dtype``: (o, (dq, dk, dv)) as fp32 [B, H, S, D] numpy."""
    b, h, sq, d = q.shape
    jdt = JDT[dtype]
    t = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3), jdt)
    cfg = _jcfg(h, k.shape[1], d, fp32_scores, jdt)
    f = lambda q, k, v: jblocks._sdpa(cfg, q, k, v, causal=causal, window=window)
    o, vjp = jax.vjp(f, t(q), t(k), t(v))
    grads = vjp(t(do).reshape(b, sq, h * d))
    back = lambda a: np.asarray(jnp.asarray(a, jnp.float32)).transpose(0, 2, 1, 3)
    return back(o.reshape(b, sq, h, d)), tuple(back(g) for g in grads)


def _port(q, k, v, do, causal, window, dtype, fp32_scores=False):
    qt, kt, vt, dot = (torch.from_numpy(a).to(dtype) for a in (q, k, v, do))
    o, stats = fa.flash_attention_fwd_plain(qt, kt, vt, causal=causal, window=window, fp32_scores=fp32_scores)
    grads = fa.flash_attention_bwd_plain(qt, kt, vt, o, stats, dot, causal=causal, window=window,
                                         fp32_scores=fp32_scores)
    return o.float().numpy(), tuple(g.float().numpy() for g in grads)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_score_divisor_is_sqrt_d_as_jax_casts_it_to_bf16():
    want = {16: 4.0, 32: 5.65625, 64: 8.0, 80: 8.9375, 128: 11.3125, 192: 13.875}
    for d in fa.HEAD_DIMS:
        assert fa.score_divisor(d) == want[d]
        # the reference's weak-typed division: bf16 scores / a Python float
        one = jnp.asarray(want[d], jnp.bfloat16) / math.sqrt(d)
        assert one.dtype == jnp.bfloat16 and float(one) == 1.0


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("n", [7, 32, 33, 48, 100, 448, 1500])
def test_tree_sum_adds_in_xlas_cpu_order(n, bf16):
    """A bf16 ``reduce_sum`` in XLA's CPU order (windows of 32 over the
    centred zero padding, each added in order, then the windows' sums) bit
    for bit, and an fp32 one; a plain bf16 sum in order or an fp32 sum
    rounded once do not give those bits."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((8, 16, n)) * np.exp(rng.standard_normal((8, 16, n)))
    dt = jnp.bfloat16 if bf16 else jnp.float32
    xj = jnp.asarray(x, dt)
    want = np.asarray(jnp.sum(xj, axis=-1, dtype=dt).astype(jnp.float32))
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32)))
    np.testing.assert_array_equal(fa.tree_sum(xt, bf16=bf16).numpy(), want)
    if bf16 and n > fa.TREE_WINDOW:
        assert not np.array_equal(fa.bf16_round(xt.sum(-1)).numpy(), want)
        assert not np.array_equal(_in_order_bf16(xt).numpy(), want)


def _in_order_bf16(x):
    acc = torch.zeros_like(x[..., 0])
    for j in range(x.shape[-1]):
        acc = fa.bf16_round(acc + x[..., j])
    return acc


def test_tree_levels_pad_as_xla_does():
    assert fa.tree_levels(32) == [] and fa.tree_levels(33) == [15] and fa.tree_levels(48) == [8]
    assert fa.tree_levels(1500) == [2, 8] and fa.tree_levels(2048) == [0, 0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 80, 128, 192])
@pytest.mark.parametrize("b,h,kvh,sq,skv,causal,window", MASKS)
def test_plain_forward_equals_the_reference_sdpa(b, h, kvh, sq, skv, causal, window, d, dtype):
    q, k, v, do = _inputs(b, h, kvh, sq, skv, d, seed=d + sq)
    want, _ = _reference(q, k, v, do, causal, window, dtype)
    got, _ = _port(q, k, v, do, causal, window, dtype)
    assert _rel(got, want) <= FWD_TOL
    ctl, _ = _port(q, k, v, do, causal, window, dtype, fp32_scores=True)
    assert _rel(ctl, want) > CONTROL_MISS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 80, 128, 192])
@pytest.mark.parametrize("b,h,kvh,sq,skv,causal,window", MASKS)
def test_plain_backward_equals_jax_grad_and_the_fp32_score_gradient_misses(b, h, kvh, sq, skv, causal, window, d,
                                                                           dtype):
    q, k, v, do = _inputs(b, h, kvh, sq, skv, d, seed=d + sq)
    _, want = _reference(q, k, v, do, causal, window, dtype)
    _, got = _port(q, k, v, do, causal, window, dtype)
    _, ctl = _port(q, k, v, do, causal, window, dtype, fp32_scores=True)
    for name, g, c, w in zip(("dq", "dk", "dv"), got, ctl, want):
        assert _rel(g, w) <= GRAD_TOL[dtype], name
    assert max(_rel(c, w) for c, w in zip(ctl[:2], want[:2])) > CONTROL_MISS


def test_the_gradient_needs_the_tree_order_of_r():
    """R added in bf16 in plain order (or in fp32, rounded once) misses
    ``jax.grad`` by about 1e-2 of the max: the cancellation in
    ``bf16(g / l) - R`` magnifies one bf16 step of R."""
    q, k, v, do = _inputs(2, 4, 2, 48, 48, 16, seed=11)
    _, want = _reference(q, k, v, do, True, 0, torch.float32)
    _, got = _port(q, k, v, do, True, 0, torch.float32)
    assert max(_rel(g, w) for g, w in zip(got, want)) <= GRAD_TOL[torch.float32]
    real = fa.bf16_row_sum
    try:
        fa.bf16_row_sum = lambda t: fa.bf16_round(t.sum(-1))
        _, fp32_r = _port(q, k, v, do, True, 0, torch.float32)
    finally:
        fa.bf16_row_sum = real
    assert max(_rel(g, w) for g, w in zip(fp32_r[:2], want[:2])) > CONTROL_MISS


def test_plain_forward_on_normal_inputs_is_close_to_the_reference():
    """Normal q and k: XLA's fp32 dot adds in another order, so a few
    bf16-rounded scores land a step apart; the output stays within 1e-3 of
    its max, and the fp32-score function misses by more."""
    rng = np.random.default_rng(5)
    q, k = (rng.standard_normal(s, dtype=np.float32) * 1.5 for s in ((2, 4, 33, 80), (2, 2, 70, 80)))
    v, do = rng.standard_normal((2, 2, 70, 80), dtype=np.float32), rng.standard_normal((2, 4, 33, 80), np.float32)
    want, _ = _reference(q, k, v, do, False, 0, torch.float32)
    got, _ = _port(q, k, v, do, False, 0, torch.float32)
    ctl, _ = _port(q, k, v, do, False, 0, torch.float32, fp32_scores=True)
    assert _rel(got, want) <= 1e-3 < _rel(ctl, want)


def test_stats_are_the_rows_max_and_bf16_sum():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 20, 30, 32, seed=3))
    _, stats = fa.flash_attention_fwd_plain(q, k, v, window=6, fp32_scores=False)
    assert stats.shape == (2, 1, 4, 20) and stats.dtype == torch.float32
    s = fa.bf16_round(fa.bf16_round(torch.einsum("bhqd,bhsd->bhqs", q, k.repeat_interleave(2, 1)))
                      / fa.score_divisor(32))
    i, j = torch.arange(20)[:, None], torch.arange(30)[None]
    s = s.masked_fill(~((j <= i) & (i - j < 6)), float("-inf"))
    m = s.amax(-1)
    assert torch.equal(stats[0], m)
    assert torch.equal(stats[1], fa.bf16_round(fa.tree_sum(fa.bf16_round(torch.exp(fa.bf16_round(s - m[..., None]))),
                                                           bf16=False)))
    with pytest.raises(ValueError, match="stats"):
        fa.flash_attention_bwd_plain(q, k, v, q, stats[0], q, fp32_scores=False)


def test_ops_trains_cpu_tensors_through_the_plain_backward_without_launches():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 24, 24, 32, seed=6))
    before = fa.launches, fa.bwd_launches, gm.launches, gm.bwd_launches
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    out = ops.flash_attention(qa, ka, va, window=5, fp32_scores=False)
    got = torch.autograd.grad(out, (qa, ka, va), do)
    o, stats = fa.flash_attention_fwd_plain(q, k, v, window=5, fp32_scores=False)
    assert torch.equal(out.detach(), o)
    want = fa.flash_attention_bwd_plain(q, k, v, o, stats, do, window=5, fp32_scores=False)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # torch's autograd through the plain ops is another gradient: the Function is what follows the reference
    qb, kb, vb = (t.clone().requires_grad_() for t in (q, k, v))
    auto = torch.autograd.grad(fa.flash_attention_plain(qb, kb, vb, window=5, fp32_scores=False), (qb, kb, vb), do)
    assert not torch.equal(auto[0], got[0])
    with torch.no_grad():
        assert torch.equal(ops.flash_attention(q, k, v, window=5, fp32_scores=False), o)
    assert (fa.launches, fa.bwd_launches, gm.launches, gm.bwd_launches) == before


def test_meta_tensors_count_the_mode_as_the_fp32_mode():
    q = torch.empty((2, 4, 64, 32), device="meta", requires_grad=True)
    k = torch.empty((2, 2, 64, 32), device="meta", requires_grad=True)
    counts = {}
    for f32 in (True, False):
        with ops.count_meta() as seen:
            ops.flash_attention(q, k, k, fp32_scores=f32).sum().backward()
        counts[f32] = seen
    assert counts[True] == counts[False] and counts[True]["flash_attention_bwd"]["calls"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_bwd_route_and_kernels_of_the_mode(d, dtype):
    """The mode takes the fp32 mode's routes: wgmma for bf16 at D 64, 80
    and 128 with rows TMA can address, mma.sync for other bf16 calls (rows
    only 8-byte aligned among them), the SIMT pipes for fp32; no delta
    pre-pass: the dQ kernel leaves each row's R for the dK/dV kernels."""
    q = torch.zeros((2, 24, 4, d), dtype=dtype).transpose(1, 2)
    k = torch.zeros((2, 24, 2, d), dtype=dtype).transpose(1, 2)
    route = fa.bwd_route(q, k, k, q, q, fp32_scores=False)
    assert route == ("simt" if dtype == torch.float32 else "wgmma" if d in fa.WGMMA_HEAD_DIMS else "mma")
    assert fa.bwd_route(q, k, k, q, q) == route
    # rows of d + 4 elements: 8-byte aligned, not what TMA takes
    q8 = torch.zeros((2, 24, 4, d + 4), dtype=dtype)[..., :d].transpose(1, 2)
    assert fa.bwd_route(q8, k, k, q8, q8, fp32_scores=False) == ("simt" if dtype == torch.float32 else "mma")
    if route == "wgmma":
        assert fa.bwd_kernels(route, d, fp32_scores=False) == (f"flash_bwd_dq_wgmma_bf16_scores_kernel<{d}>",
                                                               f"flash_bwd_dkdv_wgmma_bf16_scores_kernel<{d}>")
    if route != "simt":
        dkdv = ((f"flash_bwd_dkdv_mma_bf16_scores_kernel<{d}, 1>", f"flash_bwd_dkdv_mma_bf16_scores_kernel<{d}, 2>")
                if d >= 128 else (f"flash_bwd_dkdv_mma_bf16_scores_kernel<{d}, 3>",))
        assert fa.bwd_kernels("mma", d, fp32_scores=False) == (f"flash_bwd_dq_mma_bf16_scores_kernel<{d}>", *dkdv)
    else:
        assert fa.bwd_kernels(route, d, fp32_scores=False) == (f"flash_bwd_dq_bf16_scores_kernel<{d}>",
                                                               f"flash_bwd_dkdv_bf16_scores_kernel<{d}>")
    with pytest.raises(ValueError, match="no bf16-score backward"):
        fa.bwd_kernels("tpu", d, fp32_scores=False)


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_bf16_score_is_non_decreasing_so_the_max_sweep_maps_the_raw_max_once(d):
    """The forward's max sweep takes the raw accumulators' max and maps it
    once a row: bf16(bf16(acc) / c) is non-decreasing in acc, so its max
    over a row is its value at the row's largest acc.  Held over every bf16
    value (the mapping's first step rounds acc to one) and -inf, at each
    head dim's divisor c."""
    bits = torch.arange(2**16, dtype=torch.int32).to(torch.int16)
    x = bits.view(torch.bfloat16).float()
    x = x[~x.isnan()].sort().values
    assert x[0] == float("-inf") and x.numel() == 2**16 - 2 * 127
    s = fa.bf16_round(x / fa.score_divisor(d))
    assert bool((s[1:] >= s[:-1]).all())
    # so the max of the mapped scores is the mapping of the largest, on any row
    rows = x[torch.randint(0, x.numel(), (64, 512), generator=torch.Generator().manual_seed(d))]
    assert torch.equal(fa.bf16_round(rows / fa.score_divisor(d)).amax(-1),
                       fa.bf16_round(rows.amax(-1) / fa.score_divisor(d)))


def test_wrappers_refuse_cpu_tensors_in_the_mode():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 16, 16, 32, seed=7))
    o, stats = fa.flash_attention_fwd_plain(q, k, v, fp32_scores=False)
    before = fa.launches, fa.bwd_launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention(q, k, v, fp32_scores=False)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_bwd(q, k, v, o, stats, do, fp32_scores=False)
    assert (fa.launches, fa.bwd_launches) == before


# ---------------------------------------------------------------------------
# The models with the knob off
# ---------------------------------------------------------------------------


def _pair(arch, **over):
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), dtype=jnp.float32, attn_fp32_scores=False, **over)
    tcfg = dataclasses.replace(configs.get_smoke(arch), dtype=torch.float32, attn_fp32_scores=False, **over)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, lm_common.params_from_numpy(tcfg, jax.tree.map(lambda a: np.asarray(a, np.float32), jp),
                                                       "cpu")


def test_whisper_cross_attention_decode_honours_the_knob():
    """The reference's decode step scores its cross attention through
    ``_sdpa``, so the knob reaches it: the port's step against the
    reference's inline one, and the fp32-score step misses."""
    jcfg, tcfg, jp, tp = _pair("whisper-small")
    jl, tl = jax.tree.map(lambda a: a[0], jp["cross"]), lm_common.layer(tp["cross"], 0)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 1, jcfg.d_model), dtype=np.float32)
    kv = [_grid(rng, (3, jcfg.enc_frames, jcfg.n_kv_heads, jcfg.hd)) for _ in range(2)]
    hq = jlm.rms_norm(jnp.asarray(x), jl["ln"], jcfg.norm_eps)
    q = (hq @ jl["wq"]).reshape(3, 1, jcfg.n_heads, jcfg.hd)
    want = np.asarray(jblocks._sdpa(jcfg, q, *map(jnp.asarray, kv), causal=False))
    qt = torch.from_numpy(np.asarray(q))
    got = blocks._attend_one(tcfg, qt, *map(torch.from_numpy, kv), fp32_scores=False).numpy()
    ctl = blocks._attend_one(tcfg, qt, *map(torch.from_numpy, kv)).numpy()
    assert _rel(got, want) <= 1e-5 and _rel(ctl, want) > CONTROL_MISS
    full = blocks.cross_attention_decode(tcfg, tl, torch.from_numpy(x), *map(torch.from_numpy, kv))
    np.testing.assert_allclose(full.numpy(), x + got.reshape(3, 1, -1) @ np.asarray(jl["wo"]), rtol=1e-5, atol=1e-5)


def test_whisper_serve_step_with_the_knob_off_matches_the_reference():
    """Prefill, then decode steps, with ``attn_fp32_scores=False`` on both
    sides (the reference eager, ``jax.disable_jit``): the prefill logits
    within 2e-3 of their max (1.3e-3 read: the projections' fp32 sums in
    XLA's order flip a few bf16-rounded scores) and each decode step's
    within 1e-3 (3e-4 read); the fp32-score port misses every one by more
    than 2.5e-3 (2.9e-3 to 4.8e-3 read)."""
    jcfg, tcfg, jp, tp = _pair("whisper-small")
    rng = np.random.default_rng(4)
    s, steps = 12, 3
    toks = rng.integers(0, jcfg.vocab, (2, s + steps)).astype(np.int32)
    frames = rng.standard_normal((2, jcfg.enc_frames, jcfg.d_model), dtype=np.float32)
    with jax.disable_jit():
        jl, jc = jtf.prefill_step(jcfg, jp, {"tokens": jnp.asarray(toks[:, :s]), "frames": jnp.asarray(frames)},
                                  max_len=s + steps)
        want = [np.asarray(jl)]
        for t in range(steps):
            jl, jc = jtf.serve_step(jcfg, jp, jc, jnp.asarray(toks[:, s + t : s + t + 1]))
            want.append(np.asarray(jl))
    got = {}
    for f32 in (False, True):
        cfg = dataclasses.replace(tcfg, attn_fp32_scores=f32)
        with torch.inference_mode():
            tl, tc = transformer.prefill_step(cfg, tp, {"tokens": torch.from_numpy(toks[:, :s]).long(),
                                                        "frames": torch.from_numpy(frames)}, max_len=s + steps)
            got[f32] = [tl.numpy()]
            for t in range(steps):
                tl, tc = transformer.serve_step(cfg, tp, tc, torch.from_numpy(toks[:, s + t : s + t + 1]).long())
                got[f32].append(tl.numpy())
    for step, (g, c, w) in enumerate(zip(got[False], got[True], want)):
        assert _rel(g, w) <= (2e-3 if step == 0 else 1e-3)
        assert _rel(c, w) > 2.5e-3


def test_qwen3_training_at_head_dim_32_follows_the_reference_gradient():
    """qwen3's smoke config scores at head dim 32, where bf16(sqrt(32)) =
    5.65625 is not sqrt(32): the loss and every gradient leaf with the knob
    off against the reference's ``jax.value_and_grad`` (eager), beside the
    fp32-score port, which misses the loss."""
    jcfg, tcfg, jp, tp = _pair("qwen3-32b")
    assert tcfg.hd == 32
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, jcfg.vocab, (2, 16)).astype(np.int32),
             "labels": rng.integers(0, jcfg.vocab, (2, 16)).astype(np.int32)}
    with jax.disable_jit():
        jloss, jgrads = jax.value_and_grad(lambda p: jtf.train_loss(jcfg, p, {k: jnp.asarray(v) for k, v in
                                                                              batch.items()}))(jp)
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    loss, grads = transformer.value_and_grad(tcfg, tp, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    paths = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    ours = tree.leaves(grads)
    assert len(ours) == len(paths)
    for (path, w), g in zip(paths, ours):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), rtol=1e-3, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))
    base = float(transformer.train_loss(dataclasses.replace(tcfg, attn_fp32_scores=True), tp, tb))
    assert abs(base - float(jloss)) > 1e-5 * abs(float(jloss))
