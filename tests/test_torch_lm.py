"""The port's LM serving path against the JAX package's, on the CPU.

Weights come from the reference's ``init_params(cfg, PRNGKey)`` and cross
through numpy (``params_from_numpy``); inputs come from numpy with a seed.
Everything runs in fp32 (``dataclasses.replace(cfg, dtype=float32)`` on both
sides, as ``tests/test_models.py`` does): the reference rounds attention
scores to bf16 before its fp32 softmax and the port's flash path keeps them
in fp32, so bf16 would compare two roundings rather than two algorithms.
Tolerances: 2e-4 per block (the reference's decode-vs-forward tolerance),
3e-4 for prefill + decode logits (its prefill-vs-decode tolerance,
``tests/test_models.py:111``).

Hybrid (zamba2): the port's prefill logits are held against the reference's
``prefill_step``, but its decode continuation against the reference decoding
the whole sequence from scratch (``init_cache`` + ``serve_step``), not
against the reference's prefill + decode.  The reference's hybrid prefill
sizes the shared ring ``min(s, window)`` and ignores ``max_len``, so its
first decode step overwrites position 0; the port gives the ring the
``attn`` path's width (ROADMAP.md queue 3).  Patch prefix (internvl): the
port's ``max_len`` counts tokens (in ``init_cache`` and ``prefill_step``
alike) and the reference's positions, so the reference is given ``max_len +
n_patches``; ``tests/test_torch_encdec.py``
holds enc-dec and patch-prefix serving in detail.
"""

import dataclasses
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # CI installs requirements-dev.txt, which has no torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import blocks as jblocks
from repro.models import lm_common as jlm
from repro.models import transformer as jtf
from repro_torch import configs
from repro_torch.launch import serve as tserve
from repro_torch.models import blocks, lm_common, transformer

BLOCK_TOL = dict(rtol=2e-4, atol=2e-4)
PATH_TOL = dict(rtol=3e-4, atol=3e-4)
SERVED = ["granite-3-2b", "qwen2-0.5b", "qwen3-32b", "nemotron-4-340b", "mamba2-130m", "phi3.5-moe-42b",
          "llama4-scout-17b", "zamba2-2.7b", "whisper-small", "internvl2-76b"]


def _pair(arch: str, **over):
    """(reference cfg, port cfg) of an arch's smoke config in fp32."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), dtype=jnp.float32, **over)
    tcfg = dataclasses.replace(configs.get_smoke(arch), dtype=torch.float32, **over)
    return jcfg, tcfg


def _params(jcfg, tcfg, seed=0):
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, lm_common.params_from_numpy(tcfg, jax.tree.map(lambda a: np.asarray(a, np.float32), jp), "cpu")


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(actual, desired, tol):
    np.testing.assert_allclose(_np(actual), _np(desired), **tol)




# ---------------------------------------------------------------------------
# Configs and parameter trees
# ---------------------------------------------------------------------------


def test_registry_matches_the_reference():
    assert configs.ARCHS == jconfigs.ARCHS
    assert {k: dataclasses.astuple(v) for k, v in configs.SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in jconfigs.SHAPES.items()
    }
    for arch in configs.ARCHS:
        for shape in configs.SHAPES:
            assert configs.applicable(arch, shape) == jconfigs.applicable(arch, shape)
            assert configs.for_shape(configs.get_config(arch), shape).sliding_window == \
                jconfigs.for_shape(jconfigs.get_config(arch), shape).sliding_window


def _dtype_name(v):
    return str(v).removeprefix("torch.") if isinstance(v, torch.dtype) else jnp.dtype(v).name


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_every_config_field_equals_the_reference(arch, which):
    get_t, get_j = (configs.get_config, jconfigs.get_config) if which == "CONFIG" else (configs.get_smoke, jconfigs.get_smoke)
    t, j = get_t(arch), get_j(arch)
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    for f in dataclasses.fields(j):
        tv, jv = getattr(t, f.name), getattr(j, f.name)
        if f.name in ("dtype", "accum_dtype"):
            assert _dtype_name(tv) == _dtype_name(jv), f.name
        else:
            assert tv == jv, f.name
    for prop in ("hd", "q_dim", "kv_dim", "d_inner", "ssm_heads", "is_moe", "is_encdec"):
        assert getattr(t, prop) == getattr(j, prop), prop


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape) for k, v in tree.items()}


@pytest.mark.parametrize("seq,batch", [(2048, 1), (512, 4)])
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_layer_costs_equal_the_reference(arch, seq, batch):
    """The scheduler's per-block costs (``tests/test_models.py``'s chain
    cover), ``Layer`` for ``Layer``, from the full-size config alone."""
    ours = transformer.layer_costs(configs.get_config(arch), seq=seq, batch=batch)
    theirs = jtf.layer_costs(jconfigs.get_config(arch), seq=seq, batch=batch)
    assert [dataclasses.asdict(c) for c in ours] == [dataclasses.asdict(c) for c in theirs]
    cfg = configs.get_config(arch)
    assert len(ours) == cfg.n_layers + (cfg.enc_layers if cfg.is_encdec else 0)
    assert all(c.flops > 0 for c in ours)


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_param_tree_keys_and_shapes_equal_the_reference(arch):
    """Full width through shapes only (eval_shape / param_spec); the smoke
    config through a real init on both sides, dtypes included."""
    jcfg, tcfg = jconfigs.get_config(arch), configs.get_config(arch)
    jshape = jax.eval_shape(lambda: jlm.init_params(jcfg, jax.random.PRNGKey(0)))
    assert _shapes(lm_common.param_spec(tcfg)) == _shapes(jshape)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()

    jcfg, tcfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = lm_common.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert _shapes(tp) == _shapes(jp)
    jd = jax.tree.map(lambda a: jnp.dtype(a.dtype).name, jp)
    td = jax.tree.map(lambda a: _dtype_name(a.dtype), tp, is_leaf=lambda a: isinstance(a, torch.Tensor))
    assert td == jd


def test_init_params_scaling_and_determinism():
    cfg = configs.get_smoke("granite-3-2b")
    a = lm_common.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = lm_common.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    assert torch.equal(a["blocks"]["wq"], b["blocks"]["wq"])
    assert a["blocks"]["wq"].dtype == torch.bfloat16 and a["blocks"]["ln1"].dtype == torch.float32
    # _dense: N(0, 1) / sqrt(fan-in); ones for norm scales
    std = a["blocks"]["w_down"].float().std().item()
    assert abs(std * cfg.d_ff**0.5 - 1) < 0.05
    assert torch.equal(a["ln_f"], torch.ones(cfg.d_model))


def test_params_from_numpy_checks_keys_and_shapes():
    jcfg, tcfg = _pair("granite-3-2b")
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jlm.init_params(jcfg, jax.random.PRNGKey(0)))
    bad = {**tree, "blocks": {**tree["blocks"], "wq": tree["blocks"]["wq"][:, :, :-1]}}
    with pytest.raises(ValueError, match="shape"):
        lm_common.params_from_numpy(tcfg, bad, "cpu")
    with pytest.raises(ValueError, match="keys"):
        lm_common.params_from_numpy(tcfg, {k: v for k, v in tree.items() if k != "ln_f"}, "cpu")


# ---------------------------------------------------------------------------
# Small ops and blocks
# ---------------------------------------------------------------------------


def test_rms_norm_and_rotary_match_the_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, 32), dtype=np.float32)
    scale = rng.standard_normal(32, dtype=np.float32)
    pos = np.stack([np.arange(7), np.arange(7) + 100]).astype(np.int32)
    _close(lm_common.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)), jlm.rms_norm(jnp.asarray(x), jnp.asarray(scale)),
           BLOCK_TOL)
    _close(lm_common.rotary(torch.from_numpy(x), torch.from_numpy(pos)), jlm.rotary(jnp.asarray(x), jnp.asarray(pos)),
           BLOCK_TOL)
    xb = torch.from_numpy(x).bfloat16()
    assert lm_common.rms_norm(xb, torch.from_numpy(scale)).dtype == torch.bfloat16
    assert lm_common.rotary(xb, torch.from_numpy(pos)).dtype == torch.bfloat16


def _layer0(jp, tp, key="blocks"):
    return jax.tree.map(lambda a: a[0], jp[key]), lm_common.layer(tp[key], 0)


def _x(cfg, b=2, s=16, seed=1):
    return np.random.default_rng(seed).standard_normal((b, s, cfg.d_model), dtype=np.float32)


@pytest.mark.parametrize("arch,over", [("granite-3-2b", {}), ("qwen2-0.5b", {}), ("qwen3-32b", {}),
                                       ("granite-3-2b", {"sliding_window": 5})])
def test_attention_matches_the_reference(arch, over):
    jcfg, tcfg = _pair(arch, **over)
    jp, tp = _params(jcfg, tcfg)
    if jcfg.qkv_bias:  # the reference inits biases to zero; make them count
        rng = np.random.default_rng(9)
        jp["blocks"] = {**jp["blocks"], **{k: jnp.asarray(rng.standard_normal(jp["blocks"][k].shape, dtype=np.float32))
                                           for k in ("bq", "bk", "bv")}}
        tp = lm_common.params_from_numpy(tcfg, jax.tree.map(lambda a: np.asarray(a, np.float32), jp), "cpu")
    jl, tl = _layer0(jp, tp)
    x = _x(jcfg)
    pos = np.tile(np.arange(16, dtype=np.int32), (2, 1))
    jy, jk, jv = jblocks.attention(jcfg, jl, jnp.asarray(x), jnp.asarray(pos), window=jcfg.sliding_window,
                                   return_kv=True)
    ty, tk, tv = blocks.attention(tcfg, tl, torch.from_numpy(x), torch.from_numpy(pos), window=tcfg.sliding_window,
                                  return_kv=True)
    for a, b in ((ty, jy), (tk, jk), (tv, jv)):
        _close(a, b, BLOCK_TOL)


@pytest.mark.parametrize("window", [0, 4])
def test_attention_decode_ring_matches_the_reference(window):
    """Ten tokens through a 6-slot ring: wrap-around, the seen mask and the window."""
    jcfg, tcfg = _pair("granite-3-2b")
    jp, tp = _params(jcfg, tcfg)
    jl, tl = _layer0(jp, tp)
    W, b = 6, 2
    jk = jnp.zeros((b, W, jcfg.n_kv_heads, jcfg.hd)); jv = jk; jpos = -jnp.ones((W,), jnp.int32)
    tk = torch.zeros(b, W, tcfg.n_kv_heads, tcfg.hd); tv = tk.clone(); tpos = torch.full((W,), -1, dtype=torch.int32)
    xs = np.random.default_rng(2).standard_normal((10, b, 1, jcfg.d_model), dtype=np.float32)
    for t in range(10):
        jy, jk, jv, jpos = jblocks.attention_decode(jcfg, jl, jnp.asarray(xs[t]), jk, jv, jpos, jnp.int32(t), window=window)
        ty, tk, tv, tpos = blocks.attention_decode(tcfg, tl, torch.from_numpy(xs[t]), tk, tv, tpos, t, window=window)
        _close(ty, jy, BLOCK_TOL)
    _close(tk, jk, BLOCK_TOL)
    _close(tv, jv, BLOCK_TOL)
    assert np.array_equal(tpos.numpy(), np.asarray(jpos))


@pytest.mark.parametrize("arch", ["granite-3-2b", "nemotron-4-340b"])  # swiglu, relu2
def test_dense_ffn_matches_the_reference(arch):
    jcfg, tcfg = _pair(arch)
    jp, tp = _params(jcfg, tcfg)
    jl, tl = _layer0(jp, tp)
    x = _x(jcfg)
    _close(blocks.dense_ffn(tcfg, tl, torch.from_numpy(x)), jblocks.dense_ffn(jcfg, jl, jnp.asarray(x)), BLOCK_TOL)


def test_ssd_block_and_decode_match_the_reference():
    jcfg, tcfg = _pair("mamba2-130m")
    jp, tp = _params(jcfg, tcfg)
    rng = np.random.default_rng(4)  # non-trivial A, D and dt bias (the reference inits them to 0, 1, 0)
    extra = {k: rng.standard_normal(jp["blocks"][k].shape, dtype=np.float32) * 0.5 for k in ("A_log", "D", "dt_bias")}
    jp["blocks"] = {**jp["blocks"], **{k: jnp.asarray(v) for k, v in extra.items()}}
    tp = lm_common.params_from_numpy(tcfg, jax.tree.map(lambda a: np.asarray(a, np.float32), jp), "cpu")
    jl, tl = _layer0(jp, tp)
    x = _x(jcfg)
    jy, js, jc = jblocks.ssd_block(jcfg, jl, jnp.asarray(x), return_state=True)
    ty, ts, tc = blocks.ssd_block(tcfg, tl, torch.from_numpy(x), return_state=True)
    for a, b in ((ty, jy), (ts, js), (tc, jc)):
        _close(a, b, BLOCK_TOL)
    assert tuple(ts.shape) == (2, tcfg.ssm_heads, tcfg.ssm_head_dim, tcfg.ssm_state)
    x1 = np.random.default_rng(5).standard_normal((2, 1, jcfg.d_model), dtype=np.float32)
    jout = jblocks.ssd_decode(jcfg, jl, jnp.asarray(x1), js, jc)
    tout = blocks.ssd_decode(tcfg, tl, torch.from_numpy(x1), ts, tc)
    for a, b in zip(tout, jout):
        _close(a, b, BLOCK_TOL)


# ---------------------------------------------------------------------------
# Prefill + decode, and the serving entry point
# ---------------------------------------------------------------------------


def _jit_step(jcfg):
    """The reference's ``serve_step`` under ``jax.jit`` (eager JAX takes
    about 0.7 s a token on the hybrid smoke model)."""
    return jax.jit(partial(jtf.serve_step, jcfg))


def _decode_from_scratch(jcfg, jp, toks, max_len):
    """The reference's cache after decoding ``toks`` [b, s] one token at a
    time from ``init_cache``, and the logits of its last step."""
    step, jc = _jit_step(jcfg), jtf.init_cache(jcfg, toks.shape[0], max_len)
    for t in range(toks.shape[1]):
        jl, jc = step(jp, jc, jnp.asarray(toks[:, t : t + 1], jnp.int32))
    return jl, jc


def _hybrid_params(jcfg, tcfg, seed=0):
    """Weights of a hybrid smoke model with non-trivial A, D and dt bias (the
    reference inits them to 0, 1, 0)."""
    jp, _ = _params(jcfg, tcfg, seed)
    rng = np.random.default_rng(seed + 4)
    jp["blocks"] = {**jp["blocks"], **{k: jnp.asarray(rng.standard_normal(jp["blocks"][k].shape, dtype=np.float32) * 0.5)
                                       for k in ("A_log", "D", "dt_bias")}}
    return jp, lm_common.params_from_numpy(tcfg, jax.tree.map(lambda a: np.asarray(a, np.float32), jp), "cpu")


@pytest.mark.parametrize(
    "arch,over",
    [(a, {}) for a in SERVED] + [("granite-3-2b", {"sliding_window": 6}), ("zamba2-2.7b", {"sliding_window": 6})],
)
def test_prefill_then_decode_matches_the_reference(arch, over):
    jcfg, tcfg = _pair(arch, **over)
    hybrid = jcfg.block_kind == "hybrid"
    jp, tp = _hybrid_params(jcfg, tcfg) if hybrid else _params(jcfg, tcfg)
    b, s, steps = 2, 16, 4
    full = {k: a.numpy() for k, a in tserve.make_batch(tcfg, b, s + steps, 7, "cpu").items()}  # + frames, patches
    toks = full["tokens"]
    inputs = {**full, "tokens": toks[:, :s]}
    # the reference's max_len counts the patches, the port's does not (module docstring)
    jl, jc = jtf.prefill_step(jcfg, jp, {k: jnp.asarray(a) for k, a in inputs.items()},
                              max_len=s + steps + jcfg.n_patches)
    with torch.inference_mode():
        tl, tc = transformer.prefill_step(tcfg, tp, {k: torch.from_numpy(a) for k, a in inputs.items()},
                                          max_len=s + steps)
    _close(tl, jl, PATH_TOL)
    assert tc["index"] == int(jc["index"])
    for key in ("k", "v", "pos", "ssm", "conv", "cross_k", "cross_v"):
        if key in jc:
            _close(tc[key], jc[key], PATH_TOL)
    if hybrid:  # decode continues against the reference's decode from scratch (module docstring)
        jl_scratch, jc = _decode_from_scratch(jcfg, jp, toks[:, :s], s + steps)
        _close(jl_scratch, jl, PATH_TOL)
        W = jc["shared_pos"].shape[1]
        assert tuple(tc["shared_k"].shape) == (jcfg.n_layers // jcfg.shared_attn_every, b, W, jcfg.n_kv_heads, jcfg.hd)
        for key in ("shared_k", "shared_v", "shared_pos", "ssm", "conv"):
            _close(tc[key], jc[key], PATH_TOL)
    jstep = _jit_step(jcfg) if hybrid else partial(jtf.serve_step, jcfg)
    for t in range(steps):
        tok = toks[:, s + t : s + t + 1]
        jl, jc = jstep(jp, jc, jnp.asarray(tok, jnp.int32))
        with torch.inference_mode():
            tl, tc = transformer.serve_step(tcfg, tp, tc, torch.from_numpy(tok))
        _close(tl, jl, PATH_TOL)
    assert tc["index"] == int(jc["index"]) == s + steps + jcfg.n_patches


def test_hybrid_decode_after_prefill_keeps_position_0():
    """max_len > s: the reference's prefill ring (width s) loses position 0
    at the first decode step; the port's (width max_len) keeps it."""
    jcfg, tcfg = _pair("zamba2-2.7b")
    jp, tp = _hybrid_params(jcfg, tcfg, seed=3)
    b, s, max_len = 2, 8, 12
    toks = np.random.default_rng(11).integers(0, jcfg.vocab, (b, s + 1))
    want, _ = _decode_from_scratch(jcfg, jp, toks, max_len)
    _, jc = jtf.prefill_step(jcfg, jp, {"tokens": jnp.asarray(toks[:, :s], jnp.int32)}, max_len=max_len)
    ref_after_prefill, jc = _jit_step(jcfg)(jp, jc, jnp.asarray(toks[:, s:], jnp.int32))
    with torch.inference_mode():
        _, tc = transformer.prefill_step(tcfg, tp, {"tokens": torch.from_numpy(toks[:, :s])}, max_len=max_len)
        got, tc = transformer.serve_step(tcfg, tp, tc, torch.from_numpy(toks[:, s:]))
    _close(got, want, PATH_TOL)
    assert tc["shared_pos"][:, 0].tolist() == [0] * tc["shared_pos"].shape[0]
    assert int(np.asarray(jc["shared_pos"])[0, 0]) == s  # the reference overwrote position 0 ...
    assert np.abs(np.asarray(ref_after_prefill) - np.asarray(want)).max() > 100 * PATH_TOL["atol"]  # ... and it shows


def test_hybrid_rejects_a_depth_that_is_not_whole_groups():
    cfg = dataclasses.replace(configs.get_smoke("zamba2-2.7b"), n_layers=3)
    with pytest.raises(ValueError, match="groups"):
        transformer.init_cache(cfg, 1, 8, "cpu")


def test_serve_block_decodes_greedily():
    jcfg, tcfg = _pair("granite-3-2b")
    _, tp = _params(jcfg, tcfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, tcfg.vocab, (2, 8)))
    with torch.inference_mode():
        _, c1 = transformer.prefill_step(tcfg, tp, {"tokens": toks}, max_len=12)
        _, c2 = transformer.prefill_step(tcfg, tp, {"tokens": toks}, max_len=12)
        step = transformer.make_serve_step(tcfg)
        tok = toks[:, -1:]
        for _ in range(3):
            logits, c1 = step(tp, c1, tok)
            tok = logits.argmax(-1)[:, None]
        blk, c2 = transformer.serve_block(dataclasses.replace(tcfg, decode_block=3), tp, c2, toks[:, -1:])
    assert torch.equal(blk, logits) and c2["index"] == c1["index"] == 11


def test_init_cache_matches_the_reference_layout():
    for arch, over in (("granite-3-2b", {}), ("granite-3-2b", {"sliding_window": 6}), ("mamba2-130m", {}),
                       ("zamba2-2.7b", {}), ("zamba2-2.7b", {"sliding_window": 6})):
        jcfg, tcfg = _pair(arch, **over)
        jc = jtf.init_cache(jcfg, 2, 20)
        tc = transformer.init_cache(tcfg, 2, 20, "cpu")
        assert set(tc) == set(jc)
        for k in jc:
            if k != "index":
                _close(tc[k], jc[k], dict(rtol=0, atol=0))


@pytest.mark.parametrize("arch", ["granite-3-2b", "mamba2-130m", "phi3.5-moe-42b", "llama4-scout-17b"])
def test_serve_tokens_equal_the_reference(arch, monkeypatch):
    """The reference's weights stand in for the port's own draw."""
    jcfg, tcfg = _pair(arch)
    _, tp = _params(jcfg, tcfg, seed=0)
    monkeypatch.setattr(tserve, "init_params", lambda cfg, generator, device: tp)
    kw = dict(batch=2, prompt_len=16, gen=6, seed=0)
    ref = jserve.serve(jcfg, **kw)
    out = tserve.serve(tcfg, **kw, device="cpu")
    assert np.array_equal(out["tokens"].numpy(), np.asarray(ref["tokens"]))
    assert out["prefill_s"] > 0 and out["decode_tok_per_s"] > 0


def test_serve_runs_zamba2_as_the_reference_decodes_from_scratch(monkeypatch):
    """The same entry point serves the hybrid; its greedy tokens equal the
    reference's greedy decode of the whole sequence from scratch."""
    jcfg, tcfg = _pair("zamba2-2.7b")
    jp, tp = _hybrid_params(jcfg, tcfg)
    monkeypatch.setattr(tserve, "init_params", lambda cfg, generator, device: tp)
    b, s, gen = 2, 16, 6
    out = tserve.serve(tcfg, batch=b, prompt_len=s, gen=gen, seed=0, device="cpu")
    prompt = tserve.make_batch(tcfg, b, s, 0, "cpu")["tokens"].numpy()
    logits, jc = _decode_from_scratch(jcfg, jp, prompt, s + gen)
    step, want = _jit_step(jcfg), []
    for _ in range(gen):
        tok = np.asarray(jnp.argmax(logits, -1))[:, None]
        want.append(tok)
        logits, jc = step(jp, jc, jnp.asarray(tok, jnp.int32))
    assert np.array_equal(out["tokens"].numpy(), np.concatenate(want, 1))


def test_serve_draws_its_own_weights_from_the_seed():
    cfg = configs.get_smoke("mamba2-130m")
    a = tserve.serve(cfg, batch=2, prompt_len=8, gen=3, seed=1, device="cpu")
    b = tserve.serve(cfg, batch=2, prompt_len=8, gen=3, seed=1, device="cpu")
    assert torch.equal(a["tokens"], b["tokens"]) and tuple(a["tokens"].shape) == (2, 3)
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < cfg.vocab

