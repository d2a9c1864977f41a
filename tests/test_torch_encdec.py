"""The port's enc-dec (whisper) and patch-prefix (internvl) serving, and
flash attention over a key length other than the query's, against the JAX
package on the CPU.

Weights come from the reference's ``init_params`` and cross through numpy;
inputs come from numpy with a seed.  Everything runs in fp32, as in
``tests/test_torch_lm.py``, with its tolerances: 2e-4 per block and for
attention (the reference's kernel tolerance), 3e-4 for prefill + decode
logits and caches (``PATH_TOL``).

Flash attention over ``Skv != Sq`` is held against the reference's
``blocks._sdpa`` (XLA), which whisper's cross attention runs: the reference's
Pallas kernel takes one length for q, k and v.  internvl's decode after
prefill is held against the reference's prefill over the longer sequence:
the reference's own prefill ring drops patch 0 when ``n_patches >= gen``
(ROADMAP.md queue 3), which ``test_patch_decode_after_prefill_keeps_patch_0``
pins.
"""

import dataclasses

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
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve as tserve
from repro_torch.models import blocks, lm_common, transformer

ATTN_TOL = dict(rtol=2e-4, atol=2e-4)
BLOCK_TOL = dict(rtol=2e-4, atol=2e-4)
PATH_TOL = dict(rtol=3e-4, atol=3e-4)


def _pair(arch: str, **over):
    """(reference cfg, port cfg) of an arch's smoke config in fp32."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), dtype=jnp.float32, **over)
    tcfg = dataclasses.replace(configs.get_smoke(arch), dtype=torch.float32, **over)
    return jcfg, tcfg


def _params(jcfg, tcfg, seed=0):
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, lm_common.params_from_numpy(tcfg, jax.tree.map(lambda a: np.asarray(a, np.float32), jp), "cpu")


def _close(actual, desired, tol):
    actual = actual.detach().numpy() if isinstance(actual, torch.Tensor) else np.asarray(actual)
    np.testing.assert_allclose(actual, np.asarray(desired), **tol)


def _batch(cfg, b, s, seed):
    """``make_batch``'s serving inputs as numpy: tokens [b, s], whisper's
    frames, internvl's patches (the reference ``serve``'s draws:
    ``test_make_batch_draws_the_reference_inputs``)."""
    return {k: a.numpy() for k, a in tserve.make_batch(cfg, b, s, seed, "cpu").items()}


def _j(inputs):
    return {k: jnp.asarray(a, jnp.int32 if k == "tokens" else jnp.float32) for k, a in inputs.items()}


def _t(inputs):
    return {k: torch.from_numpy(a) for k, a in inputs.items()}


# ---------------------------------------------------------------------------
# Flash attention over a key length other than the query's
# ---------------------------------------------------------------------------


def _attn_inputs(b, h, kvh, sq, skv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d), dtype=np.float32),
            rng.standard_normal((b, kvh, skv, d), dtype=np.float32),
            rng.standard_normal((b, kvh, skv, d), dtype=np.float32))


def _sdpa_ref(q, k, v, *, causal, window):
    """The reference's ``blocks._sdpa`` on [B, H, S, D] numpy arrays, q
    chunks of 4 (so the chunked path runs where Sq divides), -> [B, H, Sq, D]."""
    b, h, sq, d = q.shape
    cfg = dataclasses.replace(jconfigs.get_smoke("granite-3-2b"), dtype=jnp.float32, attn_q_block=4,
                              n_heads=h, n_kv_heads=k.shape[1], head_dim=d)
    out = jblocks._sdpa(cfg, *(jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v)), causal=causal, window=window)
    return np.asarray(out).reshape(b, sq, h, d).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("sq,skv", [(1, 20), (8, 20), (20, 8), (16, 75)])
@pytest.mark.parametrize("causal,window", [(False, 0), (True, 0), (True, 16)])
@pytest.mark.parametrize("h,kvh", [(4, 4), (4, 2)])
def test_flash_plain_over_another_key_length_matches_sdpa(sq, skv, causal, window, h, kvh):
    q, k, v = _attn_inputs(2, h, kvh, sq, skv, 32, seed=sq * 100 + skv)
    y = fa.flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal, window=window)
    assert tuple(y.shape) == (2, h, sq, 32)
    np.testing.assert_allclose(y.numpy(), _sdpa_ref(q, k, v, causal=causal, window=window), **ATTN_TOL)


def test_flash_plain_row_that_sees_no_key_is_nan_as_in_sdpa():
    """Sq 20 against Skv 8 under a causal window of 5: rows 12 and on see
    no key (j <= 7 and j > i - 5), and are NaN in both."""
    q, k, v = _attn_inputs(1, 2, 1, 20, 8, 32, seed=3)
    y = fa.flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)), causal=True, window=5).numpy()
    want = _sdpa_ref(q, k, v, causal=True, window=5)
    assert np.isnan(y[:, :, 12:]).all() and np.isnan(want[:, :, 12:]).all()
    np.testing.assert_allclose(y[:, :, :12], want[:, :, :12], **ATTN_TOL)


# ---------------------------------------------------------------------------
# Whisper's blocks
# ---------------------------------------------------------------------------


def _whisper(seed=0):
    jcfg, tcfg = _pair("whisper-small")
    jp, tp = _params(jcfg, tcfg, seed)
    return jcfg, tcfg, jp, tp


def test_cross_attention_and_its_kv_match_the_reference():
    jcfg, tcfg, jp, tp = _whisper()
    jl, tl = jax.tree.map(lambda a: a[1], jp["cross"]), lm_common.layer(tp["cross"], 1)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, jcfg.d_model), dtype=np.float32)
    enc = rng.standard_normal((2, jcfg.enc_frames, jcfg.d_model), dtype=np.float32)
    tk, tv = blocks.cross_kv(tcfg, tl, torch.from_numpy(enc))
    ty = blocks.cross_attention(tcfg, tl, torch.from_numpy(x), tk, tv)
    _close(ty, jblocks.cross_attention(jcfg, jl, jnp.asarray(x), jnp.asarray(enc)), BLOCK_TOL)
    # the cross K/V the reference's prefill() keeps in the cache
    shape = (2, jcfg.enc_frames, jcfg.n_kv_heads, jcfg.hd)
    _close(tk, (jnp.asarray(enc) @ jl["wk"]).reshape(shape), BLOCK_TOL)
    _close(tv, (jnp.asarray(enc) @ jl["wv"]).reshape(shape), BLOCK_TOL)


def test_cross_attention_decode_matches_the_reference_inline_step():
    """The reference's decode cross attention, written inline in its
    ``serve_step``: rms_norm, q, ``_sdpa`` over every frame, ``wo``."""
    jcfg, tcfg, jp, tp = _whisper()
    jl, tl = jax.tree.map(lambda a: a[0], jp["cross"]), lm_common.layer(tp["cross"], 0)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 1, jcfg.d_model), dtype=np.float32)
    kv = [rng.standard_normal((3, jcfg.enc_frames, jcfg.n_kv_heads, jcfg.hd), dtype=np.float32) for _ in range(2)]
    hq = jlm.rms_norm(jnp.asarray(x), jl["ln"], jcfg.norm_eps)
    q = (hq @ jl["wq"]).reshape(3, 1, jcfg.n_heads, jcfg.hd)
    want = jnp.asarray(x) + jblocks._sdpa(jcfg, q, *map(jnp.asarray, kv), causal=False) @ jl["wo"]
    got = blocks.cross_attention_decode(tcfg, tl, torch.from_numpy(x), *map(torch.from_numpy, kv))
    _close(got, want, BLOCK_TOL)


def test_encoder_and_prefill_match_the_reference():
    jcfg, tcfg, jp, tp = _whisper(seed=1)
    frames = np.random.default_rng(3).standard_normal((2, jcfg.enc_frames, jcfg.d_model), dtype=np.float32)
    _close(transformer.encoder(tcfg, tp, torch.from_numpy(frames)), jtf.encoder(jcfg, jp, jnp.asarray(frames)),
           BLOCK_TOL)
    jc = jtf.prefill(jcfg, jp, {"frames": jnp.asarray(frames)}, jtf.init_cache(jcfg, 2, 20))
    tc = transformer.prefill(tcfg, tp, {"frames": torch.from_numpy(frames)}, transformer.init_cache(tcfg, 2, 20, "cpu"))
    assert set(tc) == set(jc)
    for key in ("cross_k", "cross_v"):
        _close(tc[key], jc[key], PATH_TOL)
    cache = transformer.init_cache(configs.get_smoke("granite-3-2b"), 1, 4, "cpu")  # not enc-dec: as it is
    assert transformer.prefill(configs.get_smoke("granite-3-2b"), tp, {}, cache) is cache


# ---------------------------------------------------------------------------
# Whisper: prefill and decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [16, 30, 40])
def test_whisper_prefill_then_decode_matches_the_reference(s):
    """Prompts under and over ``max_decoder_len`` (32), the ring sized 32
    whatever ``max_len`` says, then 4 decode steps: prompt 30 and prompt 40
    (cut to 32) wrap the ring."""
    jcfg, tcfg, jp, tp = _whisper(seed=2)
    b, steps = 2, 4
    full = _batch(tcfg, b, s + steps, seed=s)
    toks = full["tokens"]
    inputs = {**full, "tokens": toks[:, :s]}
    jl, jc = jtf.prefill_step(jcfg, jp, _j(inputs), max_len=s + steps)
    with torch.inference_mode():
        tl, tc = transformer.prefill_step(tcfg, tp, _t(inputs), max_len=s + steps)
    _close(tl, jl, PATH_TOL)
    W, kept = jcfg.max_decoder_len, min(s, jcfg.max_decoder_len)
    assert tc["index"] == int(jc["index"]) == kept and tuple(tc["k"].shape)[2] == W
    assert set(tc) == set(jc)
    for key in ("k", "v", "pos", "cross_k", "cross_v"):
        _close(tc[key], jc[key], PATH_TOL)
    step = jax.jit(lambda p, c, t: jtf.serve_step(jcfg, p, c, t))
    for t in range(steps):
        tok = toks[:, s + t : s + t + 1]
        jl, jc = step(jp, jc, jnp.asarray(tok, jnp.int32))
        with torch.inference_mode():
            tl, tc = transformer.serve_step(tcfg, tp, tc, torch.from_numpy(tok))
        _close(tl, jl, PATH_TOL)
    for key in ("k", "v", "pos"):
        _close(tc[key], jc[key], PATH_TOL)
    assert tc["index"] == int(jc["index"]) == kept + steps
    if kept + steps > W:  # the ring wrapped: slot 0 holds the newest position
        assert int(tc["pos"][0, 0]) == W


# ---------------------------------------------------------------------------
# internvl: the patch prefix
# ---------------------------------------------------------------------------


def _internvl(seed=0):
    jcfg, tcfg = _pair("internvl2-76b")
    jp, tp = _params(jcfg, tcfg, seed)
    return jcfg, tcfg, jp, tp


def _ref_prefill_logits(jcfg, jp, inputs):
    """The reference's prefill logits over ``inputs`` (patches and tokens)."""
    return jtf.prefill_step(jcfg, jp, _j(inputs))[0]


def test_internvl_prefill_and_decode_match_the_reference_over_the_longer_sequence():
    """Prefill logits and cache against the reference's ``prefill_step``
    (given ``max_len + n_patches``, its ring as wide as the port's); each
    decode step against the reference's prefill over the longer sequence."""
    jcfg, tcfg, jp, tp = _internvl(seed=1)
    b, s, steps = 2, 10, 4
    full = _batch(tcfg, b, s + steps, seed=5)
    toks = full["tokens"]
    inputs = {**full, "tokens": toks[:, :s]}
    jl, jc = jtf.prefill_step(jcfg, jp, _j(inputs), max_len=s + steps + jcfg.n_patches)
    with torch.inference_mode():
        tl, tc = transformer.prefill_step(tcfg, tp, _t(inputs), max_len=s + steps)
    _close(tl, jl, PATH_TOL)
    assert tc["index"] == int(jc["index"]) == jcfg.n_patches + s
    assert tuple(tc["k"].shape)[2] == jcfg.n_patches + s + steps
    for key in ("k", "v", "pos"):
        _close(tc[key], jc[key], PATH_TOL)
    for t in range(steps):
        with torch.inference_mode():
            tl, tc = transformer.serve_step(tcfg, tp, tc, torch.from_numpy(toks[:, s + t : s + t + 1]))
        _close(tl, _ref_prefill_logits(jcfg, jp, {**inputs, "tokens": toks[:, : s + t + 1]}), PATH_TOL)


def test_patch_decode_after_prefill_keeps_patch_0():
    """``n_patches`` (8) >= gen: the reference's prefill ring (max_len 12 <
    s 16, so width s) loses patch 0 at the first decode step; the port's
    (width max_len + n_patches) keeps it."""
    jcfg, tcfg, jp, tp = _internvl(seed=3)
    b, s, max_len = 2, 8, 12
    full = _batch(tcfg, b, s + 1, seed=11)
    toks = full["tokens"]
    inputs = {**full, "tokens": toks[:, :s]}
    want = _ref_prefill_logits(jcfg, jp, {**inputs, "tokens": toks})
    _, jc = jtf.prefill_step(jcfg, jp, _j(inputs), max_len=max_len)
    ref_after_prefill, jc = jtf.serve_step(jcfg, jp, jc, jnp.asarray(toks[:, s:], jnp.int32))
    with torch.inference_mode():
        _, tc = transformer.prefill_step(tcfg, tp, _t(inputs), max_len=max_len)
        got, tc = transformer.serve_step(tcfg, tp, tc, torch.from_numpy(toks[:, s:]))
    _close(got, want, PATH_TOL)
    assert tc["pos"][:, 0].tolist() == [0] * jcfg.n_layers
    assert int(np.asarray(jc["pos"])[0, 0]) == jcfg.n_patches + s  # the reference overwrote patch 0 ...
    assert np.abs(np.asarray(ref_after_prefill) - np.asarray(want)).max() > 100 * PATH_TOL["atol"]  # ... and it shows


# ---------------------------------------------------------------------------
# Caches and the serving entry point
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["whisper-small", "internvl2-76b"])
@pytest.mark.parametrize("max_len", [20, 40])
def test_init_cache_matches_the_reference_layout(arch, max_len):
    """whisper's ring is min(max_len, max_decoder_len 32) wide.  The port's
    ``max_len`` counts tokens and the reference's positions, so the
    reference is given ``max_len + n_patches`` (0 for whisper)."""
    jcfg, tcfg = _pair(arch)
    jc = jtf.init_cache(jcfg, 2, max_len + jcfg.n_patches)
    tc = transformer.init_cache(tcfg, 2, max_len, "cpu")
    assert set(tc) == set(jc)
    for k in jc:
        if k != "index":
            _close(tc[k], jc[k], dict(rtol=0, atol=0))


def test_make_batch_draws_the_reference_inputs():
    """tokens, then frames, then patches from one default_rng(seed), as the
    reference's ``serve`` draws them."""
    for arch, key, n in (("whisper-small", "frames", "enc_frames"), ("internvl2-76b", "patch_embeds", "n_patches")):
        cfg = configs.get_smoke(arch)
        got = tserve.make_batch(cfg, 3, 5, 7, "cpu")
        rng = np.random.default_rng(7)
        assert np.array_equal(got["tokens"].numpy(), rng.integers(0, cfg.vocab, (3, 5)))
        want = rng.standard_normal((3, getattr(cfg, n), cfg.d_model)).astype(np.float32)
        assert set(got) == {"tokens", key} and np.array_equal(got[key].numpy(), want)


def test_serve_whisper_tokens_equal_the_reference(monkeypatch):
    """The reference's weights stand in for the port's own draw; a prompt of
    40 is cut to 32 and decode wraps the ring."""
    jcfg, tcfg, _, tp = _whisper(seed=0)
    monkeypatch.setattr(tserve, "init_params", lambda cfg, generator, device: tp)
    kw = dict(batch=2, prompt_len=40, gen=6, seed=0)
    ref = jserve.serve(jcfg, **kw)
    out = tserve.serve(tcfg, **kw, device="cpu")
    assert np.array_equal(out["tokens"].numpy(), np.asarray(ref["tokens"]))


def test_serve_internvl_tokens_equal_the_reference_greedy_decode_from_full_prefills(monkeypatch):
    """Each greedy token equals the reference's argmax after a prefill over
    the patches and every token so far (the reference's own prefill + decode
    loses patch 0 here: ``n_patches`` 8 >= gen 6)."""
    jcfg, tcfg, jp, tp = _internvl(seed=0)
    monkeypatch.setattr(tserve, "init_params", lambda cfg, generator, device: tp)
    b, s, gen = 2, 12, 6
    out = tserve.serve(tcfg, batch=b, prompt_len=s, gen=gen, seed=0, device="cpu")
    inputs = _batch(tcfg, b, s, seed=0)
    toks = inputs["tokens"]
    for _ in range(gen):
        nxt = np.asarray(jnp.argmax(_ref_prefill_logits(jcfg, jp, {**inputs, "tokens": toks}), -1))[:, None]
        toks = np.concatenate([toks, nxt], 1)
    assert np.array_equal(out["tokens"].numpy(), toks[:, s:])
