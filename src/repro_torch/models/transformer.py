"""Model assembly: training loss and step, prefill and ring-cache decode.

Port of ``repro/models/transformer.py`` for every block kind: ``attn`` (GQA with ``qkv_bias``, ``qk_norm`` and
``sliding_window``; a swiglu or relu2 FFN, or a top-k MoE FFN with an
optional shared expert), ``ssd`` (Mamba2), ``hybrid`` (zamba2: groups of
``shared_attn_every`` Mamba2 layers, each followed by one shared attention
block and shared SwiGLU FFN, a single parameter set with a ring KV cache per
application), enc-dec (whisper: a bidirectional encoder over the stubbed
frame embeddings, decoder layers with self and cross attention) and the
patch prefix (internvl: projected patch embeddings before the tokens).

  * ``train_loss(cfg, params, batch)`` — full forward and chunked
    cross-entropy (``backbone``, ``decoder_with_cross``, ``lm_head_loss``),
    plus ``0.01 * aux`` of the MoE router; ``make_train_step(cfg, optimizer,
    accum)`` — loss, gradients (summed over microbatches in
    ``cfg.accum_dtype``) and the optimizer's update.  Remat ``"full"`` is
    ``torch.utils.checkpoint`` per layer, as the reference checkpoints its
    scan body.  On the card, attention and its gradient run on the flash
    kernels, the SSD scan and its gradient on the scan's kernels, and the
    MoE expert products and their gradients on the GEMM kernel
    (``kernels/ops.py``).  Layers are taken with one ``torch.unbind`` of each ``[L, ...]``
    stack a step, whose backward is one ``stack``: indexing the stack per
    layer would materialise a zero tensor of the whole stack per layer in
    the backward.
  * ``init_cache(cfg, batch, max_len, device)`` — decode state.
  * ``encoder(cfg, params, frames)`` / ``prefill(cfg, params, batch, cache)``
    — whisper's encoder, and its cross K/V written into a cache.
  * ``prefill_step(cfg, params, batch, max_len)`` — prompt forward that
    emits the decode cache; attention (self and cross) runs on the flash
    kernel, the SSD scan on the chunk-scan kernel, the MoE expert products
    (here and in decode) on the batched GEMM kernel.
  * ``serve_step(cfg, params, cache, tokens)`` — one-token decode.
  * ``serve_block`` / ``make_serve_step`` — ``decode_block`` tokens per call.
  * ``layer_costs(cfg, seq, batch)`` — the scheduler's static per-block
    costs (``core/cost_model.py``), from the config alone.

The layer loop is a Python loop over views of the ``[L, ...]`` stacks where
the reference has ``lax.scan``.  The cache is a dict of stacked tensors as
in the reference, with ``index`` a Python int; decode updates it in place
(the reference returns a new pytree) and returns it.  MoE layers drop the
router's auxiliary loss, as the reference's serving does.  Prefill and
decode run under ``torch.inference_mode()``.

Enc-dec, as the reference: the decoder ring is ``max_decoder_len`` wide
(whisper's 448) whatever ``max_len`` says, the prompt is cut to that
length, and decode wraps the ring past it.  The reference's prefill runs
the encoder twice (in ``prefill`` and again for the decoder's cross
attention); the port runs it once, in ``prefill``, and its prefill cross
attention reads the cross K/V that ``prefill`` wrote into the cache, which
gives the same values.

Where the port departs from the reference on purpose, both times so that
the first decode step after prefill keeps position 0 (ROADMAP.md queue 3):
- a hybrid prefill gives the shared ring the ``attn`` path's width,
  ``max(max_len, s)`` capped by the window.  The reference's sizes it
  ``min(s, window)`` and ignores ``max_len``
  (``repro/models/transformer.py:542``); the port's continuation equals
  decoding the whole sequence from scratch.
- ``max_len`` counts tokens (prompt plus generated, as ``serve`` computes
  it) in ``init_cache`` and ``prefill_step`` alike, and a patch prefix's ring
  holds ``max_len + n_patches`` positions (``_ring_width``).  The
  reference's ``max_len`` counts positions, patches included, but its
  ``serve`` passes the token count, so its prefill ring is ``max(max_len,
  s)`` with ``s`` counting the patches (``repro/models/transformer.py:501``):
  when ``n_patches >= gen`` it is exactly ``s`` wide and the first decode
  step overwrites patch 0.  The port's continuation equals the reference's
  prefill over the longer sequence; given ``max_len``, the port's caches
  equal the reference's given ``max_len + n_patches``.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import torch
from torch.utils.checkpoint import checkpoint

from .. import tree
from . import blocks
from .lm_common import LMConfig, layer, rms_norm


def _check_supported(cfg: LMConfig) -> None:
    """Raise for a config no path of the port serves."""
    if cfg.block_kind not in ("attn", "ssd", "hybrid"):
        raise ValueError(cfg.block_kind)
    if cfg.block_kind == "hybrid" and cfg.n_layers % cfg.shared_attn_every:
        raise ValueError(f"{cfg.n_layers} layers are not whole groups of {cfg.shared_attn_every}")


def _ffn(cfg: LMConfig, lp: dict, x: torch.Tensor) -> torch.Tensor:
    """The FFN sublayer of an ``attn`` layer: MoE (aux loss dropped) or dense."""
    if cfg.is_moe:
        return blocks.moe_ffn(cfg, lp, x)[0]
    return blocks.dense_ffn(cfg, lp, x)


def embed_tokens(cfg: LMConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens]


def _layers(cfg: LMConfig, params: dict) -> list[dict]:
    return [layer(params["blocks"], i) for i in range(cfg.n_layers)]


def _n_groups(cfg: LMConfig) -> int:
    """Applications of the hybrid's shared block: one after every group of
    ``shared_attn_every`` SSD layers."""
    return cfg.n_layers // cfg.shared_attn_every


def _shared(cfg: LMConfig, params: dict) -> tuple[LMConfig, dict]:
    """The hybrid's shared block: its FFN's config (always SwiGLU) and its
    one parameter set (the ``[1, ...]`` stacks' only slice)."""
    return dataclasses.replace(cfg, ffn_kind="swiglu", n_experts=0), layer(params["shared"], 0)


def _kv_ring(cfg: LMConfig, L: int, batch: int, W: int, device) -> dict:
    """``L`` empty ring KV caches of ``W`` slots (position -1: empty)."""
    return {
        "k": torch.zeros((L, batch, W, cfg.n_kv_heads, cfg.hd), dtype=cfg.dtype, device=device),
        "v": torch.zeros((L, batch, W, cfg.n_kv_heads, cfg.hd), dtype=cfg.dtype, device=device),
        "pos": torch.full((L, W), -1, dtype=torch.int32, device=device),
    }


def _prefill_ring(cfg: LMConfig, L: int, batch: int, s: int, W: int, device):
    """``L`` ring KV caches of ``W`` slots for a prefill of ``s`` positions,
    with the positions they will keep: the last ``W``, at slot ``pos % W``
    (all of them at slot ``pos`` when ``W >= s``).  Returns the ring, those
    positions and their slots; the caller stores cache ``i``'s K and V as
    ``ring["k"][i, :, slots] = k[:, kept]``."""
    ring = _kv_ring(cfg, L, batch, W, device)
    kept = torch.arange(max(s - W, 0), s, device=device)
    slots = kept % W
    ring["pos"][:, slots] = kept.to(torch.int32)
    return ring, kept, slots


def _ring_width(cfg: LMConfig, max_len: int, s: int = 0, *, window: bool = True) -> int:
    """Slots of a ring KV cache for ``max_len`` tokens (prompt plus
    generated), the one rule of ``init_cache`` and ``prefill_step``: the
    patch prefix on top, at least a prefill's ``s`` positions, at most the
    sliding window (not for an ``attn`` prefill, ``window=False``, which
    keeps all ``s`` as the reference's does); enc-dec's decoder ring at most
    ``max_decoder_len``."""
    if cfg.is_encdec:
        return min(max_len, cfg.max_decoder_len or max_len)
    W = max(max_len + cfg.n_patches, s)
    return min(W, cfg.sliding_window) if window and cfg.sliding_window else W


def init_cache(cfg: LMConfig, batch: int, max_len: int, device: str | torch.device = "cuda") -> dict:
    """Decode state for ``max_len`` tokens: ring KV cache for attention, SSM
    and conv state for SSD, both for hybrid (the ring as ``shared_k`` /
    ``shared_v`` / ``shared_pos``, one per application of the shared block);
    enc-dec: a decoder ring of ``min(max_len, max_decoder_len)`` slots and
    the cross K/V ``cross_k`` / ``cross_v`` [L, batch, enc_frames, kvh, hd]
    that prefill fills."""
    _check_supported(cfg)
    W = _ring_width(cfg, max_len)
    L = cfg.n_layers
    if cfg.is_encdec:
        kv = (L, batch, cfg.enc_frames, cfg.n_kv_heads, cfg.hd)
        return {"index": 0, **_kv_ring(cfg, L, batch, W, device),
                "cross_k": torch.zeros(kv, dtype=cfg.dtype, device=device),
                "cross_v": torch.zeros(kv, dtype=cfg.dtype, device=device)}
    if cfg.block_kind == "attn":
        return {"index": 0, **_kv_ring(cfg, L, batch, W, device)}
    cache = {
        "index": 0,
        "ssm": torch.zeros((L, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state), dtype=cfg.dtype,
                           device=device),
        "conv": torch.zeros((L, batch, 3, cfg.d_inner + 2 * cfg.ssm_state), dtype=cfg.dtype, device=device),
    }
    if cfg.block_kind == "hybrid":
        cache.update({f"shared_{k}": v for k, v in _kv_ring(cfg, _n_groups(cfg), batch, W, device).items()})
    return cache


def _unbind(stacks: dict) -> list[dict]:
    """Per-layer parameter dicts from the ``[L, ...]`` stacks, by one
    ``torch.unbind`` of each stack (its backward is one ``stack``)."""
    cols = {k: torch.unbind(v) for k, v in stacks.items()}
    return [dict(zip(cols, parts)) for parts in zip(*cols.values())]


def _recompute(on: bool, fn, *args):
    """``fn(*args)``; with ``on``, and when a graph is being recorded, its
    activations are dropped and recomputed in the backward (the reference's
    ``jax.checkpoint``)."""
    if on and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _remat(cfg: LMConfig, fn, *args):
    """One layer, recomputed in the backward under ``remat == "full"``, as the
    reference checkpoints its scan body."""
    return _recompute(cfg.remat == "full", fn, *args)


def _encoder_layer(cfg: LMConfig, lp: dict, h: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    return blocks.dense_ffn(cfg, lp, blocks.attention(cfg, lp, h, positions, causal=False))


def encoder(cfg: LMConfig, params: dict, frames: torch.Tensor) -> torch.Tensor:
    """Whisper's encoder: bidirectional attention over the (stubbed) frame
    embeddings [b, se, d_model], RoPE over frame positions, ``enc_ln_f`` at
    the end.  Returns [b, se, d_model] in ``cfg.dtype``."""
    enc_cfg = dataclasses.replace(cfg, n_experts=0, ffn_kind="swiglu", sliding_window=0)  # dense, no window
    h = frames.to(cfg.dtype)
    b, se, _ = h.shape
    positions = torch.arange(se, dtype=torch.int32, device=h.device)[None, :].expand(b, se)
    for lp in _unbind(params["enc_blocks"]):
        h = _remat(cfg, _encoder_layer, enc_cfg, lp, h, positions)
    return rms_norm(h, params["enc_ln_f"], cfg.norm_eps)


@torch.inference_mode()
def prefill(cfg: LMConfig, params: dict, batch: dict, cache: dict) -> dict:
    """Encoder pass and cross K/V warm-up (enc-dec; any other model's cache
    is returned as it is): ``cache`` with ``cross_k`` / ``cross_v`` of every
    decoder layer computed from ``batch["frames"]``."""
    if not cfg.is_encdec:
        return cache
    enc_out = encoder(cfg, params, batch["frames"])
    kv = [blocks.cross_kv(cfg, layer(params["cross"], i), enc_out) for i in range(cfg.n_layers)]
    return {**cache, "cross_k": torch.stack([k for k, _ in kv]), "cross_v": torch.stack([v for _, v in kv])}


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def _xent_chunk(h: torch.Tensor, unembed: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Summed masked next-token NLL of one sequence chunk: fp32 logits, the
    log-sum-exp with the max held out of the gradient."""
    logits = (h @ unembed).float()
    m = logits.detach().amax(-1, keepdim=True)
    logz = torch.log(torch.exp(logits - m).sum(-1)) + m[..., 0]
    gold = logits.gather(-1, labels.clamp_min(0)[..., None])[..., 0]  # a masked label's gold is multiplied by 0
    return ((logz - gold) * mask).sum()


def lm_head_loss(cfg: LMConfig, params: dict, h: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Chunked softmax cross-entropy over h [b, s, d]: never holds [b, s,
    vocab] at once.  The chunk is the first of ``loss_chunk``, 512, 256, ...
    1 that divides s; each chunk's logits are recomputed in the backward
    (``torch.utils.checkpoint``).  The unembedding product stays
    ``torch.matmul``, as the reference leaves it to XLA.  Returns the mean
    over ``mask``, fp32."""
    s = h.shape[1]
    cs = next((c for c in (cfg.loss_chunk, 512, 256, 128, 64, 32, 16, 8, 4, 2, 1) if s % c == 0), s)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s, cs):
        total = total + _recompute(True, _xent_chunk, h[:, c0 : c0 + cs], params["unembed"],
                                   labels[:, c0 : c0 + cs], mask[:, c0 : c0 + cs])
    return total / mask.sum().clamp_min(1)


def _attn_layer(cfg: LMConfig, lp: dict, x: torch.Tensor, positions: torch.Tensor):
    """One ``attn`` layer of the training forward: (x, the MoE router's aux loss or 0)."""
    x = blocks.attention(cfg, lp, x, positions, causal=True, window=cfg.sliding_window)
    if cfg.is_moe:
        return blocks.moe_ffn(cfg, lp, x)
    return blocks.dense_ffn(cfg, lp, x), torch.zeros((), dtype=torch.float32, device=x.device)


def backbone(cfg: LMConfig, params: dict, x: torch.Tensor, positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The layer stack over embedded inputs x [b, s, d]: (``ln_f``-normed h,
    the sum of the MoE layers' aux losses, fp32).  ``remat == "full"``
    recomputes each layer in the backward; a hybrid's shared block is not
    recomputed, as in the reference."""
    _check_supported(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.block_kind == "attn":
        for lp in _unbind(params["blocks"]):
            x, a = _remat(cfg, _attn_layer, cfg, lp, x, positions)
            aux = aux + a
    else:
        if cfg.block_kind == "hybrid":
            ffn_cfg, shared = _shared(cfg, params)
        for i, lp in enumerate(_unbind(params["blocks"])):
            x = _remat(cfg, blocks.ssd_block, cfg, lp, x)
            if cfg.block_kind == "hybrid" and (i + 1) % cfg.shared_attn_every == 0:
                x = blocks.attention(cfg, shared, x, positions, causal=True, window=cfg.sliding_window)
                x = blocks.dense_ffn(ffn_cfg, shared, x)
    return rms_norm(x, params["ln_f"], cfg.norm_eps), aux


def _decoder_layer(cfg: LMConfig, lp: dict, cp: dict, x: torch.Tensor, positions: torch.Tensor,
                   enc_out: torch.Tensor) -> torch.Tensor:
    x = blocks.attention(cfg, lp, x, positions, causal=True)
    x = blocks.cross_attention(cfg, cp, x, *blocks.cross_kv(cfg, cp, enc_out))
    return blocks.dense_ffn(cfg, lp, x)


def decoder_with_cross(cfg: LMConfig, params: dict, x: torch.Tensor, positions: torch.Tensor,
                       enc_out: torch.Tensor) -> torch.Tensor:
    """Whisper's decoder for training: causal self attention, cross
    attention over ``enc_out`` with each layer's cross K/V computed from it
    (so the gradient reaches the encoder), the dense FFN; ``ln_f``-normed."""
    for lp, cp in zip(_unbind(params["blocks"]), _unbind(params["cross"])):
        x = _remat(cfg, _decoder_layer, cfg, lp, cp, x, positions, enc_out)
    return rms_norm(x, params["ln_f"], cfg.norm_eps)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None, :].expand(b, s)


def train_loss(cfg: LMConfig, params: dict, batch: dict) -> torch.Tensor:
    """Next-token loss for any architecture family: batch ``tokens`` and
    ``labels`` [b, s] (labels < 0 masked), with ``frames`` for enc-dec and
    ``patch_embeds`` for a patch prefix (whose positions count the patches
    and whose outputs the loss drops).  MoE adds ``0.01 * aux``.  One
    device: training over a mesh of cards waits for ROADMAP.md queue 1
    item 7."""
    _check_supported(cfg)
    tokens, labels = batch["tokens"], batch["labels"]
    x = embed_tokens(cfg, params, tokens)
    if cfg.is_encdec:
        enc_out = encoder(cfg, params, batch["frames"])
        h = decoder_with_cross(cfg, params, x, _positions(*tokens.shape, x.device), enc_out)
        return lm_head_loss(cfg, params, h, labels, labels >= 0)
    if cfg.n_patches:
        x = torch.cat([batch["patch_embeds"].to(cfg.dtype) @ params["patch_proj"], x], dim=1)
    h, aux = backbone(cfg, params, x, _positions(x.shape[0], x.shape[1], x.device))
    if cfg.n_patches:
        h = h[:, cfg.n_patches :]
    return lm_head_loss(cfg, params, h, labels, labels >= 0) + 0.01 * aux


def value_and_grad(cfg: LMConfig, params: dict, batch: dict) -> tuple[torch.Tensor, dict]:
    """(train_loss, its gradient as a tree like ``params``, each leaf in its
    parameter's dtype).  A leaf the loss does not reach gets zeros, as
    ``jax.grad`` gives it."""
    leaves = [t.detach().requires_grad_(True) for t in tree.leaves(params)]
    loss = train_loss(cfg, tree.rebuild(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), tree.rebuild(params, [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)])


def make_train_step(cfg: LMConfig, optimizer, accum: int = 1):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, metrics ``loss`` plus the optimizer's (``lr``,
    ``grad_norm``).  ``accum > 1`` splits the batch into that many
    microbatches and sums their gradients in ``cfg.accum_dtype`` before
    dividing by ``accum``.  The optimizer updates ``params`` and
    ``opt_state`` in place (``optim.AdamW``) and returns them."""

    def train_step(params: dict, opt_state: dict, batch: dict):
        if accum == 1:
            loss, grads = value_and_grad(cfg, params, batch)
        else:
            micro = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:]) for k, v in batch.items()}
            gsum = [torch.zeros(t.shape, dtype=cfg.accum_dtype, device=t.device) for t in tree.leaves(params)]
            loss = torch.zeros((), dtype=torch.float32, device=gsum[0].device)
            for i in range(accum):
                l, g = value_and_grad(cfg, params, {k: v[i] for k, v in micro.items()})
                for acc, gi in zip(gsum, tree.leaves(g)):
                    acc += gi.to(cfg.accum_dtype)
                loss = loss + l
            grads = tree.rebuild(params, [g / accum for g in gsum])
            loss = loss / accum
        params, opt_state, om = optimizer.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, **om}

    return train_step


def _logits(cfg: LMConfig, params: dict, h: torch.Tensor) -> torch.Tensor:
    """Last-position logits [b, vocab] in fp32 from the final hidden states."""
    h = rms_norm(h, params["ln_f"], cfg.norm_eps)
    return (h[:, -1, :] @ params["unembed"]).float()


@torch.inference_mode()
def serve_step(cfg: LMConfig, params: dict, cache: dict, tokens: torch.Tensor):
    """Decode one token.  tokens: [b, 1] -> (logits [b, vocab], cache),
    the cache updated in place."""
    _check_supported(cfg)
    index = cache["index"]
    x = embed_tokens(cfg, params, tokens)
    if cfg.block_kind == "hybrid":
        ffn_cfg, shared = _shared(cfg, params)
    for i, lp in enumerate(_layers(cfg, params)):
        if cfg.is_encdec:  # self attention over the decoder ring, then cross attention over the frames
            x, _, _, _ = blocks.attention_decode(cfg, lp, x, cache["k"][i], cache["v"][i], cache["pos"][i], index)
            x = blocks.cross_attention_decode(cfg, layer(params["cross"], i), x, cache["cross_k"][i],
                                              cache["cross_v"][i])
            x = blocks.dense_ffn(cfg, lp, x)
            continue
        if cfg.block_kind == "attn":
            x, _, _, _ = blocks.attention_decode(
                cfg, lp, x, cache["k"][i], cache["v"][i], cache["pos"][i], index, window=cfg.sliding_window
            )
            x = _ffn(cfg, lp, x)
            continue
        x, ssm, conv = blocks.ssd_decode(cfg, lp, x, cache["ssm"][i], cache["conv"][i])
        cache["ssm"][i].copy_(ssm)
        cache["conv"][i].copy_(conv)
        if cfg.block_kind == "hybrid" and (i + 1) % cfg.shared_attn_every == 0:
            g = i // cfg.shared_attn_every
            x, _, _, _ = blocks.attention_decode(
                cfg, shared, x, cache["shared_k"][g], cache["shared_v"][g], cache["shared_pos"][g], index,
                window=cfg.sliding_window,
            )
            x = blocks.dense_ffn(ffn_cfg, shared, x)
    cache["index"] = index + 1
    return _logits(cfg, params, x), cache


def make_serve_step(cfg: LMConfig):
    return partial(serve_step, cfg)


def serve_block(cfg: LMConfig, params: dict, cache: dict, tokens: torch.Tensor):
    """Decode ``cfg.decode_block`` tokens in one call (greedy feedback).
    Returns (logits of the LAST token, cache)."""
    tok = tokens
    for _ in range(max(cfg.decode_block, 1) - 1):
        logits, cache = serve_step(cfg, params, cache, tok)
        tok = torch.argmax(logits, dim=-1)[:, None].to(tokens.dtype)
    return serve_step(cfg, params, cache, tok)


@torch.inference_mode()
def prefill_step(cfg: LMConfig, params: dict, batch: dict, max_len: int | None = None):
    """Serving prefill: forward over the prompt, emitting the decode cache.

    batch: {"tokens": [b, s_tok]}, with ``"frames"`` [b, enc_frames,
    d_model] for enc-dec and ``"patch_embeds"`` [b, n_patches, d_model] for
    a patch prefix.  ``max_len`` counts tokens (prompt plus generated), as
    in ``init_cache``.  Returns (last-token logits [b, vocab] fp32, cache),
    from which decode continues directly.  Its ring holds the ``s``
    positions (patches first) in ``_ring_width`` slots; a hybrid's shared
    ring keeps the last ``W`` positions at slot ``pos % W``; enc-dec's
    decoder ring is ``max_decoder_len`` wide, the prompt cut to it, and
    ``max_len`` is not read (module docstring).
    """
    _check_supported(cfg)
    if cfg.is_encdec:
        return _prefill_encdec(cfg, params, batch)
    x = embed_tokens(cfg, params, batch["tokens"])
    if cfg.n_patches:  # the patch prefix: positions count the patches
        x = torch.cat([batch["patch_embeds"].to(cfg.dtype) @ params["patch_proj"], x], dim=1)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :].expand(b, s)

    if cfg.block_kind == "attn":
        W = _ring_width(cfg, max_len or 0, s, window=False)
        ring, kept, slots = _prefill_ring(cfg, cfg.n_layers, b, s, W, x.device)
        cache = {"index": s, **ring}
        for i, lp in enumerate(_layers(cfg, params)):
            x, k, v = blocks.attention(
                cfg, lp, x, positions, causal=True, window=cfg.sliding_window, return_kv=True
            )
            x = _ffn(cfg, lp, x)
            cache["k"][i, :, slots] = k[:, kept]
            cache["v"][i, :, slots] = v[:, kept]
    else:
        if cfg.block_kind == "hybrid":  # the attn path's width, capped by the window (module docstring)
            W = _ring_width(cfg, max_len or 0, s)
            ring, kept, slots = _prefill_ring(cfg, _n_groups(cfg), b, s, W, x.device)
            ffn_cfg, shared = _shared(cfg, params)
        ssm, conv = [], []
        for i, lp in enumerate(_layers(cfg, params)):
            x, state, conv_tail = blocks.ssd_block(cfg, lp, x, return_state=True)
            ssm.append(state)
            conv.append(conv_tail)
            if cfg.block_kind == "hybrid" and (i + 1) % cfg.shared_attn_every == 0:
                g = i // cfg.shared_attn_every
                x, k, v = blocks.attention(
                    cfg, shared, x, positions, causal=True, window=cfg.sliding_window, return_kv=True
                )
                x = blocks.dense_ffn(ffn_cfg, shared, x)
                ring["k"][g, :, slots] = k[:, kept]
                ring["v"][g, :, slots] = v[:, kept]
        cache = {"index": s, "ssm": torch.stack(ssm), "conv": torch.stack(conv)}
        if cfg.block_kind == "hybrid":
            cache.update({f"shared_{key}": t for key, t in ring.items()})
    return _logits(cfg, params, x), cache


def _prefill_encdec(cfg: LMConfig, params: dict, batch: dict):
    """Whisper's prefill: ``prefill`` (the encoder once and every layer's
    cross K/V), then the decoder over the prompt cut to ``max_decoder_len``,
    writing its K/V into slots ``[0, s)`` of a ``max_decoder_len``-slot
    ring."""
    tokens = batch["tokens"][:, : cfg.max_decoder_len]
    b, s = tokens.shape
    cache = prefill(cfg, params, batch, init_cache(cfg, b, cfg.max_decoder_len, tokens.device))
    x = embed_tokens(cfg, params, tokens)
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :].expand(b, s)
    cache["index"] = s
    cache["pos"][:, :s] = positions[0]
    for i, lp in enumerate(_layers(cfg, params)):
        x, k, v = blocks.attention(cfg, lp, x, positions, causal=True, return_kv=True)
        x = blocks.cross_attention(cfg, layer(params["cross"], i), x, cache["cross_k"][i], cache["cross_v"][i])
        x = blocks.dense_ffn(cfg, lp, x)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
    return _logits(cfg, params, x), cache


# ---------------------------------------------------------------------------
# Shisha integration: per-layer static costs (generalized Eq. 1)
# ---------------------------------------------------------------------------


def layer_costs(cfg: LMConfig, seq: int, batch: int = 1):
    """Per-block cost layers for the scheduler (generalized Eq. 1): one
    per block, fused from its attention, FFN / MoE and SSD parts.  Reads only
    the config; no tensor is made."""
    from ..core.cost_model import Layer, attention_layer, ffn_layer, fuse, ssd_layer

    out: list[Layer] = []
    if cfg.is_encdec:
        for i in range(cfg.enc_layers):
            a = attention_layer(f"enc{i}.attn", cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.enc_frames, batch=batch)
            f = ffn_layer(f"enc{i}.ffn", cfg.d_model, cfg.d_ff, seq=cfg.enc_frames, batch=batch)
            out.append(fuse(f"enc{i}", [a, f]))
        dec_len = min(seq, cfg.max_decoder_len or seq)
        for i in range(cfg.n_layers):
            a = attention_layer(f"dec{i}.attn", cfg.d_model, cfg.n_heads, cfg.n_kv_heads, dec_len, batch=batch)
            c = attention_layer(f"dec{i}.cross", cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.enc_frames, batch=batch)
            f = ffn_layer(f"dec{i}.ffn", cfg.d_model, cfg.d_ff, seq=dec_len, batch=batch)
            out.append(fuse(f"dec{i}", [a, c, f]))
        return out
    if cfg.block_kind == "attn":
        for i in range(cfg.n_layers):
            a = attention_layer(
                f"blk{i}.attn", cfg.d_model, cfg.n_heads, cfg.n_kv_heads, seq, batch=batch,
                window=cfg.sliding_window or None,
            )
            f = ffn_layer(
                f"blk{i}.ffn", cfg.d_model, cfg.d_ff, seq=seq, batch=batch,
                gated=cfg.ffn_kind == "swiglu",
                n_experts=cfg.n_experts, top_k=cfg.top_k,
            )
            out.append(fuse(f"blk{i}", [a, f], kind="moe" if cfg.is_moe else "block"))
        return out
    # ssd / hybrid
    for i in range(cfg.n_layers):
        s = ssd_layer(f"blk{i}.ssd", cfg.d_model, cfg.ssm_state, seq=seq, batch=batch, expand=cfg.ssm_expand)
        if cfg.block_kind == "hybrid" and (i + 1) % cfg.shared_attn_every == 0:
            a = attention_layer(
                f"blk{i}.shared_attn", cfg.d_model, cfg.n_heads, cfg.n_kv_heads, seq, batch=batch,
                window=cfg.sliding_window or None,
            )
            f = ffn_layer(f"blk{i}.shared_ffn", cfg.d_model, cfg.d_ff, seq=seq, batch=batch)
            out.append(fuse(f"blk{i}", [s, a, f], kind="hybrid"))
        else:
            out.append(s)
    return out
