"""Model assembly for LM serving: prefill and ring-cache decode.

Port of the serving half of ``repro/models/transformer.py`` for the block
kinds served so far: ``attn`` without encoder or patches (GQA with
``qkv_bias``, ``qk_norm`` and ``sliding_window``; a swiglu or relu2 FFN, or
a top-k MoE FFN with an optional shared expert), ``ssd`` (Mamba2), and
``hybrid`` (zamba2: groups of ``shared_attn_every`` Mamba2 layers, each
followed by one shared attention block and shared SwiGLU FFN, a single
parameter set with a ring KV cache per application).

  * ``init_cache(cfg, batch, max_len, device)`` — decode state.
  * ``prefill_step(cfg, params, batch, max_len)`` — prompt forward that
    emits the decode cache; attention runs on the flash kernel, the SSD scan
    on the chunk-scan kernel, the MoE expert products (here and in decode)
    on the batched GEMM kernel.
  * ``serve_step(cfg, params, cache, tokens)`` — one-token decode.
  * ``serve_block`` / ``make_serve_step`` — ``decode_block`` tokens per call.

The layer loop is a Python loop over views of the ``[L, ...]`` stacks where
the reference has ``lax.scan``.  The cache is a dict of stacked tensors as
in the reference, with ``index`` a Python int; decode updates it in place
(the reference returns a new pytree) and returns it.  Enc-dec and patch
models raise ``NotImplementedError``: they are later slices.  MoE layers
drop the router's auxiliary loss, as the reference's serving does.  Prefill
and decode run under ``torch.inference_mode()``.

Where the port departs from the reference on purpose: a hybrid prefill
gives the shared ring the ``attn`` path's width, ``max(max_len, s)`` capped
by the window.  The reference's hybrid prefill sizes it ``min(s, window)``
and ignores ``max_len`` (``repro/models/transformer.py:542``), so its first
decode step after prefill overwrites position 0 (ROADMAP.md queue 3); the
port's continuation equals decoding the whole sequence from scratch.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import torch

from . import blocks
from .lm_common import LMConfig, layer, rms_norm


def _check_supported(cfg: LMConfig) -> None:
    """Raise for the architectures the port does not serve yet."""
    if cfg.is_encdec:
        raise NotImplementedError("enc-dec serving (whisper) is not ported yet: ROADMAP.md queue 1, enc-dec item")
    if cfg.n_patches:
        raise NotImplementedError("patch-prefix serving (internvl) is not ported yet: ROADMAP.md queue 1, patches item")
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


def init_cache(cfg: LMConfig, batch: int, max_len: int, device: str | torch.device = "cuda") -> dict:
    """Decode state: ring KV cache for attention, SSM and conv state for SSD,
    both for hybrid (the ring as ``shared_k`` / ``shared_v`` / ``shared_pos``,
    one per application of the shared block)."""
    _check_supported(cfg)
    W = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    L = cfg.n_layers
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

    batch: {"tokens": [b, s]}.  Returns (last-token logits [b, vocab] fp32,
    cache).  The cache matches ``init_cache(cfg, b, max(max_len, s))`` so
    decode continues from it directly; a hybrid's shared ring keeps the last
    ``W`` positions at slot ``pos % W`` (``W`` capped by the window).
    """
    _check_supported(cfg)
    tokens = batch["tokens"]
    x = embed_tokens(cfg, params, tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :].expand(b, s)
    L = cfg.n_layers

    W = max(max_len or s, s)
    if cfg.block_kind == "attn":
        ring, kept, slots = _prefill_ring(cfg, L, b, s, W, x.device)
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
            W = min(W, cfg.sliding_window) if cfg.sliding_window else W
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
