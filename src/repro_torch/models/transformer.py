"""Model assembly for LM serving: prefill and ring-cache decode.

Port of the serving half of ``repro/models/transformer.py`` for the block
kinds served so far: ``attn`` without encoder or patches (GQA with
``qkv_bias``, ``qk_norm`` and ``sliding_window``; a swiglu or relu2 FFN, or
a top-k MoE FFN with an optional shared expert), and ``ssd`` (Mamba2).

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
(the reference returns a new pytree) and returns it.  Hybrid, enc-dec and
patch models raise ``NotImplementedError``: they are later slices.  MoE
layers drop the router's auxiliary loss, as the reference's serving does.
Prefill and decode run under ``torch.inference_mode()``.
"""

from __future__ import annotations

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
    if cfg.block_kind == "hybrid":
        raise NotImplementedError("hybrid serving (zamba2) is not ported yet: ROADMAP.md queue 1, hybrid item")
    if cfg.block_kind not in ("attn", "ssd"):
        raise ValueError(cfg.block_kind)


def _ffn(cfg: LMConfig, lp: dict, x: torch.Tensor) -> torch.Tensor:
    """The FFN sublayer of an ``attn`` layer: MoE (aux loss dropped) or dense."""
    if cfg.is_moe:
        return blocks.moe_ffn(cfg, lp, x)[0]
    return blocks.dense_ffn(cfg, lp, x)


def embed_tokens(cfg: LMConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens]


def _layers(cfg: LMConfig, params: dict) -> list[dict]:
    return [layer(params["blocks"], i) for i in range(cfg.n_layers)]


def init_cache(cfg: LMConfig, batch: int, max_len: int, device: str | torch.device = "cuda") -> dict:
    """Decode state: ring KV cache for attention, SSM and conv state for SSD."""
    _check_supported(cfg)
    W = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    L = cfg.n_layers
    if cfg.block_kind == "attn":
        return {
            "index": 0,
            "k": torch.zeros((L, batch, W, cfg.n_kv_heads, cfg.hd), dtype=cfg.dtype, device=device),
            "v": torch.zeros((L, batch, W, cfg.n_kv_heads, cfg.hd), dtype=cfg.dtype, device=device),
            "pos": torch.full((L, W), -1, dtype=torch.int32, device=device),
        }
    return {
        "index": 0,
        "ssm": torch.zeros((L, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state), dtype=cfg.dtype,
                           device=device),
        "conv": torch.zeros((L, batch, 3, cfg.d_inner + 2 * cfg.ssm_state), dtype=cfg.dtype, device=device),
    }


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
    for i, lp in enumerate(_layers(cfg, params)):
        if cfg.block_kind == "attn":
            x, _, _, _ = blocks.attention_decode(
                cfg, lp, x, cache["k"][i], cache["v"][i], cache["pos"][i], index, window=cfg.sliding_window
            )
            x = _ffn(cfg, lp, x)
        else:
            x, ssm, conv = blocks.ssd_decode(cfg, lp, x, cache["ssm"][i], cache["conv"][i])
            cache["ssm"][i].copy_(ssm)
            cache["conv"][i].copy_(conv)
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
    decode continues from it directly.
    """
    _check_supported(cfg)
    tokens = batch["tokens"]
    x = embed_tokens(cfg, params, tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :].expand(b, s)
    L = cfg.n_layers

    if cfg.block_kind == "attn":
        W = max(max_len or s, s)
        cache = {
            "index": s,
            "k": torch.zeros((L, b, W, cfg.n_kv_heads, cfg.hd), dtype=cfg.dtype, device=x.device),
            "v": torch.zeros((L, b, W, cfg.n_kv_heads, cfg.hd), dtype=cfg.dtype, device=x.device),
        }
        slots = torch.arange(W, dtype=torch.int32, device=x.device)
        cache["pos"] = torch.where(slots < s, slots, -1)[None, :].repeat(L, 1)
        for i, lp in enumerate(_layers(cfg, params)):
            x, k, v = blocks.attention(
                cfg, lp, x, positions, causal=True, window=cfg.sliding_window, return_kv=True
            )
            x = _ffn(cfg, lp, x)
            cache["k"][i, :, :s] = k
            cache["v"][i, :, :s] = v
    else:
        ssm, conv = [], []
        for lp in _layers(cfg, params):
            x, state, conv_tail = blocks.ssd_block(cfg, lp, x, return_state=True)
            ssm.append(state)
            conv.append(conv_tail)
        cache = {"index": s, "ssm": torch.stack(ssm), "conv": torch.stack(conv)}
    return _logits(cfg, params, x), cache
