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
    accum=)`` — loss, gradients (summed over microbatches in
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

Over a mesh of ranks (``mesh=``, a ``launch.mesh.make_test_mesh`` with
``dp_axes`` and ``tp_axis``), in the reference's sharded layout
(``models/layout.py``): every rank is given its blocks of the parameters
(``sharding.local_shard``) and its slice of the batch along the data
axes (``launch.mesh.batch_shard``; ``dp_axes=()``: the whole batch on every
rank).  Each layer gathers its leaves over ``data`` (FSDP) and runs the
reference's tensor parallelism over ``tp_axis``: attention on the rank's
heads, the dense and MoE FFNs on its ``d_ff`` block (each data rank routes
its own tokens), an SSD layer on its heads where ``tp_axis`` divides them
(each rank projects, scans and decodes only those, its block of the SSM
state in the cache), the unembedding on its vocab block.  ``train_loss`` is the
reference's loss on the whole batch, ``value_and_grad`` returns the rank's
blocks of its gradient and ``make_train_step`` updates them;
``prefill_step`` and ``serve_step`` return the logits of the rank's slice
(the vocab whole) and keep its blocks of the cache: the ring split over
``tp_axis`` by slots where that divides, decode combining the ranks'
softmax statistics.  Decode keeps attention on the rank's heads: only the
token's q, k and v are gathered over ``tp_axis`` before the ring is scored.
With ``cfg.sp_residuals`` (the default) and a sequence length ``tp_axis``
divides, each stack of layers (``backbone``, ``encoder``,
``decoder_with_cross``, the prefills) runs the residual stream as the
rank's block of the sequence (``models/layout.py``'s sequence plan): the
embedded sequence is split after the embedding and gathered after the
final norm, each layer takes and returns the block, so remat saves only
the block; prefill writes its cache from the K/V of the whole sequence.

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

import torch.distributed as dist

from .. import tree
from ..kernels import ops
from ..collectives import all_gather_dim, all_reduce_over, enter_tp, own_block, sum_tp
from . import blocks
from .layout import Layout
from .lm_common import LMConfig, layer, rms_norm


def _check_supported(cfg: LMConfig) -> None:
    """Raise for a config no path of the port serves."""
    if cfg.block_kind not in ("attn", "ssd", "hybrid"):
        raise ValueError(cfg.block_kind)
    if cfg.block_kind == "hybrid" and cfg.n_layers % cfg.shared_attn_every:
        raise ValueError(f"{cfg.n_layers} layers are not whole groups of {cfg.shared_attn_every}")


def _ffn(cfg: LMConfig, lp: dict, x: torch.Tensor, lay: Layout, specs) -> torch.Tensor:
    """The FFN sublayer of an ``attn`` layer: MoE (aux loss dropped) or dense."""
    p, tp = lay.ffn(cfg, lp, specs)
    if cfg.is_moe:
        return blocks.moe_ffn(cfg, p, x, lay.mesh, lay.dp, lay.tp_axis, lay.seq)[0]
    return blocks.dense_ffn(cfg, p, x, tp, lay.seq_pair)


def embed_tokens(cfg: LMConfig, params: dict, tokens: torch.Tensor, lay: Layout | None = None) -> torch.Tensor:
    return (lay or Layout(cfg)).embed(params, tokens)


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


def cache_shapes(cfg: LMConfig, batch: int, W: int) -> dict:
    """``{name: (shape, dtype)}`` of the decode state of a ``W``-slot ring
    (``init_cache``'s tensors, ``index`` aside)."""
    L, kv = cfg.n_layers, (cfg.n_kv_heads, cfg.hd)
    ring = lambda n: {"k": ((n, batch, W, *kv), cfg.dtype), "v": ((n, batch, W, *kv), cfg.dtype),
                      "pos": ((n, W), torch.int32)}
    if cfg.is_encdec:
        cross = ((L, batch, cfg.enc_frames, *kv), cfg.dtype)
        return {**ring(L), "cross_k": cross, "cross_v": cross}
    if cfg.block_kind == "attn":
        return ring(L)
    out = {"ssm": ((L, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state), cfg.dtype),
           "conv": ((L, batch, 3, cfg.d_inner + 2 * cfg.ssm_state), cfg.dtype)}
    if cfg.block_kind == "hybrid":
        out.update({f"shared_{k}": v for k, v in ring(_n_groups(cfg)).items()})
    return out


def _alloc(shapes: dict, lay: Layout, device) -> dict:
    """Each cache tensor of ``shapes`` as the rank's ``model`` block (the
    batch is already the rank's): zeros, positions -1 (empty)."""
    dims = lay.cache_dims(shapes)
    out = {}
    for name, (shape, dtype) in shapes.items():
        shape = list(shape)
        if dims.get(name) is not None:
            shape[dims[name]] //= lay.tp
        fill = -1 if name.endswith("pos") else 0
        out[name] = torch.full(shape, fill, dtype=dtype, device=device)
    return out


def init_cache(cfg: LMConfig, batch: int, max_len: int, device: str | torch.device = "cuda") -> dict:
    """Decode state for ``max_len`` tokens: ring KV cache for attention, SSM
    and conv state for SSD, both for hybrid (the ring as ``shared_k`` /
    ``shared_v`` / ``shared_pos``, one per application of the shared block);
    enc-dec: a decoder ring of ``min(max_len, max_decoder_len)`` slots and
    the cross K/V ``cross_k`` / ``cross_v`` [L, batch, enc_frames, kvh, hd]
    that prefill fills."""
    _check_supported(cfg)
    return {"index": 0, **_alloc(cache_shapes(cfg, batch, _ring_width(cfg, max_len)), Layout(cfg), device)}


def _unbind(stacks: dict) -> list[dict]:
    """Per-layer parameter dicts from the ``[L, ...]`` stacks, by one
    ``torch.unbind`` of each stack (its backward is one ``stack``)."""
    cols = {k: torch.unbind(v) for k, v in stacks.items()}
    return [dict(zip(cols, parts)) for parts in zip(*cols.values())]


def _recompute(on: bool, fn, *args):
    """``fn(*args)``; with ``on``, and when a graph is being recorded, its
    activations are dropped and recomputed in the backward (the reference's
    ``jax.checkpoint``), and its SSD scans keep the chunk states their
    recomputed forward writes for their backward
    (``ops.keeping_scan_states``)."""
    if on and torch.is_grad_enabled():
        return checkpoint(ops.keeping_scan_states(fn), *args, use_reentrant=False)
    return fn(*args)


def _remat(cfg: LMConfig, fn, *args):
    """One layer, recomputed in the backward under ``remat == "full"``, as the
    reference checkpoints its scan body: what it keeps for the backward is
    the layer's input (the rank's block of the sequence where the stream is
    split)."""
    return _recompute(cfg.remat == "full", fn, *args)


def _attn_sublayer(cfg: LMConfig, lp: dict, x, positions, lay: Layout, specs, *, causal=True, window=0):
    acfg, ap, tp = lay.attention(cfg, lp, specs)
    return blocks.attention(acfg, ap, x, positions, causal=causal, window=window, tp=tp, seq=lay.seq_pair)


def _dense_sublayer(cfg: LMConfig, lp: dict, x, lay: Layout, specs):
    p, tp = lay.ffn(cfg, lp, specs)
    return blocks.dense_ffn(cfg, p, x, tp, lay.seq_pair)


def _encoder_layer(cfg: LMConfig, lp: dict, h: torch.Tensor, positions: torch.Tensor, lay: Layout, specs
                   ) -> torch.Tensor:
    return _dense_sublayer(cfg, lp, _attn_sublayer(cfg, lp, h, positions, lay, specs, causal=False), lay, specs)


def encoder(cfg: LMConfig, params: dict, frames: torch.Tensor, lay: Layout | None = None) -> torch.Tensor:
    """Whisper's encoder: bidirectional attention over the (stubbed) frame
    embeddings [b, se, d_model], RoPE over frame positions, ``enc_ln_f`` at
    the end.  Returns [b, se, d_model] in ``cfg.dtype``."""
    enc_cfg = dataclasses.replace(cfg, n_experts=0, ffn_kind="swiglu", sliding_window=0)  # dense, no window
    h = frames.to(cfg.dtype)
    lay = (lay or Layout(cfg)).stream(h)
    specs = lay.layer_specs("enc_blocks")
    b, se, _ = h.shape
    positions = torch.arange(se, dtype=torch.int32, device=h.device)[None, :].expand(b, se)
    h = lay.enter(h)
    for lp in _unbind(params["enc_blocks"]):
        h = _remat(cfg, _encoder_layer, enc_cfg, lp, h, positions, lay, specs)
    return lay.leave(rms_norm(h, lay.top(params, "enc_ln_f"), cfg.norm_eps))


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
    gold = logits.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]  # a masked label's gold is multiplied by 0
    return ((logz - gold) * mask).sum()


def _xent_chunk_tp(h: torch.Tensor, unembed: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor, lo: int,
                   mesh, axis: str) -> torch.Tensor:
    """:func:`_xent_chunk` with the vocab split over ``axis``: ``unembed``
    holds entries ``[lo, lo + V)``; the max and the sum of exponentials are
    combined over the axis, and the gold logit comes from the rank that holds
    the label (a masked label, < 0, from none)."""
    logits = (h @ unembed).float()
    m = all_reduce_over(logits.detach().amax(-1, keepdim=True), mesh, (axis,), dist.ReduceOp.MAX)
    logz = torch.log(sum_tp(torch.exp(logits - m).sum(-1), mesh, axis)) + m[..., 0]
    local = labels - lo
    here = (local >= 0) & (local < logits.shape[-1])
    gold = logits.gather(-1, local.clamp(0, logits.shape[-1] - 1).long()[..., None])[..., 0] * here
    return ((logz - sum_tp(gold, mesh, axis)) * mask).sum()


def lm_head_loss(cfg: LMConfig, params: dict, h: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor, count: torch.Tensor | None = None, lay: Layout | None = None) -> torch.Tensor:
    """Chunked softmax cross-entropy over h [b, s, d]: never holds [b, s,
    vocab] at once.  The chunk is the first of ``loss_chunk``, 512, 256, ...
    1 that divides s; each chunk's logits are recomputed in the backward
    (``torch.utils.checkpoint``).  The unembedding product stays
    ``torch.matmul``, as the reference leaves it to XLA; over a mesh it runs
    on the rank's vocab block where the layout splits it
    (:func:`_xent_chunk_tp`).  Returns the sum over ``mask`` divided by
    ``count`` (default: ``mask``'s count), fp32."""
    lay = lay or Layout(cfg)
    unembed, lo = lay.unembed(params)
    if lo is not None:
        h = enter_tp(h, lay.mesh, lay.tp_axis)
    s = h.shape[1]
    cs = next((c for c in (cfg.loss_chunk, 512, 256, 128, 64, 32, 16, 8, 4, 2, 1) if s % c == 0), s)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s, cs):
        part = (h[:, c0 : c0 + cs], unembed, labels[:, c0 : c0 + cs], mask[:, c0 : c0 + cs])
        if lo is None:
            total = total + _recompute(True, _xent_chunk, *part)
        else:
            total = total + _recompute(True, _xent_chunk_tp, *part, lo, lay.mesh, lay.tp_axis)
    return total / (mask.sum() if count is None else count).clamp_min(1)


def _attn_layer(cfg: LMConfig, lp: dict, x: torch.Tensor, positions: torch.Tensor, lay: Layout, specs):
    """One ``attn`` layer of the training forward: (x, the MoE router's aux loss or 0)."""
    x = _attn_sublayer(cfg, lp, x, positions, lay, specs, window=cfg.sliding_window)
    if cfg.is_moe:
        p, _ = lay.ffn(cfg, lp, specs)
        return blocks.moe_ffn(cfg, p, x, lay.mesh, lay.dp, lay.tp_axis, lay.seq)
    return _dense_sublayer(cfg, lp, x, lay, specs), torch.zeros((), dtype=torch.float32, device=x.device)


def _ssd_layer(cfg: LMConfig, lp: dict, x: torch.Tensor, lay: Layout, specs) -> torch.Tensor:
    p, tp, _ = lay.ssd(cfg, lp, specs)
    return blocks.ssd_block(cfg, p, x, tp=tp, seq=lay.seq_pair)


def _shared_layer(cfg: LMConfig, sp: dict, x, positions, lay: Layout, specs) -> torch.Tensor:
    """The hybrid's shared attention block and its SwiGLU FFN."""
    ffn_cfg = dataclasses.replace(cfg, ffn_kind="swiglu", n_experts=0)
    x = _attn_sublayer(cfg, sp, x, positions, lay, specs, window=cfg.sliding_window)
    return _dense_sublayer(ffn_cfg, sp, x, lay, specs)


def backbone(cfg: LMConfig, params: dict, x: torch.Tensor, positions: torch.Tensor, mesh=None, dp_axes=("data",),
             tp_axis="model", lay: Layout | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The layer stack over embedded inputs x [b, s, d]: (``ln_f``-normed h,
    the sum of the MoE layers' aux losses, fp32).  ``remat == "full"``
    recomputes each layer in the backward; a hybrid's shared block is not
    recomputed, as in the reference.  With a mesh, x is the rank's batch
    slice and each layer reads its parameters through the layout
    (``models/layout.py``); where the layout splits the stream, the layers
    run on the rank's block of the sequence and h is gathered whole."""
    _check_supported(cfg)
    lay = (lay or Layout(cfg, mesh, dp_axes, tp_axis)).stream(x)
    specs = lay.layer_specs("blocks")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = lay.enter(x)
    if cfg.block_kind == "attn":
        for lp in _unbind(params["blocks"]):
            x, a = _remat(cfg, _attn_layer, cfg, lp, x, positions, lay, specs)
            aux = aux + a
    else:
        if cfg.block_kind == "hybrid":
            shared, sspecs = layer(params["shared"], 0), lay.layer_specs("shared")
        for i, lp in enumerate(_unbind(params["blocks"])):
            x = _remat(cfg, _ssd_layer, cfg, lp, x, lay, specs)
            if cfg.block_kind == "hybrid" and (i + 1) % cfg.shared_attn_every == 0:
                x = _shared_layer(cfg, shared, x, positions, lay, sspecs)
    return lay.leave(rms_norm(x, lay.top(params, "ln_f"), cfg.norm_eps)), aux


def _decoder_layer(cfg: LMConfig, lp: dict, cp: dict, x: torch.Tensor, positions: torch.Tensor,
                   enc_out: torch.Tensor, lay: Layout, specs, cspecs) -> torch.Tensor:
    x = _attn_sublayer(cfg, lp, x, positions, lay, specs)
    ccfg, cpp, ctp = lay.attention(cfg, cp, cspecs, ln="ln")
    x = blocks.cross_attention(ccfg, cpp, x, *blocks.cross_kv(ccfg, cpp, enc_out, ctp), ctp, lay.seq_pair)
    return _dense_sublayer(cfg, lp, x, lay, specs)


def decoder_with_cross(cfg: LMConfig, params: dict, x: torch.Tensor, positions: torch.Tensor,
                       enc_out: torch.Tensor, lay: Layout | None = None) -> torch.Tensor:
    """Whisper's decoder for training: causal self attention, cross
    attention over ``enc_out`` with each layer's cross K/V computed from it
    (so the gradient reaches the encoder), the dense FFN; ``ln_f``-normed.
    Where the layout splits the stream, the queries run on the rank's block
    of the sequence and ``enc_out`` stays whole."""
    lay = (lay or Layout(cfg)).stream(x)
    specs, cspecs = lay.layer_specs("blocks"), lay.layer_specs("cross")
    x = lay.enter(x)
    for lp, cp in zip(_unbind(params["blocks"]), _unbind(params["cross"])):
        x = _remat(cfg, _decoder_layer, cfg, lp, cp, x, positions, enc_out, lay, specs, cspecs)
    return lay.leave(rms_norm(x, lay.top(params, "ln_f"), cfg.norm_eps))


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None, :].expand(b, s)


def _inputs(cfg: LMConfig, params: dict, batch: dict, lay: Layout) -> torch.Tensor:
    """The embedded tokens, with the projected patch prefix in front."""
    x = lay.embed(params, batch["tokens"])
    if cfg.n_patches:
        x = torch.cat([batch["patch_embeds"].to(cfg.dtype) @ lay.top(params, "patch_proj"), x], dim=1)
    return x


def train_loss(cfg: LMConfig, params: dict, batch: dict, mesh=None, dp_axes=("data",), tp_axis="model") -> torch.Tensor:
    """Next-token loss for any architecture family: batch ``tokens`` and
    ``labels`` [b, s] (labels < 0 masked), with ``frames`` for enc-dec and
    ``patch_embeds`` for a patch prefix (whose positions count the patches
    and whose outputs the loss drops).  MoE adds ``0.01 * aux``.

    With a mesh, ``params`` are the rank's blocks (``models/layout.py``)
    and ``batch`` is the rank's slice along ``dp_axes`` (``()``: the whole
    batch on every rank); the value is the reference's loss on the whole
    batch (the masked sum over it divided by its count, plus ``0.01 *`` the
    MoE layers' aux losses, each the mean over the data ranks), the same on
    every rank.  Its gradient on a rank is that rank's share, the rank's own
    masked sum over the global count plus its aux losses' share, which the
    layout's gathers sum over the ranks back into each block."""
    _check_supported(cfg)
    lay = Layout(cfg, mesh, dp_axes, tp_axis)
    tokens, labels = batch["tokens"], batch["labels"]
    mask = labels >= 0
    count = None if mesh is None else all_reduce_over(mask.sum(), mesh, lay.dp)
    aux = None
    if cfg.is_encdec:
        x = lay.embed(params, tokens)
        enc_out = encoder(cfg, params, batch["frames"], lay)
        h = decoder_with_cross(cfg, params, x, _positions(*tokens.shape, x.device), enc_out, lay)
    else:
        x = _inputs(cfg, params, batch, lay)
        h, aux = backbone(cfg, params, x, _positions(x.shape[0], x.shape[1], x.device), lay=lay)
        if cfg.n_patches:
            h = h[:, cfg.n_patches :]
    nll = lm_head_loss(cfg, params, h, labels, mask, count, lay)
    loss = nll if aux is None else nll + 0.01 * aux
    if mesh is None:
        return loss
    # the value of the whole batch's loss on the gradient of this rank's share (aux is already the data mean)
    whole = all_reduce_over(nll.detach(), mesh, lay.dp)
    whole = whole if aux is None else whole + 0.01 * aux.detach()
    return loss + (whole - loss).detach()


def value_and_grad(cfg: LMConfig, params: dict, batch: dict, mesh=None, dp_axes=("data",), tp_axis="model"
                   ) -> tuple[torch.Tensor, dict]:
    """(train_loss, its gradient as a tree like ``params``, each leaf in its
    parameter's dtype).  A leaf the loss does not reach gets zeros, as
    ``jax.grad`` gives it.  With a mesh, each rank's gradient is of its own
    blocks: the layout's gathers reduce-scatter (or sum, or slice) each
    leaf's gradient over the ranks in the backward."""
    leaves = [t.detach().requires_grad_(True) for t in tree.leaves(params)]
    loss = train_loss(cfg, tree.rebuild(params, leaves), batch, mesh, dp_axes, tp_axis)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
    return loss.detach(), tree.rebuild(params, grads)


def make_train_step(cfg: LMConfig, optimizer, mesh=None, dp_axes=("data",), tp_axis="model", accum: int = 1):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, metrics ``loss`` plus the optimizer's (``lr``,
    ``grad_norm``).  ``accum > 1`` splits the batch into that many
    microbatches and sums their gradients in ``cfg.accum_dtype`` before
    dividing by ``accum``.  The optimizer updates ``params`` and
    ``opt_state`` in place (``optim.AdamW``) and returns them.  With a mesh
    (:func:`value_and_grad`), the rank updates its blocks, and the
    gradient norm counts each element of the whole tree once."""
    extra = {} if mesh is None else {"mesh": mesh, "specs": Layout(cfg, mesh, dp_axes, tp_axis).specs}

    def train_step(params: dict, opt_state: dict, batch: dict):
        if accum == 1:
            loss, grads = value_and_grad(cfg, params, batch, mesh, dp_axes, tp_axis)
        else:
            micro = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:]) for k, v in batch.items()}
            gsum = [torch.zeros(t.shape, dtype=cfg.accum_dtype, device=t.device) for t in tree.leaves(params)]
            loss = torch.zeros((), dtype=torch.float32, device=gsum[0].device)
            for i in range(accum):
                l, g = value_and_grad(cfg, params, {k: v[i] for k, v in micro.items()}, mesh, dp_axes, tp_axis)
                for acc, gi in zip(gsum, tree.leaves(g)):
                    acc += gi.to(cfg.accum_dtype)
                loss = loss + l
            grads = tree.rebuild(params, [g / accum for g in gsum])
            loss = loss / accum
        params, opt_state, om = optimizer.update(grads, opt_state, params, **extra)
        return params, opt_state, {"loss": loss, **om}

    return train_step


def _logits(cfg: LMConfig, params: dict, h: torch.Tensor, lay: Layout) -> torch.Tensor:
    """Last-position logits [b, vocab] in fp32 from the final hidden states
    (the stream as the layout holds it; the logits gathered over the vocab's
    ranks where the layout splits it)."""
    h = rms_norm(lay.last(h), lay.top(params, "ln_f"), cfg.norm_eps)
    unembed, lo = lay.unembed(params)
    logits = (h[:, -1, :] @ unembed).float()
    return logits if lo is None else lay.gathered_vocab(logits)


def _decode_attn(cfg: LMConfig, lay: Layout, dims: dict, attn: tuple, x, cache: dict, names, i: int, index: int,
                 window: int = 0):
    """``blocks.attention_decode`` of layer ``i`` on the cache's ring
    ``names`` (k, v, pos) as the rank holds it: split over its slots (the
    flash-decode layout), whole, or split over heads or head dims, then
    gathered for the step and the token's entry written back to the block.
    ``attn`` is ``Layout.attention``'s (config, parameters, ``tp``)."""
    _, ap, tp = attn
    kn, vn, pn = names
    ck, cv, cpos = cache[kn][i], cache[vn][i], cache[pn][i]
    dim = dims.get(kn)
    if dim is None:
        return blocks.attention_decode(cfg, ap, x, ck, cv, cpos, index, window=window, tp=tp)[0]
    if dim == 2:
        return blocks.attention_decode(cfg, ap, x, ck, cv, cpos, index, window=window, split=(lay.mesh, lay.tp_axis),
                                       tp=tp)[0]
    wk, wv = (all_gather_dim(t, lay.mesh, lay.tp_axis, dim - 1) for t in (ck, cv))
    y, wk, wv, _ = blocks.attention_decode(cfg, ap, x, wk, wv, cpos, index, window=window, tp=tp)
    slot = index % cpos.shape[0]
    ck[:, slot] = own_block(wk[:, slot], lay.mesh, lay.tp_axis, dim - 2)
    cv[:, slot] = own_block(wv[:, slot], lay.mesh, lay.tp_axis, dim - 2)
    return y


def _cache_whole(lay: Layout, dims: dict, cache: dict, name: str, i: int) -> tuple[torch.Tensor, int | None]:
    """Layer ``i`` of cache tensor ``name`` gathered whole over ``model``,
    and the layer's dim it is split on (None: stored whole)."""
    dim = dims.get(name)
    t = cache[name][i]
    return (t, None) if dim is None else (all_gather_dim(t, lay.mesh, lay.tp_axis, dim - 1), dim - 1)


@torch.inference_mode()
def serve_step(cfg: LMConfig, params: dict, cache: dict, tokens: torch.Tensor, mesh=None, dp_axes=("data",),
               tp_axis="model"):
    """Decode one token.  tokens: [b, 1] -> (logits [b, vocab], cache),
    the cache updated in place.  With a mesh, ``tokens`` are the rank's
    batch slice, ``params`` and ``cache`` its blocks (the cache from
    ``prefill_step`` or ``init_cache`` over the same mesh), and the logits
    the rank's slice's, the vocab whole."""
    _check_supported(cfg)
    lay = Layout(cfg, mesh, dp_axes, tp_axis)
    specs = lay.layer_specs("blocks")
    index = cache["index"]
    ring = next((cache[k] for k in ("pos", "shared_pos") if k in cache), None)
    dims = lay.cache_dims(cache_shapes(cfg, 1, 0 if ring is None else ring.shape[-1]))
    x = lay.embed(params, tokens)
    if cfg.block_kind == "hybrid":
        ffn_cfg, shared = _shared(cfg, params)
        sspecs = lay.layer_specs("shared")
    for i, lp in enumerate(_layers(cfg, params)):
        if cfg.is_encdec:  # self attention over the decoder ring, then cross attention over the frames
            x = _decode_attn(cfg, lay, dims, lay.attention(cfg, lp, specs), x, cache, ("k", "v", "pos"), i,
                             index)
            _, cp, ctp = lay.attention(cfg, layer(params["cross"], i), lay.layer_specs("cross"), ln="ln")
            if dims.get("cross_k") == 2:
                x = blocks.cross_attention_decode(cfg, cp, x, cache["cross_k"][i], cache["cross_v"][i],
                                                  split=(lay.mesh, lay.tp_axis), tp=ctp)
            else:
                x = blocks.cross_attention_decode(cfg, cp, x, _cache_whole(lay, dims, cache, "cross_k", i)[0],
                                                  _cache_whole(lay, dims, cache, "cross_v", i)[0], tp=ctp)
            x = _dense_sublayer(cfg, lp, x, lay, specs)
            continue
        if cfg.block_kind == "attn":
            x = _decode_attn(cfg, lay, dims, lay.attention(cfg, lp, specs), x, cache, ("k", "v", "pos"), i,
                             index, cfg.sliding_window)
            x = _ffn(cfg, lp, x, lay, specs)
            continue
        p, tp, h0 = lay.ssd(cfg, lp, specs)
        sdims = lay.ssd_cache_dims(dims, tp)
        (ssm, sdim), (conv, cdim) = (_cache_whole(lay, sdims, cache, k, i) for k in ("ssm", "conv"))
        x, ssm, conv = blocks.ssd_decode(cfg, p, x, ssm, conv, tp=tp, h0=h0)
        cache["ssm"][i].copy_(ssm if sdim is None else own_block(ssm, lay.mesh, lay.tp_axis, sdim))
        cache["conv"][i].copy_(conv if cdim is None else own_block(conv, lay.mesh, lay.tp_axis, cdim))
        if cfg.block_kind == "hybrid" and (i + 1) % cfg.shared_attn_every == 0:
            g = i // cfg.shared_attn_every
            x = _decode_attn(cfg, lay, dims, lay.attention(cfg, shared, sspecs), x, cache,
                             ("shared_k", "shared_v", "shared_pos"), g, index, cfg.sliding_window)
            x = _dense_sublayer(ffn_cfg, shared, x, lay, sspecs)
    cache["index"] = index + 1
    return _logits(cfg, params, x, lay), cache


def make_serve_step(cfg: LMConfig, mesh=None, dp_axes=("data",), tp_axis="model"):
    return partial(serve_step, cfg, mesh=mesh, dp_axes=dp_axes, tp_axis=tp_axis)


def serve_block(cfg: LMConfig, params: dict, cache: dict, tokens: torch.Tensor, mesh=None, dp_axes=("data",),
                tp_axis="model"):
    """Decode ``cfg.decode_block`` tokens in one call (greedy feedback).
    Returns (logits of the LAST token, cache)."""
    tok = tokens
    for _ in range(max(cfg.decode_block, 1) - 1):
        logits, cache = serve_step(cfg, params, cache, tok, mesh, dp_axes, tp_axis)
        tok = torch.argmax(logits, dim=-1)[:, None].to(tokens.dtype)
    return serve_step(cfg, params, cache, tok, mesh, dp_axes, tp_axis)


@torch.inference_mode()
def prefill_step(cfg: LMConfig, params: dict, batch: dict, mesh=None, dp_axes=("data",), tp_axis="model",
                 max_len: int | None = None):
    """Serving prefill: forward over the prompt, emitting the decode cache.

    batch: {"tokens": [b, s_tok]}, with ``"frames"`` [b, enc_frames,
    d_model] for enc-dec and ``"patch_embeds"`` [b, n_patches, d_model] for
    a patch prefix.  ``max_len`` counts tokens (prompt plus generated), as
    in ``init_cache``.  Returns (last-token logits [b, vocab] fp32, cache),
    from which decode continues directly.  Its ring holds the ``s``
    positions (patches first) in ``_ring_width`` slots; a hybrid's shared
    ring keeps the last ``W`` positions at slot ``pos % W``; enc-dec's
    decoder ring is ``max_decoder_len`` wide, the prompt cut to it, and
    ``max_len`` is not read (module docstring).  With a mesh, ``batch`` is
    the rank's slice and ``params`` its blocks; it returns its slice's
    logits (the vocab whole) and the rank's blocks of its slice's cache.
    Where the layout splits the stream, the layers run on the rank's block
    of the sequence and the cache is written from the K/V, SSM state and
    conv tail of the whole sequence.
    """
    _check_supported(cfg)
    lay = Layout(cfg, mesh, dp_axes, tp_axis)
    if cfg.is_encdec:
        return _prefill_encdec(cfg, params, batch, lay)
    return _prefill(cfg, params, batch, max_len, lay)


def _store_ring(lay: Layout, ring: torch.Tensor, t: torch.Tensor, kept: torch.Tensor, slots: torch.Tensor,
                dim: int | None) -> None:
    """Write positions ``kept`` of ``t`` [b, s, kvh, hd] (all heads) into
    ring slots ``slots`` of the rank's block ``ring`` [b, W', kvh', hd'] of
    a cache split on ``dim`` of the stacked ``[L, b, W, kvh, hd]`` (None:
    whole): its own slots, or its own heads or head dims.  ``kept`` and
    ``slots`` are host tensors (they follow from the shapes alone)."""
    if dim == 2:
        n = ring.shape[1]
        lo = lay.rank * n
        mine = (slots >= lo) & (slots < lo + n)
        ring[:, (slots[mine] - lo).to(ring.device)] = t[:, kept[mine].to(t.device)]
        return
    kept, slots = kept.to(t.device), slots.to(t.device)
    if dim is None:
        ring[:, slots] = t[:, kept]
    else:
        ring[:, slots] = own_block(t, lay.mesh, lay.tp_axis, dim - 1)[:, kept]


def _prefill(cfg: LMConfig, params: dict, batch: dict, max_len: int | None, lay: Layout):
    """``prefill_step`` of every family but enc-dec, on the rank's batch."""
    x = _inputs(cfg, params, batch, lay)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :].expand(b, s)
    lay = lay.stream(x)
    specs = lay.layer_specs("blocks")
    x = lay.enter(x)

    if cfg.block_kind == "attn":
        W = _ring_width(cfg, max_len or 0, s, window=False)
        shapes = cache_shapes(cfg, b, W)
        cache = {"index": s, **_alloc(shapes, lay, x.device)}
        dim = lay.cache_dims(shapes).get("k")
        kept = torch.arange(max(s - W, 0), s)
        slots = kept % W
        cache["pos"][:, slots.to(x.device)] = kept.to(device=x.device, dtype=torch.int32)
        for i, lp in enumerate(_layers(cfg, params)):
            acfg, ap, tp = lay.attention(cfg, lp, specs)
            x, k, v = blocks.attention(acfg, ap, x, positions, causal=True, window=cfg.sliding_window,
                                       return_kv=True, tp=tp, seq=lay.seq_pair)
            x = _ffn(cfg, lp, x, lay, specs)
            _store_ring(lay, cache["k"][i], lay.kv_heads_whole(cfg, acfg, k), kept, slots, dim)
            _store_ring(lay, cache["v"][i], lay.kv_heads_whole(cfg, acfg, v), kept, slots, dim)
    else:
        if cfg.block_kind == "hybrid":  # the attn path's width, capped by the window (module docstring)
            W = _ring_width(cfg, max_len or 0, s)
            ffn_cfg, shared = _shared(cfg, params)
            sspecs = lay.layer_specs("shared")
        else:
            W = 0
        shapes = cache_shapes(cfg, b, W)
        cache = {"index": s, **_alloc(shapes, lay, x.device)}
        dims = lay.cache_dims(shapes)
        if cfg.block_kind == "hybrid":
            kept = torch.arange(max(s - W, 0), s)
            slots = kept % W
            cache["shared_pos"][:, slots.to(x.device)] = kept.to(device=x.device, dtype=torch.int32)
        for i, lp in enumerate(_layers(cfg, params)):
            p, tp, _ = lay.ssd(cfg, lp, specs)
            x, state, conv_tail = blocks.ssd_block(cfg, p, x, return_state=True, tp=tp, seq=lay.seq_pair)
            sdims = lay.ssd_cache_dims(dims, tp)
            for name, t in (("ssm", state), ("conv", conv_tail)):
                d = sdims.get(name)
                cache[name][i] = t if d is None else own_block(t, lay.mesh, lay.tp_axis, d - 1)
            if cfg.block_kind == "hybrid" and (i + 1) % cfg.shared_attn_every == 0:
                g = i // cfg.shared_attn_every
                acfg, ap, tp = lay.attention(cfg, shared, sspecs)
                x, k, v = blocks.attention(acfg, ap, x, positions, causal=True, window=cfg.sliding_window,
                                           return_kv=True, tp=tp, seq=lay.seq_pair)
                x = _dense_sublayer(ffn_cfg, shared, x, lay, sspecs)
                _store_ring(lay, cache["shared_k"][g], lay.kv_heads_whole(cfg, acfg, k), kept, slots,
                            dims.get("shared_k"))
                _store_ring(lay, cache["shared_v"][g], lay.kv_heads_whole(cfg, acfg, v), kept, slots,
                            dims.get("shared_k"))
    return _logits(cfg, params, x, lay), cache


def _prefill_encdec(cfg: LMConfig, params: dict, batch: dict, lay: Layout):
    """Whisper's prefill: the encoder once, then the decoder over the prompt
    cut to ``max_decoder_len``, each layer's cross K/V computed from the
    encoder's output and written into the cache with its self-attention K/V
    (slots ``[0, s)`` of a ``max_decoder_len``-slot ring)."""
    tokens = batch["tokens"][:, : cfg.max_decoder_len]
    b, s = tokens.shape
    shapes = cache_shapes(cfg, b, cfg.max_decoder_len)
    cache = {"index": s, **_alloc(shapes, lay, tokens.device)}
    dims = lay.cache_dims(shapes)
    enc_out = encoder(cfg, params, batch["frames"], lay)
    x = lay.embed(params, tokens)
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :].expand(b, s)
    lay = lay.stream(x)
    x = lay.enter(x)
    kept = torch.arange(s)
    cache["pos"][:, :s] = positions[0]
    frames = torch.arange(cfg.enc_frames)
    specs, cspecs = lay.layer_specs("blocks"), lay.layer_specs("cross")
    for i, lp in enumerate(_layers(cfg, params)):
        acfg, ap, tp = lay.attention(cfg, lp, specs)
        x, k, v = blocks.attention(acfg, ap, x, positions, causal=True, return_kv=True, tp=tp, seq=lay.seq_pair)
        ccfg, cpp, ctp = lay.attention(cfg, layer(params["cross"], i), cspecs, ln="ln")
        ck, cv = blocks.cross_kv(ccfg, cpp, enc_out, ctp)
        x = blocks.cross_attention(ccfg, cpp, x, ck, cv, ctp, lay.seq_pair)
        x = _dense_sublayer(cfg, lp, x, lay, specs)
        _store_ring(lay, cache["k"][i], lay.kv_heads_whole(cfg, acfg, k), kept, kept, dims.get("k"))
        _store_ring(lay, cache["v"][i], lay.kv_heads_whole(cfg, acfg, v), kept, kept, dims.get("k"))
        _store_ring(lay, cache["cross_k"][i], lay.kv_heads_whole(cfg, ccfg, ck), frames, frames, dims.get("cross_k"))
        _store_ring(lay, cache["cross_v"][i], lay.kv_heads_whole(cfg, ccfg, cv), frames, frames, dims.get("cross_k"))
    return _logits(cfg, params, x, lay), cache


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
