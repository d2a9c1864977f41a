"""Forward blocks of the LM path: GQA attention, dense and MoE FFN, Mamba2 SSD.

Port of ``repro/models/blocks.py``: GQA self attention, whisper's cross
attention, dense and MoE FFNs, and Mamba2 SSD, for serving and for
training.  Every function takes the per-layer parameter slice (views of
the ``[L, ...]`` stacks) and keeps the reference's ``[b, s, h, d]`` layouts.

Full-sequence attention (self and cross, prefill and training) runs on
:func:`repro_torch.kernels.ops.flash_attention`, the full-sequence SSD scan
on :func:`repro_torch.kernels.ops.ssd_scan` and the MoE expert products
(prefill, decode and training) on :func:`repro_torch.kernels.ops.gemm`, all
reached through the ``ops`` module attribute: a CUDA tensor launches the
hand-written kernel, a CPU tensor runs its plain version.  Under autograd
on the card, the gradients of attention, the SSD scan and the expert
products run on hand-written backward kernels too.  One-token decode
(:func:`attention_decode`, :func:`cross_attention_decode`,
:func:`ssd_decode`) is plain PyTorch, as the reference computes it outside
any Pallas kernel.

Over a mesh of ranks the blocks take a ``tp = (mesh, axis)`` pair where
the reference's tensor parallelism splits them (``models/layout.py`` gives
each its parameters): attention on the rank's heads, the FFNs on its
``d_ff`` block and the SSD layer on its heads (its gated norm's mean square
summed over the axis by ``collectives.psum_tp``), their input entering
through ``collectives.enter_tp`` and their output summed by
``collectives.sum_tp``.  The decode paths keep the
head split: the token's q, k and v of the rank's heads are gathered over
the axis (a few KB), every head is scored, and the rank's heads of the
output meet its rows of ``wo``; their ring may be split over its slots
(``split``), whose softmax statistics are combined over the axis.

Where the residual stream is split over the sequence (``seq = (mesh,
axis)``, ``models/layout.py``), a full-sequence sublayer takes and returns
the rank's block ``[b, s / tp, d]`` and runs its pre-norm on it: a
tensor-parallel one gathers the sequence through ``collectives.sp_gather``
and reduce-scatters its output through ``sp_scatter``; one every rank
computes whole (``tp`` None: attention or an SSD layer whose heads the
axis does not divide, an unsplit FFN) gathers through ``gather_act`` and
keeps its block of the output through ``split_act``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from ..kernels import flash_attention as fa
from ..kernels import ops
from ..collectives import (all_reduce_over, enter_tp, gather_act, gather_heads, mean_over, own_block, psum_tp,
                           sp_gather, sp_scatter, split_act, sum_tp)
from .lm_common import LMConfig, rms_norm, rotary

# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _qkv(cfg: LMConfig, p: dict, x: torch.Tensor, positions: torch.Tensor):
    b, s, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, -1, cfg.hd)
    k = k.reshape(b, s, -1, cfg.hd)
    v = v.reshape(b, s, -1, cfg.hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return rotary(q, positions), rotary(k, positions), v


def _sdpa(cfg: LMConfig, q, k, v, *, causal: bool, window: int = 0) -> torch.Tensor:
    """Softmax attention with GQA head grouping over the whole sequence.

    q: [b, sq, h, d]; k/v: [b, skv, kvh, d] -> [b, sq, h·d].  ``window``:
    sliding-window size (0 = full); the causal mask is top-left (key j
    visible to query i when j <= i), as the reference's at ``q_offset``
    0.  The flash kernel takes the tensors as
    transposed ``[b, h, s, d]`` views and writes its output in q's layout,
    so nothing is copied; it replaces both the reference's ``attn_q_block``
    chunking and its ``attn_repeat_kv`` option, neither of which changes the
    result.  Its scores are fp32 (the reference's default
    ``attn_fp32_scores``); ``attn_fp32_scores=False`` runs the kernel's
    bf16-score mode (bf16 scores and a bf16 softmax, forward and backward).
    """
    b, s, h, d = q.shape
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal, window=window,
                            fp32_scores=cfg.attn_fp32_scores)
    return o.transpose(1, 2).reshape(b, s, h * d)


def _tp_in(h: torch.Tensor, tp, seq=None) -> torch.Tensor:
    """A sublayer's normed input as its products read it: the whole
    sequence, gathered from the rank's block where ``seq`` splits it."""
    if seq is not None:
        return gather_act(h, *seq, 1) if tp is None else sp_gather(h, *seq, 1)
    return h if tp is None else enter_tp(h, *tp)


def _tp_out(y: torch.Tensor, tp, seq=None) -> torch.Tensor:
    """A sublayer's output (the ranks' partial sums with ``tp``) as the
    stream adds it: the rank's block where ``seq`` splits the stream."""
    if seq is not None:
        return split_act(y, *seq, 1) if tp is None else sp_scatter(y, *seq, 1)
    return y if tp is None else sum_tp(y, *tp)


def attention(cfg: LMConfig, p: dict, x, positions, *, causal: bool = True, window: int = 0,
              return_kv: bool = False, tp=None, seq=None):
    """Full-sequence (prefill) attention sublayer with residual.

    ``return_kv=True`` also returns the rotated K and V panels, which
    prefill writes into the decode cache.  With ``tp``, ``cfg`` counts the
    rank's heads and ``p`` holds their columns of ``wq``/``wk``/``wv`` and
    rows of ``wo``; the output is summed over the axis.  With ``seq``, x
    and the output are the rank's block of the sequence, ``positions`` and
    the K/V panels the whole sequence's (module docstring).
    """
    h = _tp_in(rms_norm(x, p["ln1"], cfg.norm_eps), tp, seq)
    q, k, v = _qkv(cfg, p, h, positions)
    o = _sdpa(cfg, q, k, v, causal=causal, window=window)
    y = x + _tp_out(o @ p["wo"], tp, seq)
    if return_kv:
        return y, k, v
    return y


def attention_decode(cfg: LMConfig, p: dict, x, cache_k, cache_v, cache_pos, index: int, *, window: int = 0,
                     split=None, tp=None):
    """One-token decode against a ring-buffer KV cache.

    cache_[kv]: [b, W, kvh, hd]; cache_pos: [W] absolute position stored
    per slot (-1 = empty).  With full attention W = max_len and the ring is
    an append cache; with a sliding window it is a true ring.  Unlike the
    reference, which returns new arrays, the token's K, V and position are
    written into the given tensors in place; they are returned as well:
    (y, cache_k, cache_v, cache_pos).

    ``split = (mesh, axis)``: cache_[kv] hold the rank's block of the ring's
    slots (``cache_pos`` whole); the rank that owns the token's slot writes
    it, each scores its own slots, and :func:`_attend_split` combines them.
    ``tp = (mesh, axis)``: ``p`` holds the rank's heads, as in
    :func:`attention` (``cfg`` still counts them all); see
    :func:`_decode_heads`.
    """
    b = x.shape[0]
    W = cache_pos.shape[0]
    pos = torch.full((b, 1), index, dtype=torch.int32, device=x.device)
    h = _tp_in(rms_norm(x, p["ln1"], cfg.norm_eps), tp)
    q, k, v = _qkv(cfg, p, h, pos)
    if tp is not None:
        q, k, v = (gather_heads(t, n, *tp) for t, n in ((q, cfg.n_heads), (k, cfg.n_kv_heads), (v, cfg.n_kv_heads)))
    slot = index % W
    cache_pos[slot] = index
    seen = (cache_pos >= 0) & (cache_pos <= index)
    if window:
        seen &= cache_pos > index - window
    lo = 0 if split is None else split[0].get_local_rank(split[1]) * cache_k.shape[1]
    if lo <= slot < lo + cache_k.shape[1]:
        cache_k[:, slot - lo] = k[:, 0].to(cache_k.dtype)
        cache_v[:, slot - lo] = v[:, 0].to(cache_v.dtype)
    if split is None:
        o = _attend_one(cfg, q, cache_k, cache_v, seen)
    else:
        o = _attend_split(cfg, q, cache_k, cache_v, seen[lo : lo + cache_k.shape[1]], split)
    return x + _decode_heads(o, p, tp), cache_k, cache_v, cache_pos


def _decode_heads(o: torch.Tensor, p: dict, tp) -> torch.Tensor:
    """The output projection of one decoded token, o [b, 1, h·d] of every
    head: with ``tp``, the rank's heads of ``o`` against its rows of
    ``wo``, summed over the axis.  Decode keeps attention's head split, so
    only the token's q, k and v (gathered whole before it) cross the wire,
    never the projections."""
    if tp is None:
        return o @ p["wo"]
    return sum_tp(own_block(o, *tp, 2) @ p["wo"], *tp)


def _decode_scores(cfg: LMConfig, q, k, seen: torch.Tensor | None, fp32_scores: bool) -> torch.Tensor:
    """One query position's masked scores [b, kvh, g, 1, s] against ``k``
    [b, s, kvh, d], fp32: q·kᵀ / sqrt(d) in fp32, or with ``fp32_scores``
    False bf16(bf16(q·kᵀ) / bf16(sqrt(d))), the reference's
    ``attn_fp32_scores=False`` (``flash_attention.flash_attention_plain``)."""
    b, d = q.shape[0], cfg.hd
    qg = q.reshape(b, 1, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, d)
    raw = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(q.dtype)).float()
    scores = raw / math.sqrt(d) if fp32_scores else fa.bf16_round(fa.bf16_round(raw) / fa.score_divisor(d))
    return scores if seen is None else scores.masked_fill(~seen, float("-inf"))


def _attend_one(cfg: LMConfig, q, k, v, seen: torch.Tensor | None = None, fp32_scores: bool = True) -> torch.Tensor:
    """One query position against ``s`` keys: q [b, 1, h, d]; k/v [b, s,
    kvh, d]; ``seen`` [s] masks keys out (None: all visible) -> [b, 1, h·d].
    Scores and softmax in fp32, the probabilities cast to q's type before
    P·V, as the reference's ``_sdpa_chunk``; with ``fp32_scores`` False its
    bf16 scores and bf16 softmax, each step rounded as
    ``flash_attention.flash_attention_plain`` rounds it."""
    b = q.shape[0]
    scores = _decode_scores(cfg, q, k, seen, fp32_scores)
    if fp32_scores:
        probs = torch.softmax(scores, dim=-1)
    else:
        u = fa.bf16_round(torch.exp(fa.bf16_round(scores - scores.amax(-1, keepdim=True))))
        probs = fa.bf16_round(u / fa.bf16_round(fa.tree_sum(u, bf16=False)[..., None]))
    return torch.einsum("bkgqs,bskd->bqkgd", probs.to(q.dtype), v.to(q.dtype)).reshape(b, 1, cfg.q_dim)


def _attend_split(cfg: LMConfig, q, k, v, seen: torch.Tensor | None, split, fp32_scores: bool = True) -> torch.Tensor:
    """:func:`_attend_one` over a key set split across the ranks of
    ``split = (mesh, axis)``, each holding ``k``/``v`` [b, s_rank, kvh, d]
    and their ``seen`` mask: each rank scores its keys in fp32, and the
    max, the sum of exponentials and the weighted values are combined over
    the axis (flash-decode), the output cast to q's type.  With
    ``fp32_scores`` False each rank scores in bf16: the max is combined,
    then each rank's fp32 sum of u = bf16(exp(bf16(s - m))), rounded to
    bf16 once whole, then the ranks' y·V with y = bf16(u / l)."""
    b, d = q.shape[0], cfg.hd
    scores = _decode_scores(cfg, q, k, seen, fp32_scores)
    mesh, axis = split
    m = all_reduce_over(scores.amax(-1, keepdim=True), mesh, (axis,), torch.distributed.ReduceOp.MAX)
    if not fp32_scores:
        u = fa.bf16_round(torch.exp(fa.bf16_round(scores - m)))
        l = fa.bf16_round(all_reduce_over(u.sum(-1, keepdim=True), mesh, (axis,)))
        y = fa.bf16_round(u / l).to(q.dtype).float()
        o = all_reduce_over(torch.einsum("bkgqs,bskd->bqkgd", y, v.to(q.dtype).float()), mesh, (axis,))
        return o.to(q.dtype).reshape(b, 1, cfg.q_dim)
    e = torch.exp(scores - m)
    o = torch.einsum("bkgqs,bskd->bqkgd", e, v.float())  # [b, 1, kvh, g, d]
    l = e.sum(-1).permute(0, 3, 1, 2)[..., None]  # [b, 1, kvh, g, 1]
    both = all_reduce_over(torch.cat([o, l], dim=-1), mesh, (axis,))
    return (both[..., :d] / both[..., d:]).to(q.dtype).reshape(b, 1, cfg.q_dim)


def cross_kv(cfg: LMConfig, p: dict, enc_out: torch.Tensor, tp=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Whisper's cross-attention K and V of one decoder layer: enc_out [b,
    se, d] -> k, v [b, se, kvh, hd], no RoPE (with ``tp``, the rank's KV
    heads)."""
    enc_out = _tp_in(enc_out, tp)
    b, se, _ = enc_out.shape
    k = (enc_out @ p["wk"]).reshape(b, se, cfg.n_kv_heads, cfg.hd)
    v = (enc_out @ p["wv"]).reshape(b, se, cfg.n_kv_heads, cfg.hd)
    return k, v


def cross_attention(cfg: LMConfig, p: dict, x, cross_k, cross_v, tp=None, seq=None) -> torch.Tensor:
    """Encoder-decoder cross attention (whisper) with residual: pre-norm
    ``p["ln"]``, queries from the decoder's ``s`` positions against the
    :func:`cross_kv` of the encoder's ``se`` frames (``s != se``: the flash
    kernel over a key length other than the query's), no mask, no RoPE.
    x: [b, s, d]; cross_[kv]: [b, se, kvh, hd] (with ``tp``, the rank's
    heads, as :func:`attention`; with ``seq``, x is the rank's block of the
    queries and the K/V stay whole)."""
    h = _tp_in(rms_norm(x, p["ln"], cfg.norm_eps), tp, seq)
    b, s, _ = h.shape
    q = (h @ p["wq"]).reshape(b, s, cfg.n_heads, cfg.hd)
    return x + _tp_out(_sdpa(cfg, q, cross_k, cross_v, causal=False) @ p["wo"], tp, seq)


def cross_attention_decode(cfg: LMConfig, p: dict, x, cross_k, cross_v, split=None, tp=None) -> torch.Tensor:
    """One-token cross attention against the prefilled encoder K/V (the
    reference writes it inline in ``serve_step``).  x: [b, 1, d]; cross_[kv]:
    [b, se, kvh, hd] -> x + attention, every frame visible; ``split``: the
    frames split over the ranks, as :func:`attention_decode`'s ring; ``tp``:
    ``p`` holds the rank's heads, as there.  The reference computes it with
    ``_sdpa``, so ``cfg.attn_fp32_scores`` reaches it (self-attention decode
    scores in fp32 whatever the knob, as the reference's)."""
    b = x.shape[0]
    q = (_tp_in(rms_norm(x, p["ln"], cfg.norm_eps), tp) @ p["wq"]).reshape(b, 1, -1, cfg.hd)
    if tp is not None:
        q = gather_heads(q, cfg.n_heads, *tp)
    f32 = cfg.attn_fp32_scores
    o = (_attend_one(cfg, q, cross_k, cross_v, fp32_scores=f32) if split is None
         else _attend_split(cfg, q, cross_k, cross_v, None, split, fp32_scores=f32))
    return x + _decode_heads(o, p, tp)


# ---------------------------------------------------------------------------
# FFN (dense)
# ---------------------------------------------------------------------------


def dense_ffn(cfg: LMConfig, p: dict, x: torch.Tensor, tp=None, seq=None) -> torch.Tensor:
    """The dense FFN sublayer with residual; with ``tp``, ``p`` holds the
    rank's ``d_ff`` block and the output is summed over the axis; with
    ``seq``, x and the output are the rank's block of the sequence."""
    h = _tp_in(rms_norm(x, p["ln2"], cfg.norm_eps), tp, seq)
    if cfg.ffn_kind == "relu2":
        u = torch.relu(h @ p["w_in"])
        return x + _tp_out((u * u) @ p["w_out"], tp, seq)  # squared-ReLU (nemotron)
    g = F.silu(h @ p["w_gate"])
    u = h @ p["w_up"]
    return x + _tp_out((g * u) @ p["w_down"], tp, seq)


# ---------------------------------------------------------------------------
# FFN (MoE)
# ---------------------------------------------------------------------------


def moe_capacity(cfg: LMConfig, tokens_local: int) -> int:
    cap = math.ceil(tokens_local * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-cap // 8) * 8)  # round up to a multiple of 8


def route(cfg: LMConfig, p: dict, xf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router of :func:`moe_ffn_local`.  xf: [t, d] -> (probs [t, E] fp32,
    gate [t, k] renormalised, expert [t, k]).  Top-k comes from a stable
    descending sort, so ties go to the lower expert index, as
    ``jax.lax.top_k`` breaks them (``torch.topk`` promises no order)."""
    probs = torch.softmax(xf.float() @ p["router"], dim=-1)
    gate, expert = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = gate[:, : cfg.top_k], expert[:, : cfg.top_k]
    return probs, gate / gate.sum(-1, keepdim=True).clamp_min(1e-9), expert


def moe_ffn_local(cfg: LMConfig, p: dict, x: torch.Tensor, capacity: int, tp: tuple | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Token-choice top-k MoE with capacity, sort-free dispatch.

    x: [b, s, d].  Returns (y, aux_loss), y without the residual.  Each
    (token, expert) pair takes the next place in its expert's queue in token
    order (token 0's k choices, then token 1's); pairs past ``capacity`` are
    dropped, their dispatch routed to a scratch row and their combine weight
    zeroed.  The three expert products run on ``ops.gemm``, all experts in
    one launch each; the router and the shared expert stay ``torch.matmul``,
    as the reference leaves them outside any kernel.

    ``tp = (mesh, axis)``: the expert weights in ``p`` are this rank's
    ``d_ff`` slice (:data:`TP_SPLIT`) and y is its partial sum.  The tokens
    and the combine weights enter the sliced products through
    ``collectives.enter_tp``, so their gradients are summed over ``axis``;
    the router's own path (and ``aux``) is the same on every rank and is
    not.
    """
    b, s, dm = x.shape
    E, k = cfg.n_experts, cfg.top_k
    t = b * s
    xf = x.reshape(t, dm)
    probs, gate, expert = route(cfg, p, xf)
    if tp is not None:
        xf, gate = enter_tp(xf, *tp), enter_tp(gate, *tp)
    # load-balancing auxiliary loss (Switch-style)
    me = probs.mean(0)
    ce = torch.zeros(E, device=x.device).index_add_(0, expert.reshape(-1), torch.ones(t * k, device=x.device)) / (t * k)
    aux = E * torch.sum(me * ce)

    flat_e = expert.reshape(-1)  # [t*k], grouped by token
    flat_tok = torch.arange(t, device=x.device).repeat_interleave(k)
    flat_gate = gate.reshape(-1)
    # position of each (token, expert) pair within its expert's queue; the
    # one-hot is laid out [E, t*k] so the count runs along the inner dim
    onehot = F.one_hot(flat_e, E).T.contiguous()
    pos = (torch.cumsum(onehot, dim=1) - onehot).gather(0, flat_e[None, :])[0]
    keep = pos < capacity
    slot = torch.where(keep, flat_e * capacity + pos, E * capacity)  # overflow -> scratch row
    scale = keep.to(x.dtype)[:, None]
    buf = torch.zeros((E * capacity + 1, dm), dtype=x.dtype, device=x.device)
    buf.index_add_(0, slot, xf[flat_tok] * scale)
    xe = buf[:-1].reshape(E, capacity, dm)
    g = F.silu(ops.gemm(xe, p["we_gate"]))
    u = ops.gemm(xe, p["we_up"])
    ye = ops.gemm(g * u, p["we_down"]).reshape(E * capacity, dm)
    contrib = ye[torch.where(keep, slot, 0)] * (flat_gate.to(x.dtype)[:, None] * scale)
    y = torch.zeros((t, dm), dtype=x.dtype, device=x.device).index_add_(0, flat_tok, contrib)
    if cfg.n_shared_experts:
        gs = F.silu(xf @ p["ws_gate"])
        us = xf @ p["ws_up"]
        y = y + (gs * us) @ p["ws_down"]
    return y.reshape(b, s, dm), aux


#: the expert weights tensor parallelism splits over ``d_ff``, and the dim
#: each is split on (the reference's ``w_specs``): the gate and up
#: projections on their last, the down projections on their second to last.
#: Over a mesh the ranks store these blocks (``param_shardings``), and
#: :func:`tp_slice` gives the same blocks as views of whole weights
TP_SPLIT = {"we_gate": -1, "we_up": -1, "we_down": -2, "ws_gate": -1, "ws_up": -1, "ws_down": -2}


def tp_slice(p: dict, tp: int, index: int) -> dict:
    """The parameters of one MoE layer as rank ``index`` of ``tp`` sees
    them: each :data:`TP_SPLIT` weight narrowed to its ``index``-th part of
    ``d_ff`` (a view: no copy; its rows keep the whole tensor's stride), the
    rest as they are."""
    out = dict(p)
    for key, dim in TP_SPLIT.items():
        if key in p:
            n = p[key].shape[dim]
            if n % tp:
                raise ValueError(f"{key}'s d_ff of {n} does not split over {tp} ranks")
            out[key] = p[key].narrow(dim, index * (n // tp), n // tp)
    return out


def moe_ffn(cfg: LMConfig, p: dict, x: torch.Tensor, mesh=None, dp_axes=("data",), tp_axis="model",
            seq: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """MoE sublayer with residual: (x + y, aux_loss).

    With a mesh of ranks (``launch.mesh.make_test_mesh``), x is this rank's
    slice of the batch along ``dp_axes`` and the reference's ``shard_map``
    path is mirrored: the rank routes its own tokens at ``moe_capacity`` of
    its own token count; where ``p``'s expert weights are the rank's
    ``d_ff`` block (the stored shard, or :func:`tp_slice` of whole ones),
    it computes that block and y is summed over ``tp_axis``
    (``collectives.sum_tp``); ``aux`` is the mean over ``dp_axes`` of the
    ranks' aux losses.  With more than one data rank
    this is another function than the path without a mesh: a shard's
    capacity can drop other tokens, and the mean of the shards' aux losses
    is not the whole batch's (ROADMAP.md queue 3).

    ``seq=True``: x and the output are the rank's block of the sequence over
    ``tp_axis`` (``models/layout.py``); the normed block is gathered whole
    (``collectives.gather_act``) before the router, so the rank routes its
    data shard's whole sequence at the capacity of its token count, and y
    is reduce-scattered to the block (``sp_scatter``; ``split_act`` with the
    experts whole).
    """
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if mesh is None:
        y, aux = moe_ffn_local(cfg, p, h, moe_capacity(cfg, h.shape[0] * h.shape[1]))
        return x + y, aux
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a DeviceMesh of ranks (launch.mesh.make_test_mesh), got {type(mesh).__name__}")
    if seq:
        h = gather_act(h, mesh, tp_axis, 1)
    capacity = moe_capacity(cfg, h.shape[0] * h.shape[1])
    if p["we_gate"].shape[-1] == cfg.d_ff:  # the experts whole on every rank
        y, aux = moe_ffn_local(cfg, p, h, capacity)
        return x + (split_act(y, mesh, tp_axis, 1) if seq else y), mean_over(aux, mesh, dp_axes)
    y, aux = moe_ffn_local(cfg, p, h, capacity, tp=(mesh, tp_axis))
    y = sp_scatter(y, mesh, tp_axis, 1) if seq else sum_tp(y, mesh, tp_axis)
    return x + y, mean_over(aux, mesh, dp_axes)


# ---------------------------------------------------------------------------
# Mamba2 SSD
# ---------------------------------------------------------------------------


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, x: [b, l, ch], w: [K, ch]."""
    K = w.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    return sum(xp[:, i : i + x.shape[1], :] * w[i] for i in range(K))


def _gated_norm(y: torch.Tensor, scale: torch.Tensor, eps: float, width: int, tp) -> torch.Tensor:
    """``rms_norm`` over all ``width`` channels of the SSD output, of which
    ``y`` holds the rank's block with ``tp``: its fp32 sum of squares summed
    over the axis both ways (``collectives.psum_tp``; each rank normalises
    its own block, so the total's gradient is partial on every rank)."""
    if tp is None:
        return rms_norm(y, scale, eps)
    yf = y.float()
    ss = psum_tp((yf * yf).sum(-1, keepdim=True), *tp)
    return (yf * torch.rsqrt(ss / width + eps) * scale).to(y.dtype)


def _own_channels(t: torch.Tensor, di: int, x0: int, dr: int) -> torch.Tensor:
    """The rank's channels ``[x_r | B | C]`` of ``t`` [..., di + 2n] (all
    channels, the conv state's layout): its heads' block ``x0 : x0 + dr`` of
    x, then B and C."""
    return torch.cat([t[..., x0 : x0 + dr], t[..., di:]], -1)


def _whole_channels(t: torch.Tensor, tp, dr: int) -> torch.Tensor:
    """All channels ``[x | B | C]`` from each rank's ``[x_r | B | C]``: the
    ranks' x blocks gathered over the axis (B and C are every rank's)."""
    return torch.cat([gather_act(t[..., :dr], *tp, t.dim() - 1), t[..., dr:]], -1)


def ssd_block(cfg: LMConfig, p: dict, x: torch.Tensor, return_state: bool = False, tp=None, seq=None):
    """Mamba2 block (full sequence) with residual.

    ``return_state=True`` also returns (ssm_state [b, h, p, n] in x's type,
    conv_tail [b, 3, di+2n]) for the prefill -> decode hand-off.  The scan
    runs on ``ops.ssd_scan``, which returns the final state with the output.

    With ``tp`` (the layer split over its heads, ``Layout.ssd``), ``p`` is
    the rank's: it projects, convolves and scans its ``h / tp`` heads (B
    and C, shared by every head, from the same input on every rank), takes
    part in the gated norm over all of ``d_inner`` (:func:`_gated_norm`) and
    multiplies by its rows of ``out_proj``; the input enters through
    ``enter_tp`` and the output is summed by ``sum_tp``.  Its final state
    is its heads' block, the conv tail is gathered whole.  With ``seq``, x
    and the output are the rank's block of the sequence: the normed blocks
    are gathered (``sp_gather``, or ``gather_act`` for the whole layer), the
    whole sequence is scanned, and the rank's block of the output kept
    (``sp_scatter``, or ``split_act``; module docstring).
    """
    di, n, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    h = p["A_log"].shape[0]  # the rank's heads with tp, else all of them
    dr = h * hd
    hin = _tp_in(rms_norm(x, p["ln"], cfg.norm_eps), tp, seq)
    b, s, _ = hin.shape
    zxbcdt = hin @ p["in_proj"]
    z, xbc_raw, dt = torch.split(zxbcdt, [dr, dr + 2 * n, h], dim=-1)
    # x, B and C as views of the conv's own [b, s, dr + 2n] output: rows of a width the tensor-core scan takes
    xbc = F.silu(_causal_conv(xbc_raw, p["conv_w"]))
    xs, B, C = torch.split(xbc, [dr, n, n], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])  # [b, s, h]
    A = -torch.exp(p["A_log"])  # [h]
    xh = xs.reshape(b, s, h, hd)
    y, state = ops.ssd_scan(xh, dt, A, B, C, chunk=cfg.ssm_chunk)
    y = y + xh * p["D"][None, None, :, None].to(x.dtype)
    y = y.reshape(b, s, dr) * F.silu(z)
    y = _gated_norm(y, p["gate_ln"], cfg.norm_eps, di, tp)
    out = x + _tp_out(y @ p["out_proj"], tp, seq)
    if return_state:
        tail = xbc_raw[:, -3:, :]
        return out, state.to(x.dtype), (tail if tp is None else _whole_channels(tail, tp, dr))
    return out


def ssd_decode(cfg: LMConfig, p: dict, x, ssm_state, conv_state, tp=None, h0: int = 0):
    """One-token SSD decode.

    x: [b, 1, d]; ssm_state: [b, h, p, n]; conv_state: [b, K-1, di+2n].
    Returns new (y, ssm_state', conv_state'), the state updated in x's type.
    With ``tp`` (``Layout.ssd``'s split over the heads, the rank's first
    head ``h0``) ``ssm_state`` is the rank's heads ``[b, h / tp, p, n]`` and
    only they are updated; the conv state stays whole (the token's x
    channels gathered over the axis) and the output is summed over it.
    """
    b = x.shape[0]
    di, n, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    h = p["A_log"].shape[0]
    dr = h * hd
    hin = _tp_in(rms_norm(x, p["ln"], cfg.norm_eps), tp)
    zxbcdt = hin @ p["in_proj"]
    z, xbc, dt = torch.split(zxbcdt, [dr, dr + 2 * n, h], dim=-1)
    mine = conv_state if tp is None else _own_channels(conv_state, di, h0 * hd, dr)
    full = torch.cat([mine, xbc], dim=1)  # [b, K, ch]
    xbc_t = F.silu(torch.einsum("bkc,kc->bc", full, p["conv_w"]))[:, None, :]
    conv_state = full[:, 1:, :] if tp is None else torch.cat([conv_state[:, 1:], _whole_channels(xbc, tp, dr)], 1)
    xs, B, C = torch.split(xbc_t, [dr, n, n], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])[:, 0]  # [b, h]
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A)  # [b, h]
    xh = xs.reshape(b, h, hd)
    dBx = torch.einsum("bh,bn,bhp->bhpn", dt.to(x.dtype), B[:, 0], xh)
    ssm_state = ssm_state * dA[..., None, None].to(x.dtype) + dBx
    y = torch.einsum("bhpn,bn->bhp", ssm_state, C[:, 0])
    y = y + xh * p["D"][None, :, None].to(x.dtype)
    y = y.reshape(b, 1, dr) * F.silu(z)
    y = _gated_norm(y, p["gate_ln"], cfg.norm_eps, di, tp)
    return x + _tp_out(y @ p["out_proj"], tp), ssm_state, conv_state
