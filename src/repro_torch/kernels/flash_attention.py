"""Flash attention: the CUDA kernel's wrapper and its plain version.

Replaces ``repro/kernels/flash_attention.py::flash_attention`` (Pallas
``_flash_kernel``): forward online-softmax attention with an optional causal
mask and GQA head grouping.  On the LM path it is the prefill attention of
every ``attn`` model, in place of the reference's ``blocks._sdpa`` (which
calls itself the XLA stand-in for this kernel).  ``csrc/flash_attention.cu``
holds three forward kernels, picked by :func:`fwd_route` from the type, the
score mode, the head dim and the strides (:func:`fwd_kernels` names each
route's launch): bf16 at head dim 64, 80, 128 or 192 with rows TMA can
address (every served prefill and training forward) runs
``flash_fwd_wgmma_kernel`` (a persistent grid; a producer warpgroup's TMA
loads into a K/V ring, ``wgmma`` products with P in registers; each head
dim's consumer warpgroups, overlap and ring :func:`fwd_plan`);
other bf16 calls run ``flash_fwd_mma_bf16_kernel`` on the tensor cores
(``mma.sync`` products with fp32 accumulators, Q in registers, a
``cp.async`` K/V ring, P kept in registers); fp32 runs ``flash_fwd_kernel``
on the SIMT pipes (TF32 would miss the reference's 2e-4).  All keep the
running max, normaliser and accumulator in fp32, skip causal tiles above
the diagonal, mask a sliding window as ``_sdpa`` does and
mask ragged lengths instead of asserting that they divide the tile (see the
source note).  The key length may differ from the query's (whisper's cross
attention: 448 decoder positions against 1500 encoder frames), with the
reference ``blocks._sdpa``'s semantics at ``q_offset = 0``: the causal mask
is top-left, key ``j`` visible to query ``i`` when ``j <= i``.  The Pallas
kernel takes one length for both.

:func:`flash_attention_plain` is exact softmax attention in fp32 with the
same masks and the same cast of the probabilities to ``v.dtype`` before
P·V; the CPU path and the on-card checks use it.

The backward (no Pallas kernel of the reference has one: the reference
trains through XLA's ``_sdpa``): ``flash_attention(..., return_lse=True)``
also returns the log-sum-exp of each row's scaled scores, and
:func:`flash_attention_bwd` takes it with o and dO to dq, dk, dv on more
kernels of ``csrc/flash_attention.cu``, by the route :func:`bwd_route`
picks from the inputs' type, head dim, strides and alignment: bf16 at head
dim 64, 80 or 128 with rows TMA can address runs two kernels on ``wgmma`` fed
by TMA (dQ, which also computes ``delta = rowsum(dO∘O)``, then dK/dV with
each GQA group split over a thread-block cluster, :func:`bwd_cluster`);
other bf16 shapes run the ``mma.sync`` kernels (the delta pre-pass, dQ,
dK/dV in one pass up to D 80 and two above); fp32 the SIMT kernels (see
the source note; :func:`bwd_kernels` names each route's launches).
:func:`flash_attention_fwd_plain` and
:func:`flash_attention_bwd_plain` are the same two functions by their
explicit formulas in fp32, for the CPU tests and the on-card checks.

Every function here also takes ``fp32_scores=False``: the reference's
``LMConfig.attn_fp32_scores=False`` (``blocks._sdpa_chunk``), where the
scores are rounded to bf16 and the softmax runs in bf16, a rounding at
each of its steps (:func:`flash_attention_plain`'s docstring lists them).
Its scale is a division by ``bf16(sqrt(D))`` (:func:`score_divisor`), as
JAX casts the reference's Python float to the scores' type.  The online
softmax cannot reproduce ``bf16(exp(bf16(s - m)))`` at the row's final max,
so the mode's forward kernels sweep a q tile's keys three times (the raw
scores' max, mapped once a row; the bf16 row sum; P·V) and save each row's
max and bf16 sum, ``(m, l)`` stacked as fp32 ``[2, B, H, Sq]``, where the
fp32 mode saves the lse.  The backward follows ``jax.grad`` of the
reference op by op, its row sum ``R = Σ bf16(bf16(g · bf16(l⁻²)) · u)``
added in bf16 in XLA's CPU order (:func:`bf16_row_sum`; the kernels add
each window of 32 in one chain, two threads a row); it runs on the routes
of the fp32 mode (:func:`bwd_route`), whose dQ kernels sweep the keys twice
(R, then dQ) and leave R for the dK/dV kernels.  The kernels give every
step's bits without an IEEE division or ``expf`` on every element: a
multiplication by the row's or the call's reciprocal, and ``ex2.approx``
with ``expf`` where its result lies near a bf16 rounding boundary, each
held to the IEEE op over every input it can take by :func:`scalar_check`.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

#: launches of the CUDA kernel since this count was last set to 0
launches = 0
#: calls of the backward's kernels (delta, dQ, dK/dV) since this count was last set to 0
bwd_launches = 0
#: the bf16-score mode's forward launches and backward calls, counted apart from the two above
bf16_scores_launches = 0
bf16_scores_bwd_launches = 0

#: head dims the kernels are built for (zamba2-2.7b runs 80, nemotron-4-340b 192)
HEAD_DIMS = (16, 32, 64, 80, 128, 192)
_DTYPES = (torch.float32, torch.bfloat16)
#: the wgmma route's error code for a tensor map the driver refused (+ its CUresult)
_TENSOR_MAP_ERROR = 10000

#: the backward's routes, by the code the C entry takes: fp32 on the SIMT
#: pipes, bf16 on ``mma.sync``, bf16 on ``wgmma`` fed by TMA
BWD_ROUTES = {"simt": 0, "mma": 1, "wgmma": 2}
#: head dims of the wgmma route: a tile of D columns is ceil(D / 64) boxes of
#: the 128-byte swizzle, D 80's second box zero-filled past its 16 columns (16
#: and 32 are too narrow for a k16 step per box row, 192 has no training path)
WGMMA_HEAD_DIMS = (64, 80, 128)
#: the largest thread-block cluster every Hopper card launches
PORTABLE_CLUSTER = 8
#: the forward's routes, by the code the C entry takes: fp32 on the SIMT
#: pipes, bf16 on ``mma.sync``, bf16 on ``wgmma`` fed by TMA
FWD_ROUTES = {"simt": 0, "mma": 1, "wgmma": 2}
#: head dims of the forward's wgmma route: its tiles are the backward's
#: (D 80 two boxes, the second zero-filled), and D 192's three boxes fit a
#: ring of 64-key tiles beside two Q tiles (16 and 32 stay on ``mma.sync``)
FWD_WGMMA_HEAD_DIMS = (64, 80, 128, 192)
#: ``flash_fwd_wgmma_config``'s fields, in its order
FWD_CONFIG_FIELDS = ("consumer_warpgroups", "overlap", "stages", "planned_blocks_an_sm", "smem_bytes", "blocks_an_sm")
#: the forward wgmma kernel's choice at each head dim as the shipped source
#: builds it (``fwd_choice``): consumer warpgroups of 64 query rows, and
#: whether a key tile's softmax overlaps its neighbours' products within a
#: warpgroup (1) or not (0); every head dim takes 64-key tiles, Q read from
#: shared memory and a persistent grid
FWD_TILING = {64: (1, 1), 80: (2, 0), 128: (1, 0), 192: (2, 0)}
#: an SM's shared memory for blocks (a block asks at most 232,448 bytes of
#: it: 1,024 are reserved a block), and the most slots of the K/V ring
SM_SMEM, FWD_MAX_STAGES = 233472, 4
#: bytes of one 128-byte-swizzled TMA box of 64 rows (a Q, K or V tile is ceil(D / 64) of them)
_BOX = 64 * 128


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q [B,H,Sq,D] and k, v [B,KVH,Skv,D], got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} disagree on batch or head dim")
    if k.shape[1] == 0 or h % k.shape[1] != 0:
        raise ValueError(f"q heads {h} are not a multiple of kv heads {k.shape[1]}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def _mask(sq: int, skv: int, causal: bool, window: int, device) -> torch.Tensor:
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= qpos - kpos < window
    return mask


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool, window: int) -> torch.Tensor:
    """Scaled, masked fp32 scores [B, KVH, G, Sq, Skv] (-inf where masked)."""
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, kvh, h // kvh, sq, d)
    scores = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) / math.sqrt(d)
    return scores.masked_fill(~_mask(sq, skv, causal, window, q.device), float("-inf"))


def score_divisor(d: int) -> float:
    """The bf16-score mode's scale: the scores are divided by ``sqrt(d)``
    rounded to bf16 (5.65625 at D 32, 8.9375 at 80, 11.3125 at 128, 13.875 at
    192; exact at 16 and 64), as the reference's weakly typed Python float
    becomes the bf16 scores' type."""
    return float(torch.tensor(math.sqrt(d), dtype=torch.float32).to(torch.bfloat16))


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (to nearest, ties to even), held in fp32."""
    return x.to(torch.bfloat16).float()


#: the window of XLA's CPU tree reduction: a longer axis is summed in windows of this many
TREE_WINDOW = 32


def tree_levels(n: int) -> list[int]:
    """The zero padding before each window level of :func:`bf16_row_sum`
    over ``n`` values: while more than ``TREE_WINDOW`` remain, they are padded
    to a multiple of it (half the padding in front, the odd one behind) and
    each window summed, so ``n`` becomes ``ceil(n / TREE_WINDOW)``."""
    pads = []
    while n > TREE_WINDOW:
        pads.append((-n % TREE_WINDOW) // 2)
        n = -(-n // TREE_WINDOW)
    return pads


def tree_sum(t: torch.Tensor, *, bf16: bool) -> torch.Tensor:
    """The sum over the last axis of fp32 ``t`` in the order XLA's CPU
    backend gives a ``reduce_sum`` (the reference's): its tree reduction
    pads an axis longer than ``TREE_WINDOW`` with zeros (:func:`tree_levels`),
    sums each window from its first element on, and repeats over the window
    sums; the last ``<= TREE_WINDOW`` values are summed in order.  With
    ``bf16`` every addition is rounded to bf16, as a bf16 ``reduce_sum``
    under ``--xla_allow_excess_precision=false`` adds (``t`` then holds bf16
    values); else each is an fp32 addition."""
    for lo in tree_levels(t.shape[-1]):
        hi = -(t.shape[-1] + lo) % TREE_WINDOW
        t = _sequential_sum(torch.nn.functional.pad(t, (lo, hi)).unflatten(-1, (-1, TREE_WINDOW)), bf16)
    return _sequential_sum(t, bf16)


def bf16_row_sum(t: torch.Tensor) -> torch.Tensor:
    """:func:`tree_sum` in bf16: the backward's R.  An fp32 sum rounded
    once, or one bf16 sum in plain order, gives other bits in about a third
    of the rows, and the backward's cancellation ``bf16(g / l) - R`` turns
    that into errors of 1e-2 of the gradient's max."""
    return tree_sum(t, bf16=True)


def _sequential_sum(t: torch.Tensor, bf16: bool) -> torch.Tensor:
    acc = torch.zeros_like(t[..., 0])
    for j in range(t.shape[-1]):
        acc = bf16_round(acc + t[..., j]) if bf16 else acc + t[..., j]
    return acc


def _bf16_softmax(q: torch.Tensor, k: torch.Tensor, causal: bool, window: int):
    """The bf16-score mode's forward up to the probabilities, each step
    rounded to bf16 and held in fp32, [B, KVH, G, Sq, Skv] (rows [..., 1]):
    (m, l, y) with s = bf16(bf16(q·kᵀ) / score_divisor(D)) (-inf where
    masked), m = max s, u = bf16(exp(bf16(s - m))), l = bf16(Σ u) (the sum
    in fp32, :func:`tree_sum`), y = bf16(u / l)."""
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, kvh, h // kvh, sq, d)
    s = bf16_round(bf16_round(torch.einsum("bkgqd,bksd->bkgqs", qg, k.float())) / score_divisor(d))
    s = s.masked_fill(~_mask(sq, skv, causal, window, q.device), float("-inf"))
    m = s.amax(-1, keepdim=True)
    u = bf16_round(torch.exp(bf16_round(s - m)))
    l = bf16_round(tree_sum(u, bf16=False)[..., None])
    return m, l, bf16_round(u / l)


def _weighted(probs: torch.Tensor, v: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """probs [B, KVH, G, Sq, Skv] (fp32 values) times v, summed in fp32 ->
    [B, H, Sq, D] in q's type."""
    b, h, sq, d = q.shape
    return torch.einsum("bkgqs,bksd->bkgqd", probs, v.float()).reshape(b, h, sq, d).to(q.dtype)


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True, window: int = 0,
    fp32_scores: bool = True,
) -> torch.Tensor:
    """Exact attention in fp32.  q: [B, H, Sq, D]; k, v: [B, KVH, Skv, D]
    -> [B, H, Sq, D] in ``q.dtype``.  Key j is visible to query i when
    ``j <= i`` (causal) and ``i - j < window`` (window > 0), positions
    counted from 0 on both sides, as ``blocks._sdpa_chunk`` masks at
    ``q_offset = 0``.  A row that sees no key (only where Sq > Skv under a
    window) is NaN, as there.

    ``fp32_scores=False`` is the reference's ``attn_fp32_scores=False``
    (``repro/models/blocks.py:57-67`` and the jaxpr of ``jax.nn.softmax``):
    s = bf16(bf16(q·kᵀ summed in fp32) / bf16(sqrt(D))), masked to -inf;
    m = max s; u = bf16(exp(bf16(s - m))); l = bf16(Σ u summed in fp32,
    in XLA's CPU order, :func:`tree_sum`); y = bf16(u / l), cast to q's
    type before y·V."""
    _check_shapes(q, k, v, window)
    if fp32_scores:
        return _weighted(torch.softmax(_scores(q, k, causal, window), dim=-1).to(v.dtype).float(), v, q)
    return _weighted(_bf16_softmax(q, k, causal, window)[2].to(q.dtype).float(), v, q)


def flash_attention_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True, window: int = 0,
    fp32_scores: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(o, lse): :func:`flash_attention_plain`'s output and the log-sum-exp
    of each row's scaled, masked scores, fp32 [B, H, Sq] (-inf for a row
    that sees no key), as the kernel writes it with ``return_lse``.  With
    ``fp32_scores=False``, (o, stats): stats fp32 [2, B, H, Sq] holds each
    row's max m and bf16 sum l of the bf16-score softmax, in the lse's
    place."""
    b, h, sq, _ = q.shape
    if fp32_scores:
        lse = torch.logsumexp(_scores(q, k, causal, window), dim=-1).reshape(b, h, sq)
        return flash_attention_plain(q, k, v, causal=causal, window=window), lse
    _check_shapes(q, k, v, window)
    m, l, y = _bf16_softmax(q, k, causal, window)
    return _weighted(y.to(q.dtype).float(), v, q), torch.stack([m.reshape(b, h, sq), l.reshape(b, h, sq)])


def _check_sees_a_key(sq: int, skv: int, window: int) -> None:
    """The backward needs every query row to see a key: a row sees none
    only under a window, where Sq >= Skv + window (causal or not)."""
    if window > 0 and sq >= skv + window:
        raise ValueError(f"query rows from {skv + window - 1} on see no key (Sq {sq}, Skv {skv}, window {window}): "
                         f"their output is NaN and has no gradient")


def flash_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
    *, causal: bool = True, window: int = 0, fp32_scores: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of :func:`flash_attention_plain` by its explicit
    formulas in fp32: P = exp(S·scale - lse), delta = rowsum(dO∘O),
    dV = P̃ᵀ·dO with P̃ = P rounded to ``v.dtype`` (as the forward rounds it
    before P·V), dS = P∘(dO·Vᵀ - delta), dQ = scale·dS·K, dK = scale·dSᵀ·Q,
    each q-head's dK and dV summed into its kv-head.  Returns (dq, dk, dv)
    in the inputs' types; raises where a row sees no key.

    ``fp32_scores=False``: ``lse`` is the forward's (m, l) stats
    (:func:`flash_attention_fwd_plain`), and the formulas are ``jax.grad``'s
    of the bf16-score forward, op by op (its jaxpr: ``jax.nn.softmax`` is
    differentiated through its division, with ``integer_pow`` for l⁻²):
    g = bf16(dO·Vᵀ); R = :func:`bf16_row_sum` of bf16(bf16(g · bf16(1 /
    bf16(l·l))) · u); dS = bf16(bf16(bf16(g / l) - R) · u) where visible, 0
    elsewhere; dS' = bf16(dS / bf16(sqrt(D))); dQ = dS'·K, dK = dS'ᵀ·Q,
    dV = yᵀ·dO, the products summed in fp32."""
    _check_shapes(q, k, v, window)
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    _check_sees_a_key(sq, skv, window)
    if not fp32_scores:
        return _bwd_plain_bf16_scores(q, k, v, lse, do, causal, window)
    g, scale = h // kvh, 1.0 / math.sqrt(d)
    p = torch.exp(_scores(q, k, causal, window) - lse.float().reshape(b, kvh, g, sq, 1))
    dof = do.float().reshape(b, kvh, g, sq, d)
    delta = (dof * o.float().reshape(b, kvh, g, sq, d)).sum(-1, keepdim=True)
    dv = torch.einsum("bkgqs,bkgqd->bksd", p.to(v.dtype).float(), dof)
    ds = p * (torch.einsum("bkgqd,bksd->bkgqs", dof, v.float()) - delta)
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, k.float()) * scale
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, q.float().reshape(b, kvh, g, sq, d)) * scale
    return dq.reshape(b, h, sq, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_plain_bf16_scores(q, k, v, stats, do, causal, window):
    """:func:`flash_attention_bwd_plain` with ``fp32_scores=False``.  u is
    recomputed from the scores and the saved m; y from u and the saved l."""
    b, h, sq, d = q.shape
    kvh = k.shape[1]
    g = h // kvh
    if stats.shape != (2, b, h, sq):
        raise ValueError(f"the bf16-score backward takes the forward's (m, l) stats [2, {b}, {h}, {sq}], "
                         f"got {tuple(stats.shape)}")
    m, l = (t.float().reshape(b, kvh, g, sq, 1) for t in stats)
    qg = q.float().reshape(b, kvh, g, sq, d)
    c = score_divisor(d)
    mask = _mask(sq, k.shape[2], causal, window, q.device)
    s = bf16_round(bf16_round(torch.einsum("bkgqd,bksd->bkgqs", qg, k.float())) / c).masked_fill(~mask, float("-inf"))
    u = bf16_round(torch.exp(bf16_round(s - m)))
    y = bf16_round(u / l).to(q.dtype).float()
    dof = do.float().reshape(b, kvh, g, sq, d)
    dp = bf16_round(torch.einsum("bkgqd,bksd->bkgqs", dof, v.float()))
    r = bf16_row_sum(bf16_round(bf16_round(dp * bf16_round(1.0 / bf16_round(l * l))) * u))[..., None]
    ds = bf16_round(bf16_round(bf16_round(dp / l) - r) * u).masked_fill(~mask, 0.0)
    ds = bf16_round(ds / c)
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, k.float())
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qg)
    dv = torch.einsum("bkgqs,bkgqd->bksd", y, dof)
    return dq.reshape(b, h, sq, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _vector_strides(t: torch.Tensor) -> tuple[int, int, int] | None:
    """The batch, head and position strides of ``t`` if it has unit stride
    over D, strides that are multiples of 4 and a 16-byte aligned base (rows
    the kernel's vector copies can read), else None."""
    sb, sh, ss, sd = t.stride()
    if sd != 1 or sb % 4 or sh % 4 or ss % 4 or t.data_ptr() % 16:
        return None
    return sb, sh, ss


def _tma_rows(t: torch.Tensor) -> bool:
    """Whether TMA can address ``t``'s rows: unit stride over D, every other
    stride a multiple of 8 elements (16 bytes) and non-zero where its dim
    is longer than 1, and a 16-byte-aligned base."""
    *outer, sd = t.stride()
    return (sd == 1 and t.data_ptr() % 16 == 0
            and all(s % 8 == 0 and (s > 0 or n == 1) for s, n in zip(outer, t.shape[:3])))


def fwd_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, fp32_scores: bool = True) -> str:
    """The forward's route (a key of ``FWD_ROUTES``) by type, score mode,
    head dim, strides and alignment alone: ``"simt"`` for fp32;
    ``"wgmma"`` for bf16 with fp32 scores at a head dim of
    ``FWD_WGMMA_HEAD_DIMS`` where TMA can address every row of q, k and v
    (the output, allocated like q, then is too); ``"mma"`` for every other
    bf16 call (D 16 and 32, rows only 8-byte aligned, and the bf16-score
    mode, whose forward sweeps the keys three times)."""
    if q.dtype == torch.float32:
        return "simt"
    if fp32_scores and q.shape[-1] in FWD_WGMMA_HEAD_DIMS and all(_tma_rows(t) for t in (q, k, v)):
        return "wgmma"
    return "mma"


def fwd_plan(d: int, tiling: tuple[int, int] | None = None) -> dict:
    """``flash_fwd_wgmma_kernel<d>``'s tiling and shared-memory plan as the
    source computes it (``fwd_tiling``, ``fwd_wgmma_smem``) for ``tiling``
    (consumer warpgroups, overlap; default the shipped ``FWD_TILING[d]``):
    the blocks an SM it is planned for (two where one consumer warpgroup
    leaves room for a ring of two slots each), the ring's slots of 64-key
    K/V tiles (as many as fit, at most ``FWD_MAX_STAGES``), and the bytes a
    block asks: 1,024 of alignment slack, two slots of a Q tile of ceil(d /
    64) boxes a consumer warpgroup (the next work tile's loading while the
    last one's output is stored), the ring of K and V tiles and the
    barriers.  Keys as ``FWD_CONFIG_FIELDS`` but the measured
    ``blocks_an_sm``, with a tile's bytes (every tile starts 1,024-byte
    aligned)."""
    wgs, overlap = FWD_TILING[d] if tiling is None else tiling
    boxes = -(-d // 64)

    def fit(groups: int, blocks: int) -> int:
        room = SM_SMEM // blocks - 1024 - 1024 - 128 - 2 * groups * boxes * _BOX
        return min(FWD_MAX_STAGES, room // (2 * boxes * _BOX))

    bps = 2 if wgs == 1 and fit(1, 2) >= 2 else 1
    stages = fit(wgs, bps)
    return {"consumer_warpgroups": wgs, "overlap": overlap, "stages": stages, "planned_blocks_an_sm": bps,
            "smem_bytes": 1024 + 2 * wgs * boxes * _BOX + stages * 2 * boxes * _BOX + 2 * (2 + stages) * 8,
            "tile_bytes": boxes * _BOX}


def fwd_kernels(route: str, d: int, fp32_scores: bool = True) -> tuple[str, ...]:
    """The kernel one forward launches on ``route`` at head dim ``d``, as
    the profiler names it."""
    if route == "wgmma" and fp32_scores:
        return (f"flash_fwd_wgmma_kernel<{d}>",)
    if route == "mma":
        return (f"flash_fwd_mma_bf16{'' if fp32_scores else '_scores'}_kernel<{d}>",)
    if route == "simt":
        return (f"flash_fwd_{'' if fp32_scores else 'bf16_scores_'}kernel<{d}>",)
    raise ValueError(f"no forward route {route!r}{'' if fp32_scores else ' in the bf16-score mode'} "
                     f"(have {tuple(FWD_ROUTES)})")


def bwd_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, do: torch.Tensor,
              fp32_scores: bool = True) -> str:
    """The backward's route (a key of ``BWD_ROUTES``) by type, head dim,
    strides and alignment alone: ``"simt"`` for fp32; ``"wgmma"`` for bf16
    at a head dim of ``WGMMA_HEAD_DIMS`` where TMA can address every row of
    q, k, v, o and dO; ``"mma"`` for every other bf16 call (D 16, 32 and
    192, rows only 8-byte aligned).  The bf16-score mode (``fp32_scores=
    False``) takes the same routes."""
    if q.dtype == torch.float32:
        return "simt"
    if q.shape[-1] in WGMMA_HEAD_DIMS and all(_tma_rows(t) for t in (q, k, v, o, do)):
        return "wgmma"
    return "mma"


def bwd_cluster(h: int, kvh: int) -> tuple[int, int]:
    """(blocks a cluster, q-heads a block) of the wgmma route's dK/dV
    kernel for ``h`` q-heads over ``kvh`` kv-heads: the cluster is the
    largest divisor of the GQA group G = h / kvh that is at most
    ``PORTABLE_CLUSTER``, and each of its blocks takes G / cluster q-heads
    (G 4: 4 blocks of one; G 12: 6 of two; G 11: 1 of eleven)."""
    g = h // kvh
    c = max(n for n in range(1, min(g, PORTABLE_CLUSTER) + 1) if g % n == 0)
    return c, g // c


def bwd_kernels(route: str, d: int, fp32_scores: bool = True) -> tuple[str, ...]:
    """The kernels one backward launches on ``route`` at head dim ``d``, in
    launch order, as the profiler names them.  The bf16-score mode has no
    delta pre-pass: its dQ kernel computes each row's R and leaves it for
    the dK/dV kernels."""
    if not fp32_scores:
        if route == "wgmma":
            return f"flash_bwd_dq_wgmma_bf16_scores_kernel<{d}>", f"flash_bwd_dkdv_wgmma_bf16_scores_kernel<{d}>"
        if route == "mma":
            modes = (1, 2) if d >= 128 else (3,)
            return (f"flash_bwd_dq_mma_bf16_scores_kernel<{d}>",
                    *(f"flash_bwd_dkdv_mma_bf16_scores_kernel<{d}, {m}>" for m in modes))
        if route == "simt":
            return f"flash_bwd_dq_bf16_scores_kernel<{d}>", f"flash_bwd_dkdv_bf16_scores_kernel<{d}>"
        raise ValueError(f"no bf16-score backward on route {route!r} (have {tuple(BWD_ROUTES)})")
    if route == "wgmma":
        return f"flash_bwd_dq_wgmma_kernel<{d}>", f"flash_bwd_dkdv_wgmma_kernel<{d}>"
    if route == "mma":
        modes = (1, 2) if d >= 128 else (3,)
        return ("flash_bwd_delta_kernel<__nv_bfloat16>", f"flash_bwd_dq_mma_bf16_kernel<{d}>",
                *(f"flash_bwd_dkdv_mma_bf16_kernel<{d}, {m}>" for m in modes))
    if route == "simt":
        return "flash_bwd_delta_kernel<float>", f"flash_bwd_dq_kernel<{d}>", f"flash_bwd_dkdv_kernel<{d}>"
    raise ValueError(f"no backward route {route!r} (have {tuple(BWD_ROUTES)})")


def _check_device(*ts: torch.Tensor) -> None:
    if not all(t.is_cuda for t in ts):
        raise ValueError(f"flash_attention needs CUDA tensors, got {[str(t.device) for t in ts]}")
    if len({t.device for t in ts}) != 1 or ts[0].device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {[str(t.device) for t in ts]}, current device cuda:{torch.cuda.current_device()}")
    if ts[0].dtype not in _DTYPES or any(t.dtype != ts[0].dtype for t in ts):
        raise TypeError(f"flash_attention takes float32 or bfloat16 alike, got {[t.dtype for t in ts]}")


def _check_kernel_shapes(q: torch.Tensor, k: torch.Tensor, rows: int) -> None:
    """What the kernels take beyond :func:`_check_shapes`: a built head dim,
    no empty axis, and grids the launch can address (``rows`` query rows a
    block in the y dimension)."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported (have {HEAD_DIMS})")
    if min(b, sq, skv) == 0:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k/v {tuple(k.shape)}")
    if b * h > 2**31 - 1 or -(-sq // rows) > 65535 or -(-skv // 32) > 65535:
        raise ValueError(f"grid too large for q {tuple(q.shape)}, k/v {tuple(k.shape)}")


def _strides(*ts: torch.Tensor) -> list[int]:
    """The batch, head and position strides of each tensor, checked as :func:`_vector_strides`."""
    out = []
    for t in ts:
        st = _vector_strides(t)
        if st is None:
            raise ValueError("flash_attention needs unit stride over D and 16-byte aligned rows (strides % 4 == 0)")
        out += st
    return out


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True, window: int = 0,
    return_lse: bool = False, fp32_scores: bool = True,
):
    """Attention on the CUDA kernels.  q: [B, H, Sq, D]; k, v: [B, KVH, Skv,
    D], float32 or bfloat16 on the current CUDA device, D in ``HEAD_DIMS``,
    unit stride over D (other strides free, so ``[b, s, h, d]`` tensors pass
    as transposed views) -> [B, H, Sq, D] with q's layout and type.  Masks
    as :func:`flash_attention_plain`.  With ``return_lse`` returns (o, lse),
    lse the fp32 [B, H, Sq] log-sum-exp of each row's scaled scores, which
    :func:`flash_attention_bwd` takes.  ``fp32_scores=False`` runs the
    bf16-score mode (``flash_fwd_mma_bf16_scores_kernel`` for bf16,
    ``flash_fwd_bf16_scores_kernel`` for fp32), and ``lse`` is then the
    (m, l) stats, fp32 [2, B, H, Sq].

    Launches the kernel of :func:`fwd_route`'s route (:func:`fwd_kernels`)
    on the current stream without synchronising (one count in
    ``launches``, or ``bf16_scores_launches`` in the mode); raises if the
    inputs are not what the kernel takes or the launch is refused.
    """
    _check_device(q, k, v)
    _check_shapes(q, k, v, window)
    return _launch_fwd(q, k, v, fwd_route(q, k, v, fp32_scores), causal, window, return_lse, fp32_scores)


def run_fwd_route(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, route: str, causal: bool = True, window: int = 0,
    return_lse: bool = False,
):
    """:func:`flash_attention` (fp32 scores) on ``route``, which need not be
    :func:`fwd_route`'s: ``"mma"`` takes every bf16 call (so the wgmma
    route's shapes can be timed on the ``mma.sync`` kernel beside it),
    ``"wgmma"`` only where :func:`fwd_route` picks it, ``"simt"`` fp32."""
    _check_device(q, k, v)
    _check_shapes(q, k, v, window)
    picked = fwd_route(q, k, v)
    if route not in ({"simt"} if picked == "simt" else {"mma", picked}):
        raise ValueError(f"the forward of q {tuple(q.shape)} ({q.dtype}) has no route {route!r} (it takes {picked!r})")
    return _launch_fwd(q, k, v, route, causal, window, return_lse, True)


def _launch_fwd(q, k, v, route: str, causal: bool, window: int, return_lse: bool, fp32_scores: bool):
    global launches, bf16_scores_launches
    _check_kernel_shapes(q, k, 64)
    b, h, sq, d = q.shape
    strides = _strides(q, k, v)
    o = torch.empty_like(q)  # same strides as q: a transposed [b, s, h, d] view stays one
    lse = None
    if return_lse:
        lse = torch.empty((b, h, sq) if fp32_scores else (2, b, h, sq), dtype=torch.float32, device=q.device)
    err = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None if lse is None else lse.data_ptr(),
        FWD_ROUTES[route], b, h, k.shape[1], sq, k.shape[2], d,
        *strides, *o.stride()[:3],
        int(causal), int(window), int(not fp32_scores), 1.0 / math.sqrt(d) if fp32_scores else score_divisor(d),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err >= _TENSOR_MAP_ERROR:
        raise RuntimeError(f"flash_attention: cuTensorMapEncodeTiled refused a tensor map "
                           f"(CUresult {err - _TENSOR_MAP_ERROR})")
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed on route {route!r}: cudaError {err}")
    if fp32_scores:
        launches += 1
    else:
        bf16_scores_launches += 1
    return (o, lse) if return_lse else o


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
    *, causal: bool = True, window: int = 0, fp32_scores: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward on the CUDA kernels: (dq, dk, dv) of
    :func:`flash_attention` from its inputs, its output ``o`` and ``lse``
    (``return_lse=True``) and ``do``, the gradient of o.  q, k, v, o and do
    as :func:`flash_attention` takes them (do and o with q's shape); the
    gradients have their inputs' shapes, types and layouts.  Raises where a
    query row sees no key (Sq >= Skv + window): its output is NaN.
    ``fp32_scores=False``: the bf16-score mode's backward, ``lse`` the
    forward's (m, l) stats [2, B, H, Sq].

    Launches the kernels of :func:`bwd_route`'s route (:func:`bwd_kernels`)
    on the current stream without synchronising (one count in
    ``bwd_launches``, or ``bf16_scores_bwd_launches`` in the mode); raises
    if the inputs are not what the kernels take or a launch is refused.
    """
    global bwd_launches, bf16_scores_bwd_launches
    _check_device(q, k, v, o, do)
    _check_shapes(q, k, v, window)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must have q's shape {tuple(q.shape)}")
    b, h, sq, d = q.shape
    want = (b, h, sq) if fp32_scores else (2, b, h, sq)
    if lse.shape != want or lse.dtype != torch.float32 or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"lse must be contiguous fp32 {list(want)} on {q.device}, got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")
    _check_sees_a_key(sq, k.shape[2], window)
    _check_kernel_shapes(q, k, 8)
    if not fp32_scores and len(tree_levels(k.shape[2])) > 3:
        raise ValueError(f"the bf16-score backward sums R over at most {TREE_WINDOW ** 4} keys, got {k.shape[2]}")
    route = bwd_route(q, k, v, o, do, fp32_scores)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    strides = (ctypes.c_longlong * 24)(*_strides(q, k, v, o, do, dq, dk, dv))
    # delta (R in the bf16-score mode) [B, H, Sq]; on the wgmma route each 64-row q tile's lse * log2(e) and
    # delta (the mode: m, l, R and 1 / l), rows past Sq included
    tile = 128 if fp32_scores else 256
    scratch = torch.empty(b * h * (-(-sq // 64) * tile if route == "wgmma" else sq), dtype=torch.float32,
                          device=q.device)
    err = _bwd_kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(), BWD_ROUTES[route],
        bwd_cluster(h, k.shape[1])[0], b, h, k.shape[1], sq, k.shape[2], d, strides,
        int(causal), int(window), int(not fp32_scores), 1.0 / math.sqrt(d) if fp32_scores else score_divisor(d),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err >= _TENSOR_MAP_ERROR:
        raise RuntimeError(f"flash_attention_bwd: the driver refused a tensor map (CUresult {err - _TENSOR_MAP_ERROR})")
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: cudaError {err}")
    if fp32_scores:
        bwd_launches += 1
    else:
        bf16_scores_bwd_launches += 1
    return dq, dk, dv


@functools.cache
def _kernel():
    """The C entry ``flash_attention_fwd``, typed."""
    from .build import library

    fn = library("flash_attention").flash_attention_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 12
        + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def scalar_check() -> dict:
    """The bf16-score mode's scalar steps held on the card to the IEEE ops
    they replace over every input they can take (``csrc/flash_attention.cu``,
    ``flash_bf16s_scalar_check``): bf16(x / c) at each head dim's
    :func:`score_divisor` over all 65,536 bf16 x; bf16(x / l) over all 2^32
    bf16 pairs (x, l), and its exact path alone (which also gives each row's
    bf16(1 / bf16(l·l))); bf16(exp(t)) over all 65,536 bf16 t (the
    backward's recomputed score may lie a step above the forward's m).  Returns ``{"steps": [{"step", "inputs", "mismatches"},
    ...], "exp_max_ulp": ...}``, the last the largest distance of the fast
    exp's fp32 value from ``expf`` in units in the last place (what its
    margin must cover).  Needs a CUDA device; synchronises."""
    divisors = [score_divisor(d) for d in HEAD_DIMS]
    out = torch.zeros(len(divisors) + 4, dtype=torch.int64, device="cuda")
    fn = _check_kernel()
    err = fn((ctypes.c_float * len(divisors))(*divisors), len(divisors), out.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_bf16s_scalar_check launch failed: cudaError {err}")
    n = out.tolist()
    steps = [{"step": f"bf16(x / {c}) (D {d})", "inputs": 2**16, "mismatches": n[i]}
             for i, (d, c) in enumerate(zip(HEAD_DIMS, divisors))]
    steps += [{"step": "bf16(x / l)", "inputs": 2**32, "mismatches": n[-4]},
              {"step": "bf16(x / l), exact path alone", "inputs": 2**32, "mismatches": n[-3]},
              {"step": "bf16(exp(t))", "inputs": 2**16, "mismatches": n[-2]}]
    return {"steps": steps, "exp_max_ulp": n[-1]}


@functools.cache
def _check_kernel():
    """The C entry ``flash_bf16s_scalar_check``, typed."""
    from .build import library

    fn = library("flash_attention").flash_bf16s_scalar_check
    fn.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fwd_config(d: int) -> dict:
    """What ``flash_fwd_wgmma_kernel<d>`` was built with
    (``FWD_CONFIG_FIELDS``: its tiling, ring, shared memory, and the blocks
    an SM of the current card holds at once)."""
    from .build import library

    fn = library("flash_attention").flash_fwd_wgmma_config
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(FWD_CONFIG_FIELDS))()
    err = fn(d, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"flash forward wgmma config at D {d}: cudaError {err}")
    return dict(zip(FWD_CONFIG_FIELDS, out))


def bwd_occupancy(d: int, fp32_scores: bool, dkdv: bool) -> int:
    """Blocks of the wgmma route's dQ (or, ``dkdv``, dK/dV) kernel at head
    dim ``d`` one SM of the current card holds at once."""
    from .build import library

    fn = library("flash_attention").flash_bwd_wgmma_occupancy
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    got = fn(d, int(not fp32_scores), int(dkdv))
    if got < 0:
        raise RuntimeError(f"flash backward wgmma occupancy at D {d}: cudaError {-got}")
    return got


@functools.cache
def _bwd_kernel():
    """The C entry ``flash_attention_bwd``, typed."""
    from .build import library

    fn = library("flash_attention").flash_attention_bwd
    fn.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_longlong)]
        + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


# ---------------------------------------------------------------------------
# Work and traffic of one call (the bounds of chip_smoke.py, the dry run's counts)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def visible_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask leaves visible: the work the data needs."""
    n = 0
    for i in range(sq):
        hi = min(i, skv - 1) if causal else skv - 1
        lo = max(0, i - window + 1) if window else 0
        n += max(0, hi - lo + 1)
    return n


def cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window: int) -> tuple[float, float]:
    """FLOPs and bytes of one forward: the two products over the visible
    pairs; q, k, v and the output each read or written once."""
    b, h, sq, d = q.shape
    flops = 4.0 * b * h * d * visible_pairs(sq, k.shape[2], causal, window)
    return flops, float(q.element_size() * (2 * q.numel() + k.numel() + v.numel()))


def bwd_cost(q: torch.Tensor, k: torch.Tensor, causal: bool, window: int) -> tuple[float, float]:
    """FLOPs and bytes of one backward: five products over the visible
    pairs; q, o, dO, dq, k, v, dk, dv once each, lse and delta in fp32."""
    b, h, sq, d = q.shape
    flops = 10.0 * b * h * d * visible_pairs(sq, k.shape[2], causal, window)
    return flops, float(q.element_size() * 4 * (q.numel() + k.numel()) + 4 * 2 * b * h * sq)
