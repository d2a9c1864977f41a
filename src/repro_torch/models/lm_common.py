"""Shared LM machinery of the port: config, parameter trees, small ops.

Port of ``repro/models/lm_common.py``.  :class:`LMConfig` keeps every field
and property of the reference, with torch dtypes (``dtype=torch.bfloat16``,
``accum_dtype=torch.float32``).  Parameters are a plain dict with the
reference's keys, stacked over layers (``[L, ...]`` leading axis); the layer
loop is a Python loop over views of them.

The parameter tree is described once, by :func:`param_spec` (shape, init
rule and dtype of every leaf); :func:`init_params` draws it from a
``torch.Generator`` with the reference's ``_dense`` scaling, and
:func:`params_from_numpy` loads the JAX package's arrays into it.  A
``torch.Generator`` cannot reproduce ``jax.random``, so weights that must
match the reference cross as numpy.

:func:`param_shardings` is the reference's layout of that tree over a
``("data", "model")`` mesh, as :class:`~repro_torch.sharding.P` specs
(``models/layout.py`` applies it).

The activation constraints.  The reference pins activation layouts for
GSPMD: ``dist_context`` opens a module global ``_DIST`` (mesh, data axes,
tensor-parallel axis, ``seq_shard = cfg.sp_residuals``) and ``cstr_act`` /
``cstr_heads`` / ``cstr_custom`` constrain a tensor to a spec, from which
XLA derives the collectives.  The port has no compiler to derive them: the
same rules are here as functions of a shape that return the spec
(:func:`cstr_act`, :func:`cstr_heads`, :func:`cstr_custom`, reading a
:class:`DistContext` passed explicitly, never a global), and
``models/layout.py`` realises the spec with explicit collectives
(``collectives.py``).  ``cstr_act``'s spec is the residual stream's: the
sequence over ``model`` (Megatron-style sequence parallelism) when
``seq_shard`` is on, the array has three or more dims and ``model``
divides its length; else the sequence whole (whisper's 1,500 frames on
16).  Each reference call site and its counterpart:

* ``transformer.py:189, 304, 441`` (``dist_context`` around
  ``train_loss``, ``serve_step``, ``prefill_step``): the ``Layout`` those
  entry points build holds ``dist_context(mesh, dp_axes, tp_axis,
  cfg.sp_residuals)`` (``Layout.dist``).
* ``transformer.py:111, 113, 122, 135, 159, 161, 173, 176`` (``cstr_act`` on
  each layer's input and output in ``backbone``'s ``attn``, ``ssd`` and
  ``hybrid`` bodies, ``encoder`` and ``decoder_with_cross``):
  ``Layout.stream`` decides once per stack by :func:`cstr_act`;
  ``Layout.enter`` splits the stream after the embedding (or the frames),
  every layer takes and returns the rank's block, and ``Layout.leave``
  gathers it after the final norm.  Decode's one position stays whole, as
  ``cstr_act``'s divisibility rule gives it.
* ``transformer.py:59`` (``cstr_act`` on each loss chunk): none; the stream
  is gathered once before the loss (``Layout.leave``), whose chunks run on
  the rank's vocab block (``_xent_chunk_tp``).
* ``blocks.py:45`` (``cstr_heads`` on q, k, v): ``Layout.attn_plan``, the
  heads over ``model`` only when :func:`cstr_heads` splits them; else the
  attention runs whole on every rank.
* ``blocks.py:89-90`` (``cstr_heads`` on the repeated K/V of
  ``attn_repeat_kv``): none; the flash kernel maps query heads to KV heads
  itself, and ``"kv_one"`` keeps a KV head shared by ranks.
* ``blocks.py:104, 109, 115`` (``cstr_custom`` around the q-chunk scan):
  none; the flash kernel replaces ``attn_q_block`` chunking.
* ``blocks.py:394`` (``cstr_heads`` on the SSD's x): ``Layout.ssd_heads``,
  the heads over ``model`` only when :func:`cstr_heads` splits them; each
  rank then projects, convolves, scans, norms (its gated norm's mean square
  summed over ``model``) and decodes its own heads (``Layout.ssd``,
  ``blocks.ssd_block(tp=)``, ``ssd_decode(tp=)``); else the layer runs
  whole on every rank.
* ``_dp_if_divisible`` (batch over the data axes only when they divide
  it): :func:`_dp_if_divisible`, in :func:`cstr_act`'s spec; the mesh
  paths are given the rank's slice of the batch (``launch.mesh.batch_shard``)
  or the whole batch with ``dp_axes=()``, as the dry run gives a batch the
  data axes do not divide (``launch.dryrun.build``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import numpy as np
import torch

from ..sharding import P, mesh_shape

# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 => d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    ffn_kind: str = "swiglu"  # swiglu | relu2
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 64
    #: "attn" for pure transformers, "ssd" for mamba2, "hybrid" for zamba2
    block_kind: str = "attn"
    #: hybrid: apply the shared attention block after every k-th SSD layer
    shared_attn_every: int = 6
    # enc-dec (whisper)
    enc_layers: int = 0
    enc_frames: int = 0
    max_decoder_len: int = 0  # whisper caps self-attn context at 448
    # VLM
    n_patches: int = 0  # internvl: patch embeddings prepended (stub frontend)
    sliding_window: int = 0  # 0 => full attention
    attn_q_block: int = 256  # reference's q-chunk of blockwise attention (the flash kernel replaces it)
    loss_chunk: int = 512  # chunked-xent sequence chunk
    scan_unroll: bool = False  # reference dry-run knob; no effect here
    # --- perf-iteration knobs of the reference ---
    sp_residuals: bool = True
    attn_fp32_scores: bool = True
    accum_dtype: Any = torch.float32
    attn_repeat_kv: bool = False  # the flash kernel maps q-heads to kv-heads itself
    decode_block: int = 1
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    remat: str = "full"  # full | none

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.hd

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Total parameter count N, from the shapes of :func:`param_spec`."""
        return sum(math.prod(leaf.shape) for leaf in _leaves(param_spec(self)))

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top_k + shared only)."""
        total = self.param_count()
        if not self.is_moe:
            return total
        per_expert = _ffn_param_count(self)
        inactive = (self.n_experts - self.top_k) * per_expert * self.n_layers
        return total - inactive


def _ffn_param_count(cfg: LMConfig) -> int:
    mats = 3 if cfg.ffn_kind == "swiglu" else 2
    return mats * cfg.d_model * cfg.d_ff


# ---------------------------------------------------------------------------
# Parameter tree (stacked over layers)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One parameter: ``init`` is "dense" (N(0,1) / sqrt(scale)), "ones" or
    "zeros", as the reference's ``_dense`` / ``jnp.ones`` / ``jnp.zeros``."""

    shape: tuple[int, ...]
    init: str
    dtype: Any
    scale: int = 1


def _dense(shape, scale, dtype) -> Leaf:
    return Leaf(tuple(shape), "dense", dtype, scale)


def _ones(shape) -> Leaf:
    return Leaf(tuple(shape), "ones", torch.float32)


def _zeros(shape, dtype) -> Leaf:
    return Leaf(tuple(shape), "zeros", dtype)


def _attn_spec(cfg: LMConfig, L: int, dtype) -> dict:
    d, q, kv, hd = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.hd
    p = {
        "wq": _dense((L, d, q), d, dtype),
        "wk": _dense((L, d, kv), d, dtype),
        "wv": _dense((L, d, kv), d, dtype),
        "wo": _dense((L, q, d), q, dtype),
        "ln1": _ones((L, d)),
    }
    if cfg.qkv_bias:
        p.update(bq=_zeros((L, q), dtype), bk=_zeros((L, kv), dtype), bv=_zeros((L, kv), dtype))
    if cfg.qk_norm:
        p.update(q_norm=_ones((L, hd)), k_norm=_ones((L, hd)))
    return p


def _ffn_spec(cfg: LMConfig, L: int, dtype) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.is_moe:
        E = cfg.n_experts
        p = {
            "router": _dense((L, d, E), d, torch.float32),
            "we_gate": _dense((L, E, d, f), d, dtype),
            "we_up": _dense((L, E, d, f), d, dtype),
            "we_down": _dense((L, E, f, d), f, dtype),
            "ln2": _ones((L, d)),
        }
        if cfg.n_shared_experts:
            fs = f * cfg.n_shared_experts
            p.update(
                ws_gate=_dense((L, d, fs), d, dtype),
                ws_up=_dense((L, d, fs), d, dtype),
                ws_down=_dense((L, fs, d), f, dtype),
            )
        return p
    if cfg.ffn_kind == "swiglu":
        return {
            "w_gate": _dense((L, d, f), d, dtype),
            "w_up": _dense((L, d, f), d, dtype),
            "w_down": _dense((L, f, d), f, dtype),
            "ln2": _ones((L, d)),
        }
    if cfg.ffn_kind == "relu2":
        return {"w_in": _dense((L, d, f), d, dtype), "w_out": _dense((L, f, d), f, dtype), "ln2": _ones((L, d))}
    raise ValueError(cfg.ffn_kind)


def _ssd_spec(cfg: LMConfig, L: int, dtype) -> dict:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    # in_proj emits [z (di), x (di), B (n), C (n), dt (h)]
    return {
        "in_proj": _dense((L, d, 2 * di + 2 * n + h), d, dtype),
        "conv_w": _dense((L, 4, di + 2 * n), 4, dtype),  # causal depthwise conv
        "A_log": _zeros((L, h), torch.float32),
        "D": _ones((L, h)),
        "dt_bias": _zeros((L, h), torch.float32),
        "out_proj": _dense((L, di, d), di, dtype),
        "ln": _ones((L, d)),
        "gate_ln": _ones((L, di)),
    }


def param_spec(cfg: LMConfig) -> dict:
    """The parameter tree of any supported architecture, as :class:`Leaf`s:
    the keys, shapes and dtypes of the reference's ``init_params``."""
    dtype = cfg.dtype
    p: dict[str, Any] = {
        "embed": _dense((cfg.vocab, cfg.d_model), cfg.d_model, dtype),
        "ln_f": _ones((cfg.d_model,)),
        "unembed": _dense((cfg.d_model, cfg.vocab), cfg.d_model, dtype),
    }
    if cfg.block_kind == "attn":
        p["blocks"] = {**_attn_spec(cfg, cfg.n_layers, dtype), **_ffn_spec(cfg, cfg.n_layers, dtype)}
    elif cfg.block_kind == "ssd":
        p["blocks"] = _ssd_spec(cfg, cfg.n_layers, dtype)
    elif cfg.block_kind == "hybrid":
        p["blocks"] = _ssd_spec(cfg, cfg.n_layers, dtype)
        shared_cfg = dataclasses.replace(cfg, qkv_bias=False, qk_norm=False, n_experts=0, ffn_kind="swiglu")
        p["shared"] = {**_attn_spec(shared_cfg, 1, dtype), **_ffn_spec(shared_cfg, 1, dtype)}
    else:
        raise ValueError(cfg.block_kind)
    if cfg.is_encdec:
        enc_cfg = dataclasses.replace(cfg, n_experts=0)
        p["enc_blocks"] = {**_attn_spec(enc_cfg, cfg.enc_layers, dtype), **_ffn_spec(enc_cfg, cfg.enc_layers, dtype)}
        p["enc_ln_f"] = _ones((cfg.d_model,))
        d, q, kv, L = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.n_layers
        p["cross"] = {
            "wq": _dense((L, d, q), d, dtype),
            "wk": _dense((L, d, kv), d, dtype),
            "wv": _dense((L, d, kv), d, dtype),
            "wo": _dense((L, q, d), q, dtype),
            "ln": _ones((L, d)),
        }
    if cfg.n_patches:
        p["patch_proj"] = _dense((cfg.d_model, cfg.d_model), cfg.d_model, dtype)
    return p


def _leaves(tree: Mapping) -> list:
    out = []
    for v in tree.values():
        out += _leaves(v) if isinstance(v, Mapping) else [v]
    return out


def _map(fn, spec: Mapping, *trees: Mapping) -> dict:
    return {
        k: _map(fn, v, *(t[k] for t in trees)) if isinstance(v, Mapping) else fn(v, *(t[k] for t in trees))
        for k, v in spec.items()
    }


def init_params(cfg: LMConfig, generator: torch.Generator, device: str | torch.device = "cuda") -> dict:
    """Full parameter tree for any supported architecture, drawn from
    ``generator`` (a generator on ``device``) in the order of
    :func:`param_spec`.

    A dense leaf is drawn in fp32 and cast into its preallocated tensor; a
    stack of matrices (three or more dims: the ``[L, ...]`` layer stacks) one
    layer slice at a time, so the fp32 transient is one layer's slice and
    not the whole stack (at phi3.5-moe's 16 layers, 1.7 GB for ``we_gate``
    instead of 26.8 GB)."""

    def draw(leaf: Leaf) -> torch.Tensor:
        if leaf.init == "dense":
            out = torch.empty(leaf.shape, dtype=leaf.dtype, device=device)
            for part in out if len(leaf.shape) >= 3 else [out]:
                w = torch.randn(part.shape, generator=generator, device=device, dtype=torch.float32)
                part.copy_(w.div_(math.sqrt(leaf.scale)))
            return out
        fill = torch.ones if leaf.init == "ones" else torch.zeros
        return fill(leaf.shape, dtype=leaf.dtype, device=device)

    return _map(draw, param_spec(cfg))


def params_from_numpy(cfg: LMConfig, tree: Mapping, device: str | torch.device = "cuda") -> dict:
    """Load a parameter tree given as numpy arrays (e.g. the JAX package's
    ``init_params``, converted with ``np.asarray(a, np.float32)``), checking
    every key and shape against :func:`param_spec` and casting to its dtype."""

    def load(leaf: Leaf, a) -> torch.Tensor:
        a = np.asarray(a)
        if tuple(a.shape) != leaf.shape:
            raise ValueError(f"parameter shape {a.shape} != expected {leaf.shape}")
        return torch.tensor(a, dtype=leaf.dtype, device=device)  # a copy: never aliases the caller's array

    spec = param_spec(cfg)
    if set(_flat_keys(tree)) != set(_flat_keys(spec)):
        raise ValueError(f"parameter keys differ: {sorted(set(_flat_keys(tree)) ^ set(_flat_keys(spec)))}")
    return _map(load, spec, tree)


def _flat_keys(tree: Mapping, prefix: str = "") -> list[str]:
    out = []
    for k, v in tree.items():
        out += _flat_keys(v, f"{prefix}{k}/") if isinstance(v, Mapping) else [prefix + k]
    return out


def layer(blocks: Mapping[str, torch.Tensor], i: int) -> dict[str, torch.Tensor]:
    """The parameters of layer ``i``: views of the ``[L, ...]`` stacks."""
    return {k: v[i] for k, v in blocks.items()}


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------


def param_shardings(cfg: LMConfig, *, fsdp_axis: str | None = "data", tp_axis: str = "model") -> dict:
    """:class:`P` tree matching :func:`param_spec`'s structure (the
    reference's ``param_shardings``).

    TP shards the feature dim; FSDP shards the other matrix dim.  Vectors
    (norm scales, biases) are replicated except long ones sharded on TP.
    The embedding keeps its vocab whole and splits ``d_model`` over TP (the
    token lookup stays local); the unembedding splits ``d_model`` over FSDP
    and its vocab over TP (the chunked loss reduces over the shard)."""
    f, d = fsdp_axis, tp_axis

    def attn(qkv_bias, qk_norm):
        sp = {"wq": P(None, f, d), "wk": P(None, f, d), "wv": P(None, f, d), "wo": P(None, d, f), "ln1": P(None, None)}
        if qkv_bias:
            sp.update(bq=P(None, d), bk=P(None, d), bv=P(None, d))
        if qk_norm:
            sp.update(q_norm=P(None, None), k_norm=P(None, None))
        return sp

    def ffn():
        if cfg.is_moe:
            sp = {"router": P(None, f, None), "we_gate": P(None, None, f, d), "we_up": P(None, None, f, d),
                  "we_down": P(None, None, d, f), "ln2": P(None, None)}
            if cfg.n_shared_experts:
                sp.update(ws_gate=P(None, f, d), ws_up=P(None, f, d), ws_down=P(None, d, f))
            return sp
        if cfg.ffn_kind == "relu2":
            return {"w_in": P(None, f, d), "w_out": P(None, d, f), "ln2": P(None, None)}
        return {"w_gate": P(None, f, d), "w_up": P(None, f, d), "w_down": P(None, d, f), "ln2": P(None, None)}

    swiglu = {"w_gate": P(None, f, d), "w_up": P(None, f, d), "w_down": P(None, d, f), "ln2": P(None, None)}
    ssd = {"in_proj": P(None, f, d), "conv_w": P(None, None, d), "A_log": P(None, None), "D": P(None, None),
           "dt_bias": P(None, None), "out_proj": P(None, d, f), "ln": P(None, None), "gate_ln": P(None, d)}
    sp: dict[str, Any] = {"embed": P(None, d), "ln_f": P(None), "unembed": P(f, d)}
    if cfg.block_kind == "attn":
        sp["blocks"] = {**attn(cfg.qkv_bias, cfg.qk_norm), **ffn()}
    elif cfg.block_kind == "ssd":
        sp["blocks"] = ssd
    else:  # hybrid
        sp["blocks"] = ssd
        sp["shared"] = {**attn(False, False), **swiglu}
    if cfg.is_encdec:
        sp["enc_blocks"] = {**attn(cfg.qkv_bias, False), **swiglu}
        sp["enc_ln_f"] = P(None)
        sp["cross"] = {"wq": P(None, f, d), "wk": P(None, f, d), "wv": P(None, f, d), "wo": P(None, d, f),
                       "ln": P(None, None)}
    if cfg.n_patches:
        sp["patch_proj"] = P(f, d)
    return sp


# ---------------------------------------------------------------------------
# Activation constraints (module docstring)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DistContext:
    """The reference's ``_DIST``, carried by value: the mesh (a
    ``DeviceMesh`` or ``{axis: size}``; None: no mesh), the data axes, the
    tensor-parallel axis and whether the residual stream's sequence is split
    over it (``cfg.sp_residuals``)."""

    mesh: Any = None
    dp: tuple = ("data",)
    tp: str = "model"
    seq_shard: bool = True


def dist_context(mesh, dp_axes=("data",), tp_axis: str = "model", seq_shard: bool = True) -> DistContext:
    return DistContext(mesh, tuple(dp_axes), tp_axis, seq_shard)


def _extent(ctx: DistContext, axes) -> int:
    sizes = mesh_shape(ctx.mesh)
    return math.prod(sizes.get(a, 1) for a in axes)


def _dp_if_divisible(n: int, ctx: DistContext) -> tuple | None:
    """The data axes when their extent divides a batch of ``n``, else None."""
    return ctx.dp if n % _extent(ctx, ctx.dp) == 0 else None


def cstr_act(ctx: DistContext, shape) -> P | None:
    """The spec of a ``[batch, seq, ...]`` activation: the batch over the
    data axes and the sequence over the tensor-parallel axis, each where it
    divides (the sequence only with ``seq_shard`` and three or more dims);
    None without a mesh."""
    if ctx.mesh is None:
        return None
    dp = _dp_if_divisible(shape[0], ctx)
    if len(shape) < 2:
        return P(dp)
    seq = ctx.tp if ctx.seq_shard and len(shape) >= 3 and shape[1] % _extent(ctx, (ctx.tp,)) == 0 else None
    return P(dp, seq, *([None] * (len(shape) - 2)))


def cstr_heads(ctx: DistContext, shape, head_axis: int) -> P | None:
    """The spec of ``[batch, ..., heads, ...]``: the batch over the data
    axes, the heads over the tensor-parallel axis, each where it divides."""
    return cstr_custom(ctx, shape, batch_axis=0, tp_axis_at=head_axis)


def cstr_custom(ctx: DistContext, shape, *, batch_axis: int | None = None, tp_axis_at: int | None = None
                ) -> P | None:
    """The spec with the data axes at ``batch_axis`` and the tensor-parallel
    axis at ``tp_axis_at``, each only where the dim divides its extent."""
    if ctx.mesh is None:
        return None
    parts: list = [None] * len(shape)
    if batch_axis is not None and shape[batch_axis] % _extent(ctx, ctx.dp) == 0:
        parts[batch_axis] = ctx.dp
    if tp_axis_at is not None and shape[tp_axis_at] % _extent(ctx, (ctx.tp,)) == 0:
        parts[tp_axis_at] = ctx.tp
    return P(*parts)


# ---------------------------------------------------------------------------
# Small shared ops
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * scale).to(x.dtype)


def rotary(x: torch.Tensor, positions: torch.Tensor, base: float = 10_000.0) -> torch.Tensor:
    """Apply RoPE, half-split (not interleaved).  x: [..., seq, heads,
    head_dim]; positions: [..., seq]."""
    hd = x.shape[-1]
    half = hd // 2
    # built on x's device: a host tensor here would cost a synchronising copy per call
    freqs = torch.exp(-math.log(base) * torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., :, None].float() * freqs  # [..., seq, half]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
