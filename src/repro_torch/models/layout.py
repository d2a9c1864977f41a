"""The sharded layout of the mesh paths: which block of each leaf a rank
stores, and what it gathers before a layer reads it.

Over a mesh of ranks (``launch.mesh.make_test_mesh``, ``make_production_mesh``)
every rank stores only its block of each parameter under the reference's
sanitized ``param_shardings`` (:func:`param_layout`), of the AdamW state
(the same specs) and of the decode cache (:func:`cache_pspecs`).  A layer
gathers the leaves it reads (``collectives.gather_param``) and frees them
after it:

* over the data axis always (FSDP); the backward re-gathers (under remat)
  and reduce-scatters the gradient back to the block;
* over ``model`` only where the compute does not run on the block: the
  reference's tensor parallelism keeps attention's ``wq``/``wk``/``wv``
  columns and ``wo`` rows of the rank's heads (:meth:`Layout.attention`;
  where the rank's query heads share one KV head that the stored split cuts
  mid-head, ``wk``/``wv`` are gathered whole and narrowed to it), the dense
  and MoE FFNs' ``d_ff`` block (:meth:`Layout.ffn`), the embedding's
  ``d_model`` block (its lookup gathered after) and the unembedding's vocab
  block (a sharded log-sum-exp in the loss, the logits gathered in
  serving), and an SSD layer's heads (:meth:`Layout.ssd`, the reference's
  ``cstr_heads`` on the scan's x): the rank's rows of ``out_proj`` and its
  block of ``gate_ln`` as stored, while ``in_proj``, ``conv_w`` and the
  head vectors, whose stored split does not follow the heads, are gathered
  whole and narrowed to the rank's columns.  Everything else (norms, the
  router, ``patch_proj``, an SSD layer whose heads ``model`` does not
  divide) is gathered whole, and that compute runs the same on every
  ``model`` rank.  Decode keeps the head split: the token's q, k and v are
  gathered over ``model`` and every head scores the rank's slots of the
  ring (``blocks.attention_decode``); an SSD layer split over its heads
  updates the rank's block of the SSM state.

The gradient of a gathered leaf is summed over the batch axes, and over
``model`` where the ranks used different parts of it (``"split"``: the
query and key norms under tensor parallelism, a KV head shared by ranks,
the SSD projection's and conv's columns, whose B and C every rank reads
for its own heads), not where they all computed the same thing
(``"rep"``).

The sequence plan (the reference's ``sp_residuals``, on by default).
:meth:`Layout.stream` decides per stack of layers, by
``lm_common.cstr_act``'s rule, whether the residual stream is split: with
``cfg.sp_residuals``, a ``model`` axis of more than one rank and a length it
divides, every rank of ``model`` holds its block of the sequence, ``[b,
s / tp, d]``, between sublayers, so ``_remat`` saves only the block
(Megatron-style sequence parallelism).  :meth:`Layout.enter` splits the
embedded sequence (``collectives.split_act``: the embedding, the patch
prefix and the frames are computed whole, and their gradient is gathered
whole in the backward), and :meth:`Layout.leave` gathers the normed stream
for the loss or the encoder's output (``gather_act``).  Each sublayer takes
its block (``blocks``' ``seq`` argument) and runs its pre-norm on it, then

* a tensor-parallel sublayer (attention on the rank's heads, a dense FFN
  on its ``d_ff`` block, an SSD layer on its heads) gathers the sequence
  over ``model`` (``collectives.sp_gather``, where there is no split
  ``enter_tp``) and reduce-scatters its partial output back to the block
  (``sp_scatter``, where there is no split ``sum_tp``);
* a sublayer every rank computes whole (attention or an SSD layer whose
  heads ``model`` does not divide, the FFN of an unsplit ``d_ff``, the MoE
  router) gathers the sequence with ``gather_act`` and keeps its block of
  the output with ``split_act``, whose backward gathers the gradient whole:
  that compute's gradient is the same on every rank, as without the split,
  and its leaves stay ``"rep"``;
* the MoE FFN gathers the sequence with ``gather_act`` and routes the data
  shard's whole sequence, as the reference's ``moe_capacity`` counts it;
  its experts on the rank's ``d_ff`` block take the tokens through
  ``enter_tp`` and their partial output is reduce-scattered to the block
  (``sp_scatter``), or, with the experts whole, kept by ``split_act``.

A pre-norm on the block sees only the rank's positions, so under the split
every norm scale a stream's block passes through (``ln``, ``ln1``, ``ln2``,
``ln_f``, ``enc_ln_f``: :data:`Layout.NORMS`) is ``"split"``, its gradient
summed over ``model``.  With the sequence whole (``sp_residuals=False``, a
length ``model`` does not divide, one-token decode) every rank holds the
whole sequence: ``enter_tp`` / ``sum_tp`` around the tensor-parallel
products, the norms ``"rep"``.

Without a mesh (``Layout(cfg, None)``) every method hands the parameters
through untouched, so the paths without a mesh are the paths with one.
"""

from __future__ import annotations

import copy
import dataclasses
from types import SimpleNamespace

import torch

from ..collectives import gather_act, gather_heads, gather_param, split_act
from ..sharding import P, dp_axes_of, mesh_shape, sanitize
from .lm_common import LMConfig, cstr_act, cstr_heads, dist_context, param_shardings, param_spec


def _has(el, axis: str) -> bool:
    return el == axis or (isinstance(el, tuple) and axis in el)


def param_layout(cfg: LMConfig, mesh) -> dict:
    """The sanitized parameter specs of ``cfg`` over ``mesh`` (the layout the
    ranks store: the reference's ``params_pspecs``, ``param_shardings`` over
    ``("data", "model")``, with every axis a dim does not divide dropped)."""
    return sanitize(mesh, param_spec(cfg), param_shardings(cfg, fsdp_axis="data", tp_axis="model"))


def _divisible_axis(tp: int, *cands: tuple[int, int]) -> int | None:
    """First candidate (axis, size) whose size divides evenly over tp."""
    for axis, size in cands:
        if size % tp == 0:
            return axis
    return None


def cache_pspecs(cfg: LMConfig, mesh, cache: dict) -> dict:
    """Decode-cache shardings (the reference's ``launch/shardings.py``).

    KV rings [L, b, W, kvh, hd]: batch over DP, the ring's sequence axis
    over ``model`` when it divides (the flash-decode layout: each model
    shard scores its slice of the context and only O(b·h) softmax
    statistics cross the wire), else kv-heads, else head_dim, else
    replicated.  SSM state [L, b, h, p, n]: the first of (h, p, n) that
    divides; conv state [L, b, 3, ch]: ch when it divides."""
    dp = dp_axes_of(mesh)
    tp = mesh_shape(mesh)["model"]
    spec: dict = {}
    for name, v in cache.items():
        if name == "index":
            spec[name] = P()
        elif name in ("pos", "shared_pos"):
            spec[name] = P(None, None)
        elif name in ("k", "v", "shared_k", "shared_v", "cross_k", "cross_v"):
            ax = 2 if v.shape[2] % tp == 0 else _divisible_axis(tp, (3, v.shape[3]), (4, v.shape[4]))
            parts = [None, dp, None, None, None]
            if ax is not None:
                parts[ax] = "model"
            spec[name] = P(*parts)
        elif name == "ssm":  # [L, b, h, p, n]
            ax = _divisible_axis(tp, (2, v.shape[2]), (3, v.shape[3]), (4, v.shape[4]))
            parts = [None, dp, None, None, None]
            if ax is not None:
                parts[ax] = "model"
            spec[name] = P(*parts)
        elif name == "conv":  # [L, b, 3, ch]
            ax = _divisible_axis(tp, (3, v.shape[3]))
            parts = [None, dp, None, None]
            if ax is not None:
                parts[ax] = "model"
            spec[name] = P(*parts)
        else:
            raise KeyError(name)
    return spec


class Layout:
    """How the ranks of ``mesh`` hold and read ``cfg``'s parameters (module
    docstring).  ``dp_axes`` are the axes the batch is split over (``()``:
    each rank holds the whole batch), ``tp_axis`` the tensor-parallel one."""

    #: the norm scales a pre-norm applies to the stream: ``"split"`` while it is split (module docstring)
    NORMS = frozenset({"ln", "ln1", "ln2", "ln_f", "enc_ln_f"})

    def __init__(self, cfg: LMConfig, mesh=None, dp_axes=("data",), tp_axis: str = "model"):
        self.cfg, self.mesh, self.tp_axis = cfg, mesh, tp_axis
        self.dp = tuple(dp_axes) if mesh is not None else ()
        self.dist = dist_context(mesh, self.dp, tp_axis, cfg.sp_residuals)
        #: whether the stream this layout runs is split over ``tp_axis`` (:meth:`stream`)
        self.seq = False
        if mesh is None:
            self.tp, self.rank, self.specs = 1, 0, None
            return
        sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
        self.tp = sizes.get(tp_axis, 1)
        self.rank = mesh.get_local_rank(tp_axis) if tp_axis in sizes else 0
        self.specs = param_layout(cfg, sizes)

    @property
    def tp_pair(self):
        return (self.mesh, self.tp_axis) if self.tp > 1 else None

    # -- the residual stream ----------------------------------------------

    def stream(self, x: torch.Tensor) -> "Layout":
        """This layout for a stack of layers over ``x`` [b, s, d] (the whole
        sequence): the stream split over ``tp_axis`` where
        ``lm_common.cstr_act`` splits ``x``'s sequence and ``tp_axis`` has
        more than one rank."""
        out = copy.copy(self)
        spec = cstr_act(self.dist, tuple(x.shape))
        out.seq = self.tp > 1 and spec is not None and spec[1] == self.tp_axis
        return out

    @property
    def seq_pair(self):
        """``(mesh, tp_axis)`` while the stream is split, else None."""
        return (self.mesh, self.tp_axis) if self.seq else None

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """The stream from the whole sequence ``x``: the rank's block while
        split (the gradient gathered whole in the backward)."""
        return split_act(x, self.mesh, self.tp_axis, 1) if self.seq else x

    def leave(self, x: torch.Tensor) -> torch.Tensor:
        """The whole sequence from the stream (the backward keeps the
        rank's block of a gradient every rank has whole)."""
        return gather_act(x, self.mesh, self.tp_axis, 1) if self.seq else x

    def last(self, x: torch.Tensor) -> torch.Tensor:
        """The stream's last position [b, 1, d]: from the last rank's block
        while split."""
        if not self.seq:
            return x[:, -1:]
        return gather_act(x[:, -1:], self.mesh, self.tp_axis, 1)[:, -1:]

    def _mode(self, key: str, mode: str) -> str:
        return "split" if self.seq and key in self.NORMS else mode

    def layer_specs(self, group: str) -> dict | None:
        """The specs of one layer of a ``[L, ...]`` stack group."""
        if self.mesh is None:
            return None
        return {k: P(*s[1:]) for k, s in self.specs[group].items()}

    def get(self, x: torch.Tensor, spec: P, mode: str) -> torch.Tensor:
        """``x`` (a stored block) as the compute reads it: ``"tp"`` keeps its
        ``model`` block and gathers the rest; ``"rep"`` and ``"split"``
        gather it whole, the gradient summed over ``model`` only for
        ``"split"``."""
        if self.mesh is None:
            return x
        keep = (self.tp_axis,) if mode == "tp" else ()
        sums = self.dp + ((self.tp_axis,) if mode == "split" else ())
        return gather_param(x, self.mesh, spec, keep, sums)

    def whole(self, lp: dict, specs: dict, keys=None) -> dict:
        """The leaves of ``lp`` (those in ``keys``) gathered whole."""
        if self.mesh is None:
            return lp
        return {k: self.get(v, specs[k], self._mode(k, "rep")) for k, v in lp.items() if keys is None or k in keys}

    # -- attention ----------------------------------------------------------

    def attn_plan(self, cfg: LMConfig, specs: dict) -> str | None:
        """``"heads"`` when the rank's block of ``wq``/``wo`` is whole query
        heads and of ``wk``/``wv`` whole KV heads; ``"kv_one"`` when its query
        heads share one KV head (``wk``/``wv`` gathered and narrowed to it);
        None (attention gathered whole, replicated) otherwise."""
        tp = self.tp
        heads = cstr_heads(self.dist, (1, 1, cfg.n_heads, cfg.hd), 2)
        if tp == 1 or heads[2] != self.tp_axis or not (_has(specs["wq"][-1], self.tp_axis) and
                                                       _has(specs["wo"][0], self.tp_axis)):
            return None
        hq, group = cfg.n_heads // tp, cfg.n_heads // cfg.n_kv_heads
        if cfg.n_kv_heads % tp == 0 and _has(specs["wk"][-1], self.tp_axis):
            return "heads"
        return "kv_one" if group % hq == 0 else None

    def attention(self, cfg: LMConfig, lp: dict, specs: dict, *, ln: str = "ln1"):
        """(the config of the rank's heads, the attention parameters as the
        compute reads them, the ``tp`` pair or None)."""
        if self.mesh is None:
            return cfg, lp, None
        keys = {"wq", "wk", "wv", "wo", ln, "bq", "bk", "bv", "q_norm", "k_norm"}
        plan = self.attn_plan(cfg, specs)
        if plan is None:
            return cfg, self.whole(lp, specs, keys), None
        hq, hd = cfg.n_heads // self.tp, cfg.hd
        p = {ln: self.get(lp[ln], specs[ln], self._mode(ln, "rep"))}
        for k in ("wq", "wo", "bq"):
            if k in lp:
                p[k] = self.get(lp[k], specs[k], "tp")
        for k in ("q_norm", "k_norm"):
            if k in lp:
                p[k] = self.get(lp[k], specs[k], "split")
        if plan == "heads":
            kq = cfg.n_kv_heads // self.tp
            for k in ("wk", "wv", "bk", "bv"):
                if k in lp:
                    p[k] = self.get(lp[k], specs[k], "tp")
        else:
            kq, j = 1, self.rank * hq // (cfg.n_heads // cfg.n_kv_heads)
            for k in ("wk", "wv", "bk", "bv"):
                if k in lp:
                    p[k] = self.get(lp[k], specs[k], "split").narrow(-1, j * hd, hd)
        local = dataclasses.replace(cfg, n_heads=hq, n_kv_heads=kq, head_dim=hd)
        return local, p, self.tp_pair

    def kv_heads_whole(self, cfg: LMConfig, local: LMConfig, t: torch.Tensor) -> torch.Tensor:
        """All KV heads [b, s, kvh, hd] from each rank's ``local`` ones
        (:meth:`attention`'s config), e.g. for the decode cache."""
        if local.n_kv_heads == cfg.n_kv_heads:
            return t
        return gather_heads(t, cfg.n_kv_heads, self.mesh, self.tp_axis)

    # -- SSD ------------------------------------------------------------------

    def ssd_heads(self, cfg: LMConfig, specs: dict) -> tuple[int, int] | None:
        """(the rank's first SSD head, its head count) where the layer splits
        over its heads: more than one rank, ``lm_common.cstr_heads`` puts
        ``tp_axis`` on the scan's head axis (the reference's rule, its
        ``blocks.py:394``) and the stored split keeps ``tp_axis`` on
        ``out_proj``'s rows and on ``gate_ln``; None (the layer whole on
        every rank) otherwise."""
        if self.mesh is None or self.tp == 1:
            return None
        spec = cstr_heads(self.dist, (1, 1, cfg.ssm_heads, cfg.ssm_head_dim), 2)
        if spec[2] != self.tp_axis or not (_has(specs["out_proj"][0], self.tp_axis) and
                                           _has(specs["gate_ln"][0], self.tp_axis)):
            return None
        hr = cfg.ssm_heads // self.tp
        return self.rank * hr, hr

    def ssd(self, cfg: LMConfig, lp: dict, specs: dict):
        """(the SSD parameters as the compute reads them, the ``tp`` pair or
        None, the rank's first head).  Split over the heads
        (:meth:`ssd_heads`), the rank reads ``in_proj``'s columns
        ``[z_r | x_r | B | C | dt_r]``, ``conv_w``'s channels
        ``[x_r | B | C]``, entries ``r`` of ``A_log``, ``D`` and ``dt_bias``
        (each gathered whole in mode ``"split"``: the stored blocks are
        contiguous runs of columns, not heads, and B and C's columns get a
        partial gradient from every rank), and its stored blocks of
        ``out_proj``'s rows and ``gate_ln``; otherwise every leaf whole."""
        if self.mesh is None:
            return lp, None, 0
        heads = self.ssd_heads(cfg, specs)
        if heads is None:
            return self.whole(lp, specs), None, 0
        h0, hr = heads
        di, n, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
        x0, dr = h0 * hd, hr * hd
        cols = ((x0, dr), (di + x0, dr), (2 * di, 2 * n), (2 * di + 2 * n + h0, hr))
        w, conv = (self.get(lp[k], specs[k], "split") for k in ("in_proj", "conv_w"))
        p = {"ln": self.get(lp["ln"], specs["ln"], self._mode("ln", "rep")),
             "in_proj": torch.cat([w.narrow(-1, a, k) for a, k in cols], -1),
             "conv_w": torch.cat([conv.narrow(-1, x0, dr), conv.narrow(-1, di, 2 * n)], -1)}
        for k in ("A_log", "D", "dt_bias"):
            p[k] = self.get(lp[k], specs[k], "split").narrow(-1, h0, hr)
        for k in ("out_proj", "gate_ln"):
            p[k] = self.get(lp[k], specs[k], "tp")
        return p, self.tp_pair, h0

    @staticmethod
    def ssd_cache_dims(dims: dict, tp) -> dict:
        """:meth:`cache_dims` as an SSD layer reads and writes its cache:
        split over its heads (``tp`` from :meth:`ssd`), the ``ssm`` block,
        split on h (``cache_pspecs``), is the rank's own state and is read
        and written as stored; every other split block is gathered whole."""
        return dims if tp is None else {**dims, "ssm": None}

    # -- FFN ------------------------------------------------------------------

    def ffn(self, cfg: LMConfig, lp: dict, specs: dict):
        """(the FFN parameters as the compute reads them, the ``tp`` pair or
        None): the ``d_ff`` block of the rank where the stored split keeps it
        (for MoE: the experts' and the shared experts' alike)."""
        if self.mesh is None:
            return lp, None
        if cfg.is_moe:
            cols, rows = ["we_gate", "we_up"], ["we_down"]
            if cfg.n_shared_experts:
                cols, rows = cols + ["ws_gate", "ws_up"], rows + ["ws_down"]
            rest = ("router", "ln2")
        elif cfg.ffn_kind == "relu2":
            cols, rows, rest = ["w_in"], ["w_out"], ("ln2",)
        else:
            cols, rows, rest = ["w_gate", "w_up"], ["w_down"], ("ln2",)
        tp = self.tp > 1 and all(_has(specs[k][-1], self.tp_axis) for k in cols) and \
            all(_has(specs[k][-2], self.tp_axis) for k in rows)
        p = {k: self.get(lp[k], specs[k], self._mode(k, "rep")) for k in rest}
        p.update({k: self.get(lp[k], specs[k], "tp" if tp else "rep") for k in cols + rows})
        return p, (self.tp_pair if tp else None)

    # -- embedding and head -------------------------------------------------

    def embed(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        """The token lookup: on the rank's ``d_model`` block of the table,
        the rows gathered after it, where the stored split keeps one."""
        spec = self.specs["embed"] if self.mesh is not None else None
        if spec is None or self.tp == 1 or not _has(spec[1], self.tp_axis):
            return self.get(params["embed"], spec, "rep")[tokens]
        return gather_act(self.get(params["embed"], spec, "tp")[tokens], self.mesh, self.tp_axis, tokens.dim())

    def unembed(self, params: dict):
        """(the unembedding as the compute reads it, the first vocab entry of
        the rank's block, or None when the compute has the whole vocab)."""
        spec = self.specs["unembed"] if self.mesh is not None else None
        if spec is None or self.tp == 1 or not _has(spec[1], self.tp_axis):
            return self.get(params["unembed"], spec, "rep"), None
        w = self.get(params["unembed"], spec, "tp")
        return w, self.rank * w.shape[1]

    def top(self, params: dict, key: str) -> torch.Tensor:
        """A top-level leaf (``ln_f``, ``enc_ln_f``, ``patch_proj``) whole."""
        return self.get(params[key], None if self.mesh is None else self.specs[key], self._mode(key, "rep"))

    def cache_dims(self, shapes: dict) -> dict:
        """``{name: the dim split over model}`` of cache tensors whose whole
        shapes are ``shapes`` (``{name: (shape, dtype)}``), under the
        reference's ``cache_pspecs``; a tensor kept whole is left out."""
        if self.mesh is None or self.tp == 1:
            return {}
        whole = {k: SimpleNamespace(shape=v[0]) for k, v in shapes.items()}
        specs = cache_pspecs(self.cfg, {self.tp_axis: self.tp}, whole)
        return {k: next((i for i, el in enumerate(sp) if _has(el, self.tp_axis)), None) for k, sp in specs.items()
                if any(_has(el, self.tp_axis) for el in sp)}

    def gathered_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """Logits of the rank's vocab block -> the whole vocab (serving)."""
        return gather_act(logits, self.mesh, self.tp_axis, logits.dim() - 1)

