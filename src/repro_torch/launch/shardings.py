"""Sharding assignment for params / optimizer / batch / decode caches.

Port of ``repro/launch/shardings.py``: :func:`params_pspecs`,
:func:`opt_pspecs`, :func:`batch_pspecs`, :func:`cache_pspecs` and
:func:`sanitize` give the reference's :class:`~repro_torch.sharding.P`
trees with its logic.  They read only the mesh's axis names and sizes, so a
``mesh`` is a ``DeviceMesh`` or a shape-only mapping such as ``{"data": 16,
"model": 16}`` (which lets the production layout be computed without 256
ranks).  The models read two of them, so they live below: ``sanitize`` in
:mod:`repro_torch.sharding`, ``cache_pspecs`` in ``models/layout.py``
(beside ``param_layout``, the sanitized ``params_pspecs`` the ranks store).

The reference's ``to_named`` and ``shaped`` hand specs to ``jax.jit``.  In
their place a rank's part of a leaf is computed by
:mod:`repro_torch.sharding` (``shaped``, ``shard_shape``, ``local_shard``)
and :func:`repro_torch.collectives.gather_whole`; :func:`init_shards` draws
a rank's blocks of a parameter tree without the whole tree.
"""

from __future__ import annotations

import math

import torch

from ..models.layout import cache_pspecs
from ..models.lm_common import LMConfig, P, param_shardings, param_spec
from ..sharding import dp_axes_of, map2, sanitize, shard_shape

__all__ = ["params_pspecs", "opt_pspecs", "batch_pspecs", "cache_pspecs", "sanitize", "init_shards"]


def params_pspecs(cfg: LMConfig, mesh) -> dict:
    return param_shardings(cfg, fsdp_axis="data", tp_axis="model")


def opt_pspecs(cfg: LMConfig, mesh, params_spec: dict) -> dict:
    return {"step": P(), "mu": params_spec, "nu": params_spec, "master": params_spec}


def batch_pspecs(cfg: LMConfig, mesh, batch: dict) -> dict:
    dp = dp_axes_of(mesh)
    return {k: P(dp, *([None] * (v.ndim - 1))) for k, v in batch.items()}


def init_shards(cfg: LMConfig, mesh, specs: dict, generator: torch.Generator | None, device) -> dict:
    """This rank's blocks of a parameter tree drawn on ``device`` without
    the whole tree: each dense block N(0, 1) / sqrt(fan-in) as
    ``init_params`` scales it (a stack of matrices one layer slice at a
    time), ones and zeros as the reference; on ``meta``, empty blocks.  The
    draws are the rank's own, not its block of ``init_params``."""

    def draw(leaf, spec):
        shape = shard_shape(leaf.shape, spec, mesh)
        out = torch.empty(shape, dtype=leaf.dtype, device=device)
        if out.device.type == "meta":
            return out
        if leaf.init != "dense":
            return out.fill_(1.0 if leaf.init == "ones" else 0.0)
        for part in out if len(shape) >= 3 else [out]:
            w = torch.randn(part.shape, generator=generator, device=device, dtype=torch.float32)
            part.copy_(w.div_(math.sqrt(leaf.scale)))
        return out

    return map2(draw, param_spec(cfg), specs)
