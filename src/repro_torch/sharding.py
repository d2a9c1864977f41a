"""Partition specs and a rank's block of a leaf.

The arithmetic of the sharded layout, below both ``models/`` and
``launch/`` (it imports nothing of the port): :class:`P`, the counterpart
of ``jax.sharding.PartitionSpec``; :func:`sanitize`, the reference's rule
that drops an axis from a dim it does not divide; and a rank's block of a
leaf under a spec (:func:`shard_shape`, :func:`shard_slices`,
:func:`local_shard`).  Along a dim split over a tuple of axes the first
axis is outermost, as in the reference.

A ``mesh`` here is a ``torch.distributed.device_mesh.DeviceMesh`` or a
shape-only mapping such as ``{"data": 16, "model": 16}``: everything but
:func:`mesh_coord` reads only axis names and sizes, so the production
layout can be computed without 256 ranks.
"""

from __future__ import annotations

import math
from typing import Mapping

import torch


class P(tuple):
    """A partition spec: one entry per dim, each ``None`` (whole), a mesh
    axis name or a tuple of names (the first axis outermost), as
    ``jax.sharding.PartitionSpec``, which turns a one-name tuple into the
    name; ``P()`` is a leaf kept whole."""

    def __new__(cls, *parts):
        norm = tuple(p[0] if isinstance(p, (tuple, list)) and len(p) == 1 else
                     tuple(p) if isinstance(p, list) else p for p in parts)
        return super().__new__(cls, norm)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self).replace(",)", ")")


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh``, of a shape-only mapping such as
    ``{"data": 16, "model": 16}``, or of an object with a ``shape`` mapping
    (the reference's ``Mesh``)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.mesh.shape))
    return dict(mesh.shape)


def axis_size(mesh, axis: str) -> int:
    return mesh_shape(mesh)[axis]


def dp_axes_of(mesh) -> tuple[str, ...]:
    """Batch axes: everything except the TP axis."""
    return tuple(a for a in mesh_shape(mesh) if a != "model")


def mesh_coord(mesh) -> dict[str, int]:
    """This rank's index along every axis of a ``DeviceMesh``."""
    return {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names}


def axes_of(el) -> tuple[str, ...]:
    """The axes of one spec entry (``None``, a name or a tuple of names)."""
    if el is None:
        return ()
    return tuple(el) if isinstance(el, tuple) else (el,)


def spec_axes(spec: P) -> tuple[str, ...]:
    """Every mesh axis a spec splits a dim over."""
    return tuple(a for el in spec for a in axes_of(el))


def map2(fn, a, b):
    """``fn`` over the leaves of two trees of one structure (``a``'s)."""
    if isinstance(a, Mapping):
        return {k: map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def sanitize(mesh, sds_tree, spec_tree):
    """Drop mesh axes from dims they don't divide evenly (whisper's vocab
    51865, mamba2's fused in_proj 3352 fall back to replicated).
    ``sds_tree``'s leaves are anything with a ``shape``."""
    shape = mesh_shape(mesh)

    def fix(sds, spec):
        if not isinstance(spec, P):
            return spec
        parts = [el if el is None or sds.shape[i] % math.prod(shape[a] for a in axes_of(el)) == 0 else None
                 for i, el in enumerate(spec)]
        return P(*parts)

    return map2(fix, sds_tree, spec_tree)


def _block(el, shape: Mapping[str, int], coord: Mapping[str, int]) -> tuple[int, int]:
    """(block index, block count) of a dim split over ``el``'s axes, the
    first axis outermost."""
    index, count = 0, 1
    for a in axes_of(el):
        index, count = index * shape[a] + coord[a], count * shape[a]
    return index, count


def shard_shape(shape, spec: P, mesh) -> tuple[int, ...]:
    """The shape of one rank's block of a leaf of ``shape`` under ``spec``."""
    sizes = mesh_shape(mesh)
    out = list(shape)
    for i, el in enumerate(spec):
        n = math.prod(sizes[a] for a in axes_of(el))
        if out[i] % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split over {el} ({n} ranks)")
        out[i] //= n
    return tuple(out)


def shard_slices(shape, spec: P, mesh, coord: Mapping[str, int] | None = None) -> tuple[slice, ...]:
    """The index of the rank at ``coord`` (default: this rank's on a
    ``DeviceMesh``) into a leaf of ``shape``: its block of every dim."""
    sizes = mesh_shape(mesh)
    coord = mesh_coord(mesh) if coord is None else coord
    out = []
    for i, n in enumerate(shape):
        el = spec[i] if i < len(spec) else None
        index, count = _block(el, sizes, coord)
        if n % count:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split over {el} ({count} ranks)")
        out.append(slice(index * (n // count), (index + 1) * (n // count)))
    return tuple(out)


def shaped(tree):
    """Value tree -> the same tree of ``meta`` tensors (no allocation);
    leaves that are not tensors (a cache's ``index``) are kept."""
    if isinstance(tree, Mapping):
        return {k: shaped(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    return tree


def local_shard(mesh, tree, specs, coord: Mapping[str, int] | None = None):
    """This rank's block of every leaf of ``tree`` under ``specs``: a leaf
    kept whole is returned as it is, a split one as a contiguous copy of its
    block, sharing no memory with the whole leaf."""

    def cut(t, spec):
        if not isinstance(t, torch.Tensor) or not any(el is not None for el in spec):
            return t
        return t[shard_slices(t.shape, spec, mesh, coord)].clone(memory_format=torch.contiguous_format)

    return map2(cut, tree, specs)


def tree_bytes(tree) -> int:
    """Bytes of the tensors of a tree (``meta`` tensors count their shape)."""
    if isinstance(tree, Mapping):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0
