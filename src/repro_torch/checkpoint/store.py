"""Checkpoint store: atomic, async, step-addressed, tree-faithful.

Port of ``repro/checkpoint/store.py`` over nested dicts of tensors, with
the reference's layout, so that each package restores the other's
checkpoints::

    <dir>/step_<N>/arrays.npz + tree.json + _DONE

``arrays.npz`` holds the leaves as ``a0, a1, ...`` in ``jax.tree.flatten``'s
order (dict keys sorted, recursively), bf16 leaves as fp32 (as the
reference saves them: numpy has no bf16); ``tree.json`` holds ``n``, the
leaf count, which is all a restore reads, and the key paths.  Writes go to a
temporary directory renamed into place (atomic on POSIX), optionally on a
background thread; the leaves are copied to the host before ``save``
returns, so the caller may update its tensors in place at once.  A write
with no ``_DONE`` marker (torn by a crash) is skipped; ``keep`` bounds the
steps kept.

Over a mesh of ranks the on-disk layout stays whole: ``save(...,
shardings=)`` gathers each leaf whole from the ranks' blocks and the
mesh's first rank writes it (every rank of the mesh calls it, and a
synchronous save returns once it is on disk), and ``restore(..., shardings=)`` loads
each leaf whole and keeps the rank's block, as the reference's
``device_put(arr, sharding)`` does.  ``shardings`` is the pair ``(mesh,
specs)``: a ``DeviceMesh`` (or, to restore, a shape-only mapping with the
rank's ``coord``) and a tree of ``sharding.P`` like ``state``'s.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

from ..collectives import all_reduce_over, gather_whole
from ..sharding import local_shard
from ..tree import leaves, named_leaves


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy that shares no memory with ``t`` (a CPU tensor's
    ``numpy()`` would alias it, and the caller may update it in place)."""
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).to("cpu", copy=True).numpy()


@dataclasses.dataclass
class CheckpointStore:
    directory: Path
    keep: int = 3

    def __post_init__(self):
        self.directory = Path(self.directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self._thread: threading.Thread | None = None

    # -- write ------------------------------------------------------------

    def save(self, step: int, state: dict, *, async_: bool = False, shardings=None) -> None:
        """Write ``state`` (a nested dict of tensors) as step ``step``; with
        ``async_`` on a background thread, one in flight at a time.  With
        ``shardings``, ``state`` holds the rank's blocks: every rank of the
        mesh calls it, the leaves are gathered whole, and rank 0 writes."""
        mesh = None
        if shardings is not None:
            mesh, specs = shardings
            whole = [gather_whole(mesh, t, s) for t, s in zip(leaves(state), leaves(specs), strict=True)]
            flat = [(k, t) for (k, _), t in zip(named_leaves(state), whole)]
        else:
            flat = named_leaves(state)
        if mesh is None or not any(mesh.get_coordinate()):  # the mesh's first rank writes
            paths, arrays = [p for p, _ in flat], [_to_numpy(t) for _, t in flat]  # on the host before returning
            if async_:
                self.wait()
                self._thread = threading.Thread(target=self._write, args=(step, arrays, paths), daemon=True)
                self._thread.start()
            else:
                self._write(step, arrays, paths)
        if mesh is not None and not async_:  # on disk when any rank returns
            all_reduce_over(torch.zeros(1, device=whole[0].device), mesh, mesh.mesh_dim_names)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, leaves: list[np.ndarray], paths: list[str]) -> None:
        final = self.directory / f"step_{step:08d}"
        tmp = self.directory / f".tmp_step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz", **{f"a{i}": a for i, a in enumerate(leaves)})
        (tmp / "tree.json").write_text(json.dumps({"treedef": "nested dict, keys sorted", "n": len(leaves),
                                                   "paths": paths}))
        (tmp / "_DONE").touch()
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        self._gc()

    def _gc(self) -> None:
        for s in self.steps()[: -self.keep]:
            shutil.rmtree(self.directory / f"step_{s:08d}", ignore_errors=True)

    # -- read -------------------------------------------------------------

    def steps(self) -> list[int]:
        """Complete steps on disk, in order."""
        return [int(p.name.split("_")[1]) for p in sorted(self.directory.glob("step_*")) if (p / "_DONE").exists()]

    def restore(self, step: int, like: dict, shardings=None, coord=None) -> dict:
        """Step ``step`` in the structure of ``like``: each leaf checked
        against its shape and given its dtype and device.  With
        ``shardings = (mesh, specs)``, each leaf is loaded whole and the
        rank keeps its block (the one at ``coord`` on a shape-only mesh),
        which ``like``'s leaf is shaped as."""
        path = self.directory / f"step_{step:08d}"
        flat = named_leaves(like)
        n = json.loads((path / "tree.json").read_text())["n"]
        if n != len(flat):
            raise ValueError(f"checkpoint has {n} leaves, expected {len(flat)}")
        mesh, specs = (None, [None] * n) if shardings is None else (shardings[0], leaves(shardings[1]))
        out: dict = {}
        with np.load(path / "arrays.npz") as data:
            for i, ((key, ref), spec) in enumerate(zip(flat, specs, strict=True)):
                arr = data[f"a{i}"]
                if spec is not None:
                    arr = local_shard(mesh, torch.as_tensor(arr), spec, coord).numpy()
                if tuple(arr.shape) != tuple(ref.shape):
                    raise ValueError(f"leaf {i} ({key}): shape {arr.shape} != {tuple(ref.shape)}")
                node = out
                *parents, name = key.split("/")
                for part in parents:
                    node = node.setdefault(part, {})
                node[name] = torch.as_tensor(arr).to(device=ref.device, dtype=ref.dtype)
        return out

    def restore_latest(self, like: dict, shardings=None, coord=None) -> tuple[int, dict] | None:
        steps = self.steps()
        if not steps:
            return None
        return steps[-1], self.restore(steps[-1], like, shardings, coord)
