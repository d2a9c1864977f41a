"""Mixed-precision AdamW with a cosine schedule and global-norm clipping.

Port of ``repro/optim/adamw.py``: the same schedule, bias corrections,
clip and decoupled weight decay, all in fp32, with an fp32 master copy of
lower-precision parameters and bf16 moments by default (12 bytes of state a
bf16 parameter: the parameter, master and two moments, with its gradient).

Where it departs from the reference, to fit the card's memory: ``update``
writes the new moments, master and parameters into the given tensors in
place and returns them (the reference returns new pytrees, which would
hold the old and the new state at once), and it works through each leaf in
chunks of ``CHUNK`` elements, so its fp32 temporaries are a few chunks and
not a whole leaf (a phi3.5-moe expert stack is 420M elements a layer).  The
arithmetic of each element is the reference's.  The step count is a 0-dim
int32 tensor on the parameters' device, so that a checkpoint holds it and no
step waits on the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..collectives import all_reduce_over
from ..sharding import axis_size, spec_axes
from ..tree import leaves, tree_map

#: elements of a leaf updated at once (fp32 temporaries of 64 MB each)
CHUNK = 1 << 24


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int, floor: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    down to ``floor * peak_lr`` at ``total``; fp32."""
    step = torch.as_tensor(step).float()
    warm = peak_lr * (step + 1) / max(warmup, 1)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos).float()


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: Any = torch.bfloat16
    #: keep an fp32 master copy when params are lower precision
    master_weights: bool = True


def _chunks(t: torch.Tensor, writable: bool = True) -> list[torch.Tensor]:
    """Flat views of ``t`` of at most ``CHUNK`` elements (a copy of a
    non-contiguous tensor that is only read)."""
    if writable and not t.is_contiguous():
        raise ValueError("AdamW updates its state and parameters in place: they must be contiguous")
    return list(t.reshape(-1).split(CHUNK))


@dataclasses.dataclass(frozen=True)
class AdamW:
    cfg: AdamWConfig = AdamWConfig()

    def init(self, params: dict) -> dict:
        """``step`` (int32, 0), ``mu`` and ``nu`` (zeros in ``moment_dtype``)
        and, with ``master_weights``, ``master`` (an fp32 copy)."""
        zeros = lambda p: torch.zeros(p.shape, dtype=self.cfg.moment_dtype, device=p.device)
        device = leaves(params)[0].device
        state = {"step": torch.zeros((), dtype=torch.int32, device=device),
                 "mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}
        if self.cfg.master_weights:
            state["master"] = tree_map(lambda p: p.detach().to(torch.float32, copy=True), params)
        return state

    def update(self, grads: dict, state: dict, params: dict, *, mesh=None, specs: dict | None = None
               ) -> tuple[dict, dict, dict]:
        """One step: clip the gradients to ``clip_norm`` by their global
        norm, update the moments, and the master (or the parameters) by
        the bias-corrected Adam step plus decoupled weight decay, at the
        schedule's rate.  Updates ``state`` and ``params`` in place and
        returns them with ``{"lr", "grad_norm"}`` (the norm before
        clipping), fp32 0-dim tensors.

        Over a mesh, ``grads``, ``params`` and the state are the rank's
        blocks of leaves split as ``specs`` (a tree of partition specs like
        ``params``) says; the global norm counts each element once: each
        leaf's squares summed over the axes the leaf is split on, not over
        those it is replicated on."""
        c = self.cfg
        step = state["step"]
        lr = cosine_schedule(step, peak_lr=c.peak_lr, warmup=c.warmup, total=c.total_steps)
        g_leaves = leaves(grads)
        groups = [()] * len(g_leaves) if mesh is None else [
            tuple(a for a in spec_axes(s) if axis_size(mesh, a) > 1) for s in leaves(specs)]
        sums: dict[tuple, torch.Tensor] = {}
        for g, axes in zip(g_leaves, groups, strict=True):
            sq = sums.get(axes, torch.zeros((), dtype=torch.float32, device=step.device))
            for part in _chunks(g, writable=False):
                sq = sq + torch.sum(torch.square(part.float()))
            sums[axes] = sq
        sq = sums.pop((), torch.zeros((), dtype=torch.float32, device=step.device))
        for axes, part in sums.items():
            sq = sq + all_reduce_over(part, mesh, axes)
        gnorm = torch.sqrt(sq)
        scale = torch.clamp(c.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
        t = (step + 1).float()
        bc1 = 1.0 - torch.pow(c.b1, t)
        bc2 = 1.0 - torch.pow(c.b2, t)
        masters = state.get("master", params)
        with torch.no_grad():
            for g, mu, nu, m, p in zip(g_leaves, leaves(state["mu"]), leaves(state["nu"]), leaves(masters),
                                       leaves(params), strict=True):
                for gp, mup, nup, mp, pp in zip(_chunks(g, writable=False), _chunks(mu), _chunks(nu), _chunks(m),
                                                _chunks(p)):
                    g32 = gp.float() * scale
                    mu32 = c.b1 * mup.float() + (1 - c.b1) * g32
                    nu32 = c.b2 * nup.float() + (1 - c.b2) * g32 * g32
                    mhat = mu32 / bc1
                    vhat = nu32 / bc2
                    m32 = mp.float()
                    m32 = m32 - lr * (mhat / (torch.sqrt(vhat) + c.eps) + c.weight_decay * m32)
                    mup.copy_(mu32)
                    nup.copy_(nu32)
                    mp.copy_(m32)
                    if pp.data_ptr() != mp.data_ptr():
                        pp.copy_(m32)
            step += 1
        return params, state, {"lr": lr, "grad_norm": gnorm}
