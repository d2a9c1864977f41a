"""Execution-Place (EP) and platform model.

The paper (Shisha, §2/§6) targets chiplet platforms built from clusters of
cores attached to memory modules of different bandwidths:

  * FEP — Fast Execution Place: high-perf cores + high-bandwidth memory.
  * SEP — Slow Execution Place: slower cores + low-bandwidth memory.

An EP is the unit Shisha maps a pipeline stage onto, modelled by its
aggregate compute rate, memory bandwidth and the link bandwidth/latency of
its connection to neighbouring EPs.  This module holds the paper's
big/LITTLE presets; the H100 preset is ``pipeline/hetero.py``.  The
scheduling algorithms only ever see ``Platform`` / ``EP`` objects.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class EP:
    """One Execution Place (paper: a chiplet = cores + attached memory)."""

    name: str
    cores: int
    #: per-core sustained compute rate, FLOP/s
    flops_per_core: float
    #: memory bandwidth of the attached module, bytes/s
    mem_bw: float
    #: link bandwidth to neighbouring EPs, bytes/s
    link_bw: float = 25e9
    #: one-way link latency to neighbouring EPs, seconds (Fig. 9 knob)
    link_latency: float = 100e-9
    #: bigger is faster; used by Algorithm 1 to rank EPs (FEP rank 1, ...)
    perf_class: int = 1

    @property
    def flops(self) -> float:
        """Aggregate compute rate of the EP, FLOP/s."""
        return self.cores * self.flops_per_core

    @property
    def is_fep(self) -> bool:
        return self.perf_class == 1


@dataclasses.dataclass(frozen=True)
class Platform:
    """A fixed set of EPs (the machine Shisha schedules onto), joined by
    scalar per-EP links."""

    name: str
    eps: tuple[EP, ...]

    def __post_init__(self):
        if not self.eps:
            raise ValueError("platform needs at least one EP")

    @property
    def n_eps(self) -> int:
        return len(self.eps)

    @property
    def feps(self) -> tuple[int, ...]:
        """Indices of fast EPs (best perf_class present on the platform)."""
        best = min(ep.perf_class for ep in self.eps)
        return tuple(i for i, ep in enumerate(self.eps) if ep.perf_class == best)

    @property
    def seps(self) -> tuple[int, ...]:
        best = min(ep.perf_class for ep in self.eps)
        return tuple(i for i, ep in enumerate(self.eps) if ep.perf_class != best)

    def ranked(self) -> list[int]:
        """EP indices sorted in descending order of performance.

        This is the paper's H_e list (§5.1): FEPs first.  Ties broken by
        aggregate FLOP rate, then memory bandwidth, then index (stable).
        """
        return sorted(
            range(self.n_eps),
            key=lambda i: (
                self.eps[i].perf_class,
                -self.eps[i].flops,
                -self.eps[i].mem_bw,
                i,
            ),
        )


    def with_latency(self, latency_s: float) -> "Platform":
        """Copy of the platform with every inter-EP link latency replaced
        (the Fig. 9 inter-chiplet latency sweep)."""
        eps = tuple(dataclasses.replace(ep, link_latency=latency_s) for ep in self.eps)
        return dataclasses.replace(self, name=f"{self.name}@lat{latency_s:g}", eps=eps)

    def without(self, dead: Sequence[int]) -> "Platform":
        """Copy of the platform with EPs ``dead`` removed (elastic rescale),
        the survivors in their order: the reference's ``without`` on its
        scalar links (no fabric, power or fault model to restrict)."""
        dead_set = set(dead)
        eps = tuple(ep for i, ep in enumerate(self.eps) if i not in dead_set)
        return dataclasses.replace(self, name=f"{self.name}-minus{sorted(dead_set)}", eps=eps)


# ---------------------------------------------------------------------------
# gem5-style presets (paper Table 1 + Table 3)
# ---------------------------------------------------------------------------

# ARM big (out-of-order, ~2 GHz, 8 FLOP/cycle fp32 NEON-ish) vs LITTLE
# (in-order, ~1.4 GHz, 4 FLOP/cycle).  Absolute values only set the time
# scale; the algorithms respond to the *ratios*, as in the paper's gem5 DB.
_BIG_FLOPS = 2.0e9 * 8
_LITTLE_FLOPS = 1.4e9 * 4

#: paper Table 1 memory bandwidths
_HBM_BW = 40e9
_DDR_BW = 20e9


def _big(name: str, cores: int, link_latency: float = 100e-9) -> EP:
    return EP(
        name=name,
        cores=cores,
        flops_per_core=_BIG_FLOPS,
        mem_bw=_HBM_BW,
        link_bw=25e9,
        link_latency=link_latency,
        perf_class=1,
    )


def _little(name: str, cores: int, link_latency: float = 100e-9) -> EP:
    return EP(
        name=name,
        cores=cores,
        flops_per_core=_LITTLE_FLOPS,
        mem_bw=_DDR_BW,
        link_bw=25e9,
        link_latency=link_latency,
        perf_class=2,
    )


def table3_platform(conf: str) -> Platform:
    """Paper Table 3 EP configurations C1..C5."""
    specs = {
        # (FEPs as list of core counts, SEPs as list of core counts)
        "C1": ([8], [8]),
        "C2": ([8, 8], [8, 8]),
        "C3": ([4, 4, 4, 4], [8, 8]),
        "C4": ([8, 8], [4, 4, 4, 4]),
        "C5": ([4, 4, 4, 4], [4, 4, 4, 4]),
    }
    if conf not in specs:
        raise KeyError(f"unknown Table-3 config {conf!r}; have {sorted(specs)}")
    fep_cores, sep_cores = specs[conf]
    eps = [_big(f"FEP{i}", c) for i, c in enumerate(fep_cores)]
    eps += [_little(f"SEP{i}", c) for i, c in enumerate(sep_cores)]
    return Platform(name=conf, eps=tuple(eps))


def paper_platform(n_eps: int = 8, fep_fraction: float = 0.5) -> Platform:
    """Generic big/LITTLE platform with ``n_eps`` EPs (Fig. 4 uses 8 EPs)."""
    n_fep = max(1, round(n_eps * fep_fraction))
    eps = [_big(f"FEP{i}", 4) for i in range(n_fep)]
    eps += [_little(f"SEP{i}", 4) for i in range(n_eps - n_fep)]
    return Platform(name=f"bigLITTLE{n_eps}", eps=tuple(eps))
