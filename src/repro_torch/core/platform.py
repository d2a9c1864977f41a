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
from typing import TYPE_CHECKING, Sequence

if TYPE_CHECKING:
    from ..faults import FaultModel
    from ..interconnect import Fabric
    from ..power import PowerModel


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
    """A fixed set of EPs (the machine Shisha schedules onto).

    ``fabric`` (optional) attaches a routed, contention-priced interconnect
    (:class:`~repro_torch.interconnect.Fabric`); without one, every consumer
    falls back to the scalar per-EP ``link_bw``/``link_latency`` model, which
    a fully-connected fabric reproduces bit-for-bit.  The field is excluded
    from comparison/hash so platform equality keeps its pre-fabric meaning.

    ``power`` (optional) attaches per-EP DVFS state tables and a package
    power cap (:class:`~repro_torch.power.PowerModel`), following the same
    playbook: compare-excluded, off by default, and a degenerate model
    (single nominal level, no cap) reproduces the power-free results
    bit-for-bit.
    """

    name: str
    eps: tuple[EP, ...]
    fabric: "Fabric | None" = dataclasses.field(default=None, compare=False)
    power: "PowerModel | None" = dataclasses.field(default=None, compare=False)
    #: optional chaos spec (:class:`~repro_torch.faults.FaultModel`), same
    #: playbook: compare-excluded, off by default, and the degenerate
    #: ``no_faults`` model reproduces fault-free results bit-for-bit
    faults: "FaultModel | None" = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        if not self.eps:
            raise ValueError("platform needs at least one EP")
        if self.fabric is not None and self.fabric.n_eps != len(self.eps):
            raise ValueError(
                f"fabric binds {self.fabric.n_eps} EPs but platform has {len(self.eps)}"
            )
        if self.power is not None and self.power.n_eps != len(self.eps):
            raise ValueError(
                f"power model covers {self.power.n_eps} EPs but platform has "
                f"{len(self.eps)}"
            )

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

    def with_fabric(self, fabric: "Fabric") -> "Platform":
        """Copy of the platform with an interconnect fabric attached.

        A fabric whose ``mc_bw`` is the sentinel ``"auto"`` gets its
        memory-controller hotspot caps resolved here, from the machine the
        fabric is being attached to: each EP's node is capped at that EP's
        ``mem_bw`` (the paper's Table 1 memory-module bandwidth), so fan-in
        onto one chiplet saturates its memory controller by default on the
        gem5-style platforms.  Nodes hosting several EPs take the smallest;
        pure router nodes (no EP) stay uncapped.
        """
        if isinstance(fabric.mc_bw, str) and fabric.n_eps == len(self.eps):
            # "auto" (validated by Fabric); a binding-size mismatch falls
            # through to __post_init__'s clean error below
            caps: dict[int, float] = {}
            for i, ep in enumerate(self.eps):
                node = fabric.ep_nodes[i]
                caps[node] = min(caps.get(node, ep.mem_bw), ep.mem_bw)
            fabric = dataclasses.replace(fabric, mc_bw=caps)
        return dataclasses.replace(self, fabric=fabric)

    def with_power(self, power: "PowerModel") -> "Platform":
        """Copy of the platform with a power/thermal model attached.

        The model is shared by reference (its per-EP DVFS levels are live
        tuned state), so two platform copies made with ``dataclasses.replace``
        see the same frequencies — deliberately, like ``fabric``.
        """
        return dataclasses.replace(self, power=power)

    def with_faults(self, faults: "FaultModel") -> "Platform":
        """Copy of the platform with a chaos fault model attached.

        Nothing breaks at attach time — the spec only becomes live when a
        serving layer expands it through a
        :class:`~repro_torch.faults.FaultInjector` at prime time.  Fault
        domains are validated here, where the EP count is known.
        """
        for d in faults.domains:
            for ep in d:
                if not (0 <= ep < len(self.eps)):
                    raise ValueError(
                        f"failure domain EP {ep} outside platform with {len(self.eps)} EPs"
                    )
        return dataclasses.replace(self, faults=faults)

    def with_latency(self, latency_s: float) -> "Platform":
        """Copy of the platform with every inter-EP link latency replaced.

        The Fig. 9 inter-chiplet latency sweep.  When a fabric is attached,
        its per-link latencies are replaced too, so the knob stays
        meaningful in both the scalar and the routed path (a routed
        transfer then pays ``hops * latency_s``).
        """
        eps = tuple(dataclasses.replace(ep, link_latency=latency_s) for ep in self.eps)
        fabric = self.fabric.with_link_latency(latency_s) if self.fabric is not None else None
        return dataclasses.replace(
            self, name=f"{self.name}@lat{latency_s:g}", eps=eps, fabric=fabric
        )

    def without(self, dead: Sequence[int]) -> "Platform":
        """Copy of the platform with EPs ``dead`` removed (elastic rescale).

        An attached fabric is restricted to the survivors: the dead chiplet's
        router keeps forwarding (routes are physically unchanged), only the
        EP binding shrinks.  An attached power model is restricted the same
        way (a copy carrying the survivors' current DVFS levels).
        """
        dead_set = set(dead)
        keep = [i for i in range(len(self.eps)) if i not in dead_set]
        eps = tuple(self.eps[i] for i in keep)
        fabric = self.fabric.restrict(keep) if self.fabric is not None else None
        power = self.power.restrict(keep) if self.power is not None else None
        # the chaos spec is NOT carried over: its EP/domain indices are in
        # the original space, and a sub-platform's faults are injected by
        # whoever owns the full platform
        return dataclasses.replace(
            self,
            name=f"{self.name}-minus{sorted(dead_set)}",
            eps=eps,
            fabric=fabric,
            power=power,
            faults=None,
        )


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
