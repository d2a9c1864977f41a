"""Heterogeneity model for the pipeline runtime.

On real chiplet hardware the FEP/SEP speed difference is physical.  One
H100 is homogeneous, so the paper's semantics are kept by attaching a
derate factor to each EP: measured per-layer times are scaled by the derate
of the EP a stage is mapped to.  The derates come from the same Platform
description the scheduler sees, so the online-tuning loop closes end to
end: measure -> scale -> Alg. 2 move -> re-measure.
"""

from __future__ import annotations

import dataclasses

from ..core.platform import EP, Platform

#: H100 SXM data sheet: fp32 outside the tensor cores, dense, at 700 W
H100_FP32_FLOPS = 67e12
#: H100 SXM data sheet: HBM3 bandwidth
H100_HBM_BW = 3.35e12
#: SMs of the H100 SXM the data-sheet rates are quoted for
H100_SMS = 132
#: emulated slow EP: the reference's SEP derate (heterogeneity, not hardware)
SEP_DERATE = 0.45
#: stage hand-off on one card is an event wait on activations that stay in
#: device memory; modelled as one HBM pass plus a launch-scale latency
HANDOFF_LATENCY = 5e-6


@dataclasses.dataclass(frozen=True)
class EPDerates:
    """Relative speed of each EP (1.0 = fastest)."""

    factors: tuple[float, ...]

    @classmethod
    def from_platform(cls, platform: Platform) -> "EPDerates":
        best = max(ep.flops for ep in platform.eps)
        return cls(tuple(best / ep.flops for ep in platform.eps))

    def scale(self, ep_idx: int, t: float) -> float:
        return t * self.factors[ep_idx]

    def compose(self, other: "EPDerates") -> "EPDerates":
        """Elementwise product of two derate vectors.

        The serving simulator uses this to merge independent derate
        sources — scripted platform faults and thermal throttling — into
        the one vector the drift detector observes.
        """
        if len(other.factors) != len(self.factors):
            raise ValueError(
                f"cannot compose derates over {len(self.factors)} and "
                f"{len(other.factors)} EPs"
            )
        return EPDerates(
            tuple(a * b for a, b in zip(self.factors, other.factors))
        )


def h100_platform_from_streams(n_stages: int, slow_fraction: float = 0.5, props=None) -> Platform:
    """A Platform whose EPs are the stages' streams on one H100.

    Counterpart of the reference's ``tpu_platform_from_mesh``.  Each EP is
    an equal share of the card's SMs at the data-sheet fp32 rate per SM, and
    an equal share of its HBM bandwidth; the first ``slow_fraction`` of the
    EPs are SEPs at :data:`SEP_DERATE`.  ``props`` is
    ``torch.cuda.get_device_properties(0)`` unless given (CPU tests pass a
    stand-in with ``multi_processor_count``, ``total_memory`` and ``name``).
    """
    if props is None:
        import torch

        props = torch.cuda.get_device_properties(0)
    sms = props.multi_processor_count // n_stages
    if sms < 1:
        raise ValueError(f"{props.multi_processor_count} SMs cannot host {n_stages} stages")
    n_slow = int(n_stages * slow_fraction)
    eps = []
    for i in range(n_stages):
        fast = i >= n_slow
        derate = 1.0 if fast else SEP_DERATE
        eps.append(
            EP(
                name=f"stream{i}",
                cores=sms,
                flops_per_core=H100_FP32_FLOPS / H100_SMS * derate,
                mem_bw=H100_HBM_BW / n_stages * derate,
                link_bw=H100_HBM_BW,
                link_latency=HANDOFF_LATENCY,
                perf_class=1 if fast else 2,
            )
        )
    # fast first, as H_e expects descending performance
    eps.sort(key=lambda e: e.perf_class)
    gib = props.total_memory / 2**30
    return Platform(name=f"{props.name}-{n_stages}x{sms}sm-{gib:.0f}GiB", eps=tuple(eps))
