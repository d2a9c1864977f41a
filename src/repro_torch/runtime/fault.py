"""Straggler mitigation — Shisha's online tuner as the runtime rebalancer.

When a stage's EP slows down (thermals, a sick host, a co-tenant on the
card), :class:`StragglerMitigator` watches measured stage times; when the
max/median imbalance crosses a threshold it derates the offending EP in the
platform model and warm-starts Algorithm 2 *from the current configuration*
(no re-seed — the current conf is near-optimal for the old derates, the
warm start Alg. 2 wants).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from ..core.config import PipelineConfig
from ..core.evaluator import Trace
from ..core.platform import Platform
from ..core.tuner import TuneResult, tune


@dataclasses.dataclass
class StragglerMitigator:
    platform: Platform
    conf: PipelineConfig
    make_trace: Callable[[Platform], Trace]
    imbalance_threshold: float = 1.5
    alpha: int = 10

    def check(self, measured_stage_times: Sequence[float]) -> tuple[bool, int | None]:
        """(should_rebalance, straggler_stage)."""
        t = np.asarray(measured_stage_times, float)
        med = float(np.median(t))
        worst = int(np.argmax(t))
        if med <= 0:
            return False, None
        return bool(t[worst] / med > self.imbalance_threshold), worst

    def derate_factor(self, measured_stage_times: Sequence[float], stage: int) -> float:
        t = np.asarray(measured_stage_times, float)
        med = float(np.median(t))
        return float(t[stage] / max(med, 1e-12))

    def rebalance(self, measured_stage_times: Sequence[float]) -> tuple[PipelineConfig, TuneResult] | None:
        """Detect a straggler, derate its EP, warm-start Alg. 2."""
        hit, stage = self.check(measured_stage_times)
        if not hit:
            return None
        ep_idx = self.conf.eps[stage]
        factor = self.derate_factor(measured_stage_times, stage)
        eps = list(self.platform.eps)
        ep = eps[ep_idx]
        eps[ep_idx] = dataclasses.replace(
            ep,
            flops_per_core=ep.flops_per_core / factor,
            mem_bw=ep.mem_bw / factor,
            perf_class=ep.perf_class + 1,  # demote: no longer a "fast" EP
        )
        derated = dataclasses.replace(self.platform, name=f"{self.platform.name}*", eps=tuple(eps))
        trace = self.make_trace(derated)
        result = tune(self.conf, trace, alpha=self.alpha)  # warm start from current conf
        self.platform = derated
        self.conf = result.best_conf
        return result.best_conf, result
