"""Fault tolerance and elasticity: Shisha's tuner as the runtime scheduler.

Port of ``repro/runtime/fault.py``:
- :class:`StragglerMitigator`: when a stage's EP slows down (thermals, a
  sick host, a co-tenant on the card), it watches measured stage times;
  when the max/median imbalance crosses a threshold it derates the
  offending EP in the platform model and warm-starts Algorithm 2 *from the
  current configuration* (no re-seed: the current conf is near-optimal for
  the old derates, the warm start Alg. 2 wants).
- :class:`ElasticScheduler`: when an EP disappears, it rebuilds the
  platform on the survivors, re-runs Algorithm 1's seed and tunes from
  there.
- :class:`TrainSupervisor`: a train loop with asynchronous checkpoints
  every ``save_every`` steps, NaN-loss quarantine (restore the last
  checkpoint and go on) and a bound on restores.  Unlike the reference it
  waits for a save still in flight before it restores, so the restore
  always finds the latest checkpoint.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np

from ..checkpoint import CheckpointStore
from ..core.config import PipelineConfig
from ..core.evaluator import Trace
from ..core.platform import Platform
from ..core.seed import generate_seed
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


@dataclasses.dataclass
class ElasticScheduler:
    platform: Platform
    weights: Sequence[float]
    make_trace: Callable[[Platform], Trace]
    alpha: int = 10

    def on_topology_change(self, dead_eps: Sequence[int] = (), n_stages: int | None = None):
        """Re-seed (Alg. 1) and tune (Alg. 2) on the surviving EPs."""
        if len(set(dead_eps)) >= self.platform.n_eps:
            raise RuntimeError("no EPs left")
        platform = self.platform.without(dead_eps) if dead_eps else self.platform
        trace = self.make_trace(platform)
        seed = generate_seed(self.weights, platform, n_stages=n_stages, choice="rank_w")
        result = tune(seed, trace, alpha=self.alpha)
        self.platform = platform
        return result.best_conf, result


@dataclasses.dataclass
class TrainSupervisor:
    """Checkpointed train loop with NaN quarantine and crash resume."""

    store: CheckpointStore
    save_every: int = 50
    max_restores: int = 3

    def run(
        self,
        state: dict,
        step_fn: Callable[[dict, int], tuple[dict, float]],
        n_steps: int,
        start_step: int = 0,
    ) -> tuple[dict, list[float]]:
        """Run ``step_fn(state, step) -> (state, loss)`` from ``start_step``
        to ``n_steps``; a non-finite loss restores the latest checkpoint and
        goes on from its step.  Returns the final state and the losses."""
        losses: list[float] = []
        restores = 0
        step = start_step
        while step < n_steps:
            state_new, loss = step_fn(state, step)
            if not math.isfinite(loss):
                if restores >= self.max_restores:
                    raise RuntimeError(f"NaN loss at step {step}, restores exhausted")
                self.store.wait()  # an async save still in flight is the latest checkpoint
                restored = self.store.restore_latest(state)
                if restored is None:
                    raise RuntimeError(f"NaN loss at step {step}, no checkpoint to restore")
                step, state = restored
                restores += 1
                continue
            state = state_new
            losses.append(float(loss))
            step += 1
            if step % self.save_every == 0 or step == n_steps:
                self.store.save(step, state, async_=True)
        self.store.wait()
        return state, losses
