"""Deterministic, restart-safe synthetic data pipeline.

Port of ``repro/data/pipeline.py``.  Every batch is a pure function of
(seed, step), drawn host-side in numpy from ``default_rng(uint32([seed,
step]))`` exactly as the reference draws it, so the two packages give the
same batches bit for bit, and a job restarted from a step-N checkpoint
regenerates the batches N, N+1, ... it would have seen.  The stream is
Zipf-distributed tokens with injected copy spans, so the loss falls during
training.  Batches come out as tensors on the requested device: ``tokens``
and ``labels`` int64, enc-dec ``frames`` and patch-prefix ``patch_embeds``
fp32 (from ``[seed, step, 2]`` and ``[seed, step, 3]``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from ..models.lm_common import LMConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch: int
    seq: int
    vocab: int
    seed: int = 0
    zipf_a: float = 1.3
    copy_span: int = 8


@dataclasses.dataclass
class SyntheticLMData:
    cfg: DataConfig

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """``tokens`` and ``labels`` [batch, seq] int32 numpy arrays, the
        reference's exactly."""
        c = self.cfg
        rng = np.random.default_rng(np.uint32([c.seed, step]))
        toks = rng.zipf(c.zipf_a, size=(c.batch, c.seq + 1)).astype(np.int64)
        toks = (toks - 1) % c.vocab
        for b in range(c.batch):  # copy spans: predictable structure for the loss to latch onto
            start = rng.integers(0, max(c.seq - 2 * c.copy_span, 1))
            src = toks[b, start : start + c.copy_span]
            toks[b, start + c.copy_span : start + 2 * c.copy_span] = src
        return {"tokens": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32)}


def make_batch_iterator(
    model_cfg: LMConfig, data_cfg: DataConfig, start_step: int = 0, device: str | torch.device = "cuda"
) -> Iterator[dict[str, torch.Tensor]]:
    """Yields the batches of steps ``start_step``, ``start_step + 1``, ...
    as tensors on ``device`` (restart-safe)."""
    ds = SyntheticLMData(data_cfg)
    step = start_step
    while True:
        arrays = dict(ds.batch_at(step))
        for key, on, n, stream in (("frames", model_cfg.is_encdec, model_cfg.enc_frames, 2),
                                   ("patch_embeds", model_cfg.n_patches, model_cfg.n_patches, 3)):
            if on:
                r = np.random.default_rng(np.uint32([data_cfg.seed, step, stream]))
                arrays[key] = r.standard_normal((data_cfg.batch, n, model_cfg.d_model), dtype=np.float32)
        yield {k: torch.as_tensor(v, dtype=torch.int64 if v.dtype == np.int32 else None, device=device)
               for k, v in arrays.items()}
        step += 1
