"""Architecture & shape registry: ``--arch <id> --shape <cell>``.

10 assigned architectures × 4 input-shape cells = 40 dry-run cells.
``applicable()`` encodes the per-family skips mandated by the assignment
(``long_500k`` needs sub-quadratic attention; enc-dec decode runs against
its capped decoder context).  Skips are reported — never silently dropped.

The port's copy of ``repro/configs`` (importing that package imports JAX
through its ``lm_common``); the arch files are the reference's, over the
port's :class:`LMConfig`.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any

from ..models.lm_common import LMConfig

_MODULES = {
    "phi3.5-moe-42b": "phi35_moe_42b",
    "llama4-scout-17b": "llama4_scout_17b",
    "nemotron-4-340b": "nemotron4_340b",
    "qwen2-0.5b": "qwen2_0_5b",
    "qwen3-32b": "qwen3_32b",
    "granite-3-2b": "granite3_2b",
    "zamba2-2.7b": "zamba2_2_7b",
    "internvl2-76b": "internvl2_76b",
    "mamba2-130m": "mamba2_130m",
    "whisper-small": "whisper_small",
}

ARCHS = tuple(_MODULES)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    phase: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


def get_config(arch: str) -> LMConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(_MODULES)}")
    return importlib.import_module(f".{_MODULES[arch]}", __package__).CONFIG


def get_smoke(arch: str) -> LMConfig:
    return importlib.import_module(f".{_MODULES[arch]}", __package__).SMOKE


def applicable(arch: str, shape: str) -> tuple[bool, str]:
    """(runs?, reason).  Encodes the assignment's skip rules."""
    cfg = get_config(arch)
    cell = SHAPES[shape]
    if shape == "long_500k":
        if cfg.block_kind in ("ssd", "hybrid"):
            return True, "sub-quadratic (SSM state / hybrid sliding-window)"
        return False, "pure full-attention arch: 500k decode is quadratic — skipped per assignment"
    if cell.phase == "decode" and cfg.is_encdec:
        # runs, but against the whisper-capped decoder context
        return True, f"decoder self-attn context capped at {cfg.max_decoder_len} (whisper spec); cross-KV over {cfg.enc_frames} frames"
    return True, ""


def for_shape(cfg: LMConfig, shape: str) -> LMConfig:
    """Shape-conditional config tweaks (documented deviations only)."""
    if shape == "long_500k" and cfg.block_kind == "hybrid":
        # zamba2's shared attention runs a sliding window at long context
        return dataclasses.replace(cfg, sliding_window=4_096)
    return cfg


def cells(include_skips: bool = False):
    """Iterate (arch, shape, runs, reason) over all 40 cells."""
    for arch in ARCHS:
        for shape in SHAPES:
            runs, reason = applicable(arch, shape)
            if runs or include_skips:
                yield arch, shape, runs, reason
