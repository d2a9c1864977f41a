"""Perf-iteration harness: profile one dry-run cell under config overrides.

Port of ``repro/launch/hillclimb.py``.  Each iteration is: hypothesis ->
override -> re-run the cell's dry run -> compare.  Overrides are
``LMConfig`` fields (``attn_q_block``, ``remat``, ``loss_chunk``, dtypes as
``bf16`` / ``f32``) plus the accumulation depth; the three roofline terms
print beside the recorded baseline (``experiments/dryrun_torch/``).  The
port's dry run counts every layer, so the reference's depth fit is not
needed::

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --arch qwen3-32b --shape train_4k \\
      --set remat=none --accum 8 --tag noremat
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from ..configs import for_shape, get_config
from .dryrun import OUT_DIR, run_cell

PERF_DIR = OUT_DIR.parent / "perf_torch"


def parse_overrides(pairs: list[str]) -> dict:
    out = {}
    for p in pairs:
        k, v = p.split("=", 1)
        if v in ("True", "False"):
            out[k] = v == "True"
        elif v in ("bf16", "f32"):
            out[k] = torch.bfloat16 if v == "bf16" else torch.float32
        else:
            try:
                out[k] = int(v)
            except ValueError:
                out[k] = v
    return out


def measure(arch: str, shape: str, overrides: dict, accum: int | None = None) -> dict:
    """The cell's dry-run profile under ``overrides`` and ``accum``."""
    cfg = for_shape(get_config(arch), shape)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    t0 = time.time()
    rec = run_cell(arch, shape, "single", out_dir=None, cfg=cfg, accum=accum)
    r = rec["roofline"]
    return {
        "arch": arch,
        "shape": shape,
        "overrides": {k: str(v) for k, v in overrides.items()},
        "accum": rec["accum"],
        "compute_s": r["compute_s"],
        "memory_s": r["memory_s"],
        "collective_s": r["collective_s"],
        "mem_gib": rec["memory"]["peak_estimate_gib"],
        "useful_ratio": r["useful_flops_ratio"],
        "wall_s": round(time.time() - t0, 1),
        "by_op_1iter": rec["collectives"]["by_op_single_iteration"],
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--set", nargs="*", default=[], dest="overrides")
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--tag", default="iter")
    args = ap.parse_args()

    rec = measure(args.arch, args.shape, parse_overrides(args.overrides), args.accum)

    base_p = OUT_DIR / f"{args.arch}__{args.shape}__single.json"
    if base_p.exists():
        base = json.loads(base_p.read_text())
        if "roofline" in base:
            b = base["roofline"]
            print(f"baseline : compute={b['compute_s']:.3e} memory={b['memory_s']:.3e} "
                  f"collective={b['collective_s']:.3e} mem={base['memory']['peak_estimate_gib']}GiB "
                  f"useful={b['useful_flops_ratio']:.3f}")
    print(f"this run : compute={rec['compute_s']:.3e} memory={rec['memory_s']:.3e} "
          f"collective={rec['collective_s']:.3e} mem={rec['mem_gib']}GiB "
          f"useful={rec['useful_ratio']:.3f}  ({rec['wall_s']}s)", flush=True)
    PERF_DIR.mkdir(parents=True, exist_ok=True)
    out = PERF_DIR / f"{args.arch}__{args.shape}__{args.tag}.json"
    out.write_text(json.dumps(rec, indent=2))
    print(f"saved {out}")


if __name__ == "__main__":
    main()
