"""How far an SSD model's training loss and each leaf's gradient move, kernel path against plain path, beside two faults in the scan's backward.

    python3 scripts/ssd_train_sensitivity.py [--arch mamba2-130m zamba2-2.7b] [--seeds 0 1] [--model bf16 mixed] [--depth N] [--hold-depth N ...]

For each model at ``chip_smoke.py``'s trained depth (TRAIN_MODELS; ``--depth``
overrides it, whole groups of 6 layers for zamba2-2.7b) and full width, and
each seed: ``launch.train.train`` on the card for TRAIN_STEPS steps (bf16,
batch TRAIN_BATCH of TRAIN_SEQ tokens, weights and data from the seed),
then ``chip_smoke.ssd_train_readings`` on the next batch, for each
``--model``: ``bf16`` (the trained weights as they are) and ``mixed`` (the
model in fp32, weights and activations, each scan's x, B and C rounded to
bf16 on the way in and its bf16 output widened on the way out, in every
path, as ``chip_smoke.hold_bf16_scans`` holds serving), at each
``--hold-depth`` (the trained weights' first N layers; 0: all; default
``chip_smoke.SSD_HOLD_DEPTH``).  Each reading is the loss's
relative difference and each leaf's max |difference| over its max |plain|
gradient, for the kernel path and for the plain path with each of
``chip_smoke.SSD_TRAIN_CONTROLS`` in place of the scan (the carried
state's gradient dropped across chunks; ddt without its decay term), all
against the plain path.  ``chip_smoke.py``'s SSD_TRAIN_LOSS_TOL,
SSD_TRAIN_GRAD_TOL and SSD_HOLD_DEPTH, and its choice of the model in
fp32 with bf16 scans, are set from these readings.
Prints the card's name and power limit and one JSON line per (model,
seed, --model, --hold-depth).  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (also puts the port on sys.path)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, make_batch_iterator  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=list(cs.SSD_MODELS))
    ap.add_argument("--seeds", nargs="+", type=int, default=[0, 1])
    ap.add_argument("--model", nargs="+", choices=["bf16", "mixed"], default=["bf16", "mixed"])
    ap.add_argument("--depth", type=int, default=None)
    ap.add_argument("--hold-depth", nargs="+", type=int, default=None,
                    help="read at the trained weights' first N layers (0: all; default chip_smoke.SSD_HOLD_DEPTH)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssd_train_sensitivity: no CUDA device visible", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(f"[card] {smi.stdout.strip().splitlines()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all(["ssd_scan", "flash_attention"])
    for arch in args.arch:
        full = get_config(arch)
        depth = args.depth or cs.TRAIN_MODELS[arch][0]
        cfg = dataclasses.replace(full, n_layers=depth) if depth else full
        for seed in args.seeds:
            res = train(cfg, steps=cs.TRAIN_STEPS, batch=cs.TRAIN_BATCH, seq=cs.TRAIN_SEQ, log_every=0, seed=seed,
                        device="cuda")
            params = res["state"]["params"]
            del res
            torch.cuda.empty_cache()
            data = DataConfig(batch=cs.TRAIN_BATCH, seq=cs.TRAIN_SEQ, vocab=cfg.vocab, seed=seed)
            batch = next(make_batch_iterator(cfg, data, start_step=cs.TRAIN_STEPS, device="cuda"))
            for model in args.model:
                for hold in args.hold_depth or [cs.SSD_HOLD_DEPTH[arch]]:
                    name, readings = cs.ssd_train_readings(cfg, params, batch, model, hold or None)
                    torch.cuda.empty_cache()
                    out = {"model": arch, "layers": cfg.n_layers, "seed": seed, "held": name}
                    for path, r in readings.items():
                        worst = max(r["leaves"], key=r["leaves"].get)
                        out[path] = {"loss": r["loss"], "worst_leaf": worst, "worst": r["leaves"][worst],
                                     "leaves": r["leaves"]}
                    print(json.dumps(out), flush=True)
            del params, batch
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
