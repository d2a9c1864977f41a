"""How far the bf16 training loss and each leaf's bf16 gradient move, kernel path against plain path, beside two attention faults.

    python3 scripts/train_grad_sensitivity.py [--arch granite-3-2b phi3.5-moe-42b] [--seeds 0 1] [--depth N]

For each model at ``chip_smoke.py``'s trained depth (TRAIN_MODELS; ``--depth``
overrides it) and full width, and each seed: ``launch.train.train`` on the
card for TRAIN_STEPS steps (bf16, batch TRAIN_BATCH of TRAIN_SEQ tokens,
weights and data from the seed), then ``chip_smoke.train_readings`` on the
next batch: the loss's relative difference and each leaf's max |difference|
over its max |plain| gradient, for the kernel path and for the plain path
with each of TRAIN_CONTROLS in place of attention (the backward without
delta; the causal mask dropped), all against the plain path.
``chip_smoke.py``'s TRAIN_LOSS_TOL and TRAIN_GRAD_TOL are set from these
readings.  Prints the card's name and power limit and one JSON line per
(model, seed).  Needs one CUDA device.
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
    ap.add_argument("--arch", nargs="+", default=list(cs.TRAIN_MODELS))
    ap.add_argument("--seeds", nargs="+", type=int, default=[0, 1])
    ap.add_argument("--depth", type=int, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_grad_sensitivity: no CUDA device visible", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(f"[card] {smi.stdout.strip().splitlines()[0]}")
    build.build_all()
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
            readings = cs.train_readings(cfg, params, batch)
            out = {"model": arch, "layers": cfg.n_layers, "seed": seed}
            for path, r in readings.items():
                out[path] = {"loss": r["loss"], "worst_leaf": max(r["leaves"].values()), "leaves": r["leaves"]}
            print(json.dumps(out))
            del params, batch
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
