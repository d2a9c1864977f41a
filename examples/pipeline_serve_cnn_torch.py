"""End-to-end example of the PyTorch port: online-scheduled CNN inference.

    PYTHONPATH=src python examples/pipeline_serve_cnn_torch.py            # full width, on the card
    PYTHONPATH=src python examples/pipeline_serve_cnn_torch.py --device cpu --scale 0.12 --in-shape 8 8 8

1. Builds a runnable SynthNet and MEASURES each layer on the device (the
   live `execute()` oracle).
2. Runs Shisha (Algorithm 1 seed + Algorithm 2 tuning, H3) against the
   measured times on a 4-EP platform of streams (EP derates emulate
   FEP/SEP chiplets).
3. Runs the chosen split as a GPipe pipeline of microbatches, one CUDA
   stream per stage.
4. Makes stage 1's EP 4x slower and lets the runtime rebalance with the
   same online tuner.
"""

from __future__ import annotations

import argparse

from repro_torch.launch.serve_cnn import serve_cnn


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Shisha CNN pipeline loop on the PyTorch port")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=float, default=1.0, help="channel scale of SynthNet (1.0 = full width)")
    ap.add_argument("--in-shape", type=int, nargs=3, default=(220, 220, 3), metavar=("H", "W", "C"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    res = serve_cnn(device=args.device, scale=args.scale, in_shape=tuple(args.in_shape), seed=args.seed)
    print("\n".join(res.report()))


if __name__ == "__main__":
    main()
