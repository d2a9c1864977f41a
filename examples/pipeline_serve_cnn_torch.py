"""End-to-end example of the PyTorch port: online-scheduled CNN inference.

    PYTHONPATH=src python examples/pipeline_serve_cnn_torch.py            # full width, on the card
    PYTHONPATH=src python examples/pipeline_serve_cnn_torch.py --device cpu --scale 0.12 --in-shape 8 8 8
    PYTHONPATH=src python examples/pipeline_serve_cnn_torch.py --ranks 4 --device cpu --scale 0.12 --in-shape 8 8 8

1. Builds a runnable SynthNet and MEASURES each layer on the device (the
   live `execute()` oracle).
2. Runs Shisha (Algorithm 1 seed + Algorithm 2 tuning, H3) against the
   measured times on a 4-EP platform of streams (EP derates emulate
   FEP/SEP chiplets).
3. Runs the chosen split as a GPipe pipeline of microbatches, one CUDA
   stream per stage, or with `--ranks N` one stage a rank: N processes
   joined over gloo on the CPU (NCCL on N cards), rank 0 measuring and
   tuning over an N-EP platform.
4. Makes stage 1's EP 4x slower and lets the runtime rebalance with the
   same online tuner.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import tempfile

import torch.distributed as dist

from repro_torch.launch.mesh import join_group
from repro_torch.launch.serve_cnn import serve_cnn


def _rank_main(rank: int, args: argparse.Namespace, store_path: str) -> None:
    """One rank of ``--ranks``: join the group, run the loop, print rank 0's report."""
    join_group(args.ranks, rank, store=dist.FileStore(store_path, args.ranks), device=args.device,
               backend=args.backend)
    try:
        res = serve_cnn(device=args.device, scale=args.scale, in_shape=tuple(args.in_shape), seed=args.seed,
                        ranks=True)
        if rank == 0:
            print(f"[ranks] {args.ranks} processes over {dist.get_backend()}, one stage a rank")
            print("\n".join(res.report()))
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Shisha CNN pipeline loop on the PyTorch port")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=float, default=1.0, help="channel scale of SynthNet (1.0 = full width)")
    ap.add_argument("--in-shape", type=int, nargs=3, default=(220, 220, 3), metavar=("H", "W", "C"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ranks", type=int, default=0, help="run the split one stage a rank over this many processes")
    ap.add_argument("--backend", default=None, help="process group backend (default: nccl on cuda, gloo on cpu)")
    args = ap.parse_args(argv)
    if not args.ranks:
        res = serve_cnn(device=args.device, scale=args.scale, in_shape=tuple(args.in_shape), seed=args.seed)
        print("\n".join(res.report()))
        return
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=_rank_main, args=(r, args, os.path.join(d, "store"))) for r in range(args.ranks)]
        for p in procs:
            p.start()
        for p in procs:
            p.join()
    failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if failed:
        raise SystemExit(f"ranks {failed} failed")


if __name__ == "__main__":
    main()
