"""How far phase 15 (b)'s granite loss on the (1, 2) mesh moves with the weights and the forward's bits.

    python3 scripts/mesh_loss_spread.py [--seeds 2 3 4 5 6] [--dtypes bf16 fp32]

``chip_smoke.py`` phase 15 (b) holds granite-3-2b's training loss
(``MESH_DEPTH`` layers, bf16, the batch of ``_mesh_train_batch``) over a
(1, 2) mesh of two gloo ranks sharing the card against one process, to
``SPLIT_LOSS_TOL``, with the weights drawn from seed 2.  This script takes
the same reading with the weights of each of ``--seeds``, for each of
``--dtypes`` (the model's type: bf16 as phase 15 runs it, or fp32, whose
forward runs the fp32 SIMT flash kernel); in bf16 once with the flash
forward on its own route (``flash_fwd_wgmma_kernel``) and once on the
``mma.sync`` route (``flash_attention.run_fwd_route``'s).  It prints one
JSON line per (type, route, seed) with each rank's loss, the one process's
and their relative difference beside the limit, in bf16 on the forward's
own route also phase 15 (b)'s loss control's (the tensor-parallel sums
dropped, ``chip_smoke._drop_tp_sums``), then the card's name and
power limit.  It checks nothing and always exits 0 once both ranks have
reported: it measures the spread.  Needs one CUDA device (the two ranks
share it).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import tempfile
from pathlib import Path
from unittest import mock

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (also puts the port on sys.path)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import blocks, transformer  # noqa: E402
from repro_torch.models.lm_common import init_params  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

RANKS, SHAPE = 2, (1, 2)


def _on_mma(q, k, v, fp32_scores=True):
    """``fa.fwd_route`` with the wgmma route sent to ``mma.sync``."""
    got = ROUTE(q, k, v, fp32_scores)
    return "mma" if got == "wgmma" else got


ROUTE = fa.fwd_route
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def rank_main(rank: int, store: str, seeds: list[int], dtypes: list[str]) -> int:
    from repro_torch.launch.mesh import batch_shard, join_group, make_test_mesh
    from repro_torch.models.layout import param_layout
    from repro_torch.sharding import local_shard

    join_group(RANKS, rank, store=torch.distributed.FileStore(store, RANKS), device="cuda", backend="gloo")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_test_mesh(SHAPE, device="cuda")
    for dtype in dtypes:
        cfg = dataclasses.replace(get_config(cs.MESH_TRAIN), n_layers=cs.MESH_DEPTH, dtype=DTYPES[dtype])
        batch = cs._mesh_train_batch(cfg)
        specs = param_layout(cfg, mesh)
        rows = batch_shard(mesh, batch)
        for route in ("wgmma", "mma") if dtype == "bf16" else ("simt",):
            with mock.patch.object(fa, "fwd_route", _on_mma if route == "mma" else ROUTE):
                for seed in seeds:
                    whole = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
                    one = transformer.value_and_grad(cfg, whole, batch)[0].item()
                    mine = local_shard(mesh, tree_map(torch.clone, whole), specs)
                    fa.launches = 0
                    meshed = transformer.value_and_grad(cfg, mine, rows, mesh, dp_axes=("data",))[0].item()
                    row = {"rank": rank, "dtype": dtype, "route": route, "seed": seed, "loss one process": one,
                           "loss mesh": meshed, "relative": abs(meshed - one) / abs(one),
                           "limit": cs.SPLIT_LOSS_TOL, "flash launches": fa.launches}
                    if dtype == "bf16" and route == "wgmma":
                        with mock.patch.object(blocks, "sum_tp", cs._drop_tp_sums), \
                                mock.patch.object(blocks, "sp_scatter", cs._drop_tp_sums):
                            dropped = transformer.value_and_grad(cfg, mine, rows, mesh, dp_axes=("data",))[0].item()
                        row["control: tensor-parallel sums dropped, relative"] = abs(dropped - one) / abs(one)
                    print(json.dumps(row), flush=True)
                    del whole, mine
                    torch.cuda.empty_cache()
    torch.distributed.destroy_process_group()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[2, 3, 4, 5, 6])
    ap.add_argument("--dtypes", nargs="+", choices=sorted(DTYPES), default=["bf16"])
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--store", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        return rank_main(args.rank, args.store, args.seeds, args.dtypes)
    if not torch.cuda.is_available():
        print("mesh_loss_spread: no CUDA device visible", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as d:
        cmd = [sys.executable, str(Path(__file__).resolve()), "--store", str(Path(d) / "store"), "--seeds",
               *map(str, args.seeds), "--dtypes", *args.dtypes]
        procs = [subprocess.Popen(cmd + ["--rank", str(r)]) for r in range(RANKS)]
        try:
            codes = [p.wait(timeout=1200) for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(f"[card] {smi.stdout.strip()}")
    return 0 if codes == [0] * RANKS else 1


if __name__ == "__main__":
    sys.exit(main())
