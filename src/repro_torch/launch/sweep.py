"""The full dry-run sweep: one subprocess per cell (a fresh process and
fake group, bounded memory), resumable: a cell whose record exists is
skipped.

Port of ``repro/launch/sweep.py``, over ``python -m
repro_torch.launch.dryrun``, writing ``experiments/dryrun_torch/``::

  PYTHONPATH=src python -m repro_torch.launch.sweep --mesh single
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[3]
OUT = REPO / "experiments" / "dryrun_torch"


def commands(meshes: list[str], out: Path = OUT) -> list[tuple[str, str, str, list[str]]]:
    """(arch, shape, mesh, command line) of every cell whose record is not
    in ``out`` yet."""
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.configs import ARCHS, SHAPES

    return [(arch, shape, mk, [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
                               "--mesh", mk, "--out", str(out)])
            for mk in meshes for arch in ARCHS for shape in SHAPES
            if not (out / f"{arch}__{shape}__{mk}.json").exists()]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--timeout", type=int, default=1800)
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args()

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    todo = commands(meshes, args.out)
    failures = []
    t_all = time.time()
    for arch, shape, mk, cmd in todo:
        t0 = time.time()
        try:
            r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=args.timeout)
        except subprocess.TimeoutExpired:
            failures.append((arch, shape, mk, "timeout"))
            print(f"[TIMEOUT] {arch} {shape} {mk} after {args.timeout}s", flush=True)
            continue
        tail = (r.stdout + r.stderr).strip().splitlines()
        line = next((l for l in reversed(tail) if l.startswith("[")), "?")
        print(f"{line}   ({time.time() - t0:.0f}s)", flush=True)
        if r.returncode != 0:
            failures.append((arch, shape, mk))
            print("\n".join(tail[-12:]), flush=True)
    print(f"sweep done in {time.time() - t_all:.0f}s; {len(todo)} cells run, {len(failures)} failures: {failures}")
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
