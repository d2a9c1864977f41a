"""Count the profiler windows that keep too few of their device records.

    python3 scripts/profiler_windows.py [--windows 100] [--reps 20]

``chip_smoke._device_ms`` reads a call's device time from a profiler window
of ``reps`` calls and takes the window again when the profiler kept under
half a record a call.  This script profiles ``--windows`` such windows of
three calls at nemotron-4-340b's prefill attention shape (bf16, causal,
q [4,96,512,192], k/v [4,8,512,192]): the port's flash kernel, SDPA and a
``torch.bmm``.  For each it prints how many windows kept how many device
records in all (a full window keeps ``reps`` times the records of one
call) and the device functions seen, then the card's name and power limit.
Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402,F401  (puts the port on sys.path)

from repro_torch.kernels import flash_attention as fa  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--windows", type=int, default=100)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profiler_windows: no CUDA device visible", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((4, 96, 512, 192), generator=gen, device="cuda").bfloat16()
    k = torch.randn((4, 8, 512, 192), generator=gen, device="cuda").bfloat16()
    v = torch.randn((4, 8, 512, 192), generator=gen, device="cuda").bfloat16()
    a, b = q[0], k[0, :1].expand(96, -1, -1).transpose(1, 2)
    calls = {
        "flash_attention": lambda: fa.flash_attention(q, k, v, causal=True),
        "sdpa": lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True),
        "bmm": lambda: torch.bmm(a, b),
    }
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        totals: dict[int, int] = {}
        kinds: set[str] = set()
        for _ in range(args.windows):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(args.reps):
                    fn()
                torch.cuda.synchronize()
            kept = {e.key[:60]: e.count for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA and e.count}
            total = sum(kept.values())
            totals[total] = totals.get(total, 0) + 1
            kinds.update(kept)
        print(json.dumps({"call": name, "windows": args.windows, "reps": args.reps,
                          "windows by device records kept": dict(sorted(totals.items())),
                          "device functions": sorted(kinds)}))
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
