"""Time every candidate plan of the conv kernel at each SynthNet shape.

    python3 scripts/conv_probe.py [--out build/conv_probe.json]

Builds ``csrc/conv2d_im2col.cu``, prints each kernel's ``ptxas`` registers
and spills and each tile's blocks an SM, then, at every distinct layer shape
of full-width SynthNet (microbatch of 2, fp32, TF32 off), runs each tile of
``im2col_conv.TILES`` at 1, 2, 3, 4, 6, 8, 11 and 16 splits (and the plan's
own), with 16-byte copies where the shape allows them and with 4-byte copies,
through ``im2col_conv.run_plan``.  Each candidate is held against
``conv2d_im2col_plain`` at 3e-4 (the run fails if one disagrees) and timed
by the profiler's device time over 20 calls (both kernels of a split plan;
the host's time to issue a call is left out), beside cuDNN's ``F.conv2d``
with ``cudnn.benchmark`` off and on, by device time too.  The plan's own
choice is also timed through ``conv2d_im2col`` by CUDA events, as
``chip_smoke.py`` times it.  Each line gives the candidate's modelled
time (``im2col_conv.modelled_ns``) and the share of the SM's FMA peak it
reached on its busiest SM, which is what ``im2col_conv.RATE`` models.  Prints
the card's name and power limit, one JSON line per shape (plan, fastest
candidate, every candidate) and writes them all to ``--out``.  Needs one
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (also puts the port on sys.path)

from repro_torch.kernels import im2col_conv as ic  # noqa: E402
from repro_torch.launch.serve_cnn import BATCH  # noqa: E402
from repro_torch.models.cnn import synthnet_specs  # noqa: E402

SPLITS = (1, 2, 3, 4, 6, 8, 11, 16)


def _device_ms(fn) -> float:
    """``chip_smoke._device_ms``, taken again when a profiler window
    recorded no kernel of the call (raises after three empty windows)."""
    for _ in range(3):
        ms, names = cs._device_ms(fn)
        if ms > 0:
            return ms
    raise RuntimeError(f"the profiler recorded no device time in three windows: {names}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/conv_probe.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("conv_probe: no CUDA device visible", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(f"[card] {smi.stdout.strip().splitlines()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ic.library()
    for name, (regs, st, ld) in sorted(cs._ptxas_entries("conv2d_im2col", r"(conv\w+_kernel\w*)").items()):
        print(f"[build] {name}: {regs} registers, spill stores {st} B, spill loads {ld} B")
    occ = {f"{bm}x{bn} {'16-byte' if v else '4-byte'}": ic.occupancy(bm, bn, v) for bm, bn in ic.TILES
           for v in (True, False)}
    print(f"[occupancy] blocks an SM: {json.dumps(occ)}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for sh in cs._conv_shapes(synthnet_specs(), batch=BATCH):
        x, w, st = cs.conv_inputs(sh, gen)
        want = ic.conv2d_im2col_plain(x, w, stride=st)
        chosen = ic.plan(tuple(x.shape), tuple(w.shape), st, sms=sms)
        flops = 2.0 * chosen.m * chosen.k * chosen.kr
        rows = []
        for bm, bn in ic.TILES:
            for splits in sorted({*SPLITS, chosen.splits}):
                p = ic.ConvPlan(bm, bn, splits, chosen.vector, chosen.m, chosen.k, chosen.kr)
                if splits > p.slices:
                    continue
                for vec in ((True, False) if p.vector else (False,)):
                    got = ic.run_plan(x, w, st, p, vector=vec)
                    torch.cuda.synchronize()
                    if not torch.allclose(got, want, rtol=cs.KERNEL_TOL, atol=cs.KERNEL_TOL):
                        raise RuntimeError(f"{sh}: plan {p} (16-byte copies {vec}) disagrees with the plain "
                                           f"version: max abs err {(got - want).abs().max().item()}")
                    ms = _device_ms(lambda: ic.run_plan(x, w, st, p, vector=vec))
                    per_sm = -(-p.blocks // sms)
                    work = bm * bn * ic.BK * -(-p.slices // splits)
                    rows.append({
                        "tile": f"{bm}x{bn}", "splits": splits, "copies": 16 if vec else 4, "blocks": p.blocks,
                        "ms": ms, "tflops": flops / ms / 1e9,
                        "model_ms": ic.modelled_ns(p.m, p.k, p.kr, bm, bn, splits, vec, sms) / 1e6,
                        "busiest_sm_peak_share": per_sm * work / (ms * 1e6 * ic._SM_FMA_PER_NS),
                        "chosen": p == chosen,
                    })
        lib_ms, lib_best_ms = cs.cudnn_ms(x, w, st, device=True)
        events_ms = cs._time_ms(lambda: ic.conv2d_im2col(x, w, stride=st))
        best = min(rows, key=lambda r: r["ms"])
        mine = min((r for r in rows if r["chosen"]), key=lambda r: -r["copies"])
        out = {"x": list(sh["x"]), "w": list(sh["w"]), "stride": st, "layers": sh["layers"],
               "plan": {"tile": f"{chosen.bm}x{chosen.bn}", "splits": chosen.splits, "blocks": chosen.blocks,
                        "ms": mine["ms"], "events_ms": events_ms},
               "fastest": {k: best[k] for k in ("tile", "splits", "copies", "blocks", "ms")},
               "library_ms": lib_ms, "library_best_ms": lib_best_ms, "candidates": rows}
        results.append(out)
        print(json.dumps({k: v for k, v in out.items() if k != "candidates"}))
        for r in sorted(rows, key=lambda r: r["ms"])[:8]:
            print(f"    {json.dumps(r)}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"card": smi.stdout.strip(), "sms": sms, "occupancy": occ,
                                          "shapes": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
