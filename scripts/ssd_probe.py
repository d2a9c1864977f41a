"""Time every candidate plan of the tensor-core SSD scan at the Mamba2 prefill shapes.

    python3 scripts/ssd_probe.py [--out build/ssd_probe.json]

Builds ``csrc/ssd_scan.cu``, prints each ``ssd_scan_mma_bf16_kernel``'s
``ptxas`` registers and spills (a spill is reported here, and fails
``chip_smoke.py``) and the blocks of it one SM holds, then, at the prefill
scan of mamba2-130m and of zamba2-2.7b (batch 4, prompt 512, bf16, x, B
and C strided as ``ssd_block`` passes them), runs every p tile of
``ssd_scan.mma_plans`` through ``ssd_scan.run_plan``, in the shipped build
and in builds that split each inexact product operand into fewer bf16
terms (``-DSSD_TERMS=1`` and ``2``; the shipped build has 3).  Each
candidate is held against ``ssd_scan_plain`` within ``BF16_REL_TOL`` of max
|plain|, for y and for the final state (the run fails if one disagrees),
with the share of its bf16 outputs that differ from the plain version's,
and timed by the profiler's device time over 20 calls (the host's time to
issue a call is left out).  The plan's own choice is also timed in parts:
``csrc/ssd_scan.cu`` is built four more times with ``-DSSD_PROBE=1`` (the
loads alone), ``2`` (the products alone), ``3`` (no state update) and ``4``
(no output rows), and each build runs the plan in turns (shipped, probes,
probes in reverse, shipped) by device time (``parts_ms``): what a part
costs is the whole less the build without it.  Every build is compiled at
once.  The plan's own choice is also timed through
``ssd_scan`` by CUDA events and by the host's time to issue a call, as
``chip_smoke.py`` times it.  A block that takes two heads to share C·Bᵀ is
not a candidate: at the block count a shape needs, a head pair does the
decay scaling twice where a p tile twice as wide does it once, with the
same loads.  Prints the card's name and power limit, one JSON line per
shape (plan, fastest candidate, every candidate) and writes them all to
``--out``.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (also puts the port on sys.path)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402

#: part build -> its SSD_PROBE value (None: the shipped library)
PARTS = {"shipped": None, "loads alone": 1, "products alone": 2, "no state update": 3, "no output rows": 4}
#: builds that split each inexact product operand into fewer bf16 terms than the shipped one
TERM_BUILDS = {"1 term": 1, "2 terms": 2}


def build_variants(defines: dict[str, str]) -> dict[str, ctypes.CDLL]:
    """The shipped library and a copy of ``csrc/ssd_scan.cu`` per entry of
    ``defines`` (name -> ``NAME=VALUE`` passed as ``-D``), all compiled at
    once; a copy built before from the same source is loaded as it is."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = build.library_path("ssd_scan").stem
    procs = {}
    for name, define in defines.items():
        out = build.BUILD_DIR / f"{stem}-{define.replace('=', '')}.so"
        if out.exists():
            procs[name] = (out, None)
            continue
        procs[name] = (out, subprocess.Popen(build.nvcc_command("ssd_scan", out) + [f"-D{define}"],
                                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {"shipped": build.library("ssd_scan")}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate() if proc else ("", None)
        if proc and proc.returncode:
            raise RuntimeError(f"nvcc ({name}) exited {proc.returncode}:\n{log}")
        libs[name] = ctypes.CDLL(str(out))
    return libs


def terms_of(lib: ctypes.CDLL) -> int:
    """The bf16 terms a build of ``csrc/ssd_scan.cu`` splits each inexact operand into."""
    lib.ssd_scan_mma_terms.restype = ctypes.c_int
    return lib.ssd_scan_mma_terms()


def using(lib: ctypes.CDLL):
    """Point the wrapper at ``lib`` for the duration of the context."""
    ssd._kernel.cache_clear()
    return mock.patch.object(ssd, "library", lambda: lib)


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
    ap.add_argument("--out", default="build/ssd_probe.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssd_probe: no CUDA device visible", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(f"[card] {smi.stdout.strip().splitlines()[0]}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ptxas = cs.ssd_ptxas()
    libs = build_variants({**{name: f"SSD_PROBE={v}" for name, v in PARTS.items() if v},
                           **{name: f"SSD_TERMS={v}" for name, v in TERM_BUILDS.items()}})
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for arch in cs.SSD_MODELS:
        cfg = get_config(arch)
        b, l, h, p, n, chunk = cs.LM_BATCH, cs.LM_PROMPT, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk
        x, dt, A, B, C = cs.ssd_inputs(b, l, h, p, n, torch.bfloat16, True, gen)
        want_y, want_state = ssd.ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
        chosen = ssd.plan(torch.bfloat16, b, h, p, n, chunk, ssd._aligned(x) and ssd._aligned(B) and ssd._aligned(C),
                          sms=sms)
        flops, nbytes = cs.ssd_cost(x, B, chunk)
        bound_ms, bound_by = cs._bound(flops, nbytes, cs.PEAK_BF16_FLOPS)
        rows = []
        for build_name in ("shipped", *TERM_BUILDS):
            with using(libs[build_name]):
                terms = terms_of(libs[build_name])
                for cand in ssd.mma_plans(b, h, p, n, chunk):
                    if cand.smem > ssd.MAX_SMEM_BYTES:
                        continue
                    y, state = ssd.run_plan(x, dt, A, B, C, chunk, cand)
                    torch.cuda.synchronize()
                    desc = {"model": arch, "p_tile": cand.p_tile, "terms": terms}
                    err = max(cs._agree("ssd_scan", desc, y, want_y, None),
                              cs._agree("ssd_scan (state)", desc, state, want_state, None))
                    ms = _device_ms(lambda: ssd.run_plan(x, dt, A, B, C, chunk, cand))
                    row = {"p_tile": cand.p_tile, "terms": terms, "blocks": cand.blocks, "smem": cand.smem,
                           "blocks_an_sm": ssd.occupancy(n, cand.p_tile, chunk), "ms": ms,
                           "bound_ratio": ms / bound_ms, "max_abs_err": err,
                           "y_differing_from_plain": (y != want_y).float().mean().item(),
                           "build": build_name, "chosen": cand == chosen and build_name == "shipped"}
                    if build_name == "shipped":
                        regs, spill_st, spill_ld = ptxas[n, cand.p_tile]
                        row.update(registers=regs, spill_bytes=spill_st + spill_ld)
                    rows.append(row)
        ssd._kernel.cache_clear()

        def kern():
            return ssd.ssd_scan(x, dt, A, B, C, chunk=chunk)

        parts = {name: [] for name in PARTS}  # device ms of the plan's kernel in each build, in turns
        for name in [*PARTS, *reversed(PARTS)]:
            with using(libs[name]):
                parts[name].append(_device_ms(lambda: ssd.run_plan(x, dt, A, B, C, chunk, chosen)))
        ssd._kernel.cache_clear()

        best = min((r for r in rows if r["build"] == "shipped"), key=lambda r: r["ms"])
        out = {"model": arch, "x": [b, l, h, p], "n": n, "chunk": chunk, "flops": flops, "bytes": nbytes,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "plan": {"p_tile": chosen.p_tile, "blocks": chosen.blocks,
                        "ms": next(r["ms"] for r in rows if r["chosen"]), "events_ms": cs._time_ms(kern),
                        "host_ms": cs._host_ms(kern)},
               "fastest": {k: best[k] for k in ("p_tile", "terms", "blocks", "ms")},
               "parts_ms": parts, "max_abs_y": want_y.float().abs().max().item(), "max_abs_state": want_state.abs().max().item(),
               "candidates": rows}
        results.append(out)
        print(json.dumps({k: v for k, v in out.items() if k != "candidates"}))
        for r in sorted(rows, key=lambda r: r["ms"]):
            print(f"    {json.dumps(r)}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"card": smi.stdout.strip(), "sms": sms, "shapes": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
