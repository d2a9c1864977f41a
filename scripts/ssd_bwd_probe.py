"""Time the SSD scan's bf16 backward kernel by kernel, the tensor-core route beside the SIMT one.

    python3 scripts/ssd_bwd_probe.py

At the training shapes of mamba2-130m (x [4,512,24,64], B and C
[4,512,128]) and zamba2-2.7b (x [4,512,80,64], B and C [4,512,64]), chunk
64, bf16, x, B and C strided as ``ssd_block`` passes them and no final
state's gradient (as training runs them), this script times
``ssd_scan_bwd`` through the port's wrapper on its tensor-core route
(``ssd_scan.bwd_route``: the states, chunk and sum kernels) and on the
SIMT route (``ssd_scan.run_bwd_route``), in the order mma, simt,
simt, mma: the whole backward's device time per call from the profiler
and each kernel's own, and the whole by CUDA events around 20 calls.

Copies of ``csrc/ssd_scan.cu`` built with ``-DSSD_BWD_PROBE=n`` take one
part out of the tensor-core route (1: every product; 2: the streamed
tiles' loads, x, dy and the B or C slices of the states kernel, x, dy, H
and dH of the chunk kernel; 3: the cross-block sum, dB's and dC's parts
not written and the sum kernel not launched; 4: the chunk kernel's d(cum),
its reverse cumulative sum, ddt and dA's parts; their outputs are wrong), and
each kernel's device time without that part says what the part costs.
Every build is compiled at once.

Prints the card's name and power limit, each backward kernel's ``ptxas``
registers, and one JSON line per shape; fails if either route disagrees
with ``ssd_scan_bwd_plain`` (``chip_smoke.BF16_REL_TOL`` of each
gradient's max) or the tensor-core route gives other bits on a second
call.  Needs one CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import re
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

#: build -> its -D flags (none: the shipped library)
BUILDS = {
    "shipped": (),
    **{name: (f"-DSSD_BWD_PROBE={n}",) for n, name in enumerate(
        ("no products", "no loads", "no cross-block sum", "no d(cum)"), start=1)},
}


def _build() -> dict[str, ctypes.CDLL]:
    """The shipped library and every probe copy, all compiled at once."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = build.library_path("ssd_scan").stem
    procs = {}
    for name, flags in BUILDS.items():
        if flags:
            out = build.BUILD_DIR / f"{stem}-{re.sub(r'[^a-z0-9]+', '-', name)}.so"
            procs[name] = (out, subprocess.Popen(build.nvcc_command("ssd_scan", out) + list(flags),
                                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {"shipped": build.library("ssd_scan")}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc ({name}) exited {proc.returncode}:\n{log}")
        libs[name] = ctypes.CDLL(str(out))
    return libs


def _using(lib: ctypes.CDLL):
    """Point the wrapper at ``lib`` for the duration of the context."""
    ssd._bwd_mma_kernel.cache_clear()
    ssd._bwd_kernel.cache_clear()
    return mock.patch.object(build, "library", lambda name: lib)


def _kernel_ms(fn) -> tuple[float, dict[str, float]]:
    """The device time per call of ``fn`` and of each SSD backward kernel it ran, by the profiler."""
    split: dict = {}
    total, _ = cs._device_ms(fn, times=split)
    return total, {m.group(1): v for k, v in split.items() if (m := cs.SSD_BWD_FN.search(k))}


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_bwd_probe: no CUDA device visible", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(f"[card] {smi.stdout.strip().splitlines()[0]}")
    libs = _build()
    for name, (regs, st, ld) in sorted(cs._ptxas_entries(
            "ssd_scan", r"(ssd_scan_bwd(?:_[a-z]+)*_kernelI(?:f|13__nv_bfloat16|Li\d+E)E)").items()):
        print(f"[ptxas] {cs._bwd_name(name)}: {regs} registers, spill stores {st} B, spill loads {ld} B")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for arch in cs.SSD_MODELS:
        cfg = get_config(arch)
        b, l, h, p, n, chunk = cs.TRAIN_BATCH, cs.TRAIN_SEQ, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk
        x, dt, A, B, C = cs.ssd_inputs(b, l, h, p, n, torch.bfloat16, True, gen)
        dy = torch.randn((b, l, h, p), generator=gen, device="cuda").to(torch.bfloat16)
        plain = ssd.ssd_scan_bwd_plain(x, dt, A, B, C, dy, chunk=chunk)
        flops, nbytes = cs.ssd_bwd_cost(x, B, chunk, False)
        bound_ms, bound_by = cs._bound(flops, nbytes, cs.PEAK_BF16_FLOPS)
        route = ssd.bwd_route(torch.bfloat16, p, n, chunk, all(ssd._aligned(t) for t in (x, B, C, dy)))
        out: dict = {"model": arch, "x": list(x.shape), "B": list(B.shape), "route": route,
                     "head_group": ssd.bwd_head_group(b, l, h), "grid": ssd.mma_bwd_grid(b, l, h, n),
                     "bound_ms": bound_ms, "bound_by": bound_by}
        runs = {"mma": lambda: ssd.run_bwd_route(x, dt, A, B, C, dy, chunk=chunk, route="mma"),
                "simt": lambda: ssd.run_bwd_route(x, dt, A, B, C, dy, chunk=chunk, route="simt")}
        with _using(libs["shipped"]):
            for name in ("mma", "simt", "simt", "mma"):
                got, again = runs[name](), runs[name]()
                torch.cuda.synchronize()
                err = max(((g.float() - w.float()).abs().max() / w.float().abs().max()).item()
                          for g, w in zip(got, plain))
                if not err <= cs.BF16_REL_TOL or not all(torch.equal(u, v) for u, v in zip(got, again)):
                    raise RuntimeError(f"{arch}: the {name} route's backward is off the plain version by {err} "
                                       f"(tolerance {cs.BF16_REL_TOL}) or differs between two calls")
                out[f"rel_err {name}"] = err
                total, split = _kernel_ms(runs[name])
                out.setdefault(f"device_ms {name}", []).append(total)
                out.setdefault(f"kernels_ms {name}", []).append(split)
                out.setdefault(f"event_ms {name}", []).append(cs._time_ms(runs[name]))
        for name, flags in BUILDS.items():
            if flags:
                with _using(libs[name]):
                    out[f"kernels_ms {name}"] = _kernel_ms(runs["mma"])[1]
        ssd._bwd_mma_kernel.cache_clear()
        ssd._bwd_kernel.cache_clear()
        print(json.dumps(out))
        del x, dt, A, B, C, dy, plain
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
