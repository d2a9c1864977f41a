"""Time the SSD scan's bf16 backward kernel by kernel: the wgmma chunk kernel's parts, beside the mma.sync one.

    python3 scripts/ssd_bwd_probe.py [--out build/ssd_bwd_probe.json] [--train-models ARCH ...]

At the training shapes of mamba2-130m (x [4,512,24,64], B and C
[4,512,128]) and zamba2-2.7b (x [4,512,80,64], B and C [4,512,64]) and at
zamba2-2.7b x train_4k's rank shape (x [16,4096,5,64]), chunk 64, bf16, x,
B and C strided as ``ssd_block`` passes them and no final state's gradient
(as training runs them), this script times ``ssd_scan_bwd`` through the
port's wrapper (``ssd_scan.run_bwd_route``) on the ``"wgmma"`` route
(``ssd_scan.bwd_route``'s), on it given the forward's states
(``ssd_scan.ssd_scan_states``' H_in: the states kernel in the gradients'
direction alone), on the ``"mma"`` route (the ``mma.sync`` chunk kernel it
replaced) and on the SIMT one, in turns (wgmma, given, mma, simt, simt,
mma, given, wgmma): the whole backward's device time per call from the
profiler and each kernel's own, and the whole by CUDA events around 20
calls.

Copies of ``csrc/ssd_scan.cu`` with one part of the wgmma chunk kernel
(``ssd_scan_bwd_chunk_kernel``) taken out are built beside the shipped
library, all at once, by editing the source text in ``build/`` (the
shipped source carries no probe switch): no products (every ``wgmma`` of
the chunk kernel dropped), no state loads (H and dH not read: zeros, no L2
prefetch), no parts written (dx, dB's and dC's parts not stored) and no
d(cum) (warp 7 skips its sums, the reverse cumulative sum, ddt and dA's
parts); their outputs are wrong.  Each probe's chunk kernel is timed in
turns with the shipped one's and the ``mma.sync`` one's (shipped, mma,
probe, probe, mma, shipped): what a part costs is the whole less the build
without it.

Then (``--train-models``, both by default) a warm training step of
mamba2-130m and of zamba2-2.7b at full size (batch 4 x 512, bf16, remat per
layer, ``transformer.make_train_step``) as the port runs it (``"wgmma"``,
each checkpointed layer's backward reading its recomputed forward's states)
and as the parent commit ran it (``"mma"``, the states rebuilt: the route
and ``ops.keeping_scan_states`` patched), in turns (new, parent, parent,
new): the step's device time by the profiler and its peak
``max_memory_allocated``.

Prints the card's name and power limit, each backward kernel's ``ptxas``
registers, spills and ``wgmma`` serialisation notes, and one JSON line per
shape; writes them to ``--out``.  Fails if a route disagrees with
``ssd_scan_bwd_plain`` (``chip_smoke.BF16_REL_TOL`` of each gradient's
max), gives other bits on a second call, or the backward given the
forward's states gives other bits than the one that rebuilds them.  Needs
one CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
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
from repro_torch.data import DataConfig, make_batch_iterator  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.lm_common import init_params  # noqa: E402
from repro_torch.optim import AdamW, AdamWConfig  # noqa: E402

#: where the edited copies of the source are built
PROBE_DIR = build.BUILD_DIR.parent / "ssd_bwd_probe"
#: the wgmma chunk kernel's text in the source: from its template line to its launcher's
KERNEL_START = "template <int N, bool TMA>\n__global__ void __launch_bounds__(BW_THREADS, 1)\nssd_scan_bwd_chunk_kernel("
KERNEL_END = "template <int N, bool TMA>\nint launch_bwd_wgmma("
#: stand-ins defined before the kernel and undone after it, for the probes that replace a call
SKIP_WGMMA = """template <int A_MN, int B_MN, int R>
__device__ __forceinline__ void probe_skip_wgmma(float (&)[R], uint64_t, uint64_t, int) {}
#define wgmma_m64n32k16_bf16 probe_skip_wgmma
#define wgmma_m64n64k16_bf16 probe_skip_wgmma
"""
NO_LOADS = """#define __ldcg(p) make_float4(0.f, 0.f, 0.f, 0.f)
#define prefetch_l2(p, n) ((void)0)
"""
#: probe -> (text put before the kernel, its undoing after it, [(old, new, occurrences)] within the kernel)
PROBES = {
    "no products": (SKIP_WGMMA, "#undef wgmma_m64n32k16_bf16\n#undef wgmma_m64n64k16_bf16\n", []),
    "no state loads": (NO_LOADS, "#undef __ldcg\n#undef prefetch_l2\n", []),
    "no parts written": ("", "", [
        ("tma_store_4d(&map_dx, ", "if (false) tma_store_4d(&map_dx, ", 2),
        ("*reinterpret_cast<float2*>(out + at + 8 * q) =", "if (false) *reinterpret_cast<float2*>(out + at + 8 * q) =",
         1)]),
    "no d(cum)": ("", "", [("if (warp == BW_CW && j > 0) dcum(j - 1);", "", 1),
                           ("if (warp == BW_CW) dcum(s.hg - 1);", "", 1)]),
}
#: shapes: name -> (model config, x's shape [b, l, h, p], state width); the training shapes and the rank one
SHAPES = {"mamba2-130m": (4, 512, 24, 64, 128), "zamba2-2.7b": (4, 512, 80, 64, 64),
          "zamba2-2.7b x train_4k rank 0 of (16, 16)": (16, 4096, 5, 64, 64)}


def _probe_source(name: str) -> Path:
    """``csrc/`` copied to ``build/ssd_bwd_probe/<name>/`` with ``ssd_scan.cu`` edited as ``PROBES[name]`` says."""
    before, after, edits = PROBES[name]
    src = (build.CSRC / "ssd_scan.cu").read_text()
    start, end = src.index(KERNEL_START), src.index(KERNEL_END)
    body = src[start:end]
    for old, new, count in edits:
        if body.count(old) != count:
            raise RuntimeError(f"probe {name!r}: {old!r} occurs {body.count(old)} times in the chunk kernel, "
                               f"want {count}: the source changed")
        body = body.replace(old, new)
    out = PROBE_DIR / re.sub(r"[^a-z0-9]+", "-", name)
    out.mkdir(parents=True, exist_ok=True)
    for header in build.CSRC.glob("*.cuh"):
        (out / header.name).write_text(header.read_text())
    (out / "ssd_scan.cu").write_text(src[:start] + before + body + after + src[end:])
    return out / "ssd_scan.cu"


def _build() -> dict[str, tuple[ctypes.CDLL, str]]:
    """The shipped library and every probe copy, all compiled at once; each with its ``ptxas -v`` log."""
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in PROBES:
        out = PROBE_DIR / f"{re.sub(r'[^a-z0-9]+', '-', name)}.so"
        cmd = [*build.nvcc_command("ssd_scan", out)[:-1], str(_probe_source(name))]
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {"shipped": (build.library("ssd_scan"), build.ptxas_report("ssd_scan"))}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc ({name}) exited {proc.returncode}:\n{log}")
        libs[name] = (ctypes.CDLL(str(out)), log)
    return libs


def _ptxas(name: str, log: str) -> None:
    """Print each backward chunk kernel's registers and spills, and the serialisation notes ptxas gave."""
    entries = cs._ptxas_entries_of(log, cs.SSD_BWD_PTXAS)
    for kernel, (regs, st, ld) in sorted(entries.items()):
        if "chunk" in kernel:
            print(f"[ptxas] {name}: {cs._bwd_name(kernel)}: {regs} registers, spill stores {st} B, spill loads {ld} B")
    notes: dict[str, int] = {}
    for line in log.splitlines():
        if (m := re.search(r"\((C75\d\d)\)", line)) and "bwd_chunk" in line:
            notes[m.group(1)] = notes.get(m.group(1), 0) + 1
    print(f"[ptxas] {name}: chunk kernels' notes {notes}")


def _using(lib: ctypes.CDLL):
    """Point the wrapper at ``lib`` for the duration of the context."""
    for fn in (ssd._bwd_mma_kernel, ssd._bwd_kernel, ssd._bwd_wgmma_kernel, ssd._kernel):
        fn.cache_clear()
    return mock.patch.object(build, "library", lambda name: lib)


def _kernel_ms(fn) -> tuple[float, dict[str, float]]:
    """The device time per call of ``fn`` and of each SSD backward kernel it ran, by the profiler."""
    split: dict = {}
    total, _ = cs._device_ms(fn, times=split)
    return total, {m.group(1): v for k, v in split.items() if (m := cs.SSD_BWD_FN.search(k))}


def _parent_path():
    """The SSD backward as the parent commit ran it: the ``"mma"`` route wherever ``"wgmma"`` is picked, and
    no layer keeping its forward's states."""
    pick = ssd.bwd_route
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(ssd, "bwd_route", lambda *a: "mma" if pick(*a) == "wgmma" else pick(*a)))
    stack.enter_context(mock.patch.object(ops, "keeping_scan_states", lambda fn: fn))
    return stack


def train_steps(arch: str) -> dict:
    """A warm training step of ``arch`` at full size on the new path and the parent's, in turns: device ms by
    the profiler (3 steps), the step's peak ``max_memory_allocated`` (GiB) and the SSD backward's launches."""
    cfg = get_config(arch)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    opt = AdamW(AdamWConfig(peak_lr=3e-4, warmup=2, total_steps=8))
    opt_state = opt.init(params)
    step_fn = transformer.make_train_step(cfg, opt)
    batch = next(make_batch_iterator(cfg, DataConfig(batch=cs.TRAIN_BATCH, seq=cs.TRAIN_SEQ, vocab=cfg.vocab, seed=0),
                                     device="cuda"))

    def step():
        return step_fn(params, opt_state, batch)  # updates params and opt_state in place

    out: dict = {"model": arch, "remat": cfg.remat, "layers": cfg.n_layers}
    for name in ("new", "parent", "parent", "new"):
        with _parent_path() if name == "parent" else contextlib.nullcontext():
            step()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = ssd.bwd_launches
            step()
            torch.cuda.synchronize()
            out.setdefault(f"peak_gib {name}", []).append(torch.cuda.max_memory_allocated() / 2**30)
            out[f"ssd_bwd_calls {name}"] = ssd.bwd_launches - before
            out.setdefault(f"device_ms {name}", []).append(cs._device_ms(step, reps=3)[0])
    del params, opt_state, batch
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(build.BUILD_DIR.parent / "ssd_bwd_probe.json"))
    ap.add_argument("--train-models", nargs="*", default=["mamba2-130m", "zamba2-2.7b"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssd_bwd_probe: no CUDA device visible", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(f"[card] {smi.stdout.strip().splitlines()[0]}")
    libs = _build()
    for name, (_, log) in libs.items():
        _ptxas(name, log)
    gen = torch.Generator(device="cuda").manual_seed(0)
    lines = []
    for shape, (b, l, h, p, n) in SHAPES.items():
        x, dt, A, B, C = cs.ssd_inputs(b, l, h, p, n, torch.bfloat16, True, gen)
        dy = torch.randn((b, l, h, p), generator=gen, device="cuda").to(torch.bfloat16)
        plain = ssd.ssd_scan_bwd_plain(x, dt, A, B, C, dy, chunk=64)
        flops, nbytes = cs.ssd_bwd_cost(x, B, 64, False)
        bound_ms, bound_by = cs._bound(flops, nbytes, cs.PEAK_BF16_FLOPS)
        out: dict = {"shape": shape, "x": list(x.shape), "B": list(B.shape),
                     "route": ssd.bwd_route(torch.bfloat16, p, n, 64, all(ssd._aligned(t) for t in (x, B, C, dy))),
                     "head_group": ssd.bwd_head_group(b, l, h), "grid": ssd.wgmma_bwd_grid(b, l, h, n),
                     "grid carried": ssd.wgmma_bwd_grid(b, l, h, n, carried=True),
                     "bound_ms": bound_ms, "bound_by": bound_by}
        with _using(libs["shipped"][0]):
            h_in = ssd.ssd_scan_states(x, dt, A, B, C, chunk=64)[2]
        runs = {"wgmma": lambda: ssd.run_bwd_route(x, dt, A, B, C, dy, chunk=64, route="wgmma"),
                "wgmma carried": lambda: ssd.run_bwd_route(x, dt, A, B, C, dy, chunk=64, route="wgmma", h_in=h_in),
                "mma": lambda: ssd.run_bwd_route(x, dt, A, B, C, dy, chunk=64, route="mma"),
                "simt": lambda: ssd.run_bwd_route(x, dt, A, B, C, dy, chunk=64, route="simt")}
        order = ["wgmma", "wgmma carried", "mma", "simt", "simt", "mma", "wgmma carried", "wgmma"]
        with _using(libs["shipped"][0]):
            got = {}
            for name in order:
                got[name], again = runs[name](), runs[name]()
                torch.cuda.synchronize()
                err = max(((g.float() - w.float()).abs().max() / w.float().abs().max()).item()
                          for g, w in zip(got[name], plain))
                if not err <= cs.BF16_REL_TOL or not all(torch.equal(u, v) for u, v in zip(got[name], again)):
                    raise RuntimeError(f"{shape}: the {name} backward is off the plain version by {err} "
                                       f"(tolerance {cs.BF16_REL_TOL}) or differs between two calls")
                out[f"rel_err {name}"] = err
                total, split = _kernel_ms(runs[name])
                out.setdefault(f"device_ms {name}", []).append(total)
                out.setdefault(f"kernels_ms {name}", []).append(split)
                out.setdefault(f"event_ms {name}", []).append(cs._time_ms(runs[name]))
            if not all(torch.equal(u, v) for u, v in zip(got["wgmma"], got["wgmma carried"])):
                raise RuntimeError(f"{shape}: the backward given the forward's states differs from the one that "
                                   f"rebuilds them")
        chunk_of = lambda split: next(v for k, v in split.items() if "chunk" in k)  # noqa: E731
        for name in [k for k in libs if k != "shipped"]:
            for lib_name, route in (("shipped", "wgmma"), ("shipped", "mma"), (name, "wgmma"), (name, "wgmma"),
                                    ("shipped", "mma"), ("shipped", "wgmma")):
                with _using(libs[lib_name][0]):
                    ms = chunk_of(_kernel_ms(runs[route])[1])
                key = f"chunk_ms {name}" if lib_name == name else f"chunk_ms {route} beside {name}"
                out.setdefault(key, []).append(ms)
        for fn in (ssd._bwd_mma_kernel, ssd._bwd_kernel, ssd._bwd_wgmma_kernel, ssd._kernel):
            fn.cache_clear()
        print(json.dumps(out))
        lines.append(out)
        del x, dt, A, B, C, dy, plain, h_in, got
        torch.cuda.empty_cache()
    for arch in args.train_models:
        out = train_steps(arch)
        print(json.dumps(out))
        lines.append(out)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(lines, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
