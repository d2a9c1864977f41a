"""Time the bf16 flash backward launch by launch, the shipped route beside the parent's.

    python3 scripts/flash_bwd_probe.py

At the training shapes of granite-3-2b (q [4,32,512,64], k/v [4,8,512,64]),
phi3.5-moe (q [4,32,512,128], k/v [4,8,512,128]) and zamba2-2.7b's shared
block (q/k/v [4,32,512,80]), bf16, causal, q, k, v and dO as the model's
transposed [b, s, h, d] views, this script times ``flash_attention_bwd``
through the port's wrapper in two builds of ``csrc/flash_attention.cu``:
the shipped one (the wgmma route at D 64 and 128: dQ with delta, one
dK/dV kernel) and a copy built with ``-DFLASH_BWD_PARENT=1``, which sends
that route through the ``mma.sync`` kernels that served every bf16 shape
before it (delta, dQ, dK/dV; a dV and a dK pass at D 128).  D 80 takes the
``mma.sync`` route in both.  In the order shipped, parent, parent,
shipped: the whole backward's device time per call from the profiler and
each launch's own, and the whole by CUDA events around 20 calls.  (CUDA
events around one launch at a time would read the host's time to issue
the call, 0.06-0.10 ms, as long as the launch itself.)

Copies built with ``-DFLASH_BWD_PROBE=n`` take one part out of the wgmma
route's kernels (1: dQ's delta; 2: the products; 3: the streamed tiles'
loads; 4: the dK/dV cluster's sum; their outputs are wrong), and each
kernel's device time without that part says what the part costs: when a
kernel without its products takes about as long as whole, the products
do not bound it.  cuDNN's backward (SDPA's, as ``chip_smoke.py`` times
it) by the profiler beside them.  Every build is compiled at once.

Prints the card's name and power limit, each wgmma kernel's ``ptxas``
registers, and one JSON line per shape; fails if the shipped or the
parent build disagrees with ``flash_attention_bwd_plain``
(``chip_smoke.BF16_REL_TOL`` of each gradient's max) or gives other bits
on a second call.  Needs one CUDA device.
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
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (also puts the port on sys.path)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

MODELS = ("granite-3-2b", "phi3.5-moe-42b", "zamba2-2.7b")
#: build -> its -D flags (none: the shipped library)
BUILDS = {
    "shipped": (),
    "parent": ("-DFLASH_BWD_PARENT=1",),
    **{name: (f"-DFLASH_BWD_PROBE={n}",) for n, name in enumerate(
        ("no delta", "no products", "no loads", "no cluster sum"), start=1)},
}


def _build() -> dict[str, ctypes.CDLL]:
    """The shipped library and every probe copy, all compiled at once."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = build.library_path("flash_attention").stem
    procs = {}
    for name, flags in BUILDS.items():
        if flags:
            out = build.BUILD_DIR / f"{stem}-{re.sub(r'[^a-z0-9]+', '-', name)}.so"
            procs[name] = (out, subprocess.Popen(build.nvcc_command("flash_attention", out) + list(flags),
                                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {"shipped": build.library("flash_attention")}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc ({name}) exited {proc.returncode}:\n{log}")
        libs[name] = ctypes.CDLL(str(out))
    return libs


def _using(lib: ctypes.CDLL):
    """Point the wrapper at ``lib`` for the duration of the context."""
    fa._bwd_kernel.cache_clear()
    return mock.patch.object(build, "library", lambda name: lib)


def _kernel_ms(fn, want: tuple[str, ...], reps: int = 20) -> dict[str, float]:
    """Device time per call of each flash kernel ``fn`` runs, by the
    profiler, keyed by its name (``chip_smoke.FLASH_FN``).  A window in
    which the profiler kept under half a record a call of any kernel of
    ``want`` is taken again, up to ``chip_smoke.PROFILER_WINDOWS``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(cs.PROFILER_WINDOWS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = {m.group(1): e.self_device_time_total / e.count * round(e.count / reps) / 1e3
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and round(e.count / reps)
               and (m := cs.FLASH_FN.search(e.key))}
        if sorted(out) == sorted(want):
            return out
    raise RuntimeError(f"the profiler kept no record a call of some of {want} in {cs.PROFILER_WINDOWS} windows")


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_probe: no CUDA device visible", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(f"[card] {smi.stdout.strip().splitlines()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    libs = _build()
    for name, (regs, st, ld) in sorted(cs._ptxas_entries(
            "flash_attention", r"(flash_bwd_[a-z]+_wgmma_kernelILi\d+EE)").items()):
        print(f"[ptxas] {cs._bwd_name(name)}: {regs} registers, spill stores {st} B, spill loads {ld} B")
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, s = cs.TRAIN_BATCH, cs.TRAIN_SEQ
    for arch in MODELS:
        cfg = get_config(arch)
        h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        q, k, v, do = (torch.randn((b, s, n, d), generator=gen, device="cuda").to(torch.bfloat16).transpose(1, 2)
                       for n in (h, kvh, kvh, h))
        o, lse = fa.flash_attention(q, k, v, return_lse=True)
        plain = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
        flops = 10.0 * b * h * d * cs.visible_pairs(s, s, True, 0)
        nbytes = 2 * 4 * (q.numel() + k.numel()) + 4 * 2 * lse.numel()
        bound_ms, bound_by = cs._bound(flops, nbytes, cs.PEAK_BF16_FLOPS)
        route = fa.bwd_route(q, k, v, o, do)
        out: dict = {"model": arch, "q": list(q.shape), "k": list(k.shape), "route": route,
                     "cluster": fa.bwd_cluster(h, kvh) if route == "wgmma" else None,
                     "bound_ms": bound_ms, "bound_by": bound_by}

        def kern():
            return fa.flash_attention_bwd(q, k, v, o, lse, do)

        for name in ("shipped", "parent", "parent", "shipped"):
            with _using(libs[name]):
                got, again = kern(), kern()
                torch.cuda.synchronize()
                err = max(((g.float() - w.float()).abs().max() / w.float().abs().max()).item()
                          for g, w in zip(got, plain))
                if not err <= cs.BF16_REL_TOL or not all(torch.equal(x, y) for x, y in zip(got, again)):
                    raise RuntimeError(f"{arch}: the {name} build's backward is off the plain version by {err} "
                                       f"(tolerance {cs.BF16_REL_TOL}) or differs between two calls")
                out[f"rel_err {name}"] = err
                split = _kernel_ms(kern, fa.bwd_kernels("mma" if name == "parent" else route, d))
                out.setdefault(f"device_ms {name}", []).append(sum(split.values()))
                out.setdefault(f"kernels_ms {name}", []).append(split)
                out.setdefault(f"event_ms {name}", []).append(cs._time_ms(kern))
        for name, flags in BUILDS.items():
            if route == "wgmma" and "PROBE" in " ".join(flags):
                with _using(libs[name]):
                    out[f"kernels_ms {name}"] = _kernel_ms(kern, fa.bwd_kernels(route, d))
        fa._bwd_kernel.cache_clear()
        qc, kc, vc = (t.detach().contiguous().requires_grad_() for t in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qc, kc, vc, is_causal=True, enable_gqa=True)
        doc = do.contiguous()
        out["cudnn_device_ms"] = cs._device_ms(
            lambda: torch.autograd.grad(sdpa_out, (qc, kc, vc), doc, retain_graph=True), need=False)[0]
        print(json.dumps(out))
        del q, k, v, do, o, lse, plain, qc, kc, vc, sdpa_out, doc
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
