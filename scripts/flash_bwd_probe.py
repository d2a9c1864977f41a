"""Time the bf16 flash backward launch by launch, the shipped route beside the parent commit's.

    python3 scripts/flash_bwd_probe.py

Run it once in a git checkout first: it writes the parent commit's
``flash_attention.cu`` (PARENT) from git to ``build/flash_bwd_parent/``,
which a copy of the tree without ``.git`` reads, and then
stops for want of a card.  On one H100 (~5 min with the builds):

At the training shapes of granite-3-2b (q [4,32,512,64], k/v [4,8,512,64]),
phi3.5-moe (q [4,32,512,128], k/v [4,8,512,128]) and zamba2-2.7b's shared
block (q/k/v [4,32,512,80]), bf16, causal, q, k, v and dO as the model's
transposed [b, s, h, d] views, this script times ``flash_attention_bwd``
and the forward through the port's wrapper in two builds: the shipped
``csrc/flash_attention.cu`` (the wgmma route at D 64, 80 and 128: dQ with
delta, one dK/dV kernel) and the parent's source, whose wgmma route takes
D 64 and 128 only, so that D 80 runs the ``mma.sync`` kernels there (delta,
dQ, dK/dV).  In the order shipped, parent, parent, shipped: the whole
backward's device time per call from the profiler and each launch's own,
the whole by CUDA events around 20 calls, and the forward's device time.
(CUDA events around one launch at a time would read the host's time to
issue the call, 0.06-0.10 ms, as long as the launch itself.)

Copies built with ``-DFLASH_BWD_PROBE=n`` take one part out of the wgmma
route's kernels (1: dQ's delta; 2: the products; 3: the streamed tiles'
loads; 4: the dK/dV cluster's sum; their outputs are wrong) or, 5, run D
80's output products at N 128 over the tile's zero columns in place of N
80 (the output stays right); each kernel's device time in that build says
what the part costs: when a kernel without its products takes about as
long as whole, the products do not bound it.  cuDNN's backward (SDPA's, as
``chip_smoke.py`` times it) by the profiler beside them.  Every build is
compiled at once.  At D 80 the shipped build and probe 5 are also held to
the plain backward at GQA groups 1 and 4, S 1, 65 and 1000, Sq != Skv,
non-causal and a window, in both score modes; and at each training shape
the shipped build's backward on its wgmma and its ``mma.sync`` route (the
route passed in, the kernels the same source holds for both) in turns, in
each score mode, kernel by kernel.

Prints the card's name and power limit, each wgmma kernel's ``ptxas``
registers (and ptxas's C7517 / C7518 wgmma waits, if any) with its blocks
an SM, and one JSON line per shape; fails if the shipped, the parent or
probe 5's build disagrees with ``flash_attention_bwd_plain``
(``chip_smoke.BF16_REL_TOL`` of each gradient's max; the bf16-score mode
``chip_smoke.BF16S_TOL`` in rms) or gives other bits on a second call.
Needs one CUDA device.
"""

from __future__ import annotations

import contextlib
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
PARTS = ("no delta", "no products", "no loads", "no cluster sum", "N 128 at D 80")
#: build -> its -D flags (none: the shipped library, and the parent's source)
BUILDS = {"shipped": (), "parent": (), **{name: (f"-DFLASH_BWD_PROBE={n}",) for n, name in enumerate(PARTS, 1)}}
#: the commit before the D 80 wgmma route, and where its kernel source is kept
PARENT = "e763fd3"
SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
PARENT_SRC = build.BUILD_DIR.parent / "flash_bwd_parent" / "flash_attention.cu"
#: the head dims the parent's wgmma route takes
PARENT_WGMMA = (64, 128)
#: D 80 cases held to the plain backward in both modes: (h, kvh, sq, skv, causal, window)
D80_CASES = [(32, 32, 512, 512, True, 0), (8, 2, 65, 65, True, 0), (8, 2, 1000, 1000, True, 0),
             (4, 4, 1, 1, True, 0), (8, 2, 15, 1000, False, 0), (8, 2, 448, 65, True, 0),
             (4, 4, 200, 200, False, 0), (8, 2, 200, 200, True, 7)]


def _parent_source() -> Path:
    """PARENT's ``flash_attention.cu``, read from git into PARENT_SRC unless it is there."""
    if not PARENT_SRC.exists():
        root = Path(__file__).resolve().parents[1]
        got = subprocess.run(["git", "-C", str(root), "show", f"{PARENT}:{SOURCE}"], capture_output=True, text=True)
        if got.returncode:
            raise RuntimeError(f"no {PARENT_SRC} and no git history to read {PARENT}:{SOURCE} from: run this "
                               f"script once in a git checkout first\n{got.stderr}")
        PARENT_SRC.parent.mkdir(parents=True, exist_ok=True)
        PARENT_SRC.write_text(got.stdout)
    return PARENT_SRC


def _build() -> tuple[dict[str, ctypes.CDLL], dict[str, str]]:
    """The shipped library and every other build, all compiled at once; and each build's ptxas log."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = build.library_path("flash_attention").stem
    procs = {}
    for name, flags in BUILDS.items():
        if name == "shipped":
            continue
        out = build.BUILD_DIR / f"{stem}-{re.sub(r'[^a-z0-9]+', '-', name.lower())}.so"
        cmd = build.nvcc_command("flash_attention", out) + list(flags)
        if name == "parent":  # its source beside the shipped headers (which only added primitives since PARENT)
            cmd = cmd[:-1] + ["-I", str(build.CSRC), str(_parent_source())]
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {"shipped": build.library("flash_attention")}
    logs = {"shipped": build.ptxas_report("flash_attention")}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc ({name}) exited {proc.returncode}:\n{log}")
        libs[name], logs[name] = ctypes.CDLL(str(out)), log
    return libs, logs


@contextlib.contextmanager
def _using(name: str, lib: ctypes.CDLL):
    """Point the wrappers at build ``name``'s ``lib`` for the duration of
    the context; the parent's ``bwd_route`` sends D 80 to ``"mma"``, and
    its ``fwd_route`` every bf16 forward (it has no wgmma forward)."""
    route = fa.bwd_route

    def parent_route(q, k, v, o, do, fp32_scores=True):
        got = route(q, k, v, o, do, fp32_scores)
        return "mma" if got == "wgmma" and q.shape[-1] not in PARENT_WGMMA else got

    def parent_fwd_route(q, k, v, fp32_scores=True):  # the parent's bf16 forward is mma.sync's alone
        got = fwd_route(q, k, v, fp32_scores)
        return "mma" if got == "wgmma" else got

    fwd_route = fa.fwd_route
    fa._kernel.cache_clear()
    fa._bwd_kernel.cache_clear()
    with mock.patch.object(build, "library", lambda _: lib), \
            mock.patch.object(fa, "bwd_route", parent_route if name == "parent" else route), \
            mock.patch.object(fa, "fwd_route", parent_fwd_route if name == "parent" else fwd_route):
        yield
    fa._kernel.cache_clear()
    fa._bwd_kernel.cache_clear()


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


def _draw(gen, b, s, n, d):
    return torch.randn((b, s, n, d), generator=gen, device="cuda").to(torch.bfloat16).transpose(1, 2)


def _hold_d80(libs: dict, gen: torch.Generator) -> None:
    """The shipped build and probe 5 at D 80 against the plain backward, both modes, same bits twice."""
    for h, kvh, sq, skv, causal, window in D80_CASES:
        q, k, v, do = (_draw(gen, 2, n, heads, 80) for n, heads in ((sq, h), (skv, kvh), (skv, kvh), (sq, h)))
        kw = dict(causal=causal, window=window)
        one_key = skv == 1 or (causal and sq == 1)
        for fp32_scores in (True, False) if not one_key else (True,):
            po, pstats = fa.flash_attention_fwd_plain(q, k, v, fp32_scores=fp32_scores, **kw)
            for name in ("shipped", PARTS[4]):
                with _using(name, libs[name]):
                    o, stats = fa.flash_attention(q, k, v, return_lse=True, fp32_scores=fp32_scores, **kw)
                    if fa.bwd_route(q, k, v, o, do, fp32_scores) != "wgmma":
                        raise RuntimeError(f"D 80 at {(h, kvh, sq, skv)} did not take the wgmma route")
                    got, again = (fa.flash_attention_bwd(q, k, v, o, stats, do, fp32_scores=fp32_scores, **kw)
                                  for _ in range(2))
                    desc = dict(build=name, h=h, kvh=kvh, sq=sq, skv=skv, causal=causal, window=window,
                                fp32_scores=fp32_scores)
                    if fp32_scores:  # the kernel's own o and lse, as chip_smoke.py's phase 11
                        plain = fa.flash_attention_bwd_plain(q, k, v, o, stats, do, **kw)
                        torch.cuda.synchronize()
                        err, tol = cs._hold_grads("D 80", desc, got, plain, cs.BF16_REL_TOL, one_key), cs.BF16_REL_TOL
                    else:  # the plain mode's own forward, as phase 11b
                        plain = fa.flash_attention_bwd_plain(q, k, v, po, pstats, do, fp32_scores=False, **kw)
                        torch.cuda.synchronize()
                        err, tol = max(cs._rms_rel(g, w) for g, w in zip(got, plain)), cs.BF16S_TOL[torch.bfloat16]
                    same = all(torch.equal(x, y) for x, y in zip(got, again))
                    print("[d80] " + json.dumps({**desc, "err": err, "tol": tol, "same_bits": same}))
                    if not err <= tol or not same:
                        raise RuntimeError(f"D 80 at {desc}: off plain by {err} (tolerance {tol}) or other bits "
                                           f"twice ({same})")
        del q, k, v, do


def main() -> int:
    _parent_source()
    if not torch.cuda.is_available():
        print("flash_bwd_probe: no CUDA device visible", file=sys.stderr)
        return 1
    print(f"[card] {cs._card()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    libs, logs = _build()
    for name in ("shipped", "parent", PARTS[4]):
        for kernel, (regs, st, ld) in sorted(cs._ptxas_entries_of(
                logs[name], r"(flash_bwd_[a-z0-9_]+_wgmma(?:_bf16_scores)?_kernelI(?:Li\d+E)+E)").items()):
            print(f"[ptxas] {name}: {cs._bwd_name(kernel)}: {regs} registers, spill stores {st} B, "
                  f"spill loads {ld} B")
        waits = [line for line in logs[name].splitlines() if re.search(r"\(C751[78]\)", line)]
        print(f"[ptxas] {name}: wgmma waits (C7517, C7518): {waits}")
    for d in fa.WGMMA_HEAD_DIMS:
        for fp32_scores in (True, False):
            print(f"[occupancy] D {d}, fp32_scores={fp32_scores}: blocks an SM dQ "
                  f"{fa.bwd_occupancy(d, fp32_scores, False)}, dK/dV {fa.bwd_occupancy(d, fp32_scores, True)}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    _hold_d80(libs, gen)
    b, s = cs.TRAIN_BATCH, cs.TRAIN_SEQ
    for arch in MODELS:
        cfg = get_config(arch)
        h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        q, k, v, do = (_draw(gen, b, s, n, d) for n in (h, kvh, kvh, h))
        o, lse = fa.flash_attention(q, k, v, return_lse=True)
        plain = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
        flops, nbytes = fa.bwd_cost(q, k, True, 0)
        bound_ms, bound_by = cs._bound(flops, nbytes, cs.PEAK_BF16_FLOPS)
        route = fa.bwd_route(q, k, v, o, do)
        out: dict = {"model": arch, "q": list(q.shape), "k": list(k.shape), "route": route,
                     "cluster": fa.bwd_cluster(h, kvh) if route == "wgmma" else None,
                     "bound_ms": bound_ms, "bound_by": bound_by}

        def kern():
            return fa.flash_attention_bwd(q, k, v, o, lse, do)

        def fwd():
            return fa.flash_attention(q, k, v, return_lse=True)

        for name in ("shipped", "parent", "parent", "shipped"):
            with _using(name, libs[name]):
                got, again = kern(), kern()
                torch.cuda.synchronize()
                err = max(((g.float() - w.float()).abs().max() / w.float().abs().max()).item()
                          for g, w in zip(got, plain))
                if not err <= cs.BF16_REL_TOL or not all(torch.equal(x, y) for x, y in zip(got, again)):
                    raise RuntimeError(f"{arch}: the {name} build's backward is off the plain version by {err} "
                                       f"(tolerance {cs.BF16_REL_TOL}) or differs between two calls")
                out[f"rel_err {name}"] = err
                split = _kernel_ms(kern, fa.bwd_kernels(fa.bwd_route(q, k, v, o, do), d))
                out.setdefault(f"device_ms {name}", []).append(sum(split.values()))
                out.setdefault(f"kernels_ms {name}", []).append(split)
                out.setdefault(f"event_ms {name}", []).append(cs._time_ms(kern))
                out.setdefault(f"fwd device_ms {name}", []).append(
                    sum(_kernel_ms(fwd, fa.fwd_kernels(fa.fwd_route(q, k, v), d)).values()))
        for part in ("device_ms", "fwd device_ms"):
            out[f"{part} shipped / parent"] = (sum(out[f"{part} shipped"]) / sum(out[f"{part} parent"]))
        # both routes of the shipped build, each score mode, in turns
        for fp32_scores in (True, False):
            o2, st2 = fa.flash_attention(q, k, v, return_lse=True, fp32_scores=fp32_scores)
            mode = "fp32-score" if fp32_scores else "bf16-score"
            for rt in ("wgmma", "mma", "mma", "wgmma"):
                with mock.patch.object(fa, "bwd_route", lambda *_, rt=rt, **__: rt):
                    split = _kernel_ms(lambda: fa.flash_attention_bwd(q, k, v, o2, st2, do, fp32_scores=fp32_scores),
                                       fa.bwd_kernels(rt, d, fp32_scores))
                out.setdefault(f"{mode} {rt} route device_ms", []).append(sum(split.values()))
                out.setdefault(f"{mode} {rt} route kernels_ms", []).append(split)
        for n, name in enumerate(PARTS, 1):
            if route == "wgmma" and (n < 5 or d == 80):
                with _using(name, libs[name]):
                    out[f"kernels_ms {name}"] = _kernel_ms(kern, fa.bwd_kernels(route, d))
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
