"""Time the flash kernel's bf16-score mode kernel by kernel, in parts, the shipped route beside the parent's.

    python3 scripts/flash_bf16s_probe.py

(one H100, ~5 min with the builds).  The parent's kernel source is read
from git (``git show PARENT:src/repro_torch/kernels/csrc/flash_attention.cu``)
into ``build/flash_bf16s_parent/`` on the first run in a checkout; a copy of
the tree without ``.git`` needs that file already there, so run the script
once in the checkout first (it writes the file, then stops where there is
no CUDA device).  At the training shapes of
granite-3-2b (q [4,32,512,64], k/v [4,8,512,64]), phi3.5-moe (q
[4,32,512,128], k/v [4,8,512,128]) and zamba2-2.7b's shared block (q/k/v
[4,32,512,80]), bf16, causal, q, k, v and dO as the model's transposed
[b, s, h, d] views, this script times the mode's forward
(``flash_attention(fp32_scores=False)``) and backward
(``flash_attention_bwd(fp32_scores=False)``) through the port's wrapper in
several builds of ``csrc/flash_attention.cu``, all compiled at once:

- the shipped one, and the parent's source (PARENT, the commit before the
  mode's redesign: the ``mma.sync`` backward at every head dim, the IEEE
  division and ``expf`` on every element, the forward's max sweep mapping
  every score, R added in key order by 16 lanes of a warp), in the order
  shipped, parent, parent, shipped: each kernel's device time per call
  from the profiler, the whole by CUDA events around 20 calls, and the
  fp32-score forward and backward of the same build on the same inputs
  (the mode's times are read as ratios to them, and the fp32-score
  kernels' shipped times against the parent's);
- copies built with ``-DFLASH_BF16S_PROBE=n``, each taking one part out
  of the mode's kernels (their outputs are wrong): 1, every per-element
  division by c or by l is a plain multiplication by a reciprocal, with no
  exact path; 2, ``bf16(exp(t))`` is ``ex2.approx`` with no exact path;
  3, the dQ kernels add no term of R; 4, the ``mma.sync`` forward runs its
  y.V sweep alone (no max sweep, no sum sweep; m = 0, l = 1, so only the
  forward is timed).  Each kernel's time without a part says what that
  part costs.

Prints the card's name and power limit, each build's ``ptxas`` registers
and spills for the mode's kernels and the fp32-score wgmma backward's, and one JSON line per shape; fails if
the shipped or the parent build disagrees with the plain mode
(``chip_smoke.BF16S_TOL``, root mean square of the difference over
plain's) or gives other bits on a second call.  Needs one CUDA device.
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

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (also puts the port on sys.path)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

MODELS = ("granite-3-2b", "phi3.5-moe-42b", "zamba2-2.7b")
PARTS = ("no divisions", "no expf", "no R sum", "no max/sum sweeps")
#: build -> its -D flags (none: the shipped library; the parent's source takes none)
BUILDS = {
    "shipped": (),
    "parent": (),
    **{name: (f"-DFLASH_BF16S_PROBE={n}",) for n, name in enumerate(PARTS, start=1)},
}
#: the commit before the mode's redesign, and where its kernel source is kept
PARENT = "6b8e459"
SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
PARENT_SRC = build.BUILD_DIR.parent / "flash_bf16s_parent" / "flash_attention.cu"
#: the mode's kernels and the fp32-score wgmma backward's in a ptxas log (mangled names)
MODE_KERNELS = (r"(flash_(?:fwd|bwd)_[a-z0-9_]*bf16_scores_kernelI(?:Li\d+E)+E"
                r"|flash_bwd_d(?:q|kdv)_wgmma_kernelI(?:Li\d+E)+E)")


def _slug(name: str) -> str:
    return re.sub(r"[^a-z0-9]+", "-", name)


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
    """The shipped library and every other build, all compiled at once;
    and each build's ptxas log."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = build.library_path("flash_attention").stem
    procs = {}
    for name, flags in BUILDS.items():
        if name == "shipped":
            continue
        out = build.BUILD_DIR / f"{stem}-{_slug(name)}.so"
        cmd = build.nvcc_command("flash_attention", out) + list(flags)
        if name == "parent":  # its source beside the shipped headers (unchanged since PARENT)
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


def _registers(log: str) -> dict[str, tuple[int, int, int]]:
    """Registers, spill-store and spill-load bytes of MODE_KERNELS in a ptxas log."""
    lines = log.splitlines()
    seen = {}
    for i, line in enumerate(lines):
        name = re.search(MODE_KERNELS, line)
        if "Compiling entry function" not in line or not name:
            continue
        props = " ".join(lines[i + 1: i + 4])
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", props)
        regs = re.search(r"Used (\d+) registers", props)
        seen[cs._bwd_name(name.group(1))] = (int(regs.group(1)), int(spill.group(1)), int(spill.group(2)))
    return seen


@contextlib.contextmanager
def _using(name: str, lib: ctypes.CDLL):
    """Point the wrappers at build ``name``'s ``lib`` for the duration of
    the context.  The parent's mode has only the ``mma.sync`` bf16
    backward, and the parent has no wgmma backward at D 80, so its
    ``bwd_route`` is ``"mma"`` there; it has no wgmma forward, so its
    ``fwd_route`` is ``"mma"`` for every bf16 forward."""
    route = fa.bwd_route

    def parent_route(q, k, v, o, do, fp32_scores=True):
        got = route(q, k, v, o, do, fp32_scores)
        return "mma" if got == "wgmma" and (not fp32_scores or q.shape[-1] == 80) else got

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


def main() -> int:
    _parent_source()
    if not torch.cuda.is_available():
        print("flash_bf16s_probe: no CUDA device visible", file=sys.stderr)
        return 1
    print(f"[card] {cs._card()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    libs, logs = _build()
    timed = {f"<{get_config(arch).hd}" for arch in MODELS}
    for name, log in logs.items():
        for kernel, (regs, st, ld) in sorted(_registers(log).items()):
            if any(d in kernel for d in timed):
                print(f"[ptxas] {name}: {kernel}: {regs} registers, spill stores {st} B, spill loads {ld} B")
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, s = cs.TRAIN_BATCH, cs.TRAIN_SEQ
    tol = cs.BF16S_TOL[torch.bfloat16]
    for arch in MODELS:
        cfg = get_config(arch)
        h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        q, k, v, do = (torch.randn((b, s, n, d), generator=gen, device="cuda").to(torch.bfloat16).transpose(1, 2)
                       for n in (h, kvh, kvh, h))
        po, pstats = fa.flash_attention_fwd_plain(q, k, v, fp32_scores=False)
        plain = fa.flash_attention_bwd_plain(q, k, v, po, pstats, do, fp32_scores=False)
        o32, lse32 = fa.flash_attention(q, k, v, return_lse=True)
        route = fa.bwd_route(q, k, v, o32, do, fp32_scores=False)
        out: dict = {"model": arch, "q": list(q.shape), "k": list(k.shape), "route": route}

        def fwd():
            return fa.flash_attention(q, k, v, return_lse=True, fp32_scores=False)

        def fwd32():
            return fa.flash_attention(q, k, v, return_lse=True)

        def bwd32():
            return fa.flash_attention_bwd(q, k, v, o32, lse32, do)

        fwd_kernel = (f"flash_fwd_mma_bf16_scores_kernel<{d}>",)
        kernels32 = {}
        for name in ("shipped", "parent", "parent", "shipped"):
            with _using(name, libs[name]):
                kernels32["fwd"] = fa.fwd_kernels(fa.fwd_route(q, k, v), d)  # this build's route
                o, stats = fwd()
                got, again = (fa.flash_attention_bwd(q, k, v, o, stats, do, fp32_scores=False) for _ in range(2))
                torch.cuda.synchronize()
                err = {"o": cs._rms_rel(o, po), **{n: cs._rms_rel(g, w) for n, g, w in zip(("dq", "dk", "dv"),
                                                                                          got, plain)}}
                if not max(err.values()) <= tol or not all(torch.equal(x, y) for x, y in zip(got, again)):
                    raise RuntimeError(f"{arch}: the {name} build is off the plain mode by {err} (rms, tolerance "
                                       f"{tol}) or its backward differs between two calls")
                out[f"rms {name}"] = err

                def bwd():
                    return fa.flash_attention_bwd(q, k, v, o, stats, do, fp32_scores=False)

                want = fa.bwd_kernels("mma" if name == "parent" and route == "wgmma" else route, d, False)
                for part, fn, kernels in (("fwd", fwd, fwd_kernel), ("bwd", bwd, want)):
                    split = _kernel_ms(fn, kernels)
                    out.setdefault(f"{part}_ms {name}", []).append(sum(split.values()))
                    out.setdefault(f"{part} kernels_ms {name}", []).append(split)
                    out.setdefault(f"{part} event_ms {name}", []).append(cs._time_ms(fn))
                kernels32["bwd"] = fa.bwd_kernels(fa.bwd_route(q, k, v, o32, do), d)  # this build's route
                for part, fn in (("fwd", fwd32), ("bwd", bwd32)):  # the same build's fp32-score kernels
                    split = _kernel_ms(fn, kernels32[part])
                    out.setdefault(f"fp32-score {part}_ms {name}", []).append(sum(split.values()))
                    out.setdefault(f"fp32-score {part} kernels_ms {name}", []).append(split)
        for name in PARTS:
            with _using(name, libs[name]):
                o, stats = fwd()

                def bwd():
                    return fa.flash_attention_bwd(q, k, v, o, stats, do, fp32_scores=False)

                out[f"fwd kernels_ms {name}"] = _kernel_ms(fwd, fwd_kernel)
                if name != PARTS[3]:  # that probe's (m, l) are not the forward's: its backward is not timed
                    out[f"bwd kernels_ms {name}"] = _kernel_ms(bwd, fa.bwd_kernels(route, d, False))
        for name in ("shipped", "parent"):
            for part in ("fwd", "bwd"):
                out[f"{part}_ms {name} / fp32-score"] = (min(out[f"{part}_ms {name}"])
                                                         / min(out[f"fp32-score {part}_ms {name}"]))
        for part in ("fwd", "bwd"):
            out[f"fp32-score {part}_ms shipped / parent"] = (min(out[f"fp32-score {part}_ms shipped"])
                                                             / min(out[f"fp32-score {part}_ms parent"]))
        print(json.dumps(out))
        del q, k, v, do, po, pstats, plain, o32, lse32
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
