"""Time the bf16 flash forward's tilings at every served prefill shape.

    python3 scripts/flash_tiles.py [--tilings all|shipped]

The shipped ``flash_fwd_wgmma_kernel<D>`` takes each head dim's consumer
warpgroups and overlap from ``fwd_choice`` in ``csrc/flash_attention.cu``.
This script builds that source once more for each choice of ``TILINGS``
(consumer warpgroups of 64 query rows, one or two; the softmax of a key
tile overlapping its neighbours' products within a warpgroup, or not),
with ``-DFLASH_FWD_WGS=`` and ``-DFLASH_FWD_OVERLAP=`` into ``build/``,
once with ``-DFLASH_D128_WARPS=4`` (the ``mma.sync`` kernel's 4-warp
tiling at D 128) and once from the parent commit's source, all at the
same time as the shipped library.  (128-key tiles, ping-pong between two
warpgroups, Q held in registers and a block a work tile lost to these
choices and were taken out of the source; this script timed them at
commit 1c091d5, PERF.md.)  Then, at each flash
call of the served models' prefills (``chip_smoke.served_flash_calls``:
bf16, q/k/v as the model's transposed views), it holds every build's
forward against the plain version (within ``BF16_REL_TOL`` of max |plain|,
the same bits on a second call) and times it by the profiler's device time
per call, the builds in turns (the list, the list reversed, the list again;
each build's mean is its reading), beside
the shipped build's ``mma.sync`` route (``flash_attention.run_fwd_route``),
the 4-warp copy's at D 128, and SDPA.  Prints the card's name and power
limit, each build's ``ptxas`` line and tiling (``fwd_config``) for every
head dim, one JSON line per shape, and the fastest tiling of each head dim
by the geometric mean of its shapes' times.  A build that disagrees with
the plain version or gives other bits twice is timed no further, and the
script then exits 1 at its end.

Then, beside the parent commit's source (PARENT, read from git into
``build/flash_fwd_parent/`` on the first run in a checkout: run the script
once here first, it writes the file and stops for want of a card), at the
training shapes of granite-3-2b, phi3.5-moe and zamba2-2.7b (batch 4 x
512, bf16, causal, the model's views), shipped and parent in turns
(shipped, parent, parent, shipped): the bf16 forward (wgmma against the
parent's ``mma.sync``) and what the change leaves alone, each by the
profiler's device time with its ratio to the parent's: the ``mma.sync``
forward, the fp32 SIMT forward, the backward on each route (wgmma and
``mma.sync`` in bf16, SIMT in fp32) and the bf16-score mode's forward and
backward (``[unmoved]`` lines).  Needs one CUDA device (~4 min with the
builds).
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import math
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

#: (consumer warpgroups, overlap within a warpgroup) of each probe build
TILINGS = [(1, 0), (1, 1), (2, 0), (2, 1)]


#: the commit before the wgmma forward, and where its kernel source is kept
PARENT = "946369c"
SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
PARENT_SRC = build.BUILD_DIR.parent / "flash_fwd_parent" / "flash_attention.cu"
#: the training shapes (batch 4 x 512) at which what the change leaves alone is timed beside the parent
TRAIN_MODELS = ("granite-3-2b", "phi3.5-moe-42b", "zamba2-2.7b")


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


def _name(tiling: tuple[int, int]) -> str:
    return "wg{}_ov{}".format(*tiling)


def _ptxas(log: str, kernel: str) -> dict[int, str]:
    """Each head dim's registers and spills of ``kernel`` in a ``ptxas -v`` log."""
    lines, out = log.splitlines(), {}
    for i, line in enumerate(lines):
        if (m := re.search(kernel + r"ILi(\d+)EE", line)) and "Compiling entry function" in line:
            out[int(m.group(1))] = " | ".join(x.split(":", 1)[-1].strip() for x in lines[i + 2: i + 4])
    return out


def _build(tilings: list) -> dict[str, ctypes.CDLL]:
    """The shipped library and one copy per tiling (and the 4-warp mma.sync copy), built at once."""
    flags = {_name(t): [f"-DFLASH_FWD_WGS={t[0]}", f"-DFLASH_FWD_OVERLAP={t[1]}"] for t in tilings}
    flags["mma_w4"] = ["-DFLASH_D128_WARPS=4"]
    flags["parent"] = []
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = build.library_path("flash_attention").stem
    procs = {}
    for name, extra in flags.items():
        out = build.BUILD_DIR / f"{stem}-{name}.so"
        cmd = build.nvcc_command("flash_attention", out) + extra
        if name == "parent":  # its source beside the shipped headers (which only added primitives since PARENT)
            cmd = cmd[:-1] + ["-I", str(build.CSRC), str(_parent_source())]
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {"shipped": build.library("flash_attention")}
    logs = {"shipped": build.ptxas_report("flash_attention")}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc ({name}) exited {proc.returncode}:\n{log[-20000:]}")
        libs[name], logs[name] = ctypes.CDLL(str(out)), log
    for name, log in logs.items():
        waits = [line for line in log.splitlines() if re.search(r"\(C751[78]\)", line) and "fwd_wgmma" in line]
        for d, line in sorted(_ptxas(log, "flash_fwd_wgmma_kernel").items()):
            print(f"[ptxas] {name} flash_fwd_wgmma_kernel<{d}>: {line}")
        if waits:
            print(f"[ptxas] {name}: wgmma made to wait: {waits}")
    print(f"[ptxas] mma_w4 flash_fwd_mma_bf16_kernel<128>: {_ptxas(logs['mma_w4'], 'flash_fwd_mma_bf16_kernel')[128]}")
    return libs


def _using(lib: ctypes.CDLL):
    """Point the wrapper at ``lib`` for the duration of the context."""
    fa._kernel.cache_clear()
    fa._bwd_kernel.cache_clear()
    return mock.patch.object(build, "library", lambda name: lib)


@contextlib.contextmanager
def _build_of(name: str, lib: ctypes.CDLL):
    """``_using(lib)``; for the parent's build, whose forward entry takes 0 (fp32, SIMT) and 1 (bf16,
    mma.sync) as the shipped one takes those route codes, the bf16 forward's route is ``"mma"``."""
    route = fa.fwd_route

    def parent_route(q, k, v, fp32_scores=True):
        got = route(q, k, v, fp32_scores)
        return "mma" if got == "wgmma" else got

    with _using(lib), mock.patch.object(fa, "fwd_route", parent_route if name == "parent" else route):
        yield


def _unmoved(libs: dict, gen: torch.Generator, card: str) -> None:
    """At each training shape, shipped and parent in turns: the bf16 forward (the change: wgmma against the
    parent's mma.sync), and what it leaves alone: the mma.sync forward, the fp32 SIMT forward, the backward
    on each route (wgmma, mma.sync; SIMT in fp32) and the bf16-score mode's forward and backward."""
    for arch in TRAIN_MODELS:
        cfg = get_config(arch)
        q, k, v, do = (torch.randn((4, 512, n, cfg.hd), generator=gen, device="cuda").to(torch.bfloat16)
                       .transpose(1, 2) for n in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads, cfg.n_heads))
        qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
        out: dict = {"model": arch, "q": list(q.shape), "k": list(k.shape), "card": card}
        for name in ("shipped", "parent", "parent", "shipped"):
            with _build_of(name, libs[name]):
                o, lse = fa.flash_attention(q, k, v, return_lse=True)
                o2, st2 = fa.flash_attention(q, k, v, return_lse=True, fp32_scores=False)
                of, lsef = fa.flash_attention(qf, kf, vf, return_lse=True)

                def bwd(rt, args=(q, k, v, o, lse, do), **kw):
                    with mock.patch.object(fa, "bwd_route", lambda *_, **__: rt):
                        return fa.flash_attention_bwd(*args, **kw)

                timed = {
                    "fwd": lambda: fa.flash_attention(q, k, v),
                    "fwd mma": lambda: fa.run_fwd_route(q, k, v, route="mma"),
                    "fwd simt": lambda: fa.flash_attention(qf, kf, vf),
                    "bwd wgmma": lambda: bwd("wgmma"),
                    "bwd mma": lambda: bwd("mma"),
                    "bwd simt": lambda: bwd("simt", (qf, kf, vf, of, lsef, dof)),
                    "bf16s fwd": lambda: fa.flash_attention(q, k, v, fp32_scores=False),
                    "bf16s bwd": lambda: fa.flash_attention_bwd(q, k, v, o2, st2, do, fp32_scores=False),
                }
                for key, fn in timed.items():
                    out.setdefault(f"{key} device_ms {name}", []).append(cs._device_ms(fn)[0])
        for key in timed:
            out[f"{key} shipped / parent"] = (min(out[f"{key} device_ms shipped"])
                                              / min(out[f"{key} device_ms parent"]))
        print("[unmoved] " + json.dumps(out))
        sys.stdout.flush()
        del q, k, v, do, qf, kf, vf, dof
        torch.cuda.empty_cache()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tilings", choices=("all", "shipped"), default="all")
    args = parser.parse_args()
    _parent_source()
    if not torch.cuda.is_available():
        print("flash_tiles: no CUDA device visible", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"[card] {card}")
    libs = _build(TILINGS if args.tilings == "all" else [])
    builds = [n for n in libs if n not in ("mma_w4", "parent")]
    for name in builds:
        with _using(libs[name]):
            print(f"[tiling] {name}: " + json.dumps({d: fa.fwd_config(d) for d in fa.FWD_WGMMA_HEAD_DIMS}))
    gen = torch.Generator(device="cuda").manual_seed(0)
    by_dim: dict[int, dict[str, list[float]]] = {}
    failed: dict[str, str] = {}  # build -> where it first disagreed; it is timed no further
    for case in cs.served_flash_calls():
        b, h, kvh, s, d = (case[k] for k in ("b", "h", "kvh", "s", "d"))
        skv, kw = case.get("skv", s), dict(causal=case["causal"])
        q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(torch.bfloat16).transpose(1, 2)
        k, v = (torch.randn((b, skv, kvh, d), generator=gen, device="cuda").to(torch.bfloat16).transpose(1, 2)
                for _ in range(2))
        want = fa.flash_attention_plain(q, k, v, **kw).float()
        tol = cs.BF16_REL_TOL * want.abs().max().item()
        out: dict = {"model": case["model"], "q": list(q.shape), "k": list(k.shape), "card": card}

        def kern():
            return fa.flash_attention(q, k, v, **kw)

        def mma():
            return fa.run_fwd_route(q, k, v, route="mma", **kw)

        for name in (*builds, *reversed(builds), *builds):
            if name in failed:
                continue
            with _using(libs[name]):
                y = kern()
                err = (y.float() - want).abs().max().item()
                if err > tol or not torch.equal(y, kern()):
                    failed[name] = f"{case['model']}'s shape: max abs err {err} (tol {tol}) or other bits twice"
                    print(f"[fail] {name} at {failed[name]}")
                    continue
                out.setdefault(f"device_ms {name}", []).append(cs._device_ms(kern)[0])
        with _using(libs["shipped"]):
            out["device_ms mma"] = cs._device_ms(mma)[0]
            out["host_ms"], out["host_ms mma"] = cs._host_ms(kern), cs._host_ms(mma)
        if d == 128:
            with _using(libs["mma_w4"]):
                out["device_ms mma_w4"] = cs._device_ms(mma)[0]
        fa._kernel.cache_clear()
        qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
        out["device_ms sdpa"] = cs._device_ms(
            lambda: F.scaled_dot_product_attention(qc, kc, vc, is_causal=case["causal"], enable_gqa=True))[0]
        for name in builds:
            if name in failed:
                continue
            mean = sum(out[f"device_ms {name}"]) / len(out[f"device_ms {name}"])
            out[f"sdpa_ratio {name}"] = mean / out["device_ms sdpa"]
            by_dim.setdefault(d, {}).setdefault(name, []).append(mean)
        print(json.dumps(out))
        sys.stdout.flush()
    for d, times in sorted(by_dim.items()):
        geo = {name: math.exp(sum(map(math.log, t)) / len(t)) for name, t in times.items() if name not in failed}
        print(f"[best] D {d}: " + json.dumps(dict(sorted(geo.items(), key=lambda kv: kv[1]))))
    if "shipped" not in failed:
        _unmoved(libs, gen, card)
    if failed:
        print(f"flash_tiles: builds that disagree with the plain version or give other bits twice: {failed}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
