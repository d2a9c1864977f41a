"""Time the bf16 SSD scan's tensor-core routes at the Mamba2 prefill and mesh-rank shapes, and the wgmma route's steps apart.

    python3 scripts/ssd_probe.py [--out build/ssd_probe.json]

Builds ``csrc/ssd_scan.cu`` as it ships, ``-DSSD_TERMS=1`` and ``2`` (each
inexact product operand split into fewer bf16 terms; 3 ship), and the
forms the route dropped, all compiled at once from the sources of commits
FORMS and CPASYNC (read from git into ``build/ssd_fwd_forms/`` and
``build/ssd_fwd_cpasync/`` on the first run in a checkout).  FORMS' states
kernel is a copy of the backward's states arithmetic with x and B by TMA;
CPASYNC's runs the backward's states body itself, x and B by ``cp.async``
as the backward loads them; the shipped one runs that body with x and B by
TMA.  FORMS as it stood (``"TMA states"``), with ``-DSSD_FWD_PASS=1`` (the chunk states in
parallel over chunks, passed along them by a kernel of their own) and with
``-DSSD_FWD_PROBE=1..7`` (no products, no state read, no G∘L∘dt, no state
written, no scans, no planes, no y stored; the chunk kernel there is the
shipped one's code).  At the prefill scan of mamba2-130m and of zamba2-2.7b
(batch 4, prompt 512, bf16, x, B and C strided as ``ssd_block`` passes
them) and at the mesh ranks' scans (their heads on a (1, 2) mesh, and
zamba2 x train_4k's rank 0 of (16, 16)) it runs, each held against
``ssd_scan_plain`` within ``BF16_REL_TOL`` of max |plain| for y and the
final state (the run fails if one disagrees or gives other bits twice),
with the share of bf16 outputs that differ from plain's:

- the wgmma route (``ssd_scan.ssd_scan``): device ms by the profiler, whole
  and kernel by kernel (the steps apart: ``ssd_scan.fwd_kernels``), with the
  L2 warm and cold before each call, CUDA events and the host's time to
  issue a call, the bytes its states move through device memory beside the
  scan's own;
- the same in the TMA-states, ``cp.async``-states and pass builds, and in
  each term build; the shipped, TMA-states and ``cp.async``-states builds
  also in turns (each in order, then in reverse);
- each probe build's kernels, in turns with the TMA-states build (whole,
  probes, probes in reverse, whole): what a part costs is the whole less
  the build without it;
- the ``mma.sync`` kernel at every p tile of ``ssd_scan.mma_plans`` through
  ``ssd_scan.run_plan``, its plan (``ssd_scan.mma_plan``) marked, in turns
  with the wgmma route.

Then (``[unmoved]``) what the change leaves alone, against the parent
commit's sources (PARENT, read from git into ``build/ssd_fwd_parent/`` on
the first run in a checkout, as FORMS' are: run the script once in a git
checkout first, where it stops for want of a card): whether each kernel source and header other than
``ssd_scan.cu`` is the parent's byte for byte (flash, ``gemm`` and the conv
then build the same library), and the SSD backward on both of its routes at
mamba2's and zamba2's training shapes, shipped and parent in turns
(shipped, parent, parent, shipped), by the profiler's device time.

Prints the card's name and power limit, one JSON line per shape and writes
them all to ``--out``.  Needs one CUDA device.
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

#: part build of FORMS' source -> its SSD_FWD_PROBE value
PARTS = {"no products": 1, "no state read": 2, "no G o L o dt": 3, "no state written": 4, "no scans": 5,
         "no planes": 6, "no y stored": 7}
#: builds that split each inexact product operand into fewer bf16 terms than the shipped one
TERM_BUILDS = {"1 term": 1, "2 terms": 2}
#: the commit before the wgmma forward, and where its kernel sources are kept
PARENT = "b50c0b1"
PARENT_DIR = build.BUILD_DIR.parent / "ssd_fwd_parent"
#: the commit whose ssd_scan.cu holds the forms the route dropped (TMA states, the pass form, the part
#: probes), and where its kernel sources are kept
FORMS = "c73822f"
FORMS_DIR = build.BUILD_DIR.parent / "ssd_fwd_forms"
#: the commit whose states kernel ran the backward's states body with x and B by cp.async, and where its
#: kernel sources are kept
CPASYNC = "1c2e59d"
CPASYNC_DIR = build.BUILD_DIR.parent / "ssd_fwd_cpasync"
#: the mesh ranks' scans (b, l, h, p, n): mamba2 and zamba2 at their heads on (1, 2), zamba2 x train_4k's rank
RANK_SHAPES = {"mamba2-130m rank of (1, 2)": (4, 512, 12, 64, 128), "zamba2-2.7b rank of (1, 2)": (4, 512, 40, 64, 64),
               "zamba2-2.7b x train_4k rank 0 of (16, 16)": (16, 4096, 5, 64, 64)}


def build_copies(jobs: dict[str, tuple[Path, str | None]]) -> dict[str, ctypes.CDLL]:
    """name -> (directory of sources, ``NAME=VALUE`` passed as ``-D`` or
    None): each directory's ``ssd_scan.cu`` built beside its own headers,
    all at once; a copy built before is loaded as it is.  Builds of FORMS'
    source come wrapped in :class:`_FormsLib`."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (src, define) in jobs.items():
        out = build.BUILD_DIR / f"ssd_scan-{src.name}{'-' + define.replace('=', '') if define else ''}.so"
        cmd = build.nvcc_command("ssd_scan", out)
        cmd = cmd[:-1] + ["-I", str(src), str(src / "ssd_scan.cu")] + ([f"-D{define}"] if define else [])
        procs[name] = (src, out, None if out.exists() else subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (src, out, proc) in procs.items():
        log, _ = proc.communicate() if proc else ("", None)
        if proc and proc.returncode:
            raise RuntimeError(f"nvcc ({name}) exited {proc.returncode}:\n{log}")
        lib = ctypes.CDLL(str(out))
        libs[name] = _FormsLib(lib) if src == FORMS_DIR else lib
    return libs


class _FormsFwd:
    """FORMS' ``ssd_scan_fwd`` as the shipped wrapper calls it: that entry
    takes one pointer more after hbuf, each chunk's decay (scratch of the
    pass form), given here."""

    def __init__(self, fn):
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 10 + [ctypes.c_void_p] * 2
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        self.fn, self.decs = fn, None

    def __call__(self, *args):
        b, l, h = args[8:11]  # after 7 pointers and the route
        if self.decs is None or self.decs.numel() < b * h * (l // 64):
            self.decs = torch.empty(b * h * (l // 64), dtype=torch.float32, device="cuda")
        return self.fn(*args[:-2], self.decs.data_ptr(), *args[-2:])


class _FormsLib:
    """A build of FORMS' ``ssd_scan.cu``, its forward entry adapted (:class:`_FormsFwd`)."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib, self.ssd_scan_fwd = lib, _FormsFwd(lib.ssd_scan_fwd)

    def __getattr__(self, name):
        return getattr(self._lib, name)


def terms_of(lib) -> int:
    """The bf16 terms a build of ``csrc/ssd_scan.cu`` splits each inexact operand into."""
    lib.ssd_scan_mma_terms.restype = ctypes.c_int
    return lib.ssd_scan_mma_terms()


def using(lib):
    """Point the wrapper at ``lib`` for the duration of the context."""
    for entry in (ssd._kernel, ssd._bwd_kernel, ssd._bwd_mma_kernel):
        entry.cache_clear()
    return mock.patch.object(ssd, "library", lambda: lib)


def _git_sources(commit: str, into: Path) -> Path:
    """``commit``'s kernel sources and headers, read from git into ``into`` unless they are there."""
    if not (into / "ssd_scan.cu").exists():
        root = Path(__file__).resolve().parents[1]
        into.mkdir(parents=True, exist_ok=True)
        for src in sorted(build.CSRC.glob("*.cu*")):
            path = f"src/repro_torch/kernels/csrc/{src.name}"
            got = subprocess.run(["git", "-C", str(root), "show", f"{commit}:{path}"], capture_output=True)
            if got.returncode:
                raise RuntimeError(f"no {into} and no git history to read {commit}:{path} from: run this "
                                   f"script once in a git checkout first\n{got.stderr.decode()}")
            (into / src.name).write_bytes(got.stdout)
    return into


def unmoved(gen: torch.Generator) -> dict:
    """What the change leaves alone beside PARENT's sources: every other kernel source and header byte for
    byte, and the SSD backward on each route at the training shapes, shipped and parent in turns."""
    out = {"same source as the parent": {src.name: (PARENT_DIR / src.name).read_bytes() == src.read_bytes()
                                         for src in sorted(build.CSRC.glob("*.cu*")) if src.name != "ssd_scan.cu"}}
    libs = {"shipped": build.library("ssd_scan"), **build_copies({"parent": (PARENT_DIR, None)})}
    for arch in cs.SSD_MODELS:
        cfg = get_config(arch)
        b, l, h, p, n = cs.TRAIN_BATCH, cs.TRAIN_SEQ, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        x, dt, A, B, C = cs.ssd_inputs(b, l, h, p, n, torch.bfloat16, True, gen)
        dy = torch.randn((b, l, h, p), generator=gen, device="cuda").to(torch.bfloat16)
        for route in ssd.BWD_ROUTES:
            ms = {"shipped": [], "parent": []}
            for name in ("shipped", "parent", "parent", "shipped"):
                with using(libs[name]):
                    ms[name].append(_kernels(lambda: ssd.run_bwd_route(x, dt, A, B, C, dy, chunk=cfg.ssm_chunk,
                                                                       route=route))[0])
            key = f"{arch} backward ({route})"
            out[key] = {**{f"{k} ms": v for k, v in ms.items()}, "shipped / parent": min(ms["shipped"]) / min(ms["parent"])}
            print(f"[unmoved] {key}: {json.dumps(out[key])}")
        del x, dt, A, B, C, dy
    for entry in (ssd._kernel, ssd._bwd_kernel, ssd._bwd_mma_kernel):
        entry.cache_clear()
    print(f"[unmoved] sources: {json.dumps(out['same source as the parent'])}")
    return out


def _kernels(fn, cold: bool = False) -> tuple[float, dict[str, float]]:
    """Device ms per call of ``fn`` and of each SSD kernel it ran, by the
    profiler (``chip_smoke._device_ms``; ``cold``: the L2 read away before
    each call, ``chip_smoke._cold_device_ms``)."""
    times: dict[str, float] = {}
    if cold:
        buf = cs._l2_flush()
        flush = lambda: buf.sum()  # noqa: E731
        skip = set(cs._device_ms(flush)[1])
        cs._device_ms(lambda: (flush(), fn()), times=times)
        times = {k: v for k, v in times.items() if k not in skip}
    else:
        cs._device_ms(fn, times=times)
    named = {}
    for key, ms in times.items():
        name = key.split("::")[-1].split("(")[0] if "ssd_scan" in key else key
        named[name] = named.get(name, 0.0) + ms
    return sum(named.values()), named


def _held(name: str, what: dict, got, want) -> dict:
    """Max abs error of y and the state against plain (raises past the bf16
    tolerance) and the share of bf16 outputs that differ from plain's."""
    (y, state), (yp, sp) = got, want
    err = max(cs._agree(name, what, y, yp, None), cs._agree(f"{name} (state)", what, state, sp, None))
    return {"max_abs_err": err, "y_differing_from_plain": (y != yp).float().mean().item()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/ssd_probe.json")
    args = ap.parse_args()
    _git_sources(PARENT, PARENT_DIR)
    _git_sources(FORMS, FORMS_DIR)
    _git_sources(CPASYNC, CPASYNC_DIR)
    if not torch.cuda.is_available():
        print("ssd_probe: no CUDA device visible", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(f"[card] {smi.stdout.strip().splitlines()[0]}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ptxas = cs.ssd_ptxas()
    libs = {"shipped": build.library("ssd_scan"),
            **build_copies({"TMA states": (FORMS_DIR, None), "cp.async states": (CPASYNC_DIR, None),
                            "pass form": (FORMS_DIR, "SSD_FWD_PASS=1"),
                            **{name: (FORMS_DIR, f"SSD_FWD_PROBE={v}") for name, v in PARTS.items()},
                            **{name: (build.CSRC, f"SSD_TERMS={v}") for name, v in TERM_BUILDS.items()}})}
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = {}
    for arch in cs.SSD_MODELS:
        cfg = get_config(arch)
        shapes[f"{arch} prefill"] = (cs.LM_BATCH, cs.LM_PROMPT, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
    shapes.update(RANK_SHAPES)
    results = []
    for label, (b, l, h, p, n) in shapes.items():
        chunk = 64
        x, dt, A, B, C = cs.ssd_inputs(b, l, h, p, n, torch.bfloat16, True, gen)
        want = ssd.ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
        chosen = ssd.plan(torch.bfloat16, b, h, p, n, chunk, *ssd.alignment(x, B, C), sms=sms)
        if chosen.route != ssd.WGMMA:
            raise RuntimeError(f"{label}: planned {chosen}, want the wgmma route")
        flops, nbytes = cs.ssd_cost(x, B, chunk)
        bound_ms, bound_by = cs._bound(flops, nbytes, cs.PEAK_BF16_FLOPS)
        hg = ssd.bwd_head_group(b, l, h, chunk, sms=sms)

        def kern():
            return ssd.ssd_scan(x, dt, A, B, C, chunk=chunk)

        out = {"shape": label, "x": [b, l, h, p], "n": n, "flops": flops, "bytes": nbytes, "bound_ms": bound_ms,
               "bound_by": bound_by, "head_group": hg, "grids": ssd.fwd_grid(b, l, h, p, n, sms=sms),
               "smem": ssd.fwd_smem_bytes(n, hg),
               # the states entering every chunk but the first, written by one kernel and read by the next
               "state_bytes_each_way": 4 * b * h * (l // chunk - 1) * p * n}
        routes = {}
        for name in ("shipped", "TMA states", "cp.async states", "pass form", *TERM_BUILDS):
            with using(libs[name]):
                got = kern()
                again = kern()
                torch.cuda.synchronize()
                if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
                    raise RuntimeError(f"{label}: the {name} build gives other bits twice")
                row = _held("ssd_scan", {"shape": label, "build": name}, got, want)
                row.update(terms=terms_of(libs[name]))
                row["ms"], row["kernels_ms"] = _kernels(kern)
                if name == "shipped":
                    row["cold_ms"], row["cold_kernels_ms"] = _kernels(kern, cold=True)
                    row.update(events_ms=cs._time_ms(kern), host_ms=cs._host_ms(kern))
            routes[name] = row
        ssd._kernel.cache_clear()
        out["wgmma"] = routes
        order = ("shipped", "TMA states", "cp.async states")
        states = {name: [] for name in order}  # the three states kernels in turns, each build whole
        for name in (*order, *reversed(order)):
            with using(libs[name]):
                states[name].append(_kernels(kern))
        out["states_turns_ms"] = states
        parts = {name: [] for name in ["TMA states", *PARTS]}  # each build's kernels, in turns
        for name in ["TMA states", *PARTS, *reversed(PARTS), "TMA states"]:
            with using(libs[name]):
                parts[name].append(_kernels(kern)[1])
        ssd._kernel.cache_clear()
        out["parts_ms"] = parts
        mma = []
        best = ssd.mma_plan(b, h, p, n, chunk, sms)
        for cand in ssd.mma_plans(b, h, p, n, chunk):
            if cand.smem > ssd.MAX_SMEM_BYTES:
                continue
            got = ssd.run_plan(x, dt, A, B, C, chunk, cand)
            torch.cuda.synchronize()
            row = {"p_tile": cand.p_tile, "blocks": cand.blocks, "plan": cand == best,
                   **_held("ssd_scan (mma.sync)", {"shape": label, "p_tile": cand.p_tile}, got, want)}
            regs, spill_st, spill_ld = ptxas[n, cand.p_tile]
            row.update(registers=regs, spill_bytes=spill_st + spill_ld)
            row["ms"] = _kernels(lambda: ssd.run_plan(x, dt, A, B, C, chunk, cand))[0]
            mma.append(row)
        out["mma"] = mma
        turns = []  # the wgmma route and the mma.sync plan in turns: wgmma, mma, mma, wgmma
        for which in ("wgmma", "mma", "mma", "wgmma"):
            fn = kern if which == "wgmma" else (lambda: ssd.run_plan(x, dt, A, B, C, chunk, best))
            turns.append((which, _kernels(fn)[0]))
        out["turns_ms"] = turns
        w = [ms for which, ms in turns if which == "wgmma"]
        m = [ms for which, ms in turns if which == "mma"]
        out["wgmma_over_mma"] = sum(w) / sum(m)
        results.append(out)
        print(json.dumps(out))
    left_alone = unmoved(gen)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"card": smi.stdout.strip(), "sms": sms, "shapes": results,
                                          "unmoved": left_alone}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
