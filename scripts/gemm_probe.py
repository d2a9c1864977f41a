"""Time the bf16 GEMM kernels whole and in parts, the shipped source beside the parent commit's and ``torch.bmm``.

    python3 scripts/gemm_probe.py

Run it once in a git checkout first: it writes the parent commit's
``gemm.cu`` (PARENT) from git to ``build/gemm_parent/``, which a copy of the
tree without ``.git`` reads, and then stops for want of a
card.  On one H100 (~4 min with the builds):

Builds ``csrc/gemm.cu`` and the parent's source, and eleven probe copies of
``csrc/gemm.cu``, all at once: ``-DGEMM_PROBE=1`` (the wgmma kernel's loads
alone: no products), ``2`` (its products alone: no loads), ``3`` (no
2-block clusters), ``4`` (no epilogue stores), ``5`` (every product on the
long-reduction schedule), ``6`` (every product on the short one), ``7``
(the decode kernel's loads alone), ``8`` (its products alone), ``9`` (the
decode kernel on 512-column tiles, a ring of 3), ``10`` (128-column tiles,
a ring of 12), ``11`` (a ring of 4), ``12`` (each block's SM, start
and end on the global timer) and ``13`` (two blocks an SM, rings of 3).

- The MoE decode products (bf16, 16 experts at capacity 8: phi3.5-moe's
  gate/up [8, 4096] · [4096, 6400] and down [8, 6400] · [6400, 4096],
  llama4-scout's [8, 5120] · [5120, 8192] and back): the shipped
  ``gemm_decode_bf16_kernel`` (with its sum) and the parent's route 1,
  ``gemm_mma_bf16_kernel<16, 128>`` with 16-byte copies, in the order
  shipped, parent, parent, shipped (the shipped kernels each by the
  profiler too); probes 7 to 13; ``torch.bmm``; the shipped kernels,
  ``torch.bmm`` and the parent's with the L2 cache cold before each call
  (``chip_smoke._cold_device_ms``: the decode step reads every weight
  once, the other layers' in between); the
  bytes bound; the parent's blocks, blocks an SM (by its shared memory) and
  waves, the shipped kernel's blocks an SM and the SMs' shares of the
  weights.  Then the parent's kernel where its grid fills the card in
  whole waves (N 5248: 41 column tiles x 16 experts, 656 blocks, within one
  wave of 660; N 10496: 1,312 blocks, two), which gives every SM an equal
  share of its blocks: when those reach a larger share of the bytes bound
  than the MoE shapes do, the waves cost the difference.
- The MoE prefill products of phi3.5-moe and llama4-scout (capacities 320
  and 160) and phi3.5-moe's training gradients (dA = dC·Bᵀ, dB = Aᵀ·dC as
  the transposed views ``ops.gemm``'s backward passes): the shipped and the
  parent's ``gemm_wgmma_bf16_kernel`` in turns (the same kernel: the
  change did not touch it), then probes 1-6.

Device time per call from the profiler (``chip_smoke.py``'s helper).
Prints the card's name and power limit, the decode kernels' ``ptxas``
registers, and one JSON line per shape; fails if a build that computes the
product disagrees with the plain version (``chip_smoke.GEMM_TOL``) or the
shipped decode kernel gives other bits on a second call.  Needs one CUDA
device.
"""

from __future__ import annotations

import contextlib
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
from repro_torch.kernels import gemm as gm  # noqa: E402
from repro_torch.models import blocks  # noqa: E402

MODELS = ("phi3.5-moe-42b", "llama4-scout-17b")
#: build -> its GEMM_PROBE value (None: the shipped library and the parent's source)
PROBES = {"shipped": None, "parent": None, "loads alone": 1, "products alone": 2, "no cluster": 3,
          "no stores": 4, "long schedule": 5, "short schedule": 6, "decode loads alone": 7,
          "decode products alone": 8, "decode tile 512, ring 3": 9, "decode tile 128, ring 12": 10,
          "decode ring 4": 11, "decode timer": 12, "decode two blocks an SM": 13}
#: the decode probes that build another tile: their columns (the wrapper's gemm.DECODE_TILE)
DECODE_TILES = {9: 512, 10: 128}
#: the probes that leave the output wrong
WRONG = (1, 2, 4, 7, 8, 12, 13)
#: the commit before the decode kernels, and where its kernel source is kept
PARENT = "e763fd3"
SOURCE = "src/repro_torch/kernels/csrc/gemm.cu"
PARENT_SRC = build.BUILD_DIR.parent / "gemm_parent" / "gemm.cu"
#: the parent's decode kernel: route 1, a block per (128-column tile, expert) asking 4 stages of 16 x 40 + 32 x 136
#: bf16 of shared memory; an SM of the H100 holds 233,472 bytes, 1,024 of them reserved a block
PARENT_DECODE_ROUTE, PARENT_DECODE_SMEM, SM_SMEM, BLOCK_RESERVED = 1, 4 * (16 * 40 + 32 * 136) * 2, 233_472, 1_024


def _parent_source() -> Path:
    """PARENT's ``gemm.cu``, read from git into PARENT_SRC unless it is there."""
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
    stem = build.library_path("gemm").stem
    procs = {}
    for name, probe in PROBES.items():
        if name == "shipped":
            continue
        out = build.BUILD_DIR / f"{stem}-{'parent' if probe is None else f'probe{probe}'}.so"
        cmd = build.nvcc_command("gemm", out)
        if probe is None:  # the parent's source beside the shipped headers (which only added primitives since PARENT)
            cmd = cmd[:-1] + ["-I", str(build.CSRC), str(_parent_source())]
        else:
            cmd.append(f"-DGEMM_PROBE={probe}")
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {"shipped": build.library("gemm")}
    logs = {"shipped": build.ptxas_report("gemm")}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc ({name}) exited {proc.returncode}:\n{log}")
        libs[name], logs[name] = ctypes.CDLL(str(out)), log
    return libs, logs


@contextlib.contextmanager
def _using(lib: ctypes.CDLL):
    """Point the wrapper at ``lib`` for the duration of the context."""
    gm._kernel.cache_clear()
    gm._decode_kernel.cache_clear()
    with mock.patch.object(build, "library", lambda name: lib):
        yield
    gm._kernel.cache_clear()
    gm._decode_kernel.cache_clear()


def _parent_decode(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The parent's route 1 on [E, M, K] · [E, K, N] (inside ``_using`` of the parent's library)."""
    E, M, K = a.shape
    N = b.shape[2]
    c = torch.empty((E, M, N), dtype=a.dtype, device=a.device)
    err = gm._kernel()(a.data_ptr(), b.data_ptr(), c.data_ptr(), PARENT_DECODE_ROUTE, E, M, N, K, *a.stride(),
                       *b.stride(), c.stride(0), c.stride(1), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the parent's decode kernel: error {err}")
    return c


def _decode_direct(a: torch.Tensor, b: torch.Tensor, blocks: int, extra: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """The decode route's C entry at ``blocks`` blocks, its scratch ``extra`` floats longer: (c, scratch)."""
    E, M, K = a.shape
    N = b.shape[2]
    c = torch.empty((E, M, N), dtype=a.dtype, device=a.device)
    ws = torch.zeros(blocks * 2 * (gm.DECODE_TILE // 64) * 128 * gm.decode_mt(M) // 2 + extra, dtype=torch.float32,
                     device=a.device)
    err = gm._decode_kernel()(a.data_ptr(), b.data_ptr(), c.data_ptr(), ws.data_ptr(), blocks, E, M, N, K,
                              a.stride(0), a.stride(1), b.stride(0), b.stride(1), c.stride(0), c.stride(1),
                              torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the decode kernels: error {err}")
    return c, ws


def _timeline(libs: dict, a: torch.Tensor, b: torch.Tensor, sms: int) -> dict:
    """Probe 12: each block's SM, start and end on the global timer (ns), summarised."""
    with _using(libs["decode timer"]):
        _decode_direct(a, b, sms, 6 * sms)
        torch.cuda.synchronize()
        _, ws = _decode_direct(a, b, sms, 6 * sms)
        torch.cuda.synchronize()
    ts = ws[-6 * sms:].view(torch.int64).view(sms, 3).cpu()
    start, end = ts[:, 1] - ts[:, 1].min(), ts[:, 2] - ts[:, 1].min()
    took = (end - start).float()
    return {"span_us": end.max().item() / 1e3, "start_spread_us": start.max().item() / 1e3,
            "end_spread_us": (end.max() - end.min()).item() / 1e3,
            "block_us": [took.min().item() / 1e3, took.median().item() / 1e3, took.max().item() / 1e3],
            "end_us_deciles": [end.float().quantile(q).item() / 1e3 for q in (0.0, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0)],
            "distinct_sms": len(set(ts[:, 0].tolist())),
            "slowest_blocks_sm": ts[took.argsort(descending=True)[:5], 0].tolist()}


def _decode_cases(gen: torch.Generator):
    """(model, product, a, b) of every MoE decode step: gate/up, then down."""
    for arch in MODELS:
        cfg = get_config(arch)
        E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        cap = blocks.moe_capacity(cfg, cs.LM_BATCH)
        for what, (sa, sb) in (("gate/up", ((E, cap, d), (E, d, f))), ("down", ((E, cap, f), (E, f, d)))):
            yield (arch, what, torch.randn(sa, generator=gen, device="cuda").to(torch.bfloat16),
                   (torch.randn(sb, generator=gen, device="cuda") / sb[-2] ** 0.5).to(torch.bfloat16))


def _prefill_cases(gen: torch.Generator):
    """(model, product, a, b): the MoE prefill products as the forward passes
    them, then phi3.5-moe's training gradients as the backward passes them."""
    bf16 = torch.bfloat16
    for arch in MODELS:
        cfg = get_config(arch)
        E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        cap = blocks.moe_capacity(cfg, cs.LM_BATCH * cs.LM_PROMPT)
        for what, (sa, sb) in (("gate/up", ((E, cap, d), (E, d, f))), ("down", ((E, cap, f), (E, f, d)))):
            yield (arch, what, torch.randn(sa, generator=gen, device="cuda").to(bf16),
                   (torch.randn(sb, generator=gen, device="cuda") / sb[-2] ** 0.5).to(bf16))
    cfg = get_config("phi3.5-moe-42b")
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    cap = blocks.moe_capacity(cfg, cs.TRAIN_BATCH * cs.TRAIN_SEQ)
    for what, (K, N) in (("gate/up", (d, f)), ("down", (f, d))):
        a = torch.randn((E, cap, K), generator=gen, device="cuda").to(bf16)  # the forward's operands as stored
        b = (torch.randn((E, K, N), generator=gen, device="cuda") / K**0.5).to(bf16)
        dc = torch.randn((E, cap, N), generator=gen, device="cuda").to(bf16)
        yield "phi3.5-moe-42b training", f"{what} dA = dC·Bᵀ", dc, b.transpose(1, 2)
        yield "phi3.5-moe-42b training", f"{what} dB = Aᵀ·dC", a.transpose(1, 2), dc
        del a, b, dc


def _check(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    err = (got.float() - want).abs().max().item()
    tol = cs.GEMM_TOL[torch.bfloat16]
    if not torch.allclose(got.float(), want, rtol=tol, atol=tol):
        raise RuntimeError(f"{what} disagrees with the plain version: max abs err {err}")
    return err


def _parent_blocks(n: int, e: int) -> tuple[int, int, float]:
    """The parent's decode grid at N columns and E experts: blocks, blocks an SM (shared memory), waves."""
    per_sm = SM_SMEM // (PARENT_DECODE_SMEM + BLOCK_RESERVED)
    blocks_ = -(-n // 128) * e
    return blocks_, per_sm, blocks_ / (per_sm * torch.cuda.get_device_properties(0).multi_processor_count)


def decode(libs: dict, gen: torch.Generator) -> None:
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for model, what, a, b in _decode_cases(gen):
        E, M, K = a.shape
        N = b.shape[2]
        want = gm.gemm_plain(a, b).float()
        flops, nbytes = gm.cost(a, b)
        bound_ms, bound_by = cs._bound(flops, nbytes, cs.PEAK_BF16_FLOPS)
        plan = gm.decode_plan(E, N, K, sms)
        shares = [plan.start(i + 1) - plan.start(i) for i in range(plan.blocks)]
        pblocks, per_sm, waves = _parent_blocks(N, E)
        out: dict = {"model": model, "product": what, "a": list(a.shape), "b": list(b.shape), "bound_ms": bound_ms,
                     "bound_by": bound_by, "bytes": nbytes,
                     "shipped": {"kernels": gm.decode_kernels(M), "blocks": plan.blocks,
                                 "blocks_an_sm": gm.decode_occupancy(gm.decode_mt(M)),
                                 "units_an_sm": [min(shares), max(shares)],
                                 "weight_mb_an_sm": [min(shares) * 32768 / 1e6, max(shares) * 32768 / 1e6],
                                 "split_tiles": len({pc.tile for pc in gm.decode_pieces(plan, K)
                                                     if pc.slot is not None})},
                     "parent": {"kernel": "gemm_mma_bf16_kernel<16, 128> 16-byte rows", "blocks": pblocks,
                                "blocks_an_sm (shared memory)": per_sm, "waves": waves}}
        for name in ("shipped", "parent", "parent", "shipped"):
            with _using(libs[name]):
                fn = (lambda: gm.gemm(a, b)) if name == "shipped" else (lambda: _parent_decode(a, b))
                got = fn()
                again = fn()
                torch.cuda.synchronize()
                out[f"max_abs_err {name}"] = _check(got, want, f"{model} {what} decode ({name})")
                if name == "shipped" and not torch.equal(got, again):
                    raise RuntimeError(f"{model} {what}: the decode kernels gave other bits on a second call")
                ms, ran = cs._device_ms(fn)
                out.setdefault(f"device_ms {name}", []).append(ms)
                out[f"ran {name}"] = sorted(ran)
        split = {}
        cs._device_ms(lambda: gm.gemm(a, b), times=split)
        out["kernels_ms shipped"] = {cs.GEMM_FN.search(k).group(1) if cs.GEMM_FN.search(k) else k[:60]: v
                                     for k, v in split.items()}
        for name in ("decode loads alone", "decode products alone"):
            with _using(libs[name]):
                out[f"device_ms {name}"] = cs._device_ms(lambda: gm.gemm(a, b))[0]
        out["timeline"] = _timeline(libs, a, b, sms)
        with _using(libs["decode two blocks an SM"]):
            out["max_abs_err two blocks an SM"] = _check(_decode_direct(a, b, 2 * sms)[0], want, f"{model} {what} x2")
            out["device_ms two blocks an SM"] = [cs._device_ms(lambda: _decode_direct(a, b, 2 * sms))[0]
                                                 for _ in range(2)]
        for name in ("decode tile 512, ring 3", "decode tile 128, ring 12", "decode ring 4"):
            tile = DECODE_TILES.get(PROBES[name], gm.DECODE_TILE)
            with _using(libs[name]), mock.patch.object(gm, "DECODE_TILE", tile):
                out[f"max_abs_err {name}"] = _check(gm.gemm(a, b), want, f"{model} {what} decode ({name})")
                out[f"device_ms {name}"] = [cs._device_ms(lambda: gm.gemm(a, b))[0] for _ in range(2)]
        out["bmm device_ms"] = cs._device_ms(lambda: torch.bmm(a, b))[0]
        for name in ("shipped", "parent"):
            best = min(out[f"device_ms {name}"])
            out[f"{name} / bmm"] = best / out["bmm device_ms"]
            out[f"{name} share of the bound"] = bound_ms / best
        out["bmm share of the bound"] = bound_ms / out["bmm device_ms"]
        # with the L2 cold before each call (the decode step's condition), in turns
        for name, fn in (("shipped", lambda: gm.gemm(a, b)), ("bmm", lambda: torch.bmm(a, b)),
                         ("bmm", lambda: torch.bmm(a, b)), ("shipped", lambda: gm.gemm(a, b))):
            out.setdefault(f"cold device_ms {name}", []).append(cs._cold_device_ms(fn))
        with _using(libs["parent"]):
            out["cold device_ms parent"] = cs._cold_device_ms(lambda: _parent_decode(a, b))
        out["cold shipped / bmm"] = min(out["cold device_ms shipped"]) / min(out["cold device_ms bmm"])
        print(json.dumps(out))
        del a, b, want
    # the parent's kernel on grids of whole waves: every SM an equal share of its blocks
    cfg = get_config("phi3.5-moe-42b")
    E, d = cfg.n_experts, cfg.d_model
    a = torch.randn((E, 8, d), generator=gen, device="cuda").to(torch.bfloat16)
    for n in (cfg.d_ff, 5248, 10496):
        b = (torch.randn((E, d, n), generator=gen, device="cuda") / d**0.5).to(torch.bfloat16)
        flops, nbytes = gm.cost(a, b)
        bound_ms, _ = cs._bound(flops, nbytes, cs.PEAK_BF16_FLOPS)
        pblocks, per_sm, waves = _parent_blocks(n, E)
        with _using(libs["parent"]):
            _check(_parent_decode(a, b), gm.gemm_plain(a, b).float(), f"parent decode at N {n}")
            ms = cs._device_ms(lambda: _parent_decode(a, b))[0]
        print(json.dumps({"parent waves": {"a": list(a.shape), "b": list(b.shape), "blocks": pblocks,
                                           "waves": waves, "device_ms": ms, "bound_ms": bound_ms,
                                           "share of the bound": bound_ms / ms}}))
        del b
    torch.cuda.empty_cache()


def prefill(libs: dict, gen: torch.Generator) -> None:
    order = ["shipped", "parent", "parent", "shipped", *(n for n, p in PROBES.items() if p and p <= 6)]
    for model, what, a, b in _prefill_cases(gen):
        want = gm.gemm_plain(a, b).float()
        out: dict = {"model": model, "product": what, "a": list(a.shape), "b": list(b.shape),
                     "majors": list(gm.majors(a, b))}
        for name in order:
            with _using(libs[name]):
                got = gm.gemm(a, b)
                torch.cuda.synchronize()
                if PROBES[name] not in WRONG:
                    out[f"max_abs_err {name}"] = _check(got, want, f"{model} {what} ({name})")
                out.setdefault(f"device_ms {name}", []).append(cs._device_ms(lambda: gm.gemm(a, b))[0])
        out["shipped / parent"] = sum(out["device_ms shipped"]) / sum(out["device_ms parent"])
        out["bmm device_ms"] = cs._device_ms(lambda: torch.bmm(a, b))[0]
        print(json.dumps(out))
        del a, b, want


def main() -> int:
    _parent_source()
    if not torch.cuda.is_available():
        print("gemm_probe: no CUDA device visible", file=sys.stderr)
        return 1
    print(f"[card] {cs._card()}")
    libs, logs = _build()
    for name in ("shipped", "parent"):
        for kernel, (regs, st, ld) in sorted(cs._ptxas_entries_of(
                logs[name], r"(gemm_(?:decode_bf16|decode_sum|mma_bf16)_kernelI(?:Li\d+E|Lb[01]E)+E)").items()):
            print(f"[ptxas] {name}: {kernel}: {regs} registers, spill stores {st} B, spill loads {ld} B")
    waits = [line for line in logs["shipped"].splitlines() if "(C751" in line]
    print(f"[ptxas] shipped: wgmma waits (C7517, C7518): {waits}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    decode(libs, gen)
    prefill(libs, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
