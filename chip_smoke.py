"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Fails (non-zero exit, no result line) when no CUDA device is visible or the
repository's sources are not beside this script.  Otherwise, in order:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every CUDA kernel of the port from the sources in the checkout
   (one ``nvcc`` per source, all at once) and prints ``ptxas -v``'s
   registers, shared memory and spills; fails unless the tensor-core flash
   kernel ``flash_fwd_mma_bf16_kernel`` compiled at every head dim with no
   spill, and unless the GEMM's ``gemm_wgmma_bf16_kernel`` compiled with no
   spill and no ``wgmma`` made to wait by ``ptxas`` (C7517, C7518), and
   unless every conv kernel (each tile of ``im2col_conv.TILES``, 16-byte
   and 4-byte copies, and the split sum) compiled with no spill, printing
   the blocks of each one SM holds, and unless the tensor-core SSD scan
   ``ssd_scan_mma_bf16_kernel`` compiled at every state width and p tile
   with no spill, asks the shared memory the wrapper counts and splits its
   inexact operands into the wrapper's ``MMA_TERMS`` bf16 terms, printing
   its registers and blocks an SM;
3. holds each kernel against its plain PyTorch version on the card, at every
   distinct layer shape of full-width SynthNet (microbatch of 2 images) and
   at the reference kernel tests' shapes plus a ragged K, in fp32 with TF32
   off (tolerance 3e-4 absolute and relative, the reference's), and the
   conv against itself over two calls (the same bits); prints each shape's
   plan (tile, splits, blocks) and fails if a SynthNet shape launches fewer
   blocks than the card has SMs; times the kernel, the plain version and
   cuDNN's ``F.conv2d`` (``cudnn.benchmark`` off, and on as
   ``library_best_ms``) on the SynthNet shapes by CUDA events, the kernel
   and cuDNN also by the profiler's device time and by the host's time to
   issue a call, and computes each shape's bound on the H100 SXM;
4. drives the main path — ``launch.serve_cnn.serve_cnn`` at full width:
   measure each layer, Shisha H3, 4-stage stream pipeline of 8 microbatches,
   straggler rebalance — with every launch count set to 0 just before and
   read just after; fails if a kernel of the path never launched;
5. checks the pipelined output: equal to the sequential model on the same
   kernels, and within 1e-3 of the output's largest magnitude of the
   sequential model computed with the plain versions (18 fp32 layers with
   reductions of up to 30976 terms summed in another order); then the
   paper's Fig. 4 race on the measured oracle of phase 4 (full-width
   SynthNet, each layer timed on the hand-written conv, the 4-EP platform of
   streams): Shisha H3, HC, HC from Shisha's seed, SA, SA from the seed and
   RW, each with RACE_BUDGET times Shisha's simulated wall, and Pipe-Search
   and ES paying the database's generation cost up front, ES over the whole
   space (19,792 configurations); prints each arm's trials, simulated time
   to 99% of its final best, best modelled throughput, its ratio to ES's and
   host seconds, and fails if any arm's best exceeds ES's; runs the best
   splits of Shisha, HC and SA as stream pipelines and prints their measured
   microbatches/s (no limit);
6. LM serving kernels: holds ``flash_attention`` and ``ssd_scan`` against
   their plain versions on the card at the LM main path's shapes in bf16
   (prefill attention of every served attention model, causal, q/k/v as
   the model's views: granite-3-2b q [4,32,512,64], k/v [4,8,512,64];
   phi3.5-moe-42b q [4,32,512,128], llama4-scout-17b q [4,40,512,128],
   k/v [4,8,512,128]; zamba2-2.7b's shared block q/k/v [4,32,512,80];
   nemotron-4-340b q [4,96,512,192], k/v [4,8,512,192]; the prefill scan
   of mamba2-130m, x [4,512,24,64],
   B/C [4,512,128], and of zamba2-2.7b, x [4,512,80,64], B/C [4,512,64],
   chunk 64, x, B and C strided as ``ssd_block`` passes them) and at
   the reference tests' shapes in fp32 at the reference's tolerances (2e-4
   attention, 2e-3 SSD), plus a ragged length, a sliding window, a
   non-causal case, a ragged p tile and strided inputs, the same at head
   dims 80 and 192 in fp32, bf16 attention cases that reach every branch
   of the tensor-core kernel (every head dim, GQA groups 1, 4, 5 and 12, S
   of 1, 15, 65 and 1000, a window of 7, non-causal), and bf16 SSD cases
   that reach every branch of the
   tensor-core scan (chunks 16, 32 and 64, state 64 and 128, p 64, 48 and
   16, one chunk, contiguous and strided), each also at every p tile of
   ``ssd_scan.mma_plans``, and bf16 at chunk 8 on the SIMT
   scan; bf16 y and final state are held within BF16_REL_TOL of max
   |plain|; fails unless both SSD model shapes plan the tensor-core scan on
   at least a block per SM and the profiler shows it ran; times the
   kernel, the plain version and (attention, at each model's shape) SDPA,
   naming the device kernel that served SDPA, and computes each bound.
   Every time in the ``kernels`` line is by CUDA events around 20 calls;
   attention and the SSD scan also get the profiler's device time per call
   and the host's time to issue a call (their wrappers take the host about
   as long to issue as the card to run), and attention the same for SDPA;
7. drives the LM main path — ``launch.serve.serve`` at full width on
   ``cuda``, bf16, batch 4, prompt 512, 32 generated tokens — for
   granite-3-2b, mamba2-130m and zamba2-2.7b at full depth and
   nemotron-4-340b at 2 of its 96 layers, every launch count set to 0
   just before each and read just after; fails if the path's kernel never
   launched or the tokens are out of range; then times a warm prefill and
   warm decode steps on the host clock and prints a profiler breakdown
   (device time by kernel, busy share of the wall) of one prefill and of
   four decode steps; fails unless an attention model's bf16 prefill ran
   ``flash_fwd_mma_bf16_kernel`` once per attention layer (zamba2: once
   per application of its shared block, 9) and never the fp32 SIMT
   ``flash_fwd_kernel``, and unless an SSD model's ran
   ``ssd_scan_mma_bf16_kernel`` once per layer and never ``ssd_scan_kernel``;
8. holds each LM path against the same path on the plain versions
   (``ops.flash_attention`` / ``ops.ssd_scan`` / ``ops.gemm`` swapped here,
   and only here): prefill plus 4 teacher-forced decode steps on the kernel
   path's tokens, logits compared relative to the largest |logit|, in bf16
   and with the same weights in fp32 (nemotron-4-340b at 1 layer: its
   fp32 weights take 51.5 GB, made as its bf16 ones are freed), held to
   LM_TOL; for an SSD model (mamba2-130m, zamba2-2.7b) in
   bf16 every prefill scan of the kernel path is also held to BF16_REL_TOL
   against the plain version on the same inputs, and its logits are held to
   LM_TOL with the bf16 scan in the model in fp32 at every layer, where a
   control scan that rounds toward zero must miss LM_TOL (see SSD_LAYERS;
   the bf16 model's logits are printed); a logits comparison that misses
   LM_TOL, or a control that meets it, fails the run after every later
   phase has run and the ``kernels`` line is printed;
9. the MoE expert GEMM (checked with phase 6): holds ``gemm`` against
   ``gemm_plain`` on the reference tests' grid (fp32 at 2e-4, bf16 at 6e-2,
   the reference's tolerances), at capacities around the wgmma tile's
   edges (M 17, 100, 321, K 4104, N 6408 and 6392, batch 1 and 16: an odd
   and an even count of column tiles), on a layer slice
   of a stacked expert tensor, and at the MoE main path's shapes in bf16
   (phi3.5-moe prefill capacity 320 and decode capacity 8, llama4-scout
   prefill capacity 160 and decode capacity 8, 16 experts in one launch);
   at each main shape fails unless prefill ran ``gemm_wgmma_bf16_kernel``
   and decode ``gemm_mma_bf16_kernel``, and times the kernel, the plain
   version and ``torch.bmm`` (cuBLAS) by CUDA events and by the profiler's
   device time, with its FLOPs, bytes and bound;
10. drives MoE serving like phase 7, with the ``gemm`` launch count beside
   the others: phi3.5-moe-42b at 16 of its 32 layers and llama4-scout-17b at
   4 of its 48, both at full width (full depth does not fit the card's
   80 GB; these depths, well below what would fit, keep the run short);
   fails unless each profiled bf16 prefill ran ``gemm_wgmma_bf16_kernel``
   three times a layer (gate, up, down) and never ``gemm_mma_bf16_kernel``;
   phase 8 for both, the fp32 comparison at 2 layers (fp32 weights of 16
   layers would need 84 GB), and the share of (token, expert) assignments
   that the kernel and plain paths route alike, held to ROUTE_FLOOR (see
   MOE_ROUTES for the logits check where they differ);
11. prints the per-kernel JSON line (the ``flash_attention`` row is
   granite-3-2b's, naming the device function that served its prefill,
   with every other served attention model's times, bound, SDPA times and
   launches under keys that name the model; the ``ssd_scan`` row is
   mamba2-130m's scan, with its device function, device and host times,
   and zamba2-2.7b's times and launches under keys that name it), then
   ``{"ok": true, "device": ...}`` last.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))  # the port, from this checkout

from repro_torch.configs import get_config
from repro_torch.core import (
    Trace,
    database_generation_cost,
    exhaustive_search,
    generate_seed,
    hill_climbing,
    pipe_search,
    random_walk,
    run_shisha,
    simulated_annealing,
    space_size,
    weights,
)
from repro_torch.kernels import build, im2col_conv, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gemm as gm
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.launch.serve import make_prompt, serve
from repro_torch.launch.mesh import make_stage_mesh
from repro_torch.launch.serve_cnn import BATCH, N_MICRO, serve_cnn
from repro_torch.models import blocks, transformer
from repro_torch.models.lm_common import init_params
from repro_torch.models.cnn import synthnet_specs
from repro_torch.pipeline import PipelineRunner, pipeline_throughput
from repro_torch.pipeline.hetero import H100_FP32_FLOPS as PEAK_FP32_FLOPS
from repro_torch.pipeline.hetero import H100_HBM_BW as HBM_BYTES_PER_S

#: kernel-vs-plain tolerance on one conv (the reference's conv test)
KERNEL_TOL = 3e-4
#: pipelined-vs-plain tolerance over the 18-layer chain, relative to max |output|
CHAIN_TOL = 1e-3
#: dense bf16 tensor-core peak of the H100 SXM (NVIDIA's data sheet)
PEAK_BF16_FLOPS = 989e12
#: kernel-vs-plain in fp32: the reference's kernel-test tolerances
ATTN_TOL, SSD_TOL = 2e-4, 2e-3
#: kernel-vs-plain in bf16, max |kernel - plain| over max |plain|: both keep
#: fp32 inside and differ by where the output (and, for attention, p) is
#: rounded to bf16, 2^-8 relative each, so 1e-2 leaves about 2.5 roundings
BF16_REL_TOL = 1e-2
#: LM logits, kernel path against plain path, relative to max |logit|: fp32
#: differs only by summation order through 24-40 layers; bf16 by the
#: roundings above at every layer, carried through the residual stream
LM_TOL = {torch.float32: 1e-3, torch.bfloat16: 5e-2}
# MOE_ROUTES: MoE logits are held to LM_TOL too, on one set of routes.  A
# router whose top choices nearly tie can pick other experts when its input
# differs by rounding, and a token sent elsewhere gets another FFN output,
# not a rounding of the same one.  In bf16 the two paths route 99.4% of
# phi3.5-moe's (token, expert) assignments alike in its first layer, 85% in
# its 16th (NVIDIA H100 80GB HBM3, 700 W), and their logits then differ by
# 46% of max |logit|.  So where any assignment differs, drive_lm prints that
# share and that error, and checks the plain path again with the kernel
# path's routes replayed (its own router probabilities as gates).  The share
# itself is held to ROUTE_FLOOR, so that a change that moves many more
# routes fails.
# SSD_LAYERS: for a bf16 SSD model every prefill scan of the kernel path is
# also held to BF16_REL_TOL against the plain version on the same inputs, y
# and final state.  Its logits are held to LM_TOL with the model in fp32,
# weights and activations, and each scan in bf16 (x, B and C rounded to
# bf16 on the way in, its bf16 output widened on the way out) in both
# paths: the tensor-core scan at every layer, its roundings carried through
# the residual stream.  In the model in bf16 they are printed, not held:
# mamba2-130m's random-weight bf16 logits at its 24 layers move by 0.07 to
# 0.17 of max |logit| whenever a scan's bf16 output differs from the plain
# version's in 1.8e-4 or more of its elements, whatever the cause: the
# plain version's own arithmetic in another fp32 order, its output times
# 1 + 1e-6, or a biased scan, so no limit there tells an exact scan from a
# biased one.  With the other ops in fp32 the same comparison reads 0.016
# to 0.028 for the tensor-core scan and for plain's arithmetic in another
# order, and 0.082 to 0.135 for plain rounded toward zero
# (scripts/ssd_lm_sensitivity.py --model bf16 mixed, seeds 0 and 1,
# PERF.md).  So that scan, biased by half a rounding on average and each
# output within one rounding of plain's, runs through the same comparison
# as a control, and the run fails if it meets LM_TOL.
#: least routing agreement, kernel path against plain path: in the first MoE
#: layer, whose inputs differ only by attention's rounding (measured 0.994
#: phi3.5-moe, 0.997 llama4-scout, bf16), and over every MoE call of the run
#: (measured 0.908 and 0.983; 1.000 for both in fp32)
ROUTE_FLOOR = {"first layer": 0.98, "all calls": 0.85}
#: kernel-vs-plain for the GEMM: the reference's kernel-test tolerances (allclose)
GEMM_TOL = {torch.float32: 2e-4, torch.bfloat16: 6e-2}
#: the LM main path: per model the kernels it must launch, the depth served
#: (None: the config's) and the depth of the fp32 comparison (None: served
#: depth).  nemotron-4-340b's embedding and head take 18.9 GB in bf16 and
#: each layer 6.9 GB; its fp32 comparison at 1 layer takes 51.5 GB.
LM_MODELS = {
    "granite-3-2b": (("flash_attention",), None, None),
    "mamba2-130m": (("ssd_scan",), None, None),
    "phi3.5-moe-42b": (("flash_attention", "gemm"), 16, 2),
    "llama4-scout-17b": (("flash_attention", "gemm"), 4, 2),
    "zamba2-2.7b": (("ssd_scan", "flash_attention"), None, None),
    "nemotron-4-340b": (("flash_attention",), 2, 1),
}
LM_BATCH, LM_PROMPT, LM_GEN, LM_FORCED = 4, 512, 32, 4
#: the port's CUDA kernel functions, as the profiler names them
PORT_KERNELS = ("flash_fwd_mma_bf16_kernel", "flash_fwd_kernel", "ssd_scan_mma_bf16_kernel", "ssd_scan_kernel",
                "gemm_wgmma_bf16_kernel", "gemm_mma_bf16_kernel", "gemm_fma_f32_kernel")
#: the two flash kernels as the profiler names them: bf16 on the tensor cores, fp32 on the SIMT pipes
FLASH_FN = re.compile(r"\(anonymous namespace\)::((?:flash_fwd_mma_bf16_kernel|flash_fwd_kernel)<[^>]*>)")
#: the GEMM's kernels as the profiler names them (wgmma, mma.sync tiles, fp32 FMA)
GEMM_FN = re.compile(r"\(anonymous namespace\)::(gemm_\w+_kernel(?:<[^>]*>)?)")
#: the SSD scan's kernels as the profiler names them: bf16 on the tensor cores, the SIMT one
SSD_FN = re.compile(r"\(anonymous namespace\)::(ssd_scan(?:_mma_bf16)?_kernel<[^>]*>)")
#: profiler windows a device-time reading takes at most: the profiler can
#: keep some or none of a window's device records
#: (``scripts/profiler_windows.py`` counts how often)
PROFILER_WINDOWS = 8
#: the Mamba2-family models whose prefill scan phase 6 times, both served
#: (LM_MODELS): state widths 128 and 64
SSD_MODELS = ("mamba2-130m", "zamba2-2.7b")
#: the comparison arms' online budget in the race, in multiples of Shisha's
#: simulated wall (the paper's "35x faster")
RACE_BUDGET = 35


def _time_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _ptxas_entries(source: str, mangled: str) -> dict[str, tuple[int, int, int]]:
    """Registers, spill-store and spill-load bytes of each function of
    ``source`` whose mangled name matches ``mangled`` (the first group names
    it), from ``ptxas -v``."""
    lines = build.ptxas_report(source).splitlines()
    seen = {}
    for i, line in enumerate(lines):
        name = re.search(mangled, line)
        if "Compiling entry function" not in line or not name:
            continue
        props = " ".join(lines[i + 1 : i + 4])
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", props)
        regs = re.search(r"Used (\d+) registers", props)
        seen[name.group(1)] = (int(regs.group(1)), int(spill.group(1)), int(spill.group(2)))
    return seen


def check_flash_ptxas() -> None:
    """Fail unless ``ptxas`` compiled ``flash_fwd_mma_bf16_kernel`` at every
    head dim with no spill; print its registers."""
    seen = {int(d): v for d, v in _ptxas_entries("flash_attention", r"flash_fwd_mma_bf16_kernelILi(\d+)EE").items()}
    for d, (regs, st, ld) in sorted(seen.items()):
        print(f"[build] flash_fwd_mma_bf16_kernel<{d}>: {regs} registers, spill stores {st} B, spill loads {ld} B")
    if sorted(seen) != list(fa.HEAD_DIMS):
        raise RuntimeError(f"ptxas compiled flash_fwd_mma_bf16_kernel at head dims {sorted(seen)}, want {fa.HEAD_DIMS}")
    spilled = {d: v for d, v in seen.items() if v[1] or v[2]}
    if spilled:
        raise RuntimeError(f"flash_fwd_mma_bf16_kernel spills: {spilled}")


def check_gemm_ptxas() -> None:
    """Fail unless ``ptxas`` compiled ``gemm_wgmma_bf16_kernel`` with no
    spill and without making its ``wgmma`` wait: C7518 (a wgmma under a
    branch ptxas cannot prove warp-uniform is serialised) and C7517 (a
    wait injected where other code touches registers a wgmma in flight
    defines); print its registers."""
    seen = {int(c): v for c, v in _ptxas_entries("gemm", r"gemm_wgmma_bf16_kernelILi(\d+)EE").items()}
    for cluster, (regs, st, ld) in sorted(seen.items()):
        print(f"[build] gemm_wgmma_bf16_kernel<{cluster}>: {regs} registers, spill stores {st} B, spill loads {ld} B")
    if sorted(seen) != [1, 2]:
        raise RuntimeError(f"ptxas compiled gemm_wgmma_bf16_kernel for clusters of {sorted(seen)}, want [1, 2]")
    spilled = {c: v for c, v in seen.items() if v[1] or v[2]}
    if spilled:
        raise RuntimeError(f"gemm_wgmma_bf16_kernel spills: {spilled}")
    waits = [line for line in build.ptxas_report("gemm").splitlines()
             if re.search(r"\(C751[78]\)", line) and "gemm_wgmma_bf16_kernel" in line]
    if waits:
        raise RuntimeError(f"ptxas made the wgmma of gemm_wgmma_bf16_kernel wait: {waits}")


def ssd_ptxas() -> dict[tuple[int, int], tuple[int, int, int]]:
    """Registers, spill-store and spill-load bytes of ``ssd_scan_mma_bf16_kernel``
    by (state width, p tile), from ``ptxas -v``; fails unless the bf16
    terms it splits each inexact operand into are the wrapper's and the
    wrapper's shared-memory size agrees with the source's.  Prints each one
    with the blocks of it one SM holds at chunk 64."""
    lib = ssd.library()
    lib.ssd_scan_mma_terms.restype = ctypes.c_int
    if lib.ssd_scan_mma_terms() != ssd.MMA_TERMS:
        raise RuntimeError(f"ssd_scan_mma_bf16_kernel splits into {lib.ssd_scan_mma_terms()} bf16 terms, the "
                           f"wrapper says {ssd.MMA_TERMS}")
    fn = lib.ssd_scan_mma_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    out = {}
    for name, (regs, st, ld) in sorted(_ptxas_entries("ssd_scan", r"(ssd_scan_mma_bf16_kernelILi\d+ELi\d+EE)").items()):
        n, pt = (int(v) for v in re.match(r"ssd_scan_mma_bf16_kernelILi(\d+)ELi(\d+)EE", name).groups())
        out[n, pt] = (regs, st, ld)
        for chunk in ssd.MMA_CHUNKS:
            if fn(n, pt, chunk) != ssd.mma_smem_bytes(chunk, n, pt):
                raise RuntimeError(f"ssd_scan_mma_bf16_kernel<{n}, {pt}> at chunk {chunk}: the source asks "
                                   f"{fn(n, pt, chunk)} B of shared memory, the wrapper counts "
                                   f"{ssd.mma_smem_bytes(chunk, n, pt)}")
        print(f"[build] ssd_scan_mma_bf16_kernel<{n}, {pt}>: {regs} registers, spill stores {st} B, "
              f"spill loads {ld} B, {ssd.occupancy(n, pt, 64)} blocks an SM at chunk 64 "
              f"({ssd.mma_smem_bytes(64, n, pt)} B of shared memory)")
    return out


def check_ssd_ptxas() -> None:
    """Fail unless ``ptxas`` compiled ``ssd_scan_mma_bf16_kernel`` at every
    state width and p tile with no spill (:func:`ssd_ptxas`)."""
    seen = ssd_ptxas()
    want = {(n, pt) for n in ssd.MMA_STATES for pt in ssd.MMA_P_TILES}
    if set(seen) != want:
        raise RuntimeError(f"ptxas compiled ssd_scan_mma_bf16_kernel for {sorted(seen)}, want {sorted(want)}")
    spilled = {k: v for k, v in seen.items() if v[1] or v[2]}
    if spilled:
        raise RuntimeError(f"ssd_scan_mma_bf16_kernel spills (state width, p tile): {spilled}")


def check_conv_ptxas() -> None:
    """Fail unless ``ptxas`` compiled ``conv2d_im2col_kernel`` for every
    tile of ``im2col_conv.TILES`` with 16-byte and with 4-byte copies, and
    the split sum, with no spill; print each kernel's registers and the
    blocks of it one SM holds at once."""
    seen = _ptxas_entries("conv2d_im2col", r"(conv2d_im2col_kernelILi\d+ELi\d+ELb[01]EE|conv_split_sum_kernel)")
    want = {f"conv2d_im2col_kernelILi{bm}ELi{bn}ELb{v}EE" for bm, bn in im2col_conv.TILES for v in (0, 1)}
    want.add("conv_split_sum_kernel")
    for name, (regs, st, ld) in sorted(seen.items()):
        tile = re.match(r"conv2d_im2col_kernelILi(\d+)ELi(\d+)ELb([01])EE", name)
        occ = ""
        if tile:
            bm, bn, v = (int(g) for g in tile.groups())
            name = f"conv2d_im2col_kernel<{bm}, {bn}, {'16-byte' if v else '4-byte'} copies>"
            occ = f", {im2col_conv.occupancy(bm, bn, bool(v))} blocks an SM"
        print(f"[build] {name}: {regs} registers, spill stores {st} B, spill loads {ld} B{occ}")
    if set(seen) != want:
        raise RuntimeError(f"ptxas compiled conv kernels {sorted(seen)}, want {sorted(want)}")
    spilled = {n: v for n, v in seen.items() if v[1] or v[2]}
    if spilled:
        raise RuntimeError(f"conv kernels spill: {spilled}")


def _conv_shapes(specs, batch: int) -> list[dict]:
    """Distinct (x, w, stride) shapes the layers give the conv, with the
    layers that share each."""
    shapes: dict[tuple, dict] = {}
    for sp in specs:
        in_h = sp.h_out * sp.stride
        key = ((batch, in_h, in_h, sp.c_in), (sp.r, sp.s, sp.c_in, sp.k), sp.stride)
        shapes.setdefault(key, {"x": key[0], "w": key[1], "stride": sp.stride, "layers": []})
        shapes[key]["layers"].append(sp.name)
    return list(shapes.values())


def conv_inputs(sh: dict, gen: torch.Generator) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Random x and w (scaled by 1/sqrt(R*S*C)) of one conv shape, on the card."""
    x = torch.randn(sh["x"], generator=gen, device="cuda")
    r, s, c, _ = sh["w"]
    w = torch.randn(sh["w"], generator=gen, device="cuda") / (r * s * c) ** 0.5
    return x, w, sh["stride"]


def cudnn_conv(x: torch.Tensor, w: torch.Tensor, stride: int):
    """cuDNN's ``F.conv2d`` on the same conv as a call: NCHW views of the
    NHWC data, padded beforehand (asymmetric SAME padding is not one
    ``F.conv2d`` argument)."""
    r, s = w.shape[:2]
    _, _, pt, pb, pl, pr = im2col_conv.same_padding(x.shape[1], x.shape[2], r, s, stride)
    xp = F.pad(x, (0, 0, pl, pr, pt, pb)).permute(0, 3, 1, 2)
    wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return lambda: F.conv2d(xp, wl, stride=stride)


def cudnn_ms(x: torch.Tensor, w: torch.Tensor, stride: int, device: bool = False) -> tuple[float, float]:
    """:func:`cudnn_conv`'s time (TF32 off), by CUDA events: with
    ``cudnn.benchmark`` off (the algorithm its heuristic picks:
    ``library_ms``) and on (the fastest one it finds by timing:
    ``library_best_ms``), then the setting restored; with ``device``, by the
    profiler's device time instead (``_device_ms``)."""
    call = cudnn_conv(x, w, stride)
    before = torch.backends.cudnn.benchmark
    def timer(fn):
        return _device_ms(fn, need=False)[0] if device else _time_ms(fn)

    try:
        torch.backends.cudnn.benchmark = False
        plain = timer(call)
        torch.backends.cudnn.benchmark = True
        best = timer(call)
    finally:
        torch.backends.cudnn.benchmark = before
    return plain, best


def check_conv(gen: torch.Generator) -> dict:
    """Phase 3 for ``conv2d_im2col``: parity everywhere, the same bits over
    two calls, each SynthNet shape's plan, times on SynthNet."""
    synth = _conv_shapes(synthnet_specs(), batch=BATCH)
    extra = [
        {"x": (2, 12, 12, 8), "w": (r, r, 8, 24), "stride": st, "layers": []}
        for r in (1, 3, 5)
        for st in (1, 2)
    ] + [
        {"x": (3, 13, 11, 5), "w": (3, 3, 5, 67), "stride": 1, "layers": []},  # ragged K, M, C
        {"x": (2, 20, 20, 8), "w": (11, 11, 8, 17), "stride": 4, "layers": []},  # 11x11 stride 4, ragged K
    ]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows, max_err = [], 0.0
    for sh in synth + extra:
        x, w, st = conv_inputs(sh, gen)
        r, s, c, k = sh["w"]
        y = im2col_conv.conv2d_im2col(x, w, stride=st)
        again = im2col_conv.conv2d_im2col(x, w, stride=st)
        yp = im2col_conv.conv2d_im2col_plain(x, w, stride=st)
        torch.cuda.synchronize()
        err = (y - yp).abs().max().item()
        max_err = max(max_err, err)
        if not torch.allclose(y, yp, rtol=KERNEL_TOL, atol=KERNEL_TOL):
            raise RuntimeError(f"conv2d_im2col disagrees with its plain version at {sh}: max abs err {err}")
        if not torch.equal(y, again):
            raise RuntimeError(f"conv2d_im2col gave other bits on a second call at {sh}")
        p = im2col_conv.plan(tuple(x.shape), tuple(w.shape), st, sms=sms)
        row = {"x": list(sh["x"]), "w": list(sh["w"]), "stride": st, "max_abs_err": err,
               "plan": {"tile": f"{p.bm}x{p.bn}", "thread": f"{p.tm}x{p.tn}", "splits": p.splits,
                        "blocks": p.blocks, "copies": 16 if p.vector else 4}}
        if sh["layers"]:
            if p.blocks < sms:
                raise RuntimeError(f"plan {p} launches {p.blocks} blocks on {sms} SMs at {sh}")
            n, h, wd, _ = sh["x"]
            ho, wo = -(-h // st), -(-wd // st)
            flops = 2.0 * n * ho * wo * k * r * s * c
            nbytes = 4.0 * (x.numel() + w.numel() + y.numel())
            lib_ms, lib_best_ms = cudnn_ms(x, w, st)
            row.update(
                layers=sh["layers"],
                flops=flops,
                bytes=nbytes,
                bound_ms=max(flops / PEAK_FP32_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3,
                bound_by="operations" if flops / PEAK_FP32_FLOPS >= nbytes / HBM_BYTES_PER_S else "bytes",
                ms=_time_ms(lambda: im2col_conv.conv2d_im2col(x, w, stride=st)),
                plain_ms=_time_ms(lambda: im2col_conv.conv2d_im2col_plain(x, w, stride=st)),
                library_ms=lib_ms,
                library_best_ms=lib_best_ms,
                device_ms=_device_ms(lambda: im2col_conv.conv2d_im2col(x, w, stride=st))[0],
                library_device_ms=cudnn_ms(x, w, st, device=True)[0],
                host_ms=_host_ms(lambda: im2col_conv.conv2d_im2col(x, w, stride=st)),
                library_host_ms=_host_ms(cudnn_conv(x, w, st)),
            )
            row["tflops"] = flops / row["ms"] / 1e9
        rows.append(row)
        print(f"[check] conv2d_im2col {json.dumps(row)}")

    # one forward of full-width SynthNet at a microbatch of 2: each shape
    # weighted by the number of layers that run it
    fwd = [r for r in rows if "layers" in r]
    tot = {key: None if any(r[key] is None for r in fwd) else sum(len(r["layers"]) * r[key] for r in fwd)
           for key in ("flops", "bytes", "ms", "plain_ms", "library_ms", "library_best_ms", "device_ms",
                       "library_device_ms")}
    t_ops, t_bytes = tot["flops"] / PEAK_FP32_FLOPS, tot["bytes"] / HBM_BYTES_PER_S
    return {
        "name": "conv2d_im2col",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/conv2d_im2col.cu",
        "replaces": "src/repro/kernels/im2col_conv.py:48",
        "max_abs_err": max_err,
        "ms": tot["ms"],
        "plain_ms": tot["plain_ms"],
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": tot["library_ms"],
        "library_best_ms": tot["library_best_ms"],
        "device_ms": tot["device_ms"],
        "library_device_ms": tot["library_device_ms"],
    }


def time_to_converge(trace: Trace, final_frac: float = 0.99) -> float:
    """Simulated wall time when the best-so-far throughput first reaches
    ``final_frac`` of its final value (``benchmarks/fig4_convergence.py``'s
    definition)."""
    curve = trace.convergence_curve()
    if not curve:
        return float("inf")
    final = curve[-1][1]
    for t, tp in curve:
        if tp >= final_frac * final:
            return t
    return curve[-1][0]


def race(res) -> None:
    """Phase 5's race: the paper's Fig. 4 comparison on the measured oracle
    of phase 4 (``res.evaluator``: every SynthNet layer timed on the card).
    Shisha H3 first; HC, HC from Shisha's seed, SA, SA from the seed and RW
    each get RACE_BUDGET times Shisha's simulated wall; Pipe-Search and ES
    pay the database's generation cost up front, ES over the whole space.
    Fails if an arm's best modelled throughput exceeds ES's, which covers
    the whole space on the same deterministic oracle.  Then runs the best
    splits of Shisha, HC and SA as stream pipelines."""
    ev = res.evaluator
    n, n_eps, ws = len(ev.layers), ev.platform.n_eps, weights(ev.layers)
    traces, results, host = {}, {}, {}

    def run(name, trace, fn):
        t0 = time.perf_counter()
        results[name] = fn(trace)
        host[name] = time.perf_counter() - t0
        traces[name] = trace

    run("Shisha", Trace(ev), lambda tr: run_shisha(ws, tr, "H3").result)
    budget = RACE_BUDGET * traces["Shisha"].wall
    seed_conf = generate_seed(ws, ev.platform, choice="rank_w").conf
    run("HC", Trace(ev), lambda tr: hill_climbing(tr, n, budget, seed=0))
    run("HC_s", Trace(ev), lambda tr: hill_climbing(tr, n, budget, start=seed_conf, seed=0))
    run("SA", Trace(ev), lambda tr: simulated_annealing(tr, n, budget, seed=0))
    run("SA_s", Trace(ev), lambda tr: simulated_annealing(tr, n, budget, start=seed_conf, seed=0))
    run("RW", Trace(ev), lambda tr: random_walk(tr, n, budget, seed=0))
    db = database_generation_cost(n, n_eps)
    run("PS", Trace(ev, setup_cost=db), lambda tr: pipe_search(tr, ws, budget_s=db + budget))
    run("ES", Trace(ev, setup_cost=db), lambda tr: exhaustive_search(tr, n))
    if traces["ES"].n_trials != space_size(n, n_eps):
        raise RuntimeError(f"ES tried {traces['ES'].n_trials} of {space_size(n, n_eps)} configurations")
    es = results["ES"].best_throughput
    table = {}
    for name, r in results.items():
        table[name] = {"trials": traces[name].n_trials, "time_to_converge_s": time_to_converge(traces[name]),
                       "wall_s": traces[name].wall, "best_micro_per_s": r.best_throughput,
                       "best_over_es": r.best_throughput / es, "host_s": host[name],
                       "best_conf": r.best_conf.pretty([ep.name for ep in ev.platform.eps])}
        print(f"[race] {name}: {json.dumps(table[name])}")
    print(f"[race] budget {budget:.3f} s simulated ({RACE_BUDGET}x Shisha's wall), database "
          f"{db:.3f} s, whole space {space_size(n, n_eps)} configurations")
    over = {name: row["best_micro_per_s"] for name, row in table.items() if row["best_micro_per_s"] > es}
    if over:
        raise RuntimeError(f"arms beat the exhaustive optimum {es} on the same oracle: {over}")
    for name in ("Shisha", "HC", "SA"):  # the chosen splits, run for real
        conf = results[name].best_conf
        runner = PipelineRunner(mesh=make_stage_mesh(conf.depth, res.micro.device), conf=conf,
                                apply_layer=res.model.apply_layer, n_micro=N_MICRO)
        table[name]["measured_micro_per_s"] = pipeline_throughput(runner, res.micro)
        print(f"[race] {name}'s split {table[name]['best_conf']} as a stream pipeline: measured "
              f"{table[name]['measured_micro_per_s']:.3f} micro/s, modelled {table[name]['best_micro_per_s']:.3f}")


def _bound(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _agree(name: str, case, got: torch.Tensor, want: torch.Tensor, tol: float | None) -> float:
    """allclose at ``tol`` (fp32 inputs); with ``tol=None`` (bf16 inputs) the
    max error within BF16_REL_TOL of max |want|."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    if tol is not None:
        ok = torch.allclose(got, want, rtol=tol, atol=tol)
    else:
        ok = err <= BF16_REL_TOL * want.abs().max().item()
    if not ok:
        raise RuntimeError(f"{name} disagrees with its plain version at {case}: max abs err {err}")
    return err


def check_flash(gen: torch.Generator) -> dict:
    """Phase 6 for ``flash_attention``: parity everywhere, times at the
    prefill shape of every served attention model, q, k and v in the model's
    layout (transposed ``[b, s, h, d]`` views).  The kernels-line row is
    granite-3-2b's, the kernel's first model."""
    f32, bf16 = torch.float32, torch.bfloat16
    served = []  # bf16, causal, one per attention model of LM_MODELS
    for arch, (names, _, _) in LM_MODELS.items():
        if "flash_attention" in names:
            cfg = get_config(arch)
            if cfg.sliding_window:  # SDPA, the yardstick, takes no window
                raise RuntimeError(f"{arch}: a sliding window is not timed here")
            served.append(dict(b=LM_BATCH, h=cfg.n_heads, kvh=cfg.n_kv_heads, s=LM_PROMPT, d=cfg.hd, dtype=bf16,
                               causal=True, window=0, model=arch))
    cases = served + [
        dict(b=2, h=h, kvh=kvh, s=s, d=32, dtype=f32, causal=c, window=0)  # tests/test_kernels.py grid
        for c in (True, False) for h, kvh in ((4, 4), (4, 2), (8, 1)) for s in (64, 128)
    ] + [
        dict(b=2, h=4, kvh=2, s=200, d=64, dtype=f32, causal=True, window=0),  # ragged S
        dict(b=2, h=4, kvh=2, s=100, d=64, dtype=f32, causal=True, window=16),  # window
        dict(b=1, h=4, kvh=4, s=77, d=128, dtype=f32, causal=False, window=9),  # non-causal window, D 128
        dict(b=2, h=8, kvh=2, s=300, d=128, dtype=bf16, causal=True, window=50),  # bf16 ragged window
        dict(b=4, h=32, kvh=8, s=512, d=64, dtype=f32, causal=True, window=0),  # granite's shape, fp32
    ] + [  # the tensor-core kernel's branches: every head dim, GQA groups 1 / 4 / 5, S of one row, under
        # one fragment, one key past a tile and ragged long, a window narrower than a 16-row fragment,
        # and no causal mask
        dict(b=2, h=4, kvh=4, s=65, d=16, dtype=bf16, causal=True, window=0),
        dict(b=2, h=8, kvh=2, s=15, d=32, dtype=bf16, causal=True, window=0),
        dict(b=1, h=8, kvh=2, s=1, d=64, dtype=bf16, causal=True, window=0),
        dict(b=2, h=40, kvh=8, s=1000, d=128, dtype=bf16, causal=True, window=0),
        dict(b=2, h=10, kvh=2, s=65, d=128, dtype=bf16, causal=False, window=0),
        dict(b=2, h=4, kvh=4, s=200, d=64, dtype=bf16, causal=True, window=7),
        dict(b=1, h=10, kvh=2, s=130, d=32, dtype=bf16, causal=False, window=7),
        dict(b=2, h=8, kvh=2, s=1000, d=16, dtype=bf16, causal=False, window=0),
        dict(b=2, h=8, kvh=8, s=200, d=80, dtype=bf16, causal=True, window=7),
        dict(b=2, h=24, kvh=2, s=130, d=192, dtype=bf16, causal=True, window=50),  # GQA group 12
        dict(b=1, h=12, kvh=1, s=65, d=80, dtype=bf16, causal=False, window=0),
        dict(b=2, h=12, kvh=1, s=300, d=192, dtype=bf16, causal=False, window=0),
        dict(b=1, h=12, kvh=1, s=1, d=192, dtype=bf16, causal=True, window=0),
    ] + [  # head dims 80 and 192 in fp32 at the reference's 2e-4: ragged S, a window, no causal mask
        dict(b=2, h=4, kvh=2, s=200, d=d, dtype=f32, causal=True, window=0) for d in (80, 192)
    ] + [
        dict(b=2, h=24, kvh=2, s=100, d=d, dtype=f32, causal=True, window=16) for d in (80, 192)
    ] + [
        dict(b=1, h=12, kvh=1, s=77, d=d, dtype=f32, causal=False, window=9) for d in (80, 192)
    ]
    row = None
    max_err = 0.0
    for case in cases:
        b, h, kvh, s, d, dt = (case[k] for k in ("b", "h", "kvh", "s", "d", "dtype"))
        q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dt).transpose(1, 2)  # the model's layout
        if "model" in case:
            k = torch.randn((b, s, kvh, d), generator=gen, device="cuda").to(dt).transpose(1, 2)
            v = torch.randn((b, s, kvh, d), generator=gen, device="cuda").to(dt).transpose(1, 2)
        else:
            k = torch.randn((b, kvh, s, d), generator=gen, device="cuda").to(dt)
            v = torch.randn((b, kvh, s, d), generator=gen, device="cuda").to(dt)
        kw = dict(causal=case["causal"], window=case["window"])
        y = fa.flash_attention(q, k, v, **kw)
        yp = fa.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        desc = {**case, "dtype": str(dt).removeprefix("torch.")}
        err = _agree("flash_attention", desc, y, yp, ATTN_TOL if dt == f32 else None)
        max_err = max(max_err, err)
        print(f"[check] flash_attention {json.dumps({**desc, 'max_abs_err': err, 'max_abs_plain': yp.float().abs().max().item()})}")
        if "model" in case:
            pairs = s * (s + 1) // 2
            flops = 4.0 * b * h * d * pairs
            nbytes = 2.0 * (q.numel() + k.numel() + v.numel() + y.numel())
            bound_ms, bound_by = _bound(flops, nbytes, PEAK_BF16_FLOPS)
            qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()

            def kern():
                return fa.flash_attention(q, k, v, **kw)

            def plain():
                return fa.flash_attention_plain(q, k, v, **kw)

            def sdpa():
                return F.scaled_dot_product_attention(qc, kc, vc, is_causal=True, enable_gqa=True)

            # CUDA events around 20 calls, as for every kernel; at these sizes the wrapper
            # takes the host longer to issue than the card to run, so the device time from
            # the profiler and the host's time to issue a call stand beside them
            timed = dict(ms=_time_ms(kern), plain_ms=_time_ms(plain), library_ms=_time_ms(sdpa),
                         bound_ms=bound_ms, bound_by=bound_by)
            device_ms, ran = _device_ms(kern)
            plain_device_ms, _ = _device_ms(plain)
            library_device_ms, sdpa_ran = _device_ms(sdpa, need=False)
            timed.update(device_ms=device_ms, plain_device_ms=plain_device_ms, library_device_ms=library_device_ms,
                         host_ms=_host_ms(kern), library_host_ms=_host_ms(sdpa))
            ratios = dict(sdpa_ratio=timed["ms"] / timed["library_ms"],
                          sdpa_device_ratio=_ratio(device_ms, library_device_ms))
            print(f"[check] flash_attention {case['model']} prefill shape: "
                  f"{json.dumps({**timed, **ratios, 'flops': flops, 'bytes': nbytes})}")
            print(f"[check] flash_attention at {case['model']}'s shape ran {json.dumps(ran)}; "
                  f"SDPA ran {json.dumps(sdpa_ran)}")
            if row is None:
                row = {**timed, "sdpa_ran": sorted(sdpa_ran)}
            else:  # the other served models' shapes, under keys that name them
                row.update({f"{case['model']} {k}": v for k, v in {**timed, **ratios}.items()})
                row[f"{case['model']} sdpa_ran"] = sorted(sdpa_ran)
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:64",
        "max_abs_err": max_err, **row,
    }


def ssd_inputs(b: int, l: int, h: int, p: int, n: int, dtype: torch.dtype, strided: bool, gen: torch.Generator):
    """Random x, dt, A, B, C of one SSD shape on the card; ``strided``: x, B
    and C as slices of one projection, as ``ssd_block`` passes them."""
    if strided:
        proj = torch.randn((b, l, h * p + 2 * n), generator=gen, device="cuda").to(dtype)
        x, B, C = proj[..., : h * p].reshape(b, l, h, p), proj[..., h * p : h * p + n], proj[..., h * p + n :]
    else:
        x = torch.randn((b, l, h, p), generator=gen, device="cuda").to(dtype)
        B = torch.randn((b, l, n), generator=gen, device="cuda").to(dtype)
        C = torch.randn((b, l, n), generator=gen, device="cuda").to(dtype)
    dt = F.softplus(torch.randn((b, l, h), generator=gen, device="cuda"))
    A = -torch.exp(0.5 * torch.randn((h,), generator=gen, device="cuda"))
    return x, dt, A, B, C


def ssd_cost(x: torch.Tensor, B: torch.Tensor, chunk: int) -> tuple[float, float]:
    """FLOPs and bytes of one scan: C.B^T once per (batch, chunk) on the
    lower triangle; per (batch, head, chunk) the masked product on the
    triangle, the carried state's output (not for the first chunk, whose
    state is zero) and the state update.  Bytes: x, B, C, y in x's type, dt,
    A and the final state in fp32, each once."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    nc, tri = l // chunk, chunk * (chunk + 1) // 2
    flops = 2.0 * b * nc * n * tri + 2.0 * b * h * (nc * p * tri + (nc - 1) * chunk * n * p + nc * chunk * n * p)
    nbytes = x.element_size() * (2 * x.numel() + 2 * B.numel()) + 4.0 * (b * l * h + h + b * h * p * n)
    return flops, nbytes


def check_ssd(gen: torch.Generator) -> dict:
    """Phase 6 for ``ssd_scan``: parity everywhere; at mamba2-130m's and
    zamba2-2.7b's prefill shapes the kernel that ran (the tensor-core one,
    on a block per SM at least), times and bound.  The kernels-line row is
    mamba2-130m's, the served model's, with zamba2's times beside it."""
    f32, bf16 = torch.float32, torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    served = []  # the prefill scan of each Mamba2-family model, as ssd_block passes it
    for arch in SSD_MODELS:
        cfg = get_config(arch)
        served.append(dict(b=LM_BATCH, l=LM_PROMPT, h=cfg.ssm_heads, p=cfg.ssm_head_dim, n=cfg.ssm_state,
                           chunk=cfg.ssm_chunk, dtype=bf16, strided=True, model=arch))
    cases = served + [
        dict(b=2, l=128, h=h, p=p, n=n, chunk=c, dtype=f32, strided=False)  # tests/test_kernels.py grid
        for c in (16, 32) for h, p, n in ((2, 16, 8), (3, 8, 16))
    ] + [
        dict(b=2, l=256, h=3, p=100, n=32, chunk=64, dtype=f32, strided=False),  # ragged p tile
        dict(b=2, l=64, h=4, p=16, n=16, chunk=8, dtype=f32, strided=True),  # mamba2 smoke shape
        dict(b=4, l=512, h=24, p=64, n=128, chunk=64, dtype=f32, strided=False),  # main shape, fp32
        dict(b=2, l=64, h=4, p=16, n=16, chunk=8, dtype=bf16, strided=True),  # mamba2 smoke, bf16: SIMT
    ] + [  # the tensor-core kernel's branches: chunks 16 / 32 / 64, state 64 / 128, p tiles 16 / 32 / 64
        # with a ragged one (p 48), one chunk, contiguous and strided inputs
        dict(b=2, l=128, h=4, p=64, n=128, chunk=16, dtype=bf16, strided=True),
        dict(b=2, l=96, h=3, p=48, n=64, chunk=32, dtype=bf16, strided=False),
        dict(b=1, l=64, h=2, p=48, n=128, chunk=64, dtype=bf16, strided=True),
        dict(b=2, l=256, h=8, p=32, n=64, chunk=64, dtype=bf16, strided=False),
        dict(b=3, l=32, h=5, p=16, n=128, chunk=16, dtype=bf16, strided=True),
    ]
    row = None
    max_err = 0.0
    for case in cases:
        b, l, h, p, n, chunk, dt = (case[k] for k in ("b", "l", "h", "p", "n", "chunk", "dtype"))
        x, dtt, A, B, C = ssd_inputs(b, l, h, p, n, dt, case["strided"], gen)
        y, st = ssd.ssd_scan(x, dtt, A, B, C, chunk=chunk)
        yp, stp = ssd.ssd_scan_plain(x, dtt, A, B, C, chunk=chunk)
        torch.cuda.synchronize()
        chosen = ssd.plan(dt, b, h, p, n, chunk, ssd._aligned(x) and ssd._aligned(B) and ssd._aligned(C), sms=sms)
        desc = {**case, "dtype": str(dt).removeprefix("torch."), "kernel": ssd.KERNELS[chosen.route],
                "p_tile": chosen.p_tile, "blocks": chosen.blocks}
        tol = SSD_TOL if dt == f32 else None
        err = max(_agree("ssd_scan", desc, y, yp, tol), _agree("ssd_scan (state)", desc, st, stp, tol))
        if chosen.route == 2:  # every other p tile of the tensor-core kernel, too
            for other in ssd.mma_plans(b, h, p, n, chunk):
                yo, so = ssd.run_plan(x, dtt, A, B, C, chunk, other)
                torch.cuda.synchronize()
                what = {**desc, "p_tile": other.p_tile, "blocks": other.blocks}
                err = max(err, _agree("ssd_scan", what, yo, yp, tol), _agree("ssd_scan (state)", what, so, stp, tol))
        max_err = max(max_err, err)
        print(f"[check] ssd_scan {json.dumps({**desc, 'max_abs_err': err, 'max_abs_plain': yp.float().abs().max().item(), 'max_abs_state': stp.abs().max().item()})}")
        if "model" in case:
            if chosen.route != ssd.KERNELS.index("ssd_scan_mma_bf16_kernel") or chosen.blocks < sms:
                raise RuntimeError(f"ssd_scan at {case['model']}'s shape planned {chosen}, want "
                                   f"ssd_scan_mma_bf16_kernel on at least {sms} blocks")
            flops, nbytes = ssd_cost(x, B, chunk)
            bound_ms, bound_by = _bound(flops, nbytes, PEAK_BF16_FLOPS)

            def kern():
                return ssd.ssd_scan(x, dtt, A, B, C, chunk=chunk)

            timed = dict(ms=_time_ms(kern), plain_ms=_time_ms(lambda: ssd.ssd_scan_plain(x, dtt, A, B, C, chunk=chunk)),
                         library_ms=None,  # no single PyTorch call computes SSD
                         bound_ms=bound_ms, bound_by=bound_by)
            for _ in range(3):  # a profiler window can hand its records to the next one: take another
                device_ms, ran = _device_ms(kern)
                fns = sorted({m.group(1) for k in ran if (m := SSD_FN.search(k))})
                if fns:
                    break
            if fns != [f"ssd_scan_mma_bf16_kernel<{n}, {chosen.p_tile}>"]:
                raise RuntimeError(f"ssd_scan at {case['model']}'s shape ran {fns}, want ssd_scan_mma_bf16_kernel "
                                   f"(the profiler's window: {ran})")
            timed.update(device_ms=device_ms, host_ms=_host_ms(kern), device_function=fns[0],
                         blocks=chosen.blocks, bound_ratio=device_ms / bound_ms)
            print(f"[check] ssd_scan {case['model']} prefill shape: "
                  f"{json.dumps({**timed, 'flops': flops, 'bytes': nbytes})}")
            if row is None:
                row = timed
            else:
                row.update({f"{case['model']} {k}": v for k, v in timed.items() if k != "library_ms"})
    return {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:59",
        "max_abs_err": max_err, **row,
    }


def check_gemm(gen: torch.Generator) -> dict:
    """Phase 9 for ``gemm``: parity everywhere, the kernel each main shape
    runs, times at the MoE main path's shapes.  The kernels-line row is one
    phi3.5-moe layer's expert products: its prefill (gate, up, down) plus one
    decode step (gate, up, down)."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [((m, k), (k, n), dt, "reference grid")  # tests/test_kernels.py
             for m, k, n in ((64, 64, 64), (200, 300, 150), (128, 512, 256), (33, 65, 17)) for dt in (f32, bf16)]
    cases += [((3, 33, 65), (3, 65, 17), dt, "batched, ragged") for dt in (f32, bf16)]
    # the wgmma tile's edges: M past 16 and past whole 192-row tiles, K and N not whole 64 / 128 tiles
    cases += [((e, m, 4104), (e, 4104, n), bf16, "wgmma tile edges")  # 51 column tiles: one block a cluster;
              for e, m, n in ((1, 17, 6408), (1, 100, 6408), (16, 321, 6392))]  # 50: two
    cases.append(((16, 160, 264), (3, 16, 264, 136), bf16, "layer 1 of a stacked expert tensor"))
    layer, main = {}, {}  # phi3.5-moe shape label -> calls per layer; main shape label -> kernel it must run
    for arch in ("phi3.5-moe-42b", "llama4-scout-17b"):
        cfg = get_config(arch)
        E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        for phase, tokens in (("prefill", LM_BATCH * LM_PROMPT), ("decode", LM_BATCH)):
            cap = blocks.moe_capacity(cfg, tokens)
            up, down = f"{arch} {phase} gate/up", f"{arch} {phase} down"
            cases += [((E, cap, d), (E, d, f), bf16, up), ((E, cap, f), (E, f, d), bf16, down)]
            kernel = "gemm_wgmma_bf16_kernel" if phase == "prefill" else "gemm_mma_bf16_kernel"
            main.update({up: kernel, down: kernel})
            if arch == "phi3.5-moe-42b":
                layer.update({up: 2, down: 1})
    cases.append(((16, 320, 4096), (16, 4096, 6400), f32, "phi3.5-moe-42b prefill gate/up, fp32"))
    max_err = 0.0
    tot = {key: 0.0 for key in ("ms", "plain_ms", "library_ms", "device_ms", "library_device_ms", "flops", "bytes")}
    for sa, sb, dt, label in cases:
        a = torch.randn(sa, generator=gen, device="cuda").to(dt)
        b = (torch.randn(sb, generator=gen, device="cuda") / sb[-2] ** 0.5).to(dt)
        if len(sb) == 4:  # the model's view: one layer of an [L, E, K, N] stack, at a nonzero offset
            b = b[1]
        y, yp = gm.gemm(a, b), gm.gemm_plain(a, b)
        torch.cuda.synchronize()
        desc = {"a": list(sa), "b": list(sb), "dtype": str(dt).removeprefix("torch."), "case": label}
        err = (y.float() - yp.float()).abs().max().item()
        if not torch.allclose(y.float(), yp.float(), rtol=GEMM_TOL[dt], atol=GEMM_TOL[dt]):
            raise RuntimeError(f"gemm disagrees with its plain version at {desc}: max abs err {err}")
        max_err = max(max_err, err)
        row = {**desc, "max_abs_err": err, "max_abs_plain": yp.float().abs().max().item(),
               "kernel": gm.KERNELS[gm.route(dt, a.shape[-2], a.shape[-1], b.shape[-1], gm._aligned(a) and gm._aligned(b))]}
        if label in main:
            E, M, K = sa
            flops, nbytes = 2.0 * E * M * K * sb[-1], 2.0 * (a.numel() + b.numel() + y.numel())
            bound_ms, bound_by = _bound(flops, nbytes, PEAK_BF16_FLOPS)
            row.update(flops=flops, bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by,
                       ms=_time_ms(lambda: gm.gemm(a, b)), plain_ms=_time_ms(lambda: gm.gemm_plain(a, b)),
                       library_ms=_time_ms(lambda: torch.bmm(a, b)))
            row["device_ms"], ran = _device_ms(lambda: gm.gemm(a, b))
            row["library_device_ms"], _ = _device_ms(lambda: torch.bmm(a, b), need=False)
            fns = sorted({m.group(1) for n in ran if (m := GEMM_FN.search(n))})
            if not fns or not all(fn.startswith(main[label]) for fn in fns):
                raise RuntimeError(f"gemm at {label} ran {fns}, want {main[label]}")
            row.update(ran=fns, tflops=flops / row["device_ms"] / 1e9, bmm_ratio=row["ms"] / row["library_ms"],
                       bmm_device_ratio=_ratio(row["device_ms"], row["library_device_ms"]))
            for key in tot:
                tot[key] = None if tot[key] is None or row[key] is None \
                    else tot[key] + layer.get(label, 0) * row[key]
        print(f"[check] gemm {json.dumps(row)}")
        del a, b, y, yp
    torch.cuda.empty_cache()
    bound_ms, bound_by = _bound(tot["flops"], tot["bytes"], PEAK_BF16_FLOPS)
    print(f"[check] gemm, one phi3.5-moe layer (prefill + one decode step): "
          f"{json.dumps({**tot, 'bound_ms': bound_ms})}")
    return {
        "name": "gemm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gemm.cu",
        "replaces": "src/repro/kernels/gemm.py:37",
        "max_abs_err": max_err, "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": tot["library_ms"],
        "device_ms": tot["device_ms"], "library_device_ms": tot["library_device_ms"],
    }


def _host_ms(fn, reps: int = 20) -> float:
    """Host time to issue one call of ``fn``: the host clock around ``reps``
    calls with no synchronisation inside (the card's queue holds them all)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return host


def _device_ms(fn, reps: int = 20, need: bool = True) -> tuple[float | None, dict[str, int]]:
    """Device time per call of ``fn`` from the profiler, and the device
    kernels it ran, by the profiler's name, with their calls per call.  Each
    kernel, copy and memset counts at its mean time per record times its
    records per call, rounded: the profiler can keep only some of a window's
    records, or none, so the window's own kernels keep their per-call time,
    and a name with under half a record per call is another window's and is
    left out.  Unlike ``_time_ms`` it excludes the host's gaps between
    calls: a call that takes the host longer to issue than the card to run
    reads as the card's time.  A window in which the profiler kept no record
    a call is taken again after a pause, up to ``PROFILER_WINDOWS`` in all;
    then it raises, or with ``need`` false (a library call, timed for
    comparison only) prints so and returns ``None``: not measured."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_WINDOWS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA and e.count]
        per_call = [(e, round(e.count / reps)) for e in events]
        if any(n for _, n in per_call):
            break
        time.sleep(0.1)
    else:
        kept = {e.key[:120]: e.count for e in events}
        msg = f"the profiler kept no device record a call in {PROFILER_WINDOWS} windows of {reps} calls: {kept}"
        if need:
            raise RuntimeError(msg)
        print(f"[check] device time not measured: {msg}")
        return None, {}
    return (sum(e.self_device_time_total / e.count * n for e, n in per_call) / 1e3,
            {e.key[:120]: n for e, n in per_call if n})


def _ratio(a: float | None, b: float | None) -> float | None:
    """``a / b``, or ``None`` where either was not measured."""
    return None if a is None or b is None else a / b


def _kernel_table(prof, wall_s: float) -> dict:
    """Device time by kernel from a profiler trace: the top kernels, sums by
    kind, and the device's busy share of ``wall_s``."""
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)

    def kind(name: str) -> str:
        if any(k in name for k in PORT_KERNELS):
            return "port kernel"
        return "matmul" if any(t in name.lower() for t in ("gemm", "nvjet", "xmma", "cutlass")) else "other"

    kinds: dict[str, float] = {}
    for name, ms, _ in rows:
        kinds[kind(name)] = kinds.get(kind(name), 0.0) + ms
    return {
        "wall_ms": wall_s * 1e3,
        "device_ms": busy,
        "kernel_calls": sum(r[2] for r in rows),
        "busy_share": busy / (wall_s * 1e3) if busy else "not measured",
        "by_kind_ms": kinds,
        "top": [{"kernel": n[:60], "ms": ms, "calls": c} for n, ms, c in rows[:6]],
        "flash_calls": {m.group(1): c for n, _, c in rows if (m := FLASH_FN.search(n))},
        "gemm_calls": {m.group(1): c for n, _, c in rows if (m := GEMM_FN.search(n))},
        "ssd_calls": {m.group(1): c for n, _, c in rows if (m := SSD_FN.search(n))},
    }


@torch.inference_mode()
def _time_lm(arch: str, cfg, params, prompt: torch.Tensor) -> dict:
    """Warm prefill and decode times of the kernel path on the host clock
    (around ``torch.cuda.synchronize()``), then one profiled prefill and
    four profiled decode steps.  Returns the prefill's kernel table."""
    from torch.profiler import ProfilerActivity, profile

    def prefill():
        return transformer.prefill_step(cfg, params, {"tokens": prompt}, max_len=prompt.shape[1] + LM_GEN)

    def decode(logits, cache, steps):
        for _ in range(steps):
            logits, cache = transformer.serve_step(cfg, params, cache, torch.argmax(logits, -1)[:, None])
        return logits, cache

    prefill()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill()
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    logits, cache = decode(logits, cache, 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = decode(logits, cache, 8)
    torch.cuda.synchronize()
    t_step = (time.perf_counter() - t0) / 8
    print(f"[lm] {arch} warm: prefill {t_prefill * 1e3:.3f} ms, decode step {t_step * 1e3:.3f} ms "
          f"({LM_BATCH / t_step:.1f} tokens/s over the batch)")
    tables = {}
    mods = (fa, ssd, gm)
    for what, run in (("prefill", lambda: prefill()), ("decode x4", lambda: decode(logits, cache, 4))):
        # a window in which the profiler kept fewer records of the port's kernels than the
        # wrappers launched is taken again: the checks below count those records
        for _ in range(PROFILER_WINDOWS):
            before = sum(mod.launches for mod in mods)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            table = _kernel_table(prof, wall)
            kept = sum(sum(table[k].values()) for k in ("flash_calls", "ssd_calls", "gemm_calls"))
            if table["kernel_calls"] and kept == sum(mod.launches for mod in mods) - before:
                break
            print(f"[lm] {arch} profile {what}: the profiler kept {kept} of "
                  f"{sum(mod.launches for mod in mods) - before} port kernel launches; taken again")
            time.sleep(0.1)
        tables[what] = table
        print(f"[lm] {arch} profile {what}: {json.dumps(tables[what])}")
    return tables["prefill"]


def _cast(params: dict, dt: torch.dtype) -> dict:
    """The parameter tree with its bf16 leaves in ``dt`` (norm scales stay fp32)."""
    return {k: _cast(v, dt) if isinstance(v, dict) else (v.to(dt) if v.dtype == torch.bfloat16 else v)
            for k, v in params.items()}


@torch.inference_mode()
def _forced_logits(cfg, params, prompt: torch.Tensor, forced: torch.Tensor) -> torch.Tensor:
    """Prefill logits, then one per teacher-forced decode step: [b, 1 + steps, vocab]."""
    logits, cache = transformer.prefill_step(cfg, params, {"tokens": prompt}, max_len=prompt.shape[1] + LM_GEN)
    out = [logits]
    for t in range(forced.shape[1]):
        logits, cache = transformer.serve_step(cfg, params, cache, forced[:, t : t + 1])
        out.append(logits)
    return torch.stack(out, dim=1)


def _fp32_first_layers(params: dict, n: int) -> dict:
    """The parameter tree cut to its first ``n`` layers with its bf16 leaves
    in fp32, made leaf by leaf while ``params`` is emptied, so that each bf16
    leaf is freed as soon as its copy exists: nemotron-4-340b's fp32 model at
    1 layer (51.5 GB) fits the card only once its bf16 one at 2 (32.7 GB) is
    gone."""
    def fp32(t: torch.Tensor) -> torch.Tensor:
        return t.float() if t.dtype == torch.bfloat16 else t

    out = {}
    for key in list(params):
        v = params.pop(key)
        if isinstance(v, dict):
            cut = n if key == "blocks" else None
            out[key] = {k: fp32(v.pop(k)[:cut]) for k in list(v)}
        else:
            out[key] = fp32(v)
        del v
    return out


@contextlib.contextmanager
def _recording_routes(out: list):
    """Append each MoE layer's expert choice [t, k] to ``out``, in call order."""
    route = blocks.route

    def recording(cfg, p, xf):
        probs, gate, expert = route(cfg, p, xf)
        out.append(expert)
        return probs, gate, expert

    with mock.patch.object(blocks, "route", recording):
        yield


@contextlib.contextmanager
def _replaying_routes(recorded: list):
    """Route each MoE call to the experts ``recorded`` for it, in call order,
    with gates from this path's own router probabilities."""
    route, calls = blocks.route, iter(recorded)

    def replaying(cfg, p, xf):
        probs = route(cfg, p, xf)[0]
        expert = next(calls)
        gate = probs.gather(1, expert)
        return probs, gate / gate.sum(-1, keepdim=True).clamp_min(1e-9), expert

    with mock.patch.object(blocks, "route", replaying):
        yield


@contextlib.contextmanager
def _plain_versions():
    """Every kernel's plain version in place of the kernel, on the model's path."""
    with mock.patch.object(ops, "flash_attention", fa.flash_attention_plain), \
            mock.patch.object(ops, "ssd_scan", ssd.ssd_scan_plain), mock.patch.object(ops, "gemm", gm.gemm_plain):
        yield


@contextlib.contextmanager
def _checking_scans(errors: list):
    """Run each ``ops.ssd_scan`` call as it is, and the plain version on the
    same inputs; append (y, final state) max |difference| over max |plain|."""
    scan = ops.ssd_scan

    def checking(x, dt, A, B, C, *, chunk=64):
        y, st = scan(x, dt, A, B, C, chunk=chunk)
        yp, sp = ssd.ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
        errors.append(((y.float() - yp.float()).abs().max().item() / yp.float().abs().max().item(),
                       (st - sp).abs().max().item() / sp.abs().max().item()))
        return y, st

    with mock.patch.object(ops, "ssd_scan", checking):
        yield


@contextlib.contextmanager
def _bf16_scans():
    """``ops.ssd_scan`` as it is now, on x, B and C rounded to bf16, its bf16
    output widened to x's type: a bf16 scan in a model in fp32."""
    scan = ops.ssd_scan

    def bf16_scan(x, dt, A, B, C, *, chunk=64):
        bf = torch.bfloat16
        y, st = scan(x.to(bf), dt, A, B.to(bf), C.to(bf), chunk=chunk)
        return y.to(x.dtype), st

    with mock.patch.object(ops, "ssd_scan", bf16_scan):
        yield


@contextlib.contextmanager
def _plain_toward_zero():
    """``ops.ssd_scan`` as the plain version with its output rounded toward
    zero to x's type (bf16) instead of to nearest: a biased scan whose every
    output is within one rounding of the plain version's."""
    def toward_zero(x, dt, A, B, C, *, chunk=64):
        y, st = ssd.ssd_scan_plain(x.float(), dt, A, B.float(), C.float(), chunk=chunk)
        return (y.contiguous().view(torch.int32) & -65536).view(torch.float32).to(x.dtype), st

    with mock.patch.object(ops, "ssd_scan", toward_zero):
        yield


def hold_bf16_scans(arch: str, cfg, params: dict, prompt: torch.Tensor, forced: torch.Tensor,
                    failures: list[str]) -> None:
    """Phase 8's logits check of a bf16 SSD model (see SSD_LAYERS): the model
    in fp32 with its scans in bf16, kernel path and a control scan that
    rounds toward zero, each against the plain path.  Appends to
    ``failures`` if the kernel path misses LM_TOL or the control meets it."""
    c, p, tol = dataclasses.replace(cfg, dtype=torch.float32), _cast(params, torch.float32), LM_TOL[torch.bfloat16]
    with _bf16_scans():
        got = _forced_logits(c, p, prompt, forced)
    with _plain_versions(), _bf16_scans():
        want = _forced_logits(c, p, prompt, forced)
    with _plain_versions(), _plain_toward_zero(), _bf16_scans():
        control = _forced_logits(c, p, prompt, forced)
    if not all(torch.isfinite(t).all() for t in (got, want, control)):
        raise RuntimeError(f"{arch}: logits with bf16 scans not finite")
    scale = want.abs().max().item()
    err, ctrl = (got - want).abs().max().item(), (control - want).abs().max().item()
    name = f"{arch} fp32 with bf16 scans at {c.n_layers} layers"
    print(f"[lm] {name}: logits {tuple(got.shape)} kernel vs plain max abs err {err:.3e}, max |logit| "
          f"{scale:.3e} (relative {err / scale:.3e}, tolerance {tol}); control (plain rounded toward zero) "
          f"relative {ctrl / scale:.3e}, must exceed {tol}")
    if not scale > 0 or err > tol * scale:
        failures.append(f"{name}: kernel path disagrees with the plain path: {err} > {tol} * {scale}")
        print(f"[FAIL] {failures[-1]}")
    if not ctrl > tol * scale:
        failures.append(f"{name}: the control that rounds toward zero agrees with the plain path: "
                        f"{ctrl} <= {tol} * {scale}, so the comparison cannot tell a biased scan")
        print(f"[FAIL] {failures[-1]}")
    del p


def _route_agreement(got: list, want: list) -> tuple[float, list[float]]:
    """Share of (token, expert) assignments of ``got`` that ``want`` makes
    too, over all calls, and per call."""
    per = [(g[:, :, None] == w[:, None, :]).any(-1).float().mean().item() for g, w in zip(got, want, strict=True)]
    n = [g.numel() for g in got]
    return sum(a * k for a, k in zip(per, n)) / sum(n), per


def drive_lm(arch: str, kernels: tuple[str, ...], depth: int | None, fp32_depth: int | None,
             failures: list[str]) -> tuple[dict[str, int], str | None]:
    """Phases 7-8 (10 for MoE) for one model: the served path, then kernels
    against plain.  Returns the launches of each kernel on the served path and
    the flash device function that served its bf16 prefill (None without
    attention); a logits comparison that misses LM_TOL is appended to
    ``failures``, every other failed check raises."""
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=depth) if depth else full
    print(f"[lm] {arch}: {cfg.n_layers} of {full.n_layers} layers, full width (d_model {cfg.d_model})")
    mods = {"conv2d_im2col": im2col_conv, "flash_attention": fa, "ssd_scan": ssd, "gemm": gm}
    for mod in mods.values():
        mod.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = serve(cfg, batch=LM_BATCH, prompt_len=LM_PROMPT, gen=LM_GEN, seed=0, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: mod.launches for name, mod in mods.items()}
    tokens = res["tokens"]
    print(f"[lm] {arch}: prefill_s {res['prefill_s']:.6f}, decode_tok_per_s {res['decode_tok_per_s']:.3f}, "
          f"wall {wall:.1f} s (weights drawn on the card included), launches {launches}, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for kernel in kernels:
        if launches[kernel] == 0:
            raise RuntimeError(f"kernel {kernel} never launched on the {arch} serving path")
    if tuple(tokens.shape) != (LM_BATCH, LM_GEN) or int(tokens.min()) < 0 or int(tokens.max()) >= cfg.vocab:
        raise RuntimeError(f"{arch}: bad tokens {tuple(tokens.shape)} in [{int(tokens.min())}, {int(tokens.max())}]")

    # the same weights and prompt, kernel path against plain path, teacher-forced on the served tokens
    prompt = make_prompt(cfg, LM_BATCH, LM_PROMPT, 0, "cuda")
    forced = tokens[:, :LM_FORCED]
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    table = _time_lm(arch, cfg, params, prompt)
    flash_calls, gemm_calls, ssd_calls = table["flash_calls"], table["gemm_calls"], table["ssd_calls"]
    served_by = None
    if "ssd_scan" in kernels:  # bf16 prefill: the tensor-core scan once per layer, never the SIMT one
        mma = {n: c for n, c in ssd_calls.items() if n.startswith("ssd_scan_mma_bf16_kernel")}
        if len(mma) != 1 or len(ssd_calls) != 1 or sum(mma.values()) != cfg.n_layers:
            raise RuntimeError(f"{arch}: the profiled bf16 prefill ran {ssd_calls}, want "
                               f"ssd_scan_mma_bf16_kernel once per layer ({cfg.n_layers})")
        print(f"[lm] {arch}: prefill scan served by {json.dumps(mma)}")
    if "gemm" in kernels:  # bf16 prefill: every expert product on wgmma, none on the mma.sync tiles
        wgmma = {n: c for n, c in gemm_calls.items() if n.startswith("gemm_wgmma_bf16_kernel")}
        if len(wgmma) != 1 or len(gemm_calls) != 1 or sum(wgmma.values()) != 3 * cfg.n_layers:
            raise RuntimeError(f"{arch}: the profiled bf16 prefill ran {gemm_calls}, want gemm_wgmma_bf16_kernel "
                               f"three times per layer ({3 * cfg.n_layers})")
        print(f"[lm] {arch}: prefill expert products served by {json.dumps(gemm_calls)}")
    if "flash_attention" in kernels:  # bf16 prefill: the tensor-core kernel once per layer, never the SIMT one
        mma = {n: c for n, c in flash_calls.items() if n.startswith("flash_fwd_mma_bf16_kernel")}
        # a hybrid runs its shared attention block once per group of SSD layers
        attn_layers = cfg.n_layers // cfg.shared_attn_every if cfg.block_kind == "hybrid" else cfg.n_layers
        if len(mma) != 1 or len(flash_calls) != 1 or sum(mma.values()) != attn_layers:
            raise RuntimeError(f"{arch}: the profiled bf16 prefill ran {flash_calls}, want "
                               f"flash_fwd_mma_bf16_kernel once per attention layer ({attn_layers})")
        served_by = next(iter(mma))
        print(f"[lm] {arch}: prefill attention served by {served_by}, {mma[served_by]} calls")
    for dt in (torch.bfloat16, torch.float32):
        c = dataclasses.replace(cfg, dtype=dt)
        if dt == torch.float32 and fp32_depth:  # the last use of params: it is emptied
            c, p = dataclasses.replace(c, n_layers=fp32_depth), _fp32_first_layers(params, fp32_depth)
        else:
            p = _cast(params, dt)
        routes: dict[str, list] = {"kernel": [], "plain": []}
        ssd_layers = "ssd_scan" in kernels and dt == torch.bfloat16  # see SSD_LAYERS
        scans: list = []
        with _recording_routes(routes["kernel"]), \
                (_checking_scans(scans) if ssd_layers else contextlib.nullcontext()):
            got = _forced_logits(c, p, prompt, forced)
        with _plain_versions(), _recording_routes(routes["plain"]):
            want = _forced_logits(c, p, prompt, forced)
        name = f"{arch} {str(dt).removeprefix('torch.')} at {c.n_layers} layers"
        if cfg.is_moe:
            share, per = _route_agreement(routes["kernel"], routes["plain"])
            print(f"[lm] {name}: routing agreement {share:.6f} of (token, expert) assignments over "
                  f"{len(per)} MoE calls; prefill by layer {[round(a, 6) for a in per[: c.n_layers]]}, "
                  f"decode min {min(per[c.n_layers:]):.6f} (floors {ROUTE_FLOOR})")
            if per[0] < ROUTE_FLOOR["first layer"] or share < ROUTE_FLOOR["all calls"]:
                raise RuntimeError(f"{name}: routing agreement {per[0]} in the first layer, {share} over all "
                                   f"calls, below {ROUTE_FLOOR}")
            if share < 1.0:  # see MOE_ROUTES
                err, scale = (got - want).abs().max().item(), want.abs().max().item()
                same = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
                print(f"[lm] {name}: each path on its own routes: logits max abs err {err:.3e} (relative "
                      f"{err / scale:.3e}), argmax agreement {same:.4f}")
                with _plain_versions(), _replaying_routes(routes["kernel"]):
                    want = _forced_logits(c, p, prompt, forced)
                name += ", plain path on the kernel path's routes"
        if ssd_layers:  # see SSD_LAYERS
            y_err, st_err = max(e[0] for e in scans), max(e[1] for e in scans)
            print(f"[lm] {name}: {len(scans)} prefill scans against the plain version on the same inputs: "
                  f"y max err {y_err:.3e}, state {st_err:.3e} of max |plain| (tolerance {BF16_REL_TOL})")
            if len(scans) != c.n_layers or max(y_err, st_err) > BF16_REL_TOL:
                raise RuntimeError(f"{name}: the kernel path's scans disagree with the plain version: {scans}")
        torch.cuda.synchronize()
        if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
            raise RuntimeError(f"{name}: logits not finite")
        err, scale = (got - want).abs().max().item(), want.abs().max().item()
        same = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        print(f"[lm] {name}: logits {tuple(got.shape)} kernel vs plain max abs err "
              f"{err:.3e}, max |logit| {scale:.3e} (relative {err / scale:.3e}, tolerance {LM_TOL[dt]}); "
              f"argmax agreement {same:.4f}")
        if dt == torch.bfloat16:
            served = (got[:, : LM_FORCED + 1].argmax(-1) == tokens[:, : LM_FORCED + 1]).float().mean().item()
            print(f"[lm] {arch}: teacher-forced kernel path reproduces the served tokens at {served:.4f} of positions")
        if ssd_layers:  # see SSD_LAYERS: held below with the model in fp32
            print(f"[lm] {name}: logits printed, not held (see SSD_LAYERS)")
        elif not scale > 0 or err > LM_TOL[dt] * scale:
            failures.append(f"{name}: kernel path disagrees with the plain path: {err} > {LM_TOL[dt]} * {scale}")
            print(f"[FAIL] {failures[-1]}")
        del p, got, want
    if "ssd_scan" in kernels:  # fp32_depth is None: params is whole
        hold_bf16_scans(arch, cfg, params, prompt, forced, failures)
    del params
    torch.cuda.empty_cache()
    return {name: launches[name] for name in kernels}, served_by


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(f"[card] {smi.stdout.strip().splitlines()[0]}")
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    # full fp32 everywhere a plain or library result is compared or timed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[card] TF32 off: cuda.matmul.allow_tf32=False, cudnn.allow_tf32=False")

    t0 = time.perf_counter()
    paths = build.build_all()
    print(f"[build] {len(paths)} kernel(s) in {time.perf_counter() - t0:.1f} s: {sorted(paths)}")
    for name in sorted(paths):
        print(f"[build] {name}:\n{build.ptxas_report(name)}")
    check_flash_ptxas()
    check_gemm_ptxas()
    check_conv_ptxas()
    check_ssd_ptxas()

    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    kernels = {"conv2d_im2col": check_conv(gen)}
    print(f"[check] done in {time.perf_counter() - t0:.1f} s")

    # main path, counts from 0
    im2col_conv.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = serve_cnn(device="cuda", scale=1.0, in_shape=(220, 220, 3), seed=0)
    torch.cuda.synchronize()
    launches = {"conv2d_im2col": im2col_conv.launches}
    wall = time.perf_counter() - t0
    print("\n".join(res.report()))
    print(f"[main] wall {wall:.1f} s, launches {launches}, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    names = [sp.name for sp in res.model.specs]
    print("[main] measured layer ms (microbatch of 2): "
          + json.dumps({n: round(t * 1e3, 4) for n, t in zip(names, res.evaluator.measured)}))
    print(f"[main] stage ms of the chosen split: {[round(t * 1e3, 4) for t in res.evaluator.stage_times(res.conf)]}")
    for name, n in launches.items():
        if n == 0:
            raise RuntimeError(f"kernel {name} never launched on the main path")
        kernels[name]["launches"] = n

    # the pipelined output against the sequential model
    model, out = res.model, res.out
    if not torch.isfinite(out).all():
        raise RuntimeError("pipelined output is not finite")
    seq = torch.stack([model(x) for x in res.micro])
    if not torch.equal(out, seq):
        raise RuntimeError(f"pipelined output differs from the sequential model: {(out - seq).abs().max().item()}")
    plain = []
    for x in res.micro:
        for i, sp in enumerate(model.specs):
            y = im2col_conv.conv2d_im2col_plain(model.layer_input(i, x), model.w[i], stride=sp.stride)
            x = torch.relu(y + model.b[i])
        plain.append(x)
    plain = torch.stack(plain)
    err, scale = (out - plain).abs().max().item(), plain.abs().max().item()
    print(f"[main] output {tuple(out.shape)}: pipelined == sequential; vs plain max abs err {err:.3e}, "
          f"max |output| {scale:.3e}")
    if not scale > 0 or err > CHAIN_TOL * scale:
        raise RuntimeError(f"pipelined output disagrees with the plain model: {err} > {CHAIN_TOL} * {scale}")
    t0 = time.perf_counter()
    race(res)
    print(f"[race] done in {time.perf_counter() - t0:.1f} s")
    del res, model, out, seq, plain
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    kernels["flash_attention"] = check_flash(gen)
    kernels["ssd_scan"] = check_ssd(gen)
    kernels["gemm"] = check_gemm(gen)
    print(f"[check] LM kernels done in {time.perf_counter() - t0:.1f} s")
    failures: list[str] = []
    for arch, (names, depth, fp32_depth) in LM_MODELS.items():
        t0 = time.perf_counter()
        launched, served_by = drive_lm(arch, names, depth, fp32_depth, failures)
        for name, n in launched.items():
            if "launches" in kernels[name]:  # each kernel's first model is its main path
                kernels[name][f"{arch} launches"] = n
            else:
                kernels[name]["launches"] = n
        if served_by:
            kernels["flash_attention"].setdefault("device_function", served_by)
        print(f"[lm] {arch} done in {time.perf_counter() - t0:.1f} s")

    print(f"[done] chip_smoke in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(kernels.values())}))
    if failures:
        print("chip_smoke: failed:\n" + "\n".join(failures), file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
