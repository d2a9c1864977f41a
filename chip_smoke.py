"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Fails (non-zero exit, no result line) when no CUDA device is visible or the
repository's sources are not beside this script.  Otherwise, in order:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every CUDA kernel of the port from the sources in the checkout
   (one ``nvcc`` per source, all at once) and prints ``ptxas -v``'s
   registers, shared memory and spills;
3. holds each kernel against its plain PyTorch version on the card, at every
   distinct layer shape of full-width SynthNet (microbatch of 2 images) and
   at the reference kernel tests' shapes plus a ragged K, in fp32 with TF32
   off (tolerance 3e-4 absolute and relative, the reference's); times the
   kernel, the plain version and cuDNN's ``F.conv2d`` on the SynthNet
   shapes and computes each shape's bound on the H100 SXM;
4. drives the main path — ``launch.serve_cnn.serve_cnn`` at full width:
   measure each layer, Shisha H3, 4-stage stream pipeline of 8 microbatches,
   straggler rebalance — with every launch count set to 0 just before and
   read just after; fails if a kernel of the path never launched;
5. checks the pipelined output: equal to the sequential model on the same
   kernels, and within 1e-3 of the output's largest magnitude of the
   sequential model computed with the plain versions (18 fp32 layers with
   reductions of up to 30976 terms summed in another order);
6. prints the per-kernel JSON line, then ``{"ok": true, "device": ...}`` last.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))  # the port, from this checkout

from repro_torch.kernels import build, im2col_conv
from repro_torch.launch.serve_cnn import BATCH, serve_cnn
from repro_torch.models.cnn import synthnet_specs
from repro_torch.pipeline.hetero import H100_FP32_FLOPS as PEAK_FP32_FLOPS
from repro_torch.pipeline.hetero import H100_HBM_BW as HBM_BYTES_PER_S

#: kernel-vs-plain tolerance on one conv (the reference's conv test)
KERNEL_TOL = 3e-4
#: pipelined-vs-plain tolerance over the 18-layer chain, relative to max |output|
CHAIN_TOL = 1e-3


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


def check_conv(gen: torch.Generator) -> dict:
    """Phase 3 for ``conv2d_im2col``: parity everywhere, times on SynthNet."""
    synth = _conv_shapes(synthnet_specs(), batch=BATCH)
    extra = [
        {"x": (2, 12, 12, 8), "w": (r, r, 8, 24), "stride": st, "layers": []}
        for r in (1, 3, 5)
        for st in (1, 2)
    ] + [
        {"x": (3, 13, 11, 5), "w": (3, 3, 5, 67), "stride": 1, "layers": []},  # ragged K, M, C
        {"x": (2, 20, 20, 8), "w": (11, 11, 8, 17), "stride": 4, "layers": []},  # 11x11 stride 4, ragged K
    ]
    rows, max_err = [], 0.0
    for sh in synth + extra:
        x = torch.randn(sh["x"], generator=gen, device="cuda")
        r, s, c, k = sh["w"]
        w = torch.randn(sh["w"], generator=gen, device="cuda") / (r * s * c) ** 0.5
        st = sh["stride"]
        y = im2col_conv.conv2d_im2col(x, w, stride=st)
        yp = im2col_conv.conv2d_im2col_plain(x, w, stride=st)
        torch.cuda.synchronize()
        err = (y - yp).abs().max().item()
        max_err = max(max_err, err)
        if not torch.allclose(y, yp, rtol=KERNEL_TOL, atol=KERNEL_TOL):
            raise RuntimeError(f"conv2d_im2col disagrees with its plain version at {sh}: max abs err {err}")
        row = {"x": list(sh["x"]), "w": list(sh["w"]), "stride": st, "max_abs_err": err}
        if sh["layers"]:
            n, h, wd, _ = sh["x"]
            ho, wo, pt, pb, pl, pr = im2col_conv.same_padding(h, wd, r, s, st)
            flops = 2.0 * n * ho * wo * k * r * s * c
            nbytes = 4.0 * (x.numel() + w.numel() + y.numel())
            # cuDNN yardstick: NCHW views of the NHWC data, padded beforehand
            # (asymmetric SAME padding is not one F.conv2d argument)
            xp = F.pad(x, (0, 0, pl, pr, pt, pb)).permute(0, 3, 1, 2)
            wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            row.update(
                layers=sh["layers"],
                flops=flops,
                bytes=nbytes,
                bound_ms=max(flops / PEAK_FP32_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3,
                bound_by="operations" if flops / PEAK_FP32_FLOPS >= nbytes / HBM_BYTES_PER_S else "bytes",
                ms=_time_ms(lambda: im2col_conv.conv2d_im2col(x, w, stride=st)),
                plain_ms=_time_ms(lambda: im2col_conv.conv2d_im2col_plain(x, w, stride=st)),
                library_ms=_time_ms(lambda: F.conv2d(xp, wl, stride=st)),
            )
            row["tflops"] = flops / row["ms"] / 1e9
        rows.append(row)
        print(f"[check] conv2d_im2col {json.dumps(row)}")

    # one forward of full-width SynthNet at a microbatch of 2: each shape
    # weighted by the number of layers that run it
    fwd = [r for r in rows if "layers" in r]
    tot = {key: sum(len(r["layers"]) * r[key] for r in fwd) for key in ("flops", "bytes", "ms", "plain_ms", "library_ms")}
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
    }


def main() -> int:
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

    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
