"""Time the bf16 wgmma GEMM kernel whole and in parts, beside ``torch.bmm``.

    python3 scripts/gemm_probe.py

Builds ``csrc/gemm.cu`` six more times, at the same time as the shipped
library, with ``-DGEMM_PROBE=1`` (the loads alone: no products), ``2`` (the
products alone: no loads), ``3`` (no 2-block clusters: every block loads
its own A tile), ``4`` (no epilogue stores), ``5`` (every product on the
long-reduction schedule: one block a tile, stores from registers) and
``6`` (every product on the short-reduction one: a persistent grid,
stores by TMA), and times
``gemm_wgmma_bf16_kernel`` through the port's wrapper at the MoE prefill
shapes of phi3.5-moe and llama4-scout (bf16, 16 experts, capacities 320 and
160, gate/up and down) and at phi3.5-moe's training shapes' gradients (the
capacity 320 of batch 4 x 512): dA = dC·Bᵀ with Bᵀ read K-major and dB =
Aᵀ·dC with Aᵀ read MN-major, both as the transposed views
``ops.gemm``'s backward passes.  In the order shipped, probes, shipped:
device time per call from the profiler, with
``chip_smoke.py``'s helper, and ``torch.bmm`` on the same views the same
way.  When the loads alone take about as long as the whole kernel, the
loads bound it; when the products alone do, the tensor cores; what the
kernel saves without its stores is what its epilogue costs.  Prints the
card's name and power limit and one JSON line per shape; fails if a build
that computes the product (shipped, no cluster, either schedule)
disagrees with the plain version.  Needs one CUDA device.
"""

from __future__ import annotations

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
#: build -> its GEMM_PROBE value (None: the shipped library)
PROBES = {"shipped": None, "loads alone": 1, "products alone": 2, "no cluster": 3, "no stores": 4,
          "long schedule": 5, "short schedule": 6}


def _build() -> dict[str, ctypes.CDLL]:
    """The shipped library and one copy per probe, all compiled at once."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = build.library_path("gemm").stem
    procs = {}
    for name, probe in PROBES.items():
        if probe is not None:
            out = build.BUILD_DIR / f"{stem}-probe{probe}.so"
            procs[name] = (out, subprocess.Popen(build.nvcc_command("gemm", out) + [f"-DGEMM_PROBE={probe}"],
                                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {"shipped": build.library("gemm")}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc ({name}) exited {proc.returncode}:\n{log}")
        libs[name] = ctypes.CDLL(str(out))
    return libs


def _using(lib: ctypes.CDLL):
    """Point the wrapper at ``lib`` for the duration of the context."""
    gm._kernel.cache_clear()
    return mock.patch.object(build, "library", lambda name: lib)


def main() -> int:
    if not torch.cuda.is_available():
        print("gemm_probe: no CUDA device visible", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(f"[card] {smi.stdout.strip().splitlines()[0]}")
    libs = _build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    order = [*PROBES, "shipped"]
    for model, what, a, b in _cases(gen):
        want = gm.gemm_plain(a, b).float()
        out: dict = {"model": model, "product": what, "a": list(a.shape), "b": list(b.shape),
                     "majors": list(gm.majors(a, b))}
        for name in order:
            with _using(libs[name]):
                got = gm.gemm(a, b)
                torch.cuda.synchronize()
                if PROBES[name] not in (1, 2, 4):
                    err = (got.float() - want).abs().max().item()
                    out[f"max_abs_err {name}"] = err
                    if not torch.allclose(got.float(), want, rtol=cs.GEMM_TOL[torch.bfloat16],
                                          atol=cs.GEMM_TOL[torch.bfloat16]):
                        raise RuntimeError(f"{model} {what}: the {name} build disagrees with the plain version")
                out.setdefault(f"device_ms {name}", []).append(cs._device_ms(lambda: gm.gemm(a, b))[0])
        gm._kernel.cache_clear()
        out["bmm device_ms"] = cs._device_ms(lambda: torch.bmm(a, b))[0]
        print(json.dumps(out))
        del a, b, want
    return 0


def _cases(gen: torch.Generator):
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


if __name__ == "__main__":
    sys.exit(main())
