"""Time the bf16 flash kernel's two tilings at head dim 128 beside SDPA.

    python3 scripts/flash_tiles.py

The shipped ``flash_fwd_mma_bf16_kernel<128>`` runs 8 warps a block (128
query rows, one block an SM).  This script builds ``csrc/flash_attention.cu``
once more with ``-DFLASH_D128_WARPS=4`` (64 query rows, two blocks an SM),
at the same time as the shipped library, and times both through the port's
wrapper at the prefill attention shapes of phi3.5-moe and llama4-scout
(bf16, causal, q/k/v as the model's transposed views), in the order 8, 4,
4, 8: device time per call from the profiler and CUDA events around 20
calls, with ``chip_smoke.py``'s helpers, and SDPA the same way.  Prints the
card's name and power limit, each build's ``ptxas`` line for D 128, and one
JSON line per shape.  Needs one CUDA device.
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

MODELS = ("phi3.5-moe-42b", "llama4-scout-17b")
WARPS = (8, 4)


def _ptxas_d128(log: str) -> str:
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if re.search(r"flash_fwd_mma_bf16_kernelILi128EE", line) and "Compiling entry function" in line:
            return " | ".join(x.split(":", 1)[-1].strip() for x in lines[i + 2 : i + 4])
    raise RuntimeError("ptxas reported no flash_fwd_mma_bf16_kernel<128>")


def _build() -> dict[int, ctypes.CDLL]:
    """The shipped library (8 warps at D 128) and a 4-warp copy, built at once."""
    w4 = build.BUILD_DIR / f"{build.library_path('flash_attention').stem}-w4.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen(build.nvcc_command("flash_attention", w4) + ["-DFLASH_D128_WARPS=4"],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {8: build.library("flash_attention")}
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"nvcc exited {proc.returncode}:\n{log}")
    print(f"[ptxas] 8 warps: {_ptxas_d128(build.ptxas_report('flash_attention'))}")
    print(f"[ptxas] 4 warps: {_ptxas_d128(log)}")
    libs[4] = ctypes.CDLL(str(w4))
    return libs


def _using(lib: ctypes.CDLL):
    """Point the wrapper at ``lib`` for the duration of the context."""
    fa._kernel.cache_clear()
    return mock.patch.object(build, "library", lambda name: lib)


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_tiles: no CUDA device visible", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(f"[card] {smi.stdout.strip().splitlines()[0]}")
    libs = _build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for arch in MODELS:
        cfg = get_config(arch)
        b, s, d = cs.LM_BATCH, cs.LM_PROMPT, cfg.hd
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda").to(torch.bfloat16).transpose(1, 2)
                   for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
        want = fa.flash_attention_plain(q, k, v)
        out: dict = {"model": arch, "q": list(q.shape)}

        def kern():
            return fa.flash_attention(q, k, v)

        for w in (*WARPS, *reversed(WARPS)):
            with _using(libs[w]):
                err = (kern().float() - want.float()).abs().max().item()
                out[f"max_abs_err_w{w}"] = err
                out.setdefault(f"device_ms_w{w}", []).append(cs._device_ms(kern)[0])
                out.setdefault(f"event_ms_w{w}", []).append(cs._time_ms(kern))
        fa._kernel.cache_clear()
        qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()

        def sdpa():
            return F.scaled_dot_product_attention(qc, kc, vc, is_causal=True, enable_gqa=True)

        out["sdpa_device_ms"] = cs._device_ms(sdpa)[0]
        out["sdpa_event_ms"] = cs._time_ms(sdpa)
        print(json.dumps(out))
        if max(out[f"max_abs_err_w{w}"] for w in WARPS) > cs.BF16_REL_TOL * want.float().abs().max().item():
            raise RuntimeError(f"{arch}: a tiling disagrees with the plain version: {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
