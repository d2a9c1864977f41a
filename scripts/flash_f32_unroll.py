"""Compare the fp32 flash forward's score-loop unroll: the shipped 8 against 2.

    python3 scripts/flash_f32_unroll.py

``flash_fwd_kernel<D>`` (fp32, SIMT) unrolls its score loop over D by
FLASH_F32_SCORE_UNROLL (``csrc/flash_attention.cu``, 8).  This script builds
``csrc/flash_attention.cu`` once more with ``-DFLASH_F32_SCORE_UNROLL=2``, at
the same time as the shipped library, prints each build's ``ptxas`` registers
and spills of ``flash_fwd_kernel`` at every head dim, and times both through
the port's wrapper at every head dim (fp32, causal, batch 4, 32 q-heads and 8
kv-heads, 512 positions, q/k/v as the model's transposed views), without the
log-sum-exp (serving) and with it (training), in the order 8, 2, 2, 8:
device time per call from the profiler and CUDA events around 20 calls,
with ``chip_smoke.py``'s helpers.  Each output is held against
``flash_attention_plain`` at ``chip_smoke.ATTN_TOL``.  Prints the card's name
and power limit and one JSON line per head dim.  Needs one CUDA device.
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

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

UNROLLS = (8, 2)
B, H, KVH, S = 4, 32, 8, 512


def _ptxas(log: str) -> dict[int, tuple[int, int, int]]:
    """(registers, spill-store bytes, spill-load bytes) of ``flash_fwd_kernel`` by head dim."""
    with mock.patch.object(build, "ptxas_report", lambda name: log):
        seen = cs._ptxas_entries("flash_attention", r"flash_fwd_kernelILi(\d+)EE")
    return {int(d): v for d, v in seen.items()}


def _build() -> dict[int, ctypes.CDLL]:
    """The shipped library (unroll 8) and a copy with unroll 2, built at once."""
    u2 = build.BUILD_DIR / f"{build.library_path('flash_attention').stem}-u2.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen(build.nvcc_command("flash_attention", u2) + ["-DFLASH_F32_SCORE_UNROLL=2"],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {8: build.library("flash_attention")}
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"nvcc exited {proc.returncode}:\n{log}")
    for u, text in ((8, build.ptxas_report("flash_attention")), (2, log)):
        for d, (regs, st, ld) in sorted(_ptxas(text).items()):
            print(f"[ptxas] unroll {u}: flash_fwd_kernel<{d}>: {regs} registers, spill stores {st} B, "
                  f"spill loads {ld} B")
    libs[2] = ctypes.CDLL(str(u2))
    return libs


def _using(lib: ctypes.CDLL):
    """Point the wrapper at ``lib`` for the duration of the context."""
    fa._kernel.cache_clear()
    return mock.patch.object(build, "library", lambda name: lib)


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_f32_unroll: no CUDA device visible", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(f"[card] {smi.stdout.strip().splitlines()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = _build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    failed = []
    for d in fa.HEAD_DIMS:
        q, k, v = (torch.randn((B, S, h, d), generator=gen, device="cuda").transpose(1, 2) for h in (H, KVH, KVH))
        want = fa.flash_attention_plain(q, k, v)
        tol = cs.ATTN_TOL * want.abs().max().item()
        out: dict = {"q": list(q.shape), "k": list(k.shape)}
        for u in (*UNROLLS, *reversed(UNROLLS)):
            with _using(libs[u]):
                for kind, lse in (("serve", False), ("train", True)):
                    def kern(lse=lse):
                        return fa.flash_attention(q, k, v, return_lse=lse)

                    got = kern()
                    err = ((got[0] if lse else got) - want).abs().max().item()
                    out[f"max_abs_err_u{u}_{kind}"] = err
                    if not err <= tol:
                        failed.append(f"D {d} unroll {u} {kind}: {err} > {tol}")
                    out.setdefault(f"device_ms_u{u}_{kind}", []).append(cs._device_ms(kern)[0])
                    out.setdefault(f"event_ms_u{u}_{kind}", []).append(cs._time_ms(kern))
        fa._kernel.cache_clear()
        print(json.dumps(out))
    if failed:
        print("flash_f32_unroll: disagrees with the plain version:\n" + "\n".join(failed), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
