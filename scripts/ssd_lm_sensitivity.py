"""How far an SSD model's bf16 logits move when the SSD scan's output moves by about a rounding or less.

    python3 scripts/ssd_lm_sensitivity.py [--arch mamba2-130m] [--seeds 0 1] [--depths 12 24] [--model bf16 mixed] [--scans ...]
    python3 scripts/ssd_lm_sensitivity.py --arch zamba2-2.7b --depths 54 --model mixed

The tensor-core SSD scan feeds bf16 operands to its products, so its bf16
output can differ from the plain version's (fp32 inside) by a rounding in
some elements, every call within ``chip_smoke.BF16_REL_TOL``.  This
measures, on the card, the logits of ``--arch`` (mamba2-130m, or zamba2-2.7b,
whose depths must be whole groups of its 6 SSD layers) against the plain path (max
|difference| over max |logit|, random weights and prompt from each seed,
bf16, prefill plus 4 teacher-forced decode steps as ``chip_smoke.py`` runs
them) at each depth, with ``ops.ssd_scan`` as:

- ``kernel``: the kernel path (the tensor-core kernel at this shape);
- ``kernel_<k>term``: the same with the tensor-core kernel built to split
  each product operand that is not exact in bf16 into k bf16 terms
  (``-DSSD_TERMS=k``; ``kernel`` is the shipped build);
- ``simt``: the SIMT kernel ``ssd_scan_kernel<__nv_bfloat16>``, which
  repeats the plain version's fp32 arithmetic;
- ``plain_x(1+eps)``: the plain version with each output multiplied by
  1 + eps before its rounding (a biased change of known size);
- ``plain_rz``: the plain version with each output rounded toward zero
  to bf16 rather than to nearest (a biased rounding; ``chip_smoke.py``'s
  control);
- ``model_<k>term``: the plain version with the operands that the
  tensor-core kernel feeds to its products (C.B^T o L o dt, w o B and the
  copy of the state) rounded to a sum of k bf16 values, all sums in fp32:
  what a kernel that splits each such operand into k bf16 terms computes,
  but for the order of its sums.

``--model mixed`` (a default, beside ``bf16``) runs the same comparison on the model in fp32, weights
and activations, with each scan's x, B and C rounded to bf16 on the way
in and its bf16 output widened on the way out, in both paths (as
``chip_smoke.py`` holds it): the bf16 scan's roundings carried through
the layers without the bf16 roundings of every other op.

First, at the prefill scan's shape (inputs as ``chip_smoke.ssd_inputs``
draws them), the share of bf16 outputs of each scan that differ from the
plain version's.  Prints the card's name and power limit and one JSON line
per measurement.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))
import chip_smoke as cs  # noqa: E402  (also puts the port on sys.path)
import ssd_probe  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.launch.serve import make_prompt  # noqa: E402
from repro_torch.models.lm_common import init_params  # noqa: E402

EPS = (1e-6, 1e-4, 4e-3)
TERMS = (1, 2, 3)


def _first_layers(params: dict, n: int) -> dict:
    """The parameter tree cut to its first ``n`` layers (views of the stacks)."""
    return {k: {kk: vv[:n] for kk, vv in v.items()} if k == "blocks" else v for k, v in params.items()}


def simt_scan(x, dt, A, B, C, *, chunk=64):
    """The SIMT kernel on bf16 inputs, which the route sends to the tensor cores."""
    b, _, h, p = x.shape
    return ssd._launch(x, dt, A, B, C, chunk, ssd._plan_of(1, b, h, p, B.shape[-1], chunk, ssd.SIMT_P_TILE))


@contextlib.contextmanager
def perturbed_plain(eps: float):
    """``ops.ssd_scan`` as the plain version with each output multiplied by
    1 + eps before its rounding to x's type."""
    def perturbed(x, dt, A, B, C, *, chunk=64):
        y, st = ssd.ssd_scan_plain(x.float(), dt, A, B.float(), C.float(), chunk=chunk)
        return (y * (1 + eps)).to(x.dtype), st

    with mock.patch.object(ops, "ssd_scan", perturbed):
        yield


def _terms(v: torch.Tensor, k: int) -> torch.Tensor:
    """``v`` as the sum of ``k`` bf16 values, each the rounding of what the earlier ones left."""
    out = torch.zeros_like(v)
    for _ in range(k):
        t = (v - out).to(torch.bfloat16).float()
        out = out + t
    return out


def model_scan(k: int):
    """The plain version with the tensor-core kernel's product operands as ``k`` bf16 terms."""
    def scan(x, dt, A, B, C, *, chunk=64):
        b, l, h, p = x.shape
        idx = torch.arange(chunk, device=x.device)
        causal = (idx[:, None] >= idx[None, :])[None, None]
        state = torch.zeros((b, h, p, B.shape[-1]), device=x.device)
        ys = []
        for c in range(l // chunk):
            sl = slice(c * chunk, (c + 1) * chunk)
            xc, dtc = x[:, sl].float(), dt[:, sl].float().permute(0, 2, 1)  # [b, s, h, p], [b, h, s]
            Bc, Cc = B[:, sl].float(), C[:, sl].float()
            cum = torch.cumsum(dtc * A[None, :, None], dim=-1)  # [b, h, s]
            g = torch.einsum("bln,bsn->bls", Cc, Bc)[:, None]
            gl = torch.where(causal, g * torch.exp(cum[..., :, None] - cum[..., None, :]) * dtc[..., None, :], 0.0)
            inter = torch.exp(cum)[..., None] * torch.einsum("bln,bhpn->bhlp", Cc, _terms(state, k))
            ys.append((inter + torch.einsum("bhls,bshp->bhlp", _terms(gl, k), xc)).permute(0, 2, 1, 3))
            bw = _terms(Bc[:, None] * (torch.exp(cum[..., -1:] - cum) * dtc)[..., None], k)  # [b, h, s, n]
            state = state * torch.exp(cum[..., -1])[..., None, None] + torch.einsum("bshp,bhsn->bhpn", xc, bw)
        return torch.cat(ys, dim=1).to(x.dtype), state

    return scan


@contextlib.contextmanager
def kernel_build(k: int):
    """The kernel path on a build of the tensor-core kernel with ``k`` bf16 terms."""
    lib = ssd_probe.build_variants({k: f"SSD_TERMS={k}"})[k]
    with ssd_probe.using(lib):
        yield
    ssd._kernel.cache_clear()


#: ops.ssd_scan as each measured scan
SCANS = {
    "kernel": contextlib.nullcontext,
    **{f"kernel_{k}term": (lambda k=k: kernel_build(k)) for k in TERMS[:-1]},
    "simt": lambda: mock.patch.object(ops, "ssd_scan", simt_scan),
    **{f"plain_x(1+{e:g})": (lambda e=e: perturbed_plain(e)) for e in EPS},
    "plain_rz": cs._plain_toward_zero,
    **{f"model_{k}term": (lambda k=k: mock.patch.object(ops, "ssd_scan", model_scan(k))) for k in TERMS},
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=cs.SSD_MODELS, default="mamba2-130m")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--depths", type=int, nargs="+", default=[12, 24])
    ap.add_argument("--model", choices=("bf16", "mixed"), nargs="+", default=["bf16", "mixed"])
    ap.add_argument("--scans", nargs="+", choices=tuple(SCANS), default=list(SCANS))
    args = ap.parse_args()
    scans = {name: SCANS[name] for name in args.scans}
    if not torch.cuda.is_available():
        print("ssd_lm_sensitivity: no CUDA device visible", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(f"[card] {smi.stdout.strip().splitlines()[0]}")
    bf16 = torch.bfloat16
    cfg = get_config(args.arch)
    for seed in args.seeds:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        x, dt, A, B, C = cs.ssd_inputs(cs.LM_BATCH, cs.LM_PROMPT, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                                       bf16, True, gen)
        yp, _ = ssd.ssd_scan_plain(x, dt, A, B, C, chunk=cfg.ssm_chunk)
        for name, scan in scans.items():
            with scan():
                y, _ = ops.ssd_scan(x, dt, A, B, C, chunk=cfg.ssm_chunk)
            torch.cuda.synchronize()
            print(json.dumps({"seed": seed, "scan": name,
                              "outputs_differing_from_plain": (y != yp).float().mean().item(),
                              "max_abs_err_over_max_plain": (y.float() - yp.float()).abs().max().item()
                              / yp.float().abs().max().item()}), flush=True)
        del x, dt, A, B, C, yp

        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
        prompt = make_prompt(cfg, cs.LM_BATCH, cs.LM_PROMPT, seed, "cuda")
        forced = torch.zeros((cs.LM_BATCH, cs.LM_FORCED), dtype=torch.long, device="cuda")
        for model, depth in ((m, d) for m in args.model for d in args.depths):
            dtype = bf16 if model == "bf16" else torch.float32
            c = dataclasses.replace(cfg, dtype=dtype, n_layers=depth)
            p = cs._cast(_first_layers(params, depth), dtype)
            around = contextlib.nullcontext if model == "bf16" else cs._bf16_scans
            with cs._plain_versions(), around():
                want = cs._forced_logits(c, p, prompt, forced)
            scale = want.float().abs().max().item()
            row = {"arch": args.arch, "seed": seed, "model": model, "layers": depth}
            for name, scan in scans.items():
                with scan(), around():
                    got = cs._forced_logits(c, p, prompt, forced)
                row[f"{name}_rel"] = (got.float() - want.float()).abs().max().item() / scale
                row[f"{name}_argmax"] = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
            print(json.dumps(row), flush=True)
        del params
    return 0


if __name__ == "__main__":
    sys.exit(main())
