"""Batched LM serving on the port: prefill + greedy decode with the ring KV
cache (attention) or the SSM state (Mamba2).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b --scale full   # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small --device cpu

Port of ``repro.launch.serve``: the same inputs (prompt, whisper's frames,
internvl's patch embeddings, all from one ``default_rng(seed)``), the same
prefill -> decode loop and the same result keys.  Weights are drawn
from ``torch.Generator(device).manual_seed(seed)``.  Prefill and decode are
timed on the host clock around ``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCHS, get_config, get_smoke
from ..models.lm_common import LMConfig, init_params
from ..models.transformer import prefill_step, serve_step


def make_batch(cfg: LMConfig, batch: int, prompt_len: int, seed: int, device: str | torch.device) -> dict:
    """The reference's serving inputs, drawn from one ``default_rng(seed)``
    in its order: ``tokens`` [batch, prompt_len] (``integers(0, vocab)``),
    then for enc-dec ``frames`` [batch, enc_frames, d_model] and for a patch
    prefix ``patch_embeds`` [batch, n_patches, d_model] (standard normal,
    fp32)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (batch, prompt_len)), dtype=torch.int64, device=device)}
    for key, on, n in (("frames", cfg.is_encdec, cfg.enc_frames), ("patch_embeds", cfg.n_patches, cfg.n_patches)):
        if on:
            out[key] = torch.as_tensor(rng.standard_normal((batch, n, cfg.d_model)), dtype=torch.float32, device=device)
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def serve(
    cfg: LMConfig,
    *,
    batch: int = 4,
    prompt_len: int = 32,
    gen: int = 16,
    seed: int = 0,
    greedy: bool = True,
    device: str | torch.device = "cuda",
) -> dict:
    """Prefill a batch of ``prompt_len`` random tokens, then decode ``gen``
    tokens greedily.  Returns ``tokens`` [batch, gen], ``prefill_s`` and
    ``decode_tok_per_s`` (the first token comes from prefill)."""
    if not greedy:
        raise NotImplementedError("only greedy decoding is implemented, as in the reference")
    device = torch.device(device)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(seed), device)
    max_len = prompt_len + gen
    inputs = make_batch(cfg, batch, prompt_len, seed, device)

    _sync(device)
    t0 = time.perf_counter()
    logits, cache = prefill_step(cfg, params, inputs, max_len=max_len)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    tok = torch.argmax(logits, dim=-1)[:, None]
    out_tokens = [tok]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache = serve_step(cfg, params, cache, tok)
        tok = torch.argmax(logits, dim=-1)[:, None]
        out_tokens.append(tok)
    _sync(device)
    t_decode = time.perf_counter() - t0
    return {
        "tokens": torch.cat(out_tokens, dim=1),
        "prefill_s": t_prefill,
        "decode_tok_per_s": batch * (gen - 1) / max(t_decode, 1e-9),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="granite-3-2b")
    ap.add_argument("--scale", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_smoke(args.arch) if args.scale == "smoke" else get_config(args.arch)
    out = serve(cfg, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen, device=args.device)
    print(
        f"[serve] {args.arch} tokens={tuple(out['tokens'].shape)} "
        f"prefill={out['prefill_s']:.3f}s decode={out['decode_tok_per_s']:.1f} tok/s"
    )


if __name__ == "__main__":
    main()
