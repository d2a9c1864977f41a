"""Batched LM serving on the PyTorch port: prefill a prompt batch, decode
with the ring cache (attention, dense or MoE FFN; whisper's decoder beside
its cross K/V; internvl's patch prefix) or the SSM state (Mamba2).

    PYTHONPATH=src python examples/serve_lm_torch.py --arch granite-3-2b      # smoke config, on the card
    PYTHONPATH=src python examples/serve_lm_torch.py --arch mamba2-130m --device cpu
    PYTHONPATH=src python examples/serve_lm_torch.py --arch phi3.5-moe-42b --device cpu
    PYTHONPATH=src python examples/serve_lm_torch.py --arch whisper-small --device cpu
    PYTHONPATH=src python examples/serve_lm_torch.py --arch internvl2-76b --device cpu

Full width: ``python -m repro_torch.launch.serve --arch granite-3-2b --scale full``.
"""

import argparse

from repro_torch.configs import ARCHS, get_smoke
from repro_torch.launch.serve import serve

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="granite-3-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cfg = get_smoke(args.arch)
    out = serve(cfg, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen, device=args.device)
    print(
        f"[example] {args.arch}: generated {tuple(out['tokens'].shape)} tokens | "
        f"prefill {out['prefill_s']:.2f}s | decode {out['decode_tok_per_s']:.1f} tok/s"
    )
