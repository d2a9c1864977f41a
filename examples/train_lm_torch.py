"""Train an LM end to end on the port, with checkpoint/restore and deterministic resume.

    PYTHONPATH=src python examples/train_lm_torch.py                  # ~8M params, on the card
    PYTHONPATH=src python examples/train_lm_torch.py --m100           # ~100M params
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 20

Twin of ``examples/train_lm.py``: the same two configurations, batch 8 of 128
tokens, checkpoints every 50 steps; weights from a ``torch.Generator``.
"""

import argparse
import tempfile
from pathlib import Path

from repro_torch.launch.train import train
from repro_torch.models.lm_common import LMConfig

SMALL = LMConfig(
    name="lm-8m", n_layers=6, d_model=256, n_heads=8, n_kv_heads=4,
    d_ff=1024, vocab=8192, remat="none",
)

M100 = LMConfig(
    name="lm-100m", n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
    d_ff=3072, vocab=32768, remat="none",
)

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--m100", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt", type=Path, default=Path(tempfile.gettempdir()) / "repro_torch_train_lm")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cfg = M100 if args.m100 else SMALL
    steps = args.steps or (200 if args.m100 else 120)
    print(f"[example] training {cfg.name}: {cfg.param_count() / 1e6:.1f}M params, {steps} steps on {args.device}")
    out = train(cfg, steps=steps, batch=8, seq=128, ckpt_dir=args.ckpt, save_every=50, log_every=10,
                device=args.device)
    l = out["losses"]
    print(f"[example] loss {l[0]:.3f} -> {l[-1]:.3f} over {len(l)} steps "
          f"({out['steps_per_s']:.2f} steps/s); checkpoints in {args.ckpt}")
