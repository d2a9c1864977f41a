"""End-to-end training driver of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b --scale smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b --scale full --batch 4 --seq 512  # the card

Port of ``repro.launch.train``: synthetic data pipeline -> train step ->
async checkpoints -> fault supervision, with the same arguments, plus
``device`` (the card unless the caller asks for the CPU).  Weights are drawn
by ``init_params(cfg, torch.Generator(device).manual_seed(seed))`` where the
reference draws from ``PRNGKey(seed)``; the two give different weights.
The step runs eagerly (no ``jit``).  Every architecture trains on the card
and on the CPU.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from ..checkpoint import CheckpointStore
from ..configs import ARCHS, get_config, get_smoke
from ..data import DataConfig, make_batch_iterator
from ..models.lm_common import LMConfig, init_params
from ..models.transformer import make_train_step
from ..optim import AdamW, AdamWConfig
from ..runtime import TrainSupervisor


def train(
    cfg: LMConfig,
    *,
    steps: int = 100,
    schedule_steps: int | None = None,  # cosine horizon (resume must keep it fixed)
    batch: int = 8,
    seq: int = 64,
    lr: float = 3e-4,
    ckpt_dir: Path | None = None,
    save_every: int = 50,
    log_every: int = 10,
    resume: bool = True,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> dict:
    """Train ``cfg`` from seeded random weights for ``steps`` steps (from
    the latest checkpoint in ``ckpt_dir`` when ``resume``).  Returns
    ``{"losses": [...], "state": {"params", "opt"}, "steps_per_s": float}``,
    steps/s on the host clock around the loop."""
    device = torch.device(device)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(seed), device)
    horizon = schedule_steps or steps
    opt = AdamW(AdamWConfig(peak_lr=lr, warmup=min(20, horizon // 5 + 1), total_steps=horizon))
    step_fn = make_train_step(cfg, opt)

    data_cfg = DataConfig(batch=batch, seq=seq, vocab=cfg.vocab, seed=seed)
    start = 0
    store = None
    state = {"params": params, "opt": opt.init(params)}
    if ckpt_dir is not None:
        store = CheckpointStore(Path(ckpt_dir))
        if resume:
            restored = store.restore_latest(state)
            if restored is not None:
                start, state = restored
                print(f"[train] resumed from step {start}")

    it = make_batch_iterator(cfg, data_cfg, start_step=start, device=device)
    losses: list[float] = []
    t0 = time.perf_counter()

    def one_step(st: dict, step: int) -> tuple[dict, float]:
        p, o, m = step_fn(st["params"], st["opt"], next(it))
        return {"params": p, "opt": o}, float(m["loss"])

    if store is not None:
        sup = TrainSupervisor(store=store, save_every=save_every)
        state, losses = sup.run(state, one_step, n_steps=steps, start_step=start)
    else:
        for step in range(start, steps):
            state, loss = one_step(state, step)
            losses.append(loss)
            if log_every and step % log_every == 0:
                print(f"[train] step {step} loss {loss:.4f}")
    dt = time.perf_counter() - t0
    return {"losses": losses, "state": state, "steps_per_s": (steps - start) / max(dt, 1e-9)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="qwen2-0.5b")
    ap.add_argument("--scale", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", type=Path, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cfg = get_smoke(args.arch) if args.scale == "smoke" else get_config(args.arch)
    out = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt, device=args.device)
    l = out["losses"]
    print(f"[train] {args.arch} first={l[0]:.4f} last={l[-1]:.4f} steps/s={out['steps_per_s']:.2f}")


if __name__ == "__main__":
    main()
