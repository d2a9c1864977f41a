"""Dry run of the production layout: one rank's memory, FLOP and collective
profile of each cell, the H100 counterpart of ``repro/launch/dryrun.py``.

For every (architecture x input shape) cell, join a group of 256 fake ranks
(512 for ``--mesh multi``) as rank 0 of ``make_production_mesh``, build
this rank's blocks of the parameters, AdamW state, batch and decode cache
under the reference's sanitized specs (``launch/shardings.py``) on the
``meta`` device, and run the cell's real step once (``make_train_step``
with the cell's accumulation, ``prefill_step`` or ``serve_block``) under

* ``torch.utils.flop_counter.FlopCounterMode``, plus the hand-written
  kernels' own counts (``kernels.ops.count_meta``: a kernel's ``meta``
  branch computes nothing and reports its FLOPs and bytes by the formulas
  ``chip_smoke.py``'s bounds use);
* a count of the bytes every other operator reads and writes (views and
  factories aside), and of the live tensors' peak;
* ``collectives.count_collectives``: every collective the mesh paths issue,
  with the reference's ring wire bytes (``collectives.wire_bytes``).

The fake group moves nothing, so no other rank exists: the record is rank
0's.  It has the reference's keys (``memory``, ``cost``,
``collectives.by_op_single_iteration``, ``roofline`` with ``compute_s``,
``memory_s``, ``collective_s``, ``dominant``, ``model_flops`` and
``useful_flops_ratio``).  ``argument_bytes_per_dev`` is exact, the sum of
the rank's blocks; ``peak_estimate_gib`` is estimated from the live
``meta`` tensors (``peak_source`` says so).

XLA's cost analysis counts a ``while`` body once, and the reference
corrects that with a fit over depth-1 and depth-3 compiles.  The port's
layer loop is a Python loop that counts every layer, so no fit is needed.

The constants are the H100 SXM's spec-sheet figures (per card): 989e12
dense bf16 FLOP/s, 3.35e12 B/s of HBM3, and a link rate per mesh axis: an
axis of at most 8 consecutive ranks stays inside an 8-GPU node on NVLink
(450e9 B/s each way); a wider or strided one crosses InfiniBand (50e9 B/s a
GPU).  Both axes of the 16 x 16 mesh cross nodes.

With ``--device cuda`` a cell whose rank-0 arguments fit the card also runs
once for real on it, as rank 0 of the same fake group (the other ranks'
blocks of a gathered leaf are zeros): ``torch.cuda.max_memory_allocated``
and the step's device time by CUDA events join the record under
``measured``.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --skip-existing
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
import weakref
from pathlib import Path

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ARCHS, SHAPES, applicable, for_shape, get_config
from ..kernels import ops
from ..collectives import count_collectives
from ..models.layout import cache_pspecs, param_layout
from ..models.lm_common import LMConfig
from ..models.transformer import cache_shapes, make_train_step, prefill_step, serve_block
from ..optim import AdamW, AdamWConfig
from ..pipeline.hetero import H100_BF16_FLOPS, H100_HBM_BW
from ..sharding import P, dp_axes_of, mesh_shape, sanitize, shard_shape, tree_bytes
from .mesh import join_fake_group, make_production_mesh
from .shardings import batch_pspecs, init_shards

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

#: H100 SXM spec-sheet figures, per card
PEAK_FLOPS = H100_BF16_FLOPS
HBM_BW = H100_HBM_BW
NVLINK_BW = 450e9
IB_BW = 50e9
#: GPUs of a node that NVLink joins
NODE = 8
#: the card's memory, bytes: a cell whose rank-0 arguments pass it is not run on the card
CARD_BYTES = 80e9


def link_bw(mesh, axis: str) -> float:
    """B/s of one rank along ``axis``: NVLink when the axis is the innermost
    and its ranks fit one node, InfiniBand otherwise."""
    shape = mesh_shape(mesh)
    inner = list(shape)[-1] == axis
    return NVLINK_BW if inner and shape[axis] <= NODE else IB_BW


# ---------------------------------------------------------------------------
# Input specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Spec:
    """A shape and a dtype, the counterpart of ``jax.ShapeDtypeStruct``."""

    shape: tuple[int, ...]
    dtype: torch.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)


def input_specs(cfg: LMConfig, shape_name: str, cell=None) -> dict:
    """:class:`Spec` stand-ins for every model input of this cell."""
    cell = cell or SHAPES[shape_name]
    B, S = cell.global_batch, cell.seq_len
    i32 = torch.int32
    if cfg.is_encdec:
        dec = min(S, cfg.max_decoder_len or S)
        batch = {"frames": Spec((B, cfg.enc_frames, cfg.d_model), cfg.dtype), "tokens": Spec((B, dec), i32)}
        if cell.phase == "train":
            batch["labels"] = Spec((B, dec), i32)
        return batch
    if cfg.n_patches and cell.phase != "decode":
        s_text = S - cfg.n_patches
        batch = {"tokens": Spec((B, s_text), i32), "patch_embeds": Spec((B, cfg.n_patches, cfg.d_model), cfg.dtype)}
        if cell.phase == "train":
            batch["labels"] = Spec((B, s_text), i32)
        return batch
    batch = {"tokens": Spec((B, S), i32)}
    if cell.phase == "train":
        batch["labels"] = Spec((B, S), i32)
    return batch


def _dptot(mesh) -> int:
    total = 1
    for a in dp_axes_of(mesh):
        total *= mesh_shape(mesh)[a]
    return total


def _maybe_dp(mesh, spec_tree, batch_size):
    """Replicate the batch axis when it doesn't divide the DP extent.  As the
    reference's, it matches the whole tuple of data axes, so a one-axis
    mesh's ``"data"`` entry stays (``sanitize`` drops it from a cache's
    batch dim; the dry run's decode tokens take no batch split)."""
    if batch_size % _dptot(mesh) == 0:
        return spec_tree
    dp = dp_axes_of(mesh)
    strip = lambda s: P(*(None if e == dp or e == list(dp) else e for e in s))
    return {k: strip(v) if isinstance(v, P) else _maybe_dp(mesh, v, batch_size) for k, v in spec_tree.items()}


def _accum_for(cfg: LMConfig, cell) -> int:
    """Gradient-accumulation depth for train cells (activation-memory fit)."""
    if cell.phase != "train":
        return 1
    if cfg.d_model >= 8192:
        return 8
    if cfg.d_model >= 4096:
        return 4
    return 1


def _model_flops(cfg: LMConfig, cell) -> float:
    """MODEL_FLOPS: 6·N·D train, 2·N·D forward-only (N = active params)."""
    n_active = cfg.active_param_count()
    if cell.phase == "train":
        dec = min(cell.seq_len, cfg.max_decoder_len or cell.seq_len) if cfg.is_encdec else cell.seq_len
        return 6.0 * n_active * cell.global_batch * dec
    if cell.phase == "prefill":
        dec = min(cell.seq_len, cfg.max_decoder_len or cell.seq_len) if cfg.is_encdec else cell.seq_len
        return 2.0 * n_active * cell.global_batch * dec
    return 2.0 * n_active * cell.global_batch  # decode: one token per sequence


def by_op(colls: list[dict]) -> dict:
    """Collectives summed by op: ``{op: {"count", "bytes", "wire_bytes"}}``."""
    out: dict[str, dict] = {}
    for c in colls:
        d = out.setdefault(c["op"], {"count": 0, "bytes": 0.0, "wire_bytes": 0.0})
        d["count"] += 1
        d["bytes"] += c["bytes"]
        d["wire_bytes"] += c["wire_bytes"]
    return out


# ---------------------------------------------------------------------------
# Counting
# ---------------------------------------------------------------------------

_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "detach", "lift_fresh",
               "_to_copy_meta", "alias", "set_"}


class _Traffic(TorchDispatchMode):
    """Bytes every operator reads and writes (views and allocations aside),
    and the peak of the live tensors the operators made, on top of a base."""

    def __init__(self, base: int):
        super().__init__()
        self.bytes, self.live, self.peak = 0.0, base, base

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if func.is_view or name in _NO_TRAFFIC or not isinstance(out, (torch.Tensor, tuple, list)):
            return out
        ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        for t in outs:
            if not any(t is i for i in ins):
                n = t.numel() * t.element_size()
                self.live += n
                weakref.finalize(t, self._free, n)
        self.peak = max(self.peak, self.live)
        return out


def _alloc(specs: dict, sizes: dict, whole: dict, device, gen: torch.Generator | None, ints: int | None = None
           ) -> dict:
    """The rank's blocks of the tensors ``whole`` (``{name: Spec}``) under
    ``specs``: empty on ``meta``; on a device random (integers below
    ``ints``), or zeros when ``ints`` is None (a fresh cache)."""
    out = {}
    for k, s in whole.items():
        shape = shard_shape(s.shape, specs[k], sizes)
        if torch.device(device).type == "meta":
            t = torch.empty(shape, dtype=s.dtype, device=device)
        elif ints is None:
            t = torch.zeros(shape, dtype=s.dtype, device=device)
        elif s.dtype.is_floating_point:
            t = torch.randn(shape, generator=gen, device=device).to(s.dtype)
        else:
            t = torch.randint(0, ints, shape, generator=gen, device=device, dtype=s.dtype)
        out[k] = t
    return out


def build(cfg: LMConfig, cell, mesh, shape_name: str, device="meta", seed: int = 0, accum: int | None = None):
    """(this rank's step as a no-argument function, its arguments' bytes):
    the parameters, optimizer state, batch and cache as the rank's blocks
    on ``device``; a train step accumulates ``accum`` microbatches (default
    the cell's)."""
    sizes = mesh_shape(mesh)
    dp = dp_axes_of(mesh)
    gen = None if torch.device(device).type == "meta" else torch.Generator(device=device).manual_seed(seed)
    pspec = param_layout(cfg, mesh)
    params = init_shards(cfg, mesh, pspec, gen, device)
    whole = input_specs(cfg, shape_name, cell)
    divisible = cell.global_batch % _dptot(mesh) == 0
    batch_dp = dp if divisible else ()
    if cell.phase == "decode":
        B, S = cell.global_batch, cell.seq_len
        from ..models.transformer import _ring_width  # the ring init_cache would give: one rule

        shapes = cache_shapes(cfg, B, _ring_width(cfg, S))
        cwhole = {k: Spec(tuple(s), d) for k, (s, d) in shapes.items()}
        cspec = sanitize(mesh, cwhole, _maybe_dp(mesh, cache_pspecs(cfg, mesh, cwhole), B))
        cache = _alloc(cspec, sizes, cwhole, device, gen)
        for k in cache:
            if k.endswith("pos"):
                cache[k].fill_(-1)
        cache["index"] = 0
        tspec = P(dp if divisible else None, None)
        tokens = _alloc({"t": tspec}, sizes, {"t": Spec((B, 1), torch.int32)}, device, gen, cfg.vocab)["t"]
        args = tree_bytes(params) + tree_bytes(cache) + tree_bytes({"t": tokens})
        return (lambda: serve_block(cfg, params, cache, tokens, mesh, batch_dp, "model")), args
    bspec = _maybe_dp(mesh, batch_pspecs(cfg, mesh, whole), cell.global_batch)
    batch = _alloc(bspec, sizes, whole, device, gen, cfg.vocab)
    if cell.phase == "prefill":
        return (lambda: prefill_step(cfg, params, batch, mesh, batch_dp, "model")), tree_bytes(params) + tree_bytes(batch)
    opt = AdamW(AdamWConfig())
    state = opt.init(params)
    step = make_train_step(cfg, opt, mesh, batch_dp, "model", accum=accum or _accum_for(cfg, cell))
    args = tree_bytes(params) + tree_bytes(state) + tree_bytes(batch)
    return (lambda: step(params, state, batch)), args


def profile(fn, args: int) -> dict:
    """Run ``fn`` once on ``meta`` tensors under the counters."""
    traffic = _Traffic(args)
    # a tensor autograd saves stays alive (and counted) until the graph lets it go
    keep = torch.autograd.graph.saved_tensors_hooks(lambda t: t, lambda t: t)
    with count_collectives() as colls, ops.count_meta() as kern, FlopCounterMode(display=False) as fc, traffic, keep:
        out = fn()
    del out
    kflops = sum(r["flops"] for r in kern.values())
    kbytes = sum(r["bytes"] for r in kern.values())
    return {"flops": float(fc.get_total_flops()) + kflops, "bytes": traffic.bytes + kbytes, "peak": traffic.peak,
            "kernels": kern, "collectives": colls}


def _join(n: int) -> None:
    if dist.is_initialized():
        if dist.get_world_size() == n and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    join_fake_group(n)


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: Path | None = OUT_DIR, device: str = "meta",
             cfg: LMConfig | None = None, accum: int | None = None) -> dict:
    """The cell's record (module docstring); written to ``out_dir`` unless
    it is None.  ``cfg`` / ``accum`` override the cell's (``hillclimb``)."""
    runs, reason = applicable(arch, shape_name)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "runs": runs, "reason": reason}
    if not runs:
        return rec
    cfg = cfg or for_shape(get_config(arch), shape_name)
    cell = SHAPES[shape_name]
    _join(512 if mesh_kind == "multi" else 256)
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi", device="meta")
    n_chips = mesh.mesh.numel()
    cell_accum = accum or _accum_for(cfg, cell)
    t0 = time.time()
    fn, args = build(cfg, cell, mesh, shape_name, "meta", accum=cell_accum)
    prof = profile(fn, args)
    wire = sum(c["wire_bytes"] for c in prof["collectives"])
    collective_s = sum(c["wire_bytes"] / link_bw(mesh, c["axis"]) for c in prof["collectives"])
    compute_s, memory_s = prof["flops"] / PEAK_FLOPS, prof["bytes"] / HBM_BW
    dominant = max(("compute", compute_s), ("memory", memory_s), ("collective", collective_s), key=lambda kv: kv[1])[0]
    model_flops = _model_flops(cfg, cell)
    rec.update({
        "phase": cell.phase,
        "n_chips": n_chips,
        "accum": cell_accum,
        "profile_s": round(time.time() - t0, 1),
        "memory": {
            "argument_bytes_per_dev": args,
            "peak_estimate_gib": round(prof["peak"] / 2**30, 3),
            "peak_source": "estimated: live meta tensors of one step",
        },
        "cost": {"flops_per_dev": prof["flops"], "bytes_per_dev": prof["bytes"],
                 "hlo_flops_global": prof["flops"] * n_chips, "kernels": prof["kernels"]},
        "collectives": {"total_wire_bytes_per_dev": wire, "by_op_single_iteration": by_op(prof["collectives"]),
                        "n_ops": len(prof["collectives"])},
        "roofline": {"compute_s": compute_s, "memory_s": memory_s, "collective_s": collective_s,
                     "dominant": dominant, "model_flops": model_flops,
                     "useful_flops_ratio": model_flops / (prof["flops"] * n_chips) if prof["flops"] else None},
    })
    if torch.device(device).type == "cuda":
        rec["measured"] = measure_on_card(cfg, cell, shape_name, mesh_kind, cell_accum, args)
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{arch}__{shape_name}__{mesh_kind}.json").write_text(json.dumps(rec, indent=2))
    return rec


def measure_on_card(cfg: LMConfig, cell, shape_name: str, mesh_kind: str, accum: int, args: int) -> dict:
    """The cell's step once on the card as rank 0 of the fake group:
    arguments by ``memory_allocated``, the step's peak (from the built
    arguments on), its device time by CUDA events, and whether its outputs
    are finite.  Skipped when the arguments pass :data:`CARD_BYTES`."""
    if args > CARD_BYTES:
        return {"skipped": f"rank-0 arguments {args / 2**30:.1f} GiB pass the card's {CARD_BYTES / 1e9:.0f} GB"}
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi", device="cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    fn, cargs = build(cfg, cell, mesh, shape_name, "cuda", accum=accum)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before
    torch.cuda.reset_peak_memory_stats()  # the step's peak, not the random draws of the build
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()  # before the check below, whose temporaries are the size of the cache
    tensors = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor) and t.is_floating_point()]
    finite = all(bool(torch.isfinite(t).all()) for t in tensors)
    rec = {"argument_bytes": cargs, "allocated_after_build": held, "peak_bytes": peak,
           "step_ms": start.elapsed_time(end), "finite": finite, "device": torch.cuda.get_device_name(0)}
    del out, fn
    torch.cuda.empty_cache()
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", type=Path, default=OUT_DIR)
    ap.add_argument("--device", default="meta", choices=["meta", "cuda"])
    args = ap.parse_args()

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = [(a, s) for a in ARCHS for s in SHAPES] if args.all else [(args.arch, args.shape)]
    failures = 0
    for arch, shape in cells:
        for mk in meshes:
            if args.skip_existing and (args.out / f"{arch}__{shape}__{mk}.json").exists():
                print(f"[CACHED] {arch} {shape} {mk}")
                continue
            try:
                rec = run_cell(arch, shape, mk, args.out, args.device)
                if rec["runs"]:
                    r = rec["roofline"]
                    print(f"[OK] {arch:18s} {shape:12s} {mk:6s} compute={r['compute_s']:.3e}s "
                          f"memory={r['memory_s']:.3e}s collective={r['collective_s']:.3e}s dom={r['dominant']} "
                          f"args/dev={rec['memory']['argument_bytes_per_dev'] / 2**30:.3f}GiB "
                          f"peak~{rec['memory']['peak_estimate_gib']}GiB profile={rec['profile_s']}s", flush=True)
                else:
                    print(f"[SKIP] {arch:18s} {shape:12s} {mk:6s} — {rec['reason']}", flush=True)
            except Exception:
                failures += 1
                print(f"[FAIL] {arch} {shape} {mk}", flush=True)
                traceback.print_exc()
    if dist.is_initialized():
        dist.destroy_process_group()
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
