"""The port's mesh paths on the CPU over gloo, against the JAX package's.

The reference runs once, in a subprocess with four host devices (as
``tests/test_distributed.py`` runs it): its ``PipelineRunner`` over a stage
mesh, ``moe_ffn`` under ``shard_map`` with ``jax.grad``, a jitted
``make_train_step`` and prefill plus decode over a ``("data", "model")``
mesh, and ``compressed_psum`` under ``shard_map``; it writes its inputs,
weights and outputs to an ``.npz``.  The port then runs once as four rank
processes joined through a ``FileStore`` in the test's directory (each a
``python -c``, so nothing is pickled from this module), fed the same
arrays, and each rank writes what it computed; the tests compare.

Tolerances: the pipeline at the reference's ``rtol = atol = 1e-4``
(``tests/test_distributed.py``); ``moe_ffn``'s y and aux at 1e-4, its
gradients, the train step's parameters and its loss as
``tests/test_torch_train.py`` holds them (``LEAF_TOL``, ``LOSS_TOL``);
logits at 1e-4; ``compressed_psum`` at 1e-6 (the same int8 sums, fp32
scales).  The reference's mesh path computes another function than its
path without a mesh where a data shard's capacity or aux loss differs
(ROADMAP.md queue 3), so the port is held against the mesh path.

The port's mesh paths take each rank's blocks of the parameters and its
slice of the batch (``launch.shardings.local_shard``, ``batch_shard``):
every smoke architecture's train step, prefill and three decode steps (the
ring wrapping) run over (2, 2) and (1, 4) in the sharded layout, with the
residual stream split over the sequence (``sp_residuals``, the default, as
the reference's) and whole, and are held against the reference's jitted
mesh step with ``param_shardings`` in-shardings; each rank's stored bytes against the sum of the reference's
``NamedSharding.shard_shape``s; a sharded checkpoint save against both
packages' restores.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # CI installs requirements-dev.txt, which has no torch

from repro_torch import configs, tree
from repro_torch.models import blocks, lm_common, transformer

REPO = Path(__file__).resolve().parents[1]
LOSS_TOL = dict(rtol=1e-5, atol=0)
LEAF_TOL = dict(rtol=1e-3, atol=1e-4)
TOL = dict(rtol=1e-4, atol=1e-4)
PSUM_TOL = dict(rtol=1e-6, atol=1e-6)
MOE_ARCHS = ("phi3.5-moe-42b", "llama4-scout-17b")
MESHES = ((2, 1), (1, 2), (2, 2))
TRAIN_ARCHS = ("phi3.5-moe-42b", "internvl2-76b")
RANKS = 4
#: every smoke architecture, run in the sharded layout over each of SHARDED_MESHES, with the ring's max_len
#: (the ring wraps on the third decode step; (1, 4)'s ring of 10 slots splits its head dim, not its slots;
#: the hybrid keeps 8, the width of the reference's prefill ring)
ALL_ARCHS = configs.ARCHS
SHARDED_MESHES = {(2, 2): 8, (1, 4): 10}

# ---------------------------------------------------------------------------
# The reference, once, on four host devices
# ---------------------------------------------------------------------------

REFERENCE = r"""
import dataclasses, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.compat import shard_map
from repro.configs import get_smoke
from repro.core import generate_seed, paper_platform
from repro.core.config import PipelineConfig
from repro.launch.mesh import make_stage_mesh
from repro.models import blocks
from repro.models import transformer as jtf
from repro.models.cnn import canonical_pipeline_apply, make_cnn, network_layers
from repro.models.lm_common import init_params, param_shardings
from repro.launch.shardings import sanitize
from repro.configs import ARCHS
from repro.optim import AdamW, AdamWConfig, compressed_psum
from repro.pipeline import PipelineRunner

out = {}
rng = np.random.default_rng(1)
devices = jax.devices()


def put(prefix, t):
    for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]:
        out[prefix + "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)] = np.asarray(leaf)


def mesh_of(shape, axes=("data", "model")):
    return Mesh(np.asarray(devices[: shape[0] * shape[1]]).reshape(shape), axes)


# the pipeline: SynthNet at scale 0.1, the H3 seed's 4 stages, and a 2-stage uneven split
model = make_cnn("synthnet", scale=0.1)
params = model.init(jax.random.PRNGKey(0))
put("cnn/", params)
in_shape = (8, 8, 8)
micro = rng.standard_normal((5, 2) + in_shape, dtype=np.float32)
out["pipe/micro"] = micro
apply_fn, to_canon, crop_out, _ = canonical_pipeline_apply(model, params, in_shape)
seed = generate_seed([l.weight for l in network_layers("synthnet")], paper_platform(4), n_stages=4).conf
for tag, conf in (("4", seed), ("2", PipelineConfig((5, 13), (0, 1)))):
    runner = PipelineRunner(mesh=make_stage_mesh(conf.depth), conf=conf, apply_layer=apply_fn, n_micro=5)
    out[f"pipe/{tag}/out"] = np.asarray(crop_out(runner.run(jax.vmap(to_canon)(jnp.asarray(micro)))))
    out[f"pipe/{tag}/stages"] = np.asarray(conf.stages)
    out[f"pipe/{tag}/eps"] = np.asarray(conf.eps)
out["pipe/seq"] = np.stack([np.asarray(model(params, jnp.asarray(micro[i]))) for i in range(5)])

# moe_ffn over each mesh: y, aux and jax.grad of sum(y * r) + aux
for arch in ("phi3.5-moe-42b", "llama4-scout-17b"):
    cfg = dataclasses.replace(get_smoke(arch), dtype=jnp.float32)
    blk = init_params(cfg, jax.random.PRNGKey(0))["blocks"]
    keys = ["router", "we_gate", "we_up", "we_down", "ln2"] + (
        ["ws_gate", "ws_up", "ws_down"] if cfg.n_shared_experts else [])
    lp = {k: blk[k][0] for k in keys}
    x = rng.standard_normal((4, 8, cfg.d_model), dtype=np.float32)
    r = rng.standard_normal((4, 8, cfg.d_model), dtype=np.float32)
    put(f"moe/{arch}/p/", lp)
    out[f"moe/{arch}/x"], out[f"moe/{arch}/r"] = x, r
    out[f"moe/{arch}/nomesh/aux"] = np.asarray(blocks.moe_ffn(cfg, lp, jnp.asarray(x))[1])
    for shape in ((2, 1), (1, 2), (2, 2)):
        mesh = mesh_of(shape)

        def f(p, xx):
            y, aux = blocks.moe_ffn(cfg, p, xx, mesh, ("data",), "model")
            return jnp.sum(y * r) + aux, (y, aux)

        with mesh:
            (_, (y, aux)), g = jax.jit(jax.value_and_grad(f, has_aux=True))(lp, jnp.asarray(x))
        tag = f"moe/{arch}/{shape[0]}x{shape[1]}/"
        out[tag + "y"], out[tag + "aux"] = np.asarray(y), np.asarray(aux)
        put(tag + "g/", g)

# one train step of each arch on (2, 2); the two data shards count different tokens
mesh = mesh_of((2, 2))
for arch in ("phi3.5-moe-42b", "internvl2-76b"):
    cfg = dataclasses.replace(get_smoke(arch), dtype=jnp.float32)
    params = init_params(cfg, jax.random.PRNGKey(0))
    batch = {"tokens": rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)}
    batch["labels"][0, :5] = -1
    batch["labels"][1, :2] = -1
    if cfg.n_patches:
        batch["patch_embeds"] = rng.standard_normal((4, cfg.n_patches, cfg.d_model), dtype=np.float32)
    opt = AdamW(AdamWConfig(total_steps=10, warmup=2, moment_dtype=jnp.float32))
    pspec = param_shardings(cfg)
    ospec = {"step": P(), "mu": pspec, "nu": pspec, "master": pspec}
    bspec = {k: P(("data",), *([None] * (v.ndim - 1))) for k, v in batch.items()}
    step = jax.jit(jtf.make_train_step(cfg, opt, mesh, ("data",), "model"), in_shardings=jax.tree.map(
        lambda s: NamedSharding(mesh, s), (pspec, ospec, bspec), is_leaf=lambda s: isinstance(s, P)))
    with mesh:
        p1, _, m = step(params, opt.init(params), {k: jnp.asarray(v) for k, v in batch.items()})
    put(f"train/{arch}/p/", params)
    put(f"train/{arch}/batch/", batch)
    put(f"train/{arch}/p1/", p1)
    for k in ("loss", "grad_norm", "lr"):
        out[f"train/{arch}/{k}"] = np.asarray(m[k])

# serving on (2, 2): prefill, then two decode steps on given tokens
cfg = dataclasses.replace(get_smoke("phi3.5-moe-42b"), dtype=jnp.float32)
params = init_params(cfg, jax.random.PRNGKey(3))
prompt = rng.integers(0, cfg.vocab, (4, 12)).astype(np.int32)
forced = rng.integers(0, cfg.vocab, (4, 2)).astype(np.int32)
put("serve/p/", params)
out["serve/prompt"], out["serve/forced"] = prompt, forced
with mesh:
    logits, cache = jax.jit(lambda p, t: jtf.prefill_step(cfg, p, {"tokens": t}, mesh, ("data",), "model",
                                                          max_len=14))(params, jnp.asarray(prompt))
    out["serve/logits0"] = np.asarray(logits)
    step = jax.jit(lambda p, c, t: jtf.serve_step(cfg, p, c, t, mesh, ("data",), "model"))
    for i in range(2):
        logits, cache = step(params, cache, jnp.asarray(forced[:, i : i + 1]))
        out[f"serve/logits{i + 1}"] = np.asarray(logits)

# every arch in the sharded layout: a jitted train step with param_shardings in-shardings, prefill and 3 decode
for arch in ARCHS:
    cfg = dataclasses.replace(get_smoke(arch), dtype=jnp.float32)
    params = init_params(cfg, jax.random.PRNGKey(5))
    batch = {"tokens": rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)}
    batch["labels"][0, :5] = -1
    batch["labels"][3, :2] = -1
    if cfg.n_patches:
        batch["patch_embeds"] = rng.standard_normal((4, cfg.n_patches, cfg.d_model), dtype=np.float32)
    if cfg.is_encdec:
        batch["frames"] = rng.standard_normal((4, cfg.enc_frames, cfg.d_model), dtype=np.float32)
    prompt = {k: (v[:, :8] if k == "tokens" else v) for k, v in batch.items() if k != "labels"}
    forced = rng.integers(0, cfg.vocab, (4, 3)).astype(np.int32)
    put(f"sh/{arch}/p/", params)
    put(f"sh/{arch}/batch/", batch)
    out[f"sh/{arch}/forced"] = forced
    for shape, max_len in ((2, 2), 8), ((1, 4), 10):
        mesh = mesh_of(shape)
        tag = f"sh/{arch}/{shape[0]}x{shape[1]}/"
        pspec = sanitize(mesh, params, param_shardings(cfg))
        opt = AdamW(AdamWConfig(total_steps=10, warmup=2, moment_dtype=jnp.float32))
        ospec = {"step": P(), "mu": pspec, "nu": pspec, "master": pspec}
        bspec = {k: P(("data",), *([None] * (v.ndim - 1))) for k, v in batch.items()}
        named = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t, is_leaf=lambda s: isinstance(s, P))
        step = jax.jit(jtf.make_train_step(cfg, opt, mesh, ("data",), "model"), in_shardings=named((pspec, ospec, bspec)))
        state = opt.init(params)
        with mesh:
            p1, _, m = step(params, state, {k: jnp.asarray(v) for k, v in batch.items()})
        put(tag + "p1/", p1)
        for k in ("loss", "grad_norm"):
            out[tag + k] = np.asarray(m[k])
        stored = 0
        for tree, spec in ((params, pspec), (state, ospec)):
            for leaf, s in zip(jax.tree.leaves(tree), jax.tree.leaves(spec, is_leaf=lambda x: isinstance(x, P))):
                stored += int(np.prod(NamedSharding(mesh, s).shard_shape(leaf.shape))) * leaf.dtype.itemsize
        out[tag + "stored"] = np.asarray(stored)
        ml = (8 if cfg.block_kind == "hybrid" else max_len) + cfg.n_patches
        with mesh:
            logits, cache = jax.jit(lambda p, b: jtf.prefill_step(cfg, p, b, mesh, ("data",), "model", max_len=ml))(
                params, {k: jnp.asarray(v) for k, v in prompt.items()})
            out[tag + "logits0"] = np.asarray(logits)
            dec = jax.jit(lambda p, c, t: jtf.serve_step(cfg, p, c, t, mesh, ("data",), "model"))
            for i in range(3):
                logits, cache = dec(params, cache, jnp.asarray(forced[:, i : i + 1]))
                out[tag + f"logits{i + 1}"] = np.asarray(logits)

# compressed_psum over 4 devices, different gradients and a carried error each
grads = {"a": rng.standard_normal((4, 64), dtype=np.float32),
         "b": rng.standard_normal((4, 8, 4), dtype=np.float32) * np.arange(1, 5, dtype=np.float32)[:, None, None]}
err = {k: rng.standard_normal(v.shape, dtype=np.float32) * 0.01 for k, v in grads.items()}
put("psum/g/", grads)
put("psum/e/", err)


def per_device(g, e):
    # the reference raises when given error= (grad_compress.py:36 unpacks a (leaves, treedef) pair leaf by leaf:
    # ROADMAP.md queue 3); its g32 is g + error, so the sum is given that and no error
    o, r = compressed_psum({k: g[k][0] + e[k][0] for k in g}, "dp")
    return {k: v[None] for k, v in o.items()}, {k: v[None] for k, v in r.items()}


o, r = jax.jit(shard_map(per_device, mesh=Mesh(np.asarray(devices[:4]), ("dp",)), in_specs=(P("dp"), P("dp")),
                         out_specs=(P("dp"), P("dp")), check_vma=False))(grads, err)
put("psum/out/", o)
put("psum/res/", r)
# the one-device case of tests/test_substrate.py
g1 = jax.random.normal(jax.random.PRNGKey(0), (64,))
o1, r1 = jax.jit(shard_map(lambda g: tuple(t["g"] for t in compressed_psum({"g": g}, "dp")),
                           mesh=Mesh(np.asarray(devices[:1]), ("dp",)), in_specs=P(None),
                           out_specs=(P(None), P(None)), check_vma=False))(g1)
out["psum1/g"], out["psum1/out"], out["psum1/res"] = np.asarray(g1), np.asarray(o1), np.asarray(r1)

# the bf16-score knob (tests/test_perf_knobs.py's setup), XLA kept to bf16 between the softmax's steps
key = jax.random.PRNGKey(11)
cfg = dataclasses.replace(get_smoke("granite-3-2b"), dtype=jnp.float32)
params = init_params(cfg, key)
batch = {"tokens": jax.random.randint(key, (2, 32), 0, cfg.vocab), "labels": jax.random.randint(key, (2, 32), 0, cfg.vocab)}
put("knob/p/", params)
put("knob/batch/", batch)
for f32 in (True, False):
    c = dataclasses.replace(cfg, attn_fp32_scores=f32)
    out[f"knob/loss_{int(f32)}"] = np.asarray(jax.jit(lambda p, b: jtf.train_loss(c, p, b))(params, batch))

np.savez(sys.argv[1], **out)
print("OK")
"""

# ---------------------------------------------------------------------------
# The port, once, on four gloo ranks
# ---------------------------------------------------------------------------

PORT = r"""
import dataclasses, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch import configs, tree
from repro_torch.core.config import PipelineConfig
from repro_torch.checkpoint import CheckpointStore
from repro_torch.collectives import all_reduce_over, gather_whole
from repro_torch.launch.mesh import batch_shard, gather_batch, join_group, make_stage_mesh, make_test_mesh
from repro_torch.models.layout import param_layout
from repro_torch.sharding import axis_size, dp_axes_of, local_shard, tree_bytes
from repro_torch.launch.serve_cnn import serve_cnn
from repro_torch.models import blocks, lm_common, transformer
from repro_torch.models.cnn import make_cnn
from repro_torch.optim import AdamW, AdamWConfig, compressed_psum
from repro_torch.pipeline import PipelineRunner

rank, world, store_path, ref_path, out_path, ckpt_dir = int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:7]
join_group(world, rank, store=dist.FileStore(store_path, world), device="cpu")
ref = dict(np.load(ref_path))
out = {}


def sub(prefix):
    keys = {k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)}
    t = {}
    for k, v in keys.items():
        *path, leaf = k.split("/")
        d = t
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    return t


def put(prefix, t):
    for name, leaf in tree.named_leaves(t):
        out[prefix + name] = leaf.detach().numpy()


def as_batch(b):
    return {k: torch.from_numpy(v).to(torch.int64 if v.dtype == np.int32 else torch.float32) for k, v in b.items()}


# the pipeline, one stage a rank
cnn = sub("cnn/")
model = make_cnn("synthnet", scale=0.1, device="cpu").params_from_numpy([cnn[str(i)] for i in range(len(cnn))])
micro = torch.from_numpy(ref["pipe/micro"])
for tag in ("4", "2"):
    conf = PipelineConfig(tuple(int(s) for s in ref[f"pipe/{tag}/stages"]), tuple(int(e) for e in ref[f"pipe/{tag}/eps"]))
    mesh = make_stage_mesh(conf.depth, "cpu", ranks=True)
    if mesh.get_coordinate() is not None:
        runner = PipelineRunner(mesh=mesh, conf=conf, apply_layer=model.apply_layer, n_micro=5)
        out[f"pipe/{tag}/out"] = runner.run(micro).numpy()
        out[f"pipe/{tag}/again"] = runner.run(micro).numpy()
        out[f"pipe/{tag}/ticks"] = np.asarray(runner.ticks)

# the CNN loop with one stage a rank: rank 0 measures and tunes, the split runs on the ranks
res = serve_cnn(device="cpu", scale=0.1, in_shape=(8, 8, 8), ranks=True)
if res.out is not None:
    seq = torch.stack([res.model(res.micro[i]) for i in range(len(res.micro))])
    out["loop/err"] = (res.out - seq).abs().max().numpy()
    out["loop/tp"] = np.asarray(res.measured_throughput)
out["loop/depth"] = np.asarray(res.conf.depth)
out["loop/lead"] = np.asarray(res.shisha is not None)

# two stages of two ranks each (per_stage 2): each inner column is a pipeline of its own
conf = PipelineConfig(tuple(int(s) for s in ref["pipe/2/stages"]), tuple(int(e) for e in ref["pipe/2/eps"]))
runner = PipelineRunner(mesh=make_stage_mesh(2, "cpu", ranks=True, per_stage=2), conf=conf,
                        apply_layer=model.apply_layer, n_micro=5)
out["pipe/2x2/out"] = runner.run(micro).numpy()

# moe_ffn over each mesh, each rank on its batch slice; the gradients summed as value_and_grad sums them
for arch in ("phi3.5-moe-42b", "llama4-scout-17b"):
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype=torch.float32)
    x, r = torch.from_numpy(ref[f"moe/{arch}/x"]), torch.from_numpy(ref[f"moe/{arch}/r"])
    for shape in ((2, 1), (1, 2), (2, 2)):
        mesh = make_test_mesh(shape, device="cpu")
        if mesh.get_coordinate() is None:
            continue
        p = {k: torch.from_numpy(v).requires_grad_(True) for k, v in sub(f"moe/{arch}/p/").items()}
        tp = axis_size(mesh, "model")  # the rank's d_ff block of the experts, as the sharded layout stores it
        mine = blocks.tp_slice(p, tp, mesh.get_local_rank("model")) if tp > 1 else p
        y, aux = blocks.moe_ffn(cfg, mine, batch_shard(mesh, x), mesh)
        grads = torch.autograd.grad((y * batch_shard(mesh, r)).sum() + aux, list(p.values()))
        split = ("data", "model") if axis_size(mesh, "model") > 1 else ("data",)
        tag = f"moe/{arch}/{shape[0]}x{shape[1]}/"
        out[tag + "y"], out[tag + "aux"] = y.detach().numpy(), aux.detach().numpy()
        for k, g in zip(p, grads):
            out[tag + "g/" + k] = all_reduce_over(g, mesh, split if k in blocks.TP_SPLIT else ("data",)).numpy()

# one train step of each arch on (2, 2)
mesh = make_test_mesh((2, 2), device="cpu")
out["mesh/dp_axes"] = np.asarray(dp_axes_of(mesh))
out["mesh/shard"] = batch_shard(mesh, torch.arange(8)).numpy()
for arch in ("phi3.5-moe-42b", "internvl2-76b"):
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype=torch.float32)
    specs = param_layout(cfg, mesh)
    params = local_shard(mesh, lm_common.params_from_numpy(cfg, sub(f"train/{arch}/p/"), "cpu"), specs)
    opt = AdamW(AdamWConfig(total_steps=10, warmup=2, moment_dtype=torch.float32))
    p1, _, m = transformer.make_train_step(cfg, opt, mesh)(params, opt.init(params),
                                                           batch_shard(mesh, as_batch(sub(f"train/{arch}/batch/"))))
    whole = gather_whole(mesh, p1, specs)
    put(f"train/{arch}/p1/", whole)
    out[f"train/{arch}/own"] = np.asarray([torch.equal(a, b) for a, b in zip(
        tree.leaves(p1), tree.leaves(local_shard(mesh, whole, specs)))])
    for k in ("loss", "grad_norm", "lr"):
        out[f"train/{arch}/{k}"] = m[k].numpy()

# serving on (2, 2)
cfg = dataclasses.replace(configs.get_smoke("phi3.5-moe-42b"), dtype=torch.float32)
params = local_shard(mesh, lm_common.params_from_numpy(cfg, sub("serve/p/"), "cpu"), param_layout(cfg, mesh))
forced = batch_shard(mesh, torch.from_numpy(ref["serve/forced"]).long())
logits, cache = transformer.prefill_step(cfg, params, {"tokens": batch_shard(mesh, torch.from_numpy(ref["serve/prompt"]).long())},
                                         mesh, max_len=14)
out["serve/logits0"] = gather_batch(mesh, logits).numpy()
out["serve/cache_batch"] = np.asarray(cache["k"].shape[1])
for i in range(2):
    logits, cache = transformer.serve_step(cfg, params, cache, forced[:, i : i + 1], mesh)
    out[f"serve/logits{i + 1}"] = gather_batch(mesh, logits).numpy()

# every arch in the sharded layout over (2, 2) and (1, 4), and a sharded checkpoint of the first
for arch in configs.ARCHS:
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype=torch.float32)
    whole = lm_common.params_from_numpy(cfg, sub(f"sh/{arch}/p/"), "cpu")
    batch = as_batch(sub(f"sh/{arch}/batch/"))
    prompt = {k: (v[:, :8] if k == "tokens" else v) for k, v in batch.items() if k != "labels"}
    forced = torch.from_numpy(ref[f"sh/{arch}/forced"]).long()
    for (shape, max_len), sp in [(m, sp) for m in (((2, 2), 8), ((1, 4), 10)) for sp in (True, False)]:
        mesh = make_test_mesh(shape, device="cpu")
        tag = f"{'sh' if sp else 'shnosp'}/{arch}/{shape[0]}x{shape[1]}/"  # the residual stream split, or whole
        cfg = dataclasses.replace(cfg, sp_residuals=sp)
        specs = param_layout(cfg, mesh)
        params = local_shard(mesh, tree.tree_map(torch.clone, whole), specs)
        opt = AdamW(AdamWConfig(total_steps=10, warmup=2, moment_dtype=torch.float32))
        state = opt.init(params)
        out[tag + "stored"] = np.asarray(tree_bytes(params) + tree_bytes(state))
        ml = 8 if cfg.block_kind == "hybrid" else max_len
        logits, cache = transformer.prefill_step(cfg, params, batch_shard(mesh, prompt), mesh, max_len=ml)
        out[tag + "logits0"] = gather_batch(mesh, logits).numpy()
        for i in range(3):
            logits, cache = transformer.serve_step(cfg, params, cache, batch_shard(mesh, forced[:, i : i + 1]), mesh)
            out[tag + f"logits{i + 1}"] = gather_batch(mesh, logits).numpy()
        p1, state, m = transformer.make_train_step(cfg, opt, mesh)(params, state, batch_shard(mesh, batch))
        got = gather_whole(mesh, p1, specs)
        put(tag + "p1/", got)
        out[tag + "own"] = np.asarray([torch.equal(a, b) for a, b in zip(tree.leaves(p1),
                                                                         tree.leaves(local_shard(mesh, got, specs)))])
        for k in ("loss", "grad_norm"):
            out[tag + k] = m[k].numpy()
        if arch == configs.ARCHS[0] and shape == (2, 2) and sp:  # every rank saves its blocks; rank 0 writes them whole
            both = {"params": specs, "opt": {"step": lm_common.P(), "mu": specs, "nu": specs, "master": specs}}
            CheckpointStore(ckpt_dir).save(1, {"params": p1, "opt": state}, shardings=(mesh, both))
            back = CheckpointStore(ckpt_dir).restore(1, {"params": p1, "opt": state}, shardings=(mesh, both))
            out["ckpt/same"] = np.asarray([torch.equal(a, b) for a, b in zip(tree.leaves(back),
                                                                             tree.leaves({"params": p1, "opt": state}))])

# compressed_psum over the four ranks, and over a group of one
g = {k: torch.from_numpy(v[rank]) for k, v in sub("psum/g/").items()}
e = {k: torch.from_numpy(v[rank]) for k, v in sub("psum/e/").items()}
o, res = compressed_psum(g, error=e)
put("psum/out/", o)
put("psum/res/", res)
one = dist.new_group([0])
if rank == 0:
    o1, r1 = compressed_psum({"g": torch.from_numpy(ref["psum1/g"])}, one)
    out["psum1/out"], out["psum1/res"] = o1["g"].numpy(), r1["g"].numpy()

# over a (1, 1) mesh every collective is a copy: the same bits as no mesh
solo = make_test_mesh((1, 1), device="cpu")
if rank == 0:
    cfg = dataclasses.replace(configs.get_smoke("phi3.5-moe-42b"), dtype=torch.float32)
    params = lm_common.params_from_numpy(cfg, sub("train/phi3.5-moe-42b/p/"), "cpu")
    batch = as_batch(sub("train/phi3.5-moe-42b/batch/"))
    prompt = {"tokens": batch["tokens"][:, :12]}  # a (1, 1) mesh: the rank's blocks and slice are the whole
    same = [torch.equal(a, b) for a, b in zip(transformer.prefill_step(cfg, params, prompt, solo, max_len=14)[0:1],
                                              transformer.prefill_step(cfg, params, prompt, max_len=14)[0:1])]
    la, ga = transformer.value_and_grad(cfg, params, batch, solo)
    lb, gb = transformer.value_and_grad(cfg, params, batch)
    same += [torch.equal(la, lb)] + [torch.equal(a, b) for a, b in zip(tree.leaves(ga), tree.leaves(gb))]
    out["solo/same"] = np.asarray(same)

np.savez(out_path, **out)
dist.barrier()
dist.destroy_process_group()
print("OK", rank)
"""


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "ref.npz"
    flags = "--xla_force_host_platform_device_count=4 --xla_allow_excess_precision=false"
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(path)], capture_output=True, text=True, timeout=900,
                       env=_env(XLA_FLAGS=flags, JAX_PLATFORMS="cpu"), cwd=REPO)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr[-3000:]}"
    return path


@pytest.fixture(scope="module")
def port(ref, tmp_path_factory):
    d = tmp_path_factory.mktemp("port")
    procs = [subprocess.Popen([sys.executable, "-c", PORT, str(rank), str(RANKS), str(d / "store"), str(ref),
                               str(d / f"rank{rank}.npz"), str(d / "ckpt")], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=_env(OMP_NUM_THREADS="1"), cwd=REPO)
             for rank in range(RANKS)]
    try:
        results = [p.communicate(timeout=900) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for rank, (p, (so, se)) in enumerate(zip(procs, results)):
        assert p.returncode == 0, f"rank {rank}: stdout:\n{so}\nstderr:\n{se[-3000:]}"
    return [{**dict(np.load(d / f"rank{rank}.npz")), "ckpt_dir": d / "ckpt"} for rank in range(RANKS)]


@pytest.fixture(scope="module")
def want(ref):
    return dict(np.load(ref))


def _shard(a, index, size):
    n = a.shape[0] // size
    return a[index * n : (index + 1) * n]


def test_pipeline_one_stage_a_rank_matches_reference_and_sequential(port, want):
    for rank in range(RANKS):  # every rank returns the last stage's outputs, as the reference's psum replicates them
        got = port[rank]["pipe/4/out"]
        np.testing.assert_allclose(got, want["pipe/4/out"], **TOL)
        np.testing.assert_allclose(got, want["pipe/seq"], **TOL)
        np.testing.assert_array_equal(got, port[rank]["pipe/4/again"])
        assert int(port[rank]["pipe/4/ticks"]) == 5 + 4 - 1


def test_pipeline_two_stage_uneven_split_on_the_first_two_ranks(port, want):
    assert tuple(want["pipe/2/stages"]) == (5, 13)
    for rank in range(2):
        np.testing.assert_allclose(port[rank]["pipe/2/out"], want["pipe/2/out"], **TOL)
        np.testing.assert_allclose(port[rank]["pipe/2/out"], want["pipe/seq"], **TOL)
    assert all("pipe/2/out" not in port[rank] for rank in (2, 3))  # outside the 2-rank mesh


def test_pipeline_with_two_ranks_a_stage_runs_each_inner_column(port, want):
    for rank in range(RANKS):  # ranks 0, 2 and 1, 3 are two pipelines of the same split
        np.testing.assert_allclose(port[rank]["pipe/2x2/out"], want["pipe/2/out"], **TOL)
        np.testing.assert_array_equal(port[rank]["pipe/2x2/out"], port[0]["pipe/2x2/out"])


def test_a_2x2_mesh_shards_the_batch_over_data(port):
    for rank in range(RANKS):
        assert list(port[rank]["mesh/dp_axes"]) == ["data"]
        d = rank // 2
        np.testing.assert_array_equal(port[rank]["mesh/shard"], np.arange(8)[4 * d : 4 * d + 4])


def test_cnn_loop_runs_the_tuned_split_one_stage_a_rank(port):
    depth = int(port[0]["loop/depth"])
    assert all(int(port[rank]["loop/depth"]) == depth for rank in range(RANKS))  # one split, broadcast
    assert [bool(port[rank]["loop/lead"]) for rank in range(RANKS)] == [True, False, False, False]
    for rank in range(depth):
        assert float(port[rank]["loop/err"]) <= 1e-4 and float(port[rank]["loop/tp"]) > 0


def test_example_runs_the_loop_over_two_gloo_ranks():
    r = subprocess.run([sys.executable, str(REPO / "examples" / "pipeline_serve_cnn_torch.py"), "--ranks", "2",
                        "--device", "cpu", "--scale", "0.1", "--in-shape", "8", "8", "8"],
                       capture_output=True, text=True, timeout=300, env=_env(OMP_NUM_THREADS="1"), cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "[ranks] 2 processes over gloo, one stage a rank" in r.stdout
    assert "[serve] pipelined 8 microbatches" in r.stdout


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_over_a_mesh_matches_the_references_shard_map(port, want, arch, shape):
    tag = f"moe/{arch}/{shape[0]}x{shape[1]}/"
    for rank in range(shape[0] * shape[1]):
        d = rank // shape[1]
        got = port[rank]
        np.testing.assert_allclose(got[tag + "y"], _shard(want[tag + "y"], d, shape[0]), **TOL)
        np.testing.assert_allclose(got[tag + "aux"], want[tag + "aux"], **TOL)
        names = [k[len(tag) + 2 :] for k in want if k.startswith(tag + "g/")]
        assert sorted(names) == sorted(k[len(tag) + 2 :] for k in got if k.startswith(tag + "g/"))
        for k in names:
            np.testing.assert_allclose(got[tag + "g/" + k], want[tag + "g/" + k], err_msg=k, **LEAF_TOL)
    if shape[0] > 1:  # a data shard's aux is not the whole batch's: the mesh path is another function
        assert abs(float(want[tag + "aux"]) - float(want[f"moe/{arch}/nomesh/aux"])) > 1e-3


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_over_2x2_matches_the_references_jitted_mesh_step(port, want, arch):
    labels = want[f"train/{arch}/batch/labels"]
    assert (labels[:2] >= 0).sum() != (labels[2:] >= 0).sum()  # the data shards count different tokens
    for rank in range(RANKS):
        got = port[rank]
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(got[f"train/{arch}/{k}"], want[f"train/{arch}/{k}"], err_msg=k, **LOSS_TOL)
        names = [k for k in want if k.startswith(f"train/{arch}/p1/")]
        assert len(names) == len([k for k in got if k.startswith(f"train/{arch}/p1/")])
        for k in names:
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **LEAF_TOL)
            np.testing.assert_array_equal(got[k], port[0][k])  # every rank's gathered parameters are the same
        assert got[f"train/{arch}/own"].all()  # and each rank stores its own block of them


def test_serving_over_2x2_matches_the_reference(port, want):
    for rank in range(RANKS):
        assert int(port[rank]["serve/cache_batch"]) == 2  # each data rank keeps its slice's cache
        for i in range(3):
            np.testing.assert_allclose(port[rank][f"serve/logits{i}"], want[f"serve/logits{i}"], err_msg=str(i), **TOL)


def test_compressed_psum_over_four_ranks_matches_the_references_shard_map(port, want):
    for rank in range(RANKS):
        for k in ("a", "b"):
            np.testing.assert_allclose(port[rank][f"psum/out/{k}"], want[f"psum/out/{k}"][rank], **PSUM_TOL)
            np.testing.assert_allclose(port[rank][f"psum/res/{k}"], want[f"psum/res/{k}"][rank], **PSUM_TOL)
    # the formula in numpy: one scale for all ranks, int8 sums, the mean
    for k in ("a", "b"):
        g32 = want[f"psum/g/{k}"] + want[f"psum/e/{k}"]
        scale = max(np.abs(g32).max(), 1e-12) / 127.0
        q = np.clip(np.round(g32 / np.float32(scale)), -127, 127)
        np.testing.assert_allclose(port[0][f"psum/out/{k}"], q.sum(0) * scale / RANKS, rtol=1e-5, atol=1e-6)


def test_compressed_psum_over_one_rank_is_the_gradient(port, want):
    g = want["psum1/g"]
    out, res = port[0]["psum1/out"], port[0]["psum1/res"]
    np.testing.assert_allclose(out, want["psum1/out"], **PSUM_TOL)
    np.testing.assert_allclose(res, want["psum1/res"], **PSUM_TOL)
    np.testing.assert_allclose(out, g, atol=2e-2)  # tests/test_substrate.py's bounds
    np.testing.assert_allclose(out + res, g, atol=2e-2)


def test_a_one_rank_mesh_gives_the_bits_of_no_mesh(port):
    assert port[0]["solo/same"].all() and len(port[0]["solo/same"]) > 10


def test_bf16_scores_match_the_reference_and_stay_close_to_fp32(want):
    cfg = dataclasses.replace(configs.get_smoke("granite-3-2b"), dtype=torch.float32)
    ptree = {k[len("knob/p/") :]: v for k, v in want.items() if k.startswith("knob/p/")}
    nested = {}
    for k, v in ptree.items():
        *path, leaf = k.split("/")
        d = nested
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    params = lm_common.params_from_numpy(cfg, nested, "cpu")
    batch = {k: torch.from_numpy(want[f"knob/batch/{k}"]).long() for k in ("tokens", "labels")}
    base = float(transformer.train_loss(cfg, params, batch))
    lo = float(transformer.train_loss(dataclasses.replace(cfg, attn_fp32_scores=False), params, batch))
    assert abs(base - lo) < 0.05  # tests/test_perf_knobs.py: a precision trade, not semantics
    assert base != lo
    np.testing.assert_allclose(base, want["knob/loss_1"], **LOSS_TOL)
    np.testing.assert_allclose(lo, want["knob/loss_0"], **LOSS_TOL)


def test_tp_slice_gives_views_of_each_ranks_d_ff_part():
    cfg = dataclasses.replace(configs.get_smoke("llama4-scout-17b"), dtype=torch.float32)
    p = lm_common.layer(lm_common.init_params(cfg, torch.Generator().manual_seed(0), "cpu")["blocks"], 0)
    parts = [blocks.tp_slice(p, 2, i) for i in range(2)]
    for key, dim in blocks.TP_SPLIT.items():
        for part in parts:
            assert part[key].untyped_storage().data_ptr() == p[key].untyped_storage().data_ptr()  # no copy
            assert part[key].stride() == p[key].stride()
        torch.testing.assert_close(torch.cat([part[key] for part in parts], dim=dim), p[key], rtol=0, atol=0)
    assert parts[0]["router"] is p["router"] and parts[1]["ln2"] is p["ln2"]
    with pytest.raises(ValueError, match="split"):
        blocks.tp_slice(p, 5, 0)


def _nested(flat: dict, prefix: str) -> dict:
    out: dict = {}
    for k, v in flat.items():
        if k.startswith(prefix):
            *path, leaf = k[len(prefix) :].split("/")
            d = out
            for p in path:
                d = d.setdefault(p, {})
            d[leaf] = v
    return out


SHARDED = [(a, m) for a in ALL_ARCHS for m in SHARDED_MESHES]
#: the port's residual stream split over the sequence (sp_residuals, the default, as the reference's) or whole
SP = pytest.mark.parametrize("sp", [True, False], ids=["sp", "nosp"])


def _port_tag(tag: str, sp: bool) -> str:
    return tag if sp else "shnosp" + tag[len("sh"):]


@SP
@pytest.mark.parametrize("arch,shape", SHARDED, ids=[f"{a}-{m[0]}x{m[1]}" for a, m in SHARDED])
def test_sharded_train_step_matches_the_references_jitted_mesh_step(port, want, arch, shape, sp):
    tag = f"sh/{arch}/{shape[0]}x{shape[1]}/"
    mine = _port_tag(tag, sp)
    names = [k[len(tag):] for k in want if k.startswith(tag + "p1/")]
    for rank in range(RANKS):
        got = port[rank]
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[mine + k], want[tag + k], err_msg=k, **LOSS_TOL)
        assert len(names) == len([k for k in got if k.startswith(mine + "p1/")])
        for k in names:
            np.testing.assert_allclose(got[mine + k], want[tag + k], err_msg=k, **LEAF_TOL)
            np.testing.assert_array_equal(got[mine + k], port[0][mine + k])
        assert got[mine + "own"].all()


@SP
@pytest.mark.parametrize("arch,shape", SHARDED, ids=[f"{a}-{m[0]}x{m[1]}" for a, m in SHARDED])
def test_sharded_prefill_and_decode_match_the_reference(port, want, arch, shape, sp):
    tag = f"sh/{arch}/{shape[0]}x{shape[1]}/"
    for rank in range(RANKS):
        for i in range(4):
            np.testing.assert_allclose(port[rank][_port_tag(tag, sp) + f"logits{i}"], want[tag + f"logits{i}"],
                                       err_msg=str(i), **TOL)


@pytest.mark.parametrize("arch,shape", SHARDED, ids=[f"{a}-{m[0]}x{m[1]}" for a, m in SHARDED])
def test_each_rank_stores_only_its_blocks(port, want, arch, shape):
    tag = f"sh/{arch}/{shape[0]}x{shape[1]}/"
    for rank in range(RANKS):
        assert int(port[rank][tag + "stored"]) == int(want[tag + "stored"])
    whole = sum(v.size * 4 for k, v in want.items() if k.startswith(f"sh/{arch}/p/"))  # fp32 smoke parameters
    assert int(want[tag + "stored"]) < 4 * whole + 4  # params and three AdamW trees, each split over the mesh


def test_a_sharded_checkpoint_restores_whole_in_both_packages_and_into_the_blocks(port, want):
    from repro.checkpoint import CheckpointStore as RefStore

    from repro_torch.checkpoint import CheckpointStore

    assert all(port[rank]["ckpt/same"].all() for rank in range(RANKS))  # each rank restores its own blocks
    arch = ALL_ARCHS[0]
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype=torch.float32)
    like_p = lm_common.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    like = {"params": like_p, "opt": {"step": torch.zeros((), dtype=torch.int32), "mu": like_p, "nu": like_p,
                                      "master": like_p}}
    back = CheckpointStore(port[0]["ckpt_dir"]).restore(1, like)
    want_p1 = _nested(want, f"sh/{arch}/2x2/p1/")
    for name, leaf in tree.named_leaves(back["params"]):
        np.testing.assert_allclose(leaf.numpy(), _get(want_p1, name), err_msg=name, **LEAF_TOL)
    assert int(back["opt"]["step"]) == 1
    import jax

    ref_like = jax.tree.map(lambda t: np.zeros(t.shape, np.float32), {"params": like_p, "opt": {
        "mu": like_p, "nu": like_p, "master": like_p}})
    ref_like["opt"]["step"] = np.zeros((), np.int32)
    ref_back = RefStore(port[0]["ckpt_dir"]).restore(1, ref_like)
    for (name, a), b in zip(tree.named_leaves(back), jax.tree.leaves(ref_back)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def _get(tree_: dict, name: str):
    for part in name.split("/"):
        tree_ = tree_[part]
    return tree_
