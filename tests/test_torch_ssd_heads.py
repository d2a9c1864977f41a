"""The SSD layer split over its heads on the port's mesh paths, against the
JAX package's.

The reference pins the scan's x with ``cstr_heads(xs.reshape(b, s, h, p),
2)`` (``repro/models/blocks.py:394``), so wherever ``model`` divides
``ssm_heads`` each ``model`` device computes only its heads.  The port does
the same with explicit collectives: ``models/layout.py``'s
``Layout.ssd_heads`` / ``Layout.ssd`` give each rank its heads' parameters,
``blocks.ssd_block(tp=)`` / ``ssd_decode(tp=)`` project, scan, norm and
decode them, and ``collectives.psum_tp`` sums the gated norm's mean square
over ``model`` both ways.

Seeded numpy weights (norm scales and biases drawn away from 1 and 0) and
batches are written once; then at the same time the reference runs in two
subprocesses of four host devices each, one a mesh, and the port as four
gloo ranks (each a ``python -c``).  Held here, on (2, 2) and (1, 4):

* the plan: ``"heads"`` where ``cstr_heads`` splits the heads, else whole,
  and the shapes each rank's ``ops.ssd_scan`` receives (a wrapper in the
  rank script records them);
* a 6-head SSD smoke variant (``d_model`` 48, ``ssm_head_dim`` 16), split on
  (2, 2) and whole on (1, 4): the loss and every gradient leaf against the
  reference's jitted mesh step;
* a control with the gated norm's mean square summed forward only
  (``sum_tp`` in place of ``psum_tp``), which must miss;
* the ``ssm`` and ``conv`` cache blocks each rank holds after prefill and
  after two decode steps, against the reference's cache sliced by its own
  ``cache_pspecs``, and the logits;
* on a fake (2, 2) group, the dry run of zamba2 smoke split over its heads
  against the whole layer: fewer FLOPs a rank, the new all-reduce counted.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # CI installs requirements-dev.txt, which has no torch

from repro_torch import configs
from repro_torch.models import lm_common
from repro_torch.models.layout import Layout

REPO = Path(__file__).resolve().parents[1]
LOSS_TOL = dict(rtol=1e-5, atol=0)
LEAF_TOL = dict(rtol=1e-3, atol=1e-4)
TOL = dict(rtol=1e-4, atol=1e-4)
RANKS = 4
MESHES = ((2, 2), (1, 4))
BATCH, SEQ, PROMPT, DECODE = 4, 16, 8, 2
#: the configs the rank scripts run: the 6-head variant trains and serves, the smoke configs (8 heads) serve
SIX = "mamba2-6h"
SERVE = (SIX, "mamba2-130m", "zamba2-2.7b")
#: the 6-head variant's changes to mamba2's smoke config (the reference's and the port's alike)
SIX_OF = {"d_model": 48}


def _env(**extra):
    return {**os.environ, "PYTHONPATH": str(REPO / "src"), **extra}


def _cfg(name: str) -> lm_common.LMConfig:
    if name == SIX:
        return dataclasses.replace(configs.get_smoke("mamba2-130m"), **SIX_OF)
    return configs.get_smoke(name)


def _named(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _inputs(path: Path) -> None:
    """Each config's weights (fp32), a training batch, a prompt and the
    decode tokens, from one seed."""
    rng = np.random.default_rng(31)
    out = {}
    for name in SERVE:
        cfg = _cfg(name)
        for leaf_name, leaf in _named(lm_common.param_spec(cfg)):
            noise = rng.standard_normal(leaf.shape).astype(np.float32)
            if leaf.init == "dense":
                out[f"{name}/p/{leaf_name}"] = noise / np.float32(np.sqrt(leaf.scale))
            else:
                out[f"{name}/p/{leaf_name}"] = np.float32(leaf.init == "ones") + np.float32(0.1) * noise
        labels = rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
        labels[0, :5] = -1
        out[f"{name}/batch/tokens"] = rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
        out[f"{name}/batch/labels"] = labels
        out[f"{name}/forced"] = rng.integers(0, cfg.vocab, (BATCH, DECODE)).astype(np.int32)
    np.savez(path, **out)


# ---------------------------------------------------------------------------
# The reference: one process a mesh, four host devices each
# ---------------------------------------------------------------------------

REFERENCE = r"""
import dataclasses, json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_smoke
from repro.launch.shardings import cache_pspecs, sanitize
from repro.models import transformer as jtf
from repro.models.lm_common import param_shardings

inp, out_path, shape = dict(np.load(sys.argv[1])), sys.argv[2], tuple(int(n) for n in sys.argv[3].split("x"))
six, six_of, serve, prompt_len, decode = sys.argv[4], json.loads(sys.argv[5]), json.loads(sys.argv[6]), \
    int(sys.argv[7]), int(sys.argv[8])
mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(shape), ("data", "model"))
out = {}


def nested(prefix):
    t = {}
    for k, v in inp.items():
        if k.startswith(prefix):
            *path, leaf = k[len(prefix):].split("/")
            d = t
            for p in path:
                d = d.setdefault(p, {})
            d[leaf] = jnp.asarray(v)
    return t


def cfg_of(name):
    base = get_smoke("mamba2-130m") if name == six else get_smoke(name)
    return dataclasses.replace(base, dtype=jnp.float32, **(six_of if name == six else {}))


def shards(cfg, cache, tag):
    # the reference's cache blocks: the whole cache sliced as its cache_pspecs place it on each device
    spec = cache_pspecs(cfg, mesh, cache)
    for name in ("ssm", "conv"):
        whole = np.asarray(cache[name])
        for dev, idx in NamedSharding(mesh, spec[name]).devices_indices_map(whole.shape).items():
            out[f"{tag}{name}/{dev.id}"] = whole[idx]


for name in serve:
    cfg, params = cfg_of(name), nested(f"{name}/p/")
    batch = nested(f"{name}/batch/")
    if name == six:
        pspec = sanitize(mesh, params, param_shardings(cfg))
        bspec = {k: P(("data",), None) for k in batch}
        named = jax.tree.map(lambda s: NamedSharding(mesh, s), (pspec, bspec), is_leaf=lambda s: isinstance(s, P))
        f = jax.jit(jax.value_and_grad(lambda p, b: jtf.train_loss(cfg, p, b, mesh, ("data",), "model")),
                    in_shardings=named)
        with mesh:
            loss, g = f(params, batch)
        out[name + "/loss"] = np.asarray(loss)
        for path, leaf in jax.tree_util.tree_flatten_with_path(g)[0]:
            out[name + "/g/" + "/".join(str(k.key) for k in path)] = np.asarray(leaf)
    forced = inp[f"{name}/forced"]
    with mesh:
        prefill = jax.jit(lambda p, t: jtf.prefill_step(cfg, p, {"tokens": t}, mesh, ("data",), "model",
                                                        max_len=prompt_len))
        logits, cache = prefill(params, batch["tokens"][:, :prompt_len])
        out[f"{name}/logits0"] = np.asarray(logits)
        shards(cfg, cache, f"{name}/cache0/")
        step = jax.jit(lambda p, c, t: jtf.serve_step(cfg, p, c, t, mesh, ("data",), "model"))
        for i in range(decode):
            logits, cache = step(params, cache, jnp.asarray(forced[:, i : i + 1]))
            out[f"{name}/logits{i + 1}"] = np.asarray(logits)
    shards(cfg, cache, f"{name}/cache{decode}/")
np.savez(out_path, **out)
print("OK")
"""

# ---------------------------------------------------------------------------
# The port: four gloo ranks
# ---------------------------------------------------------------------------

PORT = r"""
import dataclasses, json, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch import configs, tree
from repro_torch.collectives import gather_whole, sum_tp
from repro_torch.kernels import ops
from repro_torch.launch.mesh import batch_shard, join_group, make_test_mesh
from repro_torch.models import blocks, lm_common, transformer
from repro_torch.models.layout import Layout, param_layout
from repro_torch.sharding import local_shard

rank, world, store, in_path, out_path = int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6]
six, six_of, serve, prompt_len, decode = sys.argv[6], json.loads(sys.argv[7]), json.loads(sys.argv[8]), \
    int(sys.argv[9]), int(sys.argv[10])
join_group(world, rank, store=dist.FileStore(store, world), device="cpu")
inp = dict(np.load(in_path))
out = {}

# the shapes of x every scan of the rank receives
scans = []
scan = ops.ssd_scan


def recording(x, *args, **kwargs):
    scans.append(list(x.shape))
    return scan(x, *args, **kwargs)


ops.ssd_scan = recording


def nested(prefix, cast):
    t = {}
    for k, v in inp.items():
        if k.startswith(prefix):
            *path, leaf = k[len(prefix):].split("/")
            d = t
            for p in path:
                d = d.setdefault(p, {})
            d[leaf] = cast(v)
    return t


def cfg_of(name):
    base = configs.get_smoke("mamba2-130m") if name == six else configs.get_smoke(name)
    return dataclasses.replace(base, dtype=torch.float32, remat="full", **(six_of if name == six else {}))


def grads(cfg, whole, batch, mesh, tag):
    specs = param_layout(cfg, mesh)
    mine = local_shard(mesh, tree.tree_map(torch.clone, whole), specs)
    scans.clear()
    loss, g = transformer.value_and_grad(cfg, mine, batch_shard(mesh, batch), mesh)
    out[tag + "loss"] = loss.numpy()
    out[tag + "scans"] = np.asarray(scans)
    for name, leaf in tree.named_leaves(gather_whole(mesh, g, specs)):
        out[tag + "g/" + name] = leaf.numpy()


for shape in ((2, 2), (1, 4)):
    mesh = make_test_mesh(shape, device="cpu")
    for name in serve:
        cfg = cfg_of(name)
        tag = f"{name}/{shape[0]}x{shape[1]}/"
        whole = lm_common.params_from_numpy(cfg, nested(f"{name}/p/", np.asarray), "cpu")
        batch = nested(f"{name}/batch/", lambda v: torch.from_numpy(v).long())
        lay = Layout(cfg, mesh)
        heads = lay.ssd_heads(cfg, lay.layer_specs("blocks"))
        out[tag + "heads"] = np.asarray(heads if heads is not None else [-1, -1])
        if name == six:
            grads(cfg, whole, batch, mesh, tag)
            if heads is not None:  # control: the gated norm's mean square summed forward, its gradient not
                blocks.psum_tp, psum = sum_tp, blocks.psum_tp
                grads(cfg, whole, batch, mesh, tag + "unsummed/")
                blocks.psum_tp = psum
        params = local_shard(mesh, whole, param_layout(cfg, mesh))
        forced = torch.from_numpy(inp[f"{name}/forced"]).long()
        scans.clear()
        prompt = batch_shard(mesh, {"tokens": batch["tokens"][:, :prompt_len]})
        logits, cache = transformer.prefill_step(cfg, params, prompt, mesh, max_len=prompt_len)
        out[tag + "prefill_scans"] = np.asarray(scans)
        out[tag + "logits0"] = logits.numpy()
        for k in ("ssm", "conv"):
            out[tag + f"cache0/{k}"] = cache[k].clone().numpy()
        for i in range(decode):
            logits, cache = transformer.serve_step(cfg, params, cache, batch_shard(mesh, forced[:, i : i + 1]), mesh)
            out[tag + f"logits{i + 1}"] = logits.numpy()
        for k in ("ssm", "conv"):
            out[tag + f"cache{decode}/{k}"] = cache[k].numpy()
np.savez(out_path, **out)
dist.barrier()
dist.destroy_process_group()
print("OK", rank)
"""

# ---------------------------------------------------------------------------
# The dry run on a fake (2, 2) group: zamba2 smoke split over its heads, and whole
# ---------------------------------------------------------------------------

FAKE = r"""
import dataclasses, json, sys
import torch.distributed as dist
from repro_torch.configs import ShapeCell, get_smoke
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import join_fake_group, make_test_mesh
from repro_torch.models.layout import Layout

join_fake_group(4)
mesh = make_test_mesh((2, 2), device="cpu")
cell = ShapeCell("smoke_train", 64, 8, "train")
cfg = dataclasses.replace(get_smoke("zamba2-2.7b"), remat="full")
out = {}
for split in (True, False):
    if not split:  # the whole layer on every rank, as before the split
        Layout.ssd_heads = lambda self, cfg, specs: None
    fn, args = dryrun.build(cfg, cell, mesh, cell.name, accum=1)
    prof = dryrun.profile(fn, args)
    out[str(split)] = {"flops": prof["flops"], "colls": [[c["op"], c["bytes"], c["axis"]] for c in prof["collectives"]],
                       "wire": sum(c["wire_bytes"] for c in prof["collectives"])}
dist.destroy_process_group()
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's outputs by mesh, the port's by rank): every process at once."""
    d = tmp_path_factory.mktemp("ssd_heads")
    _inputs(d / "in.npz")
    flags = ("--xla_force_host_platform_device_count=4 --xla_backend_optimization_level=0 "
             "--xla_llvm_disable_expensive_passes=true")
    common = [SIX, json.dumps(SIX_OF), json.dumps(SERVE), str(PROMPT), str(DECODE)]
    procs = {f"ref {m[0]}x{m[1]}": subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(d / "in.npz"), str(d / f"ref{m[0]}x{m[1]}.npz"), f"{m[0]}x{m[1]}",
         *common], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(XLA_FLAGS=flags, JAX_PLATFORMS="cpu"), cwd=REPO) for m in MESHES}
    procs.update({f"rank {r}": subprocess.Popen(
        [sys.executable, "-c", PORT, str(r), str(RANKS), str(d / "store"), str(d / "in.npz"), str(d / f"rank{r}.npz"),
         *common], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env(OMP_NUM_THREADS="1"), cwd=REPO)
        for r in range(RANKS)})
    try:
        results = {k: p.communicate(timeout=900) for k, p in procs.items()}
    finally:
        for p in procs.values():
            p.kill()
    for k, p in procs.items():
        so, se = results[k]
        assert p.returncode == 0, f"{k}: stdout:\n{so}\nstderr:\n{se[-3000:]}"
    ref = {m: dict(np.load(d / f"ref{m[0]}x{m[1]}.npz")) for m in MESHES}
    return ref, [dict(np.load(d / f"rank{r}.npz")) for r in range(RANKS)]


@pytest.fixture(scope="module")
def fake(tmp_path_factory):
    path = tmp_path_factory.mktemp("fake") / "fake.json"
    r = subprocess.run([sys.executable, "-c", FAKE, str(path)], capture_output=True, text=True, timeout=600,
                       env=_env(OMP_NUM_THREADS="1"), cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(path.read_text())


def _leaves(d: dict, tag: str) -> dict:
    return {k[len(tag) + 2 :]: v for k, v in d.items() if k.startswith(tag + "g/")}


def _split(name: str, shape) -> bool:
    return _cfg(name).ssm_heads % shape[1] == 0


def _fake_mesh(shape, rank: int = 0):
    """What ``Layout`` reads of a mesh, for the plan alone (no group)."""
    return SimpleNamespace(mesh_dim_names=("data", "model"), mesh=SimpleNamespace(shape=shape),
                           get_local_rank=lambda axis: rank % shape[1])


#: (config, its changes, mesh, model rank, the plan wanted: (first head, heads) or None)
PLANS = [("mamba2-130m", {}, (16, 16), 3, None), ("mamba2-130m", {}, (1, 2), 1, (12, 12)),
         ("mamba2-130m", {}, (2, 4), 2, (12, 6)), ("mamba2-130m", {}, (2, 8), 7, (21, 3)),
         ("zamba2-2.7b", {}, (16, 16), 15, (75, 5)), ("zamba2-2.7b", {}, (1, 2), 1, (40, 40)),
         ("zamba2-2.7b", {}, (4, 1), 0, None), ("zamba2-2.7b", {"sp_residuals": False}, (16, 16), 2, (10, 5))]


@pytest.mark.parametrize("arch,changes,shape,rank,wanted", PLANS,
                         ids=[f"{p[0]}-{p[2][0]}x{p[2][1]}-r{p[3]}{'-nosp' if p[1] else ''}" for p in PLANS])
def test_the_plan_splits_the_heads_where_cstr_heads_does(arch, changes, shape, rank, wanted):
    cfg = dataclasses.replace(configs.get_config(arch), **changes)
    lay = Layout(cfg, _fake_mesh(shape, rank))
    assert lay.ssd_heads(cfg, lay.layer_specs("blocks")) == wanted
    spec = lm_common.cstr_heads(lay.dist, (1, 1, cfg.ssm_heads, cfg.ssm_head_dim), 2)
    assert (spec[2] == "model" and shape[1] > 1) == (wanted is not None)  # the reference's divisibility rule


@pytest.mark.parametrize("shape", MESHES, ids=[f"{m[0]}x{m[1]}" for m in MESHES])
@pytest.mark.parametrize("name", SERVE)
def test_each_ranks_scan_receives_its_heads(runs, name, shape):
    _, port = runs
    cfg = _cfg(name)
    tag = f"{name}/{shape[0]}x{shape[1]}/"
    split = _split(name, shape)
    hr = cfg.ssm_heads // shape[1] if split else cfg.ssm_heads
    for rank in range(RANKS):
        heads = port[rank][tag + "heads"].tolist()
        assert heads == ([(rank % shape[1]) * hr, hr] if split else [-1, -1])
        # prefill: the rank's data shard, the whole prompt, its heads
        want = [[BATCH // shape[0], PROMPT, hr, cfg.ssm_head_dim]] * cfg.n_layers
        assert port[rank][tag + "prefill_scans"].tolist() == want
        if name == SIX:  # training: each layer once forward and once more under remat's recompute
            want = [[BATCH // shape[0], SEQ, hr, cfg.ssm_head_dim]] * (2 * cfg.n_layers)
            assert port[rank][tag + "scans"].tolist() == want


@pytest.mark.parametrize("shape", MESHES, ids=[f"{m[0]}x{m[1]}" for m in MESHES])
def test_six_heads_gradients_match_the_references_mesh_step(runs, shape):
    ref, port = runs
    tag = f"{SIX}/{shape[0]}x{shape[1]}/"
    want = _leaves(ref[shape], SIX + "/")
    for rank in range(RANKS):
        got = _leaves(port[rank], tag)
        assert sorted(got) == sorted(want)
        np.testing.assert_allclose(port[rank][tag + "loss"], ref[shape][SIX + "/loss"], **LOSS_TOL)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **LEAF_TOL)
            np.testing.assert_array_equal(got[k], _leaves(port[0], tag)[k])  # the same on every rank


def test_the_gated_norms_gradient_unsummed_over_model_misses_the_reference(runs):
    ref, port = runs
    want = _leaves(ref[(2, 2)], SIX + "/")
    got = _leaves(port[0], f"{SIX}/2x2/unsummed/")
    missed = set()
    for k in want:
        try:
            np.testing.assert_allclose(got[k], want[k], **LEAF_TOL)
        except AssertionError:
            missed.add(k)
    # everything before a gated norm takes a wrong gradient; after the last one (the last layer's norm scale and
    # out_proj, the final norm, the unembedding) only the forward counts
    assert {"blocks/in_proj", "blocks/conv_w", "blocks/A_log", "blocks/dt_bias", "blocks/D", "embed"} <= missed
    assert not missed & {"ln_f", "unembed"}
    for k in ("blocks/gate_ln", "blocks/out_proj"):
        np.testing.assert_allclose(got[k][-1], want[k][-1], err_msg=k, **LEAF_TOL)
        assert not np.allclose(got[k][0], want[k][0], **LEAF_TOL), k
    np.testing.assert_allclose(port[0][f"{SIX}/2x2/unsummed/loss"], ref[(2, 2)][SIX + "/loss"], **LOSS_TOL)


def _block(whole_logits: np.ndarray, shape, rank: int) -> np.ndarray:
    n = whole_logits.shape[0] // shape[0]
    d = rank // shape[1]
    return whole_logits[d * n : (d + 1) * n]


@pytest.mark.parametrize("shape", MESHES, ids=[f"{m[0]}x{m[1]}" for m in MESHES])
@pytest.mark.parametrize("name", SERVE)
def test_cache_blocks_after_prefill_and_decode_are_the_references_shards(runs, name, shape):
    ref, port = runs
    tag = f"{name}/{shape[0]}x{shape[1]}/"
    for rank in range(RANKS):
        for step in (0, DECODE):
            for k in ("ssm", "conv"):
                np.testing.assert_allclose(port[rank][tag + f"cache{step}/{k}"],
                                           ref[shape][f"{name}/cache{step}/{k}/{rank}"],
                                           err_msg=f"{k} after {step} decode steps", **TOL)
        for i in range(DECODE + 1):
            want = _block(ref[shape][f"{name}/logits{i}"], shape, rank)
            np.testing.assert_allclose(port[rank][tag + f"logits{i}"], want, err_msg=str(i), **TOL)


def test_dry_run_split_over_the_heads_does_less_work_and_counts_the_norms_all_reduce(fake):
    split, whole = fake["True"], fake["False"]
    assert split["flops"] < whole["flops"]
    cfg = configs.get_smoke("zamba2-2.7b")
    # the gated norm's sum of squares, [b / data, s, 1] fp32 (the cell's batch of 8 over 2 data ranks, 64 positions),
    # summed over model once a layer forward, once more under remat's recompute, and once in the backward; the loss's
    # log-sum-exp over the vocab's ranks sums tensors of that size in both runs
    norm = 8 // 2 * 64 * 1 * 4
    count = lambda rec: sum(c == ["all-reduce", norm, "model"] for c in rec["colls"])
    assert count(split) - count(whole) == 3 * cfg.n_layers
    assert split["wire"] > whole["wire"]
