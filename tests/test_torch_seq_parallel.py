"""The residual stream split over the sequence (``sp_residuals``) on the
port's mesh paths, against the JAX package's.

The reference's ``sp_residuals`` (on by default) pins the residual stream's
sequence over ``model`` through ``dist_context`` and ``cstr_act``; the port
runs the same split with explicit collectives (``models/layout.py``'s
sequence plan).  Seeded numpy weights (norm scales and biases drawn away
from 1 and 0, so their gradients show) and batches are written once; then
at the same time the reference runs in two subprocesses of four host
devices each, one a mesh, its jitted ``value_and_grad`` of ``train_loss``
with ``param_shardings`` in-shardings for every smoke architecture (XLA's
cheaper backend passes, which keep fp32 results to rounding), and the port
as four gloo ranks (each a ``python -c``), its ``value_and_grad`` on each
rank's blocks and batch slice with the full configs' ``remat="full"`` (each
layer recomputed in the backward, its collectives with it), every gradient
leaf gathered whole.

Held here: the loss and every gradient leaf on (2, 2) and (1, 4) at
``tests/test_torch_distributed.py``'s tolerances (its sharded train step,
prefill and three decode steps run with the split on and off); the port
with ``sp_residuals`` on against off (granite smoke, fp32, (1, 4)) within
1e-5; the layer inputs remat keeps (recorded by a ``saved_tensors_hooks``
around ``transformer._remat``, which sees exactly the tensors
``torch.utils.checkpoint`` saves), ``[b, s / 4, d]`` tensors of their own
with the split and ``[b, s, d]`` without it or at a length 4 does not
divide (which still matches the reference); a control with the norms'
gradients left unsummed over ``model``, which must miss; the specs of
``lm_common.cstr_act`` / ``cstr_heads`` / ``cstr_custom`` against the ones
the reference's constraints ask for; and on a fake (2, 2) group the dry
run's peak and collective counts with the split against without it.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # CI installs requirements-dev.txt, which has no torch

from repro_torch import configs
from repro_torch.models import lm_common

REPO = Path(__file__).resolve().parents[1]
LOSS_TOL = dict(rtol=1e-5, atol=0)
LEAF_TOL = dict(rtol=1e-3, atol=1e-4)
#: sp_residuals on against off in the port (tests/test_perf_knobs.py's bound on the reference's loss)
KNOB_TOL = 1e-5
RANKS = 4
MESHES = ((2, 2), (1, 4))
ARCHS = configs.ARCHS
CASES = [(a, m) for a in ARCHS for m in MESHES]
#: the batch, and a sequence length 4 does not divide (granite on (1, 4))
BATCH, SEQ, ODD = 4, 16, 10
#: (function, shape, keyword arguments, mesh, seq_shard): lm_common's specs against the reference's constraints
CSTR = [("cstr_act", [4, 16, 64], {}, [2, 2], True), ("cstr_act", [4, 10, 64], {}, [1, 4], True),
        ("cstr_act", [4, 16, 64], {}, [1, 4], False), ("cstr_act", [3, 16, 64], {}, [2, 2], True),
        ("cstr_act", [4, 16], {}, [2, 2], True), ("cstr_act", [2, 8, 4, 16], {}, [2, 2], True),
        ("cstr_heads", [4, 16, 8, 16], {"head_axis": 2}, [1, 4], True),
        ("cstr_heads", [4, 16, 7, 8], {"head_axis": 2}, [1, 4], True),
        ("cstr_heads", [3, 16, 8, 16], {"head_axis": 2}, [2, 2], True),
        ("cstr_custom", [2, 4, 8, 2, 3, 16], {"batch_axis": 1, "tp_axis_at": 3}, [2, 2], True),
        ("cstr_custom", [2, 4, 8, 3, 3, 16], {"batch_axis": 1, "tp_axis_at": 3}, [2, 2], True),
        ("cstr_custom", [5, 8], {"batch_axis": 0}, [2, 2], True)]


def _env(**extra):
    return {**os.environ, "PYTHONPATH": str(REPO / "src"), **extra}


def _inputs(path: Path) -> None:
    """Every smoke architecture's weights (fp32) and batch, from one seed."""
    rng = np.random.default_rng(7)
    out = {}
    for arch in ARCHS:
        cfg = configs.get_smoke(arch)

        def draw(leaf, name):
            noise = rng.standard_normal(leaf.shape).astype(np.float32)
            if leaf.init == "dense":
                out[f"{arch}/p/{name}"] = noise / np.float32(np.sqrt(leaf.scale))
            else:
                out[f"{arch}/p/{name}"] = np.float32(leaf.init == "ones") + np.float32(0.1) * noise

        for name, leaf in _named(lm_common.param_spec(cfg)):
            draw(leaf, name)
        for s, tag in ((SEQ, "batch"), (ODD, "odd")):
            labels = rng.integers(0, cfg.vocab, (BATCH, s)).astype(np.int32)
            labels[0, :5] = -1
            labels[3, :2] = -1
            out[f"{arch}/{tag}/tokens"] = rng.integers(0, cfg.vocab, (BATCH, s)).astype(np.int32)
            out[f"{arch}/{tag}/labels"] = labels
            if cfg.n_patches:
                out[f"{arch}/{tag}/patch_embeds"] = rng.standard_normal((BATCH, cfg.n_patches, cfg.d_model),
                                                                        dtype=np.float32)
            if cfg.is_encdec:
                out[f"{arch}/{tag}/frames"] = rng.standard_normal((BATCH, cfg.enc_frames, cfg.d_model),
                                                                  dtype=np.float32)
    np.savez(path, **out)


def _named(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


# ---------------------------------------------------------------------------
# The reference: one process a mesh, four host devices each
# ---------------------------------------------------------------------------

REFERENCE = r"""
import dataclasses, json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_smoke
from repro.launch.shardings import sanitize
from repro.models import lm_common as jlm
from repro.models import transformer as jtf
from repro.models.lm_common import param_shardings

inp, out_path, shape = dict(np.load(sys.argv[1])), sys.argv[2], tuple(int(n) for n in sys.argv[3].split("x"))
archs, odd, cstr = json.loads(sys.argv[4]), sys.argv[5], json.loads(sys.argv[6])
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


def grads(cfg, params, batch, tag):
    pspec = sanitize(mesh, params, param_shardings(cfg))
    bspec = {k: P(("data",), *([None] * (v.ndim - 1))) for k, v in batch.items()}
    named = jax.tree.map(lambda s: NamedSharding(mesh, s), (pspec, bspec), is_leaf=lambda s: isinstance(s, P))
    f = jax.jit(jax.value_and_grad(lambda p, b: jtf.train_loss(cfg, p, b, mesh, ("data",), "model")),
                in_shardings=named)
    with mesh:
        loss, g = f(params, batch)
    out[tag + "loss"] = np.asarray(loss)
    for path, leaf in jax.tree_util.tree_flatten_with_path(g)[0]:
        out[tag + "g/" + "/".join(str(k.key) for k in path)] = np.asarray(leaf)


for arch in archs:
    cfg = dataclasses.replace(get_smoke(arch), dtype=jnp.float32)
    grads(cfg, nested(f"{arch}/p/"), nested(f"{arch}/batch/"), f"{arch}/")
if odd:
    cfg = dataclasses.replace(get_smoke(odd), dtype=jnp.float32)
    grads(cfg, nested(f"{odd}/p/"), nested(f"{odd}/odd/"), f"{odd}/odd/")

# the specs the constraints ask for (with_sharding_constraint recorded, not applied)
asked = []
jlm.jax.lax.with_sharding_constraint = lambda x, s: asked.append(s.spec) or x
for i, (fn, shp, kw, msh, seq) in enumerate(cstr):
    m = Mesh(np.asarray(jax.devices()[: msh[0] * msh[1]]).reshape(msh), ("data", "model"))
    with jlm.dist_context(m, ("data",), "model", seq_shard=seq):
        getattr(jlm, fn)(jnp.zeros(shp), **kw)
    out[f"cstr/{i}"] = np.asarray(json.dumps([list(e) if isinstance(e, tuple) else e for e in asked[-1]]))
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
from repro_torch.collectives import gather_act, gather_whole, sp_gather, sp_scatter, split_act
from repro_torch.launch.mesh import batch_shard, join_group, make_test_mesh
from repro_torch.models import lm_common, transformer
from repro_torch.models.layout import Layout, param_layout
from repro_torch.sharding import local_shard

rank, world, store, in_path, out_path = int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6]
odd = sys.argv[6]
join_group(world, rank, store=dist.FileStore(store, world), device="cpu")
inp = dict(np.load(in_path))
out = {}

# the tensors torch.utils.checkpoint keeps for each layer: a hook around _remat sees only them, since the
# checkpoint's own hook takes over the saves inside the layer
saved = []
remat = transformer._remat


def recording(cfg, fn, *args):
    def pack(t):
        if t.is_floating_point() and t.numel():  # not the empty marker some torch versions' checkpoint saves
            saved.append([*t.shape, t.untyped_storage().nbytes() // t.element_size()])
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        return remat(cfg, fn, *args)


transformer._remat = recording


def nested(prefix, cast=None):
    t = {}
    for k, v in inp.items():
        if k.startswith(prefix):
            *path, leaf = k[len(prefix):].split("/")
            d = t
            for p in path:
                d = d.setdefault(p, {})
            d[leaf] = torch.from_numpy(v) if cast is None else cast(v)
    return t


def as_batch(v):
    return torch.from_numpy(v).to(torch.int64 if v.dtype == np.int32 else torch.float32)


def grads(cfg, whole, batch, mesh, tag):
    specs = param_layout(cfg, mesh)
    mine = local_shard(mesh, tree.tree_map(torch.clone, whole), specs)
    saved.clear()
    loss, g = transformer.value_and_grad(cfg, mine, batch_shard(mesh, batch), mesh)
    out[tag + "loss"] = loss.numpy()
    out[tag + "saved"] = np.asarray(saved)
    for name, leaf in tree.named_leaves(gather_whole(mesh, g, specs)):
        out[tag + "g/" + name] = leaf.numpy()


for arch in configs.ARCHS:  # remat as the full configs take it: each layer recomputed, its collectives too
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype=torch.float32, remat="full")
    whole = lm_common.params_from_numpy(cfg, nested(f"{arch}/p/", np.asarray), "cpu")
    batch = nested(f"{arch}/batch/", as_batch)
    for shape in ((2, 2), (1, 4)):
        mesh = make_test_mesh(shape, device="cpu")
        grads(cfg, whole, batch, mesh, f"{arch}/{shape[0]}x{shape[1]}/")
        if arch == odd and shape == (1, 4):
            grads(dataclasses.replace(cfg, sp_residuals=False), whole, batch, mesh, f"{arch}/1x4/nosp/")
            for sp in (True, False):
                grads(dataclasses.replace(cfg, sp_residuals=sp), whole, nested(f"{arch}/odd/", as_batch), mesh,
                      f"{arch}/odd/{'sp' if sp else 'nosp'}/")
            Layout.NORMS, norms = frozenset(), Layout.NORMS  # control: the norms' gradients unsummed over model
            grads(cfg, whole, batch, mesh, f"{arch}/1x4/unsummed/")
            Layout.NORMS = norms

# the four crossings of the split stream on (1, 4), forward and backward, on each rank's own x
mesh = make_test_mesh((1, 4), device="cpu")
g = torch.Generator().manual_seed(rank)
for name, fn in (("sp_gather", sp_gather), ("sp_scatter", sp_scatter), ("gather_act", gather_act),
                 ("split_act", split_act)):
    x = torch.randn(2, 8, 3, generator=g, requires_grad=True)
    w = torch.randn(fn(x.detach(), mesh, "model", 1).shape, generator=g)
    y = fn(x, mesh, "model", 1)
    (dx,) = torch.autograd.grad((y * w).sum(), x)
    out[f"cross/{name}/x"], out[f"cross/{name}/w"] = x.detach().numpy(), w.numpy()
    out[f"cross/{name}/y"], out[f"cross/{name}/dx"] = y.detach().numpy(), dx.numpy()
np.savez(out_path, **out)
dist.barrier()
dist.destroy_process_group()
print("OK", rank)
"""

# ---------------------------------------------------------------------------
# The dry run on a fake (2, 2) group, with the split and without it
# ---------------------------------------------------------------------------

FAKE = r"""
import dataclasses, json, sys
import torch.distributed as dist
from repro_torch.configs import ShapeCell, get_smoke
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import join_fake_group, make_test_mesh

join_fake_group(4)
mesh = make_test_mesh((2, 2), device="cpu")
cell = ShapeCell("smoke_train", 256, 8, "train")  # long enough that the layers' saved inputs make the peak
out = {}
for sp in (True, False):
    cfg = dataclasses.replace(get_smoke("granite-3-2b"), remat="full", sp_residuals=sp)
    fn, args = dryrun.build(cfg, cell, mesh, cell.name)
    prof = dryrun.profile(fn, args)
    out[str(sp)] = {"peak": prof["peak"], "args": args, "flops": prof["flops"],
                    "ops": {k: v["count"] for k, v in dryrun.by_op(prof["collectives"]).items()},
                    "wire": sum(c["wire_bytes"] for c in prof["collectives"])}
dist.destroy_process_group()
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's outputs by mesh, the port's by rank): every process at once."""
    d = tmp_path_factory.mktemp("sp")
    _inputs(d / "in.npz")
    flags = ("--xla_force_host_platform_device_count=4 --xla_backend_optimization_level=0 "
             "--xla_llvm_disable_expensive_passes=true")
    ref_env = _env(XLA_FLAGS=flags, JAX_PLATFORMS="cpu")
    odd = "granite-3-2b"
    procs = {f"ref {m[0]}x{m[1]}": subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(d / "in.npz"), str(d / f"ref{m[0]}x{m[1]}.npz"), f"{m[0]}x{m[1]}",
         json.dumps(ARCHS), odd if m == (1, 4) else "", json.dumps(CSTR)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=ref_env, cwd=REPO) for m in MESHES}
    procs.update({f"rank {r}": subprocess.Popen(
        [sys.executable, "-c", PORT, str(r), str(RANKS), str(d / "store"), str(d / "in.npz"), str(d / f"rank{r}.npz"),
         odd], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env(OMP_NUM_THREADS="1"), cwd=REPO)
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
    return ref, [dict(np.load(d / f"rank{r}.npz")) for r in range(RANKS)], dict(np.load(d / "in.npz"))


@pytest.fixture(scope="module")
def fake(tmp_path_factory):
    path = tmp_path_factory.mktemp("fake") / "fake.json"
    r = subprocess.run([sys.executable, "-c", FAKE, str(path)], capture_output=True, text=True, timeout=600,
                       env=_env(OMP_NUM_THREADS="1"), cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(path.read_text())


def _leaves(d: dict, tag: str) -> dict:
    return {k[len(tag) + 2 :]: v for k, v in d.items() if k.startswith(tag + "g/")}


@pytest.mark.parametrize("arch,shape", CASES, ids=[f"{a}-{m[0]}x{m[1]}" for a, m in CASES])
def test_sharded_gradients_with_the_split_match_the_references_mesh_step(runs, arch, shape):
    ref, port, _ = runs
    tag = f"{arch}/{shape[0]}x{shape[1]}/"
    want = _leaves(ref[shape], arch + "/")
    for rank in range(RANKS):
        got = _leaves(port[rank], tag)
        assert sorted(got) == sorted(want)
        np.testing.assert_allclose(port[rank][tag + "loss"], ref[shape][arch + "/loss"], **LOSS_TOL)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **LEAF_TOL)
            np.testing.assert_array_equal(got[k], _leaves(port[0], tag)[k])  # the same on every rank


def _layer_inputs(d: dict, tag: str) -> np.ndarray:
    """[shape..., storage elements] of each float tensor remat kept."""
    return d[tag + "saved"]


@pytest.mark.parametrize("rank", range(RANKS))
def test_remat_keeps_each_ranks_block_of_the_sequence(runs, rank):
    _, port, _ = runs
    cfg = configs.get_smoke("granite-3-2b")
    split = _layer_inputs(port[rank], "granite-3-2b/1x4/")
    whole = _layer_inputs(port[rank], "granite-3-2b/1x4/nosp/")
    assert len(split) == len(whole) == cfg.n_layers
    block = [BATCH, SEQ // 4, cfg.d_model]
    assert split.tolist() == [block + [np.prod(block)]] * cfg.n_layers  # tensors of their own, not views
    assert whole.tolist() == [[BATCH, SEQ, cfg.d_model, BATCH * SEQ * cfg.d_model]] * cfg.n_layers
    for sp in ("sp", "nosp"):  # a length 4 does not divide: the sequence whole either way
        odd = _layer_inputs(port[rank], f"granite-3-2b/odd/{sp}/")
        assert odd.tolist() == [[BATCH, ODD, cfg.d_model, BATCH * ODD * cfg.d_model]] * cfg.n_layers
    # on (2, 2) every rank keeps its half of its data shard's sequence
    assert _layer_inputs(port[rank], "granite-3-2b/2x2/").tolist() == \
        [[BATCH // 2, SEQ // 2, cfg.d_model, BATCH * SEQ * cfg.d_model // 4]] * cfg.n_layers


@pytest.mark.parametrize("sp", ["sp", "nosp"])
def test_a_length_the_model_axis_does_not_divide_keeps_the_sequence_whole_and_matches(runs, sp):
    ref, port, _ = runs
    want = _leaves(ref[(1, 4)], "granite-3-2b/odd/")
    for rank in range(RANKS):
        tag = f"granite-3-2b/odd/{sp}/"
        np.testing.assert_allclose(port[rank][tag + "loss"], ref[(1, 4)]["granite-3-2b/odd/loss"], **LOSS_TOL)
        got = _leaves(port[rank], tag)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **LEAF_TOL)


def test_the_split_on_and_off_agree_in_the_port(runs):
    _, port, _ = runs
    for rank in range(RANKS):
        on, off = port[rank], port[rank]
        assert abs(float(on["granite-3-2b/1x4/loss"]) - float(off["granite-3-2b/1x4/nosp/loss"])) < KNOB_TOL
        a, b = _leaves(on, "granite-3-2b/1x4/"), _leaves(off, "granite-3-2b/1x4/nosp/")
        assert sorted(a) == sorted(b)
        for k in a:
            assert np.abs(a[k] - b[k]).max() < KNOB_TOL, k


def test_norm_gradients_unsummed_over_model_miss_the_reference(runs):
    ref, port, _ = runs
    want = _leaves(ref[(1, 4)], "granite-3-2b/")
    got = _leaves(port[0], "granite-3-2b/1x4/unsummed/")
    missed = set()
    for k in want:
        try:
            np.testing.assert_allclose(got[k], want[k], **LEAF_TOL)
        except AssertionError:
            missed.add(k)
    assert {"blocks/ln1", "blocks/ln2", "ln_f"} <= missed  # each norm on the block sees a quarter of the positions
    assert not missed - {"blocks/ln1", "blocks/ln2", "ln_f"}  # and nothing else changes


@pytest.mark.parametrize("name", ["sp_gather", "sp_scatter", "gather_act", "split_act"])
def test_the_crossings_of_the_split_stream(runs, name):
    _, port, _ = runs
    xs = [port[r][f"cross/{name}/x"] for r in range(RANKS)]
    ws = [port[r][f"cross/{name}/w"] for r in range(RANKS)]
    block = lambda a, r: a[:, r * (a.shape[1] // RANKS) : (r + 1) * (a.shape[1] // RANKS)]
    for r in range(RANKS):
        y, dx = port[r][f"cross/{name}/y"], port[r][f"cross/{name}/dx"]
        if name in ("sp_gather", "gather_act"):  # forward: the ranks' blocks joined
            np.testing.assert_array_equal(y, np.concatenate(xs, axis=1))
            # backward: the ranks' gradients summed (a reduce-scatter), or this rank's own (a slice)
            want = block(sum(ws), r) if name == "sp_gather" else block(ws[r], r)
        elif name == "sp_scatter":  # forward: the sum of the ranks' x, this rank's block
            np.testing.assert_allclose(y, block(sum(xs), r), rtol=1e-6, atol=1e-6)
            want = np.concatenate(ws, axis=1)  # backward: the blocks' gradients gathered
        else:  # forward: this rank's block of its own x; backward: the blocks' gradients gathered
            np.testing.assert_array_equal(y, block(xs[r], r))
            want = np.concatenate(ws, axis=1)
        np.testing.assert_allclose(dx, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", range(len(CSTR)))
def test_the_constraints_specs_are_the_references(runs, case):
    ref, _, _ = runs
    fn, shape, kw, msh, seq = CSTR[case]
    ctx = lm_common.dist_context({"data": msh[0], "model": msh[1]}, ("data",), "model", seq)
    got = getattr(lm_common, fn)(ctx, tuple(shape), **kw)
    norm = lambda e: e[0] if isinstance(e, (list, tuple)) and len(e) == 1 else (list(e) if isinstance(e, tuple) else e)
    want = [norm(e) for e in json.loads(str(ref[MESHES[0]][f"cstr/{case}"]))]
    assert [norm(e) for e in got] == want + [None] * (len(got) - len(want))


def test_dry_run_with_the_split_holds_less_and_trades_all_reduces(fake):
    on, off = fake["True"], fake["False"]
    assert on["args"] == off["args"] and on["flops"] == off["flops"]  # the same parameters and the same work
    assert on["peak"] < off["peak"]
    assert on["ops"]["all-reduce"] < off["ops"]["all-reduce"]
    assert on["ops"]["reduce-scatter"] > off["ops"]["reduce-scatter"]
    assert on["ops"]["all-gather"] > off["ops"]["all-gather"]
