"""The port's sharded layout (``launch/shardings.py``, ``sharding.py``,
``models/layout.py``, ``lm_common.param_shardings``) against the JAX package's.

Specs at tolerance zero: the reference's ``PartitionSpec``s turned into
tuples against the port's ``P``s, for all ten full configs on the
shape-only meshes (16, 16), (2, 16, 16), (2, 2), (1, 4) and (4, 1) (the
reference's functions read only ``mesh.shape`` and ``mesh.axis_names``, so
a namespace object serves them in-process), the caches over
``init_cache``'s shapes of the four ``SHAPES`` cells.  Shard arithmetic: the
blocks of every rank tile each leaf once, in the reference's order (on
(2, 2) against ``NamedSharding``'s indices and shard shapes, taken in a
subprocess with four host devices).  Checkpoints: a checkpoint saved whole
restores into each rank's blocks.  (A sharded save, and the gather back, run
over gloo ranks in ``tests/test_torch_distributed.py``.)
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

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.launch import dryrun as jdry
from repro.launch import shardings as jsh
from repro.models import lm_common as jlm
from repro.models import transformer as jtf

from repro_torch import configs, tree
from repro_torch.checkpoint import CheckpointStore
from repro_torch import sharding
from repro_torch.launch import shardings as sh
from repro_torch.launch.dryrun import _maybe_dp, input_specs
from repro_torch.models import lm_common
from repro_torch.models.layout import param_layout

REPO = Path(__file__).resolve().parents[1]
MESHES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2}, "1x4": {"data": 1, "model": 4}, "4x1": {"data": 4, "model": 1}}
ARCHS = configs.ARCHS


def _ref_mesh(shape: dict):
    return SimpleNamespace(shape=dict(shape), axis_names=tuple(shape), size=int(np.prod(list(shape.values()))))


def _tuples(t):
    """A spec tree as nested dicts of plain tuples (either package's)."""
    if isinstance(t, dict):
        return {k: _tuples(v) for k, v in t.items()}
    return tuple(t)


def _ref_tuples(t):
    return jax.tree.map(tuple, t, is_leaf=lambda x: isinstance(x, JP))


@pytest.fixture(scope="module")
def ref_params():
    return {a: jax.eval_shape(lambda a=a: jlm.init_params(jconfigs.get_config(a), jax.random.PRNGKey(0))) for a in ARCHS}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_optimizer_specs_match_the_reference(ref_params, arch, mesh):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    assert _tuples(lm_common.param_shardings(cfg)) == _ref_tuples(jlm.param_shardings(jcfg))
    assert _tuples(lm_common.param_shardings(cfg, fsdp_axis=None)) == _ref_tuples(jlm.param_shardings(jcfg, fsdp_axis=None))
    rm = _ref_mesh(MESHES[mesh])
    want = jsh.sanitize(rm, ref_params[arch], jsh.params_pspecs(jcfg, rm))
    got = sh.sanitize(MESHES[mesh], lm_common.param_spec(cfg), sh.params_pspecs(cfg, MESHES[mesh]))
    assert _tuples(got) == _ref_tuples(want)
    assert _tuples(param_layout(cfg, MESHES[mesh])) == _tuples(got)
    assert _tuples(sh.opt_pspecs(cfg, MESHES[mesh], got)) == _ref_tuples(jsh.opt_pspecs(jcfg, rm, want))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_match_the_reference(arch, mesh):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    rm, m = _ref_mesh(MESHES[mesh]), MESHES[mesh]
    for name, cell in configs.SHAPES.items():
        if not configs.applicable(arch, name)[0]:
            continue
        c, jc = configs.for_shape(cfg, name), jconfigs.for_shape(jcfg, name)
        cache = jax.eval_shape(lambda: jtf.init_cache(jc, cell.global_batch, cell.seq_len))
        want = jsh.sanitize(rm, cache, jdry._maybe_dp(rm, jsh.cache_pspecs(jc, rm, cache), cell.global_batch))
        got = sh.sanitize(m, cache, _maybe_dp(m, sh.cache_pspecs(c, m, cache), cell.global_batch))
        assert _tuples(got) == _ref_tuples(want), name
        batch = jdry.input_specs(jc, name)
        want = jdry._maybe_dp(rm, jsh.batch_pspecs(jc, rm, batch), cell.global_batch)
        got = _maybe_dp(m, sh.batch_pspecs(c, m, input_specs(c, name)), cell.global_batch)
        assert _tuples(got) == _ref_tuples(want), name


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sanitize_drops_the_axes_a_dim_does_not_divide(mesh):
    m = MESHES[mesh]
    leaves = {"a": SimpleNamespace(shape=(51865, 768)), "b": SimpleNamespace(shape=(3352, 64)),
              "c": SimpleNamespace(shape=(32, 4096))}
    spec = {"a": lm_common.P("model", "data"), "b": lm_common.P(("data", "model"), None),
            "c": lm_common.P(tuple(a for a in m if a != "model"), "model")}
    got = sh.sanitize(m, leaves, spec)
    want = jsh.sanitize(_ref_mesh(m), {k: jax.ShapeDtypeStruct(v.shape, jnp.float32) for k, v in leaves.items()},
                        {k: JP(*v) for k, v in spec.items()})
    assert _tuples(got) == _ref_tuples(want)


def _coords(sizes: dict):
    names = list(sizes)
    for flat in range(int(np.prod(list(sizes.values())))):
        coord, rest = {}, flat
        for a in reversed(names):
            coord[a], rest = rest % sizes[a], rest // sizes[a]
        yield coord


@pytest.mark.parametrize("mesh", ["2x2", "1x4", "4x1", "16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_the_ranks_blocks_tile_every_leaf_once(arch, mesh):
    """Every rank's block of each smoke leaf, by the spec's arithmetic, the
    first axis of a tuple outermost: the blocks cover each element the
    number of ranks the leaf is replicated over; on (16, 16) the full
    config's shard shapes divide each dim."""
    m = MESHES[mesh]
    full = configs.get_config(arch)
    for leaf, spec in zip(tree.leaves(lm_common.param_spec(full)), tree.leaves(param_layout(full, m))):
        shard = sharding.shard_shape(leaf.shape, spec, m)
        assert all(n % s == 0 for n, s in zip(leaf.shape, shard))
    if mesh == "16x16":
        return
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype=torch.float32)
    params = lm_common.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    specs = param_layout(cfg, m)
    n_ranks = int(np.prod(list(m.values())))
    for (name, t), spec in zip(tree.named_leaves(params), tree.leaves(specs)):
        seen = torch.zeros(t.shape, dtype=torch.int32)
        split = int(np.prod([m[a] for a in sharding.spec_axes(spec)]))
        for coord in _coords(m):
            block = sharding.local_shard(m, t, spec, coord)
            sl = sharding.shard_slices(t.shape, spec, m, coord)
            assert tuple(block.shape) == sharding.shard_shape(t.shape, spec, m)
            torch.testing.assert_close(block, t[sl], rtol=0, atol=0)
            seen[sl] += 1
        assert (seen == n_ranks // split).all(), name


def test_a_tuple_of_axes_splits_with_the_first_outermost():
    m = {"pod": 2, "data": 3, "model": 2}
    t = torch.arange(12 * 4).reshape(12, 4)
    spec = lm_common.P(("pod", "data"), "model")
    blocks = {(c["pod"], c["data"], c["model"]): sharding.local_shard(m, t, spec, c) for c in _coords(m)}
    assert torch.equal(blocks[(1, 0, 1)], t[6:8, 2:4])  # row block 1 * 3 + 0 = 3
    assert torch.equal(blocks[(0, 2, 0)], t[4:6, 0:2])  # row block 0 * 3 + 2 = 2
    whole = torch.cat([torch.cat([blocks[(p, d, 0)], blocks[(p, d, 1)]], 1) for p in range(2) for d in range(3)])
    assert torch.equal(whole, t)


REF_SHARDS = r"""
import json, sys
import numpy as np, jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import ARCHS, get_smoke
from repro.launch.shardings import sanitize, params_pspecs
from repro.models.lm_common import init_params

mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
out = {}
for arch in ARCHS:
    cfg = get_smoke(arch)
    params = jax.eval_shape(lambda: init_params(cfg, jax.random.PRNGKey(0)))
    spec = sanitize(mesh, params, params_pspecs(cfg, mesh))
    rows = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        s = spec
        for k in path:
            s = s[k.key]
        ns = NamedSharding(mesh, s)
        where = {}
        for d, idx in ns.devices_indices_map(leaf.shape).items():
            i, j = np.argwhere(mesh.devices == d)[0]
            where[f"{i},{j}"] = [[x.start or 0, x.stop if x.stop is not None else n] for x, n in zip(idx, leaf.shape)]
        rows.append({"name": "/".join(k.key for k in path), "shape": list(ns.shard_shape(leaf.shape)), "where": where})
    out[arch] = rows
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def ref_shards(tmp_path_factory):
    path = tmp_path_factory.mktemp("shards") / "shards.json"
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    r = subprocess.run([sys.executable, "-c", REF_SHARDS, str(path)], capture_output=True, text=True, timeout=300,
                       env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(path.read_text())


@pytest.mark.parametrize("arch", ARCHS)
def test_blocks_on_2x2_are_the_references_named_sharding_blocks(ref_shards, arch):
    m = MESHES["2x2"]
    cfg = configs.get_smoke(arch)
    specs = param_layout(cfg, m)
    rows = {r["name"]: r for r in ref_shards[arch]}
    for (name, leaf), spec in zip(tree.named_leaves(lm_common.param_spec(cfg)), tree.leaves(specs)):
        assert list(sharding.shard_shape(leaf.shape, spec, m)) == rows[name]["shape"], name
        for c in _coords(m):
            sl = sharding.shard_slices(leaf.shape, spec, m, c)
            assert [[s.start, s.stop] for s in sl] == rows[name]["where"][f"{c['data']},{c['model']}"], name


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_a_checkpoint_saved_whole_restores_into_each_ranks_blocks(tmp_path, mesh):
    m = MESHES[mesh]
    cfg = dataclasses.replace(configs.get_smoke("granite-3-2b"), dtype=torch.float32)
    params = lm_common.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    CheckpointStore(tmp_path).save(3, params)
    specs = param_layout(cfg, m)
    for coord in _coords(m):
        like = sharding.local_shard(m, params, specs, coord)
        step, back = CheckpointStore(tmp_path).restore_latest(like, (m, specs), coord)
        assert step == 3
        for a, b in zip(tree.leaves(back), tree.leaves(like)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)

