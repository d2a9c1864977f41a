"""The port's dry run (``launch/dryrun.py``, ``hillclimb.py``, ``sweep.py``,
``launch.mesh.make_production_mesh``) against the JAX package's.

In-process: ``input_specs`` of the 40 cells (shapes and dtypes against the
reference's ``ShapeDtypeStruct``s, as ``tests/test_distributed.py`` checks
them), ``_model_flops``, the ring wire bytes against ``parse_collectives``
on synthetic HLO lines of the same (op, bytes, group) triples,
``hillclimb.parse_overrides`` and ``sweep``'s command lines.

Fake groups (``join_fake_group``) stay the default group of the process
that joins them, so each runs in a subprocess of its own: the production
meshes on 256 and 512 fake ranks; a smoke cell's ``meta`` profile on a
(1, 1) mesh, equal in FLOPs to the same step with no mesh; a smoke train
cell on a fake (2, 2) group, whose useful-FLOPs ratio is at most 1 (with
the full configs' remat: a smoke model's embedding is so large a share of
its parameters that 6·N·D passes its matmuls' FLOPs without recompute); and
smoke cells' per-rank argument bytes on (2, 2), against the reference's
``memory_analysis().argument_size_in_bytes`` of the same cells compiled on
four host devices.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")  # CI installs requirements-dev.txt, which has no torch

from repro import configs as jconfigs
from repro.launch import dryrun as jdry

from repro_torch import configs
from repro_torch.launch import dryrun, hillclimb, sweep
from repro_torch.collectives import wire_bytes

REPO = Path(__file__).resolve().parents[1]
CELLS = [(a, s) for a in configs.ARCHS for s in configs.SHAPES]
#: smoke cells whose per-rank argument bytes are held against the reference's on (2, 2): (arch, phase)
ARG_CELLS = [(a, p) for a in ("granite-3-2b", "phi3.5-moe-42b", "mamba2-130m", "zamba2-2.7b")
             for p in ("train", "prefill", "decode")]


def _env(**extra):
    return {**os.environ, "PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu", **extra}


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_input_specs_match_the_references(arch, shape):
    got = dryrun.input_specs(configs.get_config(arch), shape)
    want = jdry.input_specs(jconfigs.get_config(arch), shape)
    assert list(got) == list(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert str(got[k].dtype).removeprefix("torch.") == str(want[k].dtype), k
    cell = configs.SHAPES[shape]
    assert got["tokens"].shape[0] == cell.global_batch


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_model_flops_and_accumulation_match_the_references(arch, shape):
    cfg, jcfg = configs.for_shape(configs.get_config(arch), shape), jconfigs.for_shape(jconfigs.get_config(arch), shape)
    cell, jcell = configs.SHAPES[shape], jconfigs.SHAPES[shape]
    assert dryrun._model_flops(cfg, cell) == jdry._model_flops(jcfg, jcell)
    assert dryrun._accum_for(cfg, cell) == jdry._accum_for(jcfg, jcell)


TRIPLES = [("all-gather", 64 * 128 * 4, 16), ("all-reduce", 32 * 32 * 2, 4), ("reduce-scatter", 8 * 4, 16),
           ("all-to-all", 4096 * 4, 8), ("collective-permute", 16 * 4, 2), ("all-reduce", 4, 256),
           ("all-gather", 2 ** 20 * 2, 2)]


@pytest.mark.parametrize("op,nbytes,group", TRIPLES)
def test_wire_bytes_match_the_references_hlo_parse(op, nbytes, group):
    dtype, size = ("bf16", 2) if nbytes % 4 else ("f32", 4)
    groups = f"replica_groups=[{256 // group if group <= 256 else 1},{group}]<=[256]"
    line = f"  %x = {dtype}[{nbytes // size}]{{0}} {op}(%p0), channel_id=1, {groups}, dimensions={{0}}"
    (parsed,) = jdry.parse_collectives(line)
    assert parsed["bytes"] == nbytes and parsed["group"] == group
    assert wire_bytes(op, nbytes, group) == parsed["wire_bytes"]
    rows = [{"op": op, "bytes": nbytes, "group": group, "wire_bytes": wire_bytes(op, nbytes, group)}] * 2
    assert dryrun.by_op(rows) == {op: {"count": 2, "bytes": 2.0 * nbytes, "wire_bytes": 2 * parsed["wire_bytes"]}}


def test_link_rates_follow_the_node():
    assert dryrun.link_bw({"data": 16, "model": 16}, "model") == dryrun.IB_BW
    assert dryrun.link_bw({"data": 16, "model": 16}, "data") == dryrun.IB_BW
    assert dryrun.link_bw({"data": 32, "model": 8}, "model") == dryrun.NVLINK_BW
    assert dryrun.link_bw({"data": 32, "model": 8}, "data") == dryrun.IB_BW


@pytest.mark.parametrize("pairs,want", [
    (["attn_q_block=1024", "remat=none"], {"attn_q_block": 1024, "remat": "none"}),
    (["dtype=bf16", "accum_dtype=f32"], {"dtype": torch.bfloat16, "accum_dtype": torch.float32}),
    (["sp_residuals=False", "attn_fp32_scores=True"], {"sp_residuals": False, "attn_fp32_scores": True}),
    ([], {}),
])
def test_parse_overrides(pairs, want):
    assert hillclimb.parse_overrides(pairs) == want


def test_sweep_runs_one_dryrun_process_per_missing_cell(tmp_path):
    (tmp_path / "granite-3-2b__train_4k__single.json").write_text("{}")
    cmds = sweep.commands(["single", "multi"], tmp_path)
    assert len(cmds) == 2 * len(CELLS) - 1
    arch, shape, mk, cmd = cmds[0]
    assert (arch, shape, mk) == (configs.ARCHS[0], "train_4k", "single")
    assert cmd == [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape, "--mesh", mk,
                   "--out", str(tmp_path)]
    assert ("granite-3-2b", "train_4k", "single") not in [c[:3] for c in cmds]
    assert [c[2] for c in cmds].count("multi") == len(CELLS)


# ---------------------------------------------------------------------------
# Fake groups, each in a process of its own
# ---------------------------------------------------------------------------

FAKE = r"""
import dataclasses, json, sys
import torch, torch.distributed as dist
from repro_torch.configs import ShapeCell, get_smoke
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import join_fake_group, make_production_mesh, make_test_mesh
from repro_torch.launch.shardings import init_shards
from repro_torch.models.layout import param_layout
from repro_torch.sharding import tree_bytes
from repro_torch.models.transformer import make_train_step
from repro_torch.optim import AdamW, AdamWConfig

out = {}
for n, multi in ((256, False), (512, True)):
    join_fake_group(n)
    m = make_production_mesh(multi_pod=multi, device="meta")
    out[f"mesh{n}"] = [list(m.mesh_dim_names), list(m.mesh.shape), list(m.get_coordinate())]
    dist.destroy_process_group()
join_fake_group(100)
try:
    make_production_mesh()
except RuntimeError as e:
    out["small"] = str(e)
dist.destroy_process_group()

join_fake_group(4)
cell = ShapeCell("smoke_train", 16, 4, "train")  # whisper smoke: 16 decoder tokens over its 16 frames
cfg = get_smoke("granite-3-2b")
one = make_test_mesh((1, 1), device="cpu")
fn, args = dryrun.build(cfg, cell, one, "smoke_train")
solo = dryrun.profile(fn, args)
specs = param_layout(cfg, {"data": 1, "model": 1})
params = init_shards(cfg, {"data": 1, "model": 1}, specs, None, "meta")
opt = AdamW(AdamWConfig())
state = opt.init(params)
batch = {k: torch.empty(s.shape, dtype=s.dtype, device="meta") for k, s in dryrun.input_specs(cfg, "x", cell).items()}
step = make_train_step(cfg, opt)
bare = dryrun.profile(lambda: step(params, state, batch), tree_bytes(params) + tree_bytes(state) + tree_bytes(batch))
out["solo"] = {"flops": solo["flops"], "bytes": solo["bytes"], "colls": len(solo["collectives"]), "args": args}
out["bare"] = {"flops": bare["flops"], "bytes": bare["bytes"], "args": tree_bytes(params) + tree_bytes(state) + tree_bytes(batch)}
out["kernels"] = solo["kernels"]

mesh = make_test_mesh((2, 2), device="cpu")
out["useful"] = {}
for arch in ("granite-3-2b", "phi3.5-moe-42b", "mamba2-130m", "whisper-small"):
    c = dataclasses.replace(get_smoke(arch), remat="full")  # the full configs' remat
    fn, args = dryrun.build(c, cell, mesh, "smoke_train")
    prof = dryrun.profile(fn, args)
    out["useful"][arch] = {"model": dryrun._model_flops(c, cell), "flops": prof["flops"],
                           "ops": sorted({x["op"] for x in prof["collectives"]})}
out["args"] = {}
for arch, phase in json.loads(sys.argv[2]):
    c = get_smoke(arch)
    cl = ShapeCell(f"smoke_{phase}", 16, 4, phase)
    out["args"][f"{arch}/{phase}"] = dryrun.build(c, cl, mesh, cl.name)[1]
dist.destroy_process_group()
json.dump(out, open(sys.argv[1], "w"))
"""

REF_ARGS = r"""
import dataclasses, json, sys
import numpy as np, jax
from jax.sharding import Mesh
from repro.configs import ShapeCell, get_smoke
from repro.launch import dryrun

mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
out = {}
for arch, phase in json.loads(sys.argv[2]):
    cell = ShapeCell(f"smoke_{phase}", 16, 4, phase)
    compiled = dryrun._build_and_compile(get_smoke(arch), cell, mesh, cell.name)
    out[f"{arch}/{phase}"] = compiled.memory_analysis().argument_size_in_bytes
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def fake(tmp_path_factory):
    path = tmp_path_factory.mktemp("fake") / "fake.json"
    r = subprocess.run([sys.executable, "-c", FAKE, str(path), json.dumps(ARG_CELLS)], capture_output=True, text=True,
                       timeout=600, env=_env(OMP_NUM_THREADS="1"), cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(path.read_text())


@pytest.fixture(scope="module")
def ref_args(tmp_path_factory):
    path = tmp_path_factory.mktemp("refargs") / "args.json"
    r = subprocess.run([sys.executable, "-c", REF_ARGS, str(path), json.dumps(ARG_CELLS)], capture_output=True,
                       text=True, timeout=600, env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4"), cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(path.read_text())


@pytest.mark.parametrize("n,multi", [(256, False), (512, True)])
def test_production_mesh_on_a_fake_group(fake, n, multi):
    names, shape, coord = fake[f"mesh{n}"]
    assert names == (["pod", "data", "model"] if multi else ["data", "model"])
    assert shape == ([2, 16, 16] if multi else [16, 16])
    assert coord == [0] * len(shape)


def test_production_mesh_needs_the_ranks(fake):
    assert "need 256 ranks" in fake["small"] and "join_fake_group" in fake["small"]


def test_a_one_rank_mesh_profiles_the_flops_of_no_mesh(fake):
    assert fake["solo"]["flops"] == fake["bare"]["flops"] > 0
    # the mesh path's few scalar steps (the global token count, the loss's value) add a few bytes of traffic
    assert abs(fake["solo"]["bytes"] - fake["bare"]["bytes"]) <= 1e-5 * fake["bare"]["bytes"]
    assert fake["solo"]["args"] == fake["bare"]["args"]
    assert fake["solo"]["colls"] == 0
    assert fake["kernels"]["flash_attention"]["calls"] == fake["kernels"]["flash_attention_bwd"]["calls"] > 0


@pytest.mark.parametrize("arch", ["granite-3-2b", "phi3.5-moe-42b", "mamba2-130m", "whisper-small"])
def test_useful_flops_ratio_on_a_fake_2x2_group_is_at_most_one(fake, arch):
    row = fake["useful"][arch]
    assert 0 < row["model"] / (row["flops"] * 4) <= 1
    assert "all-gather" in row["ops"] and "reduce-scatter" in row["ops"]


@pytest.mark.parametrize("arch,phase", ARG_CELLS, ids=[f"{a}-{p}" for a, p in ARG_CELLS])
def test_argument_bytes_per_rank_match_the_references_memory_analysis(fake, ref_args, arch, phase):
    got, want = fake["args"][f"{arch}/{phase}"], ref_args[f"{arch}/{phase}"]
    # the reference's cache carries its decode index as an int32 scalar on the device; the port's is a host int
    assert got + (4 if phase == "decode" else 0) == want


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=dtype.is_floating_point)


@pytest.mark.parametrize("kernel", ["gemm", "flash_attention", "ssd_scan", "conv2d_im2col"])
def test_a_meta_tensor_computes_nothing_and_counts_the_kernels_formula(kernel):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gemm as gm
    from repro_torch.kernels import im2col_conv, ops
    from repro_torch.kernels import ssd_scan as ssd

    with ops.count_meta() as counts:
        if kernel == "gemm":
            a, b = _meta(4, 64, 32), _meta(4, 32, 48)
            out = ops.gemm(a, b)
            assert out.shape == (4, 64, 48) and out.dtype == a.dtype
            want = gm.cost(a, b)
            grads = torch.autograd.grad(out.sum(), (a, b))
            bwd = gm.bwd_cost(a, b)
        elif kernel == "flash_attention":
            q, k, v = _meta(2, 8, 64, 16), _meta(2, 2, 64, 16), _meta(2, 2, 64, 16)
            out = ops.flash_attention(q, k, v, causal=True)
            assert out.shape == q.shape and out.dtype == q.dtype
            want = fa.cost(q, k, v, True, 0)
            assert want[0] == 4.0 * 2 * 8 * 16 * (64 * 65 // 2)  # the visible pairs of a causal 64 x 64 mask
            grads = torch.autograd.grad(out.sum(), (q, k, v))
            bwd = fa.bwd_cost(q, k, True, 0)
        elif kernel == "ssd_scan":
            x, dt, A = _meta(2, 32, 4, 16), _meta(2, 32, 4, dtype=torch.float32), _meta(4, dtype=torch.float32)
            B, C = _meta(2, 32, 8), _meta(2, 32, 8)
            out, state = ops.ssd_scan(x, dt, A, B, C, chunk=8)
            assert out.shape == x.shape and out.dtype == x.dtype
            assert state.shape == (2, 4, 16, 8) and state.dtype == torch.float32
            want = ssd.cost(x, B, 8)
            grads = torch.autograd.grad(out.sum(), (x, dt, A, B, C))
            bwd = ssd.bwd_cost(x, B, 8, False)
        else:
            x, w = _meta(2, 9, 9, 3, dtype=torch.float32), _meta(3, 3, 3, 8, dtype=torch.float32)
            with torch.no_grad():
                out = ops.conv2d_im2col(x, w, stride=2)
            assert out.shape == (2, 5, 5, 8)
            want, grads, bwd = im2col_conv.cost(x, w, 2), (), None
    assert all(g.device.type == "meta" for g in grads)
    assert counts[kernel] == {"calls": 1, "flops": want[0], "bytes": want[1]}
    if bwd is not None:
        assert counts[f"{kernel}_bwd"] == {"calls": 1, "flops": bwd[0], "bytes": bwd[1]}
    assert out.device.type == "meta"
