"""The port's training substrate against the JAX package's, on the CPU.

Mirrors ``tests/test_substrate.py`` (AdamW, int8 quantisation, the data
pipeline, the checkpoint store) and ``tests/test_fault_tolerance.py``
(elastic rescale, the supervised train loop) for ``repro_torch``, and holds
each piece against the reference where both compute the same thing: the
schedule and one update, quantised values, batches bit for bit,
checkpoints read across the two stores both ways, and the elastic
scheduler trial for trial.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # CI installs requirements-dev.txt, which has no torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro import core as jcore
from repro.checkpoint import CheckpointStore as JCheckpointStore
from repro.data import DataConfig as JDataConfig
from repro.data import make_batch_iterator as j_make_batch_iterator
from repro.models.cnn import network_layers as j_network_layers
from repro.optim import AdamW as JAdamW
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import cosine_schedule as j_cosine_schedule
from repro.optim import dequantize as j_dequantize
from repro.optim import quantize_int8 as j_quantize_int8
from repro.runtime import ElasticScheduler as JElasticScheduler
from repro_torch import configs, core
from repro_torch.checkpoint import CheckpointStore
from repro_torch.data import DataConfig, SyntheticLMData, make_batch_iterator
from repro_torch.models.cnn import network_layers
from repro_torch.optim import AdamW, AdamWConfig, cosine_schedule, dequantize, quantize_int8
from repro_torch.runtime import ElasticScheduler, TrainSupervisor

# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def test_adamw_minimizes_quadratic():
    opt = AdamW(AdamWConfig(peak_lr=0.1, warmup=5, total_steps=200, weight_decay=0.0, moment_dtype=torch.float32))
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(200):
        opt.update({"w": 2 * params["w"]}, state, params)  # the gradient of sum(w ** 2)
    assert float(params["w"].abs().max()) < 1e-2


def test_adamw_clips_gradients():
    opt = AdamW(AdamWConfig(clip_norm=1.0))
    params = {"w": torch.zeros(4)}
    _, _, m = opt.update({"w": torch.full((4,), 1e6)}, opt.init(params), params)
    assert float(m["grad_norm"]) > 1.0  # raw norm reported


def test_master_weights_dtype():
    opt = AdamW(AdamWConfig())
    state = opt.init({"w": torch.zeros(4, dtype=torch.bfloat16)})
    assert state["master"]["w"].dtype == torch.float32
    assert state["mu"]["w"].dtype == torch.bfloat16
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0


@pytest.mark.parametrize("step", [0, 1, 4, 5, 50, 99, 100, 150])
def test_cosine_schedule_matches_the_reference(step):
    kw = dict(peak_lr=3e-4, warmup=5, total=100)
    np.testing.assert_allclose(float(cosine_schedule(step, **kw)), float(j_cosine_schedule(jnp.int32(step), **kw)),
                               rtol=1e-6)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("master", [True, False])
def test_three_updates_match_the_reference(moments, master):
    """Params (bf16 and fp32 leaves), moments and master after three updates
    with clipping, bias correction and weight decay, against the reference."""
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 5), "b": {"c": (7,), "d": (2, 2, 2)}}
    p_np = jax.tree.map(lambda sh: rng.standard_normal(sh).astype(np.float32), shapes, is_leaf=lambda x: isinstance(x, tuple))
    kw = dict(peak_lr=1e-2, warmup=1, total_steps=5, clip_norm=0.5, master_weights=master)
    opt = AdamW(AdamWConfig(moment_dtype=getattr(torch, moments), **kw))
    jopt = JAdamW(JAdamWConfig(moment_dtype=getattr(jnp, moments), **kw))
    tp = {"a": torch.tensor(p_np["a"]).to(torch.bfloat16), "b": {k: torch.tensor(v) for k, v in p_np["b"].items()}}
    jp = {"a": jnp.asarray(p_np["a"], jnp.bfloat16), "b": {k: jnp.asarray(v) for k, v in p_np["b"].items()}}
    ts, js = opt.init(tp), jopt.init(jp)
    for i in range(3):
        g_np = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), p_np)
        tg = {"a": torch.tensor(g_np["a"]).to(torch.bfloat16), "b": {k: torch.tensor(v) for k, v in g_np["b"].items()}}
        jg = {"a": jnp.asarray(g_np["a"], jnp.bfloat16), "b": {k: jnp.asarray(v) for k, v in g_np["b"].items()}}
        tp, ts, tm = opt.update(tg, ts, tp)
        jp, js, jm = jopt.update(jg, js, jp)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    for ours, theirs in ((tp, jp), (ts["mu"], js["mu"]), (ts["nu"], js["nu"])) + (
            ((ts["master"], js["master"]),) if master else ()):
        for key in ("a", "b"):
            for t, j in zip(jax.tree.leaves({key: ours[key]}, is_leaf=lambda x: isinstance(x, torch.Tensor)),
                            jax.tree.leaves({key: theirs[key]})):
                np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), rtol=1e-5, atol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 3


def test_update_writes_in_place_and_returns_the_same_tensors():
    opt = AdamW(AdamWConfig(moment_dtype=torch.float32))
    params = {"w": torch.ones(5, dtype=torch.bfloat16)}
    state = opt.init(params)
    ids = params["w"].data_ptr(), state["mu"]["w"].data_ptr(), state["master"]["w"].data_ptr()
    p2, s2, _ = opt.update({"w": torch.ones(5, dtype=torch.bfloat16)}, state, params)
    assert (p2["w"].data_ptr(), s2["mu"]["w"].data_ptr(), s2["master"]["w"].data_ptr()) == ids
    assert p2 is params and s2 is state


def test_update_in_chunks_equals_one_piece(monkeypatch):
    from repro_torch.optim import adamw

    def run():
        params = {"w": torch.linspace(-1, 1, 37).reshape(37, 1)}
        state = AdamW(AdamWConfig()).init(params)
        return AdamW(AdamWConfig()).update({"w": torch.linspace(2, -3, 37).reshape(37, 1)}, state, params)

    whole = run()
    monkeypatch.setattr(adamw, "CHUNK", 5)
    chunked = run()
    assert torch.equal(whole[0]["w"], chunked[0]["w"])
    assert torch.equal(whole[1]["nu"]["w"], chunked[1]["nu"]["w"])
    assert torch.equal(whole[2]["grad_norm"], chunked[2]["grad_norm"])


# ---------------------------------------------------------------------------
# Int8 quantisation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale_mag", [1e-6, 3e-3, 1.0, 7.5, 1e3, 1e6])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_bounds_and_reference_values(scale_mag, seed):
    x = np.random.default_rng(seed).standard_normal(32).astype(np.float32) * np.float32(scale_mag)
    scale = np.float32(max(np.abs(x).max(), 1e-12) / 127.0)
    q = quantize_int8(torch.from_numpy(x), scale)
    assert q.dtype == torch.int8
    err = (dequantize(q, scale) - torch.from_numpy(x)).abs()
    assert float(err.max()) <= float(scale) * 0.5 + 1e-6
    jq = j_quantize_int8(jnp.asarray(x), jnp.float32(scale))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(dequantize(q, scale).numpy(), np.asarray(j_dequantize(jq, jnp.float32(scale))))


def test_quantize_clips_to_127():
    q = quantize_int8(torch.tensor([1e9, -1e9, 0.4]), 1.0)
    assert q.tolist() == [127, -127, 0]


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["granite-3-2b", "whisper-small", "internvl2-76b"])
@pytest.mark.parametrize("seed,start", [(0, 0), (3, 7), (12345, 1000)])
def test_batches_are_bit_equal_to_the_reference(arch, seed, start):
    tcfg, jcfg = configs.get_smoke(arch), jconfigs.get_smoke(arch)
    ours = make_batch_iterator(tcfg, DataConfig(batch=3, seq=24, vocab=tcfg.vocab, seed=seed), start, device="cpu")
    theirs = j_make_batch_iterator(jcfg, JDataConfig(batch=3, seq=24, vocab=jcfg.vocab, seed=seed), start)
    for _ in range(2):
        t, j = next(ours), next(theirs)
        assert sorted(t) == sorted(j)
        for key in t:
            assert t[key].dtype == (torch.int64 if key in ("tokens", "labels") else torch.float32)
            np.testing.assert_array_equal(t[key].numpy(), np.asarray(j[key]))


def test_batch_at_is_a_pure_function_of_seed_and_step():
    ds = SyntheticLMData(DataConfig(batch=2, seq=32, vocab=100, seed=5))
    a, b = ds.batch_at(3), ds.batch_at(3)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["tokens"], ds.batch_at(4)["tokens"])
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert a["tokens"].min() >= 0 and a["tokens"].max() < 100


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def _state():
    g = torch.Generator().manual_seed(0)
    return {"params": {"w": torch.randn(3, 4, generator=g).to(torch.bfloat16), "b": torch.randn(4, generator=g)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32), "mu": {"w": torch.randn(3, 4, generator=g)}}}


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        _equal(a[k], b[k]) if isinstance(a[k], dict) else (a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]))
        for k in a)


def test_checkpoint_round_trip(tmp_path):
    store = CheckpointStore(tmp_path)
    state = _state()
    store.save(10, state)
    assert store.steps() == [10]
    step, back = store.restore_latest(state)
    assert step == 10 and _equal(back, state)


def test_checkpoint_gc_keeps_the_last_steps(tmp_path):
    store = CheckpointStore(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        store.save(s, _state())
    assert store.steps() == [3, 4]


def test_checkpoint_async_save_snapshots_before_returning(tmp_path):
    store = CheckpointStore(tmp_path)
    state = _state()
    want = {"params": {k: v.clone() for k, v in state["params"].items()}, "opt": state["opt"]}
    store.save(5, state, async_=True)
    state["params"]["b"].add_(1.0)  # an in-place update right after save returns
    store.wait()
    assert _equal(store.restore(5, state), want)


def test_torn_write_is_skipped(tmp_path):
    store = CheckpointStore(tmp_path)
    store.save(1, _state())
    store.save(2, _state())
    (tmp_path / "step_00000002" / "_DONE").unlink()
    (tmp_path / ".tmp_step_00000003").mkdir()
    assert store.steps() == [1]
    assert store.restore_latest(_state())[0] == 1


def test_checkpoint_shape_and_leaf_count_mismatch_raise(tmp_path):
    store = CheckpointStore(tmp_path)
    store.save(1, _state())
    bad = _state()
    bad["params"]["b"] = torch.zeros(5)
    with pytest.raises(ValueError, match="shape"):
        store.restore(1, bad)
    fewer = _state()
    del fewer["opt"]["mu"]
    with pytest.raises(ValueError, match="leaves"):
        store.restore(1, fewer)


def test_the_reference_store_restores_a_port_checkpoint_and_the_reverse(tmp_path):
    state = _state()
    jstate = jax.tree.map(lambda t: jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.int32 if t.dtype == torch.int32 else jnp.float32),
        state, is_leaf=lambda x: isinstance(x, torch.Tensor))
    CheckpointStore(tmp_path / "port").save(3, state)
    back = JCheckpointStore(tmp_path / "port").restore(3, jstate)
    for t, j in zip(jax.tree.leaves(state, is_leaf=lambda x: isinstance(x, torch.Tensor)), jax.tree.leaves(back)):
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(j, np.float32))
    JCheckpointStore(tmp_path / "ref").save(4, jstate)
    step, ours = CheckpointStore(tmp_path / "ref").restore_latest(state)
    assert step == 4 and _equal(ours, state)


# ---------------------------------------------------------------------------
# Fault tolerance
# ---------------------------------------------------------------------------


def test_supervisor_nan_quarantine(tmp_path):
    store = CheckpointStore(tmp_path)
    calls = {"n": 0}

    def step_fn(state, step):
        calls["n"] += 1
        v = state["x"] + 1.0
        if step == 4 and calls["n"] < 8:  # poison exactly one step the first time it is reached
            return {"x": v}, float("nan")
        return {"x": v}, float(v)

    state, losses = TrainSupervisor(store=store, save_every=2, max_restores=3).run(
        {"x": torch.tensor(0.0)}, step_fn, n_steps=6)
    assert len(losses) == 6 and all(math.isfinite(x) for x in losses)
    assert float(state["x"]) == 6.0


def test_supervisor_gives_up_after_max_restores(tmp_path):
    store = CheckpointStore(tmp_path)
    sup = TrainSupervisor(store=store, save_every=1, max_restores=2)
    with pytest.raises(RuntimeError, match="restores exhausted"):
        sup.run({"x": torch.tensor(0.0)}, lambda s, t: (s, float("nan") if t == 2 else 1.0), n_steps=4)
    with pytest.raises(RuntimeError, match="no checkpoint"):
        TrainSupervisor(store=CheckpointStore(tmp_path / "empty")).run(
            {"x": torch.tensor(0.0)}, lambda s, t: (s, float("nan")), n_steps=2)


def test_supervisor_waits_for_a_save_in_flight_before_restoring(tmp_path, monkeypatch):
    """A departure from the reference, on purpose.  Each store's write is
    slowed by 0.5 s, checkpoints every 2 steps, and step 2 gives a NaN loss
    the first time, while the save of step 2 is still being written.  The
    reference's supervisor looks for a checkpoint without waiting and
    raises; the port's waits for the save, restores step 2 and finishes."""
    import time

    def slowed(write):
        def slow(self, *args):
            time.sleep(0.5)
            return write(self, *args)
        return slow

    monkeypatch.setattr(JCheckpointStore, "_write", slowed(JCheckpointStore._write))
    monkeypatch.setattr(CheckpointStore, "_write", slowed(CheckpointStore._write))

    def poisoned(add):
        seen = set()

        def step_fn(state, step):
            v = add(state["x"])
            if step == 2 and step not in seen:
                seen.add(step)
                return {"x": v}, float("nan")
            return {"x": v}, float(v)
        return step_fn

    from repro.runtime import TrainSupervisor as JTrainSupervisor

    with pytest.raises(RuntimeError, match="no checkpoint to restore"):
        JTrainSupervisor(store=JCheckpointStore(tmp_path / "ref"), save_every=2).run(
            {"x": jnp.asarray(0.0)}, poisoned(lambda x: x + 1.0), n_steps=4)
    state, losses = TrainSupervisor(store=CheckpointStore(tmp_path / "port"), save_every=2).run(
        {"x": torch.tensor(0.0)}, poisoned(lambda x: x + 1.0), n_steps=4)
    assert losses == [1.0, 2.0, 3.0, 4.0] and float(state["x"]) == 4.0


def test_supervisor_checkpoints_written(tmp_path):
    store = CheckpointStore(tmp_path)
    _, losses = TrainSupervisor(store=store, save_every=2).run(
        {"x": torch.tensor(0.0)}, lambda s, t: ({"x": s["x"] + 1}, 1.0), n_steps=5)
    assert store.steps() == [2, 4, 5] and losses == [1.0] * 5


def _confs(trials):
    return [(t.conf.stages, t.conf.eps, t.throughput, t.t_wall) for t in trials]


@pytest.mark.parametrize("n_eps,dead,n_stages", [(4, [1], None), (4, [0, 3], None), (8, [2, 5, 6], 3), (4, [], 2)])
def test_elastic_rescale_matches_the_reference_trial_for_trial(n_eps, dead, n_stages):
    layers, jlayers = network_layers("synthnet"), j_network_layers("synthnet")
    traces, jtraces = [], []
    el = ElasticScheduler(core.paper_platform(n_eps), core.weights(layers),
                          lambda p: traces.append(core.Trace(core.DatabaseEvaluator(p, layers))) or traces[-1])
    jel = JElasticScheduler(jcore.paper_platform(n_eps), jcore.weights(jlayers),
                            lambda p: jtraces.append(jcore.Trace(jcore.DatabaseEvaluator(p, jlayers))) or jtraces[-1])
    (conf, res), (jconf, jres) = el.on_topology_change(dead, n_stages), jel.on_topology_change(dead, n_stages)
    assert (conf.stages, conf.eps) == (jconf.stages, jconf.eps)
    assert res.best_throughput == jres.best_throughput and res.n_explored == jres.n_explored
    assert _confs(traces[0].trials) == _confs(jtraces[0].trials) and traces[0].trials
    assert el.platform.name == jel.platform.name
    assert [dataclasses.astuple(e) for e in el.platform.eps] == [dataclasses.astuple(e) for e in jel.platform.eps]
    assert el.platform.n_eps == n_eps - len(dead) and all(ep < el.platform.n_eps for ep in conf.eps)


def test_elastic_all_dead_raises():
    layers = network_layers("synthnet")
    el = ElasticScheduler(core.paper_platform(2), core.weights(layers),
                          lambda p: core.Trace(core.DatabaseEvaluator(p, layers)))
    with pytest.raises(RuntimeError, match="no EPs left"):
        el.on_topology_change(dead_eps=[0, 1])


def test_platform_without_matches_the_reference():
    for dead in ([0], [1, 3], [3, 1, 1]):
        ours, theirs = core.paper_platform(4).without(dead), jcore.paper_platform(4).without(dead)
        assert ours.name == theirs.name
        assert [dataclasses.astuple(e) for e in ours.eps] == [dataclasses.astuple(e) for e in theirs.eps]
