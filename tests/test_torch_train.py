"""The port's training path against the JAX package's, on the CPU.

Weights come from the reference's ``init_params(cfg, PRNGKey)`` and cross
through numpy; batches are seeded numpy.  Everything runs in fp32 on both
sides (as ``tests/test_models.py`` trains its smoke configs).  Tolerances:
the loss at rtol 1e-5 (both sum the same fp32 terms in other orders), each
gradient leaf and each parameter after an update at the reference's own
``rtol=1e-3, atol=1e-4`` (``tests/test_models.py:176``).  On the card the
same path runs the flash and GEMM kernels forward and backward
(``chip_smoke.py``, ``tests/test_torch_gpu.py``).
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # CI installs requirements-dev.txt, which has no torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import lm_common as jlm
from repro.models import transformer as jtf
from repro.optim import AdamW as JAdamW
from repro.optim import AdamWConfig as JAdamWConfig
from repro_torch import configs, tree
from repro_torch.launch.train import train
from repro_torch.models import lm_common, transformer
from repro_torch.optim import AdamW, AdamWConfig

LOSS_TOL = dict(rtol=1e-5, atol=0)
LEAF_TOL = dict(rtol=1e-3, atol=1e-4)


def _pair(arch: str, **over):
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), dtype=jnp.float32, **over)
    tcfg = dataclasses.replace(configs.get_smoke(arch), dtype=torch.float32, **over)
    return jcfg, tcfg


def _params(jcfg, tcfg, seed=0):
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, lm_common.params_from_numpy(tcfg, jax.tree.map(lambda a: np.asarray(a, np.float32), jp), "cpu")


def _batch(cfg, b, s, seed=1, masked=True):
    """Tokens, labels (with ``masked``, the first three of row 0 masked),
    and the frames or patches the config takes, as numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if masked:
        out["labels"][0, :3] = -1
    if cfg.is_encdec:
        out["frames"] = rng.standard_normal((b, cfg.enc_frames, cfg.d_model), dtype=np.float32)
    if cfg.n_patches:
        out["patch_embeds"] = rng.standard_normal((b, cfg.n_patches, cfg.d_model), dtype=np.float32)
    return out


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.as_tensor(v, dtype=torch.int64 if v.dtype == np.int32 else None) for k, v in batch.items()}


def _close_trees(got: dict, want, tol):
    """Every leaf, in ``jax.tree.flatten``'s order on both sides."""
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    ours = tree.leaves(got)
    assert len(ours) == len(paths)
    for (path, w), g in zip(paths, ours):
        np.testing.assert_allclose(g.detach().float().numpy(), np.asarray(w, np.float32), err_msg=jax.tree_util.keystr(path),
                                   **tol)


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_train_loss_and_gradients_match_the_reference(arch):
    jcfg, tcfg = _pair(arch)
    jp, tp = _params(jcfg, tcfg)
    batch = _batch(jcfg, 2, 16)
    jl, jg = jax.value_and_grad(lambda p: jtf.train_loss(jcfg, p, _j(batch)))(jp)
    tl, tg = transformer.value_and_grad(tcfg, tp, _t(batch))
    np.testing.assert_allclose(float(tl), float(jl), **LOSS_TOL)
    _close_trees(tg, jg, LEAF_TOL)


@pytest.mark.parametrize("arch", ["granite-3-2b", "phi3.5-moe-42b", "whisper-small"])
def test_remat_none_gives_the_same_loss_and_gradients(arch):
    _, tcfg = _pair(arch)
    jcfg, _ = _pair(arch)
    _, tp = _params(jcfg, tcfg)
    batch = _t(_batch(jcfg, 2, 16, seed=2))
    l1, g1 = transformer.value_and_grad(tcfg, tp, batch)
    l2, g2 = transformer.value_and_grad(dataclasses.replace(tcfg, remat="none"), tp, batch)
    assert torch.equal(l1, l2)
    for a, b in zip(tree.leaves(g1), tree.leaves(g2)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("s,loss_chunk", [(24, 512), (24, 16), (20, 8), (7, 512)])
def test_lm_head_loss_chunking_matches_the_reference(s, loss_chunk):
    """The chunk is the first of loss_chunk, 512, 256, ... that divides s."""
    jcfg, tcfg = _pair("granite-3-2b", loss_chunk=loss_chunk)
    jp, tp = _params(jcfg, tcfg)
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, s, jcfg.d_model), dtype=np.float32)
    labels = rng.integers(-1, jcfg.vocab, (2, s)).astype(np.int32)
    jl, (jgh, jgu) = jax.value_and_grad(
        lambda h, u: jtf.lm_head_loss(jcfg, {**jp, "unembed": u}, h, jnp.asarray(labels), jnp.asarray(labels) >= 0),
        argnums=(0, 1))(jnp.asarray(h), jp["unembed"])
    th = torch.from_numpy(h).requires_grad_()
    tu = tp["unembed"].clone().requires_grad_()
    lab = torch.from_numpy(labels).long()
    tl = transformer.lm_head_loss(tcfg, {**tp, "unembed": tu}, th, lab, lab >= 0)
    gh, gu = torch.autograd.grad(tl, (th, tu))
    np.testing.assert_allclose(float(tl.detach()), float(jl), **LOSS_TOL)
    np.testing.assert_allclose(gh.numpy(), np.asarray(jgh), **LEAF_TOL)
    np.testing.assert_allclose(gu.numpy(), np.asarray(jgu), **LEAF_TOL)


def test_moe_loss_adds_the_routers_aux_loss():
    """train_loss = lm_head_loss + 0.01 * the sum of the MoE layers' aux."""
    _, tcfg = _pair("phi3.5-moe-42b")
    jcfg, _ = _pair("phi3.5-moe-42b")
    _, tp = _params(jcfg, tcfg)
    batch = _t(_batch(jcfg, 2, 16))
    with torch.no_grad():
        x = transformer.embed_tokens(tcfg, tp, batch["tokens"])
        h, aux = transformer.backbone(tcfg, tp, x, transformer._positions(2, 16, "cpu"))
        head = transformer.lm_head_loss(tcfg, tp, h, batch["labels"], batch["labels"] >= 0)
        total = transformer.train_loss(tcfg, tp, batch)
    assert float(aux) > 0
    torch.testing.assert_close(total, head + 0.01 * aux)


def _adamw_pair(**over):
    kw = dict(total_steps=10, warmup=2, **over)
    return AdamW(AdamWConfig(moment_dtype=torch.float32, **kw)), JAdamW(JAdamWConfig(moment_dtype=jnp.float32, **kw))


@pytest.mark.parametrize("arch", ["granite-3-2b", "phi3.5-moe-42b"])
def test_one_train_step_matches_the_reference(arch):
    jcfg, tcfg = _pair(arch)
    jp, tp = _params(jcfg, tcfg)
    opt, jopt = _adamw_pair()
    batch = _batch(jcfg, 4, 8)
    jp1, jst1, jm = jax.jit(jtf.make_train_step(jcfg, jopt))(jp, jopt.init(jp), _j(batch))
    tp1, tst1, tm = transformer.make_train_step(tcfg, opt)(tp, opt.init(tp), _t(batch))
    for key in ("loss", "lr", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5, err_msg=key)
    _close_trees(tp1, jp1, LEAF_TOL)
    _close_trees(tst1["mu"], jst1["mu"], LEAF_TOL)
    assert int(tst1["step"]) == int(jst1["step"]) == 1


def test_grad_accumulation_equivalence():
    """accum=2 gives (numerically close) the same update as accum=1, and
    the reference's accum=2 update (no masked label: each microbatch's
    mean then weighs its tokens as the whole batch's does)."""
    jcfg, tcfg = _pair("granite-3-2b")
    jp, tp = _params(jcfg, tcfg)
    opt, jopt = _adamw_pair()
    batch = _batch(jcfg, 4, 8, masked=False)
    p1, _, m1 = transformer.make_train_step(tcfg, opt, accum=1)(_clone(tp), opt.init(tp), _t(batch))
    p2, _, m2 = transformer.make_train_step(tcfg, opt, accum=2)(_clone(tp), opt.init(tp), _t(batch))
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4
    for a, b in zip(tree.leaves(p1), tree.leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **LEAF_TOL)
    jp2, _, jm2 = jax.jit(jtf.make_train_step(jcfg, jopt, accum=2))(jp, jopt.init(jp), _j(batch))
    np.testing.assert_allclose(float(m2["loss"]), float(jm2["loss"]), rtol=1e-5)
    _close_trees(p2, jp2, LEAF_TOL)


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_every_leaf_gets_a_finite_nonzero_gradient(arch):
    tcfg = dataclasses.replace(configs.get_smoke(arch), dtype=torch.float32)
    tp = lm_common.init_params(tcfg, torch.Generator().manual_seed(4), "cpu")
    _, grads = transformer.value_and_grad(tcfg, tp, _t(_batch(tcfg, 4, 16, seed=5)))
    named = tree.named_leaves(grads)
    assert [n for n, _ in named] == [n for n, _ in tree.named_leaves(tp)]
    for name, g in named:
        assert torch.isfinite(g).all() and (g != 0).any(), name


def test_train_at_smoke_size_loss_falls_and_resumes_exactly(tmp_path):
    """launch.train.train on the CPU: the loss falls, and a run resumed
    from the middle checkpoint repeats the uninterrupted run's losses
    exactly (the CPU sums in a fixed order)."""
    cfg = dataclasses.replace(configs.get_smoke("granite-3-2b"), dtype=torch.float32)
    kw = dict(steps=6, batch=4, seq=16, lr=1e-2, save_every=3, log_every=0, seed=0, device="cpu")
    first = train(cfg, ckpt_dir=tmp_path, **kw)
    losses = first["losses"]
    assert len(losses) == 6 and all(math.isfinite(x) for x in losses)
    assert losses[-1] < losses[0]
    import shutil

    shutil.rmtree(tmp_path / "step_00000006")
    again = train(cfg, ckpt_dir=tmp_path, **kw)
    assert again["losses"] == losses[3:]
    for a, b in zip(tree.leaves(first["state"]), tree.leaves(again["state"])):
        assert torch.equal(a, b)


def test_train_without_a_checkpoint_directory_logs_and_returns_the_state(capsys):
    cfg = dataclasses.replace(configs.get_smoke("mamba2-130m"), dtype=torch.float32)
    out = train(cfg, steps=2, batch=2, seq=16, log_every=1, device="cpu")
    assert len(out["losses"]) == 2 and out["steps_per_s"] > 0
    assert int(out["state"]["opt"]["step"]) == 2
    assert "[train] step 1 loss" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["granite-3-2b", "phi3.5-moe-42b"])
def test_chip_smoke_training_check_sees_its_attention_faults(arch):
    """``chip_smoke.train_readings`` at 1 layer on the CPU, where the kernel
    path is the plain versions: it reads 0; the backward without delta
    keeps the loss and wv's gradient (dV is right) and moves wq's and wk's
    past TRAIN_GRAD_TOL; the dropped causal mask moves the loss past
    TRAIN_LOSS_TOL."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    cfg = dataclasses.replace(configs.get_smoke(arch), dtype=torch.float32, n_layers=1)
    params = lm_common.init_params(cfg, torch.Generator().manual_seed(6), "cpu")
    readings = cs.train_readings(cfg, params, _t(_batch(cfg, 2, 32, seed=7, masked=False)))
    assert readings["kernel"]["loss"] == 0 and set(readings["kernel"]["leaves"].values()) == {0.0}
    no_delta = readings["no delta"]["leaves"]
    assert readings["no delta"]["loss"] == 0 and no_delta["blocks/wv"] < 1e-5
    assert min(no_delta["blocks/wq"], no_delta["blocks/wk"]) > cs.TRAIN_GRAD_TOL
    assert readings["not causal"]["loss"] > cs.TRAIN_LOSS_TOL


@pytest.mark.parametrize("arch,layers", [("mamba2-130m", 1), ("zamba2-2.7b", 2)])
def test_chip_smoke_training_check_sees_its_ssd_faults(arch, layers):
    """``chip_smoke.train_readings`` with SSD_TRAIN_CONTROLS on the CPU (the
    smoke configs: chunk 8 over 32 positions, four chunks), where the kernel
    path is the plain versions: it reads 0; both faults are in the backward
    alone, so they keep the loss; the carried state's gradient dropped
    across chunks, and ddt without its decay term (at ``dt_bias``, whose
    gradient is ddt's alone), each move some leaf past both models' SSD
    gradient limits."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    cfg = dataclasses.replace(configs.get_smoke(arch), dtype=torch.float32, n_layers=layers)
    params = lm_common.init_params(cfg, torch.Generator().manual_seed(6), "cpu")
    readings = cs.train_readings(cfg, params, _t(_batch(cfg, 2, 32, seed=7, masked=False)), cs.SSD_TRAIN_CONTROLS)
    assert readings["kernel"]["loss"] == 0 and set(readings["kernel"]["leaves"].values()) == {0.0}
    limit = max(cs.SSD_TRAIN_GRAD_TOL.values())
    for fault in cs.SSD_TRAIN_CONTROLS:
        assert readings[fault]["loss"] == 0 and max(readings[fault]["leaves"].values()) > limit
    assert readings["ddt without decay"]["leaves"]["blocks/dt_bias"] > limit
