"""The bf16 flash forward's route on the CPU (no card here).

``flash_attention.fwd_route`` and ``fwd_kernels`` on tensors in the
model's layout (transposed ``[b, s, h, d]`` views): every served prefill
and training shape takes ``flash_fwd_wgmma_kernel``; D 16 and 32, rows
only 8-byte aligned, the bf16-score mode and fp32 do not.  ``fwd_plan``,
the wgmma kernel's tiling and shared-memory plan mirrored from the source,
fits a block's 232,448 bytes at every head dim and tiling the source
builds (``scripts/flash_tiles.py`` times them).  And the plain forward the
card's kernels are held to, against the JAX package at each served head dim and
GQA group not held in ``tests/test_torch_attention_ssd.py`` already:
through the Pallas kernel (interpret mode on the CPU) where S divides its
blocks, through the reference model's ``_sdpa`` where the key length
differs from the query's.  The kernels themselves run only on the
card (``tests/test_torch_gpu.py``, ``chip_smoke.py`` phase 6).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # CI installs requirements-dev.txt, which has no torch

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

ATTN_TOL = dict(rtol=2e-4, atol=2e-4)
#: the attention models the card serves (chip_smoke.LM_MODELS) and qwen3-32b, which it trains
#: (train_4k, phase 15 (c))
ATTENTION_MODELS = ("granite-3-2b", "phi3.5-moe-42b", "llama4-scout-17b", "zamba2-2.7b", "nemotron-4-340b",
                    "whisper-small", "internvl2-76b", "qwen3-32b")
#: every choice the kernel builds at each head dim (consumer warpgroups, overlap within a warpgroup): the
#: shipped ones and the ones ``scripts/flash_tiles.py`` times beside them
TILINGS = [(wgs, overlap) for wgs in (1, 2) for overlap in (0, 1)]


def _bshd(b, s, h, d, dtype=torch.bfloat16):
    """A [b, h, s, d] view of a [b, s, h, d] tensor, as the model passes q, k and v."""
    return torch.empty((b, s, h, d), dtype=dtype).transpose(1, 2)


def _prefill_calls(arch: str, b: int = 4, prompt: int = 512) -> list[tuple]:
    """(q, k, v) of each distinct flash call of ``arch``'s prefill (whisper:
    its encoder, decoder and cross attention)."""
    cfg = get_config(arch)
    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if cfg.is_encdec:
        dec = min(prompt, cfg.max_decoder_len)
        lengths = [(cfg.enc_frames, cfg.enc_frames), (dec, dec), (dec, cfg.enc_frames)]
    else:
        lengths = [(prompt + cfg.n_patches,) * 2]
    return [(_bshd(b, sq, h, d), _bshd(b, skv, kvh, d), _bshd(b, skv, kvh, d)) for sq, skv in lengths]


@pytest.mark.parametrize("arch", ATTENTION_MODELS)
def test_every_served_prefill_shape_takes_the_wgmma_route(arch):
    for q, k, v in _prefill_calls(arch):
        assert fa.fwd_route(q, k, v) == "wgmma", (arch, tuple(q.shape), tuple(k.shape))
        assert fa.fwd_kernels("wgmma", q.shape[-1]) == (f"flash_fwd_wgmma_kernel<{q.shape[-1]}>",)
        assert fa._tma_rows(torch.empty_like(q))  # the output, allocated like q, is stored by TMA too


@pytest.mark.parametrize("arch", ["granite-3-2b", "phi3.5-moe-42b", "zamba2-2.7b", "qwen3-32b"])
def test_training_shapes_take_the_wgmma_route_in_both_layouts(arch):
    """The training forward (batch 4 x 512) as the model's views, and the same tensors made contiguous."""
    cfg = get_config(arch)
    q, k, v = (_bshd(4, 512, n, cfg.hd) for n in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    assert fa.fwd_route(q, k, v) == "wgmma"
    assert fa.fwd_route(q.contiguous(), k.contiguous(), v.contiguous()) == "wgmma"


@pytest.mark.parametrize("d", [16, 32])
def test_narrow_head_dims_stay_on_mma(d):
    q, k, v = _bshd(2, 64, 8, d), _bshd(2, 64, 2, d), _bshd(2, 64, 2, d)
    assert fa.fwd_route(q, k, v) == "mma"
    assert fa.fwd_kernels("mma", d) == (f"flash_fwd_mma_bf16_kernel<{d}>",)


@pytest.mark.parametrize("d", [64, 80, 128, 192])
@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_rows_only_8_byte_aligned_stay_on_mma(d, which):
    """A position stride of a multiple of 4 elements but not 8 in any one of
    q, k, v: the 16-byte row TMA needs is missing, the mma.sync kernel's
    8-byte copies take it."""
    b, s, h, kvh = 2, 77, 8, 2
    t = {n: _bshd(b, s, heads, d) for n, heads in (("q", h), ("k", kvh), ("v", kvh))}
    heads = h if which == "q" else kvh
    t[which] = torch.empty((b, s, heads * d + 4), dtype=torch.bfloat16)[..., : heads * d] \
        .unflatten(-1, (heads, d)).transpose(1, 2)
    assert t[which].stride(2) % 8 == 4
    assert fa.fwd_route(t["q"], t["k"], t["v"]) == "mma"


@pytest.mark.parametrize("d", [64, 80, 128, 192])
def test_a_misaligned_base_stays_on_mma(d):
    flat = torch.empty(2 * 64 * 8 * d + 4, dtype=torch.bfloat16)[4:]  # 8 bytes past a 16-byte boundary
    q = flat.view(2, 64, 8, d).transpose(1, 2)
    k = v = _bshd(2, 64, 2, d)
    assert q.data_ptr() % 16 == 8
    assert fa.fwd_route(q, k, v) == "mma"


@pytest.mark.parametrize("d", [16, 64, 80, 128, 192])
def test_the_bf16_score_mode_and_fp32_are_not_on_wgmma(d):
    q, k, v = _bshd(2, 64, 8, d), _bshd(2, 64, 2, d), _bshd(2, 64, 2, d)
    assert fa.fwd_route(q, k, v, fp32_scores=False) == "mma"
    assert fa.fwd_kernels("mma", d, fp32_scores=False) == (f"flash_fwd_mma_bf16_scores_kernel<{d}>",)
    qf, kf, vf = (t.float() for t in (q, k, v))
    for fp32_scores, name in ((True, "flash_fwd_kernel"), (False, "flash_fwd_bf16_scores_kernel")):
        assert fa.fwd_route(qf, kf, vf, fp32_scores) == "simt"
        assert fa.fwd_kernels("simt", d, fp32_scores) == (f"{name}<{d}>",)
    with pytest.raises(ValueError, match="bf16-score"):
        fa.fwd_kernels("wgmma", d, fp32_scores=False)


def test_fwd_route_and_kernels_are_pure():
    """The same inputs give the same answer, and naming a route launches nothing."""
    q, k, v = _bshd(4, 512, 32, 64), _bshd(4, 512, 8, 64), _bshd(4, 512, 8, 64)
    before = fa.launches
    assert {fa.fwd_route(q, k, v) for _ in range(3)} == {"wgmma"}
    assert fa.fwd_kernels("wgmma", 64) == fa.fwd_kernels("wgmma", 64)
    assert fa.launches == before
    with pytest.raises(ValueError, match="no forward route"):
        fa.fwd_kernels("tma", 64)
    assert set(fa.FWD_ROUTES) == {"simt", "mma", "wgmma"}


def test_a_cpu_tensor_never_reaches_a_kernel_route():
    """run_fwd_route is the kernels' entry: CPU tensors are refused before any launch."""
    q, k, v = _bshd(1, 64, 4, 64), _bshd(1, 64, 2, 64), _bshd(1, 64, 2, 64)
    for route in fa.FWD_ROUTES:
        with pytest.raises(ValueError, match="CUDA"):
            fa.run_fwd_route(q, k, v, route=route)


@pytest.mark.parametrize("d", [64, 80, 128, 192])
@pytest.mark.parametrize("wgs,overlap", TILINGS)
def test_the_shared_memory_plan_fits_a_block_with_aligned_tiles(d, wgs, overlap):
    plan = fa.fwd_plan(d, (wgs, overlap))
    assert plan["stages"] >= 2
    assert plan["smem_bytes"] <= 232448
    assert plan["planned_blocks_an_sm"] * (plan["smem_bytes"] + 1024) <= fa.SM_SMEM
    # the tiles, 1,024-byte aligned in a 1,024-byte-aligned base: two slots of Q tiles, then the ring's K and V
    assert plan["tile_bytes"] % 1024 == 0
    ring_end = 1024 + 2 * wgs * plan["tile_bytes"] + plan["stages"] * 2 * plan["tile_bytes"]
    assert ring_end + 2 * (2 + plan["stages"]) * 8 == plan["smem_bytes"]
    assert (plan["consumer_warpgroups"], plan["overlap"]) == (wgs, overlap)


def test_the_shipped_plan_at_each_head_dim():
    """One consumer warpgroup and two blocks an SM at D 64 and 128, two
    consumer warpgroups and one block an SM at D 80 and 192; the softmax
    overlaps the products within the warpgroup at D 64 alone."""
    want = {64: (1, 1, 2, 4, 83040), 80: (2, 0, 1, 4, 197728), 128: (1, 0, 2, 2, 99392), 192: (2, 0, 1, 2, 197696)}
    for d, row in want.items():
        plan = fa.fwd_plan(d)
        got = tuple(plan[k] for k in ("consumer_warpgroups", "overlap", "planned_blocks_an_sm", "stages", "smem_bytes"))
        assert got == row, (d, plan)
    assert set(fa.FWD_TILING) == set(fa.FWD_WGMMA_HEAD_DIMS)


def _inputs(b, h, kvh, sq, skv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d), dtype=np.float32),
            rng.standard_normal((b, kvh, skv, d), dtype=np.float32),
            rng.standard_normal((b, kvh, skv, d), dtype=np.float32))


def _served_groups() -> list[tuple[int, int]]:
    """(head dim, GQA group) of every attention model, each pair once."""
    return sorted({(get_config(a).hd, get_config(a).n_heads // get_config(a).n_kv_heads) for a in ATTENTION_MODELS})


#: served (head dim, GQA group) pairs that tests/test_torch_attention_ssd.py already holds against the
#: Pallas kernel: D 80 at group 1 and D 192 at group 12 (``..._at_head_dims_80_and_192``), D 128 at group 5
#: (``..._at_group_5``)
HELD_ELSEWHERE = [(80, 1), (128, 5), (192, 12)]
#: the other served pairs, held below
HELD_HERE = [(64, 1), (64, 4), (128, 4), (128, 8)]


def test_every_served_group_is_held_against_the_pallas_kernel():
    assert _served_groups() == sorted(HELD_ELSEWHERE + HELD_HERE)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,group", HELD_HERE)
def test_plain_forward_matches_the_pallas_kernel_at_each_served_head_dim_and_group(d, group, causal):
    """The plain forward (what the card's kernels are held to) against the
    reference's Pallas kernel in interpret mode, 2 kv-heads at the served
    group, S 64 in blocks of 32."""
    q, k, v = _inputs(1, 2 * group, 2, 64, 64, d, seed=d * 100 + group)
    y = fa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)), causal=causal).numpy()
    y_pallas = np.asarray(jops.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal, bq=32, bk=32))
    np.testing.assert_allclose(y, y_pallas, **ATTN_TOL)


@pytest.mark.parametrize("sq,skv,causal,window", [(448, 150, False, 0), (20, 75, True, 0), (75, 20, True, 0),
                                                  (33, 100, True, 16)])
def test_plain_forward_over_another_key_length_matches_sdpa_at_head_dim_64(sq, skv, causal, window):
    """Skv != Sq at D 64 (whisper's cross attention, cut to size) against the
    reference model's _sdpa, which the Pallas kernel (one length) cannot take."""
    cfg = dataclasses.replace(get_smoke("whisper-small"), dtype=jnp.float32, attn_q_block=16, n_heads=4,
                              n_kv_heads=4, head_dim=64)
    q, k, v = _inputs(1, 4, 4, sq, skv, 64, seed=sq * 1000 + skv)
    y = fa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)), causal=causal, window=window)
    y = y.transpose(1, 2).reshape(1, sq, -1).numpy()
    bshd = [jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v)]
    y_ref = np.asarray(jblocks._sdpa(cfg, *bshd, causal=causal, window=window))
    np.testing.assert_allclose(y, y_ref, **ATTN_TOL)
