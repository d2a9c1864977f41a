"""The MoE decode GEMM's split (``gemm.decode_plan``) and its plain
composition against ``gemm_plain`` and the JAX package's gemm (CPU).

The decode route (bf16, M <= 16, rows TMA can address) runs
``gemm_decode_bf16_kernel`` on a persistent grid: the units (expert,
256-column tile, 64-row K step) in that order, K fastest, block i taking
``start(i) .. start(i + 1) - 1``, and ``gemm_decode_sum_kernel`` summing
the fp32 partials of each tile split between blocks in block order.  The
plan and its pieces are functions of the shapes and the card's SM count
alone, so they run here; ``gemm_decode_plain`` composes the same split in
PyTorch and is held against ``gemm_plain`` and the reference's Pallas
``gemm`` (interpret mode) and ``gemm_ref`` at the reference's bf16
tolerance, 6e-2, at the decode shapes narrowed.  The kernels run only on
the card: ``chip_smoke.py`` phases 9 and 10.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # CI installs requirements-dev.txt, which has no torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import gemm as gm

BF16_TOL = dict(rtol=6e-2, atol=6e-2)
H100_SMS = 132

#: (E, K, N) of every decode product on the card's main path (phi3.5-moe, llama4-scout: gate/up, down), then
#: ragged and small ones: N past whole tiles, K past whole steps, fewer units than SMs
PLANS = [(16, 4096, 6400), (16, 6400, 4096), (16, 5120, 8192), (16, 8192, 5120),
         (16, 4104, 6392), (1, 4104, 6408), (3, 264, 136), (2, 64, 8), (1, 8, 8)]


def _units(plan: gm.DecodePlan, k: int):
    """Each piece's units, as (tile, step) pairs."""
    for pc in gm.decode_pieces(plan, k):
        for step in range(pc.k0 // gm.DECODE_STEP, -(-pc.k1 // gm.DECODE_STEP)):
            yield pc.block, pc.tile, step


@pytest.mark.parametrize("sms", [H100_SMS, 7, 1])
@pytest.mark.parametrize("e,k,n", PLANS)
def test_decode_plan_covers_every_unit_once(e, k, n, sms):
    plan = gm.decode_plan(e, n, k, sms)
    assert plan.ntiles == -(-n // 256) and plan.steps == -(-k // 64)
    assert plan.units == e * plan.ntiles * plan.steps and plan.blocks == min(sms, plan.units)
    seen = [(tile, step) for _, tile, step in _units(plan, k)]
    assert sorted(seen) == [(t, s) for t in range(e * plan.ntiles) for s in range(plan.steps)]
    # the pieces' K rows cover each tile's K exactly once, the last cut at K
    for tile in range(e * plan.ntiles):
        rows = [(pc.k0, pc.k1) for pc in gm.decode_pieces(plan, k) if pc.tile == tile]
        assert rows[0][0] == 0 and rows[-1][1] == k
        assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))


@pytest.mark.parametrize("sms", [H100_SMS, 7])
@pytest.mark.parametrize("e,k,n", PLANS)
def test_decode_shares_are_within_one_unit_of_each_other(e, k, n, sms):
    plan = gm.decode_plan(e, n, k, sms)
    shares = [plan.start(i + 1) - plan.start(i) for i in range(plan.blocks)]
    assert sum(shares) == plan.units and min(shares) >= 1 and max(shares) - min(shares) <= 1
    assert plan.start(0) == 0 and plan.start(plan.blocks) == plan.units


def test_decode_plan_at_phi35_moe_gives_every_sm_a_share_of_6_4_mb():
    """The gate/up product: 16 x 25 tiles x 64 steps = 25,600 units of 32 KB
    over 132 SMs: 193 or 194 units (6.3-6.4 MB of weights) each."""
    plan = gm.decode_plan(16, 6400, 4096, H100_SMS)
    assert (plan.ntiles, plan.steps, plan.units, plan.blocks) == (25, 64, 25_600, 132)
    shares = {plan.start(i + 1) - plan.start(i) for i in range(plan.blocks)}
    assert shares == {193, 194}


@pytest.mark.parametrize("sms", [H100_SMS, 7, 3])
@pytest.mark.parametrize("e,k,n", PLANS)
def test_decode_split_tiles_sum_their_pieces_in_block_order(e, k, n, sms):
    """A whole tile is one piece, stored by its block; a split tile's pieces
    are the partials of consecutive blocks in K order, the first block's
    slot 1 (its last piece) unless it starts at the tile, every later
    block's slot 0 (its first): what the sum kernel reads, in that order."""
    plan = gm.decode_plan(e, n, k, sms)
    by_tile: dict[int, list] = {}
    for pc in gm.decode_pieces(plan, k):
        by_tile.setdefault(pc.tile, []).append(pc)
    for tile, pieces in by_tile.items():
        if len(pieces) == 1:
            assert pieces[0].slot is None and (pieces[0].k0, pieces[0].k1) == (0, k)
            continue
        assert [pc.block for pc in pieces] == list(range(pieces[0].block, pieces[0].block + len(pieces)))
        lo = tile * plan.steps
        # the sum kernel's rule: the first boundary inside the tile sums it; block j's slot by where it starts
        first = min(i for i in range(1, plan.blocks) if lo < plan.start(i) < lo + plan.steps)
        assert pieces[0].block == first - 1
        assert [pc.slot for pc in pieces] == [0 if plan.start(pc.block) >= lo else 1 for pc in pieces]
        assert all(pc.slot is not None for pc in pieces)


@pytest.mark.parametrize("e,k,n", PLANS[:4])
def test_decode_splits_few_tiles_at_the_moe_shapes(e, k, n):
    """At most one tile per boundary between two shares is split, so the
    partials the sum kernel reads are a small part of the weights."""
    plan = gm.decode_plan(e, n, k, H100_SMS)
    pieces = gm.decode_pieces(plan, k)
    split = {pc.tile for pc in pieces if pc.slot is not None}
    assert len(split) <= plan.blocks - 1
    partial_bytes = sum(1 for pc in pieces if pc.slot is not None) * 8 * 256 * 4
    assert partial_bytes < 0.01 * e * k * n * 2


@pytest.mark.parametrize("m,want", [(1, 8), (8, 8), (9, 16), (16, 16)])
def test_decode_kernels_are_named_by_their_row_tile(m, want):
    assert gm.decode_mt(m) == want
    assert gm.decode_kernels(m) == (f"gemm_decode_bf16_kernel<{want}>", f"gemm_decode_sum_kernel<{want}>")
    assert gm.route(torch.bfloat16, m, 4096, 6400, True).kernel == gm.KERNELS.index("gemm_decode_bf16_kernel<MT>")


#: (E, M, K, N, sms): the decode products narrowed (capacity 8 and 16, one token, ragged N and K), on cards of a
#: few SMs so that tiles split between blocks
NARROW = [(4, 8, 512, 520, 7), (4, 8, 520, 512, 5), (2, 16, 384, 392, 3), (3, 1, 264, 136, 4), (2, 8, 4104, 264, 11)]


def _ab(e, m, k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((e, m, k), dtype=np.float32),
            (rng.standard_normal((e, k, n)) / np.sqrt(k)).astype(np.float32))


@pytest.mark.parametrize("e,m,k,n,sms", NARROW)
def test_decode_plain_composition_matches_gemm_plain_and_the_reference(e, m, k, n, sms):
    a, b = _ab(e, m, k, n, seed=k + n)
    ta, tb = torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16()
    plan = gm.decode_plan(e, n, k, sms)
    assert any(pc.slot is not None for pc in gm.decode_pieces(plan, k)), "the case must split a tile"
    got = gm.gemm_decode_plain(ta, tb, sms)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (e, m, n)
    np.testing.assert_allclose(got.float().numpy(), gm.gemm_plain(ta, tb).float().numpy(), **BF16_TOL)
    ja, jb = jnp.asarray(a).astype(jnp.bfloat16), jnp.asarray(b).astype(jnp.bfloat16)
    for x in range(e):
        want = jops.gemm(ja[x], jb[x], bm=16, bn=128, bk=128)
        np.testing.assert_allclose(got[x].float().numpy(), np.asarray(want.astype(jnp.float32)), **BF16_TOL)
        np.testing.assert_allclose(got[x].float().numpy(),
                                   np.asarray(jref.gemm_ref(ja[x], jb[x]).astype(jnp.float32)), **BF16_TOL)


@pytest.mark.parametrize("e,m,k,n,sms", NARROW)
def test_decode_plain_composition_in_fp32_is_the_product_summed_in_slices(e, m, k, n, sms):
    """In fp32 the composition differs from one fp32 product only by the
    order of its sums: held at the reference's fp32 tolerance, 2e-4."""
    a, b = _ab(e, m, k, n, seed=1)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(gm.gemm_decode_plain(ta, tb, sms).numpy(), gm.gemm_plain(ta, tb).numpy(),
                               rtol=2e-4, atol=2e-4)
