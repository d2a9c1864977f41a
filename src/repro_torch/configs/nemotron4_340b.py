"""nemotron-4-340b [arXiv:2402.16819].

96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000, squared-ReLU FFN.
"""

from ..models.lm_common import LMConfig

CONFIG = LMConfig(
    name="nemotron-4-340b",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab=256000,
    ffn_kind="relu2",
)

SMOKE = LMConfig(
    name="nemotron-4-smoke",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab=128,
    ffn_kind="relu2",
    remat="none",
)
