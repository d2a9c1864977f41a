"""qwen3-32b [hf:Qwen/Qwen3-32B family].

64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936, qk_norm,
explicit head_dim=128 (q_dim 8192 != d_model, per the HF config).
"""

from ..models.lm_common import LMConfig

CONFIG = LMConfig(
    name="qwen3-32b",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_ff=25600,
    vocab=151936,
    head_dim=128,
    qk_norm=True,
)

SMOKE = LMConfig(
    name="qwen3-smoke",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=160,
    vocab=128,
    head_dim=32,
    qk_norm=True,
    remat="none",
)
