"""qwen2-0.5b [arXiv:2407.10671].

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936, QKV bias.
"""

from ..models.lm_common import LMConfig

CONFIG = LMConfig(
    name="qwen2-0.5b",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151936,
    qkv_bias=True,
)

SMOKE = LMConfig(
    name="qwen2-smoke",
    n_layers=3,
    d_model=56,
    n_heads=7,
    n_kv_heads=1,
    d_ff=128,
    vocab=128,
    qkv_bias=True,
    remat="none",
)
