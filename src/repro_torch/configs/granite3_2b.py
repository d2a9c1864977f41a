"""granite-3-2b [hf:ibm-granite/granite-3.0-2b-base].

40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155.
"""

from ..models.lm_common import LMConfig

CONFIG = LMConfig(
    name="granite-3-2b",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab=49155,
)

SMOKE = LMConfig(
    name="granite-3-smoke",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=160,
    vocab=128,
    remat="none",
)
