"""internvl2-76b [arXiv:2404.16821] — InternViT frontend + LLM backbone.

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.  Per the
assignment the ViT frontend is a STUB: ``input_specs()`` provides
precomputed patch embeddings (n_patches=256) that are projected and
prepended to the token sequence.
"""

from ..models.lm_common import LMConfig

CONFIG = LMConfig(
    name="internvl2-76b",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    n_patches=256,
)

SMOKE = LMConfig(
    name="internvl2-smoke",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=160,
    vocab=128,
    n_patches=8,
    remat="none",
)
