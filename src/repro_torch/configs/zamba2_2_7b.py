"""zamba2-2.7b [arXiv:2411.15242] — hybrid Mamba2 backbone + shared attention.

54L d_model=2560 32H (MHA kv=32) d_ff=10240 vocab=32000, ssm_state=64.
The shared attention+MLP block (one parameter set) is applied after every
6th Mamba2 layer.  At long context (``long_500k``) the shared block runs a
4096-token sliding window (documented deviation, DESIGN.md §4), which is
what makes the 500k decode cell sub-quadratic end-to-end.
"""

from ..models.lm_common import LMConfig

CONFIG = LMConfig(
    name="zamba2-2.7b",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    ssm_state=64,
    ssm_head_dim=64,
    block_kind="hybrid",
    shared_attn_every=6,
)

SMOKE = LMConfig(
    name="zamba2-smoke",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=128,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_chunk=8,
    block_kind="hybrid",
    shared_attn_every=2,
    remat="none",
)
