"""mamba2-130m [arXiv:2405.21060] — pure SSD (state-space duality) stack.

24L d_model=768 (attention-free) vocab=50280, ssm_state=128.
expand=2 -> d_inner=1536, 24 SSD heads of dim 64.
"""

from ..models.lm_common import LMConfig

CONFIG = LMConfig(
    name="mamba2-130m",
    n_layers=24,
    d_model=768,
    n_heads=12,  # unused (attention-free); kept for cost-model symmetry
    n_kv_heads=12,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_chunk=64,  # impl knob: keeps [.., cl, cl] decay panels VMEM/HBM-friendly
    block_kind="ssd",
)

SMOKE = LMConfig(
    name="mamba2-smoke",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=128,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_chunk=8,
    block_kind="ssd",
    remat="none",
)
