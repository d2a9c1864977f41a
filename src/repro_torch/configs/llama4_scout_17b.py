"""llama4-scout-17b-a16e [hf:meta-llama/Llama-4-Scout-17B-16E].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16e top-1 +
one shared expert (llama4 routing).  Early-fusion multimodality is out of
scope — text backbone only (DESIGN.md §4).
"""

from ..models.lm_common import LMConfig

CONFIG = LMConfig(
    name="llama4-scout-17b",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    n_experts=16,
    top_k=1,
    n_shared_experts=1,
)

SMOKE = LMConfig(
    name="llama4-scout-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=96,
    vocab=128,
    n_experts=4,
    top_k=1,
    n_shared_experts=1,
    remat="none",
)
