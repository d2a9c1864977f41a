"""whisper-small [arXiv:2212.04356] — encoder-decoder, conv frontend stubbed.

12L encoder + 12L decoder, d_model=768 12H (MHA kv=12) d_ff=3072
vocab=51865.  The conv/mel frontend is a STUB per the assignment:
``input_specs()`` provides 1500 precomputed frame embeddings.  Decoder
self-attention context is capped at 448 positions (Whisper spec), so
decode cells run a 448-slot ring cache with cross-attention over the
1500-frame encoder output.
"""

from ..models.lm_common import LMConfig

CONFIG = LMConfig(
    name="whisper-small",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    enc_layers=12,
    enc_frames=1500,
    max_decoder_len=448,
)

SMOKE = LMConfig(
    name="whisper-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=128,
    enc_layers=2,
    enc_frames=16,
    max_decoder_len=32,
    remat="none",
)
