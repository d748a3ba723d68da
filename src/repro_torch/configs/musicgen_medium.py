"""musicgen-medium — decoder-only LM over EnCodec audio tokens.

[arXiv:2306.05284; hf] 48L, d_model 1536, 24 heads (kv=24 = MHA),
d_ff 6144, vocab 2048 (one EnCodec codebook).  The EnCodec frontend is a
STUB per the assignment: ``input_specs()`` feeds precomputed frame
embeddings (B, S, d_model); the backbone + lm_head are real.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    frontend="audio_frames",
    remat="full",
    notes="EnCodec token LM; frame-embedding frontend stubbed",
)
