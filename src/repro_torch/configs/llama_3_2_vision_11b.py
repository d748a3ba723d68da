"""llama-3.2-vision-11b — VLM: text decoder with cross-attention image layers.

[hf:meta-llama/Llama-3.2-11B-Vision; unverified] 40L, d_model 4096,
32 heads (kv=8), d_ff 14336, vocab 128256.  Cross-attention on every 5th
layer over 1601 precomputed patch embeddings (vision tower STUBBED per the
assignment — ``input_specs()`` provides (B, 1601, d_model) patch embeds).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    frontend="image_patches",
    cross_attn_every=5,
    image_tokens=1601,
    remat="full",
    micro_batches=4,
    notes="cross-attn every 5th layer; vision tower stubbed",
)
