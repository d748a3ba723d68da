"""jamba-1.5-large-398b — hybrid Mamba+attention (1:7) with MoE (16e top-2).

[arXiv:2403.19887; hf] 72L, d_model 8192, 64 heads (kv=8), d_ff 24576,
vocab 65536.  Super-block of 8 layers: attention at position 4, Mamba
elsewhere; MoE FFN on odd layers (every 2nd), dense FFN otherwise.
Adaptation note (DESIGN.md §7): Jamba ships Mamba-1 mixers; we use our
Mamba2/SSD block (d_state 64, head_dim 128) — the TPU-native equivalent.
Hybrid state decode → long_500k RUNS (9 attention layers' KV SP-sharded).
FSDP required at train_4k (398B params).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    num_experts=16,
    experts_per_token=2,
    moe_every=2,
    moe_offset=1,
    attn_every=8,
    attn_offset=4,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=128,
    ssm_conv=4,
    ssm_chunk=256,
    long_context_ok=True,
    remat="full",
    micro_batches=8,
    fsdp=True,
    moe_impl="ep",
    notes="1:7 attn:mamba, MoE every 2nd layer",
)
