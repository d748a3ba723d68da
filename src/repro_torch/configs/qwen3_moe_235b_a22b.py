"""qwen3-moe-235b-a22b — large MoE: 128 experts top-8, GQA kv=4.

[hf:Qwen/Qwen3-30B-A3B family; hf] 94L, d_model 4096, 64 heads (kv=4,
head_dim 128 → inner attention width 8192), per-expert d_ff 1536,
vocab 151936.  FSDP sharding (params+opt over the data axis) is required to
fit v5e 16 GB/chip at train_4k.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    num_experts=128,
    experts_per_token=8,
    remat="full",
    micro_batches=8,
    fsdp=True,
    moe_impl="ep",
    notes="128 routed experts top-8, no shared expert",
)
