"""qwen2-moe-a2.7b — MoE LM: 60 routed experts top-4 + 4 shared experts.

[hf:Qwen/Qwen1.5-MoE-A2.7B; hf] 24L, d_model 2048, 16 heads (kv=16),
per-expert d_ff 1408, shared-expert d_ff 5632 (= 4×1408), vocab 151936.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    num_experts=60,
    experts_per_token=4,
    num_shared_experts=4,
    shared_expert_ff=5632,
    remat="full",
    micro_batches=4,
    moe_impl="ep",
    notes="4 shared + 60 routed top-4",
)
