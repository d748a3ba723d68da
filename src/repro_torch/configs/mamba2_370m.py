"""mamba2-370m — attention-free SSM (state-space duality / SSD).

[arXiv:2405.21060; unverified] 48L, d_model 1024, no attention, no FFN
(d_ff=0; the Mamba2 block IS the layer), vocab 50280, ssm_state 128.
State-space decode is O(1)/token → long_500k RUNS.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=16,          # unused (attention-free); kept for config uniformity
    num_kv_heads=16,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_chunk=256,
    long_context_ok=True,
    remat="full",
    micro_batches=1,
    notes="SSD; d_inner 2048, 32 ssm heads; paper's technique inapplicable (SGD arch)",
)
