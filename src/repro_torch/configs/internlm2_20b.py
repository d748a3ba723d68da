"""internlm2-20b — dense LM with GQA kv=8.

[arXiv:2403.17297; hf] 48L, d_model 6144, 48 heads (kv=8), d_ff 16384,
vocab 92544.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-20b",
    family="dense",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92544,
    remat="full",
    micro_batches=8,
    zero1=True,
    notes="GQA kv=8",
)
