"""granite-20b — dense code LM, llama-arch with MQA (GQA kv=1).

[arXiv:2405.04324; hf] 52L, d_model 6144, 48 heads (kv=1), d_ff 24576,
vocab 49152.  Pure full attention → long_500k skipped (see DESIGN.md
§Arch-applicability).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    remat="full",
    micro_batches=8,
    zero1=True,
    notes="MQA; code model",
)
