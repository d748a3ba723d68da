"""h2o-danube-3-4b — dense llama+mistral mix with sliding-window attention.

[arXiv:2401.16818; unverified] 24L, d_model 3840, 32 heads (kv=8, head_dim
120), d_ff 10240, vocab 32000.  SWA window 4096 (mistral default) —
sub-quadratic, so the long_500k cell RUNS for this arch.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab_size=32000,
    sliding_window=4096,
    long_context_ok=True,
    remat="full",
    micro_batches=2,
    notes="SWA window 4096; head_dim 120 (3840/32)",
)
