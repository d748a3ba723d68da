"""The LM trainer's optimizer and schedules (PyTorch port of
``repro.optim``): AdamW with float32 moments and a global-norm clip,
updated in place leaf by leaf, and the cosine-with-warmup and
Robbins–Monro schedules, in the JAX package's float32 arithmetic."""
from repro_torch.optim.adamw import OptState, adamw_init, adamw_update
from repro_torch.optim.schedules import cosine_warmup, robbins_monro

__all__ = ["adamw_init", "adamw_update", "OptState", "cosine_warmup",
           "robbins_monro"]
