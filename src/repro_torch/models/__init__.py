"""The decoder LM (PyTorch port of ``repro.models``).

``lm.LM`` (``loss_fn``, ``prefill``, ``decode_step``) for every family of
the JAX package's registry — dense, MoE, SSM, hybrid, VLM (cross-attention
to image embeddings) and audio (frame-embedding inputs) —, ``layers``
(RMSNorm, RoPE, GQA attention through the hand-written flash-attention
kernels — forward, and backward under autograd —, SwiGLU MLP), ``moe``
(the top-k routed FFN), ``ssm`` (the Mamba2 SSD block) and ``convert``
(``params_from_jax``, ``cache_from_jax``), which carries the JAX package's
weights and caches across.
"""
from repro_torch.models.convert import cache_from_jax, params_from_jax
from repro_torch.models.lm import LM, build

__all__ = ["LM", "build", "cache_from_jax", "params_from_jax"]
