"""The dense decoder LM (PyTorch port of ``repro.models``).

``lm.LM`` (``loss_fn``, ``prefill``, ``decode_step``), ``layers`` (RMSNorm,
RoPE, GQA attention through the hand-written flash-attention kernels —
forward, and backward under autograd —, SwiGLU MLP) and
``convert.params_from_jax``, which carries the JAX package's weights across.
"""
from repro_torch.models.convert import params_from_jax
from repro_torch.models.lm import LM, build

__all__ = ["LM", "build", "params_from_jax"]
