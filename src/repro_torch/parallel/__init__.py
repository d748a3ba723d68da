"""Distribution of the LM stack over a mesh of ranks (PyTorch port of
``repro.parallel``): the expert-parallel MoE FFN, ``moe_ep.moe_apply_ep``.
The LDA engine's mesh and collectives are ``launch.mesh``."""
from repro_torch.parallel.moe_ep import moe_apply_ep

__all__ = ["moe_apply_ep"]
